"""qwen3-14b — 40L d5120 40H (kv=8) d_ff 17408 vocab 151936; qk_norm, GQA.
[hf:Qwen/Qwen3-8B family scaling; hf]
"""
from repro_torch.configs.base import ArchConfig, register

QWEN3_14B = register(ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab_size=151_936,
    qk_norm=True, rope_theta=1_000_000.0,
    skip_shapes=(("long_500k", "pure full-attention arch: 500k-KV decode is excluded per assignment; sub-quadratic attns only"),),
))
