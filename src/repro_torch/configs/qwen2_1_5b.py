"""qwen2-1.5b — 28L d1536 12H (kv=2) d_ff 8960 vocab 151936; GQA with QKV
bias, tied embeddings. [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import ArchConfig, register

QWEN2_1_5B = register(ArchConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151_936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
    skip_shapes=(("long_500k", "pure full-attention arch: 500k-KV decode is excluded per assignment; sub-quadratic attns only"),),
))
