"""minicpm3-4b — 62L d2560 40H d_ff 6400 vocab 73448; MLA attention
(q_lora 768, kv_lora 256, nope 64 + rope 32, v 64) with mup-style scalers
(scale_emb 12, depth-scaled residuals, logits / (d/dim_base)).
[hf:openbmb/MiniCPM3-4B; hf]
"""
from repro_torch.configs.base import ArchConfig, register

MINICPM3_4B = register(ArchConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=96,
    d_ff=6400, vocab_size=73_448,
    use_mla=True, q_lora_rank=768, kv_lora_rank=256,
    qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
    embed_scale=12.0, logit_divisor=2560 / 256, residual_scale=1.4 / (62 ** 0.5),
    rope_theta=10_000.0,
    skip_shapes=(("long_500k", "pure full-attention arch: 500k-KV decode is excluded per assignment; sub-quadratic attns only"),),
))
