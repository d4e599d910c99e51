"""internvl2-26b — InternViT frontend (STUB: precomputed patch embeddings)
+ InternLM2-20B-class decoder: 48L d6144 48H (kv=8) d_ff 16384 vocab 92553.
[arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ArchConfig, register

INTERNVL2_26B = register(ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92_553,
    n_patches=256, vit_embed_dim=3200,
    rope_theta=1_000_000.0,
    skip_shapes=(("long_500k", "pure full-attention arch: 500k-KV decode is excluded per assignment; sub-quadratic attns only"),),
))
