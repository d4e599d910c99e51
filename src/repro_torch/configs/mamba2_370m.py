"""mamba2-370m — attention-free SSD: 48L d1024, d_state 128, head_dim 64,
expand 2 (d_inner 2048 -> 32 heads), ngroups 1, conv 4, vocab 50280, tied
embeddings. [arXiv:2405.21060; unverified]   Runs long_500k (O(1) state).

TurboKV applicability: no KV cache to page — the serve path routes the
whole-sequence SSM state as a single-page store entry (DESIGN.md
§Arch-applicability: technique inapplicable to SSM state, degenerate case).
"""
from repro_torch.configs.base import ArchConfig, register

MAMBA2_370M = register(ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50_280,
    d_state=128, ssm_heads=32, ssm_head_dim=64, d_conv=4, ssm_expand=2,
    ssm_chunk=128, ssm_groups=1,
    tie_embeddings=True,
))
