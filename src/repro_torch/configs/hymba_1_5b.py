"""hymba-1.5b — 32L d1600, parallel attention (25H, kv=5, head_dim 64) +
mamba heads (d_inner 3200, d_state 16) per layer; sliding-window 1024 with
full-attention layers {0, 15, 31}; 128 learned meta tokens; d_ff 5504.
[arXiv:2411.13676; hf]   Runs long_500k (hybrid: window + O(1) SSM state).
"""
from repro_torch.configs.base import ArchConfig, register

HYMBA_1_5B = register(ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32_001,
    sliding_window=1024, global_layers=(0, 15, 31),
    d_state=16, ssm_heads=50, ssm_head_dim=64, d_conv=4, ssm_chunk=128,
    n_meta_tokens=128,
))
