"""llama4-maverick-400b-a17b — 48L d5120 40H (kv=8); MoE every other layer
with 128 routed experts (top-1, d_ff 8192) + 1 shared expert; dense layers
d_ff 16384; vocab 202048; early-fusion multimodal (text path built; fusion
frontend stubbed like other modality stubs).
[hf:meta-llama/Llama-4-Scout-17B-16E scaled per assignment; unverified]

param/opt dtypes bf16 so params+state fit one 256-chip v5e pod
(DESIGN.md §5: 400e9*(2+2+2)B = 2.4 TB < 4 TB).
"""
from repro_torch.configs.base import ArchConfig, register

LLAMA4_MAVERICK = register(ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=202_048,
    n_experts=128, top_k=1, n_shared_experts=1, expert_d_ff=8192,
    moe_layer_step=2, moe_capacity_factor=1.25,
    rope_theta=500_000.0,
    param_dtype="bfloat16", opt_state_dtype="bfloat16",
    skip_shapes=(("long_500k", "pure full-attention arch: 500k-KV decode is excluded per assignment; sub-quadratic attns only"),),
))
