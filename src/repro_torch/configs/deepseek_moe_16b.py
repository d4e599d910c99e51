"""deepseek-moe-16b — 28L d2048 16H (MHA kv=16, head_dim 128) vocab 102400;
fine-grained MoE: 64 routed experts top-6 + 2 shared (expert d_ff 1408);
first layer dense (d_ff 10944). [arXiv:2401.06066; hf]
"""
from repro_torch.configs.base import ArchConfig, register

DEEPSEEK_MOE_16B = register(ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944, vocab_size=102_400,
    n_experts=64, top_k=6, n_shared_experts=2, expert_d_ff=1408,
    first_dense_layers=1, moe_layer_step=1, moe_capacity_factor=1.25,
    router_softmax_after_topk=True,
    rope_theta=10_000.0,
    skip_shapes=(("long_500k", "pure full-attention arch: 500k-KV decode is excluded per assignment; sub-quadratic attns only"),),
))
