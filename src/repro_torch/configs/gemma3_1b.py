"""gemma3-1b — 26L d1152 4H (kv=1) d_ff 6912 vocab 262144; 5:1 local:global
sliding-window 512; gemma-style (1+w) RMSNorm, sandwich norms, qk-norm,
tied embeddings, sqrt(d) embed scale. [hf:google/gemma-3-1b-pt; unverified]

Runs long_500k: 5/6 layers are 512-window local; the 1/6 global layers are
linear in S at decode time (DESIGN.md skip notes).
"""
from repro_torch.configs.base import ArchConfig, register

GEMMA3_1B = register(ArchConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262_144,
    sliding_window=512, global_layer_every=6,
    rope_theta=1_000_000.0,  # global-layer theta; local layers' 10k theta
                             # folded (single-theta simplification, DESIGN.md)
    qk_norm=True, tie_embeddings=True,
    embed_scale=1152 ** 0.5, norm_plus_one=True, post_norms=True,
    act="gelu",
))
