"""whisper-small — enc-dec, 12L+12L d768 12H d_ff 3072 vocab 51865; conv
audio frontend STUBBED (input_specs provides precomputed frame embeddings);
sinusoidal positions on both stacks (decoder's learned table replaced by
sinusoids so position-table size is shape-independent — DESIGN.md).
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ArchConfig, register

WHISPER_SMALL = register(ArchConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51_865,
    n_encoder_layers=12, encoder_len=1500,
    act="gelu", norm_eps=1e-5,
    skip_shapes=(
        ("long_500k", "audio enc-dec: context architecturally bounded (30 s windows); also full attention"),
    ),
))
