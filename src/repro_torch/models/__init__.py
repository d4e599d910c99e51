"""Model zoo on PyTorch: all ten assigned architectures, the decoder-only
families (dense, MLA, MoE, SSM, hybrid, vlm) and the encoder-decoder
(counterpart of ``repro.models``)."""

from repro_torch.models.model import (
    decode_step,
    empty_cache,
    init_params,
    param_bytes,
    param_count,
    prefill,
)

__all__ = ["init_params", "prefill", "decode_step", "empty_cache",
           "param_count", "param_bytes"]
