"""Model zoo on PyTorch: all ten assigned architectures, the decoder-only
families (dense, MLA, MoE, SSM, hybrid, vlm) and the encoder-decoder
(counterpart of ``repro.models``)."""

from repro_torch.models.model import (
    abstract_params,
    decode_step,
    empty_cache,
    init_params,
    loss_fn,
    param_bytes,
    param_count,
    prefill,
)

__all__ = ["init_params", "loss_fn", "prefill", "decode_step",
           "empty_cache", "abstract_params", "param_count", "param_bytes"]
