"""Model zoo on PyTorch: the dense, SSM and hybrid decoder-only families
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
