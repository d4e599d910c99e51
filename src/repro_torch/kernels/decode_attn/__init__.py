"""K6: flash-decoding GQA attention over the KV cache as a CUDA kernel
(``kernel``), with its plain PyTorch version (``ref``)."""

from repro_torch.kernels.decode_attn.kernel import launches, reset_launches
from repro_torch.kernels.decode_attn.ops import decode_attn
from repro_torch.kernels.decode_attn.ref import decode_attn_ref

__all__ = ["decode_attn", "decode_attn_ref", "launches", "reset_launches"]
