"""K7: the Mamba-2 SSD chunked scan as a CUDA kernel (``kernel``), with
its plain PyTorch versions (``ref``) and the public wrappers (``ops``)."""

from repro_torch.kernels.ssd_chunk.kernel import launches, reset_launches
from repro_torch.kernels.ssd_chunk.ops import ssd_decode_step, ssd_scan
from repro_torch.kernels.ssd_chunk.ref import ssd_chunked_ref, ssd_sequential_ref

__all__ = ["ssd_scan", "ssd_decode_step", "ssd_chunked_ref",
           "ssd_sequential_ref", "launches", "reset_launches"]
