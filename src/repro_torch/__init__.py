"""repro_torch — the TurboKV reproduction on PyTorch and CUDA.

A second package beside the JAX reference ``repro``: the same data plane
(switch match-action routing over a slot-pool directory, sorted-slab
store, hop plans, the discrete-event timing engine) and the same closed
control loop (:class:`repro_torch.cluster.EpochDriver`), written as plain
functions on tensors.  The match-action and slab-probe hot path runs as
hand-written CUDA kernels on an NVIDIA Hopper card
(:mod:`repro_torch.kernels.range_match`); on CPU tensors the kernels'
plain PyTorch versions run instead.  The same directory routes the KV
cache of a continuous-batching LLM serving engine
(:mod:`repro_torch.serving`) over the dense, Mamba-2 and Hymba
decoder-only models (:mod:`repro_torch.models`), whose decode attention
and SSD chunked scan are CUDA kernels too
(:mod:`repro_torch.kernels.decode_attn`,
:mod:`repro_torch.kernels.ssd_chunk`).

This package imports ``torch`` and ``numpy`` and never ``jax``.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
