"""The public decode-attention wrapper (counterpart of
``repro.kernels.decode_attn.ops``): the plain version on CPU tensors, K6
on CUDA tensors.  No padding of S: the kernel indexes the cache as it
is, so a length above S attends to the S rows and nothing else (the
reference's Pallas wrapper pads S and then attends to the zero rows,
ROADMAP F8)."""

from __future__ import annotations

import torch

from repro_torch.device import on_cpu
from repro_torch.kernels.decode_attn import kernel
from repro_torch.kernels.decode_attn.ref import decode_attn_ref


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor, *, window: int | None = None,
                scale: float | None = None) -> torch.Tensor:
    """GQA decode attention: q (B, Hq, D) over the cache k / v (B, S, Hkv,
    D), lengths (B,) int32.  Returns (B, Hq, D) in q's dtype."""
    if on_cpu(q, k, v, lengths):
        return decode_attn_ref(q, k, v, lengths, window=window, scale=scale)
    return kernel.decode_attn(q, k, v, lengths, window=window, scale=scale)
