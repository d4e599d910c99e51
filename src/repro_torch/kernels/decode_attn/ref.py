"""The plain PyTorch version of K6: decode attention as the reference's
``decode_attn/ref.py`` and ``models/attention.py:_decode_attend`` compute
it (scores over every cache row, invalid positions set to -1e30, softmax
with its denominator clamped at 1e-30).  The wrapper runs it on CPU
tensors; on the card only ``chip_smoke.py`` and the CUDA tests call it,
to hold the kernel to it."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor, *, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, D) over the cache k / v (B, S, Hkv, D); lengths (B,).
    Positions ``p < lengths`` (and ``p >= lengths - window``) attend; a
    length above S attends to all S rows.  Output in q's dtype."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    qg = (q.float() * scale).reshape(B, Hkv, G, D)
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k.float())
    pos = torch.arange(S, device=q.device)[None, None, None, :]
    length = lengths.to(torch.int64)[:, None, None, None]
    valid = pos < length
    if window is not None:
        valid &= pos >= length - window
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    p = e / e.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.reshape(B, Hq, D).to(q.dtype)
