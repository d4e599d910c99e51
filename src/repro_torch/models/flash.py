"""Blockwise (flash-style) attention for the prefill path (counterpart of
``repro.models.flash``): online softmax over KV blocks, so peak memory is
O(q_block * kv_block) per head.  GQA aware; causal masking, sliding
windows and the per-layer ``is_global`` switch (which lifts the window).

Plain PyTorch: the reference runs this as jnp, not as a Pallas kernel.
The block loop is the reference's, so its sums are taken in the same
order; the only difference is that a KV block masked for every query row
of a q block is skipped.  That is exact: before the first unmasked block
such a block's running sums are wiped by ``corr = exp(-1e30 - m) = 0``,
and after it the block adds ``p = 0`` with ``corr = 1``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def flash_attention(
    q: torch.Tensor,                 # (B, T, Hq, D)
    k: torch.Tensor,                 # (B, S, Hkv, D)
    v: torch.Tensor,                 # (B, S, Hkv, Dv)
    *,
    causal: bool = True,
    window: int | None = None,       # sliding window width (None = full)
    is_global: bool = False,         # lifts the window (a global layer)
    q_offset: int = 0,               # absolute position of q[0]
    q_block: int = 256,
    kv_block: int = 512,
    scale: float | None = None,
) -> torch.Tensor:
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    if is_global:
        window = None

    qb = min(q_block, T)
    kb = min(kv_block, S)
    Tp = -(-T // qb) * qb
    Sp = -(-S // kb) * kb
    if Tp != T:
        q = F.pad(q, (0, 0, 0, 0, 0, Tp - T))
    if Sp != S:
        k = F.pad(k, (0, 0, 0, 0, 0, Sp - S))
        v = F.pad(v, (0, 0, 0, 0, 0, Sp - S))

    nq, nk = Tp // qb, Sp // kb
    dev = q.device
    qr = (q.float() * scale).reshape(B, nq, qb, Hkv, G, D)
    kr = k.float().reshape(B, nk, kb, Hkv, D)
    vr = v.float().reshape(B, nk, kb, Hkv, Dv)
    outs = []
    for qi in range(nq):
        q_i = qr[:, qi]                                   # (B, qb, Hkv, G, D)
        q_lo = q_offset + qi * qb
        q_pos = q_lo + torch.arange(qb, device=dev)       # (qb,)
        m = torch.full((B, Hkv, G, qb), NEG_INF, device=dev)
        l = torch.zeros((B, Hkv, G, qb), device=dev)
        acc = torch.zeros((B, Hkv, G, qb, Dv), device=dev)
        for kj in range(nk):
            k_lo = kj * kb
            if ((causal and k_lo > q_lo + qb - 1)
                    or (window is not None and k_lo + kb - 1 <= q_lo - window)):
                continue                                  # masked for every row
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_i, kr[:, kj])
            kv_pos = k_lo + torch.arange(kb, device=dev)  # (kb,)
            mask = (kv_pos[None, :] < S).expand(qb, kb)   # padding
            if causal:
                mask = mask & (kv_pos[None, :] <= q_pos[:, None])
            if window is not None:
                mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(dim=-1)
            acc = corr[..., None] * acc + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                       vr[:, kj])
            m = m_new
        outs.append(acc / l[..., None].clamp(min=1e-30))  # (B, Hkv, G, qb, Dv)
    out = torch.stack(outs, dim=1)                        # (B, nq, Hkv, G, qb, Dv)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, Tp, Hq, Dv)
    return out[:, :T].to(q.dtype)
