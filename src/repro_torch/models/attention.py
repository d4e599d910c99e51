"""Attention, the GQA half (counterpart of ``repro.models.attention``):
qk-norm, QKV bias and sliding windows.

* :func:`gqa_seq`    full sequence (prefill) through the blockwise flash
                     attention; optionally returns the K/V it computed.
* :func:`gqa_decode` one token against a fixed-capacity cache, through the
                     decode-attention wrapper (K6 on the card).

Parameter leaves carry no layer axis here; the transformer stacks them
(L, ...) and loops.  Projections compute in the parameters' dtype (which
must be ``cfg.dtype``); softmax and norms in f32.  The reference's
``constrain`` sharding hints are no-ops on one device and are dropped.
MLA (minicpm3) is not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_attn.ops import decode_attn
from repro_torch.models.common import apply_rope, dense_init, rms_norm
from repro_torch.models.flash import flash_attention


def init_gqa(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
             n_layers: int) -> dict:
    """The GQA parameters of ``n_layers`` stacked layers."""
    D, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L, dev = (n_layers,), gen.device
    p = {
        "wq": dense_init(gen, L + (D, Hq * Dh), dtype),
        "wk": dense_init(gen, L + (D, Hkv * Dh), dtype),
        "wv": dense_init(gen, L + (D, Hkv * Dh), dtype),
        "wo": dense_init(gen, L + (Hq * Dh, D), dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", Hq * Dh), ("bk", Hkv * Dh), ("bv", Hkv * Dh)):
            p[name] = torch.zeros(L + (width,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        fill = torch.zeros if cfg.norm_plus_one else torch.ones
        p["q_norm"] = fill(L + (Dh,), dtype=dtype, device=dev)
        p["k_norm"] = fill(L + (Dh,), dtype=dtype, device=dev)
    return p


def _project_qkv(x, p, cfg: ArchConfig, positions):
    B, T, _ = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, Hq, Dh)
    k = k.reshape(B, T, Hkv, Dh)
    v = v.reshape(B, T, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_seq(x, p, cfg: ArchConfig, *, is_global: bool = False, positions=None,
            q_block: int = 256, kv_block: int = 512, return_kv: bool = False):
    """Full-sequence GQA; positions default to arange(T)."""
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(x, p, cfg, positions)
    out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                          is_global=is_global, q_block=q_block,
                          kv_block=kv_block)
    y = out.reshape(B, T, -1) @ p["wo"]
    if return_kv:
        return y, (k, v)
    return y


def gqa_decode(x_t, p, cfg: ArchConfig, k_cache, v_cache, length, *,
               is_global: bool = False):
    """One-token decode.  x_t (B, 1, D); caches (B, S, Hkv, Dh), updated in
    place; length (B,) int32.  Returns ``(y, k_cache, v_cache)``."""
    B = x_t.shape[0]
    positions = length[:, None]                       # (B, 1) absolute position
    q, k_t, v_t = _project_qkv(x_t, p, cfg, positions)

    # append the new token's K/V at position `length`
    _write_at(k_cache, k_t[:, 0], length)
    _write_at(v_cache, v_t[:, 0], length)

    window = None if is_global else cfg.sliding_window
    out = _decode_attend(q[:, 0], k_cache, v_cache, length + 1, window=window)
    y = out.reshape(B, 1, -1) @ p["wo"]
    return y, k_cache, v_cache


def _write_at(cache: torch.Tensor, row: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
    """cache (B, S, ...) <- row (B, ...) at per-example position idx (B,),
    in place.  The reference's masked blend: a position outside [0, S)
    writes nothing.  Each example's one row is read, blended and written
    back (at a clamped index), so no index leaves the cache and the host
    never waits for the device."""
    B, S = cache.shape[0], cache.shape[1]
    hit = (idx >= 0) & (idx < S)
    at = idx.clamp(0, S - 1).to(torch.int64)
    ar = torch.arange(B, device=cache.device)
    hit = hit.reshape((B,) + (1,) * (cache.dim() - 2))
    cache[ar, at] = torch.where(hit, row.to(cache.dtype), cache[ar, at])
    return cache


def _decode_attend(q, k, v, lengths, *, window: int | None = None,
                   scale: float | None = None):
    """Decode attention (B, Hq, D) x (B, S, Hkv, D) over the positions
    ``p < lengths`` (and ``p >= lengths - window``): K6 on the card, its
    plain version on the CPU."""
    return decode_attn(q.contiguous(), k, v, lengths.to(torch.int32), window=window,
                       scale=scale)


def init_mla(*args, **kwargs):
    raise NotImplementedError("MLA (minicpm3) is not ported yet")


mla_seq = mla_decode = init_mla
