"""Attention variants (counterpart of ``repro.models.attention``): GQA
(qk-norm, QKV bias, sliding windows) and MLA (multi-head latent
attention, minicpm3).

* :func:`gqa_seq`    full sequence (prefill) through the blockwise flash
                     attention; optionally returns the K/V it computed.
* :func:`gqa_decode` one token against a fixed-capacity cache, through the
                     decode-attention wrapper (K6 on the card).
* :func:`mla_seq`    full sequence: K/V decompressed from the latent, then
                     the flash attention (q / k of width nd + rd, v of vd).
* :func:`mla_decode` one token in the absorbed form, against the latent
                     cache (ckv, krope): plain float32 einsums, as the
                     reference computes it outside Pallas (its score width
                     kvr + rd and value width kvr are none of K6's head
                     dims).

Parameter leaves carry no layer axis here; the transformer stacks them
(L, ...) and loops.  Projections compute in the parameters' dtype (which
must be ``cfg.dtype``); softmax and norms in f32.  The sequence paths pin
q / k / v and the attention output through ``distributed.constraints``
(identity unless a policy is installed, and on a plain tensor).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.constraints import constrain
from repro_torch.kernels.decode_attn.ops import decode_attn
from repro_torch.models.common import apply_rope, dense_init, rms_norm
from repro_torch.models.flash import NEG_INF, flash_attention


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
    """q (B, T, Hq, Dh), k and v (B, T, Hkv, Dh), normed and rotated.  On
    a ``DTensor`` x, each rank's own heads as plain tensors, and the
    ``DTensor`` whose layout the attention output takes
    (``tensor_parallel.local_heads``); else that fourth item is None."""
    B, T, _ = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    like = None
    if TP.is_dtensor(q):
        q, k, v, like = TP.local_heads(q, k, v, Hq, Hkv, p["wo"])
        split = TP.whole_heads_split(like, p["wo"])
        q_norm, k_norm = (TP.local_replica(p[n], like, split)
                          if cfg.qk_norm else None
                          for n in ("q_norm", "k_norm"))
    else:
        q = q.reshape(B, T, Hq, Dh)
        k = k.reshape(B, T, Hkv, Dh)
        v = v.reshape(B, T, Hkv, Dh)
        q_norm, k_norm = p.get("q_norm"), p.get("k_norm")
    if cfg.qk_norm:
        q = rms_norm(q, q_norm, cfg.norm_eps, plus_one=cfg.norm_plus_one)
        k = rms_norm(k, k_norm, cfg.norm_eps, plus_one=cfg.norm_plus_one)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v, like


def gqa_seq(x, p, cfg: ArchConfig, *, is_global: bool = False, positions=None,
            q_block: int = 256, kv_block: int = 512, return_kv: bool = False):
    """Full-sequence GQA; positions default to arange(T)."""
    B, T, _ = x.shape
    if positions is None:
        dev = x.to_local().device if TP.is_dtensor(x) else x.device
        positions = torch.arange(T, dtype=torch.int32, device=dev)
    q, k, v, like = _project_qkv(x, p, cfg, positions)
    if like is not None and return_kv:
        raise NotImplementedError("sharded serving caches (cache_specs) "
                                  "are not ported: return_kv needs one card")
    q = constrain(q, "attn_q")
    k = constrain(k, "attn_kv")
    v = constrain(v, "attn_kv")
    out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                          is_global=is_global, q_block=q_block,
                          kv_block=kv_block)
    out = constrain(out, "attn_out")
    if like is not None:        # each rank's heads back into the DTensor
        out = TP.from_local_heads(out, like, p["wo"])
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
    q, k_t, v_t, _ = _project_qkv(x_t, p, cfg, positions)

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


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3 / DeepSeek lineage)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
             n_layers: int) -> dict:
    """The MLA parameters of ``n_layers`` stacked layers."""
    D, H = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    L, dev = (n_layers,), gen.device
    return {
        "wdq": dense_init(gen, L + (D, qr), dtype),
        "q_norm": torch.ones(L + (qr,), dtype=dtype, device=dev),
        "wuq": dense_init(gen, L + (qr, H * (nd + rd)), dtype),
        "wdkv": dense_init(gen, L + (D, kvr + rd), dtype),
        "kv_norm": torch.ones(L + (kvr,), dtype=dtype, device=dev),
        "wukv": dense_init(gen, L + (kvr, H * (nd + vd)), dtype),
        "wo": dense_init(gen, L + (H * vd, D), dtype),
    }


def _mla_q(x, p, cfg: ArchConfig, positions):
    B, T, _ = x.shape
    nd, rd = cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = rms_norm(x @ p["wdq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wuq"]).reshape(B, T, -1, nd + rd)
    qn, qr = q[..., :nd], q[..., nd:]
    return qn, apply_rope(qr, positions, cfg.rope_theta)


def _mla_ckv(x, p, cfg: ArchConfig, positions):
    """The latent (B, T, kvr) and the shared rotary key (B, T, rd)."""
    kvr = cfg.kv_lora_rank
    ckv_full = x @ p["wdkv"]
    ckv = rms_norm(ckv_full[..., :kvr], p["kv_norm"], cfg.norm_eps)
    krope = apply_rope(ckv_full[..., kvr:][:, :, None, :], positions,
                       cfg.rope_theta)[:, :, 0]
    return ckv, krope


def mla_seq(x, p, cfg: ArchConfig, *, positions=None, q_block: int = 256,
            kv_block: int = 512, return_kv: bool = False):
    """Full-sequence MLA: decompress K/V and run the flash attention.  On
    a ``DTensor`` x, each rank's own heads as plain tensors
    (``tensor_parallel.MLAHeads``), and a partial sum over "model"."""
    H, nd, rd, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    heads = None
    if TP.is_dtensor(x):
        if return_kv:
            raise NotImplementedError("sharded serving caches (cache_specs) "
                                      "are not ported: return_kv needs one "
                                      "card")
        heads = TP.MLAHeads(x, p, H)
        x, p, H = heads.x, heads.params, heads.h
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32, device=x.device)
    qn, qr = _mla_q(x, p, cfg, positions)
    ckv, krope = _mla_ckv(x, p, cfg, positions)
    kv = (ckv @ p["wukv"]).reshape(B, T, H, nd + vd)
    kn, v = kv[..., :nd], kv[..., nd:]
    q = torch.cat([qn, qr], dim=-1)
    k = torch.cat([kn, krope[:, :, None, :].expand(B, T, H, rd)], dim=-1)
    q = constrain(q, "attn_q")
    k = constrain(k, "attn_q")  # MLA: K is per-head too
    v = constrain(v, "attn_q")
    out = flash_attention(q, k, v, causal=True, q_block=q_block,
                          kv_block=kv_block, scale=(nd + rd) ** -0.5)
    out = constrain(out, "attn_out")
    if heads is not None:
        return heads.out(out)
    y = out.reshape(B, T, -1) @ p["wo"]
    if return_kv:
        return y, (ckv, krope)
    return y


def mla_decode(x_t, p, cfg: ArchConfig, ckv_cache, krope_cache, length):
    """Absorbed-form MLA decode: scores and context against the latent
    cache, ckv (B, S, kvr) and krope (B, S, rd), both updated in place.
    q_nope is mapped into latent space once, so a token costs O(S * (kvr +
    rd)) a head instead of decompressing O(S * H * (nd + vd)).  Returns
    ``(y, ckv_cache, krope_cache)``."""
    B = x_t.shape[0]
    H, nd, rd, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    positions = length[:, None]
    qn, qr = _mla_q(x_t, p, cfg, positions)          # (B,1,H,nd),(B,1,H,rd)
    ckv_t, krope_t = _mla_ckv(x_t, p, cfg, positions)
    _write_at(ckv_cache, ckv_t[:, 0], length)
    _write_at(krope_cache, krope_t[:, 0], length)
    new_len = length + 1

    wukv = p["wukv"].reshape(kvr, H, nd + vd)
    wuk, wuv = wukv[..., :nd], wukv[..., nd:]
    # absorb: q'(B, H, kvr) = qn . wuk^T
    q_lat = torch.einsum("bhn,rhn->bhr", qn[:, 0].float(), wuk.float())
    s = torch.einsum("bhr,bsr->bhs", q_lat, ckv_cache.float())
    s = s + torch.einsum("bhr,bsr->bhs", qr[:, 0].float(), krope_cache.float())
    s = s * (nd + rd) ** -0.5
    S = ckv_cache.shape[1]
    valid = (torch.arange(S, device=s.device)[None, None, :]
             < new_len[:, None, None])
    s = torch.where(valid, s, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    attn = e / e.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    ctx = torch.einsum("bhs,bsr->bhr", attn, ckv_cache.float())  # latent ctx
    out = torch.einsum("bhr,rhv->bhv", ctx, wuv.float())         # (B, H, vd)
    y = out.reshape(B, 1, H * vd).to(x_t.dtype) @ p["wo"]
    return y, ckv_cache, krope_cache
