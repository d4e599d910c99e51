"""Mamba-2 (SSD) mixer block: conv -> SSD scan -> gated norm -> out proj
(counterpart of ``repro.models.ssm``).

The sequence path (prefill) runs the chunked SSD scan through
:func:`repro_torch.kernels.ssd_chunk.ssd_scan`: K7 on the card (its
backward the plain version's vector-Jacobian product), the plain version
on the CPU.  (The reference's model calls the jnp chunked version,
``use_pallas=False``; K7 computes the same function.)  The decode path
carries (conv_state, ssm_state) and costs O(H P N) a token, in plain
tensor code.  Parameter leaves carry no layer axis here; the transformer
stacks them (L, ...) and loops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.kernels.ssd_chunk.ops import ssd_decode_step, ssd_scan
from repro_torch.models.common import dense_init, rms_norm


def _dims(cfg: ArchConfig):
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.d_state, cfg.ssm_groups
    d_inner = H * P
    conv_ch = d_inner + 2 * G * N
    d_in_proj = 2 * d_inner + 2 * G * N + H
    return H, P, N, G, d_inner, conv_ch, d_in_proj


def init_ssm(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
             n_layers: int) -> dict:
    """The SSM parameters of ``n_layers`` stacked layers.  ``A_log``,
    ``D`` and ``dt_bias`` follow the reference's formulas (``A_log`` in
    float32) and serve in ``dtype`` like every other leaf (ROADMAP F7)."""
    H, P, N, G, d_inner, conv_ch, d_in_proj = _dims(cfg)
    D = cfg.d_model
    L, dev = (n_layers,), gen.device
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                     device=dev))
    return {
        "in_proj": dense_init(gen, L + (D, d_in_proj), dtype),
        "conv_w": dense_init(gen, L + (cfg.d_conv, conv_ch), dtype, scale=0.2),
        "conv_b": torch.zeros(L + (conv_ch,), dtype=dtype, device=dev),
        "A_log": a_log.expand(L + (H,)).to(dtype).contiguous(),
        "D": torch.ones(L + (H,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros(L + (H,), dtype=dtype, device=dev),
        "norm_w": torch.ones(L + (d_inner,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, L + (d_inner, D), dtype),
    }


def _split_proj(zxbcdt, d_inner: int, conv_ch: int):
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner: d_inner + conv_ch]
    dt = zxbcdt[..., d_inner + conv_ch:]
    return z, xBC, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv, width d_conv, via shifted adds (w (K, C))."""
    K, T = w.shape[0], xBC.shape[1]
    out = xBC * w[-1]
    for i in range(1, K):
        shifted = F.pad(xBC, (0, 0, i, 0))[:, :T]
        out = out + shifted * w[-1 - i]
    return out + b


def ssm_seq(x, p, cfg: ArchConfig, *, return_state: bool = False,
            init_state=None):
    """Full-sequence SSD mixer.  x (B, T, D) -> (B, T, D); with
    ``return_state`` also the final SSM state (B, H, P, N) f32 and the
    decode conv state, the last d_conv - 1 pre-conv rows (B, d_conv - 1,
    conv_ch), zero-padded on the left when T is shorter.

    On a ``DTensor`` x (the sharded train step) each rank runs the mixer
    on its own SSD heads, from plain tensors
    (``tensor_parallel.SSDHeads``), and the result is a ``DTensor``: a
    partial sum over "model" where ``out_proj``'s rows are split."""
    H, P, N, G, d_inner, conv_ch, _ = _dims(cfg)
    shard = None
    if TP.is_dtensor(x):
        if return_state or init_state is not None:
            raise NotImplementedError("sharded serving caches (cache_specs) "
                                      "are not ported: the SSM states need "
                                      "one card")
        shard = TP.SSDHeads(x, p, H, P, N, G)
        x, p, H, G = shard.x, shard.params, shard.h, shard.groups
        d_inner, conv_ch = H * P, H * P + 2 * G * N
    B, T, _ = x.shape

    zxbcdt = x @ p["in_proj"]
    z, xBC_pre, dt = _split_proj(zxbcdt, d_inner, conv_ch)
    xBC = F.silu(_causal_conv(xBC_pre, p["conv_w"], p["conv_b"]))
    xs = xBC[..., :d_inner].reshape(B, T, H, P)
    Bm = xBC[..., d_inner: d_inner + G * N].reshape(B, T, G, N)
    Cm = xBC[..., d_inner + G * N:].reshape(B, T, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if init_state is None:
        init_state = torch.zeros((B, H, P, N), dtype=torch.float32,
                                 device=x.device)
    y, fstate = ssd_scan(
        xs.float(), dt, A.float(), Bm.float(), Cm.float(), init_state,
        chunk=min(cfg.ssm_chunk, max(8, T)))
    y = y + p["D"][None, None, :, None] * xs.float()
    y = y.reshape(B, T, d_inner).to(x.dtype)
    if shard is not None:
        return shard.out(y, z, cfg.norm_eps)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_state:
        tail = xBC_pre[:, -(cfg.d_conv - 1):, :]
        pad = max(0, (cfg.d_conv - 1) - T)
        if pad:
            tail = F.pad(tail, (0, 0, pad, 0))
        return out, fstate, tail
    return out


def ssm_decode(x_t, p, cfg: ArchConfig, conv_state, ssm_state):
    """One-token decode.  x_t (B, 1, D); conv_state (B, d_conv - 1,
    conv_ch); ssm_state (B, H, P, N).  Returns (y (B, 1, D),
    new_conv_state, new_ssm_state)."""
    B = x_t.shape[0]
    H, P, N, G, d_inner, conv_ch, _ = _dims(cfg)

    zxbcdt = x_t @ p["in_proj"]
    z, xBC_t, dt = _split_proj(zxbcdt, d_inner, conv_ch)     # (B, 1, *)
    window = torch.cat([conv_state, xBC_t], dim=1)           # (B, d_conv, C)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xBC = F.silu(conv_out)                                   # (B, C)
    new_conv_state = window[:, 1:]

    xs = xBC[:, :d_inner].reshape(B, H, P)
    Bm = xBC[:, d_inner: d_inner + G * N].reshape(B, G, N)[:, 0]
    Cm = xBC[:, d_inner + G * N:].reshape(B, G, N)[:, 0]
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    y, new_ssm = ssd_decode_step(xs.float(), dt1, A, Bm.float(), Cm.float(),
                                 ssm_state)
    y = y + p["D"][None, :, None] * xs.float()
    y = y.reshape(B, 1, d_inner).to(x_t.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], new_conv_state, new_ssm

