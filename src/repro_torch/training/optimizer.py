"""Optimizers (AdamW, Adafactor) and the learning-rate schedule, from
scratch (counterpart of ``repro.training.optimizer``).

The state dtype is configurable per arch (``ArchConfig.opt_state_dtype``).
The per-element updates run on the parameters' device.  The step's scalars
(the learning rate, AdamW's bias corrections, Adafactor's decay) are
computed on the host from the step count, in float32 as the reference's
compiled step computes them (ROADMAP F18): its ``b ** t`` and ``cos`` are
the C library's ``powf`` and ``cosf``; a division by a constant is a
product with the constant's float32 reciprocal; and ``a + b * c`` is one
fused multiply-add.  Plain torch float32 differs from it by an ulp in
some steps (on the CPU against the jitted reference: its ``pow`` in 22 of
20,000 steps at b1 0.9, ``float64`` cos rounded once in 278 of 20,001
schedule values).  The same host floats drive the CPU and the card.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import math

import numpy as np
import torch

from repro_torch.prng import fma_f32
from repro_torch.training import tree as T


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


_f32 = np.float32
_LIBM = None


def _libm():
    global _LIBM
    if _LIBM is None:
        lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
        lib.powf.restype = ctypes.c_float
        lib.cosf.argtypes = [ctypes.c_float]
        lib.cosf.restype = ctypes.c_float
        _LIBM = lib
    return _LIBM


def _recip(c) -> np.float32:
    """The float32 reciprocal of a constant divisor."""
    return _f32(1) / _f32(c)


def _powf(base: float, exp: float) -> float:
    return float(_libm().powf(float(_f32(base)), float(_f32(exp))))


def schedule(cfg: OptConfig, step) -> float:
    """Linear warmup + cosine decay to ``min_lr_ratio``: the float32 value
    the reference's compiled step computes at ``step`` (a host int)."""
    s = _f32(int(step))
    warm = s * _recip(max(cfg.warmup_steps, 1))
    prog = (s - _f32(cfg.warmup_steps)) * _recip(
        max(cfg.total_steps - cfg.warmup_steps, 1))
    prog = min(max(prog, _f32(0)), _f32(1))
    cos = _f32(_libm().cosf(float(_f32(math.pi) * prog)))
    k = _f32((1 - cfg.min_lr_ratio) * 0.5)
    decay = _f32(fma_f32(k, _f32(1) + cos, _f32(cfg.min_lr_ratio)).item())
    return float(_f32(cfg.lr) * (warm if s < _f32(cfg.warmup_steps) else decay))


def bias_corrections(cfg: OptConfig, step: int) -> tuple[float, float]:
    """AdamW's ``1 - b1 ** t`` and ``1 - b2 ** t`` at step ``t``."""
    t = float(_f32(step))
    return (float(_f32(1) - _f32(_powf(cfg.b1, t))),
            float(_f32(1) - _f32(_powf(cfg.b2, t))))


def adafactor_decay(step: int) -> float:
    """Adafactor's ``1 - (t + 1) ** -0.8`` at step ``t``."""
    return float(_f32(1) - _f32(_powf(_f32(step) + _f32(1), -0.8)))


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, the leaves added in the
    reference's (sorted-key) order."""
    return torch.sqrt(sum(x.float().square().sum() for x in T.leaves(tree)))


def clip_by_global_norm(grads: dict, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return T.tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _step_scalars(opt_state: dict, cfg: OptConfig):
    """The new step count (host int and device tensor) and the lr.  A
    state on the ``meta`` device holds no count to read (the dry-run's
    abstract step): the host takes it for the first step."""
    t = opt_state["step"]
    step = 1 if t.is_meta else int(t) + 1
    return step, t + 1, schedule(cfg, step)


def _lr_metrics(lr: float, gnorm: torch.Tensor) -> dict:
    return {"lr": torch.tensor(lr, dtype=torch.float32, device=gnorm.device),
            "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _zeros_like(p: torch.Tensor, dtype: torch.dtype, shape=None):
    return torch.zeros(p.shape if shape is None else shape, dtype=dtype,
                       device=p.device)


def _step0(params: dict) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=T.leaves(params)[0].device)


def adamw_init(params: dict, state_dtype: str = "float32") -> dict:
    dt = getattr(torch, state_dtype)
    zeros = lambda p: _zeros_like(p, dt)  # noqa: E731
    return {"m": T.tree_map(zeros, params), "v": T.tree_map(zeros, params),
            "step": _step0(params)}


def adamw_update(params: dict, grads: dict, opt_state: dict, cfg: OptConfig):
    step, step_t, lr = _step_scalars(opt_state, cfg)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    bc1, bc2 = bias_corrections(cfg, step)

    def upd(p, g, m, v):
        gf = g.float()
        m32, v32 = m.float(), v.float()
        m_new = cfg.b1 * m32 + (1 - cfg.b1) * gf
        v_new = cfg.b2 * v32 + (1 - cfg.b2) * gf.square()
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            update = update + cfg.weight_decay * p.float()
        p_new = p.float() - lr * update
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    out = T.tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    new_params, new_m, new_v = T.unzip(out, 3)
    return (new_params, {"m": new_m, "v": new_v, "step": step_t},
            _lr_metrics(lr, gnorm))


# ---------------------------------------------------------------------------
# Adafactor (factored second moment: O(n + m) state for (n, m) matrices)
# ---------------------------------------------------------------------------


def adafactor_init(params: dict, state_dtype: str = "float32") -> dict:
    dt = getattr(torch, state_dtype)

    def zeros(p):
        if p.dim() >= 2:
            return {"vr": _zeros_like(p, dt, p.shape[:-1]),
                    "vc": _zeros_like(p, dt, p.shape[:-2] + p.shape[-1:])}
        return {"v": _zeros_like(p, dt)}

    return {"f": T.tree_map(zeros, params), "step": _step0(params)}


def adafactor_update(params: dict, grads: dict, opt_state: dict,
                     cfg: OptConfig):
    step, step_t, lr = _step_scalars(opt_state, cfg)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    decay = adafactor_decay(step)
    keep = float(_f32(1) - _f32(decay))

    def upd(p, g, f):
        gf = g.float()
        g2 = gf.square() + 1e-30
        if p.dim() >= 2:
            vr = decay * f["vr"].float() + keep * g2.mean(dim=-1)
            vc = decay * f["vc"].float() + keep * g2.mean(dim=-2)
            denom = torch.sqrt(
                vr[..., None] * vc[..., None, :] / torch.clamp(
                    vr.mean(dim=-1, keepdim=True)[..., None], min=1e-30))
            update = gf / torch.clamp(denom, min=1e-30)
            newf = {"vr": vr.to(f["vr"].dtype), "vc": vc.to(f["vc"].dtype)}
        else:
            v = decay * f["v"].float() + keep * g2
            update = gf / torch.sqrt(torch.clamp(v, min=1e-30))
            newf = {"v": v.to(f["v"].dtype)}
        # update clipping (RMS <= 1)
        rms = torch.sqrt(update.square().mean() + 1e-30)
        update = update / torch.clamp(rms, min=1.0)
        if p.dim() >= 2:
            update = update + cfg.weight_decay * p.float()
        p_new = p.float() - lr * update
        return p_new.to(p.dtype), newf

    # the factored state is a dict where the parameters have a leaf
    out = T.tree_map(upd, params, grads, opt_state["f"])
    new_params, new_f = T.unzip(out, 2)
    return new_params, {"f": new_f, "step": step_t}, _lr_metrics(lr, gnorm)


def opt_init(params: dict, cfg: OptConfig, state_dtype: str = "float32"):
    if cfg.name == "adafactor":
        return adafactor_init(params, state_dtype)
    return adamw_init(params, state_dtype)


def opt_update(params: dict, grads: dict, opt_state: dict, cfg: OptConfig):
    """One update.  Returns (new params, new state, {"lr", "grad_norm"}).
    Reads the step count to the host (one device sync)."""
    if cfg.name == "adafactor":
        return adafactor_update(params, grads, opt_state, cfg)
    return adamw_update(params, grads, opt_state, cfg)
