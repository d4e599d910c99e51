"""Shared model building blocks: norms, RoPE, activations, init
(counterpart of ``repro.models.common``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6, *,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in f32 ('plus_one' = gemma-style (1 + w) scaling); output in
    x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    return (normed * w).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def activation(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    """(dim/2,) f32 inverse frequencies."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate the full last dim of x (..., T, H, D) at the given positions
    (broadcastable to x's (..., T) prefix: (T,) or (B, T)), half-split
    convention (rotate_half), angles in f32; output in x's dtype."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    ang = positions.float()[..., None] * inv                    # (..., T, d/2)
    cos = torch.cos(ang)[..., None, :]                          # (..., T, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_pos(seq_len: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal positions (T, D), float32."""
    half = dim // 2
    # log(10000) rounded to float32, then a float32 division, as the
    # reference forms its constant
    step = torch.tensor(math.log(10000.0), dtype=torch.float32,
                        device=device) / (half - 1)
    scale = torch.exp(-torch.arange(half, dtype=torch.float32, device=device)
                      * step)
    pos = (torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
           * scale[None, :])
    return torch.cat([torch.sin(pos), torch.cos(pos)], dim=-1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


class _ShapesOnly:
    """Stands in for a generator on the ``meta`` device, which has none:
    :func:`dense_init` then makes storage-less tensors of the right shape
    and dtype (``abstract_params``, the reference's ``jax.eval_shape``)."""

    device = torch.device("meta")


def generator(device: torch.device, seed: int):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``; on the
    ``meta`` device a stand-in that draws nothing."""
    if device.type == "meta":
        return _ShapesOnly()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init at +-3 sigma (0.02 cap like most LM
    codebases), drawn on ``gen``'s device by inverting the normal CDF of a
    uniform draw.  A leading layer axis leaves the fan-in (``shape[-2]``)
    unchanged, so a stacked layer group is one call."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else min(0.02, fan_in ** -0.5)
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    lo = 0.5 * (1.0 + math.erf(-3.0 / math.sqrt(2.0)))          # Phi(-3)
    # in place, so a stack of experts (16e9 values for llama4's MoE layer)
    # needs one float32 copy besides its weights
    z = u.mul_(1.0 - 2.0 * lo).add_(lo).mul_(2.0).sub_(1.0).erfinv_()
    z = z.mul_(math.sqrt(2.0)).clamp_(-3.0, 3.0)
    return z.mul_(std).to(dtype)
