"""Gradient compression for the data-parallel all-reduce (counterpart of
``repro.training.grad_compression``).

Int8 quantization with error feedback: each DP rank quantizes its local
gradient (plus its carried quantization error) to int8 with a per-tensor
scale, the sum over ranks runs over the int8-decoded values (the wire
format of an int8 collective), and what the quantization lost is fed
back into the rank's next gradient.

The reference runs this inside ``shard_map`` over named mesh axes.  The
port is a single controller, as its sharded data plane is
(``core.dist_store``): the ranks' gradients and error buffers are stacked
along a leading rank axis on one device, and the ``psum`` is a sum over
that axis in rank order.  As in the reference's compiled step, a division
by a constant is a product with the constant's float32 reciprocal, and the
new error ``gf - q * scale`` is one fused multiply-add.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.prng import fma_f32
from repro_torch.training import tree as T

_INV_127 = float(np.float32(1) / np.float32(127))


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization.  Returns (q int8, scale
    float32 0-d).  ``torch.round`` rounds half to even, as ``jnp.round``."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) * _INV_127
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def rank_sum(x: torch.Tensor) -> torch.Tensor:
    """The ``psum`` over the leading rank axis: ranks added in order."""
    total = x[0]
    for r in range(1, x.shape[0]):
        total = total + x[r]
    return total


def compressed_psum(grads: dict, err: dict):
    """Quantize and sum each gradient leaf over the ranks, with error
    feedback.

    grads / err: trees whose leaves carry a leading rank axis (n_dp,
    *shape).  Returns (the ranks' mean gradient (shape, in the gradient's
    dtype), the new error buffers (n_dp, *shape, in err's dtype))."""

    def one(g, e):
        n = g.shape[0]
        gf = g.float() + e.float()
        deq, new_e = [], []
        for r in range(n):
            q, scale = quantize_int8(gf[r])
            deq.append(dequantize_int8(q, scale))
            # the compiled reference contracts gf - q * scale into one
            # fused multiply-add
            new_e.append(fma_f32(-q.float(), scale, gf[r]).to(e.dtype))
        mean = rank_sum(torch.stack(deq)) * float(np.float32(1) / np.float32(n))
        return mean.to(g.dtype), torch.stack(new_e)

    return T.unzip(T.tree_map(one, grads, err), 2)


def init_error_feedback(params: dict, dtype: str = "bfloat16") -> dict:
    dt = getattr(torch, dtype)
    return T.tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                            device=p.device), params)
