"""Gradient compression for the data-parallel all-reduce (counterpart of
``repro.training.grad_compression``).

Int8 quantization with error feedback: each DP rank quantizes its local
gradient (plus its carried quantization error) to int8 with a per-tensor
scale, the sum over ranks runs over the int8-decoded values (the wire
format of an int8 collective), and what the quantization lost is fed
back into the rank's next gradient.

The reference runs this inside ``shard_map`` over named mesh axes.  The
port has two forms of it, and both add the ranks in rank order, so they
agree bit for bit:

* :func:`compressed_psum`, the single controller: the ranks' gradients
  and error buffers are stacked along a leading rank axis on one device,
  and the ``psum`` is a sum over that axis (:func:`rank_sum`).
* :func:`quantize_payload` then :func:`gather_mean`, one rank of a
  process group: the rank quantizes its own gradient, all-gathers the
  int8 payload and the float32 scales (c10d, in buckets of at most
  ``BUCKET_BYTES`` a rank), and every rank decodes the ranks' payloads
  and adds them in rank order.  An all-reduce would add in the
  collective's own order, which is neither the single controller's nor
  the same on every rank.

As in the reference's compiled step, a division by a constant is a
product with the constant's float32 reciprocal, and the new error
``gf - q * scale`` is one fused multiply-add.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.prng import fma_f32
from repro_torch.training import tree as T

_INV_127 = float(np.float32(1) / np.float32(127))
# elements a pass of the float64 fused multiply-add takes at once: its
# temporaries stay near 1 GiB on a leaf of any size
_FMA_CHUNK = 1 << 24
# int8 bytes a rank puts into one all-gather: a step of qwen2-1.5b's
# 1.54 B parameters issues 12, and holds n_dp x 128 MiB gathered at once
BUCKET_BYTES = 1 << 27


def f32_recip(n: int) -> float:
    """float32(1) / float32(n): a division by a constant, as XLA compiles
    it (a product with this)."""
    return float(np.float32(1) / np.float32(n))


def all_gather_rows(x: torch.Tensor, group, n: int,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """The 1-D ``x`` of each of the ``n`` ranks of ``group``, as (n,
    x.numel()) rows in rank order (c10d's all-gather; ``out``, if given,
    holds at least n x.numel() elements and is written)."""
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    flat = (torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
            if out is None else out[:n * x.numel()])
    gather(flat, x, group=group)
    return flat.view(n, x.numel())


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


def quantize_with_feedback(g: torch.Tensor, e: torch.Tensor):
    """One rank's leaf: ``gf = g + e`` in float32, its int8 ``q`` and
    ``scale``, and the new error ``gf - q * scale`` in ``e``'s dtype."""
    gf = g.float() + e.float()
    q, scale = quantize_int8(gf)
    # the compiled reference contracts gf - q * scale into one fused
    # multiply-add (float64 inside fma_f32, so taken in slices)
    new_e = torch.empty(gf.shape, dtype=e.dtype, device=gf.device)
    flat_q, flat_gf, flat_e = q.reshape(-1), gf.reshape(-1), new_e.view(-1)
    for i in range(0, flat_gf.numel(), _FMA_CHUNK):
        s = slice(i, i + _FMA_CHUNK)
        flat_e[s] = fma_f32(-flat_q[s].float(), scale, flat_gf[s])
    return q, scale, new_e


def compressed_psum(grads: dict, err: dict):
    """Quantize and sum each gradient leaf over the ranks, with error
    feedback, as one controller.

    grads / err: trees whose leaves carry a leading rank axis (n_dp,
    *shape).  Returns (the ranks' mean gradient (shape, in the gradient's
    dtype), the new error buffers (n_dp, *shape, in err's dtype))."""

    def one(g, e):
        n = g.shape[0]
        deq, new_e = [], []
        for r in range(n):
            q, scale, ne = quantize_with_feedback(g[r], e[r])
            deq.append(dequantize_int8(q, scale))
            new_e.append(ne)
        mean = rank_sum(torch.stack(deq)) * f32_recip(n)
        return mean.to(g.dtype), torch.stack(new_e)

    return T.unzip(T.tree_map(one, grads, err), 2)


@dataclasses.dataclass
class Payload:
    """One rank's quantized gradient: every leaf's ``q`` in one flat int8
    buffer (leaves in ``tree.items`` order), their scales, and what puts
    the leaves back together."""
    q: torch.Tensor            # (total,) int8
    scales: torch.Tensor       # (leaves,) float32
    paths: list                # leaf paths
    shapes: list
    dtypes: list               # the gradients' dtypes (the mean's)
    offsets: list              # each leaf's first element in q


@contextlib.contextmanager
def _span(spans: dict | None, name: str, device: torch.device):
    """Record the block's (start, end) in ``spans[name]``: CUDA events on
    a card (read them after a synchronize), ``perf_counter`` seconds on
    the host.  Nothing when ``spans`` is None."""
    if spans is None:
        yield
        return
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        yield
        end.record()
    else:
        start = time.perf_counter()
        yield
        end = time.perf_counter()
    spans.setdefault(name, []).append((start, end))


def quantize_payload(grads: dict, err: dict, spans: dict | None = None):
    """This rank's half of the compressed sum: each leaf's
    :func:`quantize_with_feedback`, its ``q`` written into one flat int8
    buffer.  ``err``: this rank's error buffers, the gradients' shapes.
    Returns (the :class:`Payload`, the new error buffers)."""
    items = list(T.items(grads))
    dev = items[0][1].device
    offsets = np.cumsum([0] + [g.numel() for _, g in items]).tolist()
    errs = dict(T.items(err))
    with _span(spans, "quantize", dev):
        flat = torch.empty(offsets[-1], dtype=torch.int8, device=dev)
        scales, new_err = [], {}
        for (path, g), lo in zip(items, offsets):
            q, scale, new_err[path] = quantize_with_feedback(g, errs[path])
            flat[lo:lo + g.numel()] = q.reshape(-1)
            scales.append(scale)
        payload = Payload(flat, torch.stack(scales), [p for p, _ in items],
                          [g.shape for _, g in items],
                          [g.dtype for _, g in items], offsets[:-1])
    return payload, T.map_with_path(lambda path, _: new_err[path], err)


def gather_mean(payload: Payload, group, spans: dict | None = None) -> dict:
    """The ranks' mean gradient from their payloads: the scales and then
    the int8 buffer all-gathered over ``group`` (``BUCKET_BYTES`` of each
    rank's buffer a collective), each element decoded per rank and the
    ranks added in rank order, times float32(1) / float32(n).  Every rank
    returns the same tree, in the gradients' dtypes."""
    n = dist.get_world_size(group)
    q, dev = payload.q, payload.q.device
    with _span(spans, "gather", dev):
        scales = all_gather_rows(payload.scales, group, n)
    mean = [torch.empty(s, dtype=d, device=dev)
            for s, d in zip(payload.shapes, payload.dtypes)]
    total = q.numel()
    bucket = max(1, min(BUCKET_BYTES, total))
    recv = torch.empty(n * bucket, dtype=torch.int8, device=dev)
    leaf = 0
    for lo in range(0, total, bucket):
        hi = min(lo + bucket, total)
        with _span(spans, "gather", dev):
            got = all_gather_rows(q[lo:hi], group, n, out=recv)
        with _span(spans, "dequantize_add", dev):
            while leaf < len(mean) and payload.offsets[leaf] < hi:
                off = payload.offsets[leaf]
                a, b = max(lo, off), min(hi, off + mean[leaf].numel())
                s = slice(a - lo, b - lo)
                acc = got[0, s].float() * scales[0, leaf]
                for r in range(1, n):
                    acc = acc + got[r, s].float() * scales[r, leaf]
                mean[leaf].view(-1)[a - off:b - off] = acc * f32_recip(n)
                if b < off + mean[leaf].numel():
                    break         # the leaf goes on in the next bucket
                leaf += 1
    by_path = dict(zip(payload.paths, mean))
    return _tree_of(by_path)


def _tree_of(by_path: dict) -> dict:
    tree: dict = {}
    for path, leaf in by_path.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def init_error_feedback(params: dict, dtype: str = "bfloat16") -> dict:
    dt = getattr(torch, dtype)
    return T.tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                            device=p.device), params)
