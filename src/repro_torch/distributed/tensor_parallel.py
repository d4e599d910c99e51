"""The model's sharded pieces on ``DTensor`` inputs: where DTensor's own
propagation would gather a vocab- or head-sharded tensor whole, cannot
propagate at all, or leaves a partial sum in the residual stream.

The train step on a mesh over a process group holds every parameter as a
``DTensor`` (``distributed.sharding.place``) and the batch as one split
over the data axes; the models' matmuls, norms and pointwise ops run on
them as they are.  The models call these where they do not, and only
when their input is a ``DTensor`` (a plain tensor keeps its one-card
path, bit for bit):

* :func:`vocab_parallel_embed`: the lookup in a table whose vocab rows
  lie on "model".  DTensor's indexing of such a table by a batch split
  over "data" fails inside its mask buffer; here each rank looks up the
  ids it owns, zeroes the others, and a sum over "model" completes the
  rows.
* :func:`vocab_parallel_ce`: the cross-entropy over vocab-sharded logits,
  from a local max, local sums of exponentials and the gold logit on the
  rank that owns it, combined over "model", so no rank holds a chunk's
  logits whole.
* :func:`local_heads` / :func:`from_local_heads`: attention is local to
  a head, so q, k and v go to each rank's own heads (``to_local``), and
  RoPE, qk-norm and the flash block loop run on plain tensors, positions
  and masks included.  When "model" does not divide the kv heads (or the
  q heads), the head split crosses a shard boundary: DTensor refuses that
  reshape ("Cannot unflatten unevenly sharded tensor"), so those
  projections are gathered over "model" first and each rank takes the
  heads its q heads read.
* :func:`like` and :func:`reduce_grad`, the residual stream's two sums
  (Megatron's): a row-sharded matmul's partial output is summed before it
  joins the stream, and the partial gradient of a column-sharded matmul's
  input where that input is made.  DTensor would otherwise carry both on
  as partial sums and later gather whole activations and weights.
* :func:`zeros_like_scalar`: a scalar accumulator (the loss sums, the aux
  terms) as a replicated ``DTensor`` on the mesh of the tensor it joins;
  nothing relies on ``implicit_replication``.

Every collective here goes through a ``DTensor`` redistribution, so
autograd carries it into the backward; the one exception, the max that
steadies the exponentials, is detached (its value cancels in the
gradient).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def like(y, x):
    """``y`` in ``x``'s layout when both are ``DTensor``s; else ``y``.  A
    row-sharded matmul's partial sums are summed before they join the
    residual stream (DTensor would carry them on as partial, and shard the
    next norm's input over "model" to square it); the optimizer takes each
    gradient and weight in its moments' layout (ZeRO's)."""
    if is_dtensor(y) and is_dtensor(x) and y.placements != x.placements:
        return y.redistribute(x.device_mesh, x.placements)
    return y


def reduce_grad(x):
    """``x`` unchanged; on a ``DTensor``, a redistribution onto its own
    layout, whose backward sums the partial gradient that the
    column-sharded matmuls reading ``x`` return (Megatron's all-reduce at
    a column-parallel input).  Without it the partial sum is carried down
    the residual stream, and the next row-sharded matmul's backward
    gathers its input and weight instead."""
    if is_dtensor(x):
        return x.redistribute(x.device_mesh, x.placements)
    return x


def whole(t):
    """The whole tensor of a ``DTensor`` (every rank joins), plain; a plain
    tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def local_shard(t: torch.Tensor, device_mesh, placements) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` under ``placements``
    (a view; dims split evenly, mesh dims major first)."""
    coord = device_mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            t = t.chunk(device_mesh.size(i), dim=p.dim)[coord[i]]
    return t


def from_local_layout(local: torch.Tensor, device_mesh,
                      placements) -> DTensor:
    """Each rank's shard ``local`` as the ``DTensor`` it is a part of."""
    return DTensor.from_local(local, device_mesh, tuple(placements),
                              run_check=False)


def from_whole(t: torch.Tensor, device_mesh, placements, device) -> DTensor:
    """The whole tensor ``t``, which every rank holds (on any device), as
    a ``DTensor`` on ``device_mesh``: each rank copies its own shard to
    ``device`` and nothing is sent, so ``t`` may be freed after."""
    local = local_shard(t, device_mesh, placements)
    if local.device == torch.device(device):
        local = local.clone(memory_format=torch.contiguous_format)
    else:
        local = local.contiguous().to(device)
    return from_local_layout(local, device_mesh, placements)


def laid_out_as(t: torch.Tensor, like):
    """The whole tensor ``t``, which every rank holds, as a ``DTensor``
    with ``like``'s placements; a plain ``like`` leaves ``t`` as it
    is."""
    if not is_dtensor(like):
        return t
    return from_whole(t, like.device_mesh, like.placements,
                      like.to_local().device)


def zeros_like_scalar(x, dtype: torch.dtype):
    """A 0-dim zero on ``x``'s device: replicated on ``x``'s mesh when
    ``x`` is a ``DTensor``."""
    if is_dtensor(x):
        z = torch.zeros((), dtype=dtype, device=x.to_local().device)
        return from_local_layout(z, x.device_mesh,
                                 [Replicate()] * x.device_mesh.ndim)
    return torch.zeros((), dtype=dtype, device=x.device)


def _sharded_dims(t: DTensor, tensor_dim: int) -> list[int]:
    """The mesh dims that split ``t``'s ``tensor_dim``."""
    return [i for i, p in enumerate(t.placements)
            if isinstance(p, Shard) and p.dim == tensor_dim]


def _shard_offset(t: DTensor, tensor_dim: int) -> tuple[int, int]:
    """(first index, length) of this rank's even shard of ``tensor_dim``
    (the rules shard only dims the mesh divides)."""
    n = t.shape[tensor_dim]
    lo, size = 0, n
    coord = t.device_mesh.get_coordinate()
    for i in _sharded_dims(t, tensor_dim):
        size //= t.device_mesh.size(i)
        lo += coord[i] * size
    return lo, size


def _sum_over(local: torch.Tensor, like: DTensor,
              partial_dims: list[int]) -> torch.Tensor:
    """``local`` (per rank, laid out as ``like``) summed over the mesh dims
    ``partial_dims``; the local tensor of the result."""
    if not partial_dims:
        return local
    mesh = like.device_mesh
    src = [Partial() if i in partial_dims else p
           for i, p in enumerate(like.placements)]
    dst = [Replicate() if i in partial_dims else p
           for i, p in enumerate(like.placements)]
    return from_local_layout(local, mesh, src).redistribute(mesh,
                                                            dst).to_local()


def _grad_placements(param: DTensor, data: DTensor) -> list:
    """The placements of the gradient a rank computes for ``param``'s
    local shard from ``data``'s local shard: partial over every mesh dim
    that splits the data but not the parameter."""
    out = []
    for pp, dp in zip(param.placements, data.placements):
        if isinstance(pp, Replicate) and isinstance(dp, Shard):
            out.append(Partial())
        else:
            out.append(pp)
    return out


def local_replica(param: DTensor, like: DTensor) -> torch.Tensor:
    """A replicated parameter's (a qk-norm weight's) local copy, for use on
    ``like``'s local shard: its gradient is this rank's part of a sum over
    every mesh dim that splits ``like``."""
    grad = [Partial() if isinstance(lp, Shard) else pp
            for pp, lp in zip(param.placements, like.placements)]
    return param.to_local(grad_placements=grad)


def vocab_parallel_embed(table: DTensor, tokens: DTensor) -> DTensor:
    """``table[tokens]`` for a (V, D) table whose rows may lie on mesh
    dims and ids (B, T) split over others: each rank looks up the ids in
    its own rows, zeroes the rest, and a sum over the table's mesh dims
    completes every row.  Returns (B, T, D) laid out as ``tokens``."""
    vocab_dims = _sharded_dims(table, 0)
    lo, size = _shard_offset(table, 0)
    w = table.to_local(grad_placements=_grad_placements(table, tokens))
    ids = tokens.to_local().long() - lo
    hit = (ids >= 0) & (ids < size)
    rows = F.embedding(ids.clamp(0, size - 1), w)
    rows = torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))
    rows = _sum_over(rows, tokens, vocab_dims)
    return from_local_layout(rows, tokens.device_mesh, tokens.placements)


def vocab_parallel_ce(logits: DTensor, labels: DTensor):
    """One chunk's (nll sum float32, scored tokens int32) from (B, C, V)
    float32 logits whose vocab may lie on mesh dims and labels (B, C)
    (-1 = masked), both split over the batch as ``labels``: log-sum-exp
    less the gold logit, as the one-card chunk computes it, with the
    vocab sums taken per shard and added over its mesh dims.  Both
    results are replicated scalars."""
    vocab_dims = _sharded_dims(logits, 2)
    lo, size = _shard_offset(logits, 2)
    mesh = logits.device_mesh
    lg = logits.to_local()
    lab = labels.to_local().long()
    # the max only steadies exp: detached, and the same on every rank
    m = lg.detach().amax(dim=-1)
    for i in vocab_dims:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.get_group(i))
    s = _sum_over(torch.exp(lg - m[..., None]).sum(dim=-1), labels,
                  vocab_dims)
    lse = m + torch.log(s)
    mask = lab >= 0
    own = lab - lo
    hit = (own >= 0) & (own < size)
    gold = lg.gather(-1, own.clamp(0, size - 1)[..., None])[..., 0]
    gold = _sum_over(torch.where(hit, gold, 0.0), labels, vocab_dims)
    nll = torch.where(mask, lse - gold, 0.0).sum()
    count = mask.sum().to(torch.int32)
    batch_dims = [i for i, p in enumerate(labels.placements)
                  if isinstance(p, Shard)]
    full = [Replicate()] * mesh.ndim
    part = [Partial() if i in batch_dims else Replicate()
            for i in range(mesh.ndim)]

    def total(t):
        return from_local_layout(t, mesh, part).redistribute(mesh, full)

    return total(nll), total(count)


def _heads_split(t: DTensor, n_heads: int) -> bool:
    """True when the mesh dims splitting ``t``'s last dim divide its
    ``n_heads`` heads (a shard holds whole heads)."""
    dims = _sharded_dims(t, t.ndim - 1)
    n = 1
    for i in dims:
        n *= t.device_mesh.size(i)
    return n_heads % n == 0


def _gather_last(t: DTensor) -> DTensor:
    """``t`` with its last dim whole on every rank."""
    dims = set(_sharded_dims(t, t.ndim - 1))
    return t.redistribute(t.device_mesh, [
        Replicate() if i in dims else p for i, p in enumerate(t.placements)])


def local_heads(q: DTensor, k: DTensor, v: DTensor, n_heads: int,
                n_kv_heads: int):
    """q (B, T, Hq * Dq), k (B, T, Hkv * Dq), v (B, T, Hkv * Dv) as each
    rank's plain (b, T, h, D) q and the (b, T, hkv, D) k / v its q heads
    attend to, with ``hkv`` dividing ``h`` as GQA needs.  Returns (q, k,
    v, out_like), ``out_like`` the ``DTensor`` whose layout the attention
    output takes (:func:`from_local_heads`).

    Heads split over "model" stay local.  A kv projection that "model"
    does not split into whole heads is gathered, and each rank takes the
    kv heads of its own q heads, repeated to one a q head (their gradient
    is then this rank's part of a sum over "model").  A q projection that
    "model" does not split into whole heads is gathered whole, and every
    rank computes every head."""
    if not _heads_split(q, n_heads):
        q = _gather_last(q)
    q_dims = _sharded_dims(q, q.ndim - 1)
    q_loc = q.to_local()
    b, T = q_loc.shape[:2]
    h = q_loc.shape[-1] * n_heads // q.shape[-1]
    q_loc = q_loc.reshape(b, T, h, -1)
    if (_heads_split(k, n_kv_heads) and _heads_split(v, n_kv_heads)
            and _sharded_dims(k, k.ndim - 1) == q_dims
            and _sharded_dims(v, v.ndim - 1) == q_dims):
        kv = [t.to_local() for t in (k, v)]
        hkv = kv[0].shape[-1] * n_kv_heads // k.shape[-1]
        return (q_loc, kv[0].reshape(b, T, hkv, -1),
                kv[1].reshape(b, T, hkv, -1), q)
    # gather the kv heads; keep those of this rank's q heads, one a q head
    first = _shard_offset(q, q.ndim - 1)[0] * n_heads // q.shape[-1]
    idx = torch.arange(first, first + h, device=q_loc.device) // (
        n_heads // n_kv_heads)
    out = []
    for t in (k, v):
        g = _gather_last(t)
        grad = [Partial() if i in q_dims else p
                for i, p in enumerate(g.placements)]
        full = g.to_local(grad_placements=grad).reshape(b, T, n_kv_heads, -1)
        out.append(full.index_select(2, idx))
    return q_loc, out[0], out[1], q


def from_local_heads(out: torch.Tensor, like: DTensor) -> DTensor:
    """Each rank's (b, T, h, D) attention output as the (B, T, H * D)
    ``DTensor`` laid out as the q projection ``like`` was."""
    b, T = out.shape[:2]
    return from_local_layout(out.reshape(b, T, -1), like.device_mesh,
                             like.placements)
