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
* :class:`SSDHeads`: the Mamba-2 mixer on each rank's own SSD heads, from
  ``in_proj`` and the conv gathered over "model" (the rules split them
  inside xBC, off the heads' boundaries) with the gradient of every
  gathered weight a sum over "model" (:func:`gathered_local`), and the
  gated norm's squares summed over "model".  The scan takes plain
  tensors: K7 on the card.
* :class:`ExpertShard`: the MoE layer on each rank's own batch rows and
  experts (the rules split the routed experts on E over "model"): every
  model rank holds its data rows' tokens, so the dispatch needs no
  all-to-all, only the per-expert counts all-gathered over the data axes
  (the whole batch's queue order), and the combine is a partial sum over
  "model" that :func:`add_parts` joins to the shared experts' own.
* :func:`batch_rows`: hymba's meta tokens repeated over each rank's own
  batch rows.
* :class:`MLAHeads`: minicpm3's MLA attention on each rank's own heads,
  from the down projections gathered over "model" (the rules split them
  inside the low-rank vectors, which the norms read whole), every
  gathered or replicated leaf's gradient a sum over "model".
* :func:`replicated`: a value every rank holds alike (whisper's positions,
  the MoE's aux terms) as a replicated ``DTensor``.
* :func:`pad`: the cross-entropy's padding of the sequence to whole
  chunks, on each rank's own shard.

Every collective here goes through a ``DTensor`` redistribution, so
autograd carries it into the backward; the one exception, the max that
steadies the exponentials, is detached (its value cancels in the
gradient).  Where each rank goes on to use a gathered or summed tensor
on its own part of the work, the backward must sum the ranks' gradients,
which DTensor's default backward of a gather does not (it keeps a local
chunk): those carry ``Partial`` gradient placements.
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


def replicated(t: torch.Tensor, like):
    """``t``, which every rank holds alike (a constant: whisper's
    positions, the aux terms), as a ``DTensor`` replicated on ``like``'s
    mesh; a plain ``like`` leaves ``t`` as it is."""
    if not is_dtensor(like):
        return t
    return from_local_layout(t, like.device_mesh,
                             [Replicate()] * like.device_mesh.ndim)


def zeros_like_scalar(x, dtype: torch.dtype):
    """A 0-dim zero on ``x``'s device: replicated on ``x``'s mesh when
    ``x`` is a ``DTensor``."""
    dev = x.to_local().device if is_dtensor(x) else x.device
    return replicated(torch.zeros((), dtype=dtype, device=dev), x)


def pad(t, widths: tuple, value: float = 0.0):
    """``F.pad(t, widths, value=value)``; on a ``DTensor`` each rank pads
    its own shard, laid out as ``t`` (the padded dims must not be split).
    DTensor's own padding of a tensor on a 2-D mesh (torch 2.11) returns
    a spec with one placement, which the next op refuses."""
    if not is_dtensor(t):
        return F.pad(t, widths, value=value)
    padded = {t.ndim - 1 - i // 2 for i, w in enumerate(widths) if w}
    if any(_sharded_dims(t, d) for d in padded):
        raise NotImplementedError("padding a split dim of a DTensor")
    return from_local_layout(F.pad(t.to_local(), widths, value=value),
                             t.device_mesh, t.placements)


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


def _partial_on(t: DTensor, dims) -> list:
    """``t``'s placements with ``Partial`` on the mesh dims ``dims``."""
    return [Partial() if i in dims else p for i, p in enumerate(t.placements)]


def _sum_for_parts(local: torch.Tensor, like: DTensor,
                   dims: list[int]) -> torch.Tensor:
    """:func:`_sum_over`, where each rank goes on to use the sum on its
    own part of the work (its heads): the gradient each rank returns is
    then its part of a sum over ``dims`` too, which the backward adds up
    (DTensor's default would take it as already whole)."""
    mesh, part = like.device_mesh, _partial_on(like, dims)
    return from_local_layout(local, mesh, part).redistribute(
        mesh, like.placements).to_local(grad_placements=part)


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


def local_replica(param: DTensor, like: DTensor, split=()) -> torch.Tensor:
    """A replicated parameter's (a qk-norm weight's) local copy, for use on
    ``like``'s local shard: its gradient is this rank's part of a sum over
    every mesh dim that splits ``like`` and over ``split`` (dims whose ranks
    each keep their own part of the result)."""
    grad = [Partial() if isinstance(lp, Shard) or i in split else pp
            for i, (pp, lp) in enumerate(zip(param.placements,
                                             like.placements))]
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


def whole_heads_split(like: DTensor, wo: DTensor) -> list[int]:
    """Where a rank computed every head (``like``'s last dim whole), the
    mesh dims on which it keeps only its own columns of the attention
    output: those that split the output projection ``wo``'s rows."""
    if _sharded_dims(like, like.ndim - 1):
        return []
    return _sharded_dims(wo, 0)


def local_heads(q: DTensor, k: DTensor, v: DTensor, n_heads: int,
                n_kv_heads: int, wo: DTensor | None = None):
    """q (B, T, Hq * Dq), k (B, S, Hkv * Dq), v (B, S, Hkv * Dv) as each
    rank's plain (b, T, h, D) q and the (b, S, hkv, D) k / v its q heads
    attend to, with ``hkv`` dividing ``h`` as GQA needs (S is T but in
    cross attention).  Returns (q, k, v, out_like), ``out_like`` the
    ``DTensor`` whose layout the attention output takes
    (:func:`from_local_heads`).

    Heads split over "model" stay local.  A kv projection that "model"
    does not split into whole heads is gathered, and each rank takes the
    kv heads of its own q heads, repeated to one a q head (their gradient
    is then this rank's part of a sum over "model").  A q projection that
    "model" does not split into whole heads is gathered whole, and every
    rank computes every head; where the output projection ``wo``'s rows
    are split, each rank keeps its own columns of the output, so the
    gradients of q, k and v are then its part of a sum over those dims."""
    if not _heads_split(q, n_heads):
        q = _gather_last(q)
    q_dims = _sharded_dims(q, q.ndim - 1)
    part = whole_heads_split(q, wo) if wo is not None else []
    q_loc = q.to_local(grad_placements=_partial_on(q, part))
    b, T = q_loc.shape[:2]
    h = q_loc.shape[-1] * n_heads // q.shape[-1]
    q_loc = q_loc.reshape(b, T, h, -1)
    if (_heads_split(k, n_kv_heads) and _heads_split(v, n_kv_heads)
            and _sharded_dims(k, k.ndim - 1) == q_dims
            and _sharded_dims(v, v.ndim - 1) == q_dims):
        kv = [t.to_local(grad_placements=_partial_on(t, part))
              for t in (k, v)]
        hkv = kv[0].shape[-1] * n_kv_heads // k.shape[-1]
        return (q_loc, *(t.reshape(*t.shape[:2], hkv, -1) for t in kv), q)
    # gather the kv heads; keep those of this rank's q heads, one a q head
    # (an expand, whose backward sums in a fixed order: index_select's
    # adds atomically on the card, and the step would not replay bit for
    # bit)
    first = _shard_offset(q, q.ndim - 1)[0] * n_heads // q.shape[-1]
    group = n_heads // n_kv_heads
    lo, hi = first // group, (first + h - 1) // group + 1
    out = []
    for t in (k, v):
        g = _gather_last(t)
        grad = _partial_on(g, q_dims + part)
        full = g.to_local(grad_placements=grad)
        S = full.shape[1]
        full = full.reshape(b, S, n_kv_heads, -1)
        rep = full[:, :, lo:hi, None].expand(-1, -1, -1, group, -1)
        rep = rep.reshape(b, S, (hi - lo) * group, -1)
        out.append(rep[:, :, first - lo * group:first - lo * group + h])
    return q_loc, out[0], out[1], q


def from_local_heads(out: torch.Tensor, like: DTensor,
                     wo: DTensor | None = None) -> DTensor:
    """Each rank's (b, T, h, D) attention output as the (B, T, H * D)
    ``DTensor`` laid out as the q projection ``like`` was; where the rank
    computed every head and ``wo``'s rows are split, only its own columns,
    split as those rows (no implicit redistribution before ``wo``)."""
    b, T = out.shape[:2]
    out = out.reshape(b, T, -1)
    placements = list(like.placements)
    part = whole_heads_split(like, wo) if wo is not None else []
    if part:
        lo, size = _shard_offset(wo, 0)
        out = out[..., lo:lo + size]
        for i in part:
            placements[i] = Shard(2)
    return from_local_layout(out, like.device_mesh, placements)


def gathered_local(param: DTensor, like: DTensor, split) -> torch.Tensor:
    """``param`` whole on this rank, plain: gathered over the mesh dims
    that shard it.  Its gradient is this rank's part of a sum over the
    mesh dims that split ``like`` (the batch) and over ``split`` (dims
    whose ranks each use their own part of it); DTensor's default
    backward of the gather would keep a local chunk instead."""
    mesh = param.device_mesh
    whole_p = param.redistribute(mesh, [Replicate()] * mesh.ndim)
    grad = [Partial() if i in split or isinstance(lp, Shard) else Replicate()
            for i, lp in enumerate(like.placements)]
    return whole_p.to_local(grad_placements=grad)


def batch_rows(param: DTensor, like: DTensor) -> DTensor:
    """A replicated (n, D) parameter (hymba's meta tokens) repeated over
    the batch of ``like`` (B, T, D), laid out as ``like``: each rank
    repeats it over its own rows, and its gradient is summed over the mesh
    dims that split the batch."""
    local = local_replica(param, like)
    b = like.to_local().shape[0]
    return from_local_layout(local[None].expand(b, *local.shape),
                             like.device_mesh, like.placements)


class SSDHeads:
    """Each rank's share of a Mamba-2 (SSD) mixer on a ``DTensor`` input
    x (B, T, D), split over the batch and replicated on "model".

    The rules column-shard ``in_proj`` (z | x | B | C | dt) and
    ``conv_w`` / ``conv_b`` (x | B | C) on "model" at boundaries that are
    not the mixer's (they fall inside xBC), and leave ``A_log``, ``D`` and
    ``dt_bias`` replicated.  So those are gathered over "model", and each
    rank takes the columns of its own SSD heads and the B / C columns of
    their groups (:attr:`x`, :attr:`params`: plain tensors, which the
    scan, K7 on the card, takes as one card's).  Every gradient of a
    gathered weight and of x is marked as this rank's part of a sum over
    the mesh dims the heads are split on.

    Heads split over "model" when it divides them (and the groups of a
    rank's heads are whole): there ``norm_w`` and ``out_proj``'s rows are
    split on head boundaries, and the gated norm sums its squares over
    "model" (:meth:`out`).  Otherwise every rank computes every head, and
    takes its own columns of the normed output where ``out_proj``'s rows
    are split.  ``out_proj``'s product is then a partial sum over
    "model", which the residual stream's ``like`` completes."""

    def __init__(self, x: DTensor, p: dict, H: int, P: int, N: int, G: int):
        mesh = x.device_mesh
        self.like, self.d_inner = x, H * P
        self.norm_w, self.out_proj = p["norm_w"], p["out_proj"]
        self.split = _sharded_dims(self.out_proj, 0)
        if _sharded_dims(self.norm_w, 0) != self.split:
            raise ValueError("norm_w and out_proj split d_inner apart")
        if any(isinstance(x.placements[i], Shard) for i in self.split):
            raise NotImplementedError("the SSD mixer takes x replicated on "
                                      "the mesh dims of its heads")
        n = 1
        for i in self.split:
            n *= mesh.size(i)
        h, hpg = H // n, H // G
        self.local = bool(self.split) and H % n == 0 and (
            h % hpg == 0 or hpg % h == 0)
        first = _shard_offset(self.out_proj, 0)[0] // P if self.local else 0
        if not self.local:
            h = H
        g0, g1 = first // hpg, (first + h - 1) // hpg + 1
        self.h, self.groups = h, g1 - g0
        d_inner, GN = H * P, G * N
        heads = (first * P, (first + h) * P)
        xbc = [heads, (d_inner + g0 * N, d_inner + g1 * N),
               (d_inner + GN + g0 * N, d_inner + GN + g1 * N)]
        dt = 2 * d_inner + 2 * GN + first

        def take(name, spans):
            w = gathered_local(p[name], x, self.split)
            if h == H and self.groups == G:     # every column, in order
                return w
            return torch.cat([w[..., a:b] for a, b in spans], dim=-1)

        self.params = {
            "in_proj": take("in_proj", [heads] + [
                (a + d_inner, b + d_inner) for a, b in xbc] + [(dt, dt + h)]),
            "conv_w": take("conv_w", xbc),
            "conv_b": take("conv_b", xbc),
            **{k: take(k, [(first, first + h)])
               for k in ("A_log", "D", "dt_bias")},
        }
        self.x = x.to_local(grad_placements=_partial_on(x, self.split))

    def out(self, y: torch.Tensor, z: torch.Tensor, eps: float) -> DTensor:
        """The gated RMSNorm of this rank's (b, T, h * P) scan output ``y``
        and gate ``z`` over all of d_inner, as ``models.common.rms_norm``
        computes it (float32), then ``out_proj``: a ``DTensor`` (B, T, D),
        a partial sum over the mesh dims of the heads."""
        x, mesh = self.like, self.like.device_mesh
        g = (y * F.silu(z)).float()
        ss = g.square().sum(dim=-1, keepdim=True)
        if self.local:
            ss = _sum_for_parts(ss, x, self.split)
        g = g * torch.rsqrt(ss / self.d_inner + eps)
        if self.split and not self.local:
            lo, size = _shard_offset(self.norm_w, 0)
            g = g[..., lo:lo + size]
        w = self.norm_w.to_local(grad_placements=_grad_placements(
            self.norm_w, x))
        g = (g * w.float()).to(y.dtype)
        placements = [Shard(2) if i in self.split else pl
                      for i, pl in enumerate(x.placements)]
        return from_local_layout(g, mesh, placements) @ self.out_proj


class MLAHeads:
    """Each rank's share of an MLA attention (``models.attention.mla_seq``)
    on a ``DTensor`` x (B, T, D), split over the batch and replicated on
    "model".

    The rules column-shard the down projections ``wdq`` (D, q_lora) and
    ``wdkv`` (D, kv_lora + rope) on "model" at boundaries that are not the
    layer's: both RMS norms run over the whole low-rank vector, and
    ``wdkv``'s shards fall inside the latent, off the latent / rope
    boundary.  So those two are gathered over "model", and every rank
    computes the normed query, the latent and the shared rotary key whole
    (:attr:`params`, plain, and :attr:`x`).  The up projections ``wuq``
    and ``wukv`` are column-sharded on head boundaries when "model"
    divides the heads: each rank takes its own heads from its columns
    (:attr:`h` of them), and ``wo``'s rows take its part of the output
    (:meth:`out`).  Otherwise they are gathered too, every rank computes
    every head, and keeps its own columns of the output where ``wo``'s rows
    are split.  ``wo``'s product is a partial sum over the mesh dims of the
    heads (:attr:`split`), which the residual stream's ``like`` completes.

    Every rank uses x, the gathered weights, the replicated norms and the
    rotary key on its own heads alone, so their gradients are marked as its
    part of a sum over :attr:`split`."""

    def __init__(self, x: DTensor, p: dict, n_heads: int):
        mesh = x.device_mesh
        self.like, self.wo = x, p["wo"]
        self.split = _sharded_dims(self.wo, 0)
        if any(isinstance(x.placements[i], Shard) for i in self.split):
            raise NotImplementedError("the MLA attention takes x replicated "
                                      "on the mesh dims of its heads")
        n = 1
        for i in self.split:
            n *= mesh.size(i)
        self.local = bool(self.split) and n_heads % n == 0 and all(
            _sharded_dims(p[k], 1) == self.split for k in ("wuq", "wukv"))
        self.h = n_heads // n if self.local else n_heads

        def gathered(name):
            return gathered_local(p[name], x, self.split)

        up = (("wuq", "wukv") if self.local else ())
        self.params = {
            **{k: gathered(k) for k in ("wdq", "wdkv")},
            **{k: local_replica(p[k], x, self.split)
               for k in ("q_norm", "kv_norm")},
            **{k: p[k].to_local(grad_placements=_grad_placements(p[k], x))
               if k in up else gathered(k) for k in ("wuq", "wukv")},
        }
        self.x = x.to_local(grad_placements=_partial_on(x, self.split))

    def out(self, o: torch.Tensor) -> DTensor:
        """This rank's (b, T, h, vd) attention output through ``wo``: a
        ``DTensor`` (B, T, D), a partial sum over :attr:`split`."""
        b, T = o.shape[:2]
        o = o.reshape(b, T, -1)
        if self.split and not self.local:
            lo, size = _shard_offset(self.wo, 0)
            o = o[..., lo:lo + size]
        placements = [Shard(2) if i in self.split else pl
                      for i, pl in enumerate(self.like.placements)]
        return from_local_layout(o, self.like.device_mesh,
                                 placements) @ self.wo


def add_parts(a: DTensor, b: DTensor) -> DTensor:
    """``a + b`` for two ``DTensor``s of one shape, either of them a
    partial sum over mesh dims where the other is whole: the partial one
    is summed first (a whole one is never cut into parts, which DTensor
    does by dividing it)."""
    if a.placements != b.placements:
        if any(p.is_partial() for p in a.placements):
            a = a.redistribute(a.device_mesh, b.placements)
        else:
            b = b.redistribute(b.device_mesh, a.placements)
    return a + b


class ExpertShard:
    """Each rank's share of an MoE layer (``models.moe.moe_layer``) on a
    ``DTensor`` x (B, T, D), split over the batch and replicated on
    "model".

    The rules split the routed experts' ``wg``, ``wu`` and ``wo`` (E, ...)
    on E over "model" when it divides E (:attr:`split`, the mesh dims that
    split them), and leave the router replicated.  Each rank routes its
    own batch rows (every model rank alike), gathers the slots of its own
    experts (:attr:`experts`, from :attr:`first_expert` on) from those
    rows, and its combine is its part of a sum over :attr:`split`
    (:meth:`out`).  Where the rules replicate the experts, every rank
    computes every expert on its rows and nothing is summed.

    The one-card layer's semantics over the whole batch: the capacity of
    its tokens (:attr:`n_data` x the local ones); each assignment's place
    in its expert's queue after those of the data ranks before it, whose
    rows come first (:meth:`queues`: the per-expert counts all-gathered
    over the data dims); the aux term's mean probability and counts over
    the whole batch (:meth:`batch_sum`).

    Gradients: :attr:`x` and :attr:`router` are used on the dispatch path
    for this rank's experts only, so their gradients are its part of a sum
    over :attr:`split` (the router's over the data dims too).  The aux
    term reads them whole on every model rank: only the first rank of
    :attr:`split` carries its gradient (:meth:`batch_sum`), so it counts
    once.  The local experts' gradients are partial over the data dims.
    Any other layout raises: nothing is gathered silently."""

    EXPERT_LEAVES = ("wg", "wu", "wo")

    def __init__(self, x: DTensor, p: dict):
        mesh = x.device_mesh
        self.like, self.mesh = x, mesh
        wg = p["wg"]
        self.split = _sharded_dims(wg, 0)
        self.data = _sharded_dims(x, 0)
        for i, pl in enumerate(x.placements):
            if not (pl.is_replicate() or i in self.data) or (
                    i in self.split and i in self.data):
                raise NotImplementedError(
                    "the MoE layer takes x split over the batch and "
                    "replicated on the experts' mesh dims, not "
                    f"{x.placements}")
        for name in self.EXPERT_LEAVES:
            if list(p[name].placements) != [
                    Shard(0) if i in self.split else Replicate()
                    for i in range(mesh.ndim)]:
                raise NotImplementedError(
                    f"the MoE layer takes {name} split on E alone (the "
                    f"rules'), not {p[name].placements}")
        if any(not pl.is_replicate() for pl in p["router"].placements):
            raise NotImplementedError("the MoE layer takes the router "
                                      "replicated")
        coord = mesh.get_coordinate()
        self.n_data, self.index = 1, 0
        for i in self.data:                 # major first, as the rows lie
            self.n_data *= mesh.size(i)
            self.index = self.index * mesh.size(i) + coord[i]
        self.first = all(coord[i] == 0 for i in self.split)
        self.first_expert = _shard_offset(wg, 0)[0]
        self.x = x.to_local(grad_placements=_partial_on(x, self.split))
        self.router = local_replica(p["router"], x, self.split)
        self.experts = {k: p[k].to_local(grad_placements=_grad_placements(
            p[k], x)) for k in self.EXPERT_LEAVES}

    def queues(self, counts: torch.Tensor):
        """(offset, total) from this rank's per-expert assignment counts
        (E,): the assignments of the data ranks before this one, and of
        the whole batch (no gradient)."""
        if not self.data:
            return torch.zeros_like(counts), counts
        every = from_local_layout(counts[None], self.mesh, [
            Shard(0) if i in self.data else Replicate()
            for i in range(self.mesh.ndim)]).full_tensor()
        return every[:self.index].sum(dim=0), every.sum(dim=0)

    def batch_sum(self, local: torch.Tensor) -> torch.Tensor:
        """``local``, a sum over this rank's rows, summed over the data
        dims.  Its gradient reaches ``local`` on the first rank of
        :attr:`split` alone: the others' copies of the term add nothing to
        x's and the router's sums over :attr:`split`."""
        if not self.first:
            local = local.detach()
        return _sum_over(local, self.like, self.data) if self.data else local

    def out(self, y: torch.Tensor) -> DTensor:
        """This rank's (b, T, D) routed output as the ``DTensor`` (B, T, D):
        a partial sum over :attr:`split`."""
        return from_local_layout(y, self.mesh, _partial_on(self.like,
                                                           self.split))

