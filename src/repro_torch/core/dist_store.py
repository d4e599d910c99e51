"""The sharded data plane (counterpart of ``repro.core.dist_store``).

The reference runs TurboKV over a ``jax`` device mesh with ``shard_map``:
one storage node per device, the directory replicated on every device (each
ToR switch holds the same match-action table), the batch injected sharded
(each device fronts a slice of the clients) and routed by key, with
collectives standing in for switch hops.  It is a single-controller
program: one process drives every device, and the epoch driver's control
plane acts on the global ``(N, C)`` store.

The port keeps that single-controller design.  A :class:`ShardMesh` names
the shard count and its *parts*: one device each (``mesh.devices``), the
shards split over them in contiguous blocks, so source and target order
is the stacked order.  One part is the stacked layout: every shard along
the store's leading axis on one device.  Several parts put
``n_shards / k`` shards on each device (a
:class:`~repro_torch.core.store.StoreParts`), driven from one process; the
first device is the controller's, where the directory, the load
registers and the observe stage live.  The collectives of the per-shard
plane become:

* ``psum``: a sum of each part's deltas on the controller's device (the
  psum-delta of the counters and load registers, int64 carriers masked to
  32 bits after the sum: uint32 wraparound in any order);
* the tiled ``all_to_all`` of ``(n, cap, ...)`` buckets: on one part a
  transpose of the (source, target) axes (:func:`_a2a`); over several,
  :func:`exchange`, which copies part ``a``'s buckets for part ``b``'s
  targets to ``b``'s device (``Tensor.to``: PyTorch orders a copy between
  cards on both cards' current streams) and concatenates them in source
  order, row for row the stacked transpose;
* ``all_gather``: a flatten (the stacked slices are the global batch), or
  a gather of the parts' slices onto the controller's device;
* ``axis_index``: the row index, local to a part on its device.

Each part routes its shards' slices against its own copy of the
directory's tables (every ToR holds the same match-action table; the
copies are made at each control pull and pool growth, or at the call
when the caller keeps none) and its copy of the load registers, the
dirty table and ``queue_pen``, taken once an epoch.

Two routing strategies, as in the reference:

* ``allgather``: every shard routes the whole batch with the same draws
  and applies what it owns; the replies combine by a sum in which exactly
  one shard is nonzero (over parts: every part sees the whole batch and
  the parts' replies are summed on the controller's device).
* ``bucket_a2a``: shard ``me`` routes its slice ``q[me*Bl:(me+1)*Bl]``
  with draws of its own (``fold_in(rng, me)``), buckets the reads by
  target into bounded ``(n, cap)`` queues (overflowing queries are
  dropped and counted), one exchange round serves them and returns the
  replies, and the writes walk the replica chain in ``r_max`` sequential
  rounds (the chain replication dataflow of paper Fig 9a).  The GET probes
  of a round are ONE launch of K4a (``slab_lookup``) a part.

:func:`make_dist_apply` is one epoch per call; :func:`make_dist_period`
runs a control period's epochs, each the same plane followed by the
driver's observe stage on the whole batch, on the controller's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import keys as K
from repro_torch.core import routing as R
from repro_torch.core.store import (
    Responses,
    serve_reads,
    shards_read,
    shards_write,
)

DROP = -1  # bucket slot of a dead or overflowed query


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """The port's mesh: ``n_shards`` storage nodes over ``devices``, one
    device a part (a device may repeat: several parts on one card or on
    the CPU), driven by one controller on ``device``, the first part's.
    Shard ``s`` lives on ``devices[s // (n_shards // k)]``."""

    n_shards: int
    device: torch.device
    axis: str = "data"
    devices: tuple = ()

    def __post_init__(self):
        if not self.devices:
            object.__setattr__(self, "devices", (self.device,))
        if self.devices[0] != self.device:
            raise ValueError(f"the controller's device {self.device} is not "
                             f"the first part's ({self.devices[0]})")
        if self.n_shards < 1 or self.n_shards % len(self.devices):
            raise ValueError(f"{self.n_shards} shards do not split over "
                             f"{len(self.devices)} parts")

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: self.n_shards}

    @property
    def parts(self) -> int:
        return len(self.devices)

    @property
    def per_part(self) -> int:
        return self.n_shards // self.parts


def make_mesh(n_shards: int, device=None, cards=None, *,
              axis: str = "data") -> ShardMesh:
    """A :class:`ShardMesh`.  ``cards=k``: one part on each of ``cuda:0``
    .. ``cuda:k-1`` (raises when fewer cards are present); ``cards`` a
    list: one part on each device named (repeats allowed); neither: one
    part on ``device`` (``None`` = the CUDA card).  Devices are indexed
    (``cuda:0``, never ``cuda``), so a driver on ``cuda`` recognises its
    card; ``n_shards`` must be a multiple of the parts."""
    from repro_torch.device import indexed, resolve_device

    if cards is None:
        devices = (indexed(resolve_device(device)),)
    else:
        if isinstance(cards, int):
            if cards < 1:
                raise ValueError(f"a mesh over {cards} cards")
            devices = tuple(torch.device("cuda", i) for i in range(cards))
        else:
            devices = tuple(torch.device(d) for d in cards)
        if not devices:
            raise ValueError("a mesh over no device")
        present = (torch.cuda.device_count()
                   if torch.cuda.is_available() else 0)
        for d in devices:
            if d.type == "cuda" and (d.index or 0) >= present:
                raise ValueError(f"a mesh on {d}: {present} CUDA cards "
                                 "present")
        devices = tuple(indexed(d) for d in devices)
        if device is not None and indexed(device) != devices[0]:
            raise ValueError(f"device {device} is not the mesh's first "
                             f"({devices[0]})")
    return ShardMesh(int(n_shards), devices[0], axis, devices)


def replicate(directory, mesh: ShardMesh) -> dict:
    """The directory's copies on the mesh's other devices, ``{device:
    Directory}`` (tables and counters as they are now).  A part on the
    directory's own device routes against the directory itself."""
    home = directory.device
    out = {}
    for dev in mesh.devices:
        if dev != home and dev not in out:
            out[dev] = dataclasses.replace(directory, **{
                f.name: getattr(directory, f.name).to(dev, non_blocking=True)
                for f in dataclasses.fields(directory)
                if isinstance(getattr(directory, f.name), torch.Tensor)})
    return out


def _to_batch(q: R.QueryBatch, dev) -> R.QueryBatch:
    return R.QueryBatch(*(x.to(dev, non_blocking=True) for x in (
        q.opcode, q.key, q.end_key, q.value)))


def split_batch(q: R.QueryBatch, mesh: ShardMesh) -> list[R.QueryBatch]:
    """Each part's slices of the batch (its shards' slices in order) on
    its device: views on the batch's own device, copies elsewhere."""
    Bp = q.batch // mesh.parts
    out = []
    for a, dev in enumerate(mesh.devices):
        qa = R.QueryBatch(*(x[a * Bp:(a + 1) * Bp] for x in (
            q.opcode, q.key, q.end_key, q.value)))
        out.append(qa if dev == q.key.device else _to_batch(qa, dev))
    return out


def _gather(xs: list[torch.Tensor], dev) -> torch.Tensor:
    """The parts' pieces concatenated in part order on ``dev``."""
    if len(xs) == 1:
        return xs[0].to(dev)
    return torch.cat([x.to(dev, non_blocking=True) for x in xs])


# ---------------------------------------------------------------------------
# bounded bucketing (per source shard; rows of a stacked tensor)
# ---------------------------------------------------------------------------


def _rows(x: torch.Tensor):
    """``(x as rows, squeeze back)``: a 1-D source slice is one row."""
    if x.dim() == 1:
        return x[None], lambda y: y[0]
    return x, lambda y: y


def bucketize(target: torch.Tensor, n_shards: int, cap: int):
    """Group each source's queries by target shard into ``(n_shards, cap)``
    slots.  ``target``: ``(Bl,)`` or stacked ``(n_src, Bl)`` in
    ``[0, n_shards)``, or ``DROP`` for dead queries.  Returns ``(slot``,
    the flat bucket slot or ``DROP``, ``overflow)``, the count of queries
    a full bucket turned away per source.  A stable sort: earlier queries
    in batch order win bucket slots."""
    t, back = _rows(target)
    n_src, Bl = t.shape
    dev = t.device
    valid = (t >= 0) & (t < n_shards)
    tkey = torch.where(valid, t, n_shards).to(torch.int64)   # dead sort last
    order = torch.argsort(tkey, dim=1, stable=True)
    sorted_t = torch.gather(tkey, 1, order)
    groups = torch.arange(n_shards + 1, device=dev).expand(n_src, -1)
    group_start = torch.searchsorted(sorted_t, groups.contiguous(),
                                     side="left")
    pos = (torch.arange(Bl, device=dev)[None, :]
           - torch.gather(group_start, 1, sorted_t))
    live = sorted_t < n_shards
    keep = live & (pos < cap)
    slot_sorted = torch.where(keep, sorted_t * cap + pos, DROP)
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    overflow = (live & (pos >= cap)).sum(dim=1)
    return back(slot), back(overflow)


def scatter_to_buckets(slot: torch.Tensor, payload: torch.Tensor,
                       n_slots: int, fill):
    """Payload ``(Bl, ...)`` (or stacked ``(n_src, Bl, ...)``) -> buckets
    ``(n_slots, ...)``; ``DROP`` slots are discarded."""
    sl, back = _rows(slot)
    pl = payload[None] if slot.dim() == 1 else payload
    n_src = sl.shape[0]
    idx = torch.where(sl >= 0, sl, n_slots)       # the discard slot
    out = torch.full((n_src, n_slots + 1) + tuple(pl.shape[2:]), fill,
                     dtype=pl.dtype, device=pl.device)
    src = torch.arange(n_src, device=sl.device)[:, None].expand_as(idx)
    out[src, idx] = pl
    return back(out[:, :n_slots])


def gather_from_buckets(slot: torch.Tensor, buckets: torch.Tensor, fill):
    """Inverse of :func:`scatter_to_buckets`: each query's reply from its
    bucket slot, ``fill`` for a dropped query."""
    sl, back = _rows(slot)
    bk = buckets[None] if slot.dim() == 1 else buckets
    src = torch.arange(sl.shape[0], device=sl.device)[:, None].expand_as(sl)
    out = bk[src, torch.clamp(sl, min=0)]
    dead = (sl < 0).reshape(sl.shape + (1,) * (out.dim() - 2))
    return back(torch.where(dead, fill, out))


def _a2a(x: torch.Tensor, n: int) -> torch.Tensor:
    """The tiled all_to_all of the source shards' ``(n * cap, ...)``
    buckets: row ``t`` of the result is target ``t``'s inbound queue, the
    sources' ``cap`` chunks for ``t`` in source order."""
    rest = tuple(x.shape[2:])
    cap = x.shape[1] // n
    return x.reshape((n, n, cap) + rest).transpose(0, 1).reshape(
        (n, n * cap) + rest)


def exchange(xs: list[torch.Tensor], n: int, devices) -> list[torch.Tensor]:
    """The tiled all_to_all over parts: ``xs[a]`` is part ``a``'s
    ``(P, n * cap, ...)`` buckets (its source shards' rows, target-major
    chunks); the result's entry ``b`` is part ``b``'s ``(P, n * cap,
    ...)`` inbound queues on ``devices[b]``: row ``t`` holds every
    source's ``cap`` chunk for target ``b * P + t``, in source order.
    Row for row it is :func:`_a2a` of the stacked buckets; one part is
    that transpose itself.  The replies return through the same call."""
    k = len(xs)
    if k == 1:
        return [_a2a(xs[0], n)]
    P = n // k
    rest = tuple(xs[0].shape[2:])
    cap = xs[0].shape[1] // n
    # part a's buckets as (source, target part, target, cap, ...)
    views = [x.reshape((P, k, P, cap) + rest) for x in xs]
    out = []
    for b, dev in enumerate(devices):
        inbound = torch.cat([v[:, b].to(dev, non_blocking=True)
                             for v in views])          # (n, P, cap, ...)
        out.append(inbound.transpose(0, 1).reshape((P, n * cap) + rest))
    return out


def _psum_delta(base: torch.Tensor, news: list,
                bases: list[torch.Tensor] | None = None) -> torch.Tensor:
    """``base + psum(new - base)`` of uint32 registers in int64 carriers:
    the shards' deltas summed, then wrapped to 32 bits.  With ``bases``,
    ``news[a]`` is part ``a``'s list of new registers and ``bases[a]``
    its copy of the base, on its device: each part's deltas are summed
    there, then the parts' sums on ``base``'s device (integers, so the
    order of the sum does not change the bits)."""
    if bases is None:
        news, bases = [news], [base]
    delta = sum(torch.stack(na).sub_(ba).sum(dim=0).to(base.device,
                                                       non_blocking=True)
                for na, ba in zip(news, bases))
    return K.u32(base + delta)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))


# ---------------------------------------------------------------------------
# the distributed apply
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """The reference's knobs: ``axis`` of the mesh carrying the storage
    nodes; ``strategy`` ``"bucket_a2a"`` or ``"allgather"``;
    ``bucket_cap`` per (source, target) queue; ``max_scan_results``;
    ``read_spread`` (p2c reads, K2: the apply takes and returns the load
    registers and a PRNG key); ``return_decision`` (the routing decision
    in the metrics); ``replication_mode`` (``"craq"`` threads the dirty
    table into the route, K3, and returns the picked / bounced vectors);
    ``queue_pen`` (the overload plane's queue penalty joins the p2c
    comparison: the spread / craq apply takes it after the load
    registers)."""

    axis: str = "data"
    strategy: str = "bucket_a2a"
    bucket_cap: int = 64
    max_scan_results: int = 8
    read_spread: bool = False
    return_decision: bool = False
    replication_mode: str = "eventual"
    queue_pen: bool = False


def _route_shards(cfg: DistConfig, mesh: ShardMesh, directory, dirs,
                  qp: list[R.QueryBatch], load_reg, rng, dirty, queue_pen):
    """Each shard routes its slice on its part's device, against that
    part's copy of the directory (``dirs[a]``): ``(decisions, directory',
    load_reg', picked, bounced)``, the decisions (and craq's picked /
    bounced vectors) a list of each part's, its shards' slices in order
    on its device; the counters and load registers made globally
    consistent by the psum-delta on the controller's device.  Under p2c
    each shard draws from ``fold_in(rng, shard)`` (one launch of K2 / K3
    a shard), with its part's copy of the load registers, the dirty table
    and ``queue_pen``, taken once a call; the tail-read route (K1) is a
    pure function of each key, so one launch a part routes its slices,
    and the slices' counter bumps sum to the batch's."""
    craq = cfg.replication_mode == "craq"
    P = mesh.per_part
    if not (cfg.read_spread or craq):
        outs = [R.route(d, qa) for d, qa in zip(dirs, qp)]
        if len(outs) == 1:
            return [outs[0][0]], outs[0][1], load_reg, None, None
        directory = dataclasses.replace(directory, **{
            f: _psum_delta(getattr(directory, f),
                           [[getattr(o[1], f)] for o in outs],
                           [getattr(d, f) for d in dirs])
            for f in ("read_count", "write_count")})
        return [o[0] for o in outs], directory, load_reg, None, None
    copies = {}

    def local(dev):
        if dev not in copies:
            copies[dev] = tuple(None if x is None else x.to(
                dev, non_blocking=True) for x in (load_reg, dirty, queue_pen))
        return copies[dev]

    decisions, picked, bounced, news = [], [], [], []
    for a, (d, qa) in enumerate(zip(dirs, qp)):
        lr, dt, qpen = local(qa.key.device)
        Bl = qa.batch // P
        outs = []
        for i in range(P):
            qs = R.QueryBatch(*(x[i * Bl:(i + 1) * Bl] for x in (
                qa.opcode, qa.key, qa.end_key, qa.value)))
            r = prng.fold_in(rng, a * P + i)
            if craq:
                outs.append(R.route_load_aware_dirty(d, qs, lr, dt, r,
                                                     queue_pen=qpen))
            else:
                outs.append((*R.route_load_aware(d, qs, lr, r,
                                                 queue_pen=qpen), None, None))
        decisions.append(R.RoutingDecision(*[
            torch.cat([getattr(o[0], f.name) for o in outs])
            for f in dataclasses.fields(R.RoutingDecision)]))
        news.append(outs)
        if craq:
            picked.append(torch.cat([o[3] for o in outs]))
            bounced.append(torch.cat([o[4] for o in outs]))
    new_dir = dataclasses.replace(directory, **{
        f: _psum_delta(getattr(directory, f),
                       [[getattr(o[1], f) for o in outs] for outs in news],
                       [getattr(d, f) for d in dirs])
        for f in ("read_count", "write_count")})
    load_reg = _psum_delta(load_reg, [[o[2] for o in outs] for outs in news],
                           [local(qa.key.device)[0] for qa in qp])
    if not craq:
        picked = bounced = None
    return decisions, new_dir, load_reg, picked, bounced


def _empty_scans(B: int, S: int, V: int, dev):
    """The scan answers of a batch without SCAN, as zero-stride views."""
    return (torch.zeros((), dtype=torch.float32, device=dev).expand(B, S, V),
            torch.full((), K.EMPTY_KEY, dtype=torch.int64,
                       device=dev).expand(B, S),
            torch.zeros((), dtype=torch.int64, device=dev).expand(B))


def _part_inputs(mesh: ShardMesh, directory, q, q_parts, dir_copies):
    """The parts' slices of the batch and their copies of the directory."""
    qp = split_batch(q, mesh) if q_parts is None else list(q_parts)
    copies = (replicate(directory, mesh) if dir_copies is None
              else dir_copies)
    dirs = [directory if dev == directory.device else copies[dev]
            for dev in mesh.devices]
    return qp, dirs


def _make_bucket_plane(cfg: DistConfig, mesh: ShardMesh):
    """The ``bucket_a2a`` data plane, shared by :func:`make_dist_apply`
    and :func:`make_dist_period`: route the slices, one read exchange
    round, ``r_max`` sequential write rounds along the chain, the slabs
    updated in place, part by part on each part's device.

    Returns ``plane(store, directory, q, load_reg, rng, dirty, queue_pen,
    *, scans, write_rounds, q_parts, dir_copies) -> (store, resp,
    directory', load_reg', decision, picked, bounced, bucket_overflow,
    rounds)``, ``q`` the whole batch (the shards' slices in order) on the
    controller's device, ``bucket_overflow`` ``(n,)`` per source shard,
    ``rounds`` the exchange rounds run (a host int); the replies,
    decision and registers on the controller's device; ``load_reg`` /
    ``rng`` / ``dirty`` / ``queue_pen`` ride through untouched on the
    paths that ignore them.  ``scans=False`` is the caller's knowledge
    that the batch holds no SCAN; ``write_rounds`` its knowledge that no
    chain is longer (the controller's host tables): a round past every
    chain carries no write, and a round without writes leaves every slab
    as it was (their dead tails are zero), so those rounds are not run.
    ``q_parts``: each part's slices already on its device (the caller
    sent them from the host), else copied from ``q``; ``dir_copies``: the
    directory's copies on the other devices (:func:`replicate`), else
    made now."""
    n = mesh.n_shards
    P = mesh.per_part
    devs = mesh.devices
    cap = cfg.bucket_cap
    n_slots = n * cap

    def plane(store, directory, q: R.QueryBatch, load_reg, rng, dirty,
              queue_pen, *, scans: bool = True,
              write_rounds: int | None = None, q_parts=None,
              dir_copies=None):
        B = q.batch
        if B % n:
            raise ValueError(f"batch {B} does not split over {n} shards")
        dev = q.key.device
        Bl = B // n
        rows = lambda x: x.reshape((P, Bl) + tuple(x.shape[1:]))
        qp, dirs = _part_inputs(mesh, directory, q, q_parts, dir_copies)
        decs, directory, load_reg, picked, bounced = _route_shards(
            cfg, mesh, directory, dirs, qp, load_reg, rng, dirty, queue_pen)
        is_write = [(x.opcode == K.OP_PUT) | (x.opcode == K.OP_DEL)
                    for x in qp]
        live_key = [x.key != K.EMPTY_KEY for x in qp]
        V = store.value_dim
        S = cfg.max_scan_results

        def send(slots, name, fill):
            """A field of every part's slices into its buckets, exchanged:
            each part's inbound queues."""
            return exchange([scatter_to_buckets(sl, rows(getattr(x, name)),
                                                n_slots, fill)
                             for sl, x in zip(slots, qp)], n, devs)

        def back(replies, slots, fill):
            """The parts' replies exchanged back, each query's from its
            bucket slot: a flat list a source part, on its device."""
            return [_flat(gather_from_buckets(sl, r, fill))
                    for sl, r in zip(slots, exchange(replies, n, devs))]

        # --- reads: one exchange round to the serving node and back ---
        slots, ovf = zip(*(bucketize(rows(torch.where(~w & lk, d.target,
                                                      DROP)), n, cap)
                           for w, lk, d in zip(is_write, live_key, decs)))
        got = []
        for part, bkeys, bop, bend in zip(
                store.parts, send(slots, "key", K.EMPTY_KEY),
                send(slots, "opcode", K.OP_GET), send(slots, "end_key", 0)):
            inbound = R.QueryBatch(bop, bkeys, bend, torch.zeros(
                (), dtype=torch.float32, device=bkeys.device).expand(
                    P, n_slots, V))
            read_mine = (((bop == K.OP_GET) | (bop == K.OP_SCAN))
                         & (bkeys != K.EMPTY_KEY))
            got.append(shards_read(part, inbound, read_mine,
                                   max_scan_results=S, scans=scans))
        value = back([g.value for g in got], slots, 0.0)
        found = back([g.found for g in got], slots, False)
        if scans:
            sv, sk, sc = (_gather(back([getattr(g, f) for g in got], slots,
                                       fill), dev)
                          for f, fill in (("scan_values", 0.0),
                                          ("scan_keys", K.EMPTY_KEY),
                                          ("scan_count", 0)))
        else:
            sv, sk, sc = _empty_scans(B, S, V, dev)

        # --- writes: r_max sequential rounds along the chain (Fig 9a) ---
        ovf = list(ovf)
        n_writes = decs[0].chain.shape[1]
        if write_rounds is not None:
            n_writes = min(n_writes, write_rounds)
        for pos in range(n_writes):
            wslots = []
            for a, (w, lk, d) in enumerate(zip(is_write, live_key, decs)):
                live = w & (pos < d.chain_len) & lk
                sl, w_ovf = bucketize(rows(torch.where(
                    live, d.chain[:, pos], DROP)), n, cap)
                wslots.append(sl)
                ovf[a] = ovf[a] + w_ovf
            hits = []
            for part, wkeys, wop, wval in zip(
                    store.parts, send(wslots, "key", K.EMPTY_KEY),
                    send(wslots, "opcode", K.OP_GET),
                    send(wslots, "value", 0.0)):
                wq = R.QueryBatch(wop, wkeys, torch.zeros_like(wkeys), wval)
                write_mine = (((wop == K.OP_PUT) | (wop == K.OP_DEL))
                              & (wkeys != K.EMPTY_KEY))
                # a DEL's hit is probed before the round's mutation
                hits.append(shards_read(part, wq, None, max_scan_results=1,
                                        scans=False,
                                        del_mine=write_mine).found)
                shards_write(part, wq, write_mine)
            # the DEL's found flag returns from the chain tail
            for a, hit in enumerate(back(hits, wslots, False)):
                at_tail = is_write[a] & (pos == decs[a].chain_len - 1)
                found[a] = torch.where(at_tail, hit, found[a])
        resp = Responses(value=_gather(value, dev), found=_gather(found, dev),
                         scan_values=sv, scan_keys=sk, scan_count=sc)
        decision = R.RoutingDecision(*[
            _gather([getattr(d, f.name) for d in decs], dev)
            for f in dataclasses.fields(R.RoutingDecision)])
        if picked is not None:
            picked, bounced = _gather(picked, dev), _gather(bounced, dev)
        return (store, resp, directory, load_reg, decision, picked, bounced,
                _gather(ovf, dev), 1 + n_writes)

    return plane


def _make_allgather_plane(cfg: DistConfig, mesh: ShardMesh):
    """The ``allgather`` data plane (same signature as the bucket plane;
    ``q_parts`` and ``dir_copies`` are not used): every shard sees the
    whole batch, routed with the same draws on the controller's device,
    so the decision is the batch's; each part receives the batch and the
    decision, and its shard ``n`` serves the reads it is the target of and
    applies the writes it is a live chain member of.  The replies combine
    by a sum over the parts on the controller's device in which only the
    owner's is nonzero: a write's reply carries no DEL hit and a scan-key
    word of 0 (the uint32 sum of zeros), and a float ``-0.0`` answer
    becomes ``+0.0``."""
    n = mesh.n_shards
    P = mesh.per_part
    craq = cfg.replication_mode == "craq"

    def plane(store, directory, q: R.QueryBatch, load_reg, rng, dirty,
              queue_pen, *, scans: bool = True,
              write_rounds: int | None = None, q_parts=None,
              dir_copies=None):
        picked = bounced = None
        if craq:
            decision, directory, load_reg, picked, bounced = (
                R.route_load_aware_dirty(directory, q, load_reg, dirty, rng,
                                         queue_pen=queue_pen))
        elif cfg.read_spread:
            decision, directory, load_reg = R.route_load_aware(
                directory, q, load_reg, rng, queue_pen=queue_pen)
        else:
            decision, directory = R.route(directory, q)
        B = q.batch
        dev = q.key.device
        S = cfg.max_scan_results
        is_write = (q.opcode == K.OP_PUT) | (q.opcode == K.OP_DEL)
        r_max = decision.chain.shape[1]
        member_live = (torch.arange(r_max, device=dev)[None, :]
                       < decision.chain_len[:, None])
        replies = []
        for a, part in enumerate(store.parts):
            pdev = mesh.devices[a]
            to = lambda x: x.to(pdev, non_blocking=True)
            qa = q if pdev == dev else _to_batch(q, pdev)
            target, chain, live, wr = (to(decision.target),
                                       to(decision.chain), to(member_live),
                                       to(is_write))
            base = a * P
            owned = ~wr & (target >= base) & (target < base + P)
            got = serve_reads(part, torch.where(owned, target - base, -1),
                              qa, owned, None, max_scan_results=S,
                              scans=scans)
            replies.append((got.value, got.found) + ((
                got.scan_values, torch.where(owned[:, None], got.scan_keys,
                                             0), got.scan_count)
                if scans else ()))
            shard = torch.arange(base, base + P, device=pdev)
            write_mine = wr[None, :] & (
                (chain[None] == shard[:, None, None]) & live[None]).any(dim=2)
            whole = R.QueryBatch(*(x[None].expand((P,) + tuple(x.shape))
                                   for x in (qa.opcode, qa.key, qa.end_key,
                                             qa.value)))
            shards_write(part, whole, write_mine)
        total = lambda i: sum(r[i].to(dev, non_blocking=True)
                              for r in replies[1:]) + replies[0][i]
        found = replies[0][1]
        for r in replies[1:]:
            found = found | r[1].to(dev, non_blocking=True)
        if scans:
            sv, sk, sc = total(2) + 0.0, total(3), total(4)
        else:
            owned = ~is_write & (decision.target >= 0) & (decision.target < n)
            sv, sk, sc = _empty_scans(B, S, store.value_dim, dev)
            sk = torch.where(owned[:, None], sk, 0)
        resp = Responses(value=total(0) + 0.0, found=found, scan_values=sv,
                         scan_keys=sk, scan_count=sc)
        ovf = torch.zeros(n, dtype=torch.int64, device=dev)
        return (store, resp, directory, load_reg, decision, picked, bounced,
                ovf, 0)

    return plane


def _check_cfg(cfg: DistConfig, n_shards: int) -> None:
    if cfg.replication_mode not in ("eventual", "chain", "craq"):
        raise ValueError(f"unknown replication_mode {cfg.replication_mode!r}")
    if cfg.replication_mode == "craq" and not cfg.read_spread:
        raise ValueError("replication_mode='craq' needs read_spread=True "
                         "(apportioned reads are the protocol)")
    if cfg.strategy not in ("bucket_a2a", "allgather"):
        raise ValueError(f"unknown strategy {cfg.strategy!r}")
    if n_shards < 1:
        raise ValueError(f"a mesh of {n_shards} shards")


def _check_store(store, mesh: ShardMesh) -> None:
    if store.num_shards != mesh.n_shards:
        raise ValueError(f"store of {store.num_shards} shards on a mesh of "
                         f"{mesh.n_shards}: one storage node per shard")
    devs = tuple(p.keys.device for p in store.parts)
    if len(devs) != mesh.parts or any(
            d != m for d, m in zip(devs, mesh.devices)):
        raise ValueError(f"store in {len(devs)} parts on {devs}, mesh in "
                         f"{mesh.parts} on {mesh.devices}")


def make_dist_apply(mesh: ShardMesh, directory_template, cfg: DistConfig):
    """Build the distributed batch apply (one epoch a call).

    Signatures of the returned function, as the reference's:

    * ``(store, directory, q) -> (store, responses, directory', metrics)``;
    * with ``cfg.read_spread``: ``(store, directory, load_reg, [queue_pen,]
      q, rng) -> (store, responses, directory', load_reg', metrics)``;
    * with ``replication_mode="craq"``: ``(store, directory, load_reg,
      [queue_pen,] dirty, q, rng)`` -> the same;

    ``queue_pen`` present with ``cfg.queue_pen``; every form takes the
    keywords ``scans`` (False: the batch holds no SCAN),
    ``write_rounds`` (no chain is longer), ``q_parts`` and ``dir_copies``
    (see :func:`_make_bucket_plane`).  ``store`` is a
    :class:`~repro_torch.core.store.StoreState` on a one-part mesh, a
    :class:`~repro_torch.core.store.StoreParts` split as the mesh is
    otherwise, updated in place; the batch, directory and registers lie
    on the controller's device.  ``metrics`` holds ``bucket_overflow``
    (the first shard's count, the value the reference's replicated output
    carries), ``bucket_overflow_shards`` (every source shard's),
    ``a2a_rounds`` (the exchange rounds actually run, a 0-d host tensor:
    the read round and the write rounds, so ``1 + min(r_max,
    write_rounds)`` where the reference counts a fixed ``1 + r_max``; 0 for
    ``allgather``) and, with ``cfg.return_decision``, the decision (``ridx``,
    ``target``, ``chain``, ``chain_len``; craq adds ``picked`` and
    ``bounced``).  ``directory_template`` keeps the reference's signature
    (there it fixes the sharding specs); the plane reads the directory
    it is called with."""
    n = mesh.shape[cfg.axis]
    _check_cfg(cfg, n)
    craq = cfg.replication_mode == "craq"
    spread = cfg.read_spread
    allgather = cfg.strategy == "allgather"
    plane = (_make_allgather_plane if allgather else _make_bucket_plane)(
        cfg, mesh)

    def per_device(store, directory, q, load_reg=None, rng=None, dirty=None,
                   queue_pen=None, **kw):
        _check_store(store, mesh)
        (store, resp, directory, load_reg, decision, picked, bounced,
         ovf, rounds) = plane(store, directory, q, load_reg, rng, dirty,
                              queue_pen, **kw)
        metrics = {
            "bucket_overflow": ovf[0],
            "bucket_overflow_shards": ovf,
            "a2a_rounds": torch.tensor(rounds, dtype=torch.int64),
        }
        if cfg.return_decision:
            metrics.update(ridx=decision.ridx, target=decision.target,
                           chain=decision.chain, chain_len=decision.chain_len)
            if craq:
                metrics.update(picked=picked, bounced=bounced)
        if spread:
            return store, resp, directory, load_reg, metrics
        return store, resp, directory, metrics

    if craq and cfg.queue_pen:
        def entry(store, directory, load_reg, qpen, dirty, q, rng, **kw):
            return per_device(store, directory, q, load_reg, rng, dirty,
                              qpen, **kw)
    elif craq:
        def entry(store, directory, load_reg, dirty, q, rng, **kw):
            return per_device(store, directory, q, load_reg, rng, dirty,
                              None, **kw)
    elif spread and cfg.queue_pen:
        def entry(store, directory, load_reg, qpen, q, rng, **kw):
            return per_device(store, directory, q, load_reg, rng, None,
                              qpen, **kw)
    elif spread:
        def entry(store, directory, load_reg, q, rng, **kw):
            return per_device(store, directory, q, load_reg, rng, None, None,
                              **kw)
    else:
        def entry(store, directory, q, **kw):
            return per_device(store, directory, q, **kw)
    return entry


def stack_epochs(items: list):
    """Stack per-epoch outputs (tensors, dataclasses of tensors, tuples of
    tensors, or None) along a new leading epoch axis."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if dataclasses.is_dataclass(first):
        return type(first)(*[torch.stack([getattr(x, f.name) for x in items])
                             for f in dataclasses.fields(first)])
    return tuple(torch.stack(list(xs)) for xs in zip(*items))


def make_dist_period(mesh: ShardMesh, directory_template, cfg: DistConfig, *,
                     pre, observe, fold_ovl: bool):
    """Build the whole-period program: the period's epochs, each the
    ``bucket_a2a`` plane on the batch followed by the observe stage on
    the whole batch's decision (per-node op counts, the sketch, the
    overload step, hop plans, the register advance, spans, the metrics
    row: stages that depend on the global batch order).

    ``pre(repl, ovl) -> (dirty, queue_pen)`` derives the routing inputs
    from the carried state as the per-epoch driver does between steps;
    ``observe(q, ridx, target, chain, chain_len, sketch, rng, repl, picked,
    bounced, ovl, r_ovl, eid, coord, metrics) -> (sketch, plan, node_ops,
    repl, ovl, coord, metrics, ostats, cstats, spans)`` is the per-epoch
    observe body; ``fold_ovl`` mirrors the driver's overload-stream fold.

    Returned: ``(store, directory, load_reg, sketch, repl, ovl, coord,
    metrics, qs, rngs, eids, *, scans=None, write_rounds=None,
    dir_copies=None) ->
    (store, directory, load_reg, sketch, repl, ovl, coord, metrics,
    a2a_rounds, plans, node_ops, bucket_overflow, overflow_totals,
    bounced, ostats, cstats, spans)``, ``qs`` the period's batches (any
    iterable, taken one epoch at a time: a generator lets the caller make
    each batch while the device runs the epoch before it; an item may be
    ``(q, q_parts)``, the parts' slices already on their devices), ``rngs`` their
    keys, ``eids`` the epoch ids, ``scans`` which batches hold a SCAN (all,
    when None; read at each epoch after its batch is taken) and
    ``write_rounds`` the longest chain of the period (see
    :func:`_make_bucket_plane`), ``dir_copies`` the directory's copies on
    the mesh's other devices (the tables do not change within a period).
    Every epoch given is a real one: the
    reference's padding epochs compute and commit nothing, so they are
    not passed.  ``a2a_rounds`` is the host count of exchange rounds run
    over the period; the rest is stacked over the epochs,
    ``bucket_overflow`` ``(L, n)``, every source shard's count."""
    n = mesh.shape[cfg.axis]
    _check_cfg(cfg, n)
    if cfg.strategy != "bucket_a2a":
        raise ValueError(
            "make_dist_period fuses the bucket_a2a data plane only "
            f"(strategy={cfg.strategy!r}); use make_dist_apply per epoch")
    plane = _make_bucket_plane(cfg, mesh)
    craq = cfg.replication_mode == "craq"
    spread = cfg.read_spread

    def period(store, directory, load_reg, sketch, repl, ovl, coord, metrics,
               qs, rngs, eids, *, scans=None, write_rounds=None,
               dir_copies=None):
        _check_store(store, mesh)
        outs = []
        a2a_rounds = 0
        # qs first: the caller's generator is resumed once past the last
        # epoch, so it can close that epoch's work
        for i, (q, rng, eid) in enumerate(zip(qs, rngs, eids)):
            q, q_parts = q if isinstance(q, tuple) else (q, None)
            rng = np.asarray(rng, np.uint32)
            r_ovl = prng.fold_in(rng, 0x0F10AD) if fold_ovl else rng
            r_route, r_plan = prng.split(rng)
            dirty, queue_pen = pre(repl, ovl)
            (store, _resp, directory, load_reg, decision, picked, bounced,
             ovf, rounds) = plane(
                 store, directory, q, load_reg, r_route, dirty, queue_pen,
                 scans=True if scans is None else scans[i],
                 write_rounds=write_rounds, q_parts=q_parts,
                 dir_copies=dir_copies)
            a2a_rounds += rounds
            if not craq:
                # placeholders keep observe's signature mode-independent
                picked = decision.target
                bounced = torch.zeros(q.batch, dtype=torch.bool,
                                      device=q.key.device)
            (sketch, plan, node_ops, repl, ovl, coord, metrics, ostats,
             cstats, spans) = observe(
                q, decision.ridx, decision.target, decision.chain,
                decision.chain_len, sketch, r_plan, repl, picked, bounced,
                ovl, r_ovl, int(eid), coord, metrics)
            if not spread:
                # tail-read path: registers tracked in the same units
                load_reg = K.u32(load_reg + node_ops)
            outs.append((plan, node_ops, ovf, store.overflow.sum(), bounced,
                         ostats, cstats, spans))
        if not outs:
            raise ValueError("a period with no epoch")
        stacked = [stack_epochs([o[k] for o in outs]) for k in range(8)]
        return (store, directory, load_reg, sketch, repl, ovl, coord,
                metrics, a2a_rounds, *stacked)

    return period
