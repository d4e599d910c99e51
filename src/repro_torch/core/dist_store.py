"""The sharded data plane (counterpart of ``repro.core.dist_store``).

The reference runs TurboKV over a ``jax`` device mesh with ``shard_map``:
one storage node per device, the directory replicated on every device (each
ToR switch holds the same match-action table), the batch injected sharded
(each device fronts a slice of the clients) and routed by key, with
collectives standing in for switch hops.  It is a single-controller
program: one process drives every device, and the epoch driver's control
plane acts on the global ``(N, C)`` store.

The port keeps that single-controller design on one device.  A
:class:`ShardMesh` names the shard count; the shards are stacked along the
store's leading axis, and the collectives of the per-shard plane become
tensor operations on that axis:

* ``psum``: a sum over it (the psum-delta of the counters and load
  registers, int64 carriers masked to 32 bits after the sum: uint32
  wraparound in any order);
* the tiled ``all_to_all`` of ``(n, cap, ...)`` buckets: a transpose of
  the (source, target) axes (:func:`_a2a`);
* ``all_gather``: a flatten (the stacked slices are the global batch);
* ``axis_index``: the row index.

Two routing strategies, as in the reference:

* ``allgather``: every shard routes the whole batch with the same draws
  and applies what it owns; the replies combine by a sum in which exactly
  one shard is nonzero.
* ``bucket_a2a``: shard ``me`` routes its slice ``q[me*Bl:(me+1)*Bl]``
  with draws of its own (``fold_in(rng, me)``), buckets the reads by
  target into bounded ``(n, cap)`` queues (overflowing queries are
  dropped and counted), one exchange round serves them and returns the
  replies, and the writes walk the replica chain in ``r_max`` sequential
  rounds (the chain replication dataflow of paper Fig 9a).  The GET probes
  of a round, from every shard, are ONE launch of K4a (``slab_lookup``).

:func:`make_dist_apply` is one epoch per call; :func:`make_dist_period`
runs a control period's epochs, each the same plane followed by the
driver's observe stage on the whole batch.  Shards on several cards (one
storage node per card) are not built: they wait for a machine with
several cards (ROADMAP).
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
    StoreState,
    serve_reads,
    shards_read,
    shards_write,
)

DROP = -1  # bucket slot of a dead or overflowed query


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """The port's mesh: ``n_shards`` storage nodes, stacked along the
    store's leading axis on ``device``, driven by one controller."""

    n_shards: int
    device: torch.device
    axis: str = "data"

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: self.n_shards}


def make_mesh(n_shards: int, device=None, axis: str = "data") -> ShardMesh:
    """A :class:`ShardMesh` on ``device`` (``None`` = the CUDA card)."""
    from repro_torch.device import resolve_device

    return ShardMesh(int(n_shards), resolve_device(device), axis)


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


def _psum_delta(base: torch.Tensor, news: list[torch.Tensor]) -> torch.Tensor:
    """``base + psum(new - base)`` of uint32 registers in int64 carriers:
    the shards' deltas summed, then wrapped to 32 bits."""
    delta = torch.stack(news).sub_(base).sum(dim=0)
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


def _slices(q: R.QueryBatch, n: int) -> list[R.QueryBatch]:
    Bl = q.batch // n
    return [R.QueryBatch(*(x[me * Bl:(me + 1) * Bl] for x in (
        q.opcode, q.key, q.end_key, q.value))) for me in range(n)]


def _route_shards(cfg: DistConfig, n: int, directory, q: R.QueryBatch,
                  load_reg, rng, dirty, queue_pen):
    """Each shard routes its slice: ``(decision, directory', load_reg',
    picked, bounced)`` of the whole batch, the counters and load registers
    made globally consistent by the psum-delta.  Under p2c each shard
    draws from ``fold_in(rng, shard)`` (one launch of K2 / K3 a shard);
    the tail-read route (K1) is a pure function of each key, so one
    launch routes every slice, and the slices' counter bumps sum to the
    batch's."""
    craq = cfg.replication_mode == "craq"
    if not (cfg.read_spread or craq):
        decision, directory = R.route(directory, q)
        return decision, directory, load_reg, None, None
    outs = []
    for me, qs in enumerate(_slices(q, n)):
        r = prng.fold_in(rng, me)
        if craq:
            outs.append(R.route_load_aware_dirty(
                directory, qs, load_reg, dirty, r, queue_pen=queue_pen))
        else:
            outs.append((*R.route_load_aware(
                directory, qs, load_reg, r, queue_pen=queue_pen), None, None))
    decision = R.RoutingDecision(*[
        torch.cat([getattr(o[0], f.name) for o in outs])
        for f in dataclasses.fields(R.RoutingDecision)])
    new_dir = dataclasses.replace(
        directory,
        read_count=_psum_delta(directory.read_count,
                               [o[1].read_count for o in outs]),
        write_count=_psum_delta(directory.write_count,
                                [o[1].write_count for o in outs]),
    )
    load_reg = _psum_delta(load_reg, [o[2] for o in outs])
    picked = bounced = None
    if craq:
        picked = torch.cat([o[3] for o in outs])
        bounced = torch.cat([o[4] for o in outs])
    return decision, new_dir, load_reg, picked, bounced


def _empty_scans(B: int, S: int, V: int, dev):
    """The scan answers of a batch without SCAN, as zero-stride views."""
    return (torch.zeros((), dtype=torch.float32, device=dev).expand(B, S, V),
            torch.full((), K.EMPTY_KEY, dtype=torch.int64,
                       device=dev).expand(B, S),
            torch.zeros((), dtype=torch.int64, device=dev).expand(B))


def _make_bucket_plane(cfg: DistConfig, n_shards: int):
    """The ``bucket_a2a`` data plane, shared by :func:`make_dist_apply`
    and :func:`make_dist_period`: route the slices, one read exchange
    round, ``r_max`` sequential write rounds along the chain, the slabs
    updated in place.

    Returns ``plane(store, directory, q, load_reg, rng, dirty, queue_pen,
    *, scans, write_rounds) -> (store, resp, directory', load_reg',
    decision, picked, bounced, bucket_overflow, rounds)``, ``q`` the whole
    batch (the shards' slices in order), ``bucket_overflow`` ``(n,)`` per
    source shard, ``rounds`` the exchange rounds run (a host int); ``load_reg`` / ``rng`` / ``dirty`` / ``queue_pen`` ride
    through untouched on the paths that ignore them.  ``scans=False`` is
    the caller's knowledge that the batch holds no SCAN;
    ``write_rounds`` its knowledge that no chain is longer (the
    controller's host tables): a round past every chain carries no write,
    and a round without writes leaves every slab as it was (their dead
    tails are zero), so those rounds are not run."""
    n = n_shards
    cap = cfg.bucket_cap
    n_slots = n * cap

    def plane(store: StoreState, directory, q: R.QueryBatch, load_reg, rng,
              dirty, queue_pen, *, scans: bool = True,
              write_rounds: int | None = None):
        B = q.batch
        if B % n:
            raise ValueError(f"batch {B} does not split over {n} shards")
        dev = q.key.device
        rows = lambda x: x.reshape((n, B // n) + tuple(x.shape[1:]))
        decision, directory, load_reg, picked, bounced = _route_shards(
            cfg, n, directory, q, load_reg, rng, dirty, queue_pen)
        is_write = (q.opcode == K.OP_PUT) | (q.opcode == K.OP_DEL)
        live_key = q.key != K.EMPTY_KEY
        V = store.value_dim
        S = cfg.max_scan_results

        # --- reads: one exchange round to the serving node and back ---
        read_target = torch.where(~is_write & live_key, decision.target, DROP)
        slot, ovf = bucketize(rows(read_target), n, cap)
        bkeys, bop, bend = (_a2a(scatter_to_buckets(slot, rows(x), n_slots,
                                                    fill), n)
                            for x, fill in ((q.key, K.EMPTY_KEY),
                                            (q.opcode, K.OP_GET),
                                            (q.end_key, 0)))
        inbound = R.QueryBatch(bop, bkeys, bend, torch.zeros(
            (), dtype=torch.float32, device=dev).expand(n, n_slots, V))
        read_mine = (((bop == K.OP_GET) | (bop == K.OP_SCAN))
                     & (bkeys != K.EMPTY_KEY))
        got = shards_read(store, inbound, read_mine, max_scan_results=S,
                          scans=scans)
        back = lambda x, fill: _flat(gather_from_buckets(slot, _a2a(x, n),
                                                         fill))
        value = back(got.value, 0.0)
        found = back(got.found, False)
        if scans:
            sv, sk, sc = (back(got.scan_values, 0.0),
                          back(got.scan_keys, K.EMPTY_KEY),
                          back(got.scan_count, 0))
        else:
            sv, sk, sc = _empty_scans(B, S, V, dev)

        # --- writes: r_max sequential rounds along the chain (Fig 9a) ---
        n_writes = decision.chain.shape[1]
        if write_rounds is not None:
            n_writes = min(n_writes, write_rounds)
        for pos in range(n_writes):
            live = is_write & (pos < decision.chain_len) & live_key
            wt = torch.where(live, decision.chain[:, pos], DROP)
            wslot, w_ovf = bucketize(rows(wt), n, cap)
            ovf = ovf + w_ovf
            wkeys, wop, wval = (_a2a(scatter_to_buckets(wslot, rows(x),
                                                        n_slots, fill), n)
                                for x, fill in ((q.key, K.EMPTY_KEY),
                                                (q.opcode, K.OP_GET),
                                                (q.value, 0.0)))
            wq = R.QueryBatch(wop, wkeys, torch.zeros_like(wkeys), wval)
            write_mine = (((wop == K.OP_PUT) | (wop == K.OP_DEL))
                          & (wkeys != K.EMPTY_KEY))
            # a DEL's hit is probed before the round's mutation
            del_hit = shards_read(store, wq, None, max_scan_results=1,
                                  scans=False, del_mine=write_mine).found
            shards_write(store, wq, write_mine)
            # the DEL's found flag returns from the chain tail
            at_tail = is_write & (pos == decision.chain_len - 1)
            found = torch.where(
                at_tail, _flat(gather_from_buckets(wslot, _a2a(del_hit, n),
                                                   False)), found)
        resp = Responses(value=value, found=found, scan_values=sv,
                         scan_keys=sk, scan_count=sc)
        return (store, resp, directory, load_reg, decision, picked, bounced,
                ovf, 1 + n_writes)

    return plane


def _make_allgather_plane(cfg: DistConfig, n_shards: int):
    """The ``allgather`` data plane (same signature as the bucket plane):
    every shard sees the whole batch, routed with the same draws, so the
    decision is the batch's; shard ``n`` serves the reads it is the target
    of and applies the writes it is a live chain member of.  The replies
    combine by a sum over the shards in which only the owner's is
    nonzero: a write's reply carries no DEL hit and a scan-key word of 0
    (the uint32 sum of zeros), and a float ``-0.0`` answer becomes
    ``+0.0``."""
    n = n_shards
    craq = cfg.replication_mode == "craq"

    def plane(store: StoreState, directory, q: R.QueryBatch, load_reg, rng,
              dirty, queue_pen, *, scans: bool = True,
              write_rounds: int | None = None):
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
        is_write = (q.opcode == K.OP_PUT) | (q.opcode == K.OP_DEL)
        owned = ~is_write & (decision.target >= 0) & (decision.target < n)
        got = serve_reads(store, decision.target, q, owned, None,
                          max_scan_results=cfg.max_scan_results, scans=scans)
        if scans:
            sv = got.scan_values + 0.0
            sk = torch.where(owned[:, None], got.scan_keys, 0)
            sc = got.scan_count
        else:
            sv, sk, sc = _empty_scans(B, cfg.max_scan_results,
                                      store.value_dim, dev)
            sk = torch.where(owned[:, None], sk, 0)
        resp = Responses(value=got.value + 0.0, found=got.found,
                         scan_values=sv, scan_keys=sk, scan_count=sc)
        r_max = decision.chain.shape[1]
        member_live = (torch.arange(r_max, device=dev)[None, :]
                       < decision.chain_len[:, None])
        shard = torch.arange(n, device=dev)
        write_mine = is_write[None, :] & (
            (decision.chain[None] == shard[:, None, None])
            & member_live[None]).any(dim=2)
        whole = R.QueryBatch(*(x[None].expand((n,) + tuple(x.shape))
                               for x in (q.opcode, q.key, q.end_key,
                                         q.value)))
        shards_write(store, whole, write_mine)
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


def _check_store(store: StoreState, n_shards: int) -> None:
    if store.num_shards != n_shards:
        raise ValueError(f"store of {store.num_shards} shards on a mesh of "
                         f"{n_shards}: one storage node per shard")


def make_dist_apply(mesh: ShardMesh, directory_template, cfg: DistConfig):
    """Build the distributed batch apply (one epoch a call).

    Signatures of the returned function, as the reference's:

    * ``(store, directory, q) -> (store, responses, directory', metrics)``;
    * with ``cfg.read_spread``: ``(store, directory, load_reg, [queue_pen,]
      q, rng) -> (store, responses, directory', load_reg', metrics)``;
    * with ``replication_mode="craq"``: ``(store, directory, load_reg,
      [queue_pen,] dirty, q, rng)`` -> the same;

    ``queue_pen`` present with ``cfg.queue_pen``; every form takes the
    keywords ``scans`` (False: the batch holds no SCAN) and
    ``write_rounds`` (no chain is longer; see :func:`_make_bucket_plane`).
    The store is updated in place.  ``metrics`` holds ``bucket_overflow``
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
        cfg, n)

    def per_device(store, directory, q, load_reg=None, rng=None, dirty=None,
                   queue_pen=None, **kw):
        _check_store(store, n)
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
    metrics, qs, rngs, eids, *, scans=None, write_rounds=None) ->
    (store, directory, load_reg, sketch, repl, ovl, coord, metrics,
    a2a_rounds, plans, node_ops, bucket_overflow, overflow_totals,
    bounced, ostats, cstats, spans)``, ``qs`` the period's batches (any
    iterable, taken one epoch at a time: a generator lets the caller make
    each batch while the device runs the epoch before it), ``rngs`` their
    keys, ``eids`` the epoch ids, ``scans`` which batches hold a SCAN (all,
    when None; read at each epoch after its batch is taken) and
    ``write_rounds`` the longest chain of the period (see
    :func:`_make_bucket_plane`).  Every epoch given is a real one: the
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
    plane = _make_bucket_plane(cfg, n)
    craq = cfg.replication_mode == "craq"
    spread = cfg.read_spread

    def period(store, directory, load_reg, sketch, repl, ovl, coord, metrics,
               qs, rngs, eids, *, scans=None, write_rounds=None):
        _check_store(store, n)
        outs = []
        a2a_rounds = 0
        # qs first: the caller's generator is resumed once past the last
        # epoch, so it can close that epoch's work
        for i, (q, rng, eid) in enumerate(zip(qs, rngs, eids)):
            rng = np.asarray(rng, np.uint32)
            r_ovl = prng.fold_in(rng, 0x0F10AD) if fold_ovl else rng
            r_route, r_plan = prng.split(rng)
            dirty, queue_pen = pre(repl, ovl)
            (store, _resp, directory, load_reg, decision, picked, bounced,
             ovf, rounds) = plane(
                 store, directory, q, load_reg, r_route, dirty, queue_pen,
                 scans=True if scans is None else scans[i],
                 write_rounds=write_rounds)
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
