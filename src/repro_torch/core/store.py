"""The storage-node layer: sorted-slab shards (counterpart of
``repro.core.store``).

Each shard holds a fixed-capacity ascending key slab (``EMPTY_KEY``
padding at the tail; int64 carriers of uint32 keys) and a parallel
float32 value slab.  The slab primitives are the reference's
gather-only formulas (searchsorted rank merges, cumsum compaction) —
sync-free on the card, and bit-identical to the reference.

Batch semantics: GET/SCAN observe the pre-batch state; DELs apply next;
PUTs last (last write in batch order wins).  Capacity overflow drops the
largest keys and counts them per shard.

:func:`shard_apply` is the reference's one-shard apply; the sharded data
plane (:mod:`repro_torch.core.dist_store`) runs its halves on every shard
at once, :func:`shards_read` (each row's GET / DEL probes against its own
slab, one K4a launch for all rows) and :func:`shards_write`.

Two deliberate departures from the reference's program shape, neither
visible in the results:

* :func:`apply_routed` updates the store **in place** (the JAX driver
  donated these buffers) and walks the N shards one at a time instead of
  vmapping them: the vmapped form materialises ``(N, B, V)`` masked
  values, 8 GB for a 1M-record preload at V=256.
* Reads are answered once, from the owning shard, instead of per shard
  and then combined by a one-hot ``einsum``: the GET/DEL probe is the
  slab_lookup kernel (K4a) on ``(key, target)``.  A gather from the
  owning shard gives the einsum's bits for every finite value (the
  einsum adds ``x * 1`` to zeros, which only differs for -0.0).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import keys as K
from repro_torch.core.routing import QueryBatch, RoutingDecision
from repro_torch.kernels.range_match import ops as RM
from repro_torch.kernels.range_match import ref as RMR

EMPTY = K.EMPTY_KEY


@dataclasses.dataclass(frozen=True)
class StoreState:
    """keys (N, C) int64 ascending per shard, EMPTY-padded; values
    (N, C, V) float32; overflow (N,) int64 cumulative dropped entries."""

    keys: torch.Tensor
    values: torch.Tensor
    overflow: torch.Tensor

    @property
    def num_shards(self) -> int:
        return self.keys.shape[0]

    @property
    def capacity(self) -> int:
        return self.keys.shape[1]

    @property
    def value_dim(self) -> int:
        return self.values.shape[2]


@dataclasses.dataclass(frozen=True)
class Responses:
    """value (B, V); found (B,) bool; scan_values (B, S, V); scan_keys
    (B, S) int64 (EMPTY beyond count); scan_count (B,) int64."""

    value: torch.Tensor
    found: torch.Tensor
    scan_values: torch.Tensor
    scan_keys: torch.Tensor
    scan_count: torch.Tensor


def make_store(num_shards: int, capacity: int, value_dim: int, *,
               device=None) -> StoreState:
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    return StoreState(
        keys=torch.full((num_shards, capacity), EMPTY, dtype=torch.int64,
                        device=dev),
        values=torch.zeros((num_shards, capacity, value_dim),
                           dtype=torch.float32, device=dev),
        overflow=torch.zeros(num_shards, dtype=torch.int64, device=dev),
    )


# ---------------------------------------------------------------------------
# per-shard slab primitives (one (C,) / (C, V) slab)
# ---------------------------------------------------------------------------


def _compact_sorted(keys: torch.Tensor, vals: torch.Tensor, live: torch.Tensor):
    """Gather the ``live`` entries (a sorted subsequence) to a sorted
    prefix; EMPTY keys / zero values beyond."""
    n = keys.shape[0]
    cum = torch.cumsum(live.to(torch.int64), 0)
    d = torch.arange(n, dtype=torch.int64, device=keys.device)
    src = torch.clamp(torch.searchsorted(cum, d + 1, side="left"), max=n - 1)
    in_live = d < cum[-1]
    out_k = torch.where(in_live, keys[src], EMPTY)
    out_v = vals[src]
    out_v.masked_fill_(~in_live[:, None], 0.0)
    return out_k, out_v


def _dedupe_last_write(qkeys: torch.Tensor, qvals: torch.Tensor):
    """Sort a PUT batch by key, last write in batch order winning.

    The reference's ``lexsort((-index, key))``: a stable sort of the
    reversed batch orders equal keys by descending original index."""
    B = qkeys.shape[0]
    rev = torch.flip(torch.arange(B, device=qkeys.device), (0,))
    sk, order = torch.sort(qkeys[rev], stable=True)
    perm = rev[order]
    sv = qvals[perm]
    first = torch.ones(B, dtype=torch.bool, device=qkeys.device)
    if B > 1:
        first[1:] = sk[1:] != sk[:-1]
    sk = torch.where(first, sk, EMPTY)
    return _compact_sorted(sk, sv, sk != EMPTY)


def _member_sorted(sorted_keys: torch.Tensor, probe: torch.Tensor) -> torch.Tensor:
    """probe ∈ sorted_keys (EMPTY never matches)."""
    pos = torch.searchsorted(sorted_keys, probe)
    pos = torch.clamp(pos, max=sorted_keys.shape[0] - 1)
    return (sorted_keys[pos] == probe) & (probe != EMPTY)


def slab_get(slab_keys: torch.Tensor, slab_vals: torch.Tensor,
             qkeys: torch.Tensor):
    """Batched point lookup. Returns (values (B, V), found (B,))."""
    pos = torch.searchsorted(slab_keys, qkeys)
    pos = torch.clamp(pos, max=slab_keys.shape[0] - 1)
    found = (slab_keys[pos] == qkeys) & (qkeys != EMPTY)
    vals = torch.where(found[:, None], slab_vals[pos], 0.0)
    return vals, found


def pad_slab(slab_keys: torch.Tensor, slab_vals: torch.Tensor,
             max_results: int):
    """Append ``max_results`` EMPTY / zero entries, so that every scan's
    window of ``max_results`` entries from its start stays in bounds (one
    pad covers the whole scan batch of :func:`_slab_scan_padded`)."""
    dev = slab_keys.device
    pad_k = torch.cat([slab_keys, torch.full((max_results,), EMPTY,
                                             dtype=slab_keys.dtype,
                                             device=dev)])
    pad_v = torch.cat([slab_vals, torch.zeros(
        (max_results, slab_vals.shape[1]), dtype=slab_vals.dtype,
        device=dev)])
    return pad_k, pad_v


def _slab_scan_padded(pad_k: torch.Tensor, pad_v: torch.Tensor,
                      k0: torch.Tensor, k1: torch.Tensor, max_results: int):
    """Scan core over a pre-padded slab (:func:`pad_slab`): each query's
    window starts at its ``k0`` rank and keeps ``count`` live entries."""
    C = pad_k.shape[0] - max_results
    live_keys = pad_k[:C]
    lo = torch.searchsorted(live_keys, k0)
    hi = torch.searchsorted(live_keys, k1, side="right")
    count = torch.clamp(hi - lo, max=max_results)
    j = torch.arange(max_results, device=pad_k.device)
    idx = lo[:, None] + j[None, :]
    live = j[None, :] < count[:, None]
    ks = torch.where(live, pad_k[idx], EMPTY)
    vs = torch.where(live[:, :, None], pad_v[idx], 0.0)
    return ks, vs, count


def slab_scan(slab_keys: torch.Tensor, slab_vals: torch.Tensor,
              k0: torch.Tensor, k1: torch.Tensor, max_results: int):
    """Batched range scan of [k0, k1] (inclusive) on one slab, up to
    ``max_results`` each.  Returns (keys (B, S), values (B, S, V),
    count (B,))."""
    pad_k, pad_v = pad_slab(slab_keys, slab_vals, max_results)
    return _slab_scan_padded(pad_k, pad_v, k0, k1, max_results)


def slab_delete(slab_keys: torch.Tensor, slab_vals: torch.Tensor,
                del_keys: torch.Tensor):
    """Delete a key set (EMPTY entries ignored); survivors compact."""
    sorted_del, _ = torch.sort(del_keys)
    hit = _member_sorted(sorted_del, slab_keys)
    new_keys = torch.where(hit, EMPTY, slab_keys)
    return _compact_sorted(new_keys, slab_vals, new_keys != EMPTY)


def _merge_sorted_runs(ak, av, bk, bv, out_len: int):
    """Stable merge of two sorted runs, truncated to ``out_len``.

    Every b element's merged position is ``searchsorted(a, b, right) +
    rank``; destination ``d`` binary-searches those positions to learn
    how many b elements precede it and whether it is one itself."""
    B = bk.shape[0]
    C = ak.shape[0]
    dev = ak.device
    idx_b = torch.searchsorted(ak, bk, side="right") + torch.arange(B, device=dev)
    d = torch.arange(out_len, dtype=torch.int64, device=dev)
    cb = torch.searchsorted(idx_b, d, side="left")
    cb_c = torch.clamp(cb, max=B - 1)
    from_b = idx_b[cb_c] == d
    ai = torch.clamp(d - cb, 0, C - 1)
    out_k = torch.where(from_b, bk[cb_c], ak[ai])
    # values: gather run a, then overwrite the b destinations (distinct
    # positions; the ones past out_len land in a scratch tail)
    out_v = torch.empty((out_len + B, av.shape[1]), dtype=av.dtype, device=dev)
    torch.index_select(av, 0, ai, out=out_v[:out_len])
    out_v[idx_b] = bv
    return out_k, out_v[:out_len]


def slab_put(slab_keys: torch.Tensor, slab_vals: torch.Tensor,
             put_keys: torch.Tensor, put_vals: torch.Tensor):
    """Insert/overwrite a batch. Returns (keys, vals, dropped_count)."""
    C = slab_keys.shape[0]
    pk, pv = _dedupe_last_write(put_keys, put_vals)
    overwritten = _member_sorted(pk, slab_keys)
    live = ~overwritten & (slab_keys != EMPTY)
    ak, av = _compact_sorted(slab_keys, slab_vals, live)
    out_keys, out_vals = _merge_sorted_runs(ak, av, pk, pv, C)
    n_live = live.sum() + (pk != EMPTY).sum()
    dropped = torch.clamp(n_live - C, min=0)
    return out_keys, out_vals, dropped


# ---------------------------------------------------------------------------
# batch application
# ---------------------------------------------------------------------------


def _apply_writes(store: StoreState, n: int, q: QueryBatch,
                  write_mine: torch.Tensor) -> None:
    """DELs then PUTs of the batch slice shard ``n`` holds, in place."""
    is_del = (q.opcode == K.OP_DEL) & write_mine
    is_put = (q.opcode == K.OP_PUT) & write_mine
    keys, vals = slab_delete(store.keys[n], store.values[n],
                             torch.where(is_del, q.key, EMPTY))
    keys, vals, dropped = slab_put(
        keys, vals, torch.where(is_put, q.key, EMPTY),
        torch.where(is_put[:, None], q.value, 0.0),
    )
    store.keys[n].copy_(keys)
    store.values[n].copy_(vals)
    store.overflow[n] += dropped


def apply_routed(store: StoreState, q: QueryBatch, decision: RoutingDecision,
                 *, max_scan_results: int = 8,
                 scans: bool = True) -> tuple[StoreState, Responses]:
    """Apply a routed batch: reads served by the routed target, writes by
    every live chain member.  Updates ``store`` in place and returns it
    with the per-query responses.

    ``scans=False`` is the caller's host-side knowledge that the batch
    holds no SCAN: the scan gather is skipped (it costs a node-offset
    copy of every slab key) and the scan responses are the empty answer
    it would have given, as zero-stride views."""
    N = store.num_shards
    dev = store.keys.device
    is_write = (q.opcode == K.OP_PUT) | (q.opcode == K.OP_DEL)
    r_max = decision.chain.shape[1]
    member_live = (torch.arange(r_max, device=dev)[None, :]
                   < decision.chain_len[:, None])

    # --- reads against the pre-batch state, from the owning shard ---
    # K4a probes (key, target): GETs are owned by their read target, DELs
    # by the chain head, which is their write target
    every = torch.ones_like(is_write)
    resp = serve_reads(store, decision.target, q, every, every,
                       max_scan_results=max_scan_results, scans=scans)

    # --- writes, shard by shard ---
    for n in range(N):
        write_mine = is_write & ((decision.chain == n) & member_live).any(dim=1)
        _apply_writes(store, n, q, write_mine)

    return store, resp


def shard_apply(slab_keys: torch.Tensor, slab_vals: torch.Tensor,
                q: QueryBatch, read_mine: torch.Tensor,
                write_mine: torch.Tensor, *, max_scan_results: int):
    """Apply the batch slice one shard owns (the reference's signature):
    ``read_mine`` marks the GET / SCAN it serves (it is the chain tail),
    ``write_mine`` the PUT / DEL it applies (it is a chain member).
    Returns ``(keys', vals', dropped, responses)``; the slab arguments
    are not modified."""
    one = StoreState(slab_keys[None].clone(), slab_vals[None].clone(),
                     torch.zeros(1, dtype=torch.int64, device=slab_keys.device))
    rows = QueryBatch(*(x[None] for x in (q.opcode, q.key, q.end_key,
                                          q.value)))
    resp = shards_read(one, rows, read_mine[None],
                       max_scan_results=max_scan_results,
                       del_mine=write_mine[None])
    resp = Responses(*(x[0] for x in (resp.value, resp.found,
                                      resp.scan_values, resp.scan_keys,
                                      resp.scan_count)))
    shards_write(one, rows, write_mine[None])
    return one.keys[0], one.values[0], one.overflow[0], resp


def serve_reads(store: StoreState, node: torch.Tensor, q: QueryBatch,
                read_mine: torch.Tensor | None,
                del_mine: torch.Tensor | None, *, max_scan_results: int,
                scans: bool = True) -> Responses:
    """The read half of :func:`shard_apply` for queries each against its
    own shard ``node`` (a negative node serves nothing): ``read_mine``
    marks the GETs / SCANs served (None: none), ``del_mine`` the DELs
    whose hit is reported (None: none), both against the pre-batch slabs.
    The GET / DEL probes are ONE launch of K4a (``slab_lookup``).
    ``scans=False`` is the caller's knowledge that the batch holds no
    SCAN; the answers a call cannot give (no reads, no SCAN) are the empty
    ones, as zero-stride views."""
    B = q.batch
    N = store.num_shards
    dev = store.keys.device
    S, V = max_scan_results, store.value_dim
    none = torch.zeros_like(q.opcode, dtype=torch.bool)
    is_get = none if read_mine is None else (q.opcode == K.OP_GET) & read_mine
    is_del = none if del_mine is None else (q.opcode == K.OP_DEL) & del_mine
    slot, hit = RM.slab_lookup(torch.where(is_get | is_del, q.key, EMPTY),
                               node, store.keys)
    found = hit & (is_get | is_del)
    n_safe = torch.clamp(node, 0, N - 1)
    if read_mine is not None:
        value = store.values[n_safe, slot.to(torch.int64)]
        value = torch.where((hit & is_get)[:, None], value, 0.0)
    else:
        value = torch.zeros((), dtype=torch.float32, device=dev).expand(B, V)
    if scans and read_mine is not None:
        is_scan = (q.opcode == K.OP_SCAN) & read_mine & (node >= 0)
        sk, sv, scount = slab_scan_rows(
            store, n_safe, torch.where(is_scan, q.key, EMPTY),
            torch.where(is_scan, q.end_key, 0), S)
        scount = torch.where(is_scan, scount, 0)
        sk = torch.where(is_scan[:, None], sk, EMPTY)
        sv = torch.where(is_scan[:, None, None], sv, 0.0)
    else:
        scount = torch.zeros((), dtype=torch.int64, device=dev).expand(B)
        sk = torch.full((), EMPTY, dtype=torch.int64, device=dev).expand(B, S)
        sv = torch.zeros((), dtype=torch.float32, device=dev).expand(B, S, V)
    return Responses(value=value, found=found, scan_values=sv, scan_keys=sk,
                     scan_count=scount)


def shards_read(store: StoreState, q: QueryBatch,
                read_mine: torch.Tensor | None, *, max_scan_results: int,
                scans: bool = True,
                del_mine: torch.Tensor | None = None) -> Responses:
    """:func:`serve_reads` on every shard at once: row ``n`` of the
    ``(N, M)`` query fields is the batch shard ``n`` received (one K4a
    launch for all of them).  Responses are ``(N, M, ...)``."""
    N, M = q.opcode.shape
    node = torch.arange(N, device=q.key.device)[:, None].expand(N, M)
    flat = QueryBatch(*(x.reshape((N * M,) + tuple(x.shape[2:]))
                        for x in (q.opcode, q.key, q.end_key, q.value)))
    rows = lambda x: None if x is None else x.reshape(-1)
    got = serve_reads(store, node.reshape(-1), flat, rows(read_mine),
                      rows(del_mine), max_scan_results=max_scan_results,
                      scans=scans)
    return Responses(*(x.reshape((N, M) + tuple(x.shape[1:])) for x in (
        got.value, got.found, got.scan_values, got.scan_keys,
        got.scan_count)))


def shards_write(store: StoreState, q: QueryBatch,
                 write_mine: torch.Tensor) -> None:
    """The write half of :func:`shard_apply` on every shard, in place: the
    DELs then the PUTs of row ``n`` on shard ``n``'s slab, the entries a
    full slab drops added to its ``overflow``."""
    for n in range(store.num_shards):
        row = QueryBatch(q.opcode[n], q.key[n], q.end_key[n], q.value[n])
        _apply_writes(store, n, row, write_mine[n])


def slab_scan_rows(store: StoreState, node: torch.Tensor, k0: torch.Tensor,
                   k1: torch.Tensor, max_results: int):
    """:func:`slab_scan` with each query against its own shard ``node``."""
    C = store.capacity
    flat_k = store.keys.reshape(-1)
    base = node * C
    # one searchsorted over the shard-offset concatenation of all slabs
    seq = RMR.offset_rows(store.keys)
    lo = RMR.row_searchsorted(seq, C, node, k0)
    hi = RMR.row_searchsorted(seq, C, node, k1, side="right")
    count = torch.clamp(hi - lo, max=max_results)
    j = torch.arange(max_results, device=node.device)
    idx = lo[:, None] + j[None, :]
    live = (j[None, :] < count[:, None]) & (idx < C)
    safe = base[:, None] + torch.clamp(idx, 0, C - 1)
    ks = torch.where(live, flat_k[safe], EMPTY)
    vs = torch.where(live[:, :, None],
                     store.values.reshape(-1, store.value_dim)[safe], 0.0)
    return ks, vs, count


def store_fill(store: StoreState) -> torch.Tensor:
    """(N,) live entries per shard."""
    return (store.keys != EMPTY).sum(dim=1)
