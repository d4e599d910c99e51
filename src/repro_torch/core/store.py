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


def slab_scan(slab_keys: torch.Tensor, slab_vals: torch.Tensor,
              k0: torch.Tensor, k1: torch.Tensor, max_results: int):
    """Batched range scan of [k0, k1] (inclusive) on one slab, up to
    ``max_results`` each.  Returns (keys (B, S), values (B, S, V),
    count (B,))."""
    one = StoreState(slab_keys[None], slab_vals[None],
                     torch.zeros(1, dtype=torch.int64, device=slab_keys.device))
    return slab_scan_rows(one, torch.zeros_like(k0), k0, k1, max_results)


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
    is_get = q.opcode == K.OP_GET
    is_del = q.opcode == K.OP_DEL
    is_scan = (q.opcode == K.OP_SCAN) & (decision.target >= 0)
    r_max = decision.chain.shape[1]
    member_live = (torch.arange(r_max, device=dev)[None, :]
                   < decision.chain_len[:, None])

    # --- reads against the pre-batch state, from the owning shard ---
    # K4a probes (key, target): GETs are owned by their read target, DELs
    # by the chain head, which is their write target
    slot, hit = RM.slab_lookup(q.key, decision.target, store.keys)
    t_safe = torch.clamp(decision.target, 0, N - 1)
    found = hit & (is_get | is_del)
    get_hit = hit & is_get
    value = store.values[t_safe, slot.to(torch.int64)]
    value = torch.where(get_hit[:, None], value, 0.0)
    if scans:
        sk, sv, scount = slab_scan_rows(
            store, t_safe, torch.where(is_scan, q.key, EMPTY),
            torch.where(is_scan, q.end_key, 0), max_scan_results,
        )
        scount = torch.where(is_scan, scount, 0)
        sk = torch.where(is_scan[:, None], sk, EMPTY)
        sv = torch.where(is_scan[:, None, None], sv, 0.0)
    else:
        B, S = q.batch, max_scan_results
        scount = torch.zeros((), dtype=torch.int64, device=dev).expand(B)
        sk = torch.full((), EMPTY, dtype=torch.int64, device=dev).expand(B, S)
        sv = torch.zeros((), dtype=torch.float32, device=dev).expand(
            B, S, store.value_dim)

    # --- writes, shard by shard ---
    for n in range(N):
        write_mine = is_write & ((decision.chain == n) & member_live).any(dim=1)
        _apply_writes(store, n, q, write_mine)

    return store, Responses(value=value, found=found, scan_values=sv,
                            scan_keys=sk, scan_count=scount)


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
