"""Data-plane execution of controller migration decisions (counterpart of
``repro.core.migration``).  The movers update the store in place."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import keys as K
from repro_torch.core.store import StoreState, _compact_sorted, slab_delete, slab_put

EMPTY = K.EMPTY_KEY


@dataclasses.dataclass(frozen=True)
class MigrationOp:
    """Move/copy [lo, hi] from src to dst ('move', 'copy' or 'reclaim';
    a reclaim deletes [lo, hi] at src and ignores dst)."""

    lo: int
    hi: int
    src: int
    dst: int
    kind: str = "move"


def _extract_range(slab_keys: torch.Tensor, slab_vals: torch.Tensor, lo: int,
                   hi: int):
    in_range = (slab_keys >= lo) & (slab_keys <= hi) & (slab_keys != EMPTY)
    ex_keys = torch.where(in_range, slab_keys, EMPTY)
    return _compact_sorted(ex_keys, slab_vals, in_range)


def apply_migration(store: StoreState, lo: int, hi: int, src: int, dst: int, *,
                    move: bool) -> StoreState:
    """Copy (or move) the [lo, hi] entries of shard ``src`` into ``dst``."""
    ex_keys, ex_vals = _extract_range(store.keys[src], store.values[src], lo, hi)
    dst_keys, dst_vals, dropped = slab_put(store.keys[dst], store.values[dst],
                                           ex_keys, ex_vals)
    store.keys[dst].copy_(dst_keys)
    store.values[dst].copy_(dst_vals)
    store.overflow[dst] += dropped
    if move:
        src_keys, src_vals = slab_delete(store.keys[src], store.values[src],
                                         ex_keys)
        store.keys[src].copy_(src_keys)
        store.values[src].copy_(src_vals)
    return store


def apply_reclaim(store: StoreState, lo: int, hi: int, node: int) -> StoreState:
    """Delete [lo, hi] at ``node`` (chain-narrowing space reclamation)."""
    slab_keys = store.keys[node]
    in_range = (slab_keys >= lo) & (slab_keys <= hi) & (slab_keys != EMPTY)
    del_keys = torch.where(in_range, slab_keys, EMPTY)
    new_keys, new_vals = slab_delete(slab_keys, store.values[node], del_keys)
    store.keys[node].copy_(new_keys)
    store.values[node].copy_(new_vals)
    return store


def execute(store: StoreState, ops: list[MigrationOp]) -> StoreState:
    """Run a controller migration plan."""
    for op in ops:
        lo, hi = int(op.lo) & K.MASK32, int(op.hi) & K.MASK32
        if op.kind == "reclaim":
            store = apply_reclaim(store, lo, hi, int(op.src))
        else:
            store = apply_migration(store, lo, hi, int(op.src), int(op.dst),
                                    move=(op.kind == "move"))
    return store
