"""Data-plane execution of controller migration decisions (counterpart of
``repro.core.migration``).  The movers update the store in place.

On a store split over parts (:class:`~repro_torch.core.store.StoreParts`)
a range moves across devices: it is extracted on the source's device,
copied to the destination's, put there, and deleted at the source, the
same slab operations on the same rows as on the stacked store."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import keys as K
from repro_torch.core.store import (StoreParts, StoreState, _compact_sorted,
                                   slab_delete, slab_put)

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


def apply_migration(store: StoreState | StoreParts, lo: int, hi: int, src: int,
                    dst: int, *, move: bool) -> StoreState | StoreParts:
    """Copy (or move) the [lo, hi] entries of shard ``src`` into ``dst``."""
    sp, s = store.locate(src)
    dp, d = store.locate(dst)
    ex_keys, ex_vals = _extract_range(sp.keys[s], sp.values[s], lo, hi)
    dev = dp.keys.device
    dst_keys, dst_vals, dropped = slab_put(
        dp.keys[d], dp.values[d], ex_keys.to(dev, non_blocking=True),
        ex_vals.to(dev, non_blocking=True))
    dp.keys[d].copy_(dst_keys)
    dp.values[d].copy_(dst_vals)
    dp.overflow[d] += dropped
    if move:
        src_keys, src_vals = slab_delete(sp.keys[s], sp.values[s], ex_keys)
        sp.keys[s].copy_(src_keys)
        sp.values[s].copy_(src_vals)
    return store


def apply_reclaim(store: StoreState | StoreParts, lo: int, hi: int,
                  node: int) -> StoreState | StoreParts:
    """Delete [lo, hi] at ``node`` (chain-narrowing space reclamation)."""
    part, n = store.locate(node)
    slab_keys = part.keys[n]
    in_range = (slab_keys >= lo) & (slab_keys <= hi) & (slab_keys != EMPTY)
    del_keys = torch.where(in_range, slab_keys, EMPTY)
    new_keys, new_vals = slab_delete(slab_keys, part.values[n], del_keys)
    part.keys[n].copy_(new_keys)
    part.values[n].copy_(new_vals)
    return store


def execute(store: StoreState | StoreParts,
            ops: list[MigrationOp]) -> StoreState | StoreParts:
    """Run a controller migration plan."""
    for op in ops:
        lo, hi = int(op.lo) & K.MASK32, int(op.hi) & K.MASK32
        if op.kind == "reclaim":
            store = apply_reclaim(store, lo, hi, int(op.src))
        else:
            store = apply_migration(store, lo, hi, int(op.src), int(op.dst),
                                    move=(op.kind == "move"))
    return store
