"""Directory-level wrappers for the range_match kernels (counterpart of
``repro.kernels.range_match.ops``).

``pack_tables`` turns a :class:`~repro_torch.core.directory.Directory`
into the kernels' table layout: the live mask baked into the spans (dead
slots get the inert ``lo = MAX_KEY > hi = 0`` sentinel) as uint32 bits
in int32 tensors, chains transposed to ``(r_max, S)``; ``pack_coord_tables``
does the same for the W switch copies of the coordination tier.  No lane
padding: the CUDA kernels index the tables directly.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import keys as K
from repro_torch.kernels.range_match import kernel

INT32_MAX = (1 << 31) - 1


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> int32 tensor with the same low 32
    bits (the kernels read them back as uint32)."""
    x = x.to(torch.int64) & K.MASK32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def pack_tables(directory):
    """Directory -> ``(slot_lo, slot_hi, chains, chain_len)`` kernel tables."""
    lo = torch.where(directory.live, directory.slot_lo, K.MAX_KEY)
    hi = torch.where(directory.live, directory.slot_hi, 0)
    return (
        to_i32_bits(lo),
        to_i32_bits(hi),
        directory.chains.T.to(torch.int32).contiguous(),
        directory.chain_len.to(torch.int32),
    )


def range_match(directory, keys: torch.Tensor, opcodes: torch.Tensor):
    """Route a packet batch through K1: ``(ridx, target, chain (r_max, B))``
    int32 — ``core.routing.route`` without the counter bumps."""
    lo, hi, chains, clen = pack_tables(directory)
    mvals = K.matching_value(keys, hash_partitioned=directory.hash_partitioned)
    return kernel.range_match(
        mvals.contiguous(), opcodes.to(torch.int32).contiguous(), lo, hi,
        chains, clen, num_slots=directory.num_slots,
    )


def p2c_draws(rng: np.ndarray, B: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's one ``randint(rng, (B, 2), 0, INT32_MAX)`` p2c draw
    (``routing._p2c_pick``), split into the two int32 columns."""
    u = prng.randint(rng, (B, 2), 0, INT32_MAX, device)
    return u[:, 0].contiguous(), u[:, 1].contiguous()


def range_match_spread(directory, keys: torch.Tensor, opcodes: torch.Tensor,
                       load_reg: torch.Tensor, rng: np.ndarray, *,
                       queue_pen: torch.Tensor | None = None):
    """Route through K2 (p2c read spreading): ``core.routing.
    route_load_aware`` without the counter and load-register bumps, given
    the same ``rng``.  ``queue_pen`` ((N,) uint32 values in int64, optional)
    is added to the load registers for the p2c comparison (the kernels
    never bump loads, so this is ``route_load_aware(queue_pen=)``'s
    effective load)."""
    return kernel.range_match_spread(
        *_spread_inputs(directory, keys, opcodes, load_reg, rng, queue_pen),
        num_slots=directory.num_slots,
    )


def pack_dirty(dirty: torch.Tensor) -> torch.Tensor:
    """(S, r_max) bool dirty table -> the kernels' (r_max, S) uint8
    layout, transposed like the chains."""
    return dirty.T.to(torch.uint8).contiguous()


def _spread_inputs(directory, keys, opcodes, load_reg, rng, queue_pen=None):
    """The packet vectors and tables K2, K3 and K4b share: ``(mvals,
    opcodes, u1, u2, lo, hi, chains, clen, loads)``; ``queue_pen`` is
    folded into the loads as a uint32 sum (it wraps past 2**32)."""
    u1, u2 = p2c_draws(rng, keys.shape[0], keys.device)
    lo, hi, chains, clen = pack_tables(directory)
    mvals = K.matching_value(keys, hash_partitioned=directory.hash_partitioned)
    if queue_pen is not None:
        load_reg = K.u32(load_reg + queue_pen.to(torch.int64))
    return (mvals.contiguous(), opcodes.to(torch.int32).contiguous(), u1, u2,
            lo, hi, chains, clen, to_i32_bits(load_reg))


def range_match_spread_dirty(directory, keys: torch.Tensor,
                             opcodes: torch.Tensor, load_reg: torch.Tensor,
                             dirty: torch.Tensor, rng: np.ndarray, *,
                             queue_pen: torch.Tensor | None = None,
                             key_filter: torch.Tensor | None = None):
    """Route through K3 (CRAQ reads): ``core.routing.
    route_load_aware_dirty`` without the counter and load-register bumps,
    given the same ``rng``, the (S, r_max) bool ``dirty`` table and
    optionally the (S, F) bool ``key_filter``; ``queue_pen`` as in
    :func:`range_match_spread`.  Returns ``(ridx, target, chain, picked,
    bounced)``."""
    return kernel.range_match_spread_dirty(
        *_spread_inputs(directory, keys, opcodes, load_reg, rng, queue_pen),
        pack_dirty(dirty),
        None if key_filter is None else keys.contiguous(),
        None if key_filter is None else key_filter.contiguous(),
        num_slots=directory.num_slots,
    )


def range_match_apply(directory, keys: torch.Tensor, opcodes: torch.Tensor,
                      load_reg: torch.Tensor, dirty: torch.Tensor,
                      store_keys: torch.Tensor, rng: np.ndarray):
    """Route and probe through K4b: :func:`range_match_spread_dirty`
    followed by the slab-slot lookup of each key in its serving node's
    row of the (N, C) ``store_keys`` table, in one kernel.  Returns
    ``(ridx, target, chain, picked, bounced, slot, found)``."""
    return kernel.range_match_apply(
        *_spread_inputs(directory, keys, opcodes, load_reg, rng),
        pack_dirty(dirty), keys.contiguous(), store_keys.contiguous(),
        num_slots=directory.num_slots,
    )


def pack_coord_tables(coord):
    """A ``coordination_tier.CoordState`` (duck-typed) -> K5's tables
    ``(lo_w, hi_w, chains_w, clen_w, version_w, committed)``: each switch's
    live mask baked into its spans (dead slots get the ``lo = MAX_KEY >
    hi = 0`` sentinel), chains switch-major ``(W * r_max, S)``, the uint32
    spans and versions as int32 bits (only equality is tested on the
    versions).  No lane padding."""
    W, S = coord.slot_lo.shape
    r_max = coord.chains.shape[2]
    lo = torch.where(coord.live, coord.slot_lo, K.MAX_KEY)
    hi = torch.where(coord.live, coord.slot_hi, 0)
    return (
        to_i32_bits(lo),
        to_i32_bits(hi),
        coord.chains.transpose(1, 2).reshape(W * r_max, S).to(torch.int32)
        .contiguous(),
        coord.chain_len.to(torch.int32).contiguous(),
        to_i32_bits(coord.version),
        to_i32_bits(coord.committed),
    )


def range_match_stale(coord, keys: torch.Tensor, opcodes: torch.Tensor, *,
                      hash_partitioned: bool = False):
    """Route each packet through its ingress switch's (possibly stale)
    table copy with K5: ``(sridx, server, divergent)`` — the lookup,
    serving-node rule and divergence bit of ``coordination_tier.
    observe_epoch``."""
    return kernel.range_match_stale(
        keys.to(torch.int64).contiguous(), opcodes.to(torch.int32).contiguous(),
        *pack_coord_tables(coord), num_slots=coord.slot_lo.shape[1],
        hash_partitioned=hash_partitioned,
    )


def slab_lookup(qkeys: torch.Tensor, target: torch.Tensor,
                store_keys: torch.Tensor):
    """Probe each key in its serving node's sorted slab through K4a:
    ``(slot, found)`` — ``store.slab_get``'s searchsorted-left position
    (clamped into ``[0, C)``) and its hit mask."""
    return kernel.slab_lookup(
        qkeys.to(torch.int64).contiguous(), target.to(torch.int64).contiguous(),
        store_keys.contiguous(),
    )
