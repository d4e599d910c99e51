"""Device-resident state of the switch-replicated directory tier
(counterpart of ``repro.coordination_tier.state``).

Each switch of the tier holds its own copy of the slot tables plus a
per-slot version register; control writes are committed by the host
controller and propagate along the switch chain with a lag per chain
position, so after a reconfiguration some switches serve stale tables for
a bounded window.  A query entering a lagging switch follows the old table
to the old server, the version check there detects the mismatch, and a
versioned redirect re-routes it: one extra priced hop.  The tier is an
accounting plane: the query's true routing decision, every store effect,
counter and PRNG draw are untouched; with the tier off, or with zero lag,
the metric stream equals the tier-less driver's bit for bit.

:class:`CoordState` leaves (``W`` switches, ``S`` slots):

``slot_lo / slot_hi / live / chains / chain_len``
    ``(W, S, ...)``: switch ``w``'s copy of the slot tables.
``version``
    ``(W, S)``: the table version switch ``w`` believes slot ``s`` is at.
``committed``
    ``(S,)``: the quorum-committed version of each slot.
``pend_* / install_at``
    the staged next table and the epoch at which each switch installs it
    (``INSTALL_NEVER`` = nothing staged).

Spans and versions are uint32 values carried in int64 tensors; chains,
lengths and install epochs are int64, ``live`` bool.  The per-switch match
of :func:`observe_epoch` is K5 (``kernels.range_match.range_match_stale``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import keys as K
from repro_torch.device import resolve_device
from repro_torch.kernels.range_match import ops as RM

# install_at sentinel: no staged table for this switch
INSTALL_NEVER = 2**31 - 1

# cstats layout (per-epoch coordination counters, all exact):
#   routed      queries routed this epoch (== batch size)
#   direct      served off a row matching the committed version
#   redirected  versioned redirect taken (extra hop priced in the DES)
#   mis_served  served off a divergent wrong-owner row with NO redirect
#               (only the no-quorum baseline can produce these)
#   stale_sw    switches holding >= 1 divergent slot this epoch
CSTAT_FIELDS = ("routed", "direct", "redirected", "mis_served", "stale_switches")


@dataclasses.dataclass(frozen=True)
class CoordConfig:
    """Knobs of the replicated directory tier (the reference's fields and
    defaults): ``n_switches=None`` derives the width from the pod
    structure; ``lag_per_hop`` epochs of install delay per chain position
    (0 reproduces the tier-less stream); ``quorum=True`` redirects
    divergent rows, ``False`` trusts the ingress table;
    ``staleness_bound=None`` derives ``(W-1) * lag_per_hop * drift_mult``.
    """

    n_switches: int | None = 4
    lag_per_hop: int = 1
    quorum: bool = True
    staleness_bound: int | None = None
    lease_epochs: int = 4
    failover_after: int = 2
    drift_mult: int = 4


@dataclasses.dataclass(frozen=True)
class CoordState:
    slot_lo: torch.Tensor       # (W, S) int64 uint32 values
    slot_hi: torch.Tensor       # (W, S) int64 uint32 values
    live: torch.Tensor          # (W, S) bool
    chains: torch.Tensor        # (W, S, r_max) int64
    chain_len: torch.Tensor     # (W, S) int64
    version: torch.Tensor       # (W, S) int64 uint32 values
    committed: torch.Tensor     # (S,) int64 uint32 values
    pend_lo: torch.Tensor       # (S,) int64 uint32 values
    pend_hi: torch.Tensor       # (S,) int64 uint32 values
    pend_live: torch.Tensor     # (S,) bool
    pend_chains: torch.Tensor   # (S, r_max) int64
    pend_clen: torch.Tensor     # (S,) int64
    pend_version: torch.Tensor  # (S,) int64 uint32 values
    install_at: torch.Tensor    # (W,) int64; INSTALL_NEVER = nothing staged

    @property
    def n_switches(self) -> int:
        return self.slot_lo.shape[0]

    @property
    def n_slots(self) -> int:
        return self.slot_lo.shape[1]

    @property
    def device(self) -> torch.device:
        return self.slot_lo.device


def host_tensor(a, device) -> torch.Tensor:
    """A fresh tensor on ``device`` from a numpy array (int64 unless bool).
    ``torch.tensor`` copies: on the CPU a tensor must not share memory with
    the manager's host arrays, which it goes on editing in place."""
    a = np.asarray(a)
    if a.dtype != np.bool_:
        a = a.astype(np.int64)
    return torch.tensor(a, device=device)


def make_state(tables: dict, n_switches: int, *, device=None) -> CoordState:
    """Fresh tier state: every switch holds ``tables`` (a
    ``Controller.table_snapshot()``) at version 0.  Every leaf is a fresh
    tensor: nothing aliases the live directory or another leaf."""
    dev = resolve_device(device)
    w = int(n_switches)
    lo, hi = tables["slot_lo"], tables["slot_hi"]
    lv, ch, cl = tables["live"], tables["chains"], tables["chain_len"]
    s = np.asarray(lo).shape[0]

    def tile(a):
        a = np.asarray(a)
        return host_tensor(np.tile(a[None], (w,) + (1,) * a.ndim), dev)

    z = lambda *shape: torch.zeros(shape, dtype=torch.int64, device=dev)
    return CoordState(
        slot_lo=tile(lo), slot_hi=tile(hi), live=tile(np.asarray(lv, bool)),
        chains=tile(ch), chain_len=tile(cl),
        version=z(w, s), committed=z(s),
        pend_lo=host_tensor(lo, dev), pend_hi=host_tensor(hi, dev),
        pend_live=host_tensor(np.asarray(lv, bool), dev),
        pend_chains=host_tensor(ch, dev), pend_clen=host_tensor(cl, dev),
        pend_version=z(s),
        install_at=torch.full((w,), INSTALL_NEVER, dtype=torch.int64,
                              device=dev),
    )


def install_pending(state: CoordState, eid: int) -> CoordState:
    """Switches whose install epoch has arrived adopt the staged table, so
    "install at epoch ``e``" means every query of epoch ``e`` sees it."""
    inst = int(eid) >= state.install_at                    # (W,)

    def mix(tbl, pend):
        m = inst.reshape((-1,) + (1,) * (tbl.dim() - 1))
        return torch.where(m, pend[None].expand_as(tbl), tbl)

    return dataclasses.replace(
        state,
        slot_lo=mix(state.slot_lo, state.pend_lo),
        slot_hi=mix(state.slot_hi, state.pend_hi),
        live=mix(state.live, state.pend_live),
        chains=mix(state.chains, state.pend_chains),
        chain_len=mix(state.chain_len, state.pend_clen),
        version=mix(state.version, state.pend_version),
        install_at=torch.where(inst, INSTALL_NEVER, state.install_at),
    )


def ingress_switch(keys: torch.Tensor, n_switches: int) -> torch.Tensor:
    """Which switch a query enters the fabric through: the golden hash of
    its key modulo ``W`` (no PRNG consumed)."""
    return K.hash_key(keys) % int(n_switches)


def stale_lookup(state: CoordState, sw: torch.Tensor,
                 mvals: torch.Tensor) -> torch.Tensor:
    """``directory.lookup_range`` against each query's own switch's copy
    (the reference's formula over per-query gathered rows; K5 computes the
    same on the main path without the (B, S) gather)."""
    lo = state.slot_lo[sw]
    hi = state.slot_hi[sw]
    lv = state.live[sw]
    v = K.u32(mvals.to(torch.int64))[:, None]
    hit = lv & (v >= lo) & (v <= hi)
    s = lo.shape[1]
    iota = torch.arange(s, dtype=torch.int64, device=lo.device)
    ridx = torch.where(hit, iota[None, :], s).amin(dim=1)
    return torch.clamp(ridx, max=s - 1)


def _chain_server(rows: torch.Tensor, clen: torch.Tensor,
                  is_write: torch.Tensor) -> torch.Tensor:
    """Deterministic serving node under a table: the chain head for
    writes, the tail for reads (where the version check happens)."""
    last = torch.clamp(clen.to(torch.int64) - 1, min=0)[:, None]
    tail = torch.gather(rows, 1, last)[:, 0]
    return torch.where(is_write, rows[:, 0], tail).to(torch.int64)


def observe_epoch(state: CoordState, q, decision, eid: int, *, quorum: bool,
                  hash_partitioned: bool = False):
    """One epoch of the tier: install staged tables, route each query
    through its ingress switch's (possibly stale) copy on K5, and resolve
    divergence.

    Returns ``(state', redirect (B,) bool, redirect_via (B,) int64, cstats
    (5,) int64)`` (see ``CSTAT_FIELDS``); ``routed == direct +
    redirected`` by construction.  ``mis_served`` counts queries whose
    stale server differs from the true one and that were not redirected:
    zero under the quorum arm, since a changed row carries a new version.
    """
    state = install_pending(state, eid)
    is_write = (q.opcode == K.OP_PUT) | (q.opcode == K.OP_DEL)
    _, via_stale, divergent = RM.range_match_stale(
        state, q.key, q.opcode, hash_partitioned=hash_partitioned)
    via_stale = via_stale.to(torch.int64)
    via_true = _chain_server(decision.chain, decision.chain_len, is_write)
    redirect = divergent if quorum else torch.zeros_like(divergent)
    mis = (via_stale != via_true) & ~redirect
    redirect_via = torch.where(via_stale >= 0, via_stale, via_true)
    routed = q.key.shape[0]
    n_red = redirect.sum()
    stale_sw = (state.version != state.committed[None, :]).any(dim=1).sum()
    cstats = torch.stack([torch.full_like(n_red, routed), routed - n_red, n_red,
                          mis.sum(), stale_sw])
    return state, redirect, redirect_via, cstats


def empty_cstats(device=None) -> torch.Tensor:
    """Counter vector of a disabled tier."""
    return torch.zeros(len(CSTAT_FIELDS), dtype=torch.int64,
                       device=resolve_device(device))
