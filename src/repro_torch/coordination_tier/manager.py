"""Host-side control plane of the replicated directory tier (counterpart
of ``repro.coordination_tier.manager``).

:class:`CoordManager` is the switch-chain controller: it diffs successive
host snapshots of the slot tables (``Controller.table_snapshot``, never the
live device directory, so no host syncs), bumps the committed version of
every slot a control action rewrote, and stages the new table along the
switch chain with a lag per chain position.  It also owns the lease state
machine and the fault injectors of the ``lease_expiry`` / ``split_brain``
/ ``quorum_drift`` scenarios.  It runs between device segments and
replaces whole leaves of the :class:`~.state.CoordState` with fresh
tensors on the state's device: an edit clones the leaf first, so it never
writes into a tensor that another leaf or a saved state shares.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.coordination_tier import state as ST
from repro_torch.coordination_tier.state import (
    INSTALL_NEVER,
    CoordConfig,
    CoordState,
    host_tensor,
)
from repro_torch.core import hierarchy as H

_TABLE_KEYS = ("slot_lo", "slot_hi", "live", "chains", "chain_len")

# the scenario events :meth:`CoordManager.on_event` understands (the epoch
# driver routes exactly these kinds to the manager; a run without the
# tier ignores them, so the fault scenarios double as the no-tier arm)
EVENT_KINDS = (
    "lease_expire",
    "lease_renew",
    "split_brain",
    "heal_split",
    "quorum_drift",
)


def _copy_tables(tables: dict) -> dict:
    return {k: np.array(tables[k]) for k in _TABLE_KEYS}


def _set_row(leaf: torch.Tensor, w: int, row) -> torch.Tensor:
    """``leaf.at[w].set(row)``: a clone of ``leaf`` with row ``w``
    replaced by a copy of the host array ``row``."""
    out = leaf.clone()
    out[w] = host_tensor(row, leaf.device)
    return out


class CoordManager:
    """Lease-holding controller of the switch chain.  ``device`` is where
    :meth:`make_state` and :meth:`rebuild` put the state (``None`` = the
    CUDA card)."""

    def __init__(self, cfg: CoordConfig, tables: dict, *, num_nodes: int,
                 num_pods: int = 1, device=None):
        self.cfg = cfg
        self.device = device
        self.chain = H.switch_topology(num_pods, cfg.n_switches)
        self.n_switches = len(self.chain)
        self.num_nodes = int(num_nodes)
        self._truth = _copy_tables(tables)
        s = self._truth["slot_lo"].shape[0]
        self._committed = np.zeros(s, np.uint32)
        self._staged = np.zeros(s, np.uint32)   # last committed vector staged
        # lease state machine
        self.leader_pos = 0
        self.lease_expires = cfg.lease_epochs
        self.lease_blocked = False   # an active lease_expiry fault
        self.renewals = 0
        self.failovers = 0
        self.stall_pulls = 0
        # fault bookkeeping
        self.lag_mult = np.ones(self.n_switches, np.int64)
        self.rogue: set[int] = set()

    # -- derived ----------------------------------------------------------
    @property
    def leader(self) -> int:
        return self.chain[self.leader_pos]

    def bound(self) -> int:
        """Configured staleness bound: every switch converges to the
        committed table within this many epochs of the staging pull (absent
        an active lease stall or split brain)."""
        if self.cfg.staleness_bound is not None:
            return self.cfg.staleness_bound
        return (self.n_switches - 1) * self.cfg.lag_per_hop * int(self.lag_mult.max())

    def _delays(self) -> np.ndarray:
        """Per-switch install delay: chain position relative to the leader
        times the per-hop lag (scaled for drifted switches)."""
        pos = (np.arange(self.n_switches) - self.leader_pos) % self.n_switches
        return pos * self.cfg.lag_per_hop * self.lag_mult

    # -- state construction ----------------------------------------------
    def make_state(self) -> CoordState:
        return ST.make_state(self._truth, self.n_switches, device=self.device)

    def rebuild(self, tables: dict) -> CoordState:
        """Full resync after a slot-pool growth: every switch re-registers
        at the new width."""
        self._truth = _copy_tables(tables)
        s = self._truth["slot_lo"].shape[0]
        self._committed = np.zeros(s, np.uint32)
        self._staged = np.zeros(s, np.uint32)
        self.rogue.clear()
        return self.make_state()

    # -- the control-write path -------------------------------------------
    def on_control(self, coord: CoordState, tables: dict, now: int
                   ) -> tuple[CoordState, list[str]]:
        """Runs at every control sync point (period pulls and failure
        splices): diff the snapshot against the last one, bump the
        committed versions of rewritten slots and, lease permitting, stage
        the new table along the chain."""
        notes: list[str] = []
        now = int(now)
        if not self.lease_blocked:
            self.lease_expires = now + self.cfg.lease_epochs
            self.renewals += 1
        elif now >= self.lease_expires + self.cfg.failover_after:
            self.leader_pos = (self.leader_pos + 1) % self.n_switches
            self.lease_blocked = False
            self.lease_expires = now + self.cfg.lease_epochs
            self.failovers += 1
            notes.append(f"coord_failover:sw{self.leader}")

        new = _copy_tables(tables)
        old = self._truth
        changed = (
            (new["slot_lo"] != old["slot_lo"])
            | (new["slot_hi"] != old["slot_hi"])
            | (new["live"] != old["live"])
            | (new["chains"] != old["chains"]).any(axis=1)
            | (new["chain_len"] != old["chain_len"])
        )
        self._truth = new
        n_changed = int(changed.sum())
        if n_changed:
            # the reconfiguration itself is the quorum commit; the state
            # gets a copy, so this in-place bump never reaches it later
            self._committed[changed] += 1
            coord = dataclasses.replace(
                coord, committed=host_tensor(self._committed, coord.device))

        if self.lease_blocked:
            if (self._staged != self._committed).any():
                self.stall_pulls += 1
                notes.append(
                    f"coord_stall:{int((self._staged != self._committed).sum())}")
            return coord, notes

        if (self._staged != self._committed).any():
            coord = self._stage(coord, now)
            notes.append(f"coord_stage:{n_changed}")
        return coord, notes

    def _stage(self, coord: CoordState, now: int) -> CoordState:
        t = self._truth
        install = np.full(self.n_switches, INSTALL_NEVER, np.int64)
        okay = np.ones(self.n_switches, bool)
        for w in self.rogue:   # a rogue switch ignores quorum installs
            okay[w] = False
        delays = self._delays()
        install[okay] = now + delays[okay]
        install = np.minimum(install, INSTALL_NEVER)
        self._staged = self._committed.copy()
        dev = coord.device
        return dataclasses.replace(
            coord,
            pend_lo=host_tensor(t["slot_lo"], dev),
            pend_hi=host_tensor(t["slot_hi"], dev),
            pend_live=host_tensor(t["live"].astype(bool), dev),
            pend_chains=host_tensor(t["chains"], dev),
            pend_clen=host_tensor(t["chain_len"], dev),
            pend_version=host_tensor(self._committed, dev),
            install_at=host_tensor(install, dev),
        )

    # -- fault injectors ---------------------------------------------------
    def on_event(self, kind: str, payload, coord: CoordState, tables: dict,
                 now: int) -> tuple[CoordState, list[str]]:
        notes: list[str] = []
        if kind == "lease_expire":
            self.lease_blocked = True
            self.lease_expires = min(self.lease_expires, int(now))
            notes.append(f"coord_lease_expired:sw{self.leader}")
        elif kind == "lease_renew":
            self.lease_blocked = False
            self.lease_expires = int(now) + self.cfg.lease_epochs
            self.renewals += 1
            notes.append("coord_lease_renewed")
        elif kind == "split_brain":
            w = int(payload) % self.n_switches
            if w == self.leader_pos:
                w = (w + 1) % self.n_switches
            self.rogue.add(w)
            # the rogue claims leadership and installs its own divergent
            # table: same bounds, chain ownership rotated by one node,
            # versions self-stamped far past the quorum commit
            ch = self._truth["chains"]
            rogue_ch = np.where(ch >= 0, (ch + 1) % self.num_nodes, ch)
            rogue_v = (self._committed + np.uint32(1000)).astype(np.uint32)
            coord = dataclasses.replace(
                coord,
                chains=_set_row(coord.chains, w, rogue_ch),
                version=_set_row(coord.version, w, rogue_v),
                install_at=_set_row(coord.install_at, w, INSTALL_NEVER),
            )
            notes.append(f"coord_split_brain:sw{w}")
        elif kind == "heal_split":
            t = self._truth
            for w in sorted(self.rogue):
                coord = dataclasses.replace(
                    coord,
                    slot_lo=_set_row(coord.slot_lo, w, t["slot_lo"]),
                    slot_hi=_set_row(coord.slot_hi, w, t["slot_hi"]),
                    live=_set_row(coord.live, w, t["live"].astype(bool)),
                    chains=_set_row(coord.chains, w, t["chains"]),
                    chain_len=_set_row(coord.chain_len, w, t["chain_len"]),
                    version=_set_row(coord.version, w, self._committed),
                )
                notes.append(f"coord_heal:sw{w}")
            self.rogue.clear()
        elif kind == "quorum_drift":
            w = int(payload) % self.n_switches
            self.lag_mult[w] = self.cfg.drift_mult
            notes.append(f"coord_drift:sw{w}x{self.cfg.drift_mult}")
        else:
            raise ValueError(f"unknown coordination event kind: {kind!r}")
        return coord, notes

    # -- inspection --------------------------------------------------------
    def converged(self, coord: CoordState) -> bool:
        """Every switch's every slot at the committed version (one sync)."""
        return bool((coord.version == coord.committed[None, :]).all())

    def summary(self) -> dict:
        return {
            "n_switches": self.n_switches,
            "leader": self.leader,
            "renewals": self.renewals,
            "failovers": self.failovers,
            "stall_pulls": self.stall_pulls,
            "lease_blocked": self.lease_blocked,
            "rogue": sorted(self.rogue),
            "lag_mult": self.lag_mult.tolist(),
            "staleness_bound": self.bound(),
        }
