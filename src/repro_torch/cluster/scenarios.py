"""Time-varying workload scenarios over :mod:`repro_torch.data.ycsb`.

A copy of ``repro.cluster.scenarios`` for the port (numpy only).

The paper evaluates static YCSB mixes; the adaptive-balancing loop only
earns its keep when the workload *moves*.  Each scenario emits one
fixed-shape op batch per epoch (shapes never change within a scenario, so
the cluster epoch step compiles exactly once) plus a control-event stream
(node failures/recoveries) the driver feeds to the controller.

Scenario zoo:

* ``shifting_hotspot`` — Zipf heat whose hot block rotates through the
  sorted key space (the headline adaptive-balancing stressor; the bench
  acceptance gate runs this at theta=1.2).
* ``flash_crowd``     — uniform background, then a tiny key block takes a
  large traffic share for a few epochs and vanishes again.
* ``diurnal``         — fixed Zipf popularity, sinusoidal read/write mix
  (day: read-heavy; night: write-heavy).
* ``node_failure``    — steady skewed load with a storage-node failure
  mid-run (and optional recovery) — §5.2 meets §5.1.
* ``multi_hotspot``   — several simultaneous Zipf hotspots on distinct
  key blocks, rotating over the run: whole-range control wastes motion on
  the cold remainder of each hot range, hot-subset splitting pays — the
  showcase workload for the slot-pool directory.
* ``keyspace_growth`` — insert-driven occupancy growth: only a prefix of
  the record set exists at load time and the active frontier (where both
  inserts and reads concentrate) climbs through the key space, shifting
  range occupancy against the static genesis bounds.
* ``rack_failure_hotspot`` — correlated failure: a whole rack (= the
  switch fronting it, paper §5.2) dies mid-run while a Zipf hotspot is
  rotating through the key space — the two PR-2 stressors composed, so
  the splice-the-whole-rack path is exercised by the scenario library,
  not just unit tests.
* ``ycsb_a``          — the classic update-heavy 50/50 mix (YCSB
  workload A) over stationary Zipf heat: the write-path stressor the
  replication-mode comparison (``repro.replication``) runs — chain-mode
  write broadcasts and CRAQ dirty windows both scale with the update
  share, which the read-heavy default mixes barely exercise.
* ``cascade_failure`` — overload stressor: a whole rack dies mid-run
  while the offered load stays constant, so the survivors inherit the
  dead rack's traffic on top of their own.  Without admission control
  the survivor queues collapse (service inflation compounds the
  backlog); with ``repro.overload`` + standby activation the cluster
  sheds, backs off, and recruits spare capacity instead.
* ``retry_storm``     — overload stressor: a rack blinks out and comes
  back a few epochs later.  Every query shed during the outage re-fires
  on its backoff schedule, so recovery is greeted by a synchronized
  retry wave on top of fresh load — the classic thundering-herd /
  metastable-failure shape bounded backoff budgets exist to break.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import keys as K
from repro_torch.data.ycsb import _zipf_probs


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Shared scenario knobs (fixed shapes: epoch_ops × n_epochs)."""

    n_epochs: int = 12
    epoch_ops: int = 2048
    n_records: int = 4096
    value_dim: int = 8
    read_ratio: float = 0.9       # base mix; diurnal modulates it
    seed: int = 0


class Scenario:
    """Base: stationary Zipf workload (subclasses add time variation)."""

    name = "stationary"

    def __init__(self, cfg: ScenarioConfig, *, theta: float = 0.99):
        self.cfg = cfg
        self.theta = theta
        rng = np.random.default_rng(cfg.seed)
        # distinct sorted record keys spread over the key space (ycsb idiom)
        self.record_keys = np.sort(
            rng.choice(np.uint64(K.KEY_SPACE - 2), size=cfg.n_records,
                       replace=False).astype(np.uint32)
        )
        self.base_probs = _zipf_probs(cfg.n_records, theta)
        # scatter heat over the key space for the stationary base case
        self.perm = rng.permutation(cfg.n_records)

    # -- per-epoch knobs subclasses override -------------------------------
    def record_probs(self, epoch: int) -> np.ndarray:
        """Popularity over record *indices* (sorted-key order) this epoch."""
        p = np.empty_like(self.base_probs)
        p[self.perm] = self.base_probs
        return p

    def read_ratio(self, epoch: int) -> float:
        return self.cfg.read_ratio

    def events(self, epoch: int) -> list[tuple[str, int]]:
        """Control events fired at the *start* of this epoch."""
        return []

    # -- generation --------------------------------------------------------
    def load(self):
        """(keys, values) preloaded before epoch 0 (YCSB load phase)."""
        rng = np.random.default_rng(self.cfg.seed + 1)
        vals = rng.normal(size=(self.cfg.n_records, self.cfg.value_dim))
        return self.record_keys, vals.astype(np.float32)

    def epoch(self, e: int):
        """One epoch's op stream: (opcodes, keys, end_keys, values)."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + 100 + e)
        idx = rng.choice(cfg.n_records, size=cfg.epoch_ops,
                         p=self.record_probs(e))
        keys = self.record_keys[idx]
        r = self.read_ratio(e)
        opcodes = np.where(rng.random(cfg.epoch_ops) < r, K.OP_GET,
                           K.OP_PUT).astype(np.int32)
        end_keys = np.zeros(cfg.epoch_ops, np.uint32)
        values = rng.normal(size=(cfg.epoch_ops, cfg.value_dim)).astype(np.float32)
        return opcodes, keys, end_keys, values


class ShiftingHotspot(Scenario):
    """Zipf heat concentrated on a contiguous sorted-key block that jumps
    to a new quarter of the key space every ``shift_every`` epochs.

    Contiguous in sorted-key order == contiguous sub-ranges == a few hot
    chains — the worst case for a frozen directory and the best case for
    migration + selective replication.
    """

    name = "shifting_hotspot"

    def __init__(self, cfg: ScenarioConfig, *, theta: float = 1.2,
                 shift_every: int = 3):
        super().__init__(cfg, theta=theta)
        self.shift_every = shift_every

    def record_probs(self, epoch: int) -> np.ndarray:
        n = self.cfg.n_records
        start = ((epoch // self.shift_every) * (n // 4)) % n
        # rank r (hottest first) -> record index (start + r) % n
        p = np.empty(n)
        ranks = (np.arange(n) + start) % n
        p[ranks] = self.base_probs
        return p


class FlashCrowd(Scenario):
    """Uniform background; epochs [t0, t1) send ``crowd_frac`` of traffic
    to a ``crowd_records``-wide contiguous key block."""

    name = "flash_crowd"

    def __init__(self, cfg: ScenarioConfig, *, t0: int = 4, t1: int = 8,
                 crowd_frac: float = 0.7, crowd_records: int = 32):
        super().__init__(cfg, theta=0.0)
        self.t0, self.t1 = t0, t1
        self.crowd_frac = crowd_frac
        self.crowd_records = min(crowd_records, cfg.n_records)

    def record_probs(self, epoch: int) -> np.ndarray:
        n = self.cfg.n_records
        p = np.full(n, 1.0 / n)
        if self.t0 <= epoch < self.t1:
            crowd = np.zeros(n)
            lo = (n // 2) % max(n - self.crowd_records, 1)
            crowd[lo:lo + self.crowd_records] = 1.0 / self.crowd_records
            p = (1 - self.crowd_frac) * p + self.crowd_frac * crowd
        return p / p.sum()


class Diurnal(Scenario):
    """Fixed Zipf heat; read ratio swings sinusoidally over the run
    (read-heavy 'day' to write-heavy 'night')."""

    name = "diurnal"

    def __init__(self, cfg: ScenarioConfig, *, theta: float = 0.9,
                 lo: float = 0.5, hi: float = 0.95, period: int | None = None):
        super().__init__(cfg, theta=theta)
        self.lo, self.hi = lo, hi
        self.period = period or cfg.n_epochs

    def read_ratio(self, epoch: int) -> float:
        phase = 2.0 * np.pi * epoch / max(self.period, 1)
        return self.lo + (self.hi - self.lo) * 0.5 * (1.0 + np.sin(phase))


class NodeFailure(Scenario):
    """Steady Zipf load with a node failure mid-run (optional recovery)."""

    name = "node_failure"

    def __init__(self, cfg: ScenarioConfig, *, theta: float = 0.99,
                 fail_epoch: int = 4, fail_node: int = 0,
                 recover_epoch: int | None = None):
        super().__init__(cfg, theta=theta)
        self.fail_epoch = fail_epoch
        self.fail_node = fail_node
        self.recover_epoch = recover_epoch

    def events(self, epoch: int) -> list[tuple[str, int]]:
        ev = []
        if epoch == self.fail_epoch:
            ev.append(("fail", self.fail_node))
        if self.recover_epoch is not None and epoch == self.recover_epoch:
            ev.append(("recover", self.fail_node))
        return ev


class MultiHotspot(Scenario):
    """``n_hotspots`` simultaneous Zipf hotspots on distinct contiguous
    key blocks, all rotating every ``shift_every`` epochs.

    Zipf rank r (hottest first) feeds hotspot ``r % k`` at within-block
    offset ``r // k``, so each block carries its own Zipf-decaying heat
    spike.  With k spikes alive at once there are not enough cold nodes
    to absorb whole-range moves — isolating the hot *subset* of each
    range (split, then act on the child) is the winning play.
    """

    name = "multi_hotspot"

    def __init__(self, cfg: ScenarioConfig, *, theta: float = 1.3,
                 n_hotspots: int = 3, shift_every: int = 4):
        super().__init__(cfg, theta=theta)
        self.n_hotspots = max(1, n_hotspots)
        self.shift_every = max(1, shift_every)
        # rotation stride: a quarter block per shift, so hotspots sweep
        # the space without immediately landing on each other
        self.stride = max(1, cfg.n_records // (4 * self.n_hotspots))

    def record_probs(self, epoch: int) -> np.ndarray:
        n = self.cfg.n_records
        k = self.n_hotspots
        shift = (epoch // self.shift_every) * self.stride
        r = np.arange(n)
        block = r % k                   # which hotspot this rank feeds
        offset = r // k                 # position inside the block
        pos = (block * (n // k) + shift + offset) % n
        p = np.zeros(n)
        np.add.at(p, pos, self.base_probs)
        return p / p.sum()


class KeyspaceGrowth(Scenario):
    """Insert-driven growth: only ``start_frac`` of the records exist at
    load time; each epoch the active frontier advances and traffic (write
    heavy, Zipf-concentrated on the newest records) follows it upward
    through the key space.  Static genesis bounds end up with a few
    overstuffed frontier ranges — occupancy pressure the split machinery
    relieves without touching the cold archive below.
    """

    name = "keyspace_growth"

    def __init__(self, cfg: ScenarioConfig, *, theta: float = 0.9,
                 start_frac: float = 0.25, write_ratio: float = 0.5):
        super().__init__(cfg, theta=theta)
        self.start_frac = min(max(start_frac, 0.01), 1.0)
        self.write_ratio = write_ratio

    def _active(self, epoch: int) -> int:
        n = self.cfg.n_records
        n0 = max(2, int(n * self.start_frac))
        grow = (n - n0) * (epoch + 1) // max(self.cfg.n_epochs, 1)
        return min(n, n0 + grow)

    def load(self):
        keys, vals = super().load()
        n0 = max(2, int(self.cfg.n_records * self.start_frac))
        return keys[:n0], vals[:n0]

    def record_probs(self, epoch: int) -> np.ndarray:
        n = self.cfg.n_records
        active = self._active(epoch)
        p = np.zeros(n)
        # newest records hottest: rank r -> record (active - 1 - r)
        p[active - 1 :: -1] = self.base_probs[:active]
        return p / p.sum()

    def read_ratio(self, epoch: int) -> float:
        return 1.0 - self.write_ratio


class YcsbA(Scenario):
    """YCSB workload A: ``update_ratio`` of ops are writes (default the
    canonical 50/50), Zipf-popular keys, stationary heat.  Write-heavy
    enough that replication write paths — not read spreading — set the
    tail: the headline mix for comparing ``eventual``/``chain``/``craq``.
    """

    name = "ycsb_a"

    def __init__(self, cfg: ScenarioConfig, *, theta: float = 0.99,
                 update_ratio: float = 0.5):
        super().__init__(cfg, theta=theta)
        self.update_ratio = min(max(update_ratio, 0.0), 1.0)

    def read_ratio(self, epoch: int) -> float:
        return 1.0 - self.update_ratio


class RackFailureHotspot(ShiftingHotspot):
    """Correlated failure under load: the Zipf hot block keeps rotating
    (as in ``shifting_hotspot``) and at ``fail_epoch`` a whole rack of
    storage nodes drops out at once — a switch failure takes down every
    node behind it (paper §5.2).  The driver routes the event through
    ``Controller.handle_switch_failure`` so all rack members are spliced
    *before* any chain is repaired (repair copies must never target a
    dead rack-mate).  Optional per-node recovery later in the run.
    """

    name = "rack_failure_hotspot"

    def __init__(self, cfg: ScenarioConfig, *, theta: float = 1.2,
                 shift_every: int = 3, fail_epoch: int = 4,
                 rack: tuple[int, ...] = (0, 1),
                 recover_epoch: int | None = None):
        super().__init__(cfg, theta=theta, shift_every=shift_every)
        self.fail_epoch = fail_epoch
        self.rack = tuple(int(n) for n in rack)
        self.recover_epoch = recover_epoch

    def events(self, epoch: int) -> list[tuple[str, object]]:
        ev: list[tuple[str, object]] = []
        if epoch == self.fail_epoch:
            ev.append(("rack_fail", self.rack))
        if self.recover_epoch is not None and epoch == self.recover_epoch:
            ev.extend(("recover", n) for n in self.rack)
        return ev


class CascadeFailure(Scenario):
    """Capacity-loss overload: stationary Zipf heat, constant offered
    load, and at ``fail_epoch`` a whole rack drops dead for the rest of
    the run.  The survivors must absorb the dead rack's share — offered
    load per live node jumps by ``N / (N - len(rack))`` — which drives
    queue occupancy (and with it the occupancy-dependent service
    inflation of ``repro.overload``) into the unstable regime unless the
    control plane sheds load and activates standby capacity.
    """

    name = "cascade_failure"

    def __init__(self, cfg: ScenarioConfig, *, theta: float = 0.9,
                 fail_epoch: int = 3, rack: tuple[int, ...] = (0, 1, 2)):
        super().__init__(cfg, theta=theta)
        self.fail_epoch = fail_epoch
        self.rack = tuple(int(n) for n in rack)

    def events(self, epoch: int) -> list[tuple[str, object]]:
        if epoch == self.fail_epoch:
            return [("rack_fail", self.rack)]
        return []


class RetryStorm(Scenario):
    """Transient outage + synchronized retries: a rack fails at
    ``fail_epoch`` and recovers at ``recover_epoch``.  Queries shed
    during the outage sit in the backoff orbit and re-arrive together
    once their timers expire — so the moment capacity returns, the
    cluster faces fresh load *plus* the accumulated retry wave.  An
    uncontrolled loop melts down exactly when it should be recovering
    (the metastable-failure signature); bounded retry budgets and
    admission probabilities let the wave drain instead of re-shedding
    into ever-higher backoff levels.
    """

    name = "retry_storm"

    def __init__(self, cfg: ScenarioConfig, *, theta: float = 0.9,
                 fail_epoch: int = 2, recover_epoch: int = 5,
                 rack: tuple[int, ...] = (0, 1)):
        super().__init__(cfg, theta=theta)
        self.fail_epoch = fail_epoch
        self.recover_epoch = recover_epoch
        self.rack = tuple(int(n) for n in rack)

    def events(self, epoch: int) -> list[tuple[str, object]]:
        ev: list[tuple[str, object]] = []
        if epoch == self.fail_epoch:
            ev.append(("rack_fail", self.rack))
        if epoch == self.recover_epoch:
            ev.extend(("recover", n) for n in self.rack)
        return ev


class LeaseExpiry(ShiftingHotspot):
    """Coordination-tier stressor: the controller's directory lease on the
    switch fabric expires mid-run while the Zipf hot block keeps rotating
    (so migrations keep rewriting the tables).  Staging stalls — committed
    versions run ahead of every switch copy, widening the stale window —
    until either an explicit renewal or the failover grace elapses and
    leadership moves down the switch chain
    (``repro.coordination_tier.CoordManager``).  Without the tier the
    events are ignored: the same scenario is the no-coordination baseline.
    """

    name = "lease_expiry"

    def __init__(self, cfg: ScenarioConfig, *, theta: float = 1.2,
                 shift_every: int = 3, expire_epoch: int = 3,
                 renew_epoch: int | None = None):
        super().__init__(cfg, theta=theta, shift_every=shift_every)
        self.expire_epoch = expire_epoch
        self.renew_epoch = renew_epoch

    def events(self, epoch: int) -> list[tuple[str, object]]:
        ev: list[tuple[str, object]] = []
        if epoch == self.expire_epoch:
            ev.append(("lease_expire", 0))
        if self.renew_epoch is not None and epoch == self.renew_epoch:
            ev.append(("lease_renew", 0))
        return ev


class SplitBrain(ShiftingHotspot):
    """Coordination-tier stressor: at ``split_epoch`` one switch partitions
    away from the quorum, claims leadership, and installs a divergent
    table (chain ownership rotated by one node, versions self-stamped past
    the commit).  Every query entering through the rogue switch would be
    served by the wrong owner; the versioned-redirect check catches the
    divergence and bounces them to the true owner instead.  Healing
    re-registers the rogue at the committed table.
    """

    name = "split_brain"

    def __init__(self, cfg: ScenarioConfig, *, theta: float = 1.2,
                 shift_every: int = 3, split_epoch: int = 3,
                 heal_epoch: int | None = 8, switch: int = 1):
        super().__init__(cfg, theta=theta, shift_every=shift_every)
        self.split_epoch = split_epoch
        self.heal_epoch = heal_epoch
        self.switch = int(switch)

    def events(self, epoch: int) -> list[tuple[str, object]]:
        ev: list[tuple[str, object]] = []
        if epoch == self.split_epoch:
            ev.append(("split_brain", self.switch))
        if self.heal_epoch is not None and epoch == self.heal_epoch:
            ev.append(("heal_split", self.switch))
        return ev


class QuorumDrift(ShiftingHotspot):
    """Coordination-tier stressor: at ``drift_epoch`` one switch's install
    lag multiplies (a congested control channel), so its table copy trails
    the quorum commit by ``drift_mult`` times the configured per-hop lag —
    every reconfiguration after that point leaves the drifted switch
    serving stale routes (and redirecting, under quorum reads) for a
    proportionally longer window.
    """

    name = "quorum_drift"

    def __init__(self, cfg: ScenarioConfig, *, theta: float = 1.2,
                 shift_every: int = 3, drift_epoch: int = 2,
                 switch: int = 2):
        super().__init__(cfg, theta=theta, shift_every=shift_every)
        self.drift_epoch = drift_epoch
        self.switch = int(switch)

    def events(self, epoch: int) -> list[tuple[str, object]]:
        if epoch == self.drift_epoch:
            return [("quorum_drift", self.switch)]
        return []


SCENARIOS = {
    "stationary": Scenario,
    "shifting_hotspot": ShiftingHotspot,
    "flash_crowd": FlashCrowd,
    "diurnal": Diurnal,
    "node_failure": NodeFailure,
    "multi_hotspot": MultiHotspot,
    "keyspace_growth": KeyspaceGrowth,
    "rack_failure_hotspot": RackFailureHotspot,
    "ycsb_a": YcsbA,
    "cascade_failure": CascadeFailure,
    "retry_storm": RetryStorm,
    "lease_expiry": LeaseExpiry,
    "split_brain": SplitBrain,
    "quorum_drift": QuorumDrift,
}


def make_scenario(name: str, cfg: ScenarioConfig | None = None, **kw) -> Scenario:
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; pick from {sorted(SCENARIOS)}")
    return SCENARIOS[name](cfg or ScenarioConfig(), **kw)
