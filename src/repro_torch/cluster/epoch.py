"""The closed-loop epoch driver on PyTorch (counterpart of
``repro.cluster.epoch``, oracle backend, ``eventual`` / ``chain`` /
``craq`` replication, with or without the coordination tier).

One *epoch* is one device step —

    inject workload slice
    -> route (K1 ``range_match`` for tail reads, K2 ``range_match_spread``
       for p2c reads, K3 ``range_match_spread_dirty`` for craq's p2c reads
       with dirty-bit tail bounces; counter, load-register and count-min
       sketch updates in torch)
    -> apply to the store (``apply_routed``; GET/DEL probes through K4a
       ``slab_lookup``)
    -> with the overload plane, the admission-queue / retry-orbit step
       (``overload.step``): each query's timing fate (admitted with
       inflated service, deferred or shed); its pre-epoch queue depths
       join the load registers of K2's / K3's p2c comparison
    -> with the coordination tier, install the switches' staged tables
       and route the batch through each query's ingress switch copy (K5
       ``range_match_stale``): a divergent row takes a versioned redirect
    -> build the DES hop plan (a bounced read visits its pick, then the
       tail; a redirected query visits the stale server first)
    -> advance the version/dirty register file (chain and craq)

— and the host closes the loop at each control period: pull the
statistics report, run the balancing policy, execute its migration plan,
graft the refreshed tables onto the live directory, stage the control
writes along the switch chain (coordination tier), and time the period's
traffic on the DES engine.  With the overload plane the pull also hands
the policy each node's queue depth and retry backlog and grafts the
policy's admission probabilities and retry budgets back onto the device
registers; with ``split_overflow`` a node whose store overflowed splits
its hottest range, and a pool that runs out of slots grows (every table
held per slot is rebuilt at the new width, ``growth_events`` counts it).

``fused=True`` (default) runs a control period's epochs back to back
with every carry on the device (store, directory, load registers,
sketch) and brings the period's hop plans and observables home in ONE
device-to-host copy, timed by ONE batched ``simulate_closed_loop`` call.
``fused=False`` is the per-epoch loop the fused one is held to bit for
bit.  The reference's fused period is a donated ``lax.scan``; here the
carries are updated in place (the store slabs are the big allocation).
Capturing the period as one CUDA graph is later work.

With ``telemetry`` the step also builds the epoch's sampled span table
(``telemetry.collect_spans``; the overload plane's orbit-identity
register is then sized by ``link_retries`` and stamped by
``overload.link_orbit``), and with ``metrics`` it writes the epoch's row of
the device-resident metrics ring (``telemetry.metrics.record_epoch``).
Both planes only observe: no PRNG is drawn and no carried register
changes, so the metric stream and the final state are those of the run
with them off.  The spans ride the segment's one copy home; at each
segment's end the host attributes them, feeds the flight recorder,
folds the DES columns into the ring and evaluates the SLO burn rates.

``backend="dist"`` runs the same epochs through the sharded data plane
(:mod:`repro_torch.core.dist_store`) on a ``mesh`` of one storage node a
shard, stacked on the driver's device or split into parts over several
devices (the mesh's first is the driver's: the controller's card holds
the directory, the registers and the observe stage): each shard routes
its slice of the batch on its part's device (K1 for a part's slices at
once under tail reads, K2 / K3 a shard under p2c, with draws of its own),
one bounded-bucket exchange round serves the reads (K4a, one launch a
part for its shards' inbound queries) and ``r_max`` rounds carry the
writes along the chain; the observe stage (op counts,
sketch, overload step, tier accounting with K5, hop plans, register
advance, spans, metrics row) is the oracle's, on the whole batch.  The
fused loop runs each segment as one call of ``make_dist_period`` and
brings its outputs home in one copy; ``EpochMetrics.retries`` is the
first shard's bucket overflow, as the reference's replicated output
reads it.  Over several parts the store is a
:class:`~repro_torch.core.store.StoreParts`: the preload, the migrations
and the overflow reads go part by part, the directory's copies on the
other devices are refreshed after each control pull and pool growth,
and the host sends the whole batch to the controller's device and each
part's slices to its own.  The coordination tier's fault events
(``coordination_tier.EVENT_KINDS``) are ignored without the tier, so the
same scenario is the no-tier baseline.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch import coordination_tier as CT
from repro_torch import overload as OVL
from repro_torch import prng
from repro_torch import telemetry as TEL
from repro_torch.cluster.metrics import (
    EpochMetrics,
    imbalance_stats_batch,
    latency_percentiles_batch,
    masked_p99_batch,
    migration_traffic,
    p999_batch,
)
from repro_torch.cluster.policies import Policy
from repro_torch.cluster.scenarios import Scenario
from repro_torch.core import directory as D
from repro_torch.core import keys as K
from repro_torch.core import routing as R
from repro_torch.core.controller import Controller, ControllerConfig
from repro_torch.core.coordination import (
    IN_SWITCH,
    HopPlan,
    LatencyModel,
    ServiceModel,
    plan_hops,
)
from repro_torch.core.des import BACKENDS as DES_BACKENDS
from repro_torch.core.des import simulate_closed_loop
from repro_torch.core.dist_store import (
    DistConfig,
    stack_epochs,
    make_dist_apply,
    make_dist_period,
    replicate,
)
from repro_torch.core.migration import execute as execute_migrations
from repro_torch.core.stats import make_sketch, pull_report, sketch_query, sketch_update
from repro_torch.core.store import apply_routed, make_store
from repro_torch.device import indexed, resolve_device
from repro_torch import replication as RPL
from repro_torch.telemetry import metrics as MTR
from repro_torch.telemetry import slo as SLOM


@dataclasses.dataclass
class ClusterConfig:
    """Cluster geometry + timing knobs (the reference's fields)."""

    num_nodes: int = 8
    num_ranges: int = 64
    replication: int = 2
    r_max: int = 4
    n_slots: int | None = None
    capacity: int | None = None
    mode: str = IN_SWITCH
    n_clients: int = 32
    replication_mode: str = "eventual"
    report_every: int | str | None = None
    auto_band: tuple = (1, 8)
    auto_drift_lo: float = 0.1
    auto_drift_hi: float = 0.4
    sketch_width: int = 512
    sketch_depth: int = 4
    key_window_cap: int = 1 << 16
    latency: LatencyModel = dataclasses.field(default_factory=LatencyModel)
    service_model: ServiceModel = dataclasses.field(default_factory=ServiceModel)
    p2c_chunks: int = 1
    des_backend: str | None = None
    max_scan_results: int = 8
    imbalance_threshold: float = 1.3
    max_moves_per_round: int = 4
    overload: OVL.OverloadConfig | None = None
    standby_nodes: tuple = ()
    split_overflow: bool = False
    telemetry: TEL.TelemetryConfig | None = None
    coordination: CT.CoordConfig | None = None
    metrics: MTR.MetricsConfig | None = None
    craq_filter_bits: int = 0
    seed: int = 0


def _check_supported(cfg: ClusterConfig, backend: str, mesh) -> None:
    if backend not in ("oracle", "dist"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "dist" and mesh is None:
        raise ValueError("backend='dist' needs a mesh")
    if backend == "dist" and cfg.craq_filter_bits:
        raise ValueError(
            "craq_filter_bits is an oracle-backend measurement "
            "feature; the dist data plane keeps slot-granular "
            "bouncing"
        )
    if cfg.des_backend not in (None, "auto") + DES_BACKENDS:
        raise ValueError(
            f"DES backend {cfg.des_backend!r}: pick one of {DES_BACKENDS} "
            "or auto (native, else the heapq oracle)"
        )


def _node_ops(decision: R.RoutingDecision, opcode: torch.Tensor,
              num_nodes: int) -> torch.Tensor:
    """(N,) ops served per node: reads at their target, writes at every
    live chain member.  A NO_NODE read target charges node N-1, as in the
    reference (``D.wrap_node``, ROADMAP fault F2)."""
    is_write = (opcode == K.OP_PUT) | (opcode == K.OP_DEL)
    r_max = decision.chain.shape[1]
    live = (torch.arange(r_max, device=opcode.device)[None, :]
            < decision.chain_len[:, None]) & (decision.chain != D.NO_NODE)
    w_hit = live & is_write[:, None]
    ops = torch.zeros(num_nodes, dtype=torch.int64, device=opcode.device)
    ops.index_add_(0, torch.where(w_hit, decision.chain, 0).reshape(-1),
                   w_hit.reshape(-1).to(torch.int64))
    ops.index_add_(0, D.wrap_node(decision.target, num_nodes),
                   (~is_write).to(torch.int64))
    return ops


def _merge_unique(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Merge two sorted-unique uint32 arrays in linear time."""
    if a.size == 0:
        return b
    if b.size == 0:
        return a
    pos = np.searchsorted(a, b)
    hit = (pos < a.size) & (a[np.minimum(pos, a.size - 1)] == b)
    fresh = b[~hit]
    if fresh.size == 0:
        return a
    out = np.empty(a.size + fresh.size, a.dtype)
    at_b = np.searchsorted(a, fresh) + np.arange(fresh.size)
    mask = np.zeros(out.size, bool)
    mask[at_b] = True
    out[mask] = fresh
    out[~mask] = a
    return out


def _to_host(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """Bring several device tensors home in ONE device-to-host copy: their
    bytes are concatenated on the device, copied once, and split and
    re-typed on the host."""
    flats = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    host = torch.cat(flats).cpu().numpy()
    out, at = [], 0
    for t, f in zip(tensors, flats):
        n = f.numel()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(host[at:at + n].view(dtype).reshape(tuple(t.shape)))
        at += n
    return out


class EpochDriver:
    """Run a scenario under a policy, one control period at a time, on
    ``device`` (``None`` = the CUDA card; raises when there is none)."""

    def __init__(self, scenario: Scenario, policy: Policy,
                 cfg: ClusterConfig | None = None, *, backend: str = "oracle",
                 mesh=None, dist_cfg: DistConfig | None = None,
                 fused: bool = True, device=None):
        self.scenario = scenario
        self.policy = policy
        self.cfg = cfg = cfg or ClusterConfig()
        _check_supported(cfg, backend, mesh)
        self.device = resolve_device(device)
        if backend == "dist" and (
                indexed(mesh.device) != indexed(self.device)
                or mesh.shape[(dist_cfg or DistConfig()).axis] != cfg.num_nodes):
            raise ValueError(
                f"mesh of {mesh.n_shards} shards on {mesh.devices}: the dist "
                f"backend holds one storage node a shard ({cfg.num_nodes}), "
                f"its first part on the driver's device ({self.device})")
        self.backend = backend
        self.fused = fused
        self.mode_plan = RPL.resolve_mode(
            cfg.replication_mode, policy.read_spread, cfg.replication
        )
        # per-stage host wall seconds (``stage_seconds``), taken without
        # any synchronise (so "des" includes waiting for the period's
        # device work) unless the trace plane's profile_stages blocks on
        # each device step; and on CUDA the device seconds of every step
        # from a pair of CUDA events, read once the period's copy home
        # has passed them
        tcfg = cfg.telemetry
        self.timers = TEL.StageTimers(
            sync=tcfg is not None and tcfg.profile_stages)
        self.device_step_seconds = 0.0
        self._step_events: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []
        pe = (cfg.report_every if cfg.report_every is not None
              else policy.pull_every)
        self.period_history: list[int] = []
        if pe == "auto":
            lo, hi = int(cfg.auto_band[0]), int(cfg.auto_band[1])
            if not (1 <= lo <= hi):
                raise ValueError(f"bad auto_band {cfg.auto_band}")
            self.auto_period = True
            self.period = hi
            self._cur_period = lo
            self._next_pull = lo
            self._prev_load: np.ndarray | None = None
            self._last_pull_epoch = 0
            self._reg_floor = np.zeros((cfg.num_nodes,), np.float64)
        else:
            self.auto_period = False
            self.period = int(pe)

        scfg = scenario.cfg
        policy.config.base_replication = cfg.replication
        if cfg.p2c_chunks > 1 and scfg.epoch_ops % cfg.p2c_chunks != 0:
            raise ValueError(
                f"epoch_ops {scfg.epoch_ops} not divisible by "
                f"p2c_chunks {cfg.p2c_chunks}"
            )

        n_slots = 2 * cfg.num_ranges if cfg.n_slots is None else cfg.n_slots
        directory = D.make_directory(
            cfg.num_ranges, cfg.num_nodes, cfg.replication, r_max=cfg.r_max,
            n_slots=n_slots, device=self.device,
        )
        self.controller = Controller(
            directory,
            ControllerConfig(
                imbalance_threshold=cfg.imbalance_threshold,
                max_moves_per_round=cfg.max_moves_per_round,
            ),
        )
        if cfg.standby_nodes:
            for node in cfg.standby_nodes:
                self.controller.park_node(int(node))
            directory = self.controller.directory()
            self.controller.drain_repl_log()
        capacity = cfg.capacity
        if capacity is None:
            # every record on up to r_max chains, plus 2x headroom for
            # skewed placement and widen copies
            capacity = max(256, 2 * scfg.n_records * cfg.r_max // cfg.num_nodes)
        self.store = make_store(
            cfg.num_nodes, capacity, scfg.value_dim, device=self.device,
            parts=mesh.devices if backend == "dist" else None)
        self.directory = directory
        self.load_reg = torch.zeros(cfg.num_nodes, dtype=torch.int64,
                                    device=self.device)
        # the (n_slots, r_max) version/dirty register file (and the
        # (n_slots, F) key filter), device-resident; chain and craq advance
        # it every epoch
        self.repl = RPL.make_state(n_slots, cfg.r_max, cfg.craq_filter_bits,
                                   device=self.device)
        # the coordination tier: per-switch table copies and version
        # registers on the device; the host CoordManager stages control
        # writes along the switch chain between segments
        self.coord_cfg = cfg.coordination
        if self.coord_cfg is not None:
            self.coord_mgr = CT.CoordManager(
                self.coord_cfg, self.controller.table_snapshot(),
                num_nodes=cfg.num_nodes, device=self.device,
            )
            self.coord = self.coord_mgr.make_state()
        else:
            self.coord_mgr = None
            self.coord = None
        # the previous period's redirect share (redirected / routed): the
        # policy-facing convergence signal behind redirect_backoff
        self._last_redirect_share = 0.0
        # the overload plane: per-node queue/retry registers on the device
        # (None when off, which leaves every other value bit-identical).
        # Its orbit-identity register sizes off the trace plane's
        # link_retries (0 bits: the (1,) placeholder)
        self.ovl_cfg = cfg.overload
        self.ovl = (OVL.make_state(
            cfg.num_nodes, cfg.overload,
            link_bits=tcfg.link_retries if tcfg is not None else 0,
            device=self.device) if cfg.overload is not None else None)
        # the trace plane: spans are built in the device step and ride the
        # segment's copy home; the host recorder attributes and archives
        # them (None: the step builds none)
        self.tel_cfg = tcfg
        self._tel_threshold = (TEL.rate_threshold(tcfg.sample_rate)
                               if tcfg is not None else 0)
        self.telemetry = (TEL.TelemetryRecorder(
            tcfg, model=cfg.latency, scenario=scenario.name,
            policy=policy.name, n_clients=cfg.n_clients, timers=self.timers)
            if tcfg is not None else None)
        # the fleet metrics plane: a (window, n_series) float32 ring on the
        # device, a row written by every step, with SLO burn-rate alerts
        # evaluated at each segment's end
        self.met_cfg = cfg.metrics
        self._met_pos = 0   # host mirror of metrics.pos (fold positions)
        self.met_layout = self.metrics = self.met_engine = None
        if self.met_cfg is not None:
            self.met_layout = MTR.build_layout(
                cfg.num_nodes,
                n_switches=(self.coord_mgr.n_switches
                            if self.coord_mgr is not None else 0),
                topk=min(self.met_cfg.topk, n_slots))
            for s in self.met_cfg.slos:
                if s.series not in self.met_layout.index:
                    raise ValueError(
                        f"SLO {s.name!r} names unknown series {s.series!r}")
                need = s.slow_window + self.period
                if self.met_cfg.window < need:
                    raise ValueError(
                        f"metrics window {self.met_cfg.window} too short "
                        f"for SLO {s.name!r}: needs >= slow_window + period "
                        f"= {need} epochs of retained history")
            self.metrics = MTR.make_state(self.met_cfg.window,
                                          self.met_layout.n_series,
                                          device=self.device)
            self.met_engine = SLOM.AlertEngine(self.met_cfg.slos,
                                               on_fire=self._on_slo_fire)
        self.sketch = make_sketch(cfg.sketch_width, cfg.sketch_depth,
                                  device=self.device)
        self.key = prng.PRNGKey(cfg.seed)
        # slot-pool growths (split_overflow): the rows' compiled_steps is
        # the reference's compile count, 1 + growth_events
        self.growth_events = 0
        self._period = 0
        self._last_overflow = 0
        self.host_syncs = 0        # device->host round-trips (profile metric)
        self._key_window: np.ndarray = np.empty(0, np.uint32)
        self._event_epochs = {
            e for e in range(scfg.n_epochs) if scenario.events(e)
        }
        # the dist backend: the sharded data plane, one epoch a call
        # (per-epoch loop) or a segment a call (fused loop); the bucket
        # overflow of every source shard, summed over the run
        self._mesh = mesh
        # the directory's copies on the mesh's other devices (none on a
        # one-device mesh), refreshed whenever the tables change
        self._dir_copies = {}
        self._q_parts = None
        self._dist_apply = self._period_fn = None
        self.bucket_overflow_total = 0
        self.exchange_rounds = 0    # the dist plane's a2a rounds run
        if backend == "dist":
            self._dist_cfg = dataclasses.replace(
                dist_cfg or DistConfig(),
                read_spread=self.mode_plan.spread,
                return_decision=True,
                replication_mode=cfg.replication_mode,
                max_scan_results=cfg.max_scan_results,
                queue_pen=(cfg.overload is not None
                           and cfg.overload.queue_weight > 0
                           and self.mode_plan.spread),
            )
            if fused:
                self._period_fn = self._build_dist_period()
            else:
                self._dist_apply = make_dist_apply(mesh, directory,
                                                   self._dist_cfg)
            self._replicate()
        self._preload()

    # -- host-side helpers -------------------------------------------------
    @property
    def stage_seconds(self) -> dict[str, float]:
        """Host wall seconds by pipeline stage (the stage timers' totals)."""
        return self.timers.totals

    def _timed(self, fn, *args, **kw):
        """``fn(*args, **kw)`` (a device step) between two CUDA events on
        the current stream (recording them does not block the host)."""
        if self.device.type != "cuda":
            return fn(*args, **kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kw)
        end.record()
        self._step_events.append((start, end))
        return out

    def _fold_step_events(self) -> None:
        """Add up the recorded steps' device time; called after a blocking
        copy home that follows them on the stream, so every event is done."""
        for start, end in self._step_events:
            self.device_step_seconds += start.elapsed_time(end) / 1e3
        self._step_events.clear()

    def _sync(self, x: torch.Tensor) -> np.ndarray:
        """Device->host transfer with bookkeeping."""
        self.host_syncs += 1
        return x.cpu().numpy()

    def _note_keys(self, keys) -> None:
        ek = np.unique(np.asarray(keys, np.uint32).ravel())
        self._key_window = _merge_unique(self._key_window, ek)
        cap = self.cfg.key_window_cap
        if cap and self._key_window.size > cap:
            stride = -(-self._key_window.size // cap)
            self._key_window = self._key_window[::stride]

    def _sketch_heat(self, sample: np.ndarray) -> np.ndarray:
        q = torch.as_tensor(sample.astype(np.int64), device=self.device)
        return self._sync(sketch_query(self.sketch, q)).astype(np.float64)

    def _live_mask(self) -> np.ndarray:
        out = self.controller.failed | self.controller.standby
        return np.array([n not in out for n in range(self.cfg.num_nodes)])

    def _queries(self, e: int):
        opcodes, keys, end_keys, values = self.scenario.epoch(e)
        self._note_keys(keys)
        q = R.make_queries(keys, opcodes, values, end_keys, device=self.device)
        if self._dir_copies:
            # the dist mesh spans other devices: each part's slices go
            # there from the same host arrays (the controller's part is
            # a view of the whole batch)
            k = self._mesh.parts
            Bp = len(keys) // k
            self._q_parts = [
                R.QueryBatch(*(x[a * Bp:(a + 1) * Bp] for x in (
                    q.opcode, q.key, q.end_key, q.value)))
                if indexed(dev) == q.key.device else R.make_queries(
                    *(x[a * Bp:(a + 1) * Bp] for x in (keys, opcodes, values,
                                                       end_keys)),
                    device=dev)
                for a, dev in enumerate(self._mesh.devices)]
        return opcodes, q

    def _replicate(self) -> None:
        """Copy the directory to the dist mesh's other devices (after the
        tables change: a control pull, a failure, a pool growth)."""
        if self._mesh is not None and self.backend == "dist":
            self._dir_copies = replicate(self.directory, self._mesh)

    # -- setup -------------------------------------------------------------
    def _preload(self):
        """YCSB load phase: PUT every record through the normal data path."""
        keys, vals = self.scenario.load()
        q = R.make_queries(keys, np.full((len(keys),), K.OP_PUT, np.int32),
                           vals, device=self.device)
        decision, _ = R.route(self.directory, q)   # counter bumps discarded
        apply_routed(self.store, q, decision,
                     max_scan_results=self.cfg.max_scan_results, scans=False)
        ovf = self.store.overflow.cpu().numpy().astype(np.int64)
        self._last_overflow = int(ovf.sum())
        # per-node overflow floor for capacity-driven splitting
        self._ovf_node_last = ovf

    # -- the device step -----------------------------------------------------
    def _route_chunk(self, q: R.QueryBatch, rng: np.ndarray, dirty, kf,
                     queue_pen):
        """Route one (sub-)batch by the replication mode: ``(decision,
        picked, bounced)``, the last two None outside craq."""
        mp = self.mode_plan
        if mp.dirty_reads:
            dec, self.directory, self.load_reg, picked, bounced = (
                R.route_load_aware_dirty(self.directory, q, self.load_reg,
                                         dirty, rng, queue_pen=queue_pen,
                                         key_filter=kf))
            return dec, picked, bounced
        if mp.spread:
            dec, self.directory, self.load_reg = R.route_load_aware(
                self.directory, q, self.load_reg, rng, queue_pen=queue_pen)
        else:
            dec, self.directory = R.route(self.directory, q)
        return dec, None, None

    def _pre(self, repl, ovl):
        """The routing inputs derived from the pre-epoch state: ``(dirty,
        queue_pen)``.  Reads consult the PRE-epoch dirty bits, as they
        observe the pre-batch store; deep queues repel p2c reads (the
        pre-epoch queue depths join the load registers in the pick
        comparison, the registers bump raw)."""
        mp = self.mode_plan
        ocfg = self.ovl_cfg
        queue_pen = None
        if ocfg is not None and ocfg.queue_weight > 0 and mp.spread:
            queue_pen = K.mul32(ovl.queue.to(torch.int64),
                                ocfg.queue_weight & K.MASK32)
        dirty = RPL.dirty_bits(repl) if mp.dirty_reads else None
        return dirty, queue_pen

    def _oracle_route_apply(self, q: R.QueryBatch, r_route: np.ndarray,
                            dirty, queue_pen, scans: bool):
        """Route the batch (in ``p2c_chunks`` sub-chunks with load-register
        updates between them under p2c) and apply it to the store:
        ``(decision, picked, bounced)``."""
        cfg = self.cfg
        mp = self.mode_plan
        chunks = cfg.p2c_chunks if mp.spread else 1
        kf = (self.repl.key_filter
              if mp.dirty_reads and cfg.craq_filter_bits else None)
        if chunks > 1:
            csize = q.batch // chunks
            parts = []
            for ci in range(chunks):
                sl = slice(ci * csize, (ci + 1) * csize)
                qs = R.QueryBatch(q.opcode[sl], q.key[sl], q.end_key[sl],
                                  q.value[sl])
                parts.append(self._route_chunk(
                    qs, prng.fold_in(r_route, ci), dirty, kf, queue_pen))
            decs = [p[0] for p in parts]
            decision = R.RoutingDecision(*[
                torch.cat([getattr(d, f.name) for d in decs], dim=0)
                for f in dataclasses.fields(R.RoutingDecision)
            ])
            picked = bounced = None
            if mp.dirty_reads:
                picked = torch.cat([p[1] for p in parts])
                bounced = torch.cat([p[2] for p in parts])
        else:
            decision, picked, bounced = self._route_chunk(
                q, r_route, dirty, kf, queue_pen)
        apply_routed(self.store, q, decision,
                     max_scan_results=cfg.max_scan_results, scans=scans)
        return decision, picked, bounced

    def _dist_route_apply(self, q: R.QueryBatch, r_route: np.ndarray, dirty,
                          queue_pen, scans: bool):
        """One epoch through the sharded data plane (``make_dist_apply``):
        ``(decision, picked, bounced, bucket_overflow)``, the last the
        (n,) counts of every source shard."""
        mp = self.mode_plan
        fn = self._dist_apply
        qp = (queue_pen,) if self._dist_cfg.queue_pen else ()
        kw = dict(scans=scans, write_rounds=self._write_rounds(),
                  q_parts=self._q_parts, dir_copies=self._dir_copies)
        if mp.dirty_reads:
            (self.store, _resp, self.directory, self.load_reg, m) = fn(
                self.store, self.directory, self.load_reg, *qp, dirty, q,
                r_route, **kw)
        elif mp.spread:
            (self.store, _resp, self.directory, self.load_reg, m) = fn(
                self.store, self.directory, self.load_reg, *qp, q, r_route,
                **kw)
        else:
            self.store, _resp, self.directory, m = fn(
                self.store, self.directory, q, **kw)
        self.exchange_rounds += int(m["a2a_rounds"])   # a host count
        decision = R.RoutingDecision(
            ridx=m["ridx"], target=m["target"], chain=m["chain"],
            chain_len=m["chain_len"], clength=torch.zeros_like(m["target"]))
        return (decision, m.get("picked"), m.get("bounced"),
                m["bucket_overflow_shards"])

    def _write_rounds(self) -> int:
        """The longest chain of any slot, from the controller's host
        tables (which the device directory follows between pulls): the
        dist plane's write rounds past it would be empty."""
        return int(self.controller.chain_lengths().max())

    def _step(self, q: R.QueryBatch, rng: np.ndarray, scans: bool, eid: int):
        """One epoch's device work, for both backends and both loops.
        ``scans``: the batch holds a SCAN (known on the host from the
        generated opcodes); ``eid``: the epoch, at which the tier's staged
        tables install.  Updates the carries; returns ``(plan, node_ops,
        bounced, cstats, ostats, spans, bucket_overflow)``: ``bounced``
        None outside craq, ``cstats`` (5,) None without the tier,
        ``ostats`` (7,) int32 None without the overload plane, ``spans``
        the trace plane's span table ``(span_i, span_f, counts)`` (None
        without it), ``bucket_overflow`` the dist backend's (n,) per-shard
        counts (None on the oracle).  With the metrics plane the step also
        writes the epoch's ring row."""
        mp = self.mode_plan
        # fold_in, not a wider split: the routing and hop-plan streams stay
        # those of the overload plane switched off
        r_ovl = (prng.fold_in(rng, 0x0F10AD) if self.ovl_cfg is not None
                 else rng)
        r_route, r_plan = prng.split(rng)
        dirty, queue_pen = self._pre(self.repl, self.ovl)
        bucket_ovf = None
        if self.backend == "dist":
            decision, picked, bounced, bucket_ovf = self._dist_route_apply(
                q, r_route, dirty, queue_pen, scans)
        else:
            decision, picked, bounced = self._oracle_route_apply(
                q, r_route, dirty, queue_pen, scans)
        if not mp.dirty_reads:
            # placeholders keep observe's signature mode-independent
            picked = decision.target
            bounced = torch.zeros(q.batch, dtype=torch.bool,
                                  device=self.device)
        (self.sketch, plan, node_ops, self.repl, self.ovl, self.coord,
         self.metrics, ostats, cstats, spans) = self._observe_epoch(
            q, decision.ridx, decision.target, decision.chain,
            decision.chain_len, self.sketch, r_plan, self.repl, picked,
            bounced, self.ovl, r_ovl, eid, self.coord, self.metrics)
        if not mp.spread:
            # tail-read path: registers tracked in the same units
            self.load_reg = K.u32(self.load_reg + node_ops)
        return (plan, node_ops, bounced if mp.dirty_reads else None, cstats,
                ostats, spans, bucket_ovf)

    def _observe_epoch(self, q, ridx, target, chain, chain_len, sketch, rng,
                       repl, picked, bounced, ovl, r_ovl, eid, coord,
                       metrics):
        """The observe stage: everything after the route and the store
        apply, on the whole batch's decision (per-node op counts, the
        sketch, the overload step, the tier's accounting, the hop plan,
        the register advance, the span table, the metrics row).  A pure
        function of its arguments, shared by both backends and by the
        per-epoch and period loops (the reference's dist observe)::

            -> (sketch, plan, node_ops, repl, ovl, coord, metrics,
                ostats, cstats, spans)

        The overload step decides each query's timing fate (the store
        applied every op regardless); its pre-step state is the admission
        context the span table records.  The switch tier observes the
        batch against its (possibly stale) copies: accounting only, the
        decision followed the true tables, so the tier reprices hops and
        counts."""
        cfg = self.cfg
        N = cfg.num_nodes
        mp = self.mode_plan
        ocfg = self.ovl_cfg
        tcfg = self.tel_cfg
        dev = self.device
        decision = R.RoutingDecision(ridx=ridx, target=target, chain=chain,
                                     chain_len=chain_len,
                                     clength=torch.zeros_like(target))
        node_ops = _node_ops(decision, q.opcode, N)
        sketch = sketch_update(sketch, q.key)
        bounce_kw = (dict(read_via=picked, read_bounce=bounced)
                     if mp.dirty_reads else {})
        ostats = outcome = scale = first_epoch = None
        ovl_pre = ovl
        if ocfg is not None:
            ovl, rejected, scale, outcome, ostats = OVL.step(
                ovl, target, r_ovl, ocfg)
            bounce_kw.update(shed=rejected, service_scale=scale)
            if tcfg is not None:
                # cross-epoch retry linking: stamp / clear the hashed
                # orbit-identity register (a no-op at the placeholder)
                ovl, first_epoch = OVL.link_orbit(
                    ovl, q.key, rejected, outcome == OVL.OUTCOME_ADMITTED,
                    eid)
        cstats = redirect = None
        if self.coord_cfg is not None:
            coord, redirect, redirect_via, cstats = CT.observe_epoch(
                coord, q, decision, eid, quorum=self.coord_cfg.quorum,
                hash_partitioned=self.directory.hash_partitioned,
            )
            bounce_kw.update(redirect=redirect, redirect_via=redirect_via)
        plan = plan_hops(
            q, decision, cfg.mode, cfg.latency, rng=rng, num_nodes=N,
            write_chain_cap=mp.write_cap_spread if mp.spread else None,
            service_model=cfg.service_model, **bounce_kw,
        )
        if mp.track_state:
            is_write = (q.opcode == K.OP_PUT) | (q.opcode == K.OP_DEL)
            repl = RPL.advance(
                repl, ridx, is_write,
                keys=q.key if cfg.craq_filter_bits else None)
        spans = None
        if tcfg is not None:
            spans = self._spans(q, eid, decision, picked, bounced, redirect,
                                ovl_pre, outcome, scale, first_epoch, plan)
        if metrics is not None:
            # end-of-epoch state: post-step ovl, post-observe coord,
            # post-advance repl (like the flight ring's snapshots)
            metrics = MTR.record_epoch(
                metrics, node_ops=node_ops, ovl=ovl,
                ostats=(ostats if ostats is not None else torch.zeros(
                    len(OVL.STAT_FIELDS), dtype=torch.int32, device=dev)),
                cstats=(cstats if cstats is not None
                        else CT.empty_cstats(dev)),
                coord=coord, repl=repl, sketch=sketch,
                keys=q.key, ridx=ridx, topk=self.met_layout.topk)
        return (sketch, plan, node_ops, repl, ovl, coord, metrics, ostats,
                cstats, spans)

    def _spans(self, q, eid, decision, picked, bounced, redirect, ovl_pre,
               outcome, scale, first_epoch, plan):
        """The epoch's span table: each query's admission context comes
        from the PRE-step overload state (queue depth at its target, the
        deepest occupied retry level there), as routing observes the
        pre-epoch store.  A versioned redirect rides the span's bounce
        flag (an extra pre-serve hop), while the metric stream's bounced
        column stays CRAQ-only."""
        B = q.batch
        N = self.cfg.num_nodes
        dev = self.device
        span_bounced = bounced if redirect is None else bounced | redirect
        if ovl_pre is not None:
            t_safe = torch.clamp(decision.target, 0, N - 1)
            qdepth = ovl_pre.queue[t_safe]
            Lv = ovl_pre.retry.shape[1]
            levels = torch.arange(1, Lv + 1, dtype=torch.int32, device=dev)
            orbit = (torch.where(ovl_pre.retry > 0, levels[None, :], 0)
                     .amax(dim=1) - 1)[t_safe]
        else:
            qdepth = torch.zeros(B, dtype=torch.int32, device=dev)
            orbit = torch.full((B,), -1, dtype=torch.int32, device=dev)
            outcome = torch.where(decision.target >= 0, OVL.OUTCOME_ADMITTED,
                                  OVL.OUTCOME_INVALID).to(torch.int32)
            scale = torch.ones(B, dtype=torch.float32, device=dev)
        return TEL.collect_spans(
            q, eid, decision, picked, span_bounced, outcome, qdepth, orbit,
            scale, plan, threshold=self._tel_threshold,
            k_slots=self.tel_cfg.max_spans, lookup=self.cfg.latency.lookup,
            first_epoch=first_epoch)

    def _build_dist_period(self):
        """The fused dist period program (``make_dist_period``): the
        bucket plane and the observe stage, epoch after epoch, with the
        routing inputs derived from the carried state in between."""
        return make_dist_period(
            self._mesh, self.directory, self._dist_cfg, pre=self._pre,
            observe=self._observe_epoch,
            fold_ovl=self.ovl_cfg is not None)

    # -- control -----------------------------------------------------------
    def _handle_events(self, e: int) -> tuple[list[str], int, int]:
        """Apply the scenario's control events for epoch ``e``."""
        scfg = self.scenario.cfg
        events: list[str] = []
        mig_entries = mig_bytes = 0
        tables_changed = False
        for kind, node in self.scenario.events(e):
            if kind == "fail":
                nl = self._sync(D.node_load(self.directory))
                ops = self.controller.handle_node_failure(node, nl)
                en, by = migration_traffic(self.store, ops, scfg.value_dim)
                execute_migrations(self.store, ops)
                self.directory = self.controller.refresh(self.directory)
                self._replicate()
                mig_entries += en
                mig_bytes += by
                tables_changed = True
                events.append(f"fail:{node}")
            elif kind == "rack_fail":
                rack = [int(n) for n in node]
                ops = self.controller.handle_switch_failure(rack)
                en, by = migration_traffic(self.store, ops, scfg.value_dim)
                execute_migrations(self.store, ops)
                self.directory = self.controller.refresh(self.directory)
                self._replicate()
                mig_entries += en
                mig_bytes += by
                tables_changed = True
                events.append("rack_fail:" + "+".join(map(str, rack)))
            elif kind == "recover":
                self.controller.recover_node(node)
                events.append(f"recover:{node}")
            elif kind in CT.EVENT_KINDS:
                # coordination-plane faults, ignored without the tier
                if self.coord_mgr is not None:
                    events.extend(self._coord_control(
                        self.coord_mgr.on_event, kind, node, now=e))
            else:
                raise ValueError(f"unknown scenario event {kind!r}")
        self._sync_repl()
        if self.coord_mgr is not None and tables_changed:
            # a failure splice is a control write like any other: it
            # propagates along the switch chain
            events.extend(self._coord_control(self.coord_mgr.on_control,
                                              now=e))
        return events, mig_entries, mig_bytes

    def _coord_control(self, method, *args, now: int) -> list[str]:
        """Run a CoordManager control call on the current tables and state
        (timed as the ``coord_control`` part of the control stage); returns
        its notes."""
        t0 = time.perf_counter()
        self.coord, notes = method(*args, self.coord,
                                   self.controller.table_snapshot(), now=now)
        self.timers.lap("coord_control", t0)
        return notes

    def _sync_repl(self) -> None:
        """Replay the controller's reconfiguration journal onto the
        register file (``replication.apply_events``).  The journal is
        always drained, so it cannot grow without bound; only chain and
        craq pay the host round trip, and only when there are events."""
        events = self.controller.drain_repl_log()
        if events and self.mode_plan.track_state:
            self.host_syncs += 1   # apply_events pulls the register file
            self.repl = RPL.apply_events(self.repl, events)

    def _ovl_view(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The tensors of the overload registers the pull reads: each
        node's queue depth and retry backlog."""
        return self.ovl.queue, self.ovl.retry.sum(dim=1, dtype=torch.int32)

    def _control_pull(self, now: int, ovl_view=None
                      ) -> tuple[list[str], int, int]:
        """The period-boundary pull: harvest + reset counters, run the
        policy, execute its plan, graft the refreshed tables.
        ``ovl_view``: the overload registers' host view (queue depths,
        retry backlogs), when the caller's copy home already brought it;
        else it is read here."""
        scfg = self.scenario.cfg
        self.host_syncs += 1   # pull_report harvests the device counters
        report, self.directory = pull_report(self.directory, self._period)
        self._period += 1
        if self._key_window.size:
            sample = self._key_window
            heat = self._sketch_heat(sample)
            report = dataclasses.replace(report, key_sample=sample,
                                         key_heat=heat)
            self._key_window = np.empty(0, np.uint32)
        if self.mode_plan.spread:
            # under p2c spreading the load registers are the truthful
            # per-node picture
            report = dataclasses.replace(
                report, node_load=self._sync(self.load_reg).astype(np.float64)
            )
        if self.ovl is not None:
            # the queue / retry view for the backpressure policies
            if ovl_view is None:
                self.host_syncs += 1
                ovl_view = _to_host(list(self._ovl_view()))
            qd, rb = ovl_view
            report = dataclasses.replace(
                report,
                queue_depth=qd.astype(np.int64),
                retry_backlog=rb.astype(np.int64),
                queue_limit=int(self.ovl_cfg.queue_cap),
                service_limit=int(self.ovl_cfg.service_rate),
            )
        if self.auto_period:
            span = max(now - self._last_pull_epoch, 1)
            report = dataclasses.replace(
                report,
                budget_scale=float(span) / float(self.cfg.auto_band[0]),
            )
        events: list[str] = []
        rb = getattr(self.policy.config, "redirect_backoff", 0.0)
        if rb > 0 and self._last_redirect_share > rb:
            # the switch fabric is still digesting the last
            # reconfiguration: skip this round's policy consult, so control
            # churn stops widening the stale window
            ops = []
            events.append(f"redirect_backoff:{self._last_redirect_share:.3f}")
        else:
            ops = self.policy.on_report(self.controller, report)
        if self.ovl is not None:
            # the backpressure control channel: the policy's admission
            # probabilities and retry budgets go onto the device registers
            # for the next period
            ap = getattr(self.policy, "admit_prob", None)
            if ap is not None:
                self.ovl = dataclasses.replace(
                    self.ovl, admit_prob=torch.as_tensor(
                        np.asarray(ap, np.float32), device=self.device))
            rbud = getattr(self.policy, "retry_budget", None)
            if rbud is not None:
                self.ovl = dataclasses.replace(
                    self.ovl, retry_budget=torch.as_tensor(
                        np.asarray(rbud).astype(np.int32), device=self.device))
        notes = getattr(self.policy, "notes", None)
        if notes:
            events.extend(notes)
            notes.clear()
        mig_entries = mig_bytes = 0
        if ops:
            mig_entries, mig_bytes = migration_traffic(self.store, ops,
                                                       scfg.value_dim)
            execute_migrations(self.store, ops)
            events.extend(f"{op.kind}:{op.src}->{op.dst}" for op in ops)
        if self.cfg.split_overflow:
            sops = self._capacity_splits(report)
            if sops:
                en, by = migration_traffic(self.store, sops, scfg.value_dim)
                execute_migrations(self.store, sops)
                mig_entries += en
                mig_bytes += by
                events.extend(f"{op.kind}:{op.src}->{op.dst}" for op in sops)
        grew = self.controller.num_slots != self.directory.chains.shape[0]
        if grew:
            # the slot pool grew under split_overflowed: every table held
            # per slot changes shape, so refresh refuses; rebuild the
            # directory (this pull just harvested and reset the counters,
            # so pending merge credits would land on zeros: drop them)
            self.controller.drop_credits()
            self.directory = self.controller.directory()
            self.growth_events += 1
            events.append(f"grow_pool:{self.controller.num_slots}")
        else:
            self.directory = self.controller.refresh(self.directory)
        self._replicate()
        self._sync_repl()
        if self.coord_mgr is not None:
            if grew:
                # every switch re-registers at the new width
                t0 = time.perf_counter()
                self.coord = self.coord_mgr.rebuild(
                    self.controller.table_snapshot())
                self.timers.lap("coord_control", t0)
            else:
                # the period's control writes enter the switch chain:
                # commit now, install per switch with its chain-position
                # lag
                events.extend(self._coord_control(self.coord_mgr.on_control,
                                                  now=now))
        if self.auto_period and now < self.scenario.cfg.n_epochs:
            nl = np.asarray(report.node_load, np.float64)
            if self.mode_plan.spread:
                self._auto_retune(nl - self._reg_floor, now)
                self._reg_floor = np.floor_divide(nl, 2)
            else:
                self._auto_retune(nl, now)
        # halve rather than zero: p2c needs recent load signal
        self.load_reg = self.load_reg // 2
        self.sketch = torch.zeros_like(self.sketch)
        return events, mig_entries, mig_bytes

    def _capacity_splits(self, report) -> list:
        """Capacity-driven splitting (paper §4.1.1): for each node whose
        store overflowed since the last pull, split the hottest live range
        it heads (``Controller.split_overflowed``, which grows the slot
        pool when it runs out)."""
        ovf = self._sync(self.store.overflow).astype(np.int64)
        delta = ovf - self._ovf_node_last
        self._ovf_node_last = ovf
        hot_nodes = [int(n) for n in np.argsort(-delta) if delta[n] > 0]
        if not hot_nodes:
            return []
        heat = (report.read_count + report.write_count).astype(np.float64)
        ctl = self.controller
        ops = []
        for node in hot_nodes:
            cands = [r for r in ctl.live_ranges()
                     if int(ctl.chain_nodes(r)[0]) == node]
            if not cands:
                continue
            # ranges born mid-loop (after the harvest) carry no heat yet
            ridx = max(cands,
                       key=lambda r: heat[r] if r < heat.size else 0.0)
            ops.extend(ctl.split_overflowed(ridx, report.node_load))
        return ops

    def _auto_retune(self, node_load: np.ndarray, now: int) -> None:
        """Adaptive pull cadence from report-to-report load drift."""
        cfg = self.cfg
        lo, hi = int(cfg.auto_band[0]), int(cfg.auto_band[1])
        span = max(now - self._last_pull_epoch, 1)
        load = np.asarray(node_load, np.float64) / span
        prev = self._prev_load
        if prev is not None:
            mass = max(prev.sum(), 1e-9)
            drift = float(np.abs(load - prev).sum() / mass)
            if drift > cfg.auto_drift_hi:
                self._cur_period = max(lo, self._cur_period // 2)
            elif drift < cfg.auto_drift_lo:
                self._cur_period = min(hi, self._cur_period * 2)
        self._prev_load = load
        self._last_pull_epoch = now
        self._next_pull = now + self._cur_period
        self.period_history.append(self._cur_period)

    # -- metric rows -------------------------------------------------------
    @staticmethod
    def _fold_pull(row: EpochMetrics, pull: tuple) -> None:
        """Charge a control pull's events and migration traffic to the
        epoch that ended the period."""
        events, entries, nbytes = pull
        row.events.extend(events)
        row.migration_entries += entries
        row.migration_bytes += nbytes

    def _rows(self, e0: int, lat: np.ndarray, mks: np.ndarray,
              node_ops_h: np.ndarray, ovf_h: np.ndarray, opcodes_h: np.ndarray,
              bounced_h: np.ndarray | None, cst_h: np.ndarray | None,
              ost_h: np.ndarray | None, bov_h: np.ndarray | None,
              head: tuple) -> list[EpochMetrics]:
        """EpochMetrics rows for a segment of ``L`` epochs, computed before
        the period's pull (the live mask is the segment's); ``bounced_h``
        is the (L, B) craq tail-bounce mask (None outside craq), ``cst_h``
        the (L, 5) tier counters (None without the tier), which also set
        the redirect share the pull's backoff reads, ``ost_h`` the (L, 7)
        overload counters (None without the plane), ``bov_h`` the dist
        backend's (L, n) bucket overflow per source shard (None on the
        oracle; the rows' ``retries`` is the first shard's); ``head``
        carries the segment-start events and migration traffic."""
        cfg = self.cfg
        scfg = self.scenario.cfg
        L = lat.shape[0]
        if cst_h is None:
            cst_h = np.zeros((L, len(CT.CSTAT_FIELDS)), np.int64)
        else:
            cst_h = cst_h.astype(np.int64)
            seg_routed = int(cst_h[:, 0].sum())
            if seg_routed > 0:
                self._last_redirect_share = (float(cst_h[:, 2].sum())
                                             / seg_routed)
        if ost_h is None:
            ost_h = np.zeros((L, len(OVL.STAT_FIELDS)), np.int64)
        retries = np.zeros(L, np.int64)
        if bov_h is not None:
            retries = bov_h[:, 0].astype(np.int64)
            self.bucket_overflow_total += int(bov_h.sum())
        p50s, p99s = latency_percentiles_batch(lat)
        p999s = p999_batch(lat)
        is_read = (opcodes_h == K.OP_GET) | (opcodes_h == K.OP_SCAN)
        if bounced_h is None:
            bounced_h = np.zeros_like(is_read)
        read_p99s = masked_p99_batch(lat, is_read)
        clean_p99s = masked_p99_batch(lat, is_read & ~bounced_h)
        dirty_counts = bounced_h.sum(axis=1)
        imbs, covs = imbalance_stats_batch(node_ops_h, self._live_mask())
        drops = np.diff(ovf_h, prepend=np.int64(self._last_overflow))
        self._last_overflow = int(ovf_h[-1])
        rows = []
        for i in range(L):
            mk = float(mks[i])
            events, mig_entries, mig_bytes = head if i == 0 else ([], 0, 0)
            rows.append(EpochMetrics(
                epoch=e0 + i,
                scenario=self.scenario.name,
                policy=self.policy.name,
                ops=scfg.epoch_ops,
                throughput=scfg.epoch_ops / mk if mk > 0 else 0.0,
                p50=float(p50s[i]),
                p99=float(p99s[i]),
                makespan=mk,
                imbalance=float(imbs[i]),
                cov=float(covs[i]),
                migration_entries=mig_entries,
                migration_bytes=mig_bytes,
                drops=int(drops[i]),
                retries=int(retries[i]),
                compiled_steps=1 + self.growth_events,
                events=events,
                p999=float(p999s[i]),
                read_p99=float(read_p99s[i]),
                clean_read_p99=float(clean_p99s[i]),
                dirty_reads=int(dirty_counts[i]),
                replication=cfg.replication_mode,
                deferred=int(ost_h[i, 2]),
                shed=int(ost_h[i, 3]),
                requeued=int(ost_h[i, 4]),
                lost=int(ost_h[i, 5]),
                queue_peak=int(ost_h[i, 6]),
                routed=int(cst_h[i, 0]),
                direct=int(cst_h[i, 1]),
                redirected=int(cst_h[i, 2]),
                mis_served=int(cst_h[i, 3]),
                stale_switches=int(cst_h[i, 4]),
                coordination=self._coord_label(),
            ))
        return rows

    def _coord_label(self) -> str:
        """The row's coordination arm ("none" when the tier is off)."""
        if self.coord_cfg is None:
            return "none"
        return "quorum" if self.coord_cfg.quorum else "no-quorum"

    def overload_summary(self) -> dict:
        """Host snapshot of the overload plane (empty when it is off)."""
        if self.ovl is None:
            return {}
        return OVL.summary(self.ovl)

    def _time(self, plan: HopPlan):
        """DES timing: ``(latency, makespans, issue, hops)``, the last two
        (each query's issue time and per-hop completion times) only with
        the trace plane, else None."""
        cfg = self.cfg
        out = simulate_closed_loop(
            plan, n_clients=cfg.n_clients, num_nodes=cfg.num_nodes,
            link=cfg.latency.link, return_issue=self.telemetry is not None,
            return_hops=self.telemetry is not None, backend=cfg.des_backend,
        )
        latency, makespan, *extra = out
        issue, hops = extra if extra else (None, None)
        return latency.numpy(), np.atleast_1d(makespan.numpy()), issue, hops

    # -- the observability planes ------------------------------------------
    def _state_snapshot(self, extra: tuple = ()) -> tuple[dict, list]:
        """Host view of the carried state for the flight-recorder ring, and
        the host copies of ``extra`` tensors, in one device-to-host copy
        (the caller counts it)."""
        ts = [self.load_reg, *extra]
        ovl = self.ovl
        if ovl is not None:
            ts += [ovl.queue, torch.stack([
                ovl.cum_injected, ovl.cum_admitted, ovl.cum_requeued,
                ovl.cum_deferred, ovl.cum_lost,
                ovl.retry.sum(dtype=torch.int32)])]
        track = self.mode_plan.track_state
        if track:
            ts += [RPL.dirty_bits(self.repl), self.repl.version]
        host = _to_host(ts)
        snap: dict = {"load_reg": host[0].astype(np.int64).tolist()}
        at = 1 + len(extra)
        if ovl is not None:
            inj, adm, req, dfr, lost, backlog = host[at + 1].tolist()
            snap["queue_depth"] = host[at].tolist()
            snap["retry_backlog"] = backlog
            snap["conservation_gap"] = inj - (adm + req + dfr + lost + backlog)
            at += 2
        if track:
            snap["replication"] = RPL.summary_of(host[at], host[at + 1])
        if self.coord_mgr is not None:
            snap["coordination"] = self.coord_mgr.summary()
        return snap, host[1:1 + len(extra)]

    def _observe(self, e0: int, rows: list[EpochMetrics], lat, issue,
                 makespans, hops, spans, t0: float) -> None:
        """Segment-end work of the two planes, after the pull: attribute
        and archive the spans (``spans``: host ``(span_i, span_f, counts)``
        stacks, or device tensors of one epoch), then fold the DES columns
        into the ring and evaluate the SLO burn rates.  The spans go
        first: a burn alert's flight dump must already hold its
        segment."""
        if self.telemetry is not None:
            on_device = isinstance(spans[0], torch.Tensor)
            snap, host = self._state_snapshot(spans if on_device else ())
            self.host_syncs += 1   # the state snapshot (and one epoch's spans)
            si, sf, cnt = ([h[None] for h in host] if on_device else spans)
            self.telemetry.on_segment(e0, rows, si, sf, cnt, lat, issue,
                                      makespans, snap, hops=hops)
            t0 = self.timers.lap("telemetry", t0)
        if self.metrics is not None:
            L = len(rows)
            vals = np.array([[r.p50, r.p99, r.p999, r.imbalance]
                             for r in rows], np.float64)
            self.metrics = MTR.fold_host(self.metrics, self._met_pos, vals,
                                         self.met_layout.host_cols)
            self._met_pos += L
            if self.met_cfg.slos:
                res = SLOM.evaluate_segment(self.metrics, self.met_layout,
                                            self.met_cfg.slos, L)
                self.host_syncs += 1   # the burn-rate arrays come home
                self.met_engine.observe(e0, res)
            self.timers.lap("metrics", t0)

    def _on_slo_fire(self, spec, ev: dict) -> None:
        """Rising-edge hook: a burn alert is an invariant breach, so it
        dumps the flight ring with the SLO context in the reason."""
        if self.telemetry is not None:
            self.telemetry.breach(
                f"slo_burn:{spec.name}:epoch {ev['epoch']} "
                f"value {ev['value']:.2f} > {spec.bound} "
                f"fast {ev['fast_burn']:.2f} slow {ev['slow_burn']:.2f}"
            )

    def metrics_view(self) -> dict:
        """Chronological host view of the metrics ring (one copy home)."""
        if self.metrics is None:
            raise ValueError("metrics plane disabled (metrics=None)")
        self.host_syncs += 1
        return MTR.series_view(self.metrics, self.met_layout)

    def alert_timeline(self) -> list[dict]:
        """The SLO alert timeline so far (empty when no SLO fired)."""
        if self.met_engine is None:
            return []
        return list(self.met_engine.timeline)

    # -- the per-epoch reference loop --------------------------------------
    def run_epoch(self, e: int) -> EpochMetrics:
        """One epoch, one host round-trip (the ``fused=False`` loop)."""
        if self.fused:
            raise RuntimeError(
                "per-epoch stepping is unavailable on a fused driver; "
                "use run(), or construct with fused=False"
            )
        t0 = time.perf_counter()
        head = self._handle_events(e)
        t0 = self.timers.lap("control", t0)
        opcodes, q = self._queries(e)
        t0 = self.timers.lap("inject", t0)
        plan, node_ops, bounced, cstats, ostats, spans, bovf = self._timed(
            self._step, q, prng.fold_in(self.key, e),
            bool((opcodes == K.OP_SCAN).any()), e)
        self.timers.block(self.device)
        t0 = self.timers.lap("route_apply", t0)
        self.host_syncs += 1   # the DES engine pulls the plan to the host
        lat, mks, issue, hops = self._time(plan)
        t0 = self.timers.lap("des", t0)
        node_ops_h = self._sync(node_ops)[None]
        ovf_h = np.array([int(self._sync(self.store.overflow).sum())], np.int64)
        bounced_h = None if bounced is None else self._sync(bounced)[None]
        cst_h = None if cstats is None else self._sync(cstats)[None]
        ost_h = None if ostats is None else self._sync(ostats)[None]
        bov_h = None if bovf is None else self._sync(bovf)[None]
        self._fold_step_events()
        (row,) = self._rows(e, lat[None], mks, node_ops_h, ovf_h,
                            opcodes[None], bounced_h, cst_h, ost_h, bov_h,
                            head)
        pulled = ((e + 1) == self._next_pull if self.auto_period
                  else (e + 1) % self.period == 0)
        if pulled:
            self._fold_pull(row, self._control_pull(e + 1))
        t0 = self.timers.lap("control", t0)
        self._observe(e, [row], lat[None], None if issue is None else
                      issue[None], mks, None if hops is None else hops[None],
                      spans, t0)
        return row

    # -- the fused period loop ---------------------------------------------
    def _segment_len(self, e0: int, n: int) -> int:
        """Epochs until the next host intervention: the period boundary,
        the run end, or the next scenario control event."""
        if self.auto_period:
            next_pull = self._next_pull
        else:
            next_pull = ((e0 // self.period) + 1) * self.period
        end = min(next_pull, e0 + self.period, n)
        for e2 in range(e0 + 1, end):
            if e2 in self._event_epochs:
                return e2 - e0
        return max(end - e0, 1)

    def _oracle_segment(self, e0: int, L: int, t0: float):
        """The segment's epochs one device step after another, each batch
        generated just before its step: the stacked outputs (as
        :meth:`_dist_segment`) and the stage clock."""
        outs, op_l = [], []
        for i in range(L):
            opcodes, q = self._queries(e0 + i)
            t0 = self.timers.lap("inject", t0)
            op_l.append(opcodes)
            plan, node_ops, bounced, cstats, ostats, spans, _ = self._timed(
                self._step, q, prng.fold_in(self.key, e0 + i),
                bool((opcodes == K.OP_SCAN).any()), e0 + i)
            self.timers.block(self.device)
            outs.append((plan, node_ops, None, self.store.overflow.sum(),
                         bounced, ostats, cstats, spans))
            t0 = self.timers.lap("route_apply", t0)
        return [stack_epochs([o[k] for o in outs]) for k in range(8)], op_l, t0

    def _dist_segment(self, e0: int, L: int, t0: float):
        """The segment through the fused dist period program in one call.
        Its batches come from a generator, so each is made while the
        device runs the epoch before it (as in the oracle loop); on CUDA
        the generator also records each epoch's pair of step events
        around the device work the program enqueues for it."""
        op_l, scans = [], []
        clock = [t0]
        cuda = self.device.type == "cuda"

        def step_event():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev

        def batches():
            start = None
            for e in range(e0, e0 + L):
                # the previous epoch's enqueue, then this batch
                if start is not None:
                    self._step_events.append((start, step_event()))
                clock[0] = self.timers.lap("route_apply", clock[0])
                opcodes, q = self._queries(e)
                op_l.append(opcodes)
                scans.append(bool((opcodes == K.OP_SCAN).any()))
                clock[0] = self.timers.lap("inject", clock[0])
                start = step_event() if cuda else None
                yield q if self._q_parts is None else (q, self._q_parts)
            if start is not None:
                self._step_events.append((start, step_event()))

        (self.store, self.directory, self.load_reg, self.sketch, self.repl,
         self.ovl, self.coord, self.metrics, rounds, *outs) = self._period_fn(
            self.store, self.directory, self.load_reg, self.sketch,
            self.repl, self.ovl, self.coord, self.metrics, batches(),
            [prng.fold_in(self.key, e) for e in range(e0, e0 + L)],
            list(range(e0, e0 + L)), scans=scans,
            write_rounds=self._write_rounds(), dir_copies=self._dir_copies)
        self.exchange_rounds += rounds
        self.timers.block(self.device)
        t0 = self.timers.lap("route_apply", clock[0])
        return outs, op_l, t0

    def _run_segment(self, e0: int, n: int) -> list[EpochMetrics]:
        t0 = time.perf_counter()
        head = self._handle_events(e0)
        t0 = self.timers.lap("control", t0)
        L = self._segment_len(e0, n)
        seg = self._dist_segment if self._period_fn is not None else (
            self._oracle_segment)
        (plans, nops, bovf, ovfs, bncs, osts, csts, spns), op_l, t0 = seg(
            e0, L, t0)
        # ---- ONE device-to-host copy for the whole segment ----
        self.host_syncs += 1
        # (the overload counters, the registers a pull reads, the span
        # tables and the dist backend's bucket overflow ride it)
        craq = self.mode_plan.dirty_reads
        tier = self.coord is not None
        ovl = self.ovl is not None
        traced = self.telemetry is not None
        dist = bovf is not None
        nodes, service, reply, node_ops_h, ovf_h, *extra = _to_host([
            plans.nodes, plans.service, plans.reply_links, nops, ovfs,
            *([bncs] if craq else []),
            *([csts] if tier else []),
            *([osts, *self._ovl_view()] if ovl else []),
            *([bovf] if dist else []),
            *(spns if traced else []),
        ])
        spans_h = tuple(extra[-3:]) if traced else None
        if traced:
            del extra[-3:]
        bov_h = extra.pop() if dist else None
        bounced_h = extra.pop(0) if craq else None
        cst_h = extra.pop(0) if tier else None
        ost_h = extra.pop(0) if ovl else None
        ovl_view = tuple(extra) if ovl else None
        self._fold_step_events()
        lat, mks, issue, hops = self._time(HopPlan(torch.from_numpy(nodes),
                                                   torch.from_numpy(service),
                                                   torch.from_numpy(reply)))
        t0 = self.timers.lap("des", t0)
        rows = self._rows(e0, lat, mks, node_ops_h, ovf_h, np.stack(op_l),
                          bounced_h, cst_h, ost_h, bov_h, head)
        pulled = ((e0 + L) == self._next_pull if self.auto_period
                  else (e0 + L) % self.period == 0)
        if pulled:
            self._fold_pull(rows[-1], self._control_pull(e0 + L, ovl_view))
        t0 = self.timers.lap("control", t0)
        self._observe(e0, rows, lat, issue, mks, hops, spans_h, t0)
        return rows

    def segments(self):
        """Run the scenario, yielding each segment's rows as it ends: a
        segment ends at a control pull, a scenario event or the run's end
        (one epoch a segment in the per-epoch loop)."""
        n = self.scenario.cfg.n_epochs
        if not self.fused:
            for e in range(n):
                yield [self.run_epoch(e)]
            return
        e = 0
        while e < n:
            rows = self._run_segment(e, n)
            yield rows
            e = rows[-1].epoch + 1

    def run(self) -> list[EpochMetrics]:
        """Run the scenario; with the trace plane's ``trace_dir`` set, under
        ``torch.profiler``, whose Chrome trace lands in that directory."""
        tdir = self.tel_cfg.trace_dir if self.tel_cfg is not None else None
        if not tdir:
            return [row for rows in self.segments() for row in rows]
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            rows = [row for rows in self.segments() for row in rows]
        os.makedirs(tdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            tdir, f"trace_{self.scenario.name}_{self.policy.name}.json"))
        return rows
