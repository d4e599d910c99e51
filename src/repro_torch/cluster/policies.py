"""The balancing-policy zoo (control plane of the closed loop, §5.1).

A copy of ``repro.cluster.policies`` for the port (numpy only).

A policy consumes the controller pull (:class:`~repro_torch.core.stats.StatsReport`
plus the count-min key-heat view) and mutates the controller's tables,
returning the migration plan the data movers execute.  Four knobs exist,
and each policy turns a different subset:

* **migration** — the paper's hottest-range -> coolest-node greedy move
  (``Controller.balance``);
* **selective replication** — widen the chain of sketch-identified hot
  ranges (``Controller.widen_chain``), narrow them again when they cool;
* **read spreading** — route GETs by power-of-two-choices over the live
  chain (``routing.route_load_aware``) instead of tail-only.  This is a
  *data-plane* knob: the policy only declares it (``read_spread``), the
  epoch driver compiles the matching step variant;
* **hot-subset splitting** — the paper's §5.1 "a subset of the hot data":
  split a hot range at a count-min heat quantile
  (``Controller.split_range``; the split itself moves no data) so
  subsequent moves/replicas touch only the hot child's keys, and merge
  the child back (``Controller.merge_range``) with hysteresis once its
  heat subsides.

The bench compares ``frozen`` (directory never changes — the no-switch
baseline), ``migrate`` (paper behaviour), ``replicate`` (widen + spread,
no moves), ``split_hot`` (split + migrate — whole-range moves replaced by
hot-subset moves) and ``full_adaptive`` (everything on).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.controller import Controller
from repro_torch.core.migration import MigrationOp
from repro_torch.core.stats import StatsReport


@dataclasses.dataclass
class PolicyConfig:
    # widen a range when its heat *per live replica* exceeds this multiple
    # of the mean range heat
    hot_factor: float = 1.5
    # cap on replicas added per report (hottest ranges first)
    max_widen_per_round: int = 8
    # shrink a widened chain when its heat falls back under the mean
    narrow_below_mean: bool = True
    # chains never shrink below this (the configured replication factor)
    base_replication: int = 2

    # ---- hot-subset splitting (slot-pool) ----
    # split a range when its heat exceeds this multiple of the live mean
    split_factor: float = 2.0
    # cap on splits per report (hottest ranges first)
    max_splits_per_round: int = 4
    # never split a span narrower than this many matching values
    min_split_span: int = 4096
    # merge hysteresis: a child is "cool" when its heat drops below this
    # multiple of the live mean ...
    merge_factor: float = 0.75
    # ... for this many consecutive reports
    merge_patience: int = 2
    # lineage compaction: re-parent dangling/deep split lineage each
    # report so `generation` stays bounded (Controller.compact_lineage).
    # On by default: rescued orphans merge where they previously could
    # not, keeping long adversarial split runs from growing the lineage
    # without bound.  Set to None to leave lineage untouched (the pre-PR-8
    # behaviour, bit-comparable with the PR-3/4 gate-matrix rows).
    max_lineage_depth: int | None = 3

    # ---- overload backpressure (repro.overload; OverloadAdaptivePolicy) ----
    # AIMD admission control on queue occupancy (depth / queue_limit):
    admit_hi: float = 0.75        # above -> multiplicative decrease
    admit_lo: float = 0.25        # below -> additive recovery
    admit_decrease: float = 0.5   # the multiplicative cut
    admit_increase: float = 0.1   # the additive step back toward 1.0
    admit_floor: float = 0.05     # never fully closed (probes recovery)
    # retry budget as a fraction of the per-epoch service rate: caps how
    # much of a synchronized backlog release re-enters per epoch
    retry_frac: float = 0.25
    # capacity autoscale bands on mean queue occupancy over serving nodes
    scale_up_util: float = 0.5    # above (or any retry backlog) -> activate
    scale_down_util: float = 0.1  # below, with empty backlog -> park
    scale_patience: int = 2       # consecutive reports before acting
    min_serving: int = 2          # never park below this many live nodes

    # ---- coordination-tier backoff (repro.coordination_tier) ----
    # skip a policy round entirely when the previous period's redirect
    # share (redirected / routed, from the switch tier's conservation
    # counters) exceeds this: the fabric is still digesting the last
    # reconfiguration, and more migrations would only widen the stale
    # window.  0.0 (the default) disables the check bit-identically.
    redirect_backoff: float = 0.0


class Policy:
    """Base policy: freeze the directory (no control actions at all)."""

    name = "frozen"
    read_spread = False     # epoch driver compiles tail-read step
    # declared pull cadence: epochs per controller pull.  This is the
    # period the fused epoch driver runs device-resident between host
    # round-trips when ``ClusterConfig.report_every`` is left unset — a
    # policy that tolerates staler reports can raise it and trade control
    # lag for data-plane throughput (NetCache-style: many data intervals
    # per control pull).  The string ``"auto"`` delegates the choice to
    # the driver's drift-adaptive cadence (``ClusterConfig.auto_band``):
    # each report's node-load drift against the previous one shortens or
    # lengthens the next period inside the band.  Policy decisions are a
    # pure function of the period-boundary report either way.
    pull_every: int | str = 1

    def __init__(self, config: PolicyConfig | None = None):
        self.config = config or PolicyConfig()

    def on_report(self, controller: Controller, report: StatsReport
                  ) -> list[MigrationOp]:
        return []


class MigratePolicy(Policy):
    """Paper §5.1 behaviour: statistics-driven sub-range migration only."""

    name = "migrate"

    def on_report(self, controller, report):
        return controller.balance(report)


def _live_heat(controller: Controller, report: StatsReport):
    """(heat (S,), live (S,), live-mean) with dead slots zeroed out."""
    heat = (report.read_count + report.write_count).astype(np.float64)
    if report.live is not None:
        live = np.asarray(report.live, bool)
    else:
        live = np.zeros(len(heat), bool)
        live[controller.live_ranges()] = True
    heat = np.where(live, heat, 0.0)
    mean = heat[live].mean() if live.any() else 0.0
    return heat, live, mean


def _sketch_boundary(lo: int, hi: int, report: StatsReport) -> int | None:
    """Heat-median split boundary for [lo, hi] from the count-min view.

    The sampled keys inside the span, weighted by their ``sketch_query``
    estimates, give the period's heat distribution over the range; the
    weighted median is the boundary that splits that heat in half — the
    quantile split the whole-range counters cannot see.  None when the
    sketch view is absent or too thin (callers fall back to the midpoint).
    """
    if report.key_sample is None or report.key_heat is None:
        return None
    ks = report.key_sample.astype(np.uint64)
    w = report.key_heat.astype(np.float64)
    m = (ks >= lo) & (ks <= hi)
    ks, w = ks[m], w[m]
    if ks.size < 2 or w.sum() <= 0:
        return None
    order = np.argsort(ks)
    ks, w = ks[order], w[order]
    cum = np.cumsum(w)
    j = int(np.searchsorted(cum, cum[-1] * 0.5))
    j = min(j, ks.size - 2)
    return int(max(lo, min(int(ks[j]), hi - 1)))


class _SplitMergeMixin:
    """Shared hot-subset split / hysteresis-merge machinery.

    Splitting never moves data (the child inherits the parent's chain);
    the win is that every subsequent control action on the child — a
    migration or a widened replica — is priced by the hot subset's keys
    only.  Merging re-coalesces cooled children so the live record count
    (and the slot pool) does not ratchet upward over a long run.
    """

    def __init__(self, config: PolicyConfig | None = None):
        super().__init__(config)
        self._cool: dict[int, int] = {}   # child slot -> consecutive cool reports

    def split_merge(self, controller: Controller, report: StatsReport
                    ) -> list[MigrationOp]:
        cfg = self.config
        heat, live, mean = _live_heat(controller, report)
        ops: list[MigrationOp] = []
        if mean <= 0:
            return ops

        # ---- splits: hottest ranges first, boundary at the sketch median
        # (budget_scale: cadence-aware — k epochs of report get k rounds'
        # worth; 1.0 on fixed cadence, so the integer is unchanged there)
        budget = max(1, int(round(cfg.max_splits_per_round
                                  * report.budget_scale)))
        for ridx in np.argsort(np.where(live, heat, -1.0))[::-1]:
            ridx = int(ridx)
            if budget <= 0 or heat[ridx] <= cfg.split_factor * mean:
                break
            if controller.free_slots() == 0:
                break  # pool exhausted: shape stability outranks splitting
            lo, hi = controller.range_span(ridx)
            if hi - lo + 1 < cfg.min_split_span:
                continue
            boundary = _sketch_boundary(lo, hi, report)
            if boundary is None:
                boundary = lo + (hi - lo) // 2
            child = controller.split_range(ridx, boundary)
            if child is None:
                continue
            self._cool.pop(child, None)
            budget -= 1

        # ---- merges: children cool for `merge_patience` straight reports
        threshold = cfg.merge_factor * mean
        for child in controller.children():
            if report.live is not None and not report.live[child]:
                # born after the report snapshot (e.g. by the split pass
                # above): its zero heat is ignorance, not coolness — a
                # spurious tick here would halve the hysteresis
                continue
            if heat[child] < threshold:
                self._cool[child] = self._cool.get(child, 0) + 1
            else:
                self._cool[child] = 0
            if self._cool.get(child, 0) >= cfg.merge_patience:
                merged = controller.merge_range(child)
                if merged is not None:
                    ops.extend(merged)
                    self._cool.pop(child, None)
        # drop hysteresis state for slots that died some other way
        live_children = set(controller.children())
        for s in list(self._cool):
            if s not in live_children:
                self._cool.pop(s)

        # lineage upkeep (opt-in): merges can orphan grandchildren (their
        # parent slot died or was reused) and adversarial split runs
        # deepen the lineage; re-parenting onto adjacent live slots keeps
        # every child mergeable and bounds `generation` depth
        if cfg.max_lineage_depth is not None:
            controller.compact_lineage(cfg.max_lineage_depth)
        return ops


class SplitHotPolicy(_SplitMergeMixin, Policy):
    """Hot-subset splitting + migration (the slot-pool showcase).

    Against ``migrate`` this moves strictly less data for the same
    imbalance reduction: the balancer's hottest-range pick lands on a
    split child whose span covers only the hot subset, so the emitted
    move op is priced by the hot keys, not the whole range's residents.
    """

    name = "split_hot"

    def on_report(self, controller, report):
        ops = self.split_merge(controller, report)
        ops.extend(controller.balance(report))
        return ops


class ReplicatePolicy(Policy):
    """Hot-range selective replication + load-aware read spreading.

    Widens the chains of ranges whose *per-replica* heat dominates the
    mean — possibly by several replicas in one round — and narrows cooled
    chains back to the base replication.  Declares ``read_spread``
    because widening without spreading is pointless: tail-only reads
    would simply all move to the newcomer.

    Two details matter in practice (found the hard way):

    * consecutive widenings must account for the load they just shifted —
      picking "the coldest node" from a stale report piles every new
      replica onto the same three nodes and simply relocates the hotspot;
    * widened members are lazily-refreshed *read replicas*: the write's
      client-visible path stays the base chain (``plan_hops
      write_chain_cap``), and this policy re-emits a refresh copy per
      standing widened replica each round — the sync traffic the bench
      charges as migration bytes.
    """

    name = "replicate"
    read_spread = True

    def on_report(self, controller, report):
        cfg = self.config
        heat, live, mean = _live_heat(controller, report)
        ops: list[MigrationOp] = []
        if mean <= 0:
            return ops
        nl = report.node_load.astype(np.float64).copy()
        clen = controller.chain_lengths().astype(np.float64)
        # cadence-aware widen budget (1.0 scale on fixed cadence)
        budget = max(1, int(round(cfg.max_widen_per_round
                                  * report.budget_scale)))

        # hottest per live replica first: a wide warm chain is already
        # fine; dead slots and fully-spliced chains (clen 0) carry no
        # replica to widen from and are masked out
        ratio = np.where(live & (clen > 0), heat / np.maximum(clen, 1.0), -1.0)
        for ridx in np.argsort(ratio)[::-1]:
            if budget <= 0 or ratio[ridx] <= 0:
                break
            while budget > 0 and heat[ridx] / clen[ridx] > cfg.hot_factor * mean:
                op = controller.widen_chain(int(ridx), nl)
                if op is None:
                    break
                ops.append(op)
                budget -= 1
                # re-estimate: members shed read share, newcomer takes one
                c = clen[ridx]
                for m in controller.chain_nodes(int(ridx))[: int(c)]:
                    nl[int(m)] -= heat[ridx] / (c * (c + 1))
                nl[op.dst] += heat[ridx] / (c + 1)
                clen[ridx] += 1

        cl = controller.chain_lengths()
        widened = live & (cl > cfg.base_replication)
        if cfg.narrow_below_mean:
            for ridx in np.where(widened)[0]:
                if heat[ridx] < mean:
                    op = controller.narrow_chain(int(ridx), cfg.base_replication)
                    if op is not None:
                        ops.append(op)
            cl = controller.chain_lengths()
            widened = live & (cl > cfg.base_replication)

        # periodic refresh of standing read replicas (lazy delta sync)
        for ridx in np.where(widened)[0]:
            lo, hi = controller.range_span(int(ridx))
            chain = controller.chain_nodes(int(ridx))
            head = int(chain[0])
            for pos in range(cfg.base_replication, int(cl[ridx])):
                dst = int(chain[pos])
                if dst >= 0 and not any(
                    o.kind == "copy" and o.dst == dst and o.lo == lo
                    for o in ops
                ):
                    ops.append(MigrationOp(lo=lo, hi=hi, src=head, dst=dst,
                                           kind="copy"))
        return ops


class FullAdaptivePolicy(_SplitMergeMixin, ReplicatePolicy):
    """Everything on: split/merge + replicate + spread + migrate.

    Splitting isolates the hot subset of a range; replication handles
    subsets too hot for any single tail; migration evens out the residual
    per-node imbalance the replicas leave behind; the merge hysteresis
    re-coalesces split records once their heat subsides.
    """

    name = "full_adaptive"

    def on_report(self, controller, report):
        ops = self.split_merge(controller, report)
        ops.extend(super().on_report(controller, report))
        ops.extend(controller.balance(report))
        return ops


class OverloadAdaptivePolicy(FullAdaptivePolicy):
    """Everything on, plus the survival layer (repro.overload):

    * **AIMD admission control** — queue occupancy above ``admit_hi``
      multiplicatively cuts that node's admission probability (explicit
      client backpressure instead of queue collapse); occupancy below
      ``admit_lo`` additively recovers it toward 1.0, with a floor so
      recovery is always probed;
    * **retry budgeting** — released backoff retries are capped at
      ``retry_frac`` of the service rate per node per epoch, so a
      synchronized backlog release (the retry storm) cannot re-overrun
      the queues it just drained;
    * **capacity autoscale** — mean occupancy over serving nodes above
      ``scale_up_util`` (or any standing retry backlog) for
      ``scale_patience`` straight reports activates a standby node
      (``Controller.activate_node``); occupancy below ``scale_down_util``
      with an empty backlog parks the least-loaded node back into the
      reserve (``Controller.park_node`` — its repair-copy drain rides the
      returned migration plan, journaled through ``repl_log``).

    The control channel is attribute-based: the epoch driver grafts
    ``admit_prob`` / ``retry_budget`` onto the device registers after
    each report and drains ``notes`` into the epoch's event log.  Without
    an overload plane (``queue_limit == 0``) this is exactly
    ``full_adaptive``.
    """

    name = "overload_adaptive"

    def __init__(self, config: PolicyConfig | None = None):
        super().__init__(config)
        self.admit_prob: np.ndarray | None = None
        self.retry_budget: np.ndarray | None = None
        self.notes: list[str] = []
        self._hi_rounds = 0
        self._lo_rounds = 0

    def on_report(self, controller, report):
        ops = super().on_report(controller, report)
        ops.extend(self._backpressure(controller, report))
        return ops

    def _backpressure(self, controller: Controller, report: StatsReport
                      ) -> list[MigrationOp]:
        cfg = self.config
        if report.queue_limit <= 0 or report.queue_depth is None:
            return []
        N = report.node_load.shape[0]
        # pressure signal: post-drain queue depth alone understates a
        # node in trouble (a full queue that drains service_rate looks
        # calm), so fold in its retry backlog — queries the node already
        # turned away that are coming back
        rb = (report.retry_backlog.astype(np.float64)
              if report.retry_backlog is not None
              else np.zeros(report.queue_depth.shape[0]))
        occ = ((report.queue_depth.astype(np.float64) + rb)
               / float(report.queue_limit))
        ap = (self.admit_prob if self.admit_prob is not None
              else np.ones(N, np.float64))
        ap = np.where(
            occ > cfg.admit_hi, ap * cfg.admit_decrease,
            np.where(occ < cfg.admit_lo,
                     np.minimum(ap + cfg.admit_increase, 1.0), ap),
        )
        self.admit_prob = np.clip(ap, cfg.admit_floor, 1.0)
        self.retry_budget = np.full(
            N, max(1, int(cfg.retry_frac * report.service_limit)), np.int64
        )

        # ---- autoscale: band + patience on serving-node occupancy ----
        serving = controller.live_nodes()
        util = float(occ[serving].mean()) if serving else 0.0
        backlog = (int(report.retry_backlog.sum())
                   if report.retry_backlog is not None else 0)
        if util > cfg.scale_up_util or backlog > 0:
            self._hi_rounds += 1
            self._lo_rounds = 0
        elif util < cfg.scale_down_util and backlog == 0:
            self._lo_rounds += 1
            self._hi_rounds = 0
        else:
            self._hi_rounds = self._lo_rounds = 0

        ops: list[MigrationOp] = []
        if self._hi_rounds >= cfg.scale_patience and controller.standby:
            node = min(controller.standby)
            controller.activate_node(node)
            self.notes.append(f"autoscale_up:{node}")
            self._hi_rounds = 0
        elif (self._lo_rounds >= cfg.scale_patience
              and len(serving) - 1 >= max(cfg.min_serving,
                                          cfg.base_replication)):
            node = min(serving, key=lambda n: report.node_load[n])
            ops.extend(controller.park_node(node, report.node_load))
            self.notes.append(f"autoscale_down:{node}")
            self._lo_rounds = 0
        return ops


POLICIES = {
    "frozen": Policy,
    "migrate": MigratePolicy,
    "replicate": ReplicatePolicy,
    "split_hot": SplitHotPolicy,
    "full_adaptive": FullAdaptivePolicy,
    "overload_adaptive": OverloadAdaptivePolicy,
}


def make_policy(name: str, config: PolicyConfig | None = None) -> Policy:
    if name not in POLICIES:
        raise ValueError(f"unknown policy {name!r}; pick from {sorted(POLICIES)}")
    return POLICIES[name](config)
