"""The TurboKV controller (counterpart of ``repro.core.controller``;
control plane, paper §3 / §5).

A logically centralized, host-side process that (a) balances load by
migrating hot sub-ranges to under-utilized nodes based on the data-plane
statistics reports, (b) splices failed nodes out of every chain and restores
the replication factor, and (c) splits sub-ranges — on capacity overflow
(paper §4.1.1) or to isolate the hot *subset* of a range (paper §5.1
"a subset of the hot data").  It mutates the directory with plain numpy
(this *is* the control plane — it is deliberately off the jitted hot path,
exactly as the paper's Python/Thrift controller sits off the P4 data plane)
and emits :class:`~repro_torch.core.migration.MigrationOp` plans for the data
movers.

Slot-pool discipline: the directory is a fixed pool of physical slots
(:mod:`repro_torch.core.directory`); :meth:`Controller.split_range` allocates a
dead slot for the new record and :meth:`Controller.merge_range` returns one
to the pool, so control actions never change array shapes and the cluster
epoch step stays compiled.  Only :meth:`Controller.grow_pool` (capacity
emergency, pool exhausted) changes shapes — after it the caller must
rebuild via :meth:`directory` (``refresh`` refuses, by design).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import keys as K
from repro_torch.core.directory import (
    DEAD_HI,
    DEAD_LO,
    NO_NODE,
    NO_SLOT,
    Directory,
    directory_from_arrays,
)
from repro_torch.core.migration import MigrationOp
from repro_torch.core.stats import StatsReport


@dataclasses.dataclass
class ControllerConfig:
    # migrate when max node load exceeds mean load by this factor
    imbalance_threshold: float = 1.5
    # cap on migrations per balancing round (greedy, hottest-first)
    max_moves_per_round: int = 4
    # split a sub-range when a shard reports overflow
    split_on_overflow: bool = True


class Controller:
    """Host-side control plane over a (Directory, StoreState) pair."""

    def __init__(self, directory: Directory, config: ControllerConfig | None = None):
        self.config = config or ControllerConfig()
        self._dir = _to_numpy(directory)
        # the grafted tables go back to the device the directory lives on
        self.device = directory.device
        self.hash_partitioned = directory.hash_partitioned
        self.failed: set[int] = set()
        # capacity-autoscale reserve: drained nodes held out of every
        # placement decision (balance / widen / repair targets) but not
        # *failed* — ``activate_node`` returns one to service instantly,
        # no repair copies needed because it rejoins empty
        self.standby: set[int] = set()
        self.log: list[str] = []
        # merge bookkeeping: (dead_child, absorber) pairs whose *live*
        # device counters must be credited over at the next refresh
        self._credits: list[tuple[int, int]] = []
        # replication-state journal: every control action that changes a
        # record's chain membership or lineage appends an event here; the
        # epoch driver drains it at sync points and replays it onto the
        # device-resident version/dirty register file
        # (repro.replication.state.apply_events — see the grammar there)
        self.repl_log: list[tuple] = []

    # -- directory snapshot back to device tensors -------------------------
    def directory(self) -> Directory:
        return directory_from_arrays(
            self._dir, hash_partitioned=self.hash_partitioned,
            device=self.device,
        )

    def refresh(self, live: Directory) -> Directory:
        """Graft the control-plane tables onto a *live* device directory.

        The data plane keeps bumping the statistics registers between
        controller pulls; a control update must not clobber them
        mid-period — ``stats.pull_report`` is the **only** reset path.
        This returns a directory with the controller's slot tables but
        the live directory's counters (after crediting merged children's
        unreported hits to their absorbing record), and refuses a shape
        change (only :meth:`grow_pool` changes shapes).
        """
        d = self._dir
        if d["chains"].shape != tuple(live.chains.shape):
            raise ValueError(
                f"directory shape changed ({tuple(live.chains.shape)} -> "
                f"{d['chains'].shape}); pull a report and rebuild via .directory()"
            )
        read_count, write_count = live.read_count, live.write_count
        if self._credits:
            rc = read_count.cpu().numpy().copy()
            wc = write_count.cpu().numpy().copy()
            for src, dst in self._credits:
                rc[dst] = (rc[dst] + rc[src]) & K.MASK32
                rc[src] = 0
                wc[dst] = (wc[dst] + wc[src]) & K.MASK32
                wc[src] = 0
            self._credits = []
            read_count = torch.as_tensor(rc, device=self.device)
            write_count = torch.as_tensor(wc, device=self.device)
        return dataclasses.replace(self.directory(), read_count=read_count,
                                   write_count=write_count)

    def table_snapshot(self) -> dict:
        """Host-side copies of the slot tables a coordination switch serves.

        Returns fresh numpy arrays (not views of the controller's private
        state) for exactly the fields a data-plane switch table holds:
        ``slot_lo / slot_hi / live / chains / chain_len``.  The
        coordination tier (``repro.coordination_tier``) diffs successive
        snapshots to decide which slots changed and therefore need a
        version bump + staged propagation — without ever pulling the live
        device directory (no host syncs).
        """
        d = self._dir
        return {
            "slot_lo": d["slot_lo"].copy(),
            "slot_hi": d["slot_hi"].copy(),
            "live": d["live"].copy(),
            "chains": d["chains"].copy(),
            "chain_len": d["chain_len"].copy(),
        }

    @property
    def num_nodes(self) -> int:
        return self._dir["node_addr"].shape[0]

    @property
    def num_slots(self) -> int:
        return self._dir["chains"].shape[0]

    @property
    def num_ranges(self) -> int:
        """Count of *live* records (logical ranges, not physical slots)."""
        return int(self._dir["live"].sum())

    @property
    def r_max(self) -> int:
        return self._dir["chains"].shape[1]

    def live_nodes(self) -> list[int]:
        return [
            n for n in range(self.num_nodes)
            if n not in self.failed and n not in self.standby
        ]

    def live_ranges(self) -> list[int]:
        """Slot indices of the live records."""
        return [int(s) for s in np.where(self._dir["live"])[0]]

    def free_slots(self) -> int:
        """How many dead slots remain in the pool."""
        return int((~self._dir["live"]).sum())

    def children(self) -> list[int]:
        """Live slots born by a split (parent still tracked) — the merge
        candidates the policy hysteresis watches."""
        d = self._dir
        return [
            int(s)
            for s in np.where(d["live"] & (d["parent"] != NO_SLOT))[0]
        ]

    def chain_lengths(self) -> np.ndarray:
        """(S,) copy of the live chain lengths (policy introspection)."""
        return self._dir["chain_len"].copy()

    def chain_nodes(self, ridx: int) -> np.ndarray:
        """(r_max,) copy of record ``ridx``'s chain slots (NO_NODE padded)."""
        return self._dir["chains"][ridx].copy()

    def range_span(self, ridx: int) -> tuple[int, int]:
        """Inclusive [lo, hi] key span of record ``ridx`` (public form of
        the internal helper; policy/metric layers should use this rather
        than reading ``_dir`` directly)."""
        return self._range_span(ridx)

    def is_live(self, ridx: int) -> bool:
        return bool(self._dir["live"][ridx])

    # ------------------------------------------------------------------
    # load balancing (paper §5.1): greedy hottest-range -> coolest-node
    # ------------------------------------------------------------------
    def balance(self, report: StatsReport) -> list[MigrationOp]:
        cfg = self.config
        d = self._dir
        load = report.node_load.astype(np.float64).copy()
        out = self.failed | self.standby
        live_node = np.array([n not in out for n in range(self.num_nodes)])
        ops: list[MigrationOp] = []
        heat = (report.read_count + report.write_count).astype(np.float64)
        heat = np.where(d["live"], heat, 0.0)  # dead slots carry no weight

        # cadence-aware budget: a realized period of k epochs gets k
        # rounds' worth of moves, so pull_every="auto" doesn't change the
        # migration *rate* (budget_scale is 1.0 on fixed cadence — same
        # integer, bit-identical behaviour)
        budget = max(1, int(round(cfg.max_moves_per_round * report.budget_scale)))
        for _ in range(budget):
            mean = load[live_node].mean() if live_node.any() else 0.0
            hot_node = int(np.where(live_node, load, -np.inf).argmax())
            if mean <= 0 or load[hot_node] <= cfg.imbalance_threshold * mean:
                break
            cold_node = int(np.where(live_node, load, np.inf).argmin())
            if cold_node == hot_node:
                break
            # hottest live sub-range served by the hot node (any chain position)
            served = d["live"] & (d["chains"] == hot_node).any(axis=1)
            if not served.any():
                break
            ridx = int(np.where(served, heat, -1.0).argmax())
            if heat[ridx] <= 0:
                break
            chain = d["chains"][ridx]
            if cold_node in chain:
                heat[ridx] = 0.0  # nothing to gain; try another range
                continue
            pos = int(np.where(chain == hot_node)[0][0])
            lo, hi = self._range_span(ridx)
            ops.append(MigrationOp(lo=lo, hi=hi, src=hot_node, dst=cold_node, kind="move"))
            d["chains"][ridx, pos] = cold_node
            self.repl_log.append(("reset", ridx))
            moved = heat[ridx]
            load[hot_node] -= moved
            load[cold_node] += moved
            heat[ridx] = 0.0
            self.log.append(f"balance: range {ridx} pos {pos}: node {hot_node} -> {cold_node}")
        return ops

    # ------------------------------------------------------------------
    # selective replication (repro_torch.cluster): widen a hot chain in place
    # ------------------------------------------------------------------
    def widen_chain(self, ridx: int, node_load: np.ndarray) -> MigrationOp | None:
        """Append a replica to chain ``ridx`` (hot-range selective replication).

        Picks the least-loaded live node not already in the chain, appends
        it at the tail slot, and returns the repair-copy op that populates
        it.  No-op (returns None) when the chain is already at ``r_max``
        or no candidate node exists.  Array shapes never change — only
        ``chain_len[ridx]`` and one chain slot — so the data-plane step
        stays compiled.  Pays off only with load-aware read spreading
        (``routing.route_load_aware``): tail-only reads would all move to
        the newcomer instead of dividing across the chain.
        """
        d = self._dir
        if not d["live"][ridx]:
            return None
        clen = int(d["chain_len"][ridx])
        if clen >= self.r_max:
            return None
        chain = d["chains"][ridx]
        current = set(int(c) for c in chain[:clen])
        candidates = [n for n in self.live_nodes() if n not in current]
        if not candidates or clen == 0:
            return None
        newcomer = min(candidates, key=lambda n: node_load[n])
        chain[clen] = newcomer
        d["chain_len"][ridx] = clen + 1
        self.repl_log.append(("reset", ridx))
        lo, hi = self._range_span(ridx)
        self.log.append(f"widen: range {ridx} replica {newcomer} (r={clen + 1})")
        return MigrationOp(lo=lo, hi=hi, src=int(chain[0]), dst=newcomer, kind="copy")

    def narrow_chain(self, ridx: int, base_replication: int) -> MigrationOp | None:
        """Drop the widened tail replica of chain ``ridx`` (cool-down).

        Inverse of :meth:`widen_chain`: shrinks the chain back toward
        ``base_replication`` by removing the last replica.  The removed
        node keeps its copy (no data movement is strictly needed for
        correctness); a 'reclaim' op is returned so the data mover frees
        the space.
        """
        d = self._dir
        if not d["live"][ridx]:
            return None
        clen = int(d["chain_len"][ridx])
        if clen <= base_replication or clen <= 1:
            return None
        victim = int(d["chains"][ridx, clen - 1])
        d["chains"][ridx, clen - 1] = NO_NODE
        d["chain_len"][ridx] = clen - 1
        self.repl_log.append(("reset", ridx))
        lo, hi = self._range_span(ridx)
        self.log.append(f"narrow: range {ridx} dropped replica {victim} (r={clen - 1})")
        return MigrationOp(lo=lo, hi=hi, src=victim, dst=victim, kind="reclaim")

    # ------------------------------------------------------------------
    # hot-subset splitting (paper §5.1 "a subset of the hot data"):
    # slot-pool split / merge — shapes never change
    # ------------------------------------------------------------------
    def split_range(self, ridx: int, boundary: int) -> int | None:
        """Split record ``ridx`` at ``boundary``: the parent keeps
        ``[lo, boundary]``, a dead slot is allocated for the child
        ``[boundary + 1, hi]``.

        The child inherits the parent's chain, so **no data moves** — every
        chain member already holds the child span; the payoff is that
        subsequent control actions (migrate / widen) on the child touch
        only the hot subset's keys.  Returns the child's slot index, or
        None when the boundary is degenerate, the record is dead, or the
        pool is exhausted (callers may :meth:`grow_pool` and rebuild).
        """
        d = self._dir
        if not d["live"][ridx]:
            return None
        lo, hi = self._range_span(ridx)
        if not (lo <= boundary < hi):
            return None
        free = np.where(~d["live"])[0]
        if free.size == 0:
            return None
        child = int(free[0])
        d["slot_lo"][child] = np.uint32(boundary + 1)
        d["slot_hi"][child] = np.uint32(hi)
        d["slot_hi"][ridx] = np.uint32(boundary)
        d["chains"][child] = d["chains"][ridx]
        d["chain_len"][child] = d["chain_len"][ridx]
        d["parent"][child] = ridx
        d["generation"][child] = d["generation"][ridx] + 1
        d["read_count"][child] = 0
        d["write_count"][child] = 0
        d["live"][child] = True
        # the child's keys were the parent's keys: same outstanding writes,
        # so it inherits the parent's version/dirty row verbatim
        self.repl_log.append(("inherit", ridx, child))
        self.log.append(
            f"split: range {ridx} at {boundary} -> child slot {child} "
            f"[{boundary + 1}, {hi}]"
        )
        return child

    def merge_range(self, child: int) -> list[MigrationOp] | None:
        """Re-coalesce split record ``child`` into its parent (cool-down).

        Valid only while both slots are live and their spans are still
        adjacent (either may have re-split meanwhile — then the merge is
        refused and the hysteresis keeps watching).  The merged record
        keeps the **parent's** chain; the returned plan makes the store
        consistent with that: parent-chain members missing the child span
        get a copy, child-chain members leaving the record reclaim it.
        The child's unreported counter hits are credited to the parent at
        the next :meth:`refresh`, and the freed slot returns to the pool.
        """
        d = self._dir
        p = int(d["parent"][child])
        if p < 0 or not d["live"][child] or not d["live"][p]:
            return None
        clo, chi = self._range_span(child)
        plo, phi = self._range_span(p)
        if phi + 1 != clo and chi + 1 != plo:
            return None  # spans drifted apart (one side re-split)
        p_len = int(d["chain_len"][p])
        c_len = int(d["chain_len"][child])
        if p_len == 0 or c_len == 0:
            return None
        p_members = [int(n) for n in d["chains"][p][:p_len] if n != NO_NODE]
        c_members = [int(n) for n in d["chains"][child][:c_len] if n != NO_NODE]
        if not p_members or not c_members:
            return None
        ops: list[MigrationOp] = []
        src = c_members[0]  # child chain head holds the child span
        for m in p_members:
            if m not in c_members:
                ops.append(MigrationOp(lo=clo, hi=chi, src=src, dst=m, kind="copy"))
        for m in c_members:
            if m not in p_members:
                ops.append(MigrationOp(lo=clo, hi=chi, src=m, dst=m, kind="reclaim"))

        d["slot_lo"][p] = np.uint32(min(plo, clo))
        d["slot_hi"][p] = np.uint32(max(phi, chi))
        d["read_count"][p] += d["read_count"][child]
        d["write_count"][p] += d["write_count"][child]
        self.repl_log.append(("merge", child, p))
        self._kill_slot(child)
        self.repl_log.append(("kill", child))
        self._credits.append((child, p))
        self.log.append(f"merge: child slot {child} -> range {p} [{min(plo, clo)}, {max(phi, chi)}]")
        return ops

    def _kill_slot(self, s: int) -> None:
        d = self._dir
        d["live"][s] = False
        d["slot_lo"][s] = DEAD_LO
        d["slot_hi"][s] = DEAD_HI
        d["chains"][s] = NO_NODE
        d["chain_len"][s] = 0
        d["parent"][s] = NO_SLOT
        d["generation"][s] = 0
        d["read_count"][s] = 0
        d["write_count"][s] = 0

    def grow_pool(self, extra: int | None = None) -> int:
        """Append dead slots to the pool (capacity emergency only).

        This **changes array shapes**: the epoch step must be rebuilt and
        ``refresh`` will refuse until the caller re-pulls via
        :meth:`directory`.  Returns the new pool size.
        """
        d = self._dir
        extra = self.num_slots if extra is None else extra
        d["slot_lo"] = np.concatenate([d["slot_lo"], np.full((extra,), DEAD_LO, np.uint32)])
        d["slot_hi"] = np.concatenate([d["slot_hi"], np.full((extra,), DEAD_HI, np.uint32)])
        d["live"] = np.concatenate([d["live"], np.zeros((extra,), bool)])
        d["chains"] = np.concatenate(
            [d["chains"], np.full((extra, self.r_max), NO_NODE, np.int32)]
        )
        d["chain_len"] = np.concatenate([d["chain_len"], np.zeros((extra,), np.int32)])
        d["parent"] = np.concatenate([d["parent"], np.full((extra,), NO_SLOT, np.int32)])
        d["generation"] = np.concatenate([d["generation"], np.zeros((extra,), np.int32)])
        d["read_count"] = np.concatenate([d["read_count"], np.zeros((extra,), np.uint32)])
        d["write_count"] = np.concatenate([d["write_count"], np.zeros((extra,), np.uint32)])
        self.repl_log.append(("grow", self.num_slots))
        self.log.append(f"grow_pool: {self.num_slots - extra} -> {self.num_slots} slots")
        return self.num_slots

    def drop_credits(self) -> None:
        """Discard pending merge counter credits.  Only correct right
        after a ``stats.pull_report`` (the live counters are zero, so the
        credits would transfer nothing anyway) — the epoch driver uses it
        when a pool growth forces a full :meth:`directory` rebuild that
        bypasses :meth:`refresh`."""
        self._credits = []

    def drain_repl_log(self) -> list[tuple]:
        """Hand the accumulated replication-state events to the driver
        (and clear them) — the replication analogue of ``_credits``."""
        events, self.repl_log = self.repl_log, []
        return events

    # ------------------------------------------------------------------
    # lineage compaction: bound split-lineage depth over long runs
    # ------------------------------------------------------------------
    def compact_lineage(self, max_depth: int = 3) -> int:
        """Re-parent split lineage so ``generation`` depth stays bounded.

        Adversarial split sequences leave two kinds of rot in the lineage
        metadata (spans and chains are untouched — this is bookkeeping
        only, the data plane never sees it):

        * **dangling parents** — a child whose parent slot died (merged
          away) or was reused for an unrelated span can never pass
          ``merge_range``'s liveness/adjacency check, so the slot leaks
          from the merge hysteresis forever;
        * **deep chains** — child-of-child-of-child lineage whose
          ``generation`` grows without bound.

        Repair: every live split child is re-parented onto the live slot
        whose span is *adjacent* to it (left neighbour preferred, then
        right — the natural merge partner; live slots partition the key
        space, so one exists unless the child spans everything), then
        generations are recomputed as depth in the repaired forest and
        any slot deeper than ``max_depth`` is promoted to a genesis range
        (``parent = NO_SLOT``, generation 0) — it simply stops
        auto-merging.  Lookups are bit-identical before and after
        (asserted by the hypothesis round-trip test) and no replication
        event is journaled: chain membership did not change.

        Returns the number of slots whose lineage was rewritten.
        """
        d = self._dir
        live = np.where(d["live"])[0]
        by_lo = {int(d["slot_lo"][s]): int(s) for s in live}
        by_hi = {int(d["slot_hi"][s]): int(s) for s in live}
        changed = 0

        for s in live:
            s = int(s)
            p = int(d["parent"][s])
            if p == NO_SLOT:
                continue
            lo, hi = self._range_span(s)
            # a valid parent is live and span-adjacent (mergeable)
            p_ok = (
                0 <= p < self.num_slots and bool(d["live"][p])
                and (int(d["slot_hi"][p]) + 1 == lo or int(d["slot_lo"][p]) == hi + 1)
            )
            if p_ok:
                continue
            left = by_hi.get(lo - 1)
            right = by_lo.get(hi + 1)
            new_p = left if left is not None else right
            if new_p is None or new_p == s:
                d["parent"][s] = NO_SLOT
                d["generation"][s] = 0
            else:
                d["parent"][s] = new_p
            changed += 1

        # recompute generation = depth in the repaired forest, promoting
        # anything deeper than max_depth (or on a cycle) to genesis
        depth: dict[int, int] = {}

        def resolve(s: int) -> int:
            path = []
            cur = s
            while cur not in depth:
                p = int(d["parent"][cur])
                if p == NO_SLOT or not (0 <= p < self.num_slots) or not d["live"][p]:
                    depth[cur] = 0 if p == NO_SLOT else 1
                    break
                if p in path or p == cur:        # cycle: promote the root
                    depth[cur] = 0
                    d["parent"][cur] = NO_SLOT
                    break
                path.append(cur)
                cur = p
            for cur in reversed(path):
                depth[cur] = depth[int(d["parent"][cur])] + 1
            return depth[s]

        for s in live:
            s = int(s)
            if not d["live"][s]:
                continue
            g = resolve(s)
            if int(d["parent"][s]) != NO_SLOT and g > max_depth:
                d["parent"][s] = NO_SLOT
                g = 0
                depth[s] = 0
                changed += 1
            if int(d["generation"][s]) != g:
                d["generation"][s] = g
                changed += 1
        if changed:
            self.log.append(f"compact_lineage: rewrote {changed} slots")
        return changed

    # ------------------------------------------------------------------
    # failure handling (paper §5.2): splice, then restore replication
    # ------------------------------------------------------------------
    def handle_node_failure(self, node: int, node_load: np.ndarray | None = None) -> list[MigrationOp]:
        d = self._dir
        self.failed.add(node)
        ops: list[MigrationOp] = []
        load = (
            node_load.astype(np.float64).copy()
            if node_load is not None
            else np.zeros(self.num_nodes)
        )
        live_nodes = self.live_nodes()
        if not live_nodes:
            raise RuntimeError("all storage nodes failed")

        for ridx in self.live_ranges():
            chain = d["chains"][ridx]
            clen = int(d["chain_len"][ridx])
            pos = np.where(chain[:clen] == node)[0]
            if pos.size == 0:
                continue
            p = int(pos[0])
            # splice: predecessor now feeds the successor (chain shrinks by 1)
            chain[p : clen - 1] = chain[p + 1 : clen]
            chain[clen - 1] = NO_NODE
            d["chain_len"][ridx] = clen - 1
            self.repl_log.append(("reset", ridx))
            self.log.append(f"failure: spliced node {node} from range {ridx} (pos {p})")

            # restore replication: append the least-loaded live node not in
            # the chain; repair-copy the range from a surviving replica.
            current = set(int(c) for c in chain[: clen - 1])
            candidates = [n for n in live_nodes if n not in current]
            if candidates and clen - 1 >= 1:
                newcomer = min(candidates, key=lambda n: load[n])
                chain[clen - 1] = newcomer
                d["chain_len"][ridx] = clen
                survivor = int(chain[0])
                lo, hi = self._range_span(ridx)
                ops.append(MigrationOp(lo=lo, hi=hi, src=survivor, dst=newcomer, kind="copy"))
                load[newcomer] += 1.0
                self.log.append(f"failure: range {ridx} re-replicated on node {newcomer}")
        return ops

    def handle_switch_failure(self, rack_nodes: list[int]) -> list[MigrationOp]:
        """Paper §5.2: a failed switch makes its whole rack unreachable —
        treat every node behind it as failed.

        The whole rack is marked dead *before* any chain is spliced:
        splicing node-by-node would let the re-replication step pick a
        repair target behind the same dead switch (wasted copies to a
        node about to be spliced out itself).
        """
        self.failed.update(rack_nodes)
        ops: list[MigrationOp] = []
        for n in rack_nodes:
            ops.extend(self.handle_node_failure(n))
        return ops

    def recover_node(self, node: int) -> None:
        """A rebooted/replaced node rejoins empty; the balancer will use it."""
        self.failed.discard(node)
        self.log.append(f"recover: node {node} back in service")

    # ------------------------------------------------------------------
    # capacity autoscaling: drain a node into the standby reserve when
    # load subsides, activate it back when utilization crosses the band
    # ------------------------------------------------------------------
    def park_node(self, node: int, node_load: np.ndarray | None = None) -> list[MigrationOp]:
        """Drain ``node`` into the standby reserve (autoscale release).

        Its chains are spliced and re-replicated exactly like a failure —
        every span it served gets a repair copy on a live node, journaled
        through ``repl_log`` so replication state stays coherent — but the
        node lands in ``standby`` rather than ``failed``:
        :meth:`activate_node` returns it to service instantly (it rejoins
        empty; no repair needed).  No-op if already parked.
        """
        if node in self.standby:
            return []
        self.standby.add(node)
        ops = self.handle_node_failure(node, node_load)
        self.failed.discard(node)
        self.log.append(f"park: node {node} drained to standby")
        return ops

    def activate_node(self, node: int) -> None:
        """Return a standby node to service (autoscale grow).

        The node rejoins empty — the balancer (and failure repair) start
        placing ranges on it from the next control round.
        """
        if node not in self.standby:
            return
        self.standby.discard(node)
        self.failed.discard(node)
        self.log.append(f"activate: node {node} joins from standby")

    # ------------------------------------------------------------------
    # capacity overflow (paper §4.1.1): split the sub-range, migrate half
    # ------------------------------------------------------------------
    def split_overflowed(self, ridx: int, node_load: np.ndarray) -> list[MigrationOp]:
        d = self._dir
        if not d["live"][ridx]:
            return []
        lo, hi = self._range_span(ridx)
        if hi - lo < 2:
            return []
        mid = lo + (hi - lo) // 2
        if self.free_slots() == 0:
            # capacity emergency outranks shape stability: grow the pool
            # (the caller must rebuild the step via .directory())
            self.grow_pool()
        child = self.split_range(ridx, mid)
        if child is None:
            return []

        # move the child (upper) half's head to the least-loaded node
        live = self.live_nodes()
        old_head = int(d["chains"][child, 0])
        target = min((n for n in live if n != old_head), key=lambda n: node_load[n], default=None)
        ops: list[MigrationOp] = []
        if target is not None:
            d["chains"][child, 0] = target
            self.repl_log.append(("reset", child))
            ops.append(MigrationOp(lo=mid + 1, hi=hi, src=old_head, dst=target, kind="move"))
            self.log.append(f"split: range {ridx} at {mid}; upper half head {old_head} -> {target}")
        return ops

    # ------------------------------------------------------------------
    def _range_span(self, ridx: int) -> tuple[int, int]:
        """Inclusive [lo, hi] key span of record ridx."""
        d = self._dir
        return int(d["slot_lo"][ridx]), int(d["slot_hi"][ridx])


def _to_numpy(directory: Directory) -> dict[str, np.ndarray]:
    """Host copies of the directory tables in the controller's layout
    (uint32 spans and counters, int32 ids)."""
    def h(t, dtype):
        return t.cpu().numpy().astype(dtype)

    return {
        "slot_lo": h(directory.slot_lo, np.uint32),
        "slot_hi": h(directory.slot_hi, np.uint32),
        "live": h(directory.live, bool),
        "chains": h(directory.chains, np.int32),
        "chain_len": h(directory.chain_len, np.int32),
        "parent": h(directory.parent, np.int32),
        "generation": h(directory.generation, np.int32),
        "node_addr": h(directory.node_addr, np.int32),
        "read_count": h(directory.read_count, np.uint32),
        "write_count": h(directory.write_count, np.uint32),
    }
