"""Per-epoch cluster metrics (counterpart of ``repro.cluster.metrics``;
the monitoring half of paper §5.1).

The closed loop needs numbers on both sides: the *data plane* produces
per-epoch load/latency observations, the *bench* consumes per-run
summaries comparing policies.  Everything here is plain numpy — these are
control-plane/reporting quantities, deliberately off the jitted step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import keys as K
from repro_torch.core.migration import MigrationOp
from repro_torch.core.store import StoreState


@dataclasses.dataclass
class EpochMetrics:
    """One epoch's observation row (JSON-serializable via ``to_row``)."""

    epoch: int
    scenario: str
    policy: str
    ops: int                  # ops injected this epoch
    throughput: float         # ops / DES makespan (ops per tick)
    p50: float                # DES closed-loop latency percentiles (ticks)
    p99: float
    makespan: float
    imbalance: float          # max/mean per-node ops over live nodes
    cov: float                # coefficient of variation of per-node ops
    migration_entries: int    # entries moved/copied by control ops this epoch
    migration_bytes: int      # wire estimate of the above
    drops: int                # store capacity drops (overflow delta)
    retries: int              # bucket overflows (dist backend; 0 for oracle)
    compiled_steps: int       # cumulative device-step trace count
    events: list[str] = dataclasses.field(default_factory=list)
    # ---- overload observables (repro.overload; all 0 when disabled) ----
    deferred: int = 0         # admission-gated queries (client backpressure)
    shed: int = 0             # queue-full rejections entering retry orbit
    requeued: int = 0         # backoff retries re-admitted this epoch
    lost: int = 0             # retries escaping past the top backoff level
    queue_peak: int = 0       # max per-node queue occupancy after the epoch
    # ---- replication-mode observables (repro.replication) ----
    p999: float = 0.0         # extreme tail (p99.9) over all ops
    read_p99: float = 0.0     # p99 over GET/SCAN ops only
    clean_read_p99: float = 0.0   # p99 over reads served WITHOUT a CRAQ
                                  # tail bounce (== read_p99 off-craq)
    dirty_reads: int = 0      # reads that bounced to the tail this epoch
    replication: str = "eventual"
    # ---- coordination-tier observables (repro.coordination_tier) ----
    # exact conservation holds per row: routed == direct + redirected
    routed: int = 0           # queries resolved through the switch tier
    direct: int = 0           # served off a non-divergent table row
    redirected: int = 0       # versioned redirects (one priced extra hop)
    mis_served: int = 0       # stale wrong-owner serves NOT redirected
    stale_switches: int = 0   # switch copies divergent at epoch end
    coordination: str = "none"

    def to_row(self) -> dict:
        row = dataclasses.asdict(self)
        row["events"] = list(self.events)
        return row

    @classmethod
    def from_row(cls, row: dict) -> "EpochMetrics":
        """Inverse of :func:`to_row`: rebuild the dataclass from its JSON
        dict (round-trip asserted in ``tests/test_cluster.py`` — bench
        artifacts must reconstruct without loss)."""
        return cls(**{**row, "events": list(row.get("events", []))})


def latency_percentiles(latency: np.ndarray) -> tuple[float, float]:
    """(p50, p99) of a DES latency vector."""
    lat = np.asarray(latency, np.float64)
    if lat.size == 0:
        return 0.0, 0.0
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))


def latency_percentiles_batch(latency: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-epoch (p50s, p99s) over a period's stacked (P, B) latency matrix
    — one vectorized percentile pass; each row's result is exactly what
    :func:`latency_percentiles` computes on that row alone."""
    lat = np.asarray(latency, np.float64)
    if lat.ndim != 2:
        raise ValueError(f"expected (P, B) latency, got shape {lat.shape}")
    if lat.shape[1] == 0:
        z = np.zeros(lat.shape[0])
        return z, z.copy()
    qs = np.percentile(lat, (50, 99), axis=1)
    return qs[0], qs[1]


def p999_batch(latency: np.ndarray) -> np.ndarray:
    """Per-epoch p99.9 over a (P, B) latency matrix — the extreme-tail
    column of the replication-mode comparison (coordination overheads and
    tail bounces live out there)."""
    lat = np.asarray(latency, np.float64)
    if lat.ndim != 2:
        raise ValueError(f"expected (P, B) latency, got shape {lat.shape}")
    if lat.shape[1] == 0:
        return np.zeros(lat.shape[0])
    return np.percentile(lat, 99.9, axis=1)


def masked_p99_batch(latency: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Per-epoch p99 over the masked entries of a (P, B) latency matrix
    (e.g. reads only, or clean reads only).  Rows whose mask is empty
    report 0.0.

    One sort-based pass over the whole matrix: masked-out entries are
    padded to +inf so each row's live values sort to the front, then the
    per-row 0.99 rank is interpolated exactly as ``np.percentile`` does
    (same floor/ceil gather, same ``_lerp`` formula — including its
    ``t >= 0.5`` branch, which differs from a naive ``a + diff*t`` in the
    last ulp).  Bit-identical to the per-row loop it replaced, kept as
    :func:`masked_p99_batch_loop` for the equivalence test."""
    lat = np.asarray(latency, np.float64)
    m = np.asarray(mask, bool)
    if lat.shape != m.shape or lat.ndim != 2:
        raise ValueError(f"latency {lat.shape} vs mask {m.shape}")
    P, B = lat.shape
    if B == 0:
        return np.zeros(P)
    padded = np.where(m, lat, np.inf)
    padded.sort(axis=1)
    n = m.sum(axis=1)                       # live count per row
    ok = n > 0
    vi = 0.99 * (np.where(ok, n, 1) - 1)    # virtual index, guarded
    lo = np.floor(vi).astype(np.intp)
    hi = np.ceil(vi).astype(np.intp)
    a = np.take_along_axis(padded, lo[:, None], axis=1)[:, 0]
    b = np.take_along_axis(padded, hi[:, None], axis=1)[:, 0]
    # zero empty rows BEFORE the arithmetic: their pad is +inf and
    # inf - inf would raise a warning on lanes we discard anyway
    a = np.where(ok, a, 0.0)
    b = np.where(ok, b, 0.0)
    t = vi - lo
    diff = b - a
    return np.where(t >= 0.5, b - diff * (1 - t), a + diff * t)


def masked_p99_batch_loop(latency: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """The per-row reference implementation of :func:`masked_p99_batch`
    (one ``np.percentile`` call per epoch row) — the equivalence oracle."""
    lat = np.asarray(latency, np.float64)
    m = np.asarray(mask, bool)
    if lat.shape != m.shape or lat.ndim != 2:
        raise ValueError(f"latency {lat.shape} vs mask {m.shape}")
    out = np.zeros(lat.shape[0])
    for i in range(lat.shape[0]):
        row = lat[i][m[i]]
        if row.size:
            out[i] = np.percentile(row, 99)
    return out


def imbalance_stats_batch(node_ops: np.ndarray, live: np.ndarray | None = None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Per-epoch (max/mean, CoV) over a period's stacked (P, N) node-ops
    matrix; row-identical to :func:`imbalance_stats` (the node liveness
    mask is constant within a period — control events only fire at
    segment boundaries)."""
    ops = np.asarray(node_ops, np.float64)
    if ops.ndim != 2:
        raise ValueError(f"expected (P, N) node_ops, got shape {ops.shape}")
    if live is not None:
        ops = ops[:, np.asarray(live, bool)]
    P = ops.shape[0]
    if ops.shape[1] == 0:
        return np.ones(P), np.zeros(P)
    mean = ops.mean(axis=1)
    ok = mean > 0
    safe = np.where(ok, mean, 1.0)
    imb = np.where(ok, ops.max(axis=1) / safe, 1.0)
    cov = np.where(ok, ops.std(axis=1) / safe, 0.0)
    return imb, cov


def imbalance_stats(node_ops: np.ndarray, live: np.ndarray | None = None
                    ) -> tuple[float, float]:
    """(max/mean, CoV) of per-node served ops, over live nodes only.

    max/mean is the paper's balancing trigger quantity
    (``ControllerConfig.imbalance_threshold`` compares against it); CoV
    adds a whole-distribution view that max/mean misses.
    """
    ops = np.asarray(node_ops, np.float64)
    if live is not None:
        ops = ops[np.asarray(live, bool)]
    mean = ops.mean() if ops.size else 0.0
    if mean <= 0:
        return 1.0, 0.0
    return float(ops.max() / mean), float(ops.std() / mean)


def migration_traffic(store: StoreState, ops: list[MigrationOp],
                      value_dim: int) -> tuple[int, int]:
    """(entries, bytes) a migration plan will move, counted on the source.

    Counts actual resident entries in each op's [lo, hi] span on its
    source shard *before* execution — the directory-span estimate the
    controller reasons with can be badly off under skew.  Bytes model the
    shim wire format: 4-byte key + value_dim f32 words.
    """
    counts = [
        ((store.keys[op.src] >= op.lo) & (store.keys[op.src] <= op.hi)
         & (store.keys[op.src] != K.EMPTY_KEY)).sum()
        for op in ops if op.kind != "reclaim"    # reclaims move no data
    ]
    # counted on the device, one transfer for the whole plan
    entries = int(torch.stack(counts).sum()) if counts else 0
    return entries, entries * 4 * (1 + value_dim)


def summarize(rows: list[EpochMetrics]) -> dict:
    """Aggregate a run's epoch rows into the bench comparison row."""
    if not rows:
        return {}
    f = lambda k: np.asarray([getattr(r, k) for r in rows], np.float64)
    return {
        "scenario": rows[0].scenario,
        "policy": rows[0].policy,
        "replication": rows[0].replication,
        "coordination": rows[0].coordination,
        "epochs": len(rows),
        "mean_throughput": float(f("throughput").mean()),
        "mean_p50": float(f("p50").mean()),
        "mean_p99": float(f("p99").mean()),
        "max_p99": float(f("p99").max()),
        "mean_p999": float(f("p999").mean()),
        "max_p999": float(f("p999").max()),
        "mean_read_p99": float(f("read_p99").mean()),
        "mean_clean_read_p99": float(f("clean_read_p99").mean()),
        "total_dirty_reads": int(f("dirty_reads").sum()),
        "mean_imbalance": float(f("imbalance").mean()),
        "max_imbalance": float(f("imbalance").max()),
        "mean_cov": float(f("cov").mean()),
        "total_migration_entries": int(f("migration_entries").sum()),
        "total_migration_bytes": int(f("migration_bytes").sum()),
        "total_drops": int(f("drops").sum()),
        "total_retries": int(f("retries").sum()),
        "total_deferred": int(f("deferred").sum()),
        "total_shed": int(f("shed").sum()),
        "total_requeued": int(f("requeued").sum()),
        "total_lost": int(f("lost").sum()),
        "max_queue_peak": int(f("queue_peak").max()),
        "total_routed": int(f("routed").sum()),
        "total_direct": int(f("direct").sum()),
        "total_redirected": int(f("redirected").sum()),
        "total_mis_served": int(f("mis_served").sum()),
        "max_stale_switches": int(f("stale_switches").max()),
        "compiled_steps": int(rows[-1].compiled_steps),
    }
