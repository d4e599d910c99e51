"""The host half of the trace plane: per-run span/pipeline bookkeeping
(counterpart of ``repro.telemetry.recorder``).

One :class:`TelemetryRecorder` per :class:`~repro_torch.cluster.epoch.
EpochDriver` (when ``ClusterConfig.telemetry`` is set).  The driver
hands it, once per fused segment (or per epoch on the per-epoch loop):

* the device-assembled span tables (``trace.collect_spans`` output,
  already brought home with the segment's one device-to-host copy),
* the DES latency/issue matrices and per-epoch makespans,
* the segment's ``EpochMetrics`` rows and a state snapshot (queue
  depths, retry backlog, load registers, replication dirty summary,
  overload conservation gap).

The recorder attributes every sampled span (``attribution.decompose`` —
exact by construction), accumulates the per-epoch records the exporters
consume, feeds the flight-recorder ring, and fires postmortem dumps on
an SLO p999 breach or a broken conservation invariant.  It never touches
the device: everything here is plain numpy on the far side of the one
host sync per period.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.coordination import LatencyModel
from repro_torch.telemetry import attribution as A
from repro_torch.telemetry import export as E
from repro_torch.telemetry.flight import FlightRecorder
from repro_torch.telemetry.profiler import StageTimers
from repro_torch.telemetry.trace import SI, TelemetryConfig


class TelemetryRecorder:
    """Per-run trace/profile accumulator (host side)."""

    def __init__(self, cfg: TelemetryConfig, *, model: LatencyModel,
                 scenario: str = "", policy: str = "",
                 n_clients: int | None = None,
                 timers: StageTimers | None = None):
        self.cfg = cfg
        self.model = model
        self.scenario = scenario
        self.policy = policy
        self.n_clients = n_clients
        self.epochs: list[dict] = []      # per-epoch span records
        self.breaches: list[str] = []
        # the driver passes its own stage timers, so one mechanism times
        # the pipeline whether the trace plane is on or off
        self.timers = (timers if timers is not None
                       else StageTimers(sync=cfg.profile_stages))
        self.flight = FlightRecorder(
            cfg.flight_epochs, cfg.flight_dir,
            tag=f"{scenario}_{policy}" if scenario else "run",
        )
        self._clock = 0.0                 # cumulative DES makespan offset

    # -- ingestion ----------------------------------------------------------
    def on_segment(self, e0: int, rows: list, span_i: np.ndarray,
                   span_f: np.ndarray, counts: np.ndarray, lat: np.ndarray,
                   issue: np.ndarray | None, makespans: np.ndarray,
                   snapshot: dict | None = None,
                   hops: np.ndarray | None = None) -> None:
        """Fold one segment's (L, ...) stacked telemetry into the run.

        ``hops`` (L, B, H), when given, carries the DES engine's exact
        per-hop completion times (``return_hops``) — the exporter then
        draws child slices from measured timestamps instead of anchored
        reconstructions.
        """
        span_i = np.asarray(span_i)
        span_f = np.asarray(span_f)
        counts = np.asarray(counts)
        lat = np.asarray(lat)
        makespans = np.atleast_1d(np.asarray(makespans, np.float64))
        L = len(rows)
        for i in range(L):
            n = int(counts[i, 1])
            si = span_i[i, :n]
            sf = span_f[i, :n]
            qid = si[:, SI["qid"]] if n else np.zeros(0, np.int64)
            lq = lat[i, qid].astype(np.float64)
            comps = A.decompose(si, sf, lq, self.model)
            rec = {
                "epoch": e0 + i,
                "t0": self._clock,
                "makespan": float(makespans[i]),
                "n_sampled": int(counts[i, 0]),
                "span_i": si,
                "span_f": sf,
                "lat": lq,
                "comps": comps,
                "issue": (np.asarray(issue[i])[qid].astype(np.float64)
                          if issue is not None else None),
                "hops": (np.asarray(hops[i])[qid].astype(np.float64)
                         if hops is not None else None),
            }
            self.epochs.append(rec)
            self._clock += float(makespans[i])

            row = rows[i]
            row_d = row.to_row() if hasattr(row, "to_row") else dict(row)
            entry = {"metrics": row_d,
                     "spans": [E.span_tree(rec, j, self.model)
                               for j in range(n)]}
            if snapshot:
                entry["state"] = snapshot
            self.flight.record(entry)

            slo = self.cfg.slo_p999
            if slo is not None and row_d.get("p999", 0.0) > slo:
                self.breach(
                    f"slo_p999:epoch {e0 + i} p999 "
                    f"{row_d['p999']:.1f} > {slo}"
                )
        gap = (snapshot or {}).get("conservation_gap")
        if gap not in (None, 0):
            self.breach(f"conservation:gap {gap} after epoch {e0 + L - 1}")

    def breach(self, reason: str) -> None:
        """Record a gate/invariant breach and dump the flight ring."""
        self.breaches.append(reason)
        self.flight.dump(reason)

    # -- views --------------------------------------------------------------
    @property
    def span_count(self) -> int:
        return sum(r["span_i"].shape[0] for r in self.epochs)

    def all_latency(self) -> np.ndarray:
        if not self.epochs:
            return np.zeros(0)
        return np.concatenate([r["lat"] for r in self.epochs])

    def all_comps(self) -> np.ndarray:
        if not self.epochs:
            return np.zeros((0, len(A.BUCKETS)))
        return np.concatenate([r["comps"] for r in self.epochs])

    def verify_exact(self) -> float:
        """Max |reconstructed - DES| over every sampled span (0.0 when
        the exactness contract holds; the --trace benches gate on it)."""
        lat = self.all_latency()
        if lat.size == 0:
            return 0.0
        return float(np.abs(A.reconstruct(self.all_comps()) - lat).max())

    def attribution(self, q: float = 99.9) -> dict:
        return A.tail_attribution(self.all_latency(), self.all_comps(), q)

    def retry_orbits(self) -> list[dict]:
        """Cross-epoch retry orbits stitched from the sampled spans
        (:func:`repro_torch.telemetry.export.link_retries`) — one tree per
        orbit, re-injection attempts as children, true time-to-success
        when the orbit completed inside the sampled window."""
        return E.link_retries(self.epochs, self.model)

    def summary(self) -> dict:
        out = {
            "epochs_traced": len(self.epochs),
            "spans": self.span_count,
            "spans_sampled": sum(r["n_sampled"] for r in self.epochs),
            "breaches": list(self.breaches),
            "flight_dumps": list(self.flight.dumps),
            "reconstruction_max_err": self.verify_exact(),
        }
        if self.cfg.link_retries > 0:
            orbits = self.retry_orbits()
            done = [o["time_to_success"] for o in orbits
                    if o["time_to_success"] is not None]
            out["retry_orbits"] = len(orbits)
            out["orbits_completed"] = len(done)
            out["mean_time_to_success"] = (
                float(np.mean(done)) if done else 0.0
            )
        out.update(self.timers.summary())
        return out

    # -- exports ------------------------------------------------------------
    def chrome_trace(self) -> dict:
        return E.chrome_trace(self.epochs, self.model,
                              n_clients=self.n_clients,
                              scenario=self.scenario, policy=self.policy)

    def write_chrome_trace(self, path: str) -> str:
        return E.write_chrome_trace(path, self.epochs, self.model,
                                    n_clients=self.n_clients,
                                    scenario=self.scenario,
                                    policy=self.policy)

    def write_jsonl(self, path: str) -> str:
        return E.write_jsonl(path, self.epochs, self.model)
