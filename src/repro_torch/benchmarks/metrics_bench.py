"""Fleet-metrics-plane benchmark: the parity gate and a forced-breach
incident (counterpart of ``benchmarks/metrics_bench.py``).

Two arms, both gated:

* **parity**: shifting_hotspot / full_adaptive, three drivers: metrics
  plane off (fused), on (fused), on (per-epoch).  The ``EpochMetrics``
  stream is bit-identical with the ring on and off (the plane is a pure
  observer), the fused ring equals the per-epoch ring bit for bit, and
  the step was built once (``traces = 1 + growth_events``: the reference
  counts jit traces, so this check cannot fail until the step is
  captured as a CUDA graph per pool shape, ROADMAP 6b).
* **breach**: retry_storm on the plain arm with the overload queues on:
  admission stays open, so the storm drives the fleet p999 through the
  declared SLO bound.  The burn-rate alert's firing epochs equal
  :func:`repro_torch.telemetry.slo.reference_alerts` (an independent numpy
  oracle over the same float32 series) exactly; the rising edge triggered
  a flight-recorder dump; the incident report is complete.  Artifacts, in
  ``--out-dir``: ``INCIDENT_torch_metrics_smoke.{json,md}``,
  ``METRICS_torch_view.json`` (the dashboard's input),
  ``DASH_torch_metrics.txt`` (the rendered snapshot), and the flight
  dumps; the OpenMetrics exposition is checked too.

Run: ``PYTHONPATH=src python -m repro_torch.benchmarks.metrics_bench
[--quick] [--out-dir DIR] [--device cpu] [--json BENCH_torch_metrics.json]
[--no-check]`` (``--device`` defaults to the CUDA card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# the overload bench's scenario sizes and queue physics: the breach arm is
# its retry storm on the plain arm
from repro_torch.benchmarks.overload_bench import (overload_config,
                                                   scenario_config)

SMOKE_TAG = "torch_metrics_smoke"
VIEW_ARTIFACT = "METRICS_torch_view.json"
DASH_ARTIFACT = "DASH_torch_metrics.txt"


def slo_spec(quick: bool):
    from repro_torch.telemetry.slo import SLO

    # the bound well under the storm's tail so the breach is forced; the
    # objective and windows tight enough that the alert fires in the run
    return SLO(name="p999_fleet", series="p999",
               bound=120.0 if quick else 150.0,
               objective=0.9, fast_window=2, slow_window=4,
               fast_burn=2.0, slow_burn=1.0)


# ---------------------------------------------------------------------------
# arm 1: pure-observer parity
# ---------------------------------------------------------------------------

def run_parity(quick: bool, device=None) -> tuple[list[dict], list[str]]:
    import torch

    from repro_torch.cluster import (ClusterConfig, EpochDriver, make_policy,
                                     make_scenario, summarize)
    from repro_torch.telemetry.metrics import MetricsConfig

    scfg = scenario_config(quick)

    def ccfg(metrics):
        return ClusterConfig(num_nodes=8, num_ranges=32, replication=2,
                             r_max=4, n_clients=16, report_every=2,
                             imbalance_threshold=1.1, max_moves_per_round=6,
                             metrics=metrics)

    def drive(metrics, fused):
        scen = make_scenario("shifting_hotspot", scfg,
                             theta=1.2, shift_every=2)
        drv = EpochDriver(scen, make_policy("full_adaptive"),
                          ccfg(metrics), fused=fused, device=device)
        t0 = time.perf_counter()
        rows = drv.run()
        return drv, rows, time.perf_counter() - t0

    mcfg = MetricsConfig(window=64, topk=4)
    drv_off, rows_off, _ = drive(None, True)
    drv_on, rows_on, wall = drive(mcfg, True)
    drv_ref, rows_ref, _ = drive(mcfg, False)

    problems = []
    if [r.to_row() for r in rows_off] != [r.to_row() for r in rows_on]:
        problems.append(
            "parity: metrics-on EpochMetrics rows differ from metrics-off "
            "(the ring perturbed the stream it observes)")
    if [r.to_row() for r in rows_on] != [r.to_row() for r in rows_ref]:
        problems.append("parity: fused rows differ from per-epoch rows")
    if not torch.equal(drv_on.metrics.ring.cpu(), drv_ref.metrics.ring.cpu()):
        problems.append(
            "parity: fused metrics ring != per-epoch ring (bitwise)")
    if int(drv_on.metrics.pos) != int(drv_ref.metrics.pos):
        problems.append("parity: ring pos diverged fused vs per-epoch")
    for tag, drv in (("off", drv_off), ("on", drv_on)):
        if 1 + drv.growth_events != 1:
            problems.append(f"parity: fused step (metrics {tag}) built "
                            f"{1 + drv.growth_events}x")

    row = summarize(rows_on)
    row.update(bench="metrics_parity", arm="parity", wall_s=round(wall, 3),
               traces=1 + drv_on.growth_events,
               ring_pos=int(drv_on.metrics.pos),
               n_series=drv_on.met_layout.n_series)
    return [row], problems


# ---------------------------------------------------------------------------
# arm 2: forced SLO breach -> burn alert -> incident artifact
# ---------------------------------------------------------------------------

def run_breach(quick: bool, out_dir: str = ".", device=None
               ) -> tuple[list[dict], list[str]]:
    import numpy as np

    from repro_torch.cluster import (ClusterConfig, EpochDriver,
                                     TelemetryConfig, make_policy,
                                     make_scenario, summarize)
    from repro_torch.telemetry import dashboard, incident
    from repro_torch.telemetry import metrics as MTR
    from repro_torch.telemetry import slo as SLOM
    from repro_torch.telemetry.metrics import MetricsConfig

    spec = slo_spec(quick)
    ccfg = ClusterConfig(
        num_nodes=10, num_ranges=20, replication=2,
        overload=overload_config(quick),
        standby_nodes=(8, 9), report_every=2,
        telemetry=TelemetryConfig(sample_rate=1 / 4 if quick else 1 / 64,
                                  flight_dir=out_dir, flight_epochs=4),
        metrics=MetricsConfig(window=64, slos=(spec,)),
    )
    scen = make_scenario("retry_storm", scenario_config(quick))
    drv = EpochDriver(scen, make_policy("full_adaptive"), ccfg, fused=True,
                      device=device)
    t0 = time.perf_counter()
    rows = drv.run()
    wall = time.perf_counter() - t0

    problems = []
    # ground truth: the independent numpy oracle over the same f32 series
    vals = np.asarray([r.p999 for r in rows], np.float32)
    ref = SLOM.reference_alerts(vals, spec)
    fired = drv.met_engine.firing_epochs(spec.name)
    if not fired:
        problems.append("breach: the forced p999 SLO never fired")
    if fired != ref["fire_epochs"]:
        problems.append(
            f"breach: alert firing epochs {fired} != ground truth "
            f"{ref['fire_epochs']}")
    if not any(b.startswith("slo_burn:") for b in drv.telemetry.breaches):
        problems.append("breach: rising edge did not reach the recorder")
    if not drv.telemetry.flight.dumps:
        problems.append("breach: no flight-recorder dump was written")

    # the one-command postmortem, checked for completeness
    doc = incident.report(drv, out_dir=out_dir, tag=SMOKE_TAG)
    for key in ("alerts", "slos", "metrics", "breaches", "flight_dumps",
                "p999_attribution", "stage_timers"):
        if not doc.get(key):
            problems.append(f"breach: incident report missing '{key}'")
    if "retry_orbits" not in doc:     # may legitimately be empty
        problems.append("breach: incident report missing 'retry_orbits'")
    if doc.get("alerts", {}).get("fires", 0) < 1:
        problems.append("breach: incident alert timeline has no fire")
    if "share" not in doc.get("p999_attribution", {}):
        problems.append("breach: attribution lacks bucket shares")

    # the dashboard snapshot and the OpenMetrics exposition of one view
    view = drv.metrics_view()
    view_path = os.path.join(out_dir, VIEW_ARTIFACT)
    MTR.write_view(view_path, view, alerts=drv.alert_timeline())
    with open(view_path) as f:
        snap = dashboard.render(json.load(f))
    with open(os.path.join(out_dir, DASH_ARTIFACT), "w") as f:
        f.write(snap)
    if "p999" not in snap or "fire" not in snap:
        problems.append("breach: dashboard snapshot lacks p999/alert rows")
    om = MTR.to_openmetrics(view)
    if "turbokv_p999" not in om or not om.endswith("# EOF\n"):
        problems.append("breach: OpenMetrics exposition malformed")

    row = summarize(rows)
    row.update(bench="metrics_breach", arm="breach", wall_s=round(wall, 3),
               traces=1 + drv.growth_events, slo_bound=spec.bound,
               fire_epochs=fired, ref_fire_epochs=ref["fire_epochs"],
               alert_fires=doc["alerts"]["fires"],
               flight_dumps=len(drv.telemetry.flight.dumps),
               incident_paths=doc.get("paths", []))
    return [row], problems


def gate_doc(quick: bool, rows: list[dict], prob_p: list[str],
             prob_b: list[str]) -> dict:
    """The bench JSON: the rows and the three gates' verdicts."""
    return {"quick": quick, "parity_ok": not prob_p,
            "alert_epoch_ok": not any("firing" in p or "never fired" in p
                                      for p in prob_b),
            "incident_complete": not any("incident" in p for p in prob_b),
            "rows": rows}


def main(argv=None) -> int:
    from repro_torch.benchmarks import history
    from repro_torch.benchmarks.run import card_meta
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--json", default=None, help="write rows to this path")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--device", default=None,
                    help="the EpochDriver's device (default: the CUDA card)")
    ap.add_argument("--no-check", action="store_true")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    rows_p, prob_p = run_parity(args.quick, device=dev)
    rows_b, prob_b = run_breach(args.quick, args.out_dir, device=dev)
    rows = rows_p + rows_b
    problems = prob_p + prob_b
    for r in rows:
        print(f"{r['bench']:16s} wall {r['wall_s']:7.2f}s "
              f"traces {r['traces']}")

    doc = gate_doc(args.quick, rows, prob_p, prob_b)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(doc, meta=card_meta(dev)), f, indent=1,
                      default=str)
        print(f"wrote {args.json} ({len(rows)} rows)")
        history.append("metrics", doc, history_path=history.beside(args.json))

    if not args.no_check and problems:
        print("\nGATE FAILURES:", file=sys.stderr)
        for p in problems:
            print(f"  - {p}", file=sys.stderr)
        return 1
    print("metrics gates: OK" if not problems else
          f"metrics gates: {len(problems)} problem(s) (unchecked)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
