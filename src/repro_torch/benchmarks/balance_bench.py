"""Adaptive-balancing benchmark: the policy zoo over the scenario library
(counterpart of ``benchmarks/balance_bench.py``, its gate matrix).

Runs the port's :class:`~repro_torch.cluster.EpochDriver` (the oracle
backend) over the time-varying scenario library and emits one row per
(scenario x policy) run.  The acceptance gates (:func:`check_acceptance`;
an empty list means they pass):

* **adaptive gate**: on the Zipf-1.2 shifting hotspot, ``full_adaptive``
  must beat the frozen directory on both mean load imbalance (max/mean)
  and mean DES p99 latency;
* **splitting gate**: on the Zipf-1.3 multi-hotspot workload,
  ``split_hot`` must beat whole-range ``migrate`` on mean load imbalance
  (no worse at ``--quick``) at **equal or fewer** migrated entries;
* **built once**: every run's epoch step was built ``1 + growth_events``
  times.  The reference counts jit traces; the port has no trace to count
  and reports ``traces = 1 + growth_events`` (as ``coordination_tier/
  bench.py`` does), so this gate cannot fail until the step is captured
  as a CUDA graph per pool shape (ROADMAP 6b).

``--service lognormal|pareto`` re-runs the matrix under seeded per-hop
service draws; ``--period N`` sets the control-pull cadence (the fused
period's length, default 1), ``--period auto`` the drift-adaptive one;
``--per-epoch`` runs the per-epoch driver instead of the fused periods.
Extras, each with its own gates:

* ``--profile``: the fused against the per-epoch driver on the same
  scenario with the whole run in one period: steady epochs/s and host
  syncs; the fused driver must make strictly fewer host syncs and reach
  ``PROFILE_RATIO_GATE`` (1.2x; 0.9x at ``--quick``) the per-epoch
  epochs/s, a wall-clock gate;
* ``--trace``: the adaptive-gate pair with span sampling on: its rows
  equal the telemetry-off rows, the step was built once and every span
  reconstructs its DES latency exactly; writes a Chrome trace
  (``TRACE_torch_balance.json``, ``--trace-out``);
* ``--dist``: the dist backend on an 8-shard mesh stacked on the driver's
  device (the reference forks 8 XLA host devices; the port runs it in
  this process): flash_crowd under a tight bucket bound (overflow counts
  as client retries), and ``keyspace_growth`` under capacity pressure,
  whose pool must grow;
* ``--replication``: :mod:`repro_torch.replication.bench`'s three-mode
  comparison and its key-filter arm, with their gates.

Run: ``PYTHONPATH=src python -m repro_torch.benchmarks.balance_bench
[--quick] [--scenarios a,b] [--policies x,y] [--service kind]
[--period N|auto] [--per-epoch] [--profile] [--trace] [--dist]
[--replication] [--device cpu] [--json BENCH_torch_balance.json]
[--no-check]`` (``--device`` defaults to the CUDA card).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

DEFAULT_POLICIES = ("frozen", "migrate", "replicate", "split_hot", "full_adaptive")
DEFAULT_SCENARIOS = (
    "shifting_hotspot", "flash_crowd", "diurnal", "node_failure",
    "multi_hotspot", "keyspace_growth", "rack_failure_hotspot",
)
DIST_SCENARIO = "flash_crowd"                 # switch queue pressure case
DIST_POLICIES = ("frozen", "full_adaptive")
# gate-matrix pull cadence: 1 keeps every policy decision identical to the
# per-epoch rows, so the adaptive / splitting gates compare unchanged
# behaviour
DEFAULT_PERIOD = 1
# the --profile comparison pair
PROFILE_SCENARIO = "shifting_hotspot"
PROFILE_POLICIES = ("frozen", "full_adaptive")
# fused steady epochs/s over the per-epoch driver's, the reference's two
# levels (its quick sizes straddle 1.0 from run to run)
PROFILE_RATIO_GATE = 1.2
PROFILE_RATIO_GATE_QUICK = 0.9


# the acceptance-gate cluster geometry: fine ranges so a Zipf hot block
# spans several chains, headroom for selective replication and splitting
def cluster_config(quick: bool, service: str = "fixed",
                   period=DEFAULT_PERIOD):
    from repro_torch.cluster import ClusterConfig
    from repro_torch.core import ServiceModel

    return ClusterConfig(
        num_nodes=8,
        num_ranges=32 if quick else 128,
        replication=2,
        r_max=4 if quick else 5,
        n_clients=32,
        report_every=period,
        imbalance_threshold=1.1,
        max_moves_per_round=8,
        service_model=ServiceModel(kind=service),
    )


def scenario_config(quick: bool):
    from repro_torch.cluster import ScenarioConfig

    if quick:
        return ScenarioConfig(n_epochs=4, epoch_ops=512, n_records=1024,
                              value_dim=4, seed=1, read_ratio=0.95)
    return ScenarioConfig(n_epochs=10, epoch_ops=1024, n_records=2048,
                          value_dim=4, seed=1, read_ratio=0.95)


def scenario_kwargs(name: str, scfg) -> dict:
    mid = scfg.n_epochs // 2
    return {
        "shifting_hotspot": dict(theta=1.2, shift_every=max(scfg.n_epochs // 3, 1)),
        "flash_crowd": dict(t0=mid // 2, t1=mid + 1),
        "diurnal": {},
        "node_failure": dict(fail_epoch=mid, fail_node=0),
        "multi_hotspot": dict(theta=1.3, n_hotspots=3,
                              shift_every=max(scfg.n_epochs // 3, 1)),
        "keyspace_growth": {},
        "rack_failure_hotspot": dict(
            theta=1.2, shift_every=max(scfg.n_epochs // 3, 1),
            fail_epoch=mid, rack=(0, 1),
            recover_epoch=mid + 2 if mid + 2 < scfg.n_epochs else None,
        ),
        "ycsb_a": {},
        "stationary": {},
    }[name]


def _steady_epochs_per_s(drv, n_epochs: int, repeats: int = 1) -> float:
    """Steady-state epochs/s: re-drive the (already built) driver over the
    scenario's epochs via its real ``run()`` path.  Best of ``repeats``."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        drv.run()
        best = min(best, time.perf_counter() - t0)
    return n_epochs / best


def run_matrix(scenarios, policies, quick: bool, *, service: str = "fixed",
               backend: str = "oracle", mesh=None, dist_cfg=None,
               period=DEFAULT_PERIOD, fused: bool = True,
               measure_steady: bool = False, verbose: bool = True,
               device=None):
    from repro_torch.cluster import EpochDriver, make_policy, make_scenario, summarize

    rows = []
    for sname in scenarios:
        scfg = scenario_config(quick)
        for pname in policies:
            scen = make_scenario(sname, scfg, **scenario_kwargs(sname, scfg))
            drv = EpochDriver(scen, make_policy(pname),
                              cluster_config(quick, service, period),
                              backend=backend, mesh=mesh, dist_cfg=dist_cfg,
                              fused=fused, device=device)
            t0 = time.perf_counter()
            epochs = drv.run()
            wall = time.perf_counter() - t0
            row = summarize(epochs)
            row["wall_s"] = round(wall, 3)
            row["traces"] = 1 + drv.growth_events
            row["service"] = service
            row["backend"] = backend
            row["period"] = period
            row["fused"] = fused
            row["host_syncs"] = drv.host_syncs
            row["growth_events"] = drv.growth_events
            if drv.period_history:
                row["auto_periods"] = list(drv.period_history)
            if measure_steady and backend == "oracle":
                # the re-drive mutates driver state (fine for timing) but
                # runs AFTER the row's metrics are captured
                row["steady_eps"] = round(
                    _steady_epochs_per_s(drv, scfg.n_epochs), 2
                )
            rows.append(row)
            if verbose:
                eps = row.get("steady_eps")
                print(
                    f"{sname:20s} {pname:14s} imb {row['mean_imbalance']:5.2f} "
                    f"p99 {row['mean_p99']:6.1f} p50 {row['mean_p50']:6.1f} "
                    f"thr {row['mean_throughput']:.3f} "
                    f"ent {row['total_migration_entries']:6d} "
                    f"retries {row['total_retries']:4d} "
                    f"traces {row['traces']}"
                    + (f" steady {eps:7.2f} ep/s" if eps else "")
                )
    return rows


def check_acceptance(rows, *, quick: bool = False) -> list[str]:
    """The cluster-subsystem acceptance gates (see the module docstring).

    ``quick`` (4 epochs) relaxes the splitting gate's imbalance comparison
    to "no worse": a couple of control rounds cannot reliably separate the
    policies' imbalance means, but the keys-moved advantage and the
    built-once property must hold at any size.
    """
    by = {(r["scenario"], r["policy"]): r for r in rows
          if r.get("backend", "oracle") == "oracle" and not r.get("profile")
          and not r.get("trace")
          and r.get("bench") not in ("replication", "replication_filter")}
    problems = []
    f = by.get(("shifting_hotspot", "frozen"))
    a = by.get(("shifting_hotspot", "full_adaptive"))
    if f and a:
        if not a["mean_imbalance"] < f["mean_imbalance"]:
            problems.append(
                f"full_adaptive imbalance {a['mean_imbalance']:.2f} !< "
                f"frozen {f['mean_imbalance']:.2f}"
            )
        if not a["mean_p99"] < f["mean_p99"]:
            problems.append(
                f"full_adaptive p99 {a['mean_p99']:.1f} !< "
                f"frozen {f['mean_p99']:.1f}"
            )
    # splitting gate: hot-subset control beats whole-range migration on
    # imbalance without moving more data
    m = by.get(("multi_hotspot", "migrate"))
    s = by.get(("multi_hotspot", "split_hot"))
    if m and s:
        ok = (s["mean_imbalance"] <= m["mean_imbalance"] if quick
              else s["mean_imbalance"] < m["mean_imbalance"])
        if not ok:
            problems.append(
                f"split_hot imbalance {s['mean_imbalance']:.2f} !< "
                f"migrate {m['mean_imbalance']:.2f}"
            )
        if not s["total_migration_entries"] <= m["total_migration_entries"]:
            problems.append(
                f"split_hot moved {s['total_migration_entries']} entries "
                f"!<= migrate {m['total_migration_entries']}"
            )
    for r in rows:
        expect = 1 + r.get("growth_events", 0)
        if r["traces"] != expect:
            problems.append(
                f"{r['scenario']}/{r['policy']}: epoch step built "
                f"{r['traces']}x (expected {expect})"
            )
    return problems


def run_profile(quick: bool, device=None) -> tuple[list[dict], list[str]]:
    """The epoch-pipeline profile: the fused against the per-epoch driver,
    same scenario and config, the whole run in one control period (policy
    decisions and pulls are then the same on both sides): wall seconds,
    steady epochs/s and host syncs.

    Returns (rows, problems): the ratio gate (fused steady epochs/s at
    least ``PROFILE_RATIO_GATE`` x the per-epoch driver's, a wall-clock
    gate) and the host-sync gate (fused strictly fewer)."""
    from repro_torch.cluster import EpochDriver, make_policy, make_scenario

    scfg = scenario_config(quick)
    period = scfg.n_epochs
    rows, problems = [], []
    for pname in PROFILE_POLICIES:
        measured = {}
        for fused in (True, False):
            scen = make_scenario(
                PROFILE_SCENARIO, scfg,
                **scenario_kwargs(PROFILE_SCENARIO, scfg))
            drv = EpochDriver(scen, make_policy(pname),
                              cluster_config(quick, period=period),
                              fused=fused, device=device)
            t0 = time.perf_counter()
            drv.run()
            wall = time.perf_counter() - t0
            syncs_run = drv.host_syncs
            steady = _steady_epochs_per_s(drv, scfg.n_epochs, repeats=3)
            row = {
                "profile": True,
                "scenario": PROFILE_SCENARIO,
                "policy": pname,
                "fused": fused,
                "period": period,
                "epochs": scfg.n_epochs,
                "wall_s": round(wall, 3),
                "compile_s": round(wall - scfg.n_epochs / steady, 3),
                "steady_eps": round(steady, 2),
                "host_syncs": syncs_run,
                "host_syncs_per_epoch": round(syncs_run / scfg.n_epochs, 2),
                "traces": 1 + drv.growth_events,
            }
            measured[fused] = row
            rows.append(row)
            print(
                f"[profile] {pname:14s} {'fused' if fused else 'epoch':5s} "
                f"P={period} wall {row['wall_s']:6.2f}s "
                f"(first run ~{row['compile_s']:5.2f}s over steady) "
                f"steady {row['steady_eps']:8.2f} epochs/s "
                f"syncs/epoch {row['host_syncs_per_epoch']:5.2f} "
                f"traces {row['traces']}"
            )
        gate = PROFILE_RATIO_GATE_QUICK if quick else PROFILE_RATIO_GATE
        ratio = measured[True]["steady_eps"] / max(measured[False]["steady_eps"], 1e-9)
        if ratio < gate:
            problems.append(
                f"profile: fused steady epochs/s only {ratio:.2f}x the "
                f"per-epoch driver on {PROFILE_SCENARIO}/{pname} "
                f"(gate {gate}x)"
            )
        if not measured[True]["host_syncs"] < measured[False]["host_syncs"]:
            problems.append(
                f"profile: fused driver made {measured[True]['host_syncs']} "
                f"host syncs !< per-epoch {measured[False]['host_syncs']} "
                f"on {PROFILE_SCENARIO}/{pname}"
            )
    return rows, problems


def profile_ratios(rows: list[dict]) -> dict:
    """Each --profile policy's fused steady epochs/s over its per-epoch
    driver's."""
    by = {(r["policy"], r["fused"]): r for r in rows if r.get("profile")}
    return {p: by[(p, True)]["steady_eps"]
            / max(by[(p, False)]["steady_eps"], 1e-9)
            for p in PROFILE_POLICIES if (p, True) in by and (p, False) in by}


# the --trace pair: the adaptive-gate scenario under its winning policy
TRACE_SCENARIO = "shifting_hotspot"
TRACE_POLICY = "full_adaptive"
TRACE_ARTIFACT = "TRACE_torch_balance.json"


def trace_parity(base: list, drv, traced: list) -> tuple[float, list[str]]:
    """The telemetry column's checks, shared with the overload bench:
    ``traced`` (``drv``'s run with span sampling on) equals ``base`` (the
    same run with telemetry off) row for row, the step was built once,
    spans were recorded and each reconstructs its DES latency exactly.
    Returns (the reconstruction error, the problems)."""
    problems = []
    if [r.to_row() for r in base] != [r.to_row() for r in traced]:
        problems.append(
            "trace: telemetry-on EpochMetrics rows differ from the "
            "telemetry-off run (tracing perturbed the metric stream)")
    traces = 1 + drv.growth_events
    if traces != 1:
        problems.append(
            f"trace: epoch step built {traces}x with sampling on "
            "(expected 1)")
    err = drv.telemetry.verify_exact()
    if err != 0.0:
        problems.append(
            f"trace: span latency reconstruction off by {err!r} "
            "(must be exactly 0.0)")
    if drv.telemetry.span_count == 0:
        problems.append("trace: sampling enabled but zero spans recorded")
    return err, problems


def run_trace(quick: bool, out: str = TRACE_ARTIFACT, device=None
              ) -> tuple[list[dict], list[str]]:
    """The telemetry parity column: the adaptive-gate pair run with
    ``telemetry=None`` and with span sampling on.  Its rows must equal the
    telemetry-off rows field for field, the step must be built once, and
    every sampled span's latency buckets must sum to its DES latency with
    zero float64 error.  Writes the Chrome trace to ``out``."""
    import dataclasses

    from repro_torch.cluster import (
        EpochDriver, TelemetryConfig, make_policy, make_scenario,
    )

    scfg = scenario_config(quick)
    kw = scenario_kwargs(TRACE_SCENARIO, scfg)
    # sample aggressively at smoke sizes so the run records spans; the
    # full size uses the default 1/64 production rate
    tcfg = TelemetryConfig(sample_rate=1 / 4 if quick else 1 / 64)

    def drive(tel):
        scen = make_scenario(TRACE_SCENARIO, scfg, **kw)
        drv = EpochDriver(scen, make_policy(TRACE_POLICY),
                          dataclasses.replace(cluster_config(quick),
                                              telemetry=tel), device=device)
        return drv, drv.run()

    _, base = drive(None)
    drv, traced = drive(tcfg)
    traces = 1 + drv.growth_events
    err, problems = trace_parity(base, drv, traced)
    n_spans = drv.telemetry.span_count

    path = drv.telemetry.write_chrome_trace(out)
    summ = drv.telemetry.summary()
    row = {
        "trace": True,
        "scenario": TRACE_SCENARIO,
        "policy": TRACE_POLICY,
        "sample_rate": tcfg.sample_rate,
        "spans": n_spans,
        "n_sampled": summ["spans_sampled"],
        "reconstruction_max_err": err,
        "traces": traces,
        "parity": not problems,
        "artifact": path,
    }
    print(
        f"[trace] {TRACE_SCENARIO}/{TRACE_POLICY} spans {n_spans} "
        f"(sampled {summ['spans_sampled']}) reconstruction err {err!r} "
        f"traces {traces} -> {path}"
    )
    return [row], problems


def run_dist_parity(quick: bool, device=None) -> list[dict]:
    """The dist-backend column on an 8-shard mesh stacked on ``device``:
    the flash crowd under a tight (source, target) bucket bound, whose
    overflow is dropped and counted as client retries, and the
    ``keyspace_growth`` pool-growth row."""
    from repro_torch.core import DistConfig
    from repro_torch.core.dist_store import make_mesh

    mesh = make_mesh(8, device)
    dist_cfg = DistConfig(bucket_cap=16 if quick else 24)
    rows = run_matrix([DIST_SCENARIO], list(DIST_POLICIES), quick,
                      backend="dist", mesh=mesh, dist_cfg=dist_cfg,
                      verbose=False, device=mesh.device)
    rows.append(_dist_growth_row(mesh, quick))
    return rows


def _dist_growth_row(mesh, quick: bool) -> dict:
    """keyspace_growth under capacity pressure on the dist backend: the
    pool must grow mid-run (``growth_events`` >= 1, checked by the --dist
    gate)."""
    from repro_torch.cluster import (ClusterConfig, EpochDriver,
                                     ScenarioConfig, make_policy,
                                     make_scenario, summarize)

    scfg = ScenarioConfig(n_epochs=6 if quick else 10, epoch_ops=512,
                          n_records=2048, read_ratio=0.3, value_dim=2,
                          seed=1)
    scen = make_scenario("keyspace_growth", scfg)
    drv = EpochDriver(
        scen, make_policy("full_adaptive"),
        ClusterConfig(num_nodes=8, num_ranges=8, n_slots=8, replication=1,
                      r_max=2, capacity=64, split_overflow=True,
                      report_every=2),
        backend="dist", mesh=mesh, device=mesh.device)
    epochs = drv.run()
    row = summarize(epochs)
    row.update({
        "scenario": "keyspace_growth",
        "bench": "dist_growth",
        "backend": "dist",
        "fused": True,
        "traces": 1 + drv.growth_events,
        "growth_events": drv.growth_events,
        "host_syncs": drv.host_syncs,
    })
    return row


def check_dist(rows: list[dict]) -> list[str]:
    """The --dist gate: every dist row built ``1 + growth_events`` times,
    and the growth row's pool grew."""
    problems = []
    for r in rows:
        expect = 1 + r.get("growth_events", 0)
        if r["traces"] != expect:
            problems.append(
                f"dist {r['scenario']}/{r['policy']}: traces "
                f"{r['traces']} != 1 + growth_events ({expect})"
            )
    grow = [r for r in rows if r.get("bench") == "dist_growth"]
    if grow and grow[0]["growth_events"] < 1:
        problems.append(
            "keyspace_growth --dist never grew the pool under "
            "capacity pressure"
        )
    return problems


def main(argv=None) -> int:
    from repro_torch.benchmarks import history
    from repro_torch.benchmarks.run import card_meta
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="tiny sizes (CI smoke)")
    ap.add_argument("--scenarios", default=",".join(DEFAULT_SCENARIOS))
    ap.add_argument("--policies", default=",".join(DEFAULT_POLICIES))
    ap.add_argument("--service", default="fixed",
                    choices=("fixed", "lognormal", "pareto"),
                    help="per-hop service-time distribution (ServiceModel)")
    ap.add_argument("--dist", action="store_true",
                    help="also run the dist-backend column (8-shard mesh)")
    ap.add_argument("--period", default=str(DEFAULT_PERIOD),
                    help="control-pull cadence = fused period length "
                         f"(default {DEFAULT_PERIOD}); 'auto' adapts the "
                         "cadence to report-to-report load drift")
    ap.add_argument("--per-epoch", action="store_true",
                    help="run the per-epoch driver instead of the fused "
                         "period pipeline")
    ap.add_argument("--profile", action="store_true",
                    help="also run the fused vs per-epoch pipeline profile "
                         "(steady epochs/s and host syncs, with its gates)")
    ap.add_argument("--replication", action="store_true",
                    help="also run the three-mode replication comparison "
                         "(eventual / chain / craq tail latencies + gates)")
    ap.add_argument("--trace", action="store_true",
                    help="also run the telemetry parity column and write a "
                         "Chrome trace (see --trace-out)")
    ap.add_argument("--trace-out", default=TRACE_ARTIFACT,
                    help=f"Chrome-trace path (default {TRACE_ARTIFACT})")
    ap.add_argument("--device", default=None,
                    help="the EpochDriver's device (default: the CUDA card)")
    ap.add_argument("--json", default=None, help="write rows to this path")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the acceptance gate (exploratory runs)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    period = args.period if args.period == "auto" else int(args.period)
    scenarios = [s for s in args.scenarios.split(",") if s]
    policies = [p for p in args.policies.split(",") if p]
    rows = run_matrix(scenarios, policies, args.quick, service=args.service,
                      period=period, fused=not args.per_epoch,
                      measure_steady=True, device=dev)

    profile_problems: list[str] = []
    if args.profile:
        profile_rows, profile_problems = run_profile(args.quick, device=dev)
        rows.extend(profile_rows)

    trace_problems: list[str] = []
    if args.trace:
        trace_rows, trace_problems = run_trace(args.quick, args.trace_out,
                                               device=dev)
        rows.extend(trace_rows)

    replication_problems: list[str] = []
    if args.replication:
        from repro_torch.replication.bench import (
            check_filter_arm, check_replication, run_filter_arm,
            run_replication_matrix,
        )
        repl_rows = run_replication_matrix(args.quick, device=dev)
        replication_problems = check_replication(repl_rows)
        filter_rows = run_filter_arm(args.quick, device=dev)
        replication_problems += check_filter_arm(filter_rows)
        rows.extend(repl_rows)
        rows.extend(filter_rows)

    dist_problems: list[str] = []
    if args.dist:
        dist_rows = run_dist_parity(args.quick, device=dev)
        for r in dist_rows:
            print(
                f"[dist] {r['scenario']:14s} {r['policy']:14s} "
                f"imb {r['mean_imbalance']:5.2f} p99 {r['mean_p99']:6.1f} "
                f"retries {r['total_retries']:4d} "
                f"({r['total_retries'] / max(r['epochs'], 1):.1f}/epoch) "
                f"traces {r['traces']} grows {r.get('growth_events', 0)}"
            )
        dist_problems = check_dist(dist_rows)
        rows.extend(dist_rows)

    if args.json:
        doc = {"quick": args.quick, "service": args.service, "rows": rows}
        with open(args.json, "w") as f:
            json.dump(dict(doc, meta=card_meta(dev)), f, indent=1)
        print(f"wrote {args.json} ({len(rows)} rows)")
        history.append("balance", doc, history_path=history.beside(args.json))

    if not args.no_check:
        problems = (check_acceptance(rows, quick=args.quick)
                    + profile_problems + trace_problems
                    + replication_problems + dist_problems)
        if problems:
            print("ACCEPTANCE FAILED:")
            for p in problems:
                print("  -", p)
            return 1
        gates = []
        if "shifting_hotspot" in scenarios:
            gates.append("full_adaptive < frozen on imbalance AND p99")
        if "multi_hotspot" in scenarios:
            gates.append("split_hot < migrate on imbalance at <= entries moved")
        gates.append("all steps built once")
        if args.dist:
            gates.append("dist: traces == 1 + growth_events, pool grows "
                         "under keyspace_growth capacity pressure")
        if args.profile:
            g = PROFILE_RATIO_GATE_QUICK if args.quick else PROFILE_RATIO_GATE
            gates.append(
                f"fused steady epochs/s >= {g}x per-epoch at fewer syncs")
        if args.trace:
            gates.append(
                "telemetry: off-mode bit-parity, one built step, "
                "exact span reconstruction")
        if args.replication:
            gates.append(
                "craq clean-read p99 <= chain tail-read p99 on read-heavy "
                "diurnal; dirty bounces only (and always) under craq writes")
        print("acceptance: " + "; ".join(gates))
    return 0


if __name__ == "__main__":
    sys.exit(main())
