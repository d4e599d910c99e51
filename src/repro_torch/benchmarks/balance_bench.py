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
period's length, default 1), ``--period auto`` the drift-adaptive one.
The reference's ``--dist``, ``--profile``, ``--trace`` and
``--replication`` extras are not ported.

Run: ``PYTHONPATH=src python -m repro_torch.benchmarks.balance_bench
[--quick] [--scenarios a,b] [--policies x,y] [--service kind]
[--period N|auto] [--device cpu] [--json BENCH_torch_balance.json]
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
# gate-matrix pull cadence: 1 keeps every policy decision identical to the
# per-epoch rows, so the adaptive / splitting gates compare unchanged
# behaviour
DEFAULT_PERIOD = 1


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
               period=DEFAULT_PERIOD, measure_steady: bool = False,
               verbose: bool = True, device=None):
    from repro_torch.cluster import EpochDriver, make_policy, make_scenario, summarize

    rows = []
    for sname in scenarios:
        scfg = scenario_config(quick)
        for pname in policies:
            scen = make_scenario(sname, scfg, **scenario_kwargs(sname, scfg))
            drv = EpochDriver(scen, make_policy(pname),
                              cluster_config(quick, service, period),
                              device=device)
            t0 = time.perf_counter()
            epochs = drv.run()
            wall = time.perf_counter() - t0
            row = summarize(epochs)
            row["wall_s"] = round(wall, 3)
            row["traces"] = 1 + drv.growth_events
            row["service"] = service
            row["backend"] = "oracle"
            row["period"] = period
            row["fused"] = True
            row["host_syncs"] = drv.host_syncs
            row["growth_events"] = drv.growth_events
            if drv.period_history:
                row["auto_periods"] = list(drv.period_history)
            if measure_steady:
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


def main(argv=None) -> int:
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
    ap.add_argument("--period", default=str(DEFAULT_PERIOD),
                    help="control-pull cadence = fused period length "
                         f"(default {DEFAULT_PERIOD}); 'auto' adapts the "
                         "cadence to report-to-report load drift")
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
                      period=period, measure_steady=True, device=dev)

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"quick": args.quick, "service": args.service,
                       "meta": card_meta(dev), "rows": rows}, f, indent=1)
        print(f"wrote {args.json} ({len(rows)} rows)")

    if not args.no_check:
        problems = check_acceptance(rows, quick=args.quick)
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
        print("acceptance: " + "; ".join(gates))
    return 0


if __name__ == "__main__":
    sys.exit(main())
