"""Scale-out benchmark: the dist-backend period pipeline on an 8-shard mesh
(counterpart of ``benchmarks/dist_bench.py``).

Four drivers run the same shifting-hotspot scenario under the same
adaptive policy and report steady-state epochs/s, host syncs an epoch and
per-stage wall seconds:

* ``single_host``: the oracle backend at the default control cadence
  (period 1);
* ``single_host_fused``: the same with the whole run in one period;
* ``dist_epoch``: the dist backend stepped once an epoch, whole-run
  period;
* ``dist_fused``: the dist backend with whole periods fused, whole-run
  period.

The reference forks a subprocess with 8 forced XLA host devices; the
port's mesh (:func:`repro_torch.core.dist_store.make_mesh`) stacks the 8
storage nodes on one device under one controller, so all four drivers run
in this process.

Gates (skipped with ``--no-check``):

* **parity**: ``dist_fused`` equals ``dist_epoch`` bit for bit (the
  ``EpochMetrics`` stream and the final store) and was built once;
* **ratio**: ``single_host`` steady epochs/s is at most ``RATIO_GATE``
  (2x) ``dist_fused``'s: a wall-clock gate;
* **syncs**: ``dist_fused`` makes no more host syncs an epoch than
  ``dist_epoch``.

The reference counts jit traces; the port reports ``traces = 1 +
growth_events``, so the built-once check cannot fail until the step is
captured as a CUDA graph per pool shape (ROADMAP 6b).

Run: ``PYTHONPATH=src python -m repro_torch.benchmarks.dist_bench
[--quick] [--device cpu] [--json BENCH_torch_dist.json] [--no-check]``
(``--device`` defaults to the CUDA card).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

SCENARIO = "shifting_hotspot"
POLICY = "full_adaptive"
RATIO_GATE = 2.0
N_SHARDS = 8


def _stage_breakdown(drv) -> dict:
    s = drv.telemetry.timers.summary()
    return {"stage_s": s["stage_s"], "stage_share": s["stage_share"]}


def run(quick: bool, device=None) -> tuple[list[dict], list[str]]:
    """The four drivers' rows and the parity gate's findings."""
    import torch

    from repro_torch.benchmarks.balance_bench import (
        _steady_epochs_per_s, cluster_config, scenario_config,
        scenario_kwargs,
    )
    from repro_torch.cluster import (EpochDriver, TelemetryConfig,
                                     make_policy, make_scenario, summarize)
    from repro_torch.core import DistConfig
    from repro_torch.core.dist_store import make_mesh
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    mesh = make_mesh(N_SHARDS, device)
    scfg = scenario_config(quick)
    kw = scenario_kwargs(SCENARIO, scfg)
    # dist rows fuse the whole run into one control period; the bucket
    # bound is the balance bench's switch-queue pressure column's
    period = scfg.n_epochs
    dist_cfg = DistConfig(bucket_cap=16 if quick else 24)
    variants = (
        ("single_host", "oracle", True, 1),
        ("single_host_fused", "oracle", True, period),
        ("dist_epoch", "dist", False, period),
        ("dist_fused", "dist", True, period),
    )

    def driver(backend, fused, per, telemetry=None):
        ccfg = cluster_config(quick, period=per)
        if telemetry is not None:
            ccfg = dataclasses.replace(ccfg, telemetry=telemetry)
        dist = backend == "dist"
        return EpochDriver(make_scenario(SCENARIO, scfg, **kw),
                           make_policy(POLICY), ccfg, backend=backend,
                           mesh=mesh if dist else None,
                           dist_cfg=dist_cfg if dist else None,
                           fused=fused, device=device)

    rows, finals = [], {}
    for name, backend, fused, per in variants:
        drv = driver(backend, fused, per)
        t0 = time.perf_counter()
        epochs = drv.run()
        wall = time.perf_counter() - t0
        syncs_run = drv.host_syncs  # before the steady re-runs add theirs
        steady = _steady_epochs_per_s(drv, scfg.n_epochs, repeats=3)
        finals[name] = (drv, epochs)

        # a separate profiled pass, so the timed runs carry no telemetry
        drv_p = driver(backend, fused, per,
                       TelemetryConfig(sample_rate=1.0 / 64.0))
        drv_p.run()

        row = summarize(epochs)
        row.update({
            "bench": "dist_scaleout",
            "variant": name,
            "backend": backend,
            "fused": fused,
            "period": per,
            "epochs": scfg.n_epochs,
            "wall_s": round(wall, 3),
            "steady_eps": round(steady, 2),
            "host_syncs": syncs_run,
            "host_syncs_per_epoch": round(syncs_run / scfg.n_epochs, 2),
            "traces": 1 + drv.growth_events,
            **_stage_breakdown(drv_p),
        })
        rows.append(row)

    # bit parity: fused dist against per-epoch dist (the stores after the
    # steady re-runs, as the reference compares them)
    problems = []
    (drv_r, ep_r), (drv_f, ep_f) = finals["dist_epoch"], finals["dist_fused"]
    for a, b in zip(ep_r, ep_f):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        for k in da:
            if da[k] != db[k]:
                problems.append(
                    f"parity: epoch {a.epoch} field {k}: {da[k]} != {db[k]}")
    for f in ("keys", "values", "overflow"):
        if not torch.equal(getattr(drv_r.store, f).cpu(),
                           getattr(drv_f.store, f).cpu()):
            problems.append(f"parity: final store field {f} differs")
    traces = 1 + drv_f.growth_events
    if traces != 1:
        problems.append(f"dist_fused rebuilt: {traces} != 1")
    return rows, problems


def ratios(rows: list[dict]) -> tuple[float, float]:
    """``single_host`` and ``single_host_fused`` steady epochs/s over
    ``dist_fused``'s."""
    by = {r["variant"]: r for r in rows if r.get("bench") == "dist_scaleout"}
    d = max(by["dist_fused"]["steady_eps"], 1e-9)
    return (by["single_host"]["steady_eps"] / d,
            by["single_host_fused"]["steady_eps"] / d)


def check(rows: list[dict]) -> list[str]:
    """The ratio (wall clock) and syncs gates."""
    by = {r["variant"]: r for r in rows if r.get("bench") == "dist_scaleout"}
    problems = []
    ratio, roofline = ratios(rows)
    print(f"ratio vs single_host {ratio:.2f}x (gate {RATIO_GATE}x); "
          f"vs fused roofline {roofline:.2f}x (informational)")
    if ratio > RATIO_GATE:
        problems.append(
            f"ratio: single-host is {ratio:.2f}x dist_fused steady epochs/s "
            f"(gate {RATIO_GATE}x)")
    if (by["dist_fused"]["host_syncs_per_epoch"]
            > by["dist_epoch"]["host_syncs_per_epoch"]):
        problems.append(
            f"syncs: dist_fused {by['dist_fused']['host_syncs_per_epoch']}"
            f"/epoch > dist_epoch "
            f"{by['dist_epoch']['host_syncs_per_epoch']}/epoch")
    return problems


def main(argv=None) -> int:
    from repro_torch.benchmarks import history
    from repro_torch.benchmarks.run import card_meta
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true", help="CI smoke sizes")
    ap.add_argument("--device", default=None,
                    help="the drivers' device (default: the CUDA card)")
    ap.add_argument("--json", default=None, help="write rows to this path")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the gates (exploratory runs)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    rows, problems = run(args.quick, device=dev)
    for row in rows:
        shares = ", ".join(f"{k} {v:.0%}"
                           for k, v in sorted(row["stage_share"].items(),
                                              key=lambda kv: -kv[1]))
        print(f"{row['variant']:12s} steady {row['steady_eps']:8.2f} ep/s "
              f"wall {row['wall_s']:6.2f}s "
              f"syncs/epoch {row['host_syncs_per_epoch']:5.2f} "
              f"traces {row['traces']}  [{shares}]")

    if args.json:
        doc = {"quick": args.quick, "meta": card_meta(dev), "rows": rows}
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"wrote {args.json} ({len(rows)} rows)")
        history.append("dist", doc, history_path=history.beside(args.json))

    if not args.no_check:
        problems = problems + check(rows)
        if problems:
            print("ACCEPTANCE FAILED:")
            for p in problems:
                print(" -", p)
            return 1
        print("acceptance: dist_fused bit-identical to dist_epoch; "
              f"single-host <= {RATIO_GATE}x dist_fused steady epochs/s; "
              "fused syncs/epoch <= per-epoch")
    return 0


if __name__ == "__main__":
    sys.exit(main())
