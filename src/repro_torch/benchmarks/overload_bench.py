"""Overload-survival benchmark: the closed loop against the retry storm
(counterpart of ``benchmarks/overload_bench.py``).

Runs the two overload stressors (``cascade_failure``: a rack dies for
good and the survivors inherit its traffic; ``retry_storm``: a transient
outage whose shed queries re-fire together on recovery) with the overload
plane (:mod:`repro_torch.overload`) on in both arms, identical queue
physics and standby reserve, only the control plane differing:

* ``plain``: ``full_adaptive``; admission stays open, retry re-entry is
  unbounded, the standby reserve is never recruited;
* ``controlled``: ``overload_adaptive``; AIMD admission, retry budgets
  and capacity autoscale onto the reserve.

**Survival gate** (:func:`check_survival`, per scenario): the controlled
arm loses no query, ends with a retry backlog under ``BACKLOG_FRAC`` of
what was injected and keeps its worst p999 within ``P999_BOUND``; the
plain arm breaks at least one of the three; every run has
``conservation_gap == 0`` and built its step once.  The reference counts
jit traces; the port reports ``traces = 1 + growth_events``, so the
built-once check cannot fail until the step is captured as a CUDA graph
per pool shape (ROADMAP 6b).

``--trace`` also runs the retry storm's controlled arm with span sampling
on: telemetry-off rows equal telemetry-on rows, spans reconstruct their
DES latency exactly; it writes a Chrome trace (``TRACE_torch_overload.json``)
and the p999 attribution (``ATTRIB_torch_retry_storm.json``).

Run: ``PYTHONPATH=src python -m repro_torch.benchmarks.overload_bench
[--quick] [--scenarios a,b] [--trace] [--device cpu]
[--json BENCH_torch_overload.json] [--no-check]`` (``--device`` defaults
to the CUDA card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

SCENARIOS = ("cascade_failure", "retry_storm")
ARMS = (("plain", "full_adaptive"), ("controlled", "overload_adaptive"))

# survival-gate bounds: p999 is in DES ticks and scales with the epoch,
# so each size has its own bound; the backlog fraction does not
P999_BOUND = {True: 350.0, False: 400.0}
BACKLOG_FRAC = 0.02


def overload_config(quick: bool):
    from repro_torch.overload import OverloadConfig

    # queue_cap ~ 60 % of a survivor's post-failure epoch share, service
    # just above the pre-failure share: stable until the rack dies
    if quick:
        return OverloadConfig(queue_cap=48, service_rate=80, inflation=3.0,
                              max_level=3, backoff_base=1, jitter_span=2,
                              queue_weight=2)
    return OverloadConfig(queue_cap=192, service_rate=320, inflation=3.0,
                          max_level=3, backoff_base=1, jitter_span=2,
                          queue_weight=2)


def scenario_config(quick: bool):
    from repro_torch.cluster import ScenarioConfig

    if quick:
        return ScenarioConfig(n_epochs=16, epoch_ops=512, n_records=2048,
                              value_dim=4, seed=7)
    return ScenarioConfig(n_epochs=24, epoch_ops=2048, n_records=4096,
                          value_dim=8, seed=7)


def cluster_config(quick: bool):
    from repro_torch.cluster import ClusterConfig

    return ClusterConfig(num_nodes=10, num_ranges=20, replication=2,
                         overload=overload_config(quick),
                         standby_nodes=(8, 9), report_every=2)


def policy_for(arm: str):
    from repro_torch.cluster import PolicyConfig, make_policy

    if arm == "controlled":
        return make_policy("overload_adaptive",
                           PolicyConfig(scale_patience=1))
    return make_policy("full_adaptive")


def run_matrix(scenarios, quick: bool, verbose: bool = True, device=None):
    from repro_torch.cluster import EpochDriver, make_scenario, summarize
    from repro_torch.overload import conservation_gap

    rows = []
    for sname in scenarios:
        for arm, _ in ARMS:
            scen = make_scenario(sname, scenario_config(quick))
            drv = EpochDriver(scen, policy_for(arm), cluster_config(quick),
                              device=device)
            t0 = time.perf_counter()
            epochs = drv.run()
            wall = time.perf_counter() - t0
            row = summarize(epochs)
            row.update(drv.overload_summary())
            row["arm"] = arm
            row["wall_s"] = round(wall, 3)
            row["traces"] = 1 + drv.growth_events
            row["conservation_gap"] = conservation_gap(drv.ovl)
            row["autoscale_events"] = [
                e for r in epochs for e in r.events
                if e.startswith("autoscale_")
            ]
            rows.append(row)
            if verbose:
                print(
                    f"{sname:16s} {arm:10s} lost {row['lost']:5d} "
                    f"backlog {row['retry_backlog']:5d} "
                    f"shed {row['total_shed']:5d} "
                    f"deferred {row['total_deferred']:5d} "
                    f"max_p999 {row['max_p999']:7.1f} "
                    f"traces {row['traces']}"
                )
    return rows


TRACE_SCENARIO = "retry_storm"
TRACE_ARM = "controlled"
TRACE_ARTIFACT = "TRACE_torch_overload.json"
ATTRIB_ARTIFACT = "ATTRIB_torch_retry_storm.json"
ATTRIB_Q = 99.9


def run_trace(quick: bool, out_dir: str = ".", device=None
              ) -> tuple[list[dict], list[str]]:
    """The telemetry column: retry storm, controlled arm, sampling on.

    Checks that the telemetry-on rows equal the telemetry-off rows, that
    the step was built once and that every span reconstructs its DES
    latency exactly; writes the Chrome trace and the p999 attribution."""
    import dataclasses

    from repro_torch.benchmarks.balance_bench import trace_parity
    from repro_torch.cluster import EpochDriver, TelemetryConfig, make_scenario

    scfg = scenario_config(quick)
    tcfg = TelemetryConfig(sample_rate=1 / 4 if quick else 1 / 64)

    def drive(tel):
        scen = make_scenario(TRACE_SCENARIO, scfg)
        drv = EpochDriver(scen, policy_for(TRACE_ARM),
                          dataclasses.replace(cluster_config(quick),
                                              telemetry=tel), device=device)
        return drv, drv.run()

    _, base = drive(None)
    drv, traced = drive(tcfg)
    traces = 1 + drv.growth_events
    err, problems = trace_parity(base, drv, traced)

    path = drv.telemetry.write_chrome_trace(
        os.path.join(out_dir, TRACE_ARTIFACT))
    attrib_out = os.path.join(out_dir, ATTRIB_ARTIFACT)
    attrib = drv.telemetry.attribution(ATTRIB_Q)
    with open(attrib_out, "w") as f:
        json.dump({"scenario": TRACE_SCENARIO, "arm": TRACE_ARM,
                   "quick": quick, "sample_rate": tcfg.sample_rate,
                   "spans": drv.telemetry.span_count,
                   "attribution": attrib}, f, indent=1)

    row = {
        "trace": True,
        "scenario": TRACE_SCENARIO,
        "arm": TRACE_ARM,
        "sample_rate": tcfg.sample_rate,
        "spans": drv.telemetry.span_count,
        "reconstruction_max_err": err,
        "traces": traces,
        "parity": not problems,
        "attribution": attrib,
        "artifacts": [path, attrib_out],
    }
    share = attrib.get("share", {})
    top = max(share, key=share.get) if share else "n/a"
    print(
        f"[trace] {TRACE_SCENARIO}/{TRACE_ARM} spans {row['spans']} "
        f"reconstruction err {err!r} traces {traces}; p{ATTRIB_Q} "
        f"tail mass mostly '{top}' "
        f"({share.get(top, 0.0):.0%}) -> {path}, {attrib_out}"
    )
    return [row], problems


def check_survival(rows, *, quick: bool) -> list[str]:
    """The survival gate: controlled survives, plain collapses."""
    bound = P999_BOUND[quick]
    rows = [r for r in rows if not r.get("trace")]
    by = {(r["scenario"], r["arm"]): r for r in rows}
    problems = []

    def violations(r):
        v = []
        if r["lost"] > 0:
            v.append(f"lost {r['lost']} queries")
        if r["retry_backlog"] > BACKLOG_FRAC * r["injected"]:
            v.append(f"standing backlog {r['retry_backlog']}")
        if r["max_p999"] > bound:
            v.append(f"p999 {r['max_p999']:.1f} > {bound}")
        return v

    for r in rows:
        if r["conservation_gap"] != 0:
            problems.append(
                f"{r['scenario']}/{r['arm']}: conservation gap "
                f"{r['conservation_gap']} (queries leaked)")
        if r["traces"] != 1:
            problems.append(
                f"{r['scenario']}/{r['arm']}: {r['traces']} built "
                f"steps (expected 1)")

    for scen in sorted({r["scenario"] for r in rows}):
        ctrl = by.get((scen, "controlled"))
        plain = by.get((scen, "plain"))
        if ctrl:
            v = violations(ctrl)
            if v:
                problems.append(f"{scen}/controlled did not survive: "
                                + "; ".join(v))
            if not ctrl["autoscale_events"]:
                problems.append(
                    f"{scen}/controlled never recruited the reserve")
        if plain and not violations(plain):
            problems.append(
                f"{scen}/plain survived — the stressor is not stressing "
                f"(lost 0, backlog {plain['retry_backlog']}, "
                f"p999 {plain['max_p999']:.1f})")
    return problems


def main(argv=None) -> int:
    from repro_torch.benchmarks import history
    from repro_torch.benchmarks.run import card_meta
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke sizes (16 epochs x 512 ops)")
    ap.add_argument("--scenarios", default=",".join(SCENARIOS))
    ap.add_argument("--trace", action="store_true",
                    help="also run the telemetry column on the retry storm "
                         "and write the Chrome trace and p999 attribution")
    ap.add_argument("--device", default=None,
                    help="the EpochDriver's device (default: the CUDA card)")
    ap.add_argument("--json", default=None, help="write rows to this path")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the survival gate (exploratory runs)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    scenarios = [s for s in args.scenarios.split(",") if s]
    rows = run_matrix(scenarios, args.quick, device=dev)

    trace_problems: list[str] = []
    if args.trace:
        trace_rows, trace_problems = run_trace(args.quick, device=dev)
        rows.extend(trace_rows)

    if args.json:
        doc = {"quick": args.quick, "meta": card_meta(dev), "rows": rows}
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"wrote {args.json} ({len(rows)} rows)")
        history.append("overload", doc, history_path=history.beside(args.json))

    if not args.no_check:
        problems = check_survival(rows, quick=args.quick) + trace_problems
        if problems:
            print("SURVIVAL GATE FAILED:")
            for p in problems:
                print("  -", p)
            return 1
        print("survival gate: controlled arm lost 0 queries, drained its "
              "backlog and kept p999 bounded on every scenario; the "
              "uncontrolled arm collapsed on every scenario; accounting "
              "conserved; one built step per run"
              + ("; telemetry parity + exact reconstruction held"
                 if args.trace else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
