"""The three-mode replication comparison and its gates (counterpart of
``repro.replication.bench``).

Runs ``eventual`` / ``chain`` / ``craq`` over write-mix workloads (a
diurnal read/write swing, a write-heavy flash crowd and YCSB-A's 50/50
mix) under ``frozen`` (the protocol-pure comparison: no migration or
widening) and ``full_adaptive``, and reports the consistency/latency trade
as per-mode tail latencies.  :func:`run_filter_arm` measures what the
hashed per-key dirty filter buys on YCSB-A.

Gates (:func:`check_replication`, :func:`check_filter_arm`; empty lists
mean they pass):

1. on the read-heavy phase of the diurnal swing under ``frozen``, craq's
   clean-read p99 must not exceed chain's tail-read p99;
2. craq must report dirty-read bounces under YCSB-A, eventual and chain
   none, and under ``frozen`` the chain rows must equal the eventual rows
   (with no widening, chain replication is tail reads over the base
   chain);
3. every run's step was built once: the reference counts jit traces, the
   port has no traces and reports ``1 + growth_events``;
4. the F = 64 filter must strictly cut craq's bounces without raising the
   read p99.

``run_*`` take ``device`` (None = the CUDA card, as for the driver).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.replication.protocol import REPLICATION_MODES

# read_ratio(e) at or above this marks a "read-heavy" epoch (gate 1)
READ_HEAVY = 0.8
BENCH_POLICIES = ("frozen", "full_adaptive")
REPLICATION_SCENARIOS = ("diurnal", "flash_crowd", "ycsb_a")


def _scenario(name: str, quick: bool):
    from repro_torch.cluster import ScenarioConfig, make_scenario

    if quick:
        base = dict(n_epochs=6, epoch_ops=512, n_records=1024, value_dim=4,
                    seed=1)
    else:
        base = dict(n_epochs=12, epoch_ops=1024, n_records=2048, value_dim=4,
                    seed=1)
    if name == "diurnal":
        return make_scenario("diurnal", ScenarioConfig(**base),
                             lo=0.35, hi=0.98)
    if name == "flash_crowd":
        cfg = ScenarioConfig(**base, read_ratio=0.75)
        return make_scenario("flash_crowd", cfg,
                             t0=cfg.n_epochs // 3, t1=2 * cfg.n_epochs // 3)
    if name == "ycsb_a":
        return make_scenario("ycsb_a", ScenarioConfig(**base))
    raise ValueError(f"unknown replication bench scenario {name!r}")


def _cluster_cfg(quick: bool, mode: str):
    from repro_torch.cluster import ClusterConfig

    return ClusterConfig(
        num_nodes=8,
        num_ranges=32 if quick else 128,
        replication=2,
        r_max=4 if quick else 5,
        n_clients=32,
        report_every=1,
        imbalance_threshold=1.1,
        max_moves_per_round=8,
        replication_mode=mode,
    )


def _traces(drv) -> int:
    return 1 + drv.growth_events


def run_replication_matrix(quick: bool, *, policies=BENCH_POLICIES,
                           verbose: bool = True, device=None) -> list[dict]:
    """One row per (scenario x replication mode x policy), plus the phase
    split gate 1 needs: read-heavy vs write-heavy epoch means."""
    from repro_torch.cluster import EpochDriver, make_policy, summarize

    rows = []
    for sname in REPLICATION_SCENARIOS:
        for policy, mode in ((p, m) for p in policies
                             for m in REPLICATION_MODES):
            scen = _scenario(sname, quick)
            drv = EpochDriver(scen, make_policy(policy),
                              _cluster_cfg(quick, mode), device=device)
            t0 = time.perf_counter()
            epochs = drv.run()
            wall = time.perf_counter() - t0

            heavy = np.array([scen.read_ratio(r.epoch) >= READ_HEAVY
                              for r in epochs])
            read_p99 = np.array([r.read_p99 for r in epochs])
            clean_p99 = np.array([r.clean_read_p99 for r in epochs])
            p99 = np.array([r.p99 for r in epochs])

            row = summarize(epochs)
            row.update({
                "bench": "replication",
                "wall_s": round(wall, 3),
                "traces": _traces(drv),
                "backend": "oracle",
                "period": 1,
                "fused": True,
                "host_syncs": drv.host_syncs,
                "read_heavy_epochs": int(heavy.sum()),
                "read_heavy_read_p99": (
                    float(read_p99[heavy].mean()) if heavy.any() else 0.0),
                "read_heavy_clean_p99": (
                    float(clean_p99[heavy].mean()) if heavy.any() else 0.0),
                "write_heavy_p99": (
                    float(p99[~heavy].mean()) if (~heavy).any() else 0.0),
            })
            rows.append(row)
            if verbose:
                print(
                    f"[replication] {sname:12s} {policy:13s} {mode:8s} "
                    f"p99 {row['mean_p99']:6.1f} p999 {row['mean_p999']:6.1f} "
                    f"read_p99 {row['mean_read_p99']:6.1f} "
                    f"clean_p99 {row['mean_clean_read_p99']:6.1f} "
                    f"dirty {row['total_dirty_reads']:5d} "
                    f"traces {row['traces']}"
                )
    return rows


def run_filter_arm(quick: bool, *, verbose: bool = True,
                   device=None) -> list[dict]:
    """craq on YCSB-A under ``frozen`` at filter widths 0 and 64: identical
    routing and writes, only who bounces changes."""
    from repro_torch.cluster import EpochDriver, make_policy, summarize

    rows = []
    for fbits in (0, 64):
        scen = _scenario("ycsb_a", quick)
        cfg = dataclasses.replace(_cluster_cfg(quick, "craq"),
                                  craq_filter_bits=fbits)
        drv = EpochDriver(scen, make_policy("frozen"), cfg, device=device)
        t0 = time.perf_counter()
        epochs = drv.run()
        wall = time.perf_counter() - t0
        row = summarize(epochs)
        row.update({
            "bench": "replication_filter",
            "wall_s": round(wall, 3),
            "traces": _traces(drv),
            "backend": "oracle",
            "filter_bits": fbits,
        })
        rows.append(row)
        if verbose:
            print(
                f"[repl-filter]  ycsb_a       frozen        craq     "
                f"F={fbits:<3d} dirty {row['total_dirty_reads']:5d} "
                f"read_p99 {row['mean_read_p99']:6.1f} "
                f"traces {row['traces']}"
            )
    return rows


def check_filter_arm(rows: list[dict]) -> list[str]:
    """Gate 4: the filter must strictly cut the bounce count without
    raising the read tail."""
    by = {r["filter_bits"]: r for r in rows
          if r.get("bench") == "replication_filter"}
    problems: list[str] = []
    if not by:
        return problems
    base, filt = by.get(0), by.get(64)
    if base is None or filt is None:
        return ["replication_filter: missing the F=0 or F=64 arm"]
    if base["total_dirty_reads"] <= 0:
        problems.append("replication_filter: baseline craq opened no "
                        "dirty window on ycsb_a")
    if not filt["total_dirty_reads"] < base["total_dirty_reads"]:
        problems.append(
            f"replication_filter: F=64 dirty reads "
            f"{filt['total_dirty_reads']} !< slot-granular baseline "
            f"{base['total_dirty_reads']} (the filter bought nothing)"
        )
    if not filt["mean_read_p99"] <= base["mean_read_p99"]:
        problems.append(
            f"replication_filter: F=64 read p99 "
            f"{filt['mean_read_p99']:.1f} !<= slot-granular baseline "
            f"{base['mean_read_p99']:.1f}"
        )
    for r in rows:
        if r.get("bench") == "replication_filter" and r["traces"] != 1:
            problems.append(
                f"replication_filter: F={r['filter_bits']} step built "
                f"{r['traces']}x (expected 1)"
            )
    return problems


def check_replication(rows: list[dict]) -> list[str]:
    """Gates 1-3 (see the module docstring)."""
    by = {(r["scenario"], r["replication"], r["policy"]): r for r in rows
          if r.get("bench") == "replication"}
    problems: list[str] = []

    craq = by.get(("diurnal", "craq", "frozen"))
    chain = by.get(("diurnal", "chain", "frozen"))
    if craq and chain:
        if craq["read_heavy_epochs"] == 0:
            problems.append("replication: diurnal sweep has no read-heavy "
                            "phase — gate 1 is vacuous")
        elif not (craq["read_heavy_clean_p99"]
                  <= chain["read_heavy_read_p99"]):
            problems.append(
                f"replication: craq clean-read p99 "
                f"{craq['read_heavy_clean_p99']:.1f} !<= chain tail-read "
                f"p99 {chain['read_heavy_read_p99']:.1f} on the diurnal "
                f"read-heavy phase (frozen)"
            )

    for (sname, mode, policy), r in by.items():
        if mode in ("eventual", "chain") and r["total_dirty_reads"] != 0:
            problems.append(
                f"replication: {sname}/{mode}/{policy} reported "
                f"{r['total_dirty_reads']} dirty-read bounces (must be 0)"
            )
        if mode == "chain" and policy == "frozen":
            ev = by.get((sname, "eventual", "frozen"))
            if ev is not None:
                for k in ("mean_p99", "mean_read_p99", "mean_throughput",
                          "mean_imbalance"):
                    if r[k] != ev[k]:
                        problems.append(
                            f"replication: {sname}/frozen chain {k} "
                            f"{r[k]:.4f} != eventual {ev[k]:.4f} (with no "
                            f"widening these must coincide exactly)"
                        )
    for policy in ("frozen", "full_adaptive"):
        ya = by.get(("ycsb_a", "craq", policy))
        if ya and ya["total_dirty_reads"] <= 0:
            problems.append(
                f"replication: craq/{policy} reported no dirty-read bounces "
                "on the write-heavy ycsb_a mix — the dirty window never "
                "opened"
            )

    for r in rows:
        if r.get("bench") == "replication" and r["traces"] != 1:
            problems.append(
                f"replication: {r['scenario']}/{r['replication']} step "
                f"built {r['traces']}x (expected 1)"
            )
    return problems
