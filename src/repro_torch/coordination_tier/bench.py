"""The coordination-tier benchmark and its gates (counterpart of
``benchmarks/coordination_tier_bench.py``).

Three columns over the switch-replicated directory tier:

* **staleness sweep**: ``shifting_hotspot`` under ``full_adaptive`` with
  the per-hop install lag swept over ``SWEEP_LAGS``; a longer lag widens
  the window in which ingress copies disagree with the quorum commit, so
  the redirect share must grow with it while lag 0 stays redirect-free;
* **parity arm**: the zero-lag tier against ``coordination=None``, equal on
  every non-coordination field of the metric stream;
* **fault arms**: ``lease_expiry`` and ``split_brain`` under the quorum arm
  and the trusting baseline (``quorum=False``).

Gates (:func:`check_coordination`; an empty list means they pass): exact
conservation ``routed == direct + redirected == epoch batch`` on every
row; zero lag redirects and mis-serves nothing; lag 1 redirects, and the
share does not shrink at the largest lag; the quorum arm mis-serves
nothing; parity rows equal; under both faults the quorum arm mis-serves
nothing and redirects, the baseline mis-serves and never redirects; lease
expiry fails over; every run's step was built once (the reference counts
jit traces, the port reports ``1 + growth_events``).

``run_*`` take ``device`` (None = the CUDA card, as for the driver).
"""

from __future__ import annotations

import dataclasses
import time

SWEEP_LAGS = (0, 1, 2, 4)
SWEEP_SCENARIO = "shifting_hotspot"
FAULT_SCENARIOS = ("lease_expiry", "split_brain")

# the coordination observables (stripped for the parity arm)
COORD_ROW_KEYS = ("routed", "direct", "redirected", "mis_served",
                  "stale_switches", "coordination")


def scenario_config(quick: bool):
    from repro_torch.cluster import ScenarioConfig

    if quick:
        return ScenarioConfig(n_epochs=12, epoch_ops=512, n_records=2048,
                              value_dim=4, seed=7)
    return ScenarioConfig(n_epochs=20, epoch_ops=1024, n_records=4096,
                          value_dim=4, seed=7)


def cluster_config(quick: bool, coord):
    from repro_torch.cluster import ClusterConfig

    return ClusterConfig(num_nodes=8, num_ranges=32 if quick else 64,
                         replication=2, r_max=4, n_clients=32,
                         report_every=2, imbalance_threshold=1.1,
                         max_moves_per_round=8, coordination=coord)


def _scen_kw(name: str) -> dict:
    if name == SWEEP_SCENARIO:
        return dict(theta=1.2, shift_every=2)
    if name == "lease_expiry":
        return dict(theta=1.2, shift_every=2, expire_epoch=3)
    if name == "split_brain":
        return dict(theta=1.2, shift_every=2, split_epoch=3, heal_epoch=8,
                    switch=1)
    raise ValueError(name)


def _drive(name: str, quick: bool, coord, device, policy_name="full_adaptive"):
    from repro_torch.cluster import EpochDriver, make_policy, make_scenario

    scen = make_scenario(name, scenario_config(quick), **_scen_kw(name))
    drv = EpochDriver(scen, make_policy(policy_name),
                      cluster_config(quick, coord), device=device)
    t0 = time.perf_counter()
    epochs = drv.run()
    return drv, epochs, time.perf_counter() - t0


def _row(drv, epochs, wall, **extra) -> dict:
    from repro_torch.cluster import summarize

    row = summarize(epochs)
    row["wall_s"] = round(wall, 3)
    row["traces"] = 1 + drv.growth_events
    row["conservation_ok"] = all(
        r.routed == r.direct + r.redirected for r in epochs)
    row["batch_routed_ok"] = all(
        r.routed == drv.scenario.cfg.epoch_ops for r in epochs)
    row["redirect_share"] = (row["total_redirected"] / row["total_routed"]
                             if row["total_routed"] > 0 else 0.0)
    if drv.coord_mgr is not None:
        row.update({f"mgr_{k}": v for k, v in drv.coord_mgr.summary().items()})
    row.update(extra)
    return row


def run_sweep(quick: bool, *, verbose: bool = True, device=None) -> list[dict]:
    from repro_torch.coordination_tier import CoordConfig

    rows = []
    for lag in SWEEP_LAGS:
        coord = CoordConfig(n_switches=4, lag_per_hop=lag, quorum=True)
        drv, epochs, wall = _drive(SWEEP_SCENARIO, quick, coord, device)
        row = _row(drv, epochs, wall, bench="coord_sweep", lag=lag,
                   quorum=True)
        rows.append(row)
        if verbose:
            print(f"[coord-sweep] {SWEEP_SCENARIO:17s} lag {lag} "
                  f"redirects {row['total_redirected']:5d} "
                  f"share {row['redirect_share']:.4f} "
                  f"mis {row['total_mis_served']:4d} "
                  f"stale_sw<= {row['max_stale_switches']} "
                  f"p999 {row['mean_p999']:7.1f} traces {row['traces']}")
    return rows


def run_parity(quick: bool, *, verbose: bool = True, device=None) -> list[dict]:
    """Tier-off against the zero-lag tier: the accounting-plane arm."""
    from repro_torch.coordination_tier import CoordConfig

    _, e_off, _ = _drive(SWEEP_SCENARIO, quick, None, device)
    drv_on, e_on, wall = _drive(
        SWEEP_SCENARIO, quick,
        CoordConfig(n_switches=4, lag_per_hop=0, quorum=True), device)

    def strip(r):
        d = dataclasses.asdict(r)
        d = {k: v for k, v in d.items() if k not in COORD_ROW_KEYS}
        d["events"] = [e for e in d["events"] if not e.startswith("coord_")]
        return d

    mismatch = sum(strip(a) != strip(b) for a, b in zip(e_off, e_on))
    row = _row(drv_on, e_on, wall, bench="coord_parity", lag=0, quorum=True,
               parity_epochs=len(e_on),
               parity_mismatches=mismatch + abs(len(e_off) - len(e_on)))
    if verbose:
        print(f"[coord-parity] zero-lag vs tier-off: {row['parity_epochs']} "
              f"epochs, {row['parity_mismatches']} mismatched "
              f"(redirects {row['total_redirected']}, traces {row['traces']})")
    return [row]


def run_faults(quick: bool, *, verbose: bool = True, device=None) -> list[dict]:
    from repro_torch.coordination_tier import CoordConfig

    rows = []
    for sname in FAULT_SCENARIOS:
        for arm, quorum in (("quorum", True), ("baseline", False)):
            coord = CoordConfig(n_switches=4, lag_per_hop=1, quorum=quorum)
            drv, epochs, wall = _drive(sname, quick, coord, device)
            row = _row(drv, epochs, wall, bench="coord_fault", arm=arm, lag=1,
                       quorum=quorum)
            rows.append(row)
            if verbose:
                print(f"[coord-fault] {sname:13s} {arm:8s} "
                      f"mis {row['total_mis_served']:5d} "
                      f"redirects {row['total_redirected']:5d} "
                      f"failovers {row['mgr_failovers']} "
                      f"stalls {row['mgr_stall_pulls']} "
                      f"traces {row['traces']}")
    return rows


def check_coordination(rows: list[dict]) -> list[str]:
    """The coordination gates (see the module docstring)."""
    problems: list[str] = []

    for r in rows:
        tag = f"{r.get('bench')}/{r.get('scenario')}/{r.get('arm', r.get('lag'))}"
        if not r.get("conservation_ok", False):
            problems.append(f"{tag}: routed != direct + redirected on "
                            "some epoch (conservation broke)")
        if not r.get("batch_routed_ok", False):
            problems.append(f"{tag}: routed != epoch batch on some epoch")
        if r.get("traces") != 1:
            problems.append(f"{tag}: step built {r.get('traces')}x "
                            "(expected 1)")

    sweep = {r["lag"]: r for r in rows if r.get("bench") == "coord_sweep"}
    z = sweep.get(0)
    if z and (z["total_redirected"] != 0 or z["total_mis_served"] != 0):
        problems.append(
            f"coord_sweep: zero-lag tier redirected "
            f"{z['total_redirected']} / mis-served {z['total_mis_served']} "
            "(must both be 0)")
    if 1 in sweep and sweep[1]["total_redirected"] <= 0:
        problems.append("coord_sweep: lag 1 produced no redirects — the "
                        "staleness window never opened")
    lags = sorted(sweep)
    if len(lags) >= 2:
        lo, hi = sweep[lags[1]], sweep[lags[-1]]
        if hi["redirect_share"] < lo["redirect_share"]:
            problems.append(
                f"coord_sweep: redirect share shrank with lag "
                f"({lags[-1]}: {hi['redirect_share']:.4f} < "
                f"{lags[1]}: {lo['redirect_share']:.4f})")
    for r in sweep.values():
        if r["total_mis_served"] != 0:
            problems.append(
                f"coord_sweep: lag {r['lag']} mis-served "
                f"{r['total_mis_served']} under quorum reads (must be 0)")

    for r in rows:
        if r.get("bench") != "coord_parity":
            continue
        if r.get("parity_mismatches", 1) != 0:
            problems.append(
                f"coord_parity: {r['parity_mismatches']} epoch rows "
                "diverge between zero-lag tier and coordination=None")
        if r["total_redirected"] != 0:
            problems.append("coord_parity: zero-lag arm redirected "
                            f"{r['total_redirected']} queries")

    faults = {(r["scenario"], r["arm"]): r for r in rows
              if r.get("bench") == "coord_fault"}
    for sname in FAULT_SCENARIOS:
        q = faults.get((sname, "quorum"))
        b = faults.get((sname, "baseline"))
        if q is None or b is None:
            problems.append(f"coord_fault: missing an arm for {sname}")
            continue
        if q["total_mis_served"] != 0:
            problems.append(
                f"coord_fault: {sname}/quorum mis-served "
                f"{q['total_mis_served']} queries (must be 0)")
        if q["total_redirected"] <= 0:
            problems.append(
                f"coord_fault: {sname}/quorum never redirected — the "
                "fault opened no stale window")
        if b["total_mis_served"] <= 0:
            problems.append(
                f"coord_fault: {sname}/baseline never mis-served — the "
                "stressor is not stressing")
        if b["total_redirected"] != 0:
            problems.append(
                f"coord_fault: {sname}/baseline redirected "
                f"{b['total_redirected']} (the trusting arm must not)")
        if sname == "lease_expiry" and q["mgr_failovers"] < 1:
            problems.append("coord_fault: lease_expiry/quorum never "
                            "failed leadership over")
    return problems
