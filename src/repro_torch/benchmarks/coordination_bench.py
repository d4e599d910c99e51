"""Coordination-engine benchmark: the DES engine against the heapq oracle
(counterpart of ``benchmarks/coordination_bench.py``).

* single-scenario closed-loop and open-loop wall-clock at a given batch
  size (B 8,192 by default) for both engines,
* the fused paper sweep (every fig13a / fig13bc / tables12 scenario, 57
  (workload x mode) lanes, in **one** engine call) against the oracle run
  scenario by scenario,
* a 1,000,000-op closed-loop sweep across the three coordination modes
  (the engine only; the oracle would take minutes).

Routing and the hop plans run on ``device`` (None = the CUDA card); the
DES runs on the host.  Run through ``python -m repro_torch.benchmarks.run``.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch import core as C
from repro_torch import prng
from repro_torch.benchmarks.paper_tables import (
    N_CLIENTS,
    N_NODES,
    N_RANGES,
    REPLICATION,
    build_scenarios,
    fig13a_workloads,
    fig13bc_workloads,
    tables12_workloads,
)
from repro_torch.data.ycsb import WorkloadConfig, run_phase
from repro_torch.device import resolve_device


def _sweep_workloads(n_ops: int):
    """The full paper-suite workload list: the same grids the figures use."""
    return (fig13a_workloads(n_ops) + fig13bc_workloads(n_ops)
            + tables12_workloads(n_ops))


def _routed_mixed(n_ops: int, dev):
    """The 50/50 read/update stream routed on ``dev``: (queries, decision,
    arrivals)."""
    wcfg = WorkloadConfig(n_ops=n_ops, read_ratio=0.5, update_ratio=0.5)
    opcodes, keys, end_keys, values, arrivals = run_phase(wcfg)
    d = C.make_directory(N_RANGES, N_NODES, REPLICATION, device=dev)
    q = C.make_queries(keys, opcodes, values, end_keys, device=dev)
    dec, d = C.route(d, q)
    return q, dec, arrivals


def _mixed_plan(n_ops: int, mode: str = C.SERVER_DRIVEN, device=None):
    q, dec, arrivals = _routed_mixed(n_ops, resolve_device(device))
    plan = C.plan_hops(q, dec, mode, C.LatencyModel(),
                       rng=prng.PRNGKey(0), num_nodes=N_NODES)
    return plan, arrivals


def _wall(fn, *args, repeats: int = 3, **kw):
    best = float("inf")
    out = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        best = min(best, time.perf_counter() - t0)
    return best, out


def bench_engine(n_ops: int = 8192, *, include_reference: bool = True,
                 include_1m: bool = True, backend: str | None = None,
                 device=None):
    """Returns (rows, wall): CSV rows plus raw wall-clock seconds."""
    rows: list[tuple[str, float, str]] = []
    # resolve exactly as the simulate calls below will
    wall: dict = {"backend": C.des.resolve_backend(backend)}

    # --- single scenario, closed + open loop -------------------------------
    plan, arrivals = _mixed_plan(n_ops, device=device)

    t_vec, (lat_v, mk_v) = _wall(
        C.simulate_closed_loop, plan,
        n_clients=N_CLIENTS, num_nodes=N_NODES, backend=backend)
    wall[f"closed_B{n_ops}_vectorized_s"] = t_vec
    derived = f"makespan={float(mk_v):.0f}"
    if include_reference:
        t_ref, (lat_r, mk_r) = _wall(
            C.simulate_closed_loop_reference, plan,
            n_clients=N_CLIENTS, num_nodes=N_NODES, repeats=1)
        wall[f"closed_B{n_ops}_reference_s"] = t_ref
        exact = bool(np.array_equal(np.asarray(lat_v), np.asarray(lat_r)))
        derived += f";speedup_vs_reference={t_ref / t_vec:.1f}x;bitexact={exact}"
    rows.append((f"des/closed_loop/B{n_ops}", t_vec * 1e6 / n_ops, derived))

    t_vec_o, (lat_vo, mk_vo) = _wall(
        C.simulate, plan, arrivals, num_nodes=N_NODES, backend=backend)
    wall[f"open_B{n_ops}_vectorized_s"] = t_vec_o
    derived = f"makespan={float(mk_vo):.0f}"
    if include_reference:
        t_ref_o, (lat_ro, mk_ro) = _wall(
            C.simulate_reference, plan, arrivals, num_nodes=N_NODES, repeats=1)
        wall[f"open_B{n_ops}_reference_s"] = t_ref_o
        exact = bool(np.array_equal(np.asarray(lat_vo), np.asarray(lat_ro)))
        derived += f";speedup_vs_reference={t_ref_o / t_vec_o:.1f}x;bitexact={exact}"
    rows.append((f"des/open_loop/B{n_ops}", t_vec_o * 1e6 / n_ops, derived))

    # --- fused paper sweep (the hot path this engine exists for) -----------
    _, plans = build_scenarios(_sweep_workloads(n_ops), device=device)
    S = len(plans)
    stacked = C.stack_plans(plans)
    t_sweep, (lat_s, mk_s) = _wall(
        C.simulate_closed_loop, stacked,
        n_clients=N_CLIENTS, num_nodes=N_NODES, backend=backend)
    wall[f"sweep{S}_B{n_ops}_vectorized_s"] = t_sweep
    derived = f"scenarios={S};per_scenario_ms={t_sweep / S * 1e3:.2f}"
    if include_reference:
        t0 = time.perf_counter()
        for i, p in enumerate(plans):
            lat_r, mk_r = C.simulate_closed_loop_reference(
                p, n_clients=N_CLIENTS, num_nodes=N_NODES)
            assert np.asarray(mk_s)[i] == np.asarray(mk_r)
        t_refsweep = time.perf_counter() - t0
        wall[f"sweep{S}_B{n_ops}_reference_s"] = t_refsweep
        derived += f";speedup_vs_reference={t_refsweep / t_sweep:.1f}x"
    rows.append((f"des/fused_sweep/S{S}/B{n_ops}", t_sweep * 1e6 / (S * n_ops),
                 derived))

    # --- 1M-op closed-loop sweep across all three modes ---------------------
    if include_1m:
        n_big = 1_000_000
        q, dec, _ = _routed_mixed(n_big, resolve_device(device))
        big = C.stack_plans([
            C.plan_hops(q, dec, m, C.LatencyModel(), rng=prng.PRNGKey(0),
                        num_nodes=N_NODES)
            for m in C.MODES
        ])
        t0 = time.perf_counter()
        lat_b, mk_b = C.simulate_closed_loop(
            big, n_clients=N_CLIENTS, num_nodes=N_NODES, backend=backend)
        t_big = time.perf_counter() - t0
        wall["sweep3_B1000000_vectorized_s"] = t_big
        rows.append((
            "des/fused_sweep/S3/B1000000", t_big * 1e6 / (3 * n_big),
            f"wall_s={t_big:.2f};makespans=" + ",".join(
                f"{float(x):.0f}" for x in np.asarray(mk_b)),
        ))
    return rows, wall
