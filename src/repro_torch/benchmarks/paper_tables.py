"""Reproductions of the paper's tables and figures (counterpart of
``benchmarks/paper_tables.py``).

Setup mirrors the paper's §8: 16 storage nodes, a 128-record index
table, chain length 3, range partitioning, YCSB workloads (16-byte keys
as uint32 matching values, 128-byte values as 32 float32 words).  Times
are abstract DES ticks; the reproduced quantities are the ratios between
the coordination models.

Every figure builds its whole (workload x coordination mode) scenario
set, routes each workload on ``device`` (K1 on the card), draws the hop
plans there with the port's threefry (``prng.PRNGKey(seed)``), stacks
them on the host and simulates the sweep in one DES call.
``engine="reference"`` replays the scenarios one by one through the heapq
oracle: the same bits, only slower.  Every entry takes ``device`` (None =
the CUDA card, raising without one); the percentiles are numpy's, as in
the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import core as C
from repro_torch import prng
from repro_torch.data.ycsb import WorkloadConfig, load_phase, run_phase
from repro_torch.device import resolve_device

N_NODES = 16
N_RANGES = 128
REPLICATION = 3
N_CLIENTS = 4  # the paper's testbed: 4 client hosts replaying YCSB streams


@dataclasses.dataclass
class BenchResult:
    mode: str
    throughput: float          # ops / tick
    read_mean: float
    read_p50: float
    read_p99: float
    write_mean: float
    write_p50: float
    write_p99: float
    scan_mean: float
    scan_p50: float
    scan_p99: float


def _percentiles(lat, mask):
    lat = np.asarray(lat)[np.asarray(mask)]
    if lat.size == 0:
        return (float("nan"),) * 3
    return float(lat.mean()), float(np.percentile(lat, 50)), float(np.percentile(lat, 99))


# ---------------------------------------------------------------------------
# scenario construction + fused simulation
# ---------------------------------------------------------------------------


def build_scenarios(workloads, *, seed: int = 0, run_store_ops: bool = False,
                    modes=C.MODES, device=None):
    """Route every workload on ``device`` and expand it into one scenario
    per mode.

    Returns (scenarios, plans): ``scenarios[i] = (label, mode, opcodes,
    wcfg)`` describes ``plans[i]`` (a (B, H) HopPlan on ``device``).  All
    workloads must share ``n_ops`` so the plans can be stacked and fused.
    """
    dev = resolve_device(device)
    scenarios, plans = [], []
    for label, wcfg in workloads:
        d = C.make_directory(N_RANGES, N_NODES, REPLICATION, device=dev)
        opcodes, keys, end_keys, values, arrivals = run_phase(wcfg)
        q = C.make_queries(keys, opcodes, values, end_keys, device=dev)
        dec, d = C.route(d, q)
        if run_store_ops:  # functional execution (correctness-coupled timing)
            store = C.make_store(N_NODES, capacity=wcfg.n_records,
                                 value_dim=wcfg.value_dim, device=dev)
            lk, lv = load_phase(wcfg)
            ql = C.make_queries(lk, np.full((len(lk),), C.OP_PUT), lv,
                                device=dev)
            dl, d = C.route(d, ql)
            store, _ = C.apply_routed(store, ql, dl)
            store, _ = C.apply_routed(store, q, dec)
        for mode in modes:
            plans.append(C.plan_hops(q, dec, mode, C.LatencyModel(),
                                     rng=prng.PRNGKey(seed),
                                     num_nodes=N_NODES))
            scenarios.append((label, mode, opcodes, wcfg))
    return scenarios, plans


def simulate_scenarios(plans, *, engine: str = "vectorized",
                       n_clients: int = N_CLIENTS):
    """Closed-loop simulate a scenario list -> (latencies, makespans).

    ``vectorized``: one fused engine call over the stacked plans.
    ``reference``: the heapq oracle, one scenario at a time (bit-identical).
    """
    if engine == "reference":
        lats, mks = [], []
        for p in plans:
            lat, mk = C.simulate_closed_loop_reference(
                p, n_clients=n_clients, num_nodes=N_NODES)
            lats.append(np.asarray(lat))
            mks.append(float(mk))
        return lats, mks
    if engine != "vectorized":
        raise ValueError(f"engine must be 'reference' or 'vectorized', got {engine!r}")
    lat, mk = C.simulate_closed_loop(C.stack_plans(plans),
                                     n_clients=n_clients, num_nodes=N_NODES)
    return list(lat.numpy()), [float(x) for x in mk.numpy()]


def _to_result(mode, wcfg, opcodes, lat, makespan) -> BenchResult:
    is_read = opcodes == C.OP_GET
    is_write = opcodes == C.OP_PUT
    is_scan = opcodes == C.OP_SCAN
    rm, r50, r99 = _percentiles(lat, is_read)
    wm, w50, w99 = _percentiles(lat, is_write)
    sm, s50, s99 = _percentiles(lat, is_scan)
    return BenchResult(mode, wcfg.n_ops / max(makespan, 1e-9),
                       rm, r50, r99, wm, w50, w99, sm, s50, s99)


def run_workload(wcfg: WorkloadConfig, mode: str, *, seed: int = 0,
                 run_store_ops: bool = False,
                 engine: str = "vectorized", device=None) -> BenchResult:
    """Route + (optionally) execute a YCSB stream, then simulate one mode."""
    if mode not in C.MODES:
        raise ValueError(f"mode must be one of {C.MODES}")
    scenarios, plans = build_scenarios([("", wcfg)], seed=seed,
                                       run_store_ops=run_store_ops,
                                       modes=(mode,), device=device)
    lats, mks = simulate_scenarios(plans, engine=engine)
    return _to_result(mode, wcfg, scenarios[0][2], lats[0], mks[0])


# ---------------------------------------------------------------------------
# workload grids, shared with coordination_bench so the engine bench
# measures exactly the scenario set the figures use
# ---------------------------------------------------------------------------


def fig13a_workloads(n_ops: int):
    workloads = []
    for dist, theta in [("uniform", 0.0), ("zipf", 0.9), ("zipf", 0.95),
                        ("zipf", 0.99), ("zipf", 1.2)]:
        label = "uniform" if dist == "uniform" else f"zipf-{theta}"
        workloads.append((label, WorkloadConfig(
            distribution=dist, zipf_theta=theta, n_ops=n_ops,
            read_ratio=1.0, update_ratio=0.0)))
    return workloads


def fig13bc_workloads(n_ops: int):
    workloads = []
    for dist, theta in [("uniform", 0.0), ("zipf", 0.95)]:
        for wr in (0.0, 0.1, 0.3, 0.5, 0.7, 0.9):
            label = "uniform" if dist == "uniform" else f"zipf-{theta}"
            workloads.append(((label, wr), WorkloadConfig(
                distribution=dist, zipf_theta=theta, n_ops=n_ops,
                read_ratio=1 - wr, update_ratio=wr)))
    return workloads


def tables12_workloads(n_ops: int):
    return [(name, WorkloadConfig(
        distribution=dist, zipf_theta=theta, n_ops=n_ops,
        read_ratio=0.45, update_ratio=0.45, scan_ratio=0.10))
        for dist, theta, name in [("uniform", 0.0, "uniform"),
                                  ("zipf", 1.2, "zipf-1.2")]]


# ---------------------------------------------------------------------------
# Figure 13(a): throughput vs skewness, read-only
# ---------------------------------------------------------------------------


def fig13a_throughput_vs_skew(n_ops: int = 8192, engine: str = "vectorized",
                              device=None):
    scenarios, plans = build_scenarios(fig13a_workloads(n_ops), device=device)
    _, mks = simulate_scenarios(plans, engine=engine)
    return [(label, mode, wcfg.n_ops / max(mk, 1e-9))
            for (label, mode, _, wcfg), mk in zip(scenarios, mks)]


# ---------------------------------------------------------------------------
# Figure 13(b,c): throughput vs write ratio (uniform / zipf-0.95)
# ---------------------------------------------------------------------------


def fig13bc_throughput_vs_write_ratio(n_ops: int = 8192,
                                      engine: str = "vectorized",
                                      device=None):
    scenarios, plans = build_scenarios(fig13bc_workloads(n_ops), device=device)
    _, mks = simulate_scenarios(plans, engine=engine)
    return [(label_wr[0], label_wr[1], mode, wcfg.n_ops / max(mk, 1e-9))
            for (label_wr, mode, _, wcfg), mk in zip(scenarios, mks)]


# ---------------------------------------------------------------------------
# Tables 1 & 2: latency analysis (uniform / zipf-1.2), mixed ops incl. scans
# ---------------------------------------------------------------------------


def tables12_latency(n_ops: int = 8192, engine: str = "vectorized",
                     device=None):
    scenarios, plans = build_scenarios(tables12_workloads(n_ops), device=device)
    lats, mks = simulate_scenarios(plans, engine=engine)
    out: dict[str, dict[str, BenchResult]] = {}
    for (name, mode, opcodes, wcfg), lat, mk in zip(scenarios, lats, mks):
        out.setdefault(name, {})[mode] = _to_result(mode, wcfg, opcodes, lat, mk)
    return out


# ---------------------------------------------------------------------------
# §5.1: load-balancing migration effect under skew
# ---------------------------------------------------------------------------


def load_balance_effect(n_ops: int = 8192, theta: float = 1.2, device=None):
    dev = resolve_device(device)
    d = C.make_directory(N_RANGES, N_NODES, REPLICATION, device=dev)
    wcfg = WorkloadConfig(distribution="zipf", zipf_theta=theta, n_ops=n_ops,
                          read_ratio=0.9, update_ratio=0.1)
    opcodes, keys, end_keys, values, arrivals = run_phase(wcfg)
    q = C.make_queries(keys, opcodes, values, end_keys, device=dev)

    # period 1: observe load
    dec, d = C.route(d, q)
    report, d = C.pull_report(d, 0)
    before = report.node_load
    imb_before = before.max() / max(before.mean(), 1e-9)

    # controller balances; same workload again (stationary popularity)
    ctl = C.Controller(d, C.ControllerConfig(imbalance_threshold=1.1,
                                             max_moves_per_round=16))
    ops = ctl.balance(report)
    d = ctl.directory()
    dec2, d = C.route(d, q)
    report2, d = C.pull_report(d, 1)
    after = report2.node_load
    imb_after = after.max() / max(after.mean(), 1e-9)
    return {
        "imbalance_before": float(imb_before),
        "imbalance_after": float(imb_after),
        "migrations": len(ops),
        "max_load_before": float(before.max()),
        "max_load_after": float(after.max()),
    }


# ---------------------------------------------------------------------------
# §6: hierarchical (multi-rack) routing: pod-crossing fraction
# ---------------------------------------------------------------------------


def hierarchy_stats(n_ops: int = 8192, n_pods: int = 2, device=None):
    dev = resolve_device(device)
    d = C.make_directory(N_RANGES, N_NODES, REPLICATION, num_pods=n_pods,
                         device=dev)
    table = C.derive_pod_table(d, n_pods)
    wcfg = WorkloadConfig(n_ops=n_ops, read_ratio=0.5, update_ratio=0.5)
    opcodes, keys, end_keys, values, arrivals = run_phase(wcfg)
    q = C.make_queries(keys, opcodes, values, device=dev)
    pods = C.route_pod(table, d, q).cpu().numpy()
    # clients uniformly spread over pods: crossing = target pod != client pod
    rng = np.random.default_rng(0)
    client_pod = rng.integers(0, n_pods, size=len(pods))
    crossing = float((pods != client_pod).mean())
    dec, d = C.route(d, q)
    # every routed target agrees with the pod-level direction (consistency)
    node_pods = d.node_addr[:, 0].cpu().numpy()
    agree = float((node_pods[dec.target.cpu().numpy()] == pods).mean())
    return {"pod_crossing_fraction": crossing, "pod_table_agreement": agree}
