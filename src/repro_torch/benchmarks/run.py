"""The paper-table suite's CLI (counterpart of ``benchmarks/run.py``).

Prints ``name,us_per_call,derived`` CSV rows in the reference's order.
For the coordination-model rows us_per_call is the simulated mean
latency per op (abstract ticks, see :mod:`.paper_tables`) and ``derived``
carries the reproduced quantity (throughput / latency ratios against
server-driven coordination).  Run:

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--quick]
      [--engine {reference,vectorized}] [--n-ops N] [--device cpu]
      [--json BENCH_torch_coordination.json]

``--device`` defaults to the CUDA card (routing and hop plans run there,
the DES on the host).  ``--json`` also writes every row plus the engine's
wall-clock seconds, in the reference's layout; ``meta`` adds the device
and, on the card, its name and power limit as ``nvidia-smi`` reports
them.  The reference's kernel rows (its ``table_kernels``) have no
counterpart here: the port's kernels are timed against their plain
versions by ``chip_smoke.py`` phase 2, and the CLI says so where those
rows were.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from repro_torch import core as C
from repro_torch.benchmarks import paper_tables as PT
from repro_torch.device import resolve_device

KERNEL_ROWS_NOTE = ("# kernel rows: not ported; the port's kernels are "
                    "timed against their plain versions by chip_smoke.py "
                    "phase 2 (kernels)")

_ROWS: list[tuple[str, float, str]] = []


def _emit(name: str, us: float, derived: str):
    _ROWS.append((name, us, derived))
    print(f"{name},{us:.2f},{derived}", flush=True)


def table_fig13a(n_ops: int, engine: str, device=None):
    rows = PT.fig13a_throughput_vs_skew(n_ops, engine=engine, device=device)
    base = {}
    for label, mode, thr in rows:
        base.setdefault(label, {})[mode] = thr
    for label, mode, thr in rows:
        rel = thr / base[label][C.SERVER_DRIVEN]
        _emit(f"fig13a/{label}/{mode}", 1e3 / max(thr, 1e-9),
              f"throughput={thr:.3f}ops_tick;vs_server={rel:.3f}x")


def table_fig13bc(n_ops: int, engine: str, device=None):
    rows = PT.fig13bc_throughput_vs_write_ratio(n_ops, engine=engine,
                                                device=device)
    base = {}
    for label, wr, mode, thr in rows:
        base.setdefault((label, wr), {})[mode] = thr
    for label, wr, mode, thr in rows:
        rel = thr / base[(label, wr)][C.SERVER_DRIVEN]
        _emit(f"fig13bc/{label}/wr{wr}/{mode}", 1e3 / max(thr, 1e-9),
              f"throughput={thr:.3f};vs_server={rel:.3f}x")


def tables_1_2(n_ops: int, engine: str, device=None):
    out = PT.tables12_latency(n_ops, engine=engine, device=device)
    for dist, modes in out.items():
        sv = modes[C.SERVER_DRIVEN]
        for mode, r in modes.items():
            _emit(
                f"table12/{dist}/{mode}/read", r.read_mean,
                f"p50={r.read_p50:.1f};p99={r.read_p99:.1f};vs_server_mean={r.read_mean / sv.read_mean:.3f}",
            )
            _emit(
                f"table12/{dist}/{mode}/write", r.write_mean,
                f"p50={r.write_p50:.1f};p99={r.write_p99:.1f};vs_server_mean={r.write_mean / sv.write_mean:.3f}",
            )
            _emit(
                f"table12/{dist}/{mode}/scan", r.scan_mean,
                f"p50={r.scan_p50:.1f};p99={r.scan_p99:.1f};vs_server_mean={r.scan_mean / sv.scan_mean:.3f}",
            )


def table_load_balance(n_ops: int, device=None):
    r = PT.load_balance_effect(n_ops, device=device)
    _emit("load_balance/zipf1.2", r["max_load_before"],
          f"imb_before={r['imbalance_before']:.2f};imb_after={r['imbalance_after']:.2f};"
          f"migrations={r['migrations']}")


def table_hierarchy(n_ops: int, device=None):
    r = PT.hierarchy_stats(n_ops, device=device)
    _emit("hierarchy/2pods", 0.0,
          f"pod_crossing={r['pod_crossing_fraction']:.3f};"
          f"agreement={r['pod_table_agreement']:.3f}")


def table_engine(n_ops: int, quick: bool, device=None):
    from repro_torch.benchmarks.coordination_bench import bench_engine

    rows, wall = bench_engine(n_ops, include_reference=not quick,
                              include_1m=not quick, device=device)
    for name, us, derived in rows:
        _emit(name, us, derived)
    return wall


def simulated_rows(n_ops: int, engine: str = "vectorized", device=None
                   ) -> list[tuple[str, float, str]]:
    """The suite's simulated rows (all but the engine's ``des/*``), in the
    CLI's order."""
    start = len(_ROWS)
    table_fig13a(n_ops, engine, device)
    table_fig13bc(n_ops, engine, device)
    tables_1_2(n_ops, engine, device)
    table_load_balance(n_ops, device)
    table_hierarchy(n_ops, device)
    return _ROWS[start:]


def card_meta(dev) -> dict:
    """The device's entry of ``meta``: its type, and on the card its name
    and power limit (``nvidia-smi``)."""
    meta = {"device": dev.type}
    if dev.type == "cuda":
        import torch

        meta["device_name"] = torch.cuda.get_device_name(dev)
        meta["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="smaller op counts")
    ap.add_argument("--engine", choices=("reference", "vectorized"),
                    default="vectorized",
                    help="DES implementation for the coordination benchmarks")
    ap.add_argument("--n-ops", type=int, default=None,
                    help="ops per workload (default: 2048 quick, 8192 full)")
    ap.add_argument("--device", default=None,
                    help="device of routing and hop plans (default: the "
                    "CUDA card)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write rows + engine wall-clock to PATH")
    args = ap.parse_args(argv)
    if args.n_ops is not None and args.n_ops < 1:
        ap.error("--n-ops must be >= 1")
    n = args.n_ops if args.n_ops is not None else (2048 if args.quick else 8192)
    dev = resolve_device(args.device)

    _ROWS.clear()
    t0 = time.perf_counter()
    print("name,us_per_call,derived")
    simulated_rows(n, args.engine, dev)
    print(KERNEL_ROWS_NOTE, flush=True)
    wall = table_engine(n, args.quick, dev)
    total = time.perf_counter() - t0

    if args.json:
        payload = {
            "meta": {
                "n_ops": n,
                "engine": args.engine,
                "quick": args.quick,
                "backends": list(C.des.available_backends()),
                "suite_wall_clock_s": total,
                **card_meta(dev),
            },
            "engine_wall_clock": wall,
            "rows": [
                {"name": name, "us_per_call": us, "derived": derived}
                for name, us, derived in _ROWS
            ],
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"# wrote {len(_ROWS)} rows -> {args.json}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
