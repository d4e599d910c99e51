"""Pipeline profiler: stage timers and per-kernel roofline rows
(counterpart of ``repro.telemetry.profiler``).

* :class:`StageTimers`: the epoch driver's wall-clock accumulators around
  its pipeline stages (inject / route_apply / des / control /
  coord_control, and telemetry / metrics with those planes on).  With
  ``sync`` the driver also blocks on the device step, so the timer
  measures execution rather than enqueue (an explicit observer effect on
  wall time only; the trace plane's ``profile_stages`` turns it on).
* :func:`kernel_roofline_rows`: times the port's five route kernels (K1
  ``range_match``, K2 ``range_match_spread``, K3
  ``range_match_spread_dirty``, K4b ``range_match_apply``, K5
  ``range_match_stale``) and places each against the H100's peaks.  On
  the card each call is timed with CUDA events after an L2 flush; on the
  CPU the rows time the plain versions, and each row names its device.
  Bytes come from the shapes (:func:`route_bytes`: each input read once,
  each output written once); the kernels do no floating-point work.

This module owns the peaks and the byte counts: ``chip_smoke.py``'s
kernel bounds read them from here.

CLI: ``PYTHONPATH=src python -m repro_torch.telemetry.profiler --json
rows.json`` (``--device cpu`` for the plain versions).
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12          # HBM3
PEAK_F32_FLOPS = 67e12             # float32 on the CUDA cores
PEAK_BF16_FLOPS = 989e12           # dense bfloat16 on the tensor cores


class StageTimers:
    """Named wall-clock accumulators for the epoch pipeline stages."""

    def __init__(self, enabled: bool = True, *, sync: bool = False):
        self.enabled = enabled
        self.sync = sync and enabled
        self.totals: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    def lap(self, name: str, t0: float) -> float:
        """Charge the time since ``t0`` to ``name``; returns now."""
        t1 = time.perf_counter()
        if self.enabled:
            self.totals[name] = self.totals.get(name, 0.0) + t1 - t0
            self.calls[name] = self.calls.get(name, 0) + 1
        return t1

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.lap(name, t0)

    def block(self, device: torch.device) -> None:
        """With ``sync``, wait for the device's queued work (a no-op on
        the CPU, where the work has already run)."""
        if self.sync and device.type == "cuda":
            torch.cuda.synchronize(device)

    def summary(self) -> dict:
        total = sum(self.totals.values())
        return {
            "stage_s": {k: round(v, 6) for k, v in self.totals.items()},
            "stage_calls": dict(self.calls),
            "stage_share": {
                k: round(v / total, 4) if total > 0 else 0.0
                for k, v in self.totals.items()
            },
            "total_s": round(total, 6),
        }


# ---------------------------------------------------------------------------
# byte counts and the kernel roofline
# ---------------------------------------------------------------------------

KERNELS = ("range_match", "range_match_spread", "range_match_spread_dirty",
           "range_match_apply", "range_match_stale")


def slab_probes(C: int) -> int:
    """Slab words a left bisect over ``C`` entries reads: ceil(log2(C + 1))
    steps plus the final probe."""
    return math.ceil(math.log2(C + 1)) + 1


def route_bytes(kernel: str, *, B: int, S: int, N: int, r_max: int,
                C: int | None = None, W: int | None = None,
                filter_bits: int = 0) -> int:
    """The bytes one call of a route kernel must move at these shapes.

    Every key, matching value, target, slab word and output id counts at
    its 32-bit width (the kernels read the port's int64 carriers of the
    first four), flags at 1 B, each input read once and each output
    written once.  ``B`` packets, ``S`` slots, ``N`` nodes, ``r_max``
    chain positions; ``C`` slab entries a node (K4a, K4b), ``W`` switch
    copies (K5), ``filter_bits`` K3's key-filter width.  K4a and K4b read
    the slab words their bisect probes (:func:`slab_probes`).
    """
    table = S * (4 + 4 + 4 + 4 * r_max)            # lo, hi, clen, chains
    route_out = 4 + 4 + 4 * r_max                  # ridx, target, chain
    spread_in = 4 + 4 + 4 + 4                      # mval, opcode, u1, u2
    # K3: the (r_max, S) dirty bytes in, (picked, bounced) out; the filter
    # adds the raw keys and the (S, F) filter bytes
    dirty = (B * (spread_in + route_out + 4 + 1) + table + 4 * N
             + r_max * S)
    if filter_bits:
        dirty += B * 4 + S * filter_bits
    if kernel == "range_match":
        return B * (4 + 4 + route_out) + table
    if kernel == "range_match_spread":
        return B * (spread_in + route_out) + table + 4 * N
    if kernel == "range_match_spread_dirty":
        return dirty
    if kernel == "slab_lookup":                    # key, target, slot, found
        return B * (4 + 4 + 4 + 1) + B * slab_probes(C) * 4
    if kernel == "range_match_apply":
        # K3's traffic plus the probe's (slot, found out; the key is the
        # matching value already counted)
        return dirty + B * (4 + 1) + B * slab_probes(C) * 4
    if kernel == "range_match_stale":
        # key and opcode in; sridx, server and divergent out; the W copies
        # of lo, hi, clen, version and chains, and committed, once each
        return (B * (4 + 4 + 4 + 4 + 1) + W * S * (4 * 4 + 4 * r_max)
                + 4 * S)
    raise ValueError(f"unknown route kernel {kernel!r}")


_FLUSH: dict[int, torch.Tensor] = {}   # one read buffer a card


def l2_flush(device: torch.device) -> None:
    """Read a buffer of twice the card's L2, so the next kernel meets its
    inputs in device memory.  A read, not a write, leaves the L2 clean,
    so the kernel that follows pays no write-backs of the flush's lines.
    The buffer is made at the first call (before any CUDA-graph capture
    that replays the flush)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    buf = _FLUSH.get(idx)
    if buf is None:
        props = torch.cuda.get_device_properties(idx)
        l2 = getattr(props, "L2_cache_size", 50 * 2**20)
        buf = _FLUSH[idx] = torch.ones(2 * l2 // 4,
                                       device=torch.device("cuda", idx))
    buf.sum()


def _time_us(fn, device: torch.device, iters: int) -> float:
    """Median microseconds of ``fn()``: CUDA events after an L2 flush on
    the card, the host clock on the CPU (after one warm-up call)."""
    fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            l2_flush(device)
            torch.cuda.synchronize(device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) * 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(times))


def _kernel_thunks(*, batch, num_ranges, num_nodes, replication, r_max,
                   n_slots, seed, capacity, n_switches, device):
    from repro_torch import coordination_tier as CT
    from repro_torch import prng
    from repro_torch.core import directory as D
    from repro_torch.kernels.range_match import ops as OPS

    directory = D.make_directory(num_ranges, num_nodes, replication,
                                 r_max=r_max, n_slots=n_slots, device=device)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=device)
    keys = t(rng.integers(0, np.iinfo(np.int32).max, batch, dtype=np.int64))
    opcodes = torch.zeros(batch, dtype=torch.int32, device=device)  # GETs
    load_reg = torch.zeros(num_nodes, dtype=torch.int64, device=device)
    dirty = torch.zeros((directory.num_slots, r_max), dtype=torch.bool,
                        device=device)
    r2 = prng.fold_in(prng.PRNGKey(seed), 1)
    # K4b also bisects each serving node's sorted slab: a populated table
    store_keys = t(np.sort(rng.integers(0, np.iinfo(np.int32).max,
                                        (num_nodes, capacity),
                                        dtype=np.int64), axis=1))
    # K5 routes against per-switch copies at the controller's snapshot
    tables = {k: getattr(directory, k).cpu().numpy() for k in
              ("slot_lo", "slot_hi", "live", "chains", "chain_len")}
    coord = CT.make_state(tables, n_switches, device=device)
    return {
        "range_match": lambda: OPS.range_match(directory, keys, opcodes),
        "range_match_spread": lambda: OPS.range_match_spread(
            directory, keys, opcodes, load_reg, r2),
        "range_match_spread_dirty": lambda: OPS.range_match_spread_dirty(
            directory, keys, opcodes, load_reg, dirty, r2),
        "range_match_apply": lambda: OPS.range_match_apply(
            directory, keys, opcodes, load_reg, dirty, store_keys, r2),
        "range_match_stale": lambda: OPS.range_match_stale(
            coord, keys, opcodes),
    }


def kernel_roofline_rows(*, batch: int = 4096, num_ranges: int = 64,
                         num_nodes: int = 8, replication: int = 2,
                         r_max: int = 4, n_slots: int | None = None,
                         seed: int = 0, measure_iters: int = 5,
                         capacity: int = 1024, n_switches: int = 4,
                         device=None) -> list[dict]:
    """Time each route kernel on ``device`` (``None`` = the card) and
    return its roofline row."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    S = 2 * num_ranges if n_slots is None else n_slots
    thunks = _kernel_thunks(
        batch=batch, num_ranges=num_ranges, num_nodes=num_nodes,
        replication=replication, r_max=r_max, n_slots=S, seed=seed,
        capacity=capacity, n_switches=n_switches, device=dev,
    )
    on_card = dev.type == "cuda"
    dev_name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    rows = []
    for name in KERNELS:
        flops = 0.0        # integer compares and selects only
        bytes_ = float(route_bytes(name, B=batch, S=S, N=num_nodes,
                                   r_max=r_max, C=capacity, W=n_switches))
        t_compute_us = flops / PEAK_F32_FLOPS * 1e6
        t_memory_us = bytes_ / HBM_BYTES_PER_S * 1e6
        roof = max(t_compute_us, t_memory_us)
        rows.append({
            "kernel": name,
            "impl": "cuda" if on_card else "plain",
            "device": dev_name,
            "batch": batch,
            "n_slots": S,
            "flops": flops,
            "bytes": bytes_,
            "intensity_flop_per_byte": flops / bytes_ if bytes_ else 0.0,
            "t_compute_us": t_compute_us,
            "t_memory_us": t_memory_us,
            "bound": "memory" if t_memory_us >= t_compute_us else "compute",
            "roofline_us": roof,
            "measured_us": _time_us(thunks[name], dev, measure_iters),
            "queries_per_s_roofline": batch / (roof * 1e-6),
        })
    return rows


def fmt_roofline_md(rows: list[dict]) -> str:
    hdr = ("| kernel | impl | device | B | bytes | roofline µs | bound "
           "| measured µs |\n|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in rows:
        lines.append(
            f"| {r['kernel']} | {r['impl']} | {r['device']} | {r['batch']} "
            f"| {r['bytes']:.3g} | {r['roofline_us']:.3f} | {r['bound']} "
            f"| {r['measured_us']:.1f} |"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain versions")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    rows = kernel_roofline_rows(batch=args.batch, device=args.device)
    print(fmt_roofline_md(rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"rows": rows, "peak_f32_flops": PEAK_F32_FLOPS,
                       "hbm_bytes_per_s": HBM_BYTES_PER_S}, f, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
