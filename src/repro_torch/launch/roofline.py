"""Roofline analysis over the dry-run's records (counterpart of
``repro.launch.roofline``, with the H100's constants of
``telemetry.profiler`` and ``launch.mesh``: NVIDIA H100 80GB HBM3 at its
700 W power limit).

Per (arch x shape x mesh) cell, three per-step time bounds per device:

  compute    = counted FLOPs per device / dense bf16 peak
  memory     = compulsory bytes per device / HBM bandwidth
  collective = each axis group's wire bytes / its link's bandwidth
               (NVLink inside a node, InfiniBand across)

plus MODEL_FLOPS (the textbook 6*N*D / 2*N*D useful work, N the active
parameters) and the usefulness ratio MODEL_FLOPS / counted FLOPs, which
exposes remat recompute and dispatch / padding work.  The headline score

  fraction = ideal_compute_time / max(compute, memory, collective)

with ideal_compute_time = MODEL_FLOPS / (cards * peak): the share of the
binding bound spent on useful model math.  A card cell also has the
measured fraction, ideal_compute_time over its CUDA-event step time.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline [--results dryrun_results.json]
      [--tag baseline] [--format md|csv]
"""

from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config
from repro_torch.launch.input_specs import parse_shape
from repro_torch.launch.mesh import MeshLayout
from repro_torch.launch.op_stats import collective_seconds
from repro_torch.telemetry.profiler import HBM_BYTES_PER_S, PEAK_BF16_FLOPS
from repro_torch.training import tree as T


def param_counts(arch: str) -> tuple[float, float]:
    """(total, active) parameter counts from the abstract param tree: a
    routed expert's weights count top_k / n_experts of their size as
    active."""
    from repro_torch.models.model import abstract_params

    cfg = get_config(arch)
    return tree_param_counts(cfg, abstract_params(cfg))


def tree_param_counts(cfg, params: dict) -> tuple[float, float]:
    """:func:`param_counts` of a parameter tree of ``cfg``."""
    total = routed = 0
    for path, leaf in T.items(params):
        n = leaf.numel()
        total += n
        if "moe" in path and "shared" not in path and any(
                nm in ("wg", "wu", "wo") for nm in path):
            routed += n
    if cfg.n_experts and routed:
        active = total - routed + routed * cfg.top_k / cfg.n_experts
    else:
        active = total
    return float(total), float(active)


def model_flops(arch: str, shape_name: str) -> float:
    """Textbook useful FLOPs per step (whole job, all cards)."""
    shape = parse_shape(shape_name)
    _, n_active = param_counts(arch)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    # decode: one token a sequence (the cache reads are the memory term's)
    return 2.0 * n_active * shape.global_batch


def analyze_cell(key: str, cell: dict) -> dict | None:
    if cell.get("status") != "ok":
        return None
    tag, arch, shape_name, mesh_name = key.split("/")
    n_dev = cell["n_devices"]
    src = cell["analytic"]
    mesh = MeshLayout(tuple(cell["axis_names"]), tuple(cell["mesh"]))

    t_compute = src["flops_per_device"] / PEAK_BF16_FLOPS
    t_memory = src["bytes_per_device"] / HBM_BYTES_PER_S
    t_coll = collective_seconds(mesh, src["wire_bytes_by_axes"])
    bound = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]

    mf = model_flops(arch, shape_name)
    counted_total = src["flops_per_device"] * n_dev
    ideal = mf / (n_dev * PEAK_BF16_FLOPS)
    temp = cell["memory"]["temp_bytes"]
    row = {
        "key": key, "tag": tag, "arch": arch, "shape": shape_name,
        "mesh": mesh_name, "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "bound": bound, "model_flops": mf,
        "counted_flops_total": counted_total,
        "useful_ratio": mf / max(counted_total, 1.0),
        "ideal_s": ideal,
        "roofline_fraction": ideal / max(t_compute, t_memory, t_coll, 1e-30),
        "temp_gib": None if temp is None else temp / 2**30,
        "arg_gib": cell["memory"]["argument_bytes"] / 2**30,
        "count_s": cell.get("count_s"),
    }
    if "measured" in cell:
        step_s = cell["measured"]["step_ms"] / 1e3
        row["step_s"] = step_s
        row["measured_fraction"] = ideal / step_s
    return row


def load(results_path: str, tag: str = "baseline"):
    with open(results_path) as f:
        results = json.load(f)
    rows, skips = [], []
    for key, cell in sorted(results.items()):
        if not key.startswith(tag + "/"):
            continue
        if cell.get("status") == "skipped":
            skips.append((key, cell["reason"]))
            continue
        r = analyze_cell(key, cell)
        if r:
            rows.append(r)
    return rows, skips


def _opt(x, fmt: str) -> str:
    return "n/a" if x is None else format(x, fmt)


def fmt_md(rows, skips) -> str:
    out = [
        "| arch | shape | mesh | compute s | memory s | collective s | bound "
        "| useful (6ND/counted) | roofline frac | measured frac "
        "| temp GiB/dev |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
            f"| {r['t_collective_s']:.3e} | **{r['bound']}** "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.3f} "
            f"| {_opt(r.get('measured_fraction'), '.3f')} "
            f"| {_opt(r['temp_gib'], '.2f')} |"
        )
    if skips:
        out.append("")
        out.append("Skipped cells:")
        for key, why in skips:
            out.append(f"- `{key}`: {why}")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="dryrun_results.json")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--format", choices=["md", "csv"], default="md")
    args = ap.parse_args(argv)
    rows, skips = load(args.results, args.tag)
    if args.format == "md":
        print(fmt_md(rows, skips))
    else:
        cols = ["arch", "shape", "mesh", "t_compute_s", "t_memory_s",
                "t_collective_s", "bound", "useful_ratio", "roofline_fraction"]
        print(",".join(cols))
        for r in rows:
            print(",".join(str(r[c]) for c in cols))


if __name__ == "__main__":
    main()
