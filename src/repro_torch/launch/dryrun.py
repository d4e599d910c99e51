"""Dry-run: place and count every (arch x shape x mesh) cell (counterpart
of ``repro.launch.dryrun``).

For each cell this builds the step the shape dictates (``train_step`` /
``prefill`` / ``decode_step``) on ``meta`` tensors, places its arguments
with ``distributed.sharding``, and records:

  * ``memory``: per-device argument bytes (``sharded_bytes_per_device``
    of state + batch, or of params + [batch | tokens + cache]) and output
    bytes; ``temp_bytes`` is null, since a ``meta`` step allocates nothing;
  * ``cost`` / ``analytic``: the counted FLOPs of the whole job
    (``launch.op_stats``: one layer of each kind times its count), the
    even split over the devices (where GSPMD replicates work, the
    reference's per-device figure is higher) and the compulsory bytes;
  * ``collectives``: the ring model's payloads and wire bytes by axis.

On the ``card`` mesh, the 1x1 layout on the visible H100, the step also
runs: CUDA-event ms (the median of 3 after one warm-up, which runs under
``FlopCounterMode``; a kernel launched through ctypes is not in that
count), the bytes the arguments occupy on the card, to hold against the
prediction, and ``temp_bytes``, ``max_memory_allocated`` less the
arguments.  Card cells' shapes are
written ``<kind>@B<batch>xT<seq>`` (``input_specs.parse_shape``).

Results are cached incrementally in a JSON file; reruns skip finished
cells.  Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --jobs 6
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --mesh card
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import statistics
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as SH
from repro_torch.launch import input_specs as ISPEC
from repro_torch.launch import op_stats as OS
from repro_torch.launch.mesh import MeshLayout, dp_axes, make_production_mesh
from repro_torch.models import model as MODEL
from repro_torch.training import tree as T
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.step import TrainConfig, init_train_state

DEFAULT_OUT = "dryrun_results.json"
FSDP_BYTES = 12 * 2**30       # per-device parameter bytes past which a
                              # second (DP) axis shards the weights
MESHES = {"single": make_production_mesh(multi_pod=False),
          "multi": make_production_mesh(multi_pod=True),
          "card": MeshLayout(("data", "model"), (1, 1))}
# the card cells: phase training's 8 x 2,048 tokens, a 2,048-token
# prompt, phase serving's 32 slots of an 8,192-position cache
CARD_SHAPES = ("train@B8xT2048", "prefill@B1xT2048", "decode@B32xT8192")
CARD_REPS = 3


def pick_microbatches(cfg, shape, n_dp: int) -> int:
    """Enough gradient accumulation that per-micro activations fit HBM.

    Remat keeps ~L x tokens x d_model x 2B of saved layer inputs per
    microbatch; target that at <= ~2 GiB/device.
    """
    local_b = max(1, shape.global_batch // n_dp)
    big = cfg.d_model >= 4096 or cfg.n_experts >= 64
    huge = cfg.d_model >= 6144 or (cfg.n_experts >= 64 and cfg.d_model >= 5120)
    target_tokens = 4096 if huge else (2 * 4096 if big else 16 * 1024)
    per_seq = shape.seq_len
    seqs = max(1, target_tokens // per_seq)
    m = max(1, local_b // seqs)
    while local_b % m:
        m -= 1
    return m


@dataclasses.dataclass
class Cell:
    """A step ready to count or run: ``fn(*args)``, each argument placed
    by the spec tree at the same index of ``specs``."""
    cfg: object
    shape: object
    mesh: object
    dp: tuple
    tcfg: TrainConfig
    fn: object
    args: tuple
    specs: tuple
    extra: dict


def _card_batch(cfg, shape, device, seed: int) -> dict:
    from repro_torch.data.pipeline import DataConfig, make_batch

    batch = make_batch(cfg, shape, seed, DataConfig("copy"))
    if shape.kind != "train":
        batch.pop("labels")
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def build_cell(arch: str | ArchConfig, shape_name: str, mesh, *,
               microbatches: int | None = None, zero: bool = True,
               remat: bool = True, cache_policy: str = "auto",
               device="meta", seed: int = 0) -> Cell:
    """The cell's step and its placed arguments: on ``meta`` (nothing
    allocated) or, on another device, made from ``seed`` (the port's
    seeded init, the copy task's batch; a decode cache of zeros whose
    every slot holds seq_len - 1 tokens, so the step reads all of it).
    ``arch`` names a config or is one (a reduced config, say)."""
    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    shape = ISPEC.parse_shape(shape_name)
    dp = dp_axes(mesh)
    n_dp = SH.mesh_size(mesh, dp)
    meta = torch.device(device).type == "meta"

    if shape.kind == "train":
        mb = microbatches if microbatches is not None else pick_microbatches(
            cfg, shape, n_dp)
        tcfg = TrainConfig(opt=OptConfig(), microbatches=mb, remat=remat)
        state, batch = OS.abstract_args(cfg, shape, tcfg)
        p_only = SH.param_specs(state["params"], mesh)
        fsdp = SH.sharded_bytes_per_device(state["params"], p_only,
                                           mesh) > FSDP_BYTES
        specs = (SH.state_specs(state, mesh, dp_axes=dp, zero=zero,
                                fsdp_params=fsdp),
                 SH.batch_specs(batch, dp))
        if not meta:
            state = init_train_state(cfg, tcfg, seed, device=device)
            batch = _card_batch(cfg, shape, device, seed)
        return Cell(cfg, shape, mesh, dp, tcfg, OS.step_fn(cfg, shape, tcfg),
                    (state, batch), specs,
                    {"microbatches": mb, "fsdp_params": fsdp})

    tcfg = TrainConfig(remat=remat)
    args = OS.abstract_args(cfg, shape, tcfg)
    # serving weights are resident in the compute dtype, not the float32
    # training master copies; weights past the budget under model-only
    # sharding get a second axis over DP
    p_specs = SH.param_specs(args[0], mesh)
    if SH.sharded_bytes_per_device(args[0], p_specs, mesh) > FSDP_BYTES:
        p_specs = SH.zero_extend(p_specs, args[0], mesh, dp)
    B = shape.global_batch
    if shape.kind == "prefill":
        specs = (p_specs, SH.batch_specs(args[1], dp))
        if not meta:
            args = (MODEL.init_params(cfg, seed, device=device),
                    _card_batch(cfg, shape, device, seed))
    else:
        tok_spec = SH.P(dp) if B % n_dp == 0 else SH.P()
        specs = (p_specs, tok_spec,
                 SH.cache_specs(args[2], mesh, dp_axes=dp,
                                seq_policy=cache_policy))
        if not meta:
            gen = torch.Generator(device=device).manual_seed(seed)
            args = (MODEL.init_params(cfg, seed, device=device),
                    torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                                  device=device, dtype=ISPEC.TOKEN_DTYPE),
                    MODEL.empty_cache(cfg, B, shape.seq_len,
                                      length=shape.seq_len - 1, device=device))
    return Cell(cfg, shape, mesh, dp, tcfg, OS.step_fn(cfg, shape, tcfg),
                args, specs, {})


def _tree(x) -> dict:
    return x if isinstance(x, dict) else {"x": x}


def argument_bytes(cell: Cell) -> int:
    return sum(SH.sharded_bytes_per_device(_tree(a), _tree(s), cell.mesh)
               for a, s in zip(cell.args, cell.specs))


def count_cell(cell: Cell) -> dict:
    """The record of a cell built on ``meta`` (no status)."""
    cfg, shape, mesh = cell.cfg, cell.shape, cell.mesh
    t0 = time.perf_counter()
    counts = OS.step_flops(cfg, shape, cell.tcfg)
    params = cell.args[0]["params"] if shape.kind == "train" else cell.args[0]
    n_pos = OS.positions(cfg, shape)
    p_specs = cell.specs[0]["params"] if shape.kind == "train" else cell.specs[0]
    m_specs = cell.specs[0]["opt"].get("m") if shape.kind == "train" else None
    coll = OS.collective_stats(cfg, shape, mesh, cell.dp, p_specs, params,
                               m_specs=m_specs, remat=cell.tcfg.remat,
                               n_pos=n_pos,
                               microbatches=cell.tcfg.microbatches)
    arg = argument_bytes(cell)
    out = OS.output_bytes(cfg, shape, mesh, cell.dp, cell.args, cell.specs,
                          n_pos=n_pos)
    n_dev = mesh.size
    analytic = {"flops_per_device": counts["flops"] / n_dev,
                "bytes_per_device": float(arg + out),
                "collectives": {k: coll[k] for k in OS.COLLECTIVES},
                "wire_bytes": coll["wire_bytes"],
                "wire_bytes_by_axes": coll["wire_bytes_by_axes"]}
    return {
        "mesh": list(mesh.sizes), "axis_names": list(mesh.axis_names),
        "n_devices": n_dev,
        "count_s": round(time.perf_counter() - t0, 2),
        "memory": {"argument_bytes": arg, "output_bytes": out,
                   "temp_bytes": None},
        "cost": {"flops": counts["flops"], "rest_flops": counts["rest"],
                 "layers": counts["layers"]},
        "analytic": analytic,
        "collectives": coll,
        **cell.extra,
    }


def measure_on_card(arch: str, shape_name: str, record: dict, *,
                    reps: int = CARD_REPS, seed: int = 0, **kw) -> dict:
    """Run the card cell's step (see the module docstring); returns the
    ``measured`` fields, and fills ``record``'s ``temp_bytes``."""
    from repro_torch.device import resolve_device

    dev = resolve_device(None)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    cell = build_cell(arch, shape_name, MESHES["card"], device=dev,
                      seed=seed, **kw)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    n_leaves = sum(len(T.leaves(_tree(a))) for a in cell.args)
    # the cell lets go of its arguments: a train step's first state must
    # not outlive the step that replaces it
    fn, args, train = cell.fn, list(cell.args), cell.shape.kind == "train"
    del cell

    def step():
        out = fn(*args)
        if train:                  # the next step starts from this one's state
            args[0] = out[0]
        return out

    with FlopCounterMode(display=False) as fc:
        out = step()
    torch.cuda.synchronize()
    ms, peak = [], 0
    for _ in range(reps):
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = step()
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
    result = out[1]["loss"] if train else out[0]
    finite = bool(torch.isfinite(result.float()).all())
    record["memory"]["temp_bytes"] = peak - held
    del args, out, result
    torch.cuda.empty_cache()
    return {"step_ms": statistics.median(ms), "step_ms_all": ms,
            "reps": reps, "argument_bytes_on_card": held,
            "argument_leaves": n_leaves,
            "max_memory_allocated": peak, "flops_on_card": int(
                fc.get_total_flops()), "finite": finite}


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             measure: bool = True, **kw) -> dict:
    """One cell's record; on the ``card`` mesh (with ``measure``) the step
    also runs on the card (:func:`measure_on_card`)."""
    cfg = get_config(arch)
    why = cfg.skips(shape_name)
    if why:
        return {"status": "skipped", "reason": why}
    cell = build_cell(arch, shape_name, MESHES[mesh_name], **kw)
    res = {"status": "ok", **count_cell(cell)}
    if mesh_name == "card" and measure:
        res["measured"] = measure_on_card(arch, shape_name, res, **kw)
    return res


def _safe_cell(job: tuple) -> dict:
    """:func:`run_cell` that records a failure instead of raising (a
    sweep's worker)."""
    arch, shape_name, mesh_name, kw = job
    torch.set_num_threads(1)
    try:
        return run_cell(arch, shape_name, mesh_name, **kw)
    except Exception as e:  # noqa: BLE001 (a failed cell is a result)
        return {"status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


def run_cells(jobs: list[tuple], n_workers: int = 1):
    """(arch, shape, mesh, kwargs) jobs -> their records, in order, as
    they finish (an iterator); ``n_workers`` > 1 counts ``meta`` cells in
    that many spawned processes (card cells run in this one)."""
    if n_workers <= 1:
        yield from map(_safe_cell, jobs)
        return
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(n_workers) as pool:
        yield from pool.imap(_safe_cell, jobs)


def cell_key(tag: str, arch: str, shape_name: str, mesh_name: str) -> str:
    return f"{tag}/{arch}/{shape_name}/{mesh_name}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    help="a name of SHAPES, or <kind>@B<batch>xT<seq>")
    ap.add_argument("--mesh", choices=["single", "multi", "both", "card"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--no-zero", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--tag", default="baseline", help="result namespace")
    ap.add_argument("--cache-policy", choices=["auto", "heads"], default="auto",
                    help="decode cache: seq-sharded (auto) or head-sharded")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for the meta cells")
    args = ap.parse_args(argv)

    card = args.mesh == "card"
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    default_shapes = list(CARD_SHAPES) if card else list(SHAPES)
    shapes = default_shapes if (args.all or not args.shape) else [args.shape]
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"], "card": ["card"]}[args.mesh]
    if card:
        # a full-width step's transients fragment the allocator's
        # fixed-size segments (set before the card's first use)
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    kw = dict(microbatches=args.microbatches, zero=not args.no_zero,
              remat=not args.no_remat, cache_policy=args.cache_policy)

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    todo = []
    for arch in archs:
        for shape_name in shapes:
            for mesh_name in meshes:
                key = cell_key(args.tag, arch, shape_name, mesh_name)
                if (key in results and not args.force and
                        results[key].get("status") in ("ok", "skipped")):
                    print(f"[cached] {key}")
                    continue
                todo.append((key, (arch, shape_name, mesh_name, kw)))
    t0 = time.perf_counter()
    jobs = 1 if card else args.jobs
    for (key, _), res in zip(todo, run_cells([j for _, j in todo], jobs)):
        results[key] = res
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        msg = res.get("reason") or res.get("error") or (
            f"{res['cost']['flops']:.4e} FLOPs, arguments "
            f"{res['memory']['argument_bytes'] / 2**30:.2f} GiB/dev, "
            f"counted in {res['count_s']} s")
        if "measured" in res:
            msg += f", {res['measured']['step_ms']:.2f} ms on the card"
        print(f"[{res['status']}] {key}: {msg}", flush=True)
    ok = sum(1 for v in results.values() if v.get("status") == "ok")
    sk = sum(1 for v in results.values() if v.get("status") == "skipped")
    er = sum(1 for v in results.values() if v.get("status") == "error")
    print(f"\ntotal: {ok} ok, {sk} skipped, {er} error -> {args.out} "
          f"({time.perf_counter() - t0:.1f} s for {len(todo)} cells)")


if __name__ == "__main__":
    main()
