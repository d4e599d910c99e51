"""Training launcher (counterpart of ``repro.launch.train``).

Restores the newest committed checkpoint if there is one and runs the
reference's fault-tolerant loop: synthetic batches from
``data.pipeline``, the train step (AdamW, warmup then cosine decay, remat
on), a straggler monitor, asynchronous checkpoints, a log line every 10
steps.  On one device:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --steps 50 --seq 256 --batch 8 --device cpu

Sharded over a process group, one process a rank (the reference's SPMD
program over its mesh): the state is placed as ``DTensor``s by
``distributed.sharding``'s rules on an ``(n_data, model_parallel)`` mesh,
the batch split over "data", and the step runs under the mesh's
activation pins:

  PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 4 \\
      -m repro_torch.launch.train --arch qwen2-1.5b --reduced \\
      --model-parallel 2 --steps 6 --device cpu

``--distributed`` asks for the same over a multi-node ``torchrun``
rendezvous.  ``--device`` defaults to the CUDA cards (rank r on card
``LOCAL_RANK % count`` over NCCL, at most one rank a card: ranks that
share a card are refused; ``--device cpu`` runs the ranks over gloo).
The master weights come from the port's seeded init in
``cfg.param_dtype``, drawn alike on every rank.  The sharded step covers
every family: the dense ones, MLA (minicpm3: the down projections
gathered, each rank on its own heads) and the vlm (internvl2: the patch
prefix gathered over "model"); the SSM and hybrid ones (mamba2, hymba:
each rank scans its own SSD heads, through K7 on the card); the MoE
family (deepseek-moe, llama4's dense + MoE pairs: each rank runs its own
experts on its own batch rows, with the whole batch's capacity, queue
order and drops); and the encoder-decoder (whisper: each rank on its own
heads in the encoder's, the decoder's and the cross attention, the tied
table vocab-parallel).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

import contextlib

import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.constraints import (activation_policy,
                                                 make_mesh_policy)
from repro_torch.launch.mesh import dp_axes
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import elastic as EL
from repro_torch.training.elastic import DistMesh, StragglerMonitor, fit_mesh
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.step import (TrainConfig, abstract_train_state,
                                       init_placed_train_state,
                                       init_train_state, make_train_step)


def device_batch(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def mesh_batch(batch: dict, mesh: DistMesh) -> dict:
    """A numpy batch (every rank makes the whole one) as ``DTensor``s
    split over the mesh's data axes, each rank keeping its rows."""
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    return SH.place(tensors, SH.batch_specs(tensors, dp_axes(mesh)), mesh)


def placed_state(cfg: ArchConfig, tcfg: TrainConfig, mesh: DistMesh,
                 seed: int = 0):
    """(state, specs): the seeded init placed on ``mesh`` by the
    reference's rules (ZeRO over the data axes for m and v)."""
    specs = SH.state_specs(abstract_train_state(cfg, tcfg), mesh,
                           dp_axes=dp_axes(mesh))
    return init_placed_train_state(cfg, tcfg, mesh, specs, seed), specs


def train_config(steps: int, lr: float, microbatches: int = 1) -> TrainConfig:
    """The launcher's schedule: warmup max(5, steps // 20), cosine decay
    over ``steps``, remat on."""
    return TrainConfig(opt=OptConfig(lr=lr, warmup_steps=max(5, steps // 20),
                                     total_steps=steps),
                       microbatches=microbatches, remat=True)


def train_loop(cfg: ArchConfig, shape: ShapeSpec, tcfg: TrainConfig, *,
               steps: int, ckpt_dir: str, ckpt_every: int, device=None,
               mesh: DistMesh | None = None, task: str = "copy",
               resume_step: int | None = None, log=print):
    """Train to ``steps``, resuming from the newest checkpoint in
    ``ckpt_dir`` (or from ``resume_step``) when there is one, and
    checkpointing every ``ckpt_every`` steps on a thread.  On ``device``,
    or, given a :class:`~repro_torch.training.elastic.DistMesh`, sharded
    over its ranks (every rank calls this; the state is ``DTensor``s, the
    checkpoints whole, written by rank 0).

    Returns (state, records): one record a step run, ``step``, ``loss``,
    ``grad_norm``, ``seconds`` (host clock around the step and the read
    of its loss) and, on the card, ``ms`` (CUDA events around the
    step; this rank's)."""
    if mesh is not None:
        device = mesh.device
        state, _ = placed_state(cfg, tcfg, mesh)
        to_device = lambda b: mesh_batch(b, mesh)  # noqa: E731
        policy = activation_policy(make_mesh_policy(mesh, dp_axes(mesh)))
    else:
        device = torch.device(device)
        state = init_train_state(cfg, tcfg, device=device)
        to_device = lambda b: device_batch(b, device)  # noqa: E731
        policy = contextlib.nullcontext()
    try:
        state, start = CKPT.restore(state, ckpt_dir, resume_step)
        log(f"resumed from step {start}")
    except FileNotFoundError:
        start = 0
    step_fn = make_train_step(cfg, tcfg)
    cuda = device.type == "cuda"
    mon = StragglerMonitor()
    pending = None
    records = []
    with policy:
        for i in range(start, steps):
            batch = to_device(make_batch(cfg, shape, i, DataConfig(task)))
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            if cuda:
                ev[1].record()
            loss = TP.whole(metrics["loss"]).item()   # waits for the step
            dt = time.perf_counter() - t0
            straggle = mon.record(dt)
            rec = {"step": i, "loss": loss,
                   "grad_norm": TP.whole(metrics["grad_norm"]).item(),
                   "seconds": dt}
            if cuda:
                ev[1].synchronize()
                rec["ms"] = ev[0].elapsed_time(ev[1])
            records.append(rec)
            if i % 10 == 0 or i == steps - 1:
                log(f"step {i:5d} loss {loss:.4f} gnorm "
                    f"{rec['grad_norm']:.2f}"
                    f"{' [straggler]' if straggle else ''}")
            if (i + 1) % ckpt_every == 0:
                if pending is not None:
                    pending.join()
                pending = CKPT.save(state, ckpt_dir, i + 1, blocking=False)
    if pending is not None:
        pending.join()
    if mesh is not None:
        dist.barrier()      # rank 0's last checkpoint is committed
    log(f"done at step {steps}; stragglers: {mon.flagged}")
    return state, records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true", help="CPU-sized config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "turbokv_launch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--task", default="copy",
                    choices=["copy", "markov", "uniform"])
    ap.add_argument("--distributed", action="store_true",
                    help="multi-node runs: join the process group of a "
                         "torchrun rendezvous (as any sharded run does)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA cards; cpu runs "
                         "on the host, and a sharded run's ranks over gloo)")
    args = ap.parse_args(argv)

    # expandable segments: a full-width step's transients fragment the
    # allocator's fixed-size segments (set before the card's first use)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeSpec("launch", args.seq, args.batch, "train")
    tcfg = train_config(args.steps, args.lr, args.microbatches)
    sharded = (args.distributed or args.model_parallel > 1
               or "WORLD_SIZE" in os.environ)
    if not sharded:
        dev = resolve_device(args.device)
        mesh = fit_mesh(devices=[dev])
        print(f"mesh: {mesh.shape} | arch: {cfg.name} | device: {dev}")
        train_loop(cfg, shape, tcfg, steps=args.steps, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every, device=dev, task=args.task,
                   log=lambda s: print(s, flush=True))
        return
    if "WORLD_SIZE" not in os.environ:
        raise SystemExit(f"usage: {EL.TORCHRUN_USAGE}")
    own_group = not dist.is_initialized()
    dev = EL.init_process_group(args.device)
    try:
        mesh = fit_mesh(model_parallel=args.model_parallel, device=dev)
        devices = [None] * mesh.size
        dist.all_gather_object(devices, str(dev))
        main_rank = mesh.rank == 0
        if main_rank:
            print(f"mesh: {mesh.shape} | arch: {cfg.name} | dp axes: "
                  f"{dp_axes(mesh)} | backend: {mesh.backend} | ranks: "
                  f"{mesh.size} | devices: {devices}", flush=True)
        train_loop(cfg, shape, tcfg, steps=args.steps,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                   mesh=mesh, task=args.task,
                   log=(lambda s: print(s, flush=True)) if main_rank
                   else (lambda s: None))
    finally:
        if own_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
