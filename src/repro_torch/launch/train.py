"""Training launcher (counterpart of ``repro.launch.train``).

Restores the newest committed checkpoint if there is one and runs the
reference's fault-tolerant loop on one device: synthetic batches from
``data.pipeline``, the train step (AdamW, warmup then cosine decay, remat
on), a straggler monitor, asynchronous checkpoints, a log line every 10
steps:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --steps 50 --seq 256 --batch 8 --device cpu

``--device`` defaults to the CUDA card.  The master weights come from the
port's seeded init in ``cfg.param_dtype``.  A model-parallel mesh
(``--model-parallel`` above 1) and multi-host runs (``--distributed``)
wait for ROADMAP step 16c: the sharded step on several cards.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.device import resolve_device
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.elastic import StragglerMonitor, fit_mesh
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.step import (TrainConfig, init_train_state,
                                       make_train_step)


def device_batch(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train_config(steps: int, lr: float, microbatches: int = 1) -> TrainConfig:
    """The launcher's schedule: warmup max(5, steps // 20), cosine decay
    over ``steps``, remat on."""
    return TrainConfig(opt=OptConfig(lr=lr, warmup_steps=max(5, steps // 20),
                                     total_steps=steps),
                       microbatches=microbatches, remat=True)


def train_loop(cfg: ArchConfig, shape: ShapeSpec, tcfg: TrainConfig, *,
               steps: int, ckpt_dir: str, ckpt_every: int, device,
               task: str = "copy", resume_step: int | None = None,
               log=print):
    """Train to ``steps``, resuming from the newest checkpoint in
    ``ckpt_dir`` (or from ``resume_step``) when there is one, and
    checkpointing every ``ckpt_every`` steps on a thread.

    Returns (state, records): one record a step run, ``step``, ``loss``,
    ``grad_norm``, ``seconds`` (host clock around the step and the read
    of its loss) and, on the card, ``ms`` (CUDA events around the
    step)."""
    device = torch.device(device)
    state = init_train_state(cfg, tcfg, device=device)
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
    for i in range(start, steps):
        batch = device_batch(make_batch(cfg, shape, i, DataConfig(task)),
                             device)
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        if cuda:
            ev[1].record()
        loss = float(metrics["loss"])           # waits for the step
        dt = time.perf_counter() - t0
        straggle = mon.record(dt)
        rec = {"step": i, "loss": loss,
               "grad_norm": float(metrics["grad_norm"]), "seconds": dt}
        if cuda:
            ev[1].synchronize()
            rec["ms"] = ev[0].elapsed_time(ev[1])
        records.append(rec)
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i:5d} loss {loss:.4f} gnorm {rec['grad_norm']:.2f}"
                f"{' [straggler]' if straggle else ''}")
        if (i + 1) % ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = CKPT.save(state, ckpt_dir, i + 1, blocking=False)
    if pending is not None:
        pending.join()
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
                    help="multi-host runs (not ported yet)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.distributed or args.model_parallel > 1:
        raise NotImplementedError(
            "--distributed and --model-parallel > 1 run the sharded train "
            "step on several cards (ROADMAP step 16c), which the port does "
            "not have yet; the placement rules and the dry-run "
            "(python -m repro_torch.launch.dryrun) need no second card")
    # expandable segments: a full-width step's transients fragment the
    # allocator's fixed-size segments (set before the card's first use)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = fit_mesh(devices=[dev])
    print(f"mesh: {mesh.shape} | arch: {cfg.name} | device: {dev}")
    shape = ShapeSpec("launch", args.seq, args.batch, "train")
    train_loop(cfg, shape, train_config(args.steps, args.lr,
                                        args.microbatches),
               steps=args.steps, ckpt_dir=args.ckpt_dir,
               ckpt_every=args.ckpt_every, device=dev, task=args.task,
               log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
