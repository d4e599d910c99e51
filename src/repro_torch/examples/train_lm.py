"""End-to-end training driver (counterpart of ``examples/train_lm.py``).

Trains a qwen2-family model (~110M parameters; ``--preset tiny`` for a
4-layer one) on the synthetic copy task with the production substrate:
AdamW and its cosine schedule, remat, microbatch accumulation, periodic
checkpoints written on a thread, restart from the latest checkpoint, and
a straggler monitor.  The initial state is the port's seeded init (seed
0); ``run(state=...)`` trains another.

  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 20 --preset tiny --device cpu
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.examples._common import Lines, parser
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import tree as T
from repro_torch.training.elastic import StragglerMonitor
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.step import (TrainConfig, init_train_state,
                                       make_train_step)

PRESETS = {
    # ~110M params: d=768, 12L, ff=2048, vocab 32k (tied)
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
                 d_ff=2048, vocab_size=32_000, seq=512, batch=8, micro=2),
    "tiny": dict(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
                 d_ff=256, vocab_size=2_048, seq=128, batch=8, micro=1),
}


def configs(preset: str, steps: int, lr: float):
    """The model config, the batch shape and the train config."""
    p = PRESETS[preset]
    cfg = dataclasses.replace(
        get_config("qwen2-1.5b"),
        n_layers=p["n_layers"], d_model=p["d_model"], n_heads=p["n_heads"],
        n_kv_heads=p["n_kv_heads"], head_dim=p["head_dim"], d_ff=p["d_ff"],
        vocab_size=p["vocab_size"], dtype="float32", param_dtype="float32",
    )
    shape = ShapeSpec("train", p["seq"], p["batch"], "train")
    tcfg = TrainConfig(
        opt=OptConfig(lr=lr, warmup_steps=max(10, steps // 20),
                      total_steps=steps),
        microbatches=p["micro"], remat=True,
    )
    return cfg, shape, tcfg


def run(device=None, *, steps: int = 300, preset: str = "100m",
        ckpt_dir: str | None = None, ckpt_every: int = 50, lr: float = 3e-4,
        state: dict | None = None, echo: bool = True) -> dict:
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    out = Lines(echo)
    cfg, shape, tcfg = configs(preset, steps, lr)
    if ckpt_dir is None:
        ckpt_dir = os.path.join(tempfile.gettempdir(), "turbokv_train_ckpt")
    if state is None:
        state = init_train_state(cfg, tcfg, 0, device=dev)
    n_params = sum(x.numel() for x in T.leaves(state["params"]))
    out(f"model: {n_params / 1e6:.1f}M params | steps: {steps}")

    # resume if a checkpoint exists (a restart-safe driver)
    try:
        state, start = CKPT.restore(state, ckpt_dir)
        out(f"resumed from step {start}")
    except FileNotFoundError:
        start = 0

    step_fn = make_train_step(cfg, tcfg)
    mon = StragglerMonitor()
    pending = None
    history = []
    for i in range(start, steps):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 make_batch(cfg, shape, i, DataConfig(task="copy")).items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])           # waits for the step
        dt = time.perf_counter() - t0
        lr_i, gnorm = float(metrics["lr"]), float(metrics["grad_norm"])
        history.append({"step": i, "loss": loss, "lr": lr_i,
                        "grad_norm": gnorm, "seconds": dt})
        straggle = mon.record(dt)
        if i % 10 == 0 or i == steps - 1:
            out(f"step {i:4d} loss {loss:.4f} lr {lr_i:.2e} gnorm {gnorm:.2f} "
                f"{dt:.2f}s{' [straggler]' if straggle else ''}")
        if (i + 1) % ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = CKPT.save(state, ckpt_dir, i + 1, blocking=False)
    if pending is not None:
        pending.join()
    out(f"done; stragglers flagged: {mon.flagged}")
    return {"lines": list(out), "n_params": n_params, "start": start,
            "history": history}


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--preset", choices=PRESETS, default="100m")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoints (default: turbokv_train_ckpt in the "
                         "temp dir); a run resumes from the latest there")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    args = ap.parse_args(argv)
    run(args.device, steps=args.steps, preset=args.preset,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, lr=args.lr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
