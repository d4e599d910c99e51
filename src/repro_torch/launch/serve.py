"""Serving launcher (counterpart of ``repro.launch.serve``).

Stands up the continuous-batching engine over the TurboKV-routed cache on
the card, replays a synthetic request trace, and runs the controller loop
(periodic rebalancing from data-plane counters; optional failure
injection):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --reduced --requests 24 --fail-shard-at 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --reduced --device cpu

Every decoder-only family serves: dense (qwen2, qwen3, gemma3), MLA
(minicpm3), MoE (deepseek-moe, llama4), vlm (internvl2, text only), ssm
(mamba2) and hybrid (hymba, whose meta tokens take cache rows:
``--cache-len`` must hold them and the prompt).  The encoder-decoder
(whisper) needs its frames and is driven through the model facade.

``--device`` defaults to the CUDA card; ``--device cpu`` runs the plain
versions on the host.  The weights come from the port's seeded init, in
the config's dtype.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import model as MODEL
from repro_torch.serving.engine import ServingEngine


def serve_loop(eng, *, rebalance_every: int = 6, fail_shard_at: int = -1,
               on_step=None, verbose: bool = False) -> list[dict]:
    """Step ``eng`` until its queue drains, running the controller loop: a
    rebalance every ``rebalance_every`` steps and, at step
    ``fail_shard_at``, the failure of the most-loaded shard.  Any engine
    with the reference's interface will do.  ``on_step(step, eng)`` runs
    after each step.  Returns one record a step: ``slot_shard`` and the
    ``active`` ids after it, and ``rebalance`` ``(moved, ops)`` and
    ``failed`` ``(shard, moved ids)`` where they happened."""
    records: list[dict] = []
    while eng.waiting or eng.active:
        if len(records) >= 10_000:
            raise RuntimeError("engine did not drain")
        eng.step()
        step = len(records) + 1
        rec = {"step": step, "slot_shard": eng.slot_shard.tolist(),
               "active": sorted(eng.active)}
        if rebalance_every and step % rebalance_every == 0:
            moved, ops = rec["rebalance"] = eng.rebalance()
            if ops and verbose:
                print(f"[step {step}] rebalance: {len(ops)} ranges, "
                      f"{moved} sequences migrated")
        if step == fail_shard_at:
            victim = int(np.argmax(eng.shard_load()))
            rec["failed"] = (victim, eng.fail_shard(victim))
            if verbose:
                print(f"[step {step}] injected failure of shard {victim}: "
                      f"{len(rec['failed'][1])} sequences failed over")
        if on_step is not None:
            on_step(step, eng)
        records.append(rec)
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--rebalance-every", type=int, default=6)
    ap.add_argument("--fail-shard-at", type=int, default=-1,
                    help="inject a shard failure at this engine step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = MODEL.init_params(cfg, args.seed, device=dev)
    eng = ServingEngine(cfg, params, n_slots=args.slots,
                        cache_len=args.cache_len, n_shards=args.shards,
                        device=dev)
    rng = np.random.default_rng(args.seed)

    for i in range(args.requests):
        plen = int(rng.integers(4, min(16, args.cache_len // 4)))
        eng.submit(rng.integers(0, cfg.vocab_size, plen),
                   max_new_tokens=args.max_new)

    t0 = time.perf_counter()
    records = serve_loop(eng, rebalance_every=args.rebalance_every,
                         fail_shard_at=args.fail_shard_at, verbose=True)
    # every step ends in a copy of its logits to the host, so the clock
    # includes the device's work
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out_tokens) for r in eng.finished.values())
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"served {len(eng.finished)}/{args.requests} requests, "
          f"{tokens} tokens in {len(records)} steps "
          f"({tokens / dt:.1f} tok/s on {where})")


if __name__ == "__main__":
    main()
