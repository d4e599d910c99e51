"""Serving demo: continuous batching over the TurboKV-routed KV cache
(counterpart of ``examples/serve_kvcache.py``).

A reduced qwen2-family model serves a stream of batched requests; request
caches are placed on logical storage shards by the hashed-id directory
(the paper's key-based routing), the controller rebalances hot shards from
the data-plane counters, and a shard failure fails active sequences over
to their chain replicas mid-generation.  The weights are the port's seeded
init (seed 0); ``run(params=...)`` serves others.

  PYTHONPATH=src python -m repro_torch.examples.serve_kvcache [--device cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from repro_torch import models as M
from repro_torch.configs import get_config
from repro_torch.examples._common import Lines, parser
from repro_torch.serving.engine import ServingEngine

N_REQUESTS = 24


def run(device=None, params: dict | None = None, echo: bool = True) -> dict:
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    out = Lines(echo)
    cfg = get_config("qwen2-1.5b").reduced()
    if params is None:
        params = M.init_params(cfg, 0, device=dev)

    eng = ServingEngine(cfg, params, n_slots=8, cache_len=96, n_shards=4,
                        device=dev)
    rng = np.random.default_rng(0)

    # a burst of requests with skewed prompt reuse (hot prefixes)
    t0 = time.perf_counter()
    rids = []
    for _ in range(N_REQUESTS):
        plen = int(rng.integers(4, 12))
        rids.append(eng.submit(rng.integers(0, cfg.vocab_size, plen),
                               max_new_tokens=12))

    steps = 0
    while eng.waiting or eng.active:
        eng.step()
        steps += 1
        if steps == 4:  # mid-stream: the controller rebalances
            moved, ops = eng.rebalance()
            out(f"[step {steps}] rebalance: {len(ops)} range moves, "
                f"{moved} active sequences migrated")
        if steps == 8:  # mid-stream: a storage shard dies
            victim = int(np.argmax(eng.shard_load()))
            failed_over = eng.fail_shard(victim)
            out(f"[step {steps}] shard {victim} failed -> "
                f"{len(failed_over)} sequences failed over to replicas")

    dt = time.perf_counter() - t0
    done = eng.finished
    total_tokens = sum(len(r.out_tokens) for r in done.values())
    out(f"finished {len(done)}/{N_REQUESTS} requests, {total_tokens} tokens "
        f"in {steps} engine steps ({dt:.1f}s, {total_tokens / dt:.1f} tok/s "
        f"{dev.type.upper()})")
    out("sample output:", done[rids[0]].out_tokens)
    assert len(done) == N_REQUESTS
    return {"lines": list(out), "steps": steps, "tokens": total_tokens,
            "seconds": dt,
            "out_tokens": [list(map(int, done[r].out_tokens)) for r in rids]}


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
