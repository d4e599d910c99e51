"""Quickstart: the TurboKV core in ~60 lines (counterpart of
``examples/quickstart.py``).

Builds a 16-range directory over 8 storage shards (chain replication
r=3), routes a YCSB-ish batch through the in-switch coordination path,
scans a range, triggers the load balancer, and survives a node failure.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch import core as C
from repro_torch.core import keys as K
from repro_torch.examples._common import Lines, parser


def run(device=None, echo: bool = True) -> dict:
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    out = Lines(echo)
    # the directory (the switch tables) and the sharded store
    directory = C.make_directory(num_ranges=16, num_nodes=8, replication=3,
                                 device=dev)
    store = C.make_store(num_shards=8, capacity=256, value_dim=4, device=dev)

    # clients PUT 64 key-value pairs
    rng = np.random.default_rng(0)
    keys = rng.choice(2**32 - 2, 64, replace=False).astype(np.uint32)
    vals = rng.normal(size=(64, 4)).astype(np.float32)
    q = C.make_queries(keys, np.full(64, C.OP_PUT), vals, device=dev)
    decision, directory = C.route(directory, q)         # key-based routing
    store, _ = C.apply_routed(store, q, decision)       # chain-replicated write
    out("per-shard fill:", C.store_fill(store).cpu().numpy().astype(np.int32))

    # GET them back (served by each chain's tail)
    qg = C.make_queries(keys, np.full(64, C.OP_GET), value_dim=4, device=dev)
    decision, directory = C.route(directory, qg)
    _, resp = C.apply_routed(store, qg, decision)
    found = bool(resp.found.all())
    err = float((resp.value.cpu() - torch.from_numpy(vals)).abs().max())
    out("all found:", found, "| max err:", err)

    # range SCAN (clone-and-circulate expansion)
    lo = int(keys.min())
    qs = C.make_queries(np.array([lo]), np.array([C.OP_SCAN]),
                        end_keys=np.array([(lo + 2**29) & K.MASK32]),
                        value_dim=4, device=dev)
    qs = C.expand_scans(directory, qs, max_scan_fanout=4)
    decision, directory = C.route(directory, qs)
    _, sresp = C.apply_routed(store, qs, decision, max_scan_results=16)
    out("scan hits:", int(sresp.scan_count.sum()))

    # controller: statistics -> migration (paper §5.1)
    report, directory = C.pull_report(directory, period=0)
    ctl = C.Controller(directory, C.ControllerConfig(imbalance_threshold=1.05))
    moves = ctl.balance(report)
    store = C.execute_migrations(store, moves)
    directory = ctl.directory()
    out("migrations executed:", len(moves))

    # node failure: splice + re-replicate (paper §5.2)
    repair = ctl.handle_node_failure(3, report.node_load)
    store = C.execute_migrations(store, repair)
    directory = ctl.directory()
    decision, directory = C.route(directory, qg)
    _, resp2 = C.apply_routed(store, qg, decision)
    survived = bool(resp2.found.all())
    out("after failing node 3 — all still found:", survived)
    assert found and survived
    return {"lines": list(out)}


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
