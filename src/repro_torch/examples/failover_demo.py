"""Failure-handling walkthrough (paper §5.2) on the distributed store
(counterpart of ``examples/failover_demo.py``).

Populates a chain-replicated store, kills a node, lets the controller
splice it out of every chain and re-replicate from survivors, then kills
a whole rack (switch failure): data stays readable throughout (r-1 fault
tolerance per chain, restored after each repair round).  The closing
section times the repaired cluster under all three coordination models in
one pass of the DES engine.

  PYTHONPATH=src python -m repro_torch.examples.failover_demo [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch import core as C
from repro_torch import prng
from repro_torch.examples._common import Lines, parser

N_NODES, N_RANGES, R = 12, 48, 3


def run(device=None, echo: bool = True) -> dict:
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    out = Lines(echo)
    directory = C.make_directory(N_RANGES, N_NODES, R, num_pods=3,
                                 device=dev)                  # 3 racks
    store = C.make_store(N_NODES, capacity=512, value_dim=2, device=dev)

    rng = np.random.default_rng(1)
    keys = rng.choice(2**32 - 2, 200, replace=False).astype(np.uint32)
    vals = rng.normal(size=(200, 2)).astype(np.float32)
    vals_t = torch.from_numpy(vals).to(dev)
    q = C.make_queries(keys, np.full(200, C.OP_PUT), vals, device=dev)
    dec, directory = C.route(directory, q)
    store, _ = C.apply_routed(store, q, dec)
    out(f"loaded 200 keys x {R} replicas -> fill "
        f"{int(C.store_fill(store).sum())}")

    def verify(directory, store, label):
        qg = C.make_queries(keys, np.full(200, C.OP_GET), value_dim=2,
                            device=dev)
        dec, directory = C.route(directory, qg)
        _, resp = C.apply_routed(store, qg, dec)
        ok = bool(resp.found.all()) and bool(
            torch.allclose(resp.value, vals_t, atol=1e-6))
        out(f"  [{label}] all 200 keys readable and correct: {ok}")
        assert ok
        return directory

    report, directory = C.pull_report(directory, 0)
    ctl = C.Controller(directory)

    # a single node failure
    out("\nfailing node 5 ...")
    repair = ctl.handle_node_failure(5, report.node_load)
    store = C.execute_migrations(store, repair)
    directory = ctl.directory()
    directory = verify(directory, store, "after node-5 splice + re-replication")
    chains = directory.chains.cpu().numpy()
    clen = directory.chain_len.cpu().numpy()
    assert all(5 not in chains[i][: clen[i]] for i in range(N_RANGES))
    assert (clen == R).all(), "replication factor restored everywhere"
    out(f"  repair copies: {len(repair)}; replication back to r={R}")

    # a switch (rack) failure: every node behind it is gone
    addr = directory.node_addr.cpu().numpy()
    rack = [n for n in range(N_NODES)
            if int(addr[n, 0]) == 2 and n not in ctl.failed]
    out(f"\nfailing rack/pod 2 (nodes {rack}) ...")
    repair = ctl.handle_switch_failure(rack)
    store = C.execute_migrations(store, repair)
    directory = ctl.directory()
    directory = verify(directory, store, "after rack failure")

    # node recovery: it rejoins empty, the balancer reuses it
    out("\nrecovering node 5 ...")
    ctl.recover_node(5)
    report, directory = C.pull_report(directory, 1)
    qg = C.make_queries(keys, np.full(200, C.OP_GET), value_dim=2, device=dev)
    dec, directory = C.route(directory, qg)
    C.apply_routed(store, qg, dec)
    report, directory = C.pull_report(directory, 2)
    ctl2 = C.Controller(directory, C.ControllerConfig(imbalance_threshold=1.02,
                                                      max_moves_per_round=8))
    ctl2.failed = set(ctl.failed) - {5}
    moves = ctl2.balance(report)
    store = C.execute_migrations(store, moves)
    directory = ctl2.directory()
    directory = verify(directory, store,
                       f"after rebalancing {len(moves)} ranges onto node 5")
    out("\ncontroller log (tail):")
    for line in (ctl.log + ctl2.log)[-5:]:
        out("  ", line)

    # coordination timing on the repaired cluster: one DES call sweeps all
    # three coordination models over a mixed read/write stream
    out("\ncoordination timing after repair (one fused DES sweep,",
        f"backend={C.des.resolve_backend(None)}):")
    B = 2048
    rng2 = np.random.default_rng(7)
    mix_keys = rng2.choice(keys, B).astype(np.uint32)
    mix_ops = rng2.choice([C.OP_GET, C.OP_PUT], B, p=[0.7, 0.3])
    qm = C.make_queries(mix_keys, mix_ops, np.zeros((B, 2), np.float32),
                        device=dev)
    decm, directory = C.route(directory, qm)
    plans = [C.plan_hops(qm, decm, mode, C.LatencyModel(),
                         rng=prng.PRNGKey(0), num_nodes=N_NODES)
             for mode in C.MODES]
    lat, makespan = C.simulate_closed_loop(C.stack_plans(plans),
                                           n_clients=4, num_nodes=N_NODES)
    lat, makespan = np.asarray(lat), np.asarray(makespan)
    for i, mode in enumerate(C.MODES):
        out(f"  {mode:>13}: throughput {B / makespan[i]:.3f} ops/tick, "
            f"mean latency {lat[i].mean():.1f} ticks")
    return {"lines": list(out)}


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
