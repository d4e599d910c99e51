"""Closed-loop adaptive balancing walkthrough (paper §5.1; counterpart of
``examples/balance_demo.py``).

Replays a Zipf-1.2 shifting hotspot (the hot key block jumps to a new
quarter of the key space every few epochs) against a frozen directory and
against the full adaptive policy (migration, hot-range selective
replication, power-of-two-choices read spreading), printing the per-epoch
load imbalance and DES tail latency side by side; then whole-range
migration against hot-subset splitting on three simultaneous hotspots.

  PYTHONPATH=src python -m repro_torch.examples.balance_demo [--device cpu]
"""

from __future__ import annotations

import sys

from repro_torch.cluster import (
    ClusterConfig,
    EpochDriver,
    ScenarioConfig,
    make_policy,
    make_scenario,
    summarize,
)
from repro_torch.examples._common import Lines, parser

SCFG = ScenarioConfig(n_epochs=9, epoch_ops=1024, n_records=2048,
                      value_dim=4, seed=1, read_ratio=0.95)
CCFG = ClusterConfig(num_nodes=8, num_ranges=128, replication=2, r_max=5,
                     n_clients=32, imbalance_threshold=1.1,
                     max_moves_per_round=8)


def run(device=None, echo: bool = True) -> dict:
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    out = Lines(echo)

    def drive(policy_name: str, scenario: str, **kw):
        driver = EpochDriver(make_scenario(scenario, SCFG, **kw),
                             make_policy(policy_name), CCFG, device=dev)
        rows = driver.run()
        # one step a pool shape (the reference: one compile)
        assert driver.growth_events == 0, "the step must be built once"
        return rows, driver

    out(f"{SCFG.n_epochs} epochs x {SCFG.epoch_ops} ops, Zipf-1.2 hotspot "
        f"shifting every 3 epochs, {CCFG.num_nodes} nodes\n")
    runs = {name: drive(name, "shifting_hotspot", theta=1.2,
                        shift_every=3)[0]
            for name in ("frozen", "full_adaptive")}

    out("epoch | imbalance (max/mean)  | DES p99 (ticks)       | control actions")
    out("      | frozen    adaptive    | frozen    adaptive    |")
    for e in range(SCFG.n_epochs):
        f, a = runs["frozen"][e], runs["full_adaptive"][e]
        shifted = "  <- hotspot jump" if e % 3 == 0 and e > 0 else ""
        acts = sum(1 for ev in a.events if "->" in ev)
        out(f"  {e:2d}  | {f.imbalance:7.2f}   {a.imbalance:7.2f}     "
            f"| {f.p99:7.1f}   {a.p99:7.1f}     | {acts:3d} ops{shifted}")

    sf, sa = summarize(runs["frozen"]), summarize(runs["full_adaptive"])
    out(f"""
summary (mean over epochs)
  imbalance : {sf['mean_imbalance']:.2f} -> {sa['mean_imbalance']:.2f}
  DES p99   : {sf['mean_p99']:.1f} -> {sa['mean_p99']:.1f} ticks
  DES p50   : {sf['mean_p50']:.1f} -> {sa['mean_p50']:.1f} ticks
  throughput: {sf['mean_throughput']:.3f} -> {sa['mean_throughput']:.3f} ops/tick
  paid for with {sa['total_migration_bytes']} migration bytes
""")
    assert sa["mean_imbalance"] < sf["mean_imbalance"]
    assert sa["mean_p99"] < sf["mean_p99"]
    out("full_adaptive beats the frozen directory on imbalance AND tail latency")

    # hot-subset splitting (paper §5.1, "a subset of the hot data"):
    # split_hot carves the hot subset into a spare directory slot, then
    # migrates just that child
    out("multi-hotspot (3 simultaneous Zipf-1.3 spikes): whole-range vs "
        "hot-subset control\n")
    out("policy     | imbalance | p99     | entries moved | live ranges (slots)")
    for name in ("migrate", "split_hot"):
        rows, drv = drive(name, "multi_hotspot", theta=1.3, n_hotspots=3,
                          shift_every=3)
        s = summarize(rows)
        out(f"{name:10s} | {s['mean_imbalance']:9.2f} | {s['mean_p99']:7.1f} "
            f"| {s['total_migration_entries']:13d} "
            f"| {drv.controller.num_ranges} ({drv.controller.num_slots})")
    return {"lines": list(out)}


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
