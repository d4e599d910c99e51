"""Query-trace walkthrough (counterpart of ``examples/trace_demo.py``).

Runs a retry storm with the overload control plane and span sampling on,
then renders one sampled query's span tree: where this query's
closed-loop latency went ({queue, inflation, bounce, retry_backoff,
service}), which node served it, how deep the admission queue was when it
arrived, and what retry orbit it found.  Finishes with the run's p999
tail attribution (the same decomposition summed over every tail span) and
the pipeline's stage timers.

The trace plane is a pure observer: the metric stream is bit-identical to
a telemetry-off run (deterministic hash sampling, no random draw
consumed).

  PYTHONPATH=src python -m repro_torch.examples.trace_demo [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from repro_torch.cluster import (
    ClusterConfig,
    EpochDriver,
    PolicyConfig,
    ScenarioConfig,
    TelemetryConfig,
    make_policy,
    make_scenario,
)
from repro_torch.examples._common import TIMER_HEADER, Lines, parser
from repro_torch.overload import OverloadConfig
from repro_torch.telemetry import BUCKETS, span_tree

SCFG = ScenarioConfig(n_epochs=12, epoch_ops=512, n_records=2048,
                      value_dim=4, seed=7)
CCFG = ClusterConfig(
    num_nodes=10, num_ranges=20, replication=2, standby_nodes=(8, 9),
    report_every=2,
    overload=OverloadConfig(queue_cap=48, service_rate=60, inflation=3.0,
                            max_level=3, backoff_base=1, jitter_span=2,
                            queue_weight=2),
    telemetry=TelemetryConfig(sample_rate=1 / 8, max_spans=64),
)


def run(device=None, echo: bool = True) -> dict:
    from repro_torch.device import resolve_device

    out = Lines(echo)
    scenario = make_scenario("retry_storm", SCFG)
    policy = make_policy("overload_adaptive", PolicyConfig(scale_patience=1))
    driver = EpochDriver(scenario, policy, CCFG, device=resolve_device(device))
    driver.run()
    tel = driver.telemetry

    assert driver.growth_events == 0, "tracing must not rebuild the step"
    assert tel.verify_exact() == 0.0, "span components must sum to DES latency"

    out(f"{SCFG.n_epochs} epochs x {SCFG.epoch_ops} ops retry storm, "
        f"{tel.span_count} spans recorded "
        f"({tel.summary()['spans_sampled']} sampled)\n")

    # the sampled query with the worst latency: the one worth explaining
    worst = max(
        ((rec, j) for rec in tel.epochs for j in range(rec["span_i"].shape[0])),
        key=lambda rj: rj[0]["lat"][rj[1]],
    )
    tree = span_tree(worst[0], worst[1], CCFG.latency)

    out(f"worst sampled query: {tree['op']} key=0x{tree['key']:08x} "
        f"(epoch {tree['epoch']}, qid {tree['qid']})")
    out(f"  routed range slot {tree['ridx']} -> node {tree['target']} "
        f"(chain {tree['chain']})")
    out(f"  admission: {tree['outcome']}, queue depth at entry "
        f"{tree['queue_depth']}, retry orbit {tree['orbit_level']}")
    out(f"  closed-loop latency {tree['latency']:.1f} ticks "
        f"(issued t={tree['start']:.1f})")
    out("  span tree:")
    out(f"    query {tree['latency']:8.1f} ticks")
    for hop in tree["hops"]:
        out(f"      {hop['name']:24s} {hop['dur']:8.1f} ticks  "
            f"[{hop['kind']}] @t={hop['start']:.1f}")
    out("  exact decomposition:")
    for b in BUCKETS:
        v = tree["components"][b]
        if v:
            bar = "#" * int(round(40 * v / tree["latency"]))
            out(f"    {b:14s} {v:8.1f}  {bar}")
    total = sum(tree["components"].values())
    out(f"    {'(sum)':14s} {total:8.1f}  == DES latency exactly")

    att = tel.attribution(99.9)
    out(f"\np99.9 tail attribution ({att['n_tail']} spans >= "
        f"{att['threshold']:.1f} ticks, of {att['n']} sampled):")
    for b in BUCKETS:
        share = att["share"].get(b, 0.0)
        out(f"  {b:14s} {share:6.1%}  {'#' * int(round(40 * share))}")

    timers = tel.summary()
    out("\n" + TIMER_HEADER)
    for name, share in sorted(timers["stage_share"].items(),
                              key=lambda kv: -kv[1]):
        out(f"  {name:12s} {share:6.1%}  ({timers['stage_s'][name]:.3f}s "
            f"x{timers['stage_calls'][name]})")

    lat = tel.all_latency()
    out(f"\nsampled-latency check: reconstruction max err "
        f"{tel.verify_exact()!r} over {lat.size} spans "
        f"(p99 {np.percentile(lat, 99):.1f} ticks)")
    return {"lines": list(out)}


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
