"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase (the default)
    python3 chip_smoke.py --phases device,kernels

Phases, each printing one JSON line (any failure raises and the script
exits non-zero):

1. device      the card (``nvidia-smi`` name and power limit), and the
               build of the CUDA kernels (range_match, decode_attn,
               ssd_chunk) and the DES core from the sources in this
               checkout, one compiler process each, all started together
               (build seconds); the DES must time with its native core,
               not the heapq fallback;
2. kernels     each range_match kernel (K1 ``range_match``, K2
               ``range_match_spread``, K3 ``range_match_spread_dirty`` without
               and with the 64-bit key filter, K4a ``slab_lookup``, K4b
               ``range_match_apply``, K5 ``range_match_stale`` over four
               perturbed switch copies of the tables) against its plain
               PyTorch version on the card at the full-width shapes of the
               main path, bitwise, with its bound and two CUDA-event
               timings, each after an L2 flush (the paths meet their
               inputs in device memory): ``ms``, the call as the path pays
               it (the wrapper's host work included), and ``device_ms``,
               the kernels alone (replays of a CUDA graph captured around
               the call, less those of the flush alone); the library
               yardsticks likewise; for K1-K4b also the split of their
               device time between ``span_order`` and the route kernel
               (``torch.profiler``) and the match pass the route kernel
               took over the sorted span table (``match``, which must be
               ``"search"`` on a controller's directory), for K5 the split
               between ``span_order`` and its search kernel and the pass of
               each switch copy (each must be ``"search"``), and K1 once more
               at the serving router's shape (B 32, 32 hash-partitioned
               slots); then K6
               ``decode_attn`` against its plain version within a
               stated tolerance (f32 1e-4; bf16 two bf16 steps of each
               output, ``K6_TOL``): (a) qwen2-1.5b's heads in bf16 at
               ``decode_32k`` cut to a batch of 32, (b) gemma3-1b's heads
               in f32 with its 512 window, (c) lengths past S (F8), (d)
               the serving phase's shape (S 8,192, lengths 257-2,176),
               then phase families' shapes: deepseek-moe-16b's G 1 D 128
               (S 4,096), llama4's G 5 (S 8,192), internvl2-26b's G 6
               (S 4,096), whisper-small's G 1 D 64 self attention (S 448)
               and cross attention (1,500 encoder rows), each
               with SDPA's time as the library yardstick; then K7
               ``ssd_chunk`` against its plain version within
               |err| <= 2e-4 (1 + |want|) on y and the final state
               (``K7_TOL``): (a) mamba2-370m's heads over a 32,768-token
               prefill with the model's dt / A ranges, (b) hymba-1.5b's
               heads at B 4 over 2,100 tokens (padded), (c) a chunk of 10
               with G 2, (d) mamba2-370m's heads at the serving phase's
               mean prompt of 1,170 tokens, (e) mamba2-370m's heads at
               the training shape, B 8 x 2,048; its bound counts
               operations and bytes;
3. parity      the port's EpochDriver on the card against itself on the
               CPU at the test configuration (metric stream, final store,
               chains, replication register file and coordination-tier
               state bit-identical), and fused == per-epoch on the card, for
               eventual replication (``shifting_hotspot``), for ``chain`` /
               ``craq`` / craq with an 8-bit key filter (``ycsb_a``), and
               with the lag-1 coordination tier (``shifting_hotspot``,
               ``split_brain`` with and without quorum, craq on
               ``ycsb_a``), with the overload plane of
               ``tests/test_overload.py`` (``cascade_failure`` and
               ``retry_storm`` under ``overload_adaptive`` with a standby
               node, craq on ``ycsb_a``: the final ``OverloadState`` too,
               K2 / K3 once an epoch under a nonzero queue penalty,
               conservation) and with ``split_overflow`` pool growth
               (``keyspace_growth`` into an 8-slot pool: the same
               ``grow_pool`` events and ``compiled_steps``), and with both
               observability planes on (span tables, counts, attribution,
               the metrics ring, burn arrays, alert timelines and flight
               dumps too): ``tests/test_telemetry.py``'s traced run, craq
               under the lag-1 tier (bounce and redirect columns) and the
               overload plane under pool growth with linked retry orbits;
               and the dist backend on an 8-shard mesh (the load
               registers too): p2c with the overload plane and both
               observability planes, craq on ``ycsb_a``, the lag-1 tier
               through ``split_brain``, and a lognormal service model
               (the port's reproductions of XLA's float32 log1p and exp);
               then the replication bench
               (``repro_torch.replication.bench``) and the coordination-tier
               bench (``repro_torch.coordination_tier.bench``) on the card
               at their full sizes, whose gates must come back empty; then
               the serving engine on the card against itself on the CPU
               (reduced qwen2-1.5b, gemma3-1b, mamba2-370m, hymba-1.5b,
               deepseek-moe-16b, minicpm3-4b, internvl2-26b and llama4 in
               f32, TF32 off: 7 requests, 4 slots, a 64-position cache,
               4 shards, a rebalance every 2 steps and a shard failure at
               step 3): equal tokens, shards, migrations and failovers,
               every picked logits row within 1e-4, K1 launched, K6 on
               every GQA attention of every decode step (``gqa_attentions``:
               none for MLA, two a llama4 pair) and K7 on every SSM layer
               of every prefill; and reduced whisper-small through the
               model facade (4 utterances, 8 greedy steps): equal tokens,
               logits within 1e-4, K6 on both attentions of every layer;
               then one train step of reduced qwen2-1.5b, deepseek-
               moe-16b, mamba2-370m and hymba-1.5b (f32, remat, TF32 off)
               on the card against the CPU from one state and batch: loss,
               every gradient and every updated leaf within 1e-4, the SSM
               layers' scans through K7 forward (and in the remat
               recompute) and the plain chunked scan's VJP backward
               (``ssd_chunk_plain_grad`` counted); and ``ssd_scan`` with a
               gradient asked for on the card: one K7 launch, y within
               ``K7_TOL`` of the CPU plain version's, the gradients of A,
               x, dt, B and C within 1e-4 (1 + |cpu|) of its, one backward
               counted, while the same call under no_grad launches K7
               once and counts no backward;
4. full_width  the main path at full width — YCSB records of
               fieldcount 10 x fieldlength 100 (value_dim 256 float32),
               1,000,000 records, 65,536 ops an epoch, 8 nodes, 1024 ranges
               — ``shifting_hotspot`` with replication 2 under ``frozen``
               and ``full_adaptive``, and YCSB workload A with replication 3
               under ``craq``/``full_adaptive`` and ``chain``/``frozen``, and
               the four-switch lag-1 coordination tier under
               ``full_adaptive`` (``shifting_hotspot``) and ``frozen``
               (``split_brain``); the kernels' launch counts are read around
               each run, every acknowledged write is read back from every
               live replica, and the tier runs must redirect, mis-serve
               nothing and conserve ``routed == direct + redirected`` on
               every epoch.  After the craq run, ``route_and_lookup`` (K4b)
               runs on its live state, held against K3 followed by K4a;
5. overload    the overload plane at full width: the reference's overload
               bench deployment (``benchmarks/overload_bench.py``) at phase
               4's data — 10 nodes with standby (8, 9), replication 2,
               1024 ranges, ``overload_adaptive`` (scale patience 1), a pull
               every 2 epochs, queue 6,144 and service 10,240 a node and
               epoch (the bench's ratios to an active node's share) — on
               ``cascade_failure`` (rack 0-2 dies at epoch 3) and
               ``retry_storm`` (rack 0-1 out in epochs 2-4), 8 epochs
               each, and the cascade once more with a queue of 20,480 that
               outlives its epoch; conservation after every period, K2 once
               an epoch (under a nonzero queue penalty in the third run),
               deferred or shed queries after the failure, every
               acknowledged write read back from every live replica;
               epochs/s, stage seconds, losses, backlog, p999, autoscale
               events and peak memory;
   telemetry   both observability planes at full width on phase
               overload's ``retry_storm`` deployment, with the metrics
               bench's settings (spans sampled at 1/64 into 64 slots, a
               4-epoch flight ring, a 64-epoch metrics ring, the p999 SLO
               at 150 with windows 2 / 4) and 12-bit orbit linking, against
               the same run with them off: equal metric streams, final
               store and registers, exact attribution, the burn alerts of
               the numpy oracle, a complete incident report, and every
               sampled span counted; epochs/s and stage seconds with the
               planes on and off, the device time of an epoch's
               ``collect_spans`` + ``record_epoch``, alerts and peak
               memory;
   dist        the dist backend (``backend="dist"``, the sharded data
               plane of ``core/dist_store.py``) at phase 4's full width on
               an 8-shard mesh on the card, buckets of epoch_ops / N =
               8,192: (a) ``shifting_hotspot`` x ``frozen``, whose metric
               stream and final store must equal phase 4's oracle run bit
               for bit, (b) ``full_adaptive`` (K2 once a shard and epoch),
               (c) YCSB-A ``craq`` x ``full_adaptive`` (K3 likewise) and
               (d) the four-switch lag-1 tier through ``split_brain``
               (K5); bucket overflow 0 in every epoch, every acknowledged
               write read back from every live replica; epochs/s, stage
               seconds, device step, exchange rounds, dirty reads and peak
               memory;
   paper       the paper's evaluation (``repro_torch.benchmarks``): the
               CLI's full run (``python -m repro_torch.benchmarks.run``)
               into ``BENCH_torch_coordination.json``: fig 13a, fig 13b/c,
               tables 1-2, the §5.1 migration effect and the §6 pod
               crossing at 8,192 ops a workload, routed (K1) and planned
               on the card, their rows equal bit for bit to the CPU
               path's (whose rows and raw outputs equal the reference's,
               ``tests/data/paper_rows_reference.json``), with the
               in-switch over server-driven ratios; the DES engine
               against its heapq oracle, bit for bit, and the 1,000,000-op
               three-mode sweep; fig 13a at 1,000,000 ops a workload (5
               workloads through K1, 15 lanes of hop plans, one fused DES
               call on the host; seconds by stage); the balance gate matrix
               (7 scenarios x 5 policies, 10 epochs of 1,024 ops, 128
               ranges; each run driven once, without the CLI's
               ``steady_eps`` re-drive) into ``BENCH_torch_balance.json``,
               whose gates must
               come back empty, and its --quick ``shifting_hotspot`` x
               {``frozen``, ``full_adaptive``} rows equal on the card, on
               the CPU and in the fixture (but ``wall_s``, and the
               reference's own ``host_syncs``);
   benches     the repo's other benches at their default sizes on the
               card: the overload survival matrix (both arms x
               cascade_failure, retry_storm) and its trace column, the
               metrics plane's parity and forced breach, the scale-out
               bench's four drivers on the 8-shard mesh, the balance
               bench's --profile, --trace, --dist and --replication
               extras; every row equal to the reference's in
               ``tests/data/bench_rows_reference.json`` (made by
               ``tests/bench_reference.py``) but the clock's columns and
               the host syncs, every correctness gate holding (survival,
               conservation, parity, alerts against the numpy oracle,
               incident completeness, pool growth, ``traces``), the two
               wall-clock gates (the dist bench's 2x, --profile's 1.2x)
               printed as verdicts that do not decide ``ok``; then the six
               demos (``repro_torch.examples``; ``train_lm`` at --preset
               tiny, 20 steps), their lines equal to the reference's (the
               serving demo's but its tokens, and the training demo's
               parameter count and rates: both start from the port's
               seeded init); artifacts in a temporary directory; the
               store kernels' launches as path ``benches``, and with K6
               as path ``examples``;
6. serving     the serving path at full width: ``ServingEngine`` on
               qwen2-1.5b (28 layers, d 1536, 12 / 2 heads of 128, vocab
               151,936, bf16 weights from the port's seeded init), 32 slots
               of an 8,192-position cache (7.5 GB), 4 shards of replication
               2, 64 requests of 256-2,048 prompt tokens and 128 new tokens
               each, greedy, a rebalance every 6 steps and the most-loaded
               shard failed at step 8; every request must finish and no
               sequence may sit on the dead shard afterwards; K6 is held
               against its plain version on layer 0's live cache mid-run;
               tokens/s, prefill seconds and decode-step milliseconds
               (CUDA events), launches, migrations and peak memory;
7. serving_ssm the same engine, traffic and gates on mamba2-370m at its
               published widths (48 layers, d 1024, 32 SSD heads of 64,
               d_state 128, vocab 50,280, tied embeddings, bf16 weights from
               the port's seeded init; no KV cache, 48 MiB of f32 decode
               state a slot): K7 on every layer of every prefill, held
               against its plain version on layer 0's live scan inputs of
               the first prefill; decode by the recurrence;
8. families    the families added last, at their published widths with
               bf16 weights from the port's seeded init, one line each:
               the serving traffic above, cut to 12 requests, through the
               engine on
               deepseek-moe-16b (a 4,096-position cache; the MoE drops of
               one 2,048-token prompt), minicpm3-4b (MLA, no K6; one
               decode step against the teacher-forced prefill), internvl2-
               26b (a 4,096-position cache; then one facade prefill of 256
               patch embeddings before 256 tokens and 16 decode steps) and
               llama4-maverick cut to one dense + MoE pair (an 8,192-
               position cache), K6 held against its plain version on layer
               0's live caches (both sublayers of the pair); then whisper-
               small through the facade: 32 utterances of 1,500 frame
               embeddings, the start-of-transcript prompt, 128 greedy
               steps in its 448-position context, K6 on the self and the
               cross attention of every layer, held against its plain
               version on layer 0's caches.  Gates: every request
               finishes, none stays on the failed shard, K6 launches ==
               ``gqa_attentions`` x steps, parameter counts within the
               reference's ranges (the pair: its exact count);
9. training    ``launch/train.py``'s loop on qwen2-1.5b (28 layers, d
               1536, vocab 151,936) and then mamba2-370m (48 layers, d
               1024, 32 SSD heads of 64, d_state 128, vocab 50,280, tied
               embeddings), each at its published widths and depth: bf16
               compute over float32 master weights and AdamW state,
               remat, the copy task, 16 steps of 8 x 2,048 tokens, lr
               3e-4 with the launcher's warmup, a checkpoint every 8
               steps on a thread; then step 8's checkpoint restored and
               steps 8-9 replayed.  tokens/s, step ms p50 / p99 (CUDA
               events), peak memory, ``train_mfu`` (model FLOPs over the
               H100's dense bf16 peak; mamba2 has no attention term) and
               the device's busy share of one more, profiled step, and
               for mamba2 the SSD scans' share of the step (one layer's
               scan at the training shape, K7 forward, K7 recompute and
               the plain VJP backward, timed with CUDA events and
               profiled on its own, times 48 layers, over the profiled
               step's device time and kernels and over step ms p50);
               gates: the loss falls (the
               mean of the last 5 steps under that of the first 5), no
               kernel launches but K7's (the reference trains through
               jnp; mamba2's scans launch K7 twice a layer and step and
               count one backward through the plain scan's VJP), the
               replay within 1e-3 (and whether bit for bit);
10. dryrun     the dry-run (``repro_torch.launch.dryrun``) on this machine,
               which has no JAX: (a) the ten configs' ``train_4k`` and
               ``decode_32k`` cells on the 16x16 mesh at published widths,
               counted on ``meta`` in spawned workers (status or skip
               reason, argument GiB a device, counted and model FLOPs, the
               bound and the roofline fraction); (b) qwen2-1.5b and
               mamba2-370m at full width on the ``card`` mesh (1x1 on this
               H100): train at phase training's 8 x 2,048, a 2,048-token
               prefill and a decode step of phase serving's 32 slots of
               8,192 positions, each predicted on ``meta`` and then run
               (CUDA-event ms, the median of 3 after one warm-up), with
               the predicted argument bytes against those the arguments
               occupy, ``temp_bytes`` from the allocator, the bound and the
               measured fraction; gates: the bytes at least those
               predicted and less than 512 B a leaf above them, the
               warm-up's ``FlopCounterMode`` count plus the plain FLOPs of
               the kernels it launched (which it cannot see) equal to the
               prediction exactly, K6 (qwen2's decode) and K7 (mamba2's
               prefill and train) once a layer and step, finite outputs.

Three more phases run only when named in ``--phases``: ``profile``
(``torch.profiler`` over two full-width epochs of the epoch driver),
``serving_profile`` (over two full-width decode steps with every slot busy,
and one prefill of 2,048 tokens) and ``grid_study`` (with ``kernels``: the
device time of K1-K4b at the phase 2 shape under a grid of one thread a
packet and of 1, 2 and 3 blocks an SM, in turns).

It then prints the kernel table (``{"kernels": [...]}``, with each main
path's launch counts in ``launches_by_path``, and beside K7 the backward
passes through the plain scan's VJP, ``plain_vjp_backward_by_path``),
the card line,
and last ``{"ok": true, "device": {...}}``.  Without a CUDA card it exits
non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

PHASES = ("device", "kernels", "parity", "full_width", "overload",
          "telemetry", "dist", "paper", "benches", "serving", "serving_ssm",
          "families", "training", "dryrun")
EXTRA_PHASES = ("profile", "serving_profile",   # run only when named
                "grid_study")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def l2_flush() -> None:
    """Read a buffer of twice the card's L2 (``telemetry.profiler.
    l2_flush``), so that the next kernel meets its inputs in device
    memory, as the paths do: a decode step reads 28 layers' caches in
    turn, and the store's kernels run between other work."""
    from repro_torch.telemetry.profiler import l2_flush as flush

    flush(torch.device("cuda", 0))


def time_cuda(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timed calls,
    each on an idle stream after an L2 flush: the call as the path pays it,
    the wrapper's host work included."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        l2_flush()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def time_device(fn, calls: int = 20, reps: int = 5) -> float:
    """Median device milliseconds of one ``fn()`` after an L2 flush: a CUDA
    graph of ``calls`` pairs (flush, call) and one of ``calls`` flushes
    alone, each replayed ``reps`` times in turn between CUDA events; the
    difference of their medians, over ``calls``.  The wrappers' host work
    (checks, allocations, the ctypes call) runs once, at capture, so the
    window holds the kernels and the gaps between them only;
    ``time_cuda`` times the call as a caller pays it."""
    def flushed_call():
        l2_flush()
        fn()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            flushed_call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graphs = []
    for body in (flushed_call, l2_flush):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                body()
        graph.replay()
        graphs.append(graph)
    torch.cuda.synchronize()
    times = [[], []]
    for _ in range(reps):
        for graph, out in zip(graphs, times):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b) / calls)
    del graphs
    torch.cuda.empty_cache()
    return float(np.median(times[0]) - np.median(times[1]))


def _dev_us(e) -> float:
    """A profiler event's own device microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def device_split(fn, names: tuple, calls: int = 20) -> dict:
    """Device milliseconds a call of each kernel of ``fn`` whose name holds
    one of ``names`` (``torch.profiler`` over ``calls`` calls, each after
    an L2 flush; the flush's own kernel is not among them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            l2_flush()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        for n in names:
            if n in e.key:
                out[n] = out.get(n, 0.0) + _dev_us(e) / calls / 1e3
    return out


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    from repro_torch.core import _des_native
    from repro_torch.kernels.decode_attn import kernel as DAK
    from repro_torch.kernels.range_match import kernel as RMK
    from repro_torch.kernels.ssd_chunk import kernel as SSK

    t0 = time.perf_counter()
    # one compiler process per source, all started together
    with ThreadPoolExecutor(max_workers=4) as ex:
        futures = [ex.submit(RMK.build), ex.submit(DAK.build),
                   ex.submit(SSK.build), ex.submit(_des_native.load)]
        libs = [f.result() for f in futures]
    build_s = time.perf_counter() - t0
    RMK._load()
    DAK._load()
    SSK._load()
    from repro_torch.core import des as TDes

    # the C event core times every run below, not the heapq fallback
    if not _des_native.available() or TDes.resolve_backend(None) != "native":
        raise AssertionError("the native DES core is not the one in use: "
                             f"{_des_native.unavailable_reason()}")
    here = Path(__file__).parent
    out = {"phase": "device", "card": card_line(),
           "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "kernel_library": os.path.relpath(libs[0], here),
           "decode_attn_library": os.path.relpath(libs[1], here),
           "ssd_chunk_library": os.path.relpath(libs[2], here),
           "des_backend": "native", "build_s": build_s}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

B_FULL = 65536
N_FULL = 8
RANGES_FULL = 1024
S_FULL = 2 * RANGES_FULL
R_MAX = 4
RECORDS_FULL = 1_000_000
C_FULL = max(256, 2 * RECORDS_FULL * R_MAX // N_FULL)
F_FULL = 64                # the key-filter width the replication bench uses


def _full_width_tables(rng, dev):
    """A full-width directory after some random control history."""
    from repro_torch.core import directory as D
    from repro_torch.core.controller import Controller

    d = D.make_directory(RANGES_FULL, N_FULL, 2, r_max=R_MAX, n_slots=S_FULL,
                         device=dev)
    ctl = Controller(d)
    load = rng.random(N_FULL)
    for _ in range(400):
        r = int(rng.choice(ctl.live_ranges()))
        act = rng.integers(0, 3)
        if act == 0:
            lo, hi = ctl.range_span(r)
            if hi - lo > 2:
                ctl.split_range(r, int(rng.integers(lo, hi)))
        elif act == 1:
            ctl.widen_chain(r, load)
        elif ctl.children():
            ctl.merge_range(int(rng.choice(ctl.children())))
    return ctl.directory()


def _slabs(rng, dev):
    slabs = np.full((N_FULL, C_FULL), 0xFFFFFFFF, np.int64)
    for n in range(N_FULL):
        m = int(rng.integers(C_FULL // 4, C_FULL // 2))
        slabs[n, :m] = np.sort(rng.choice(2**32 - 1, m, replace=False))
    return torch.tensor(slabs, device=dev)


W_FULL = 4                 # switches of the coordination tier


def _perturbed_coord(directory, dev):
    """The tier's W switch copies of ``directory``'s tables, perturbed as
    the reference's kernel test perturbs them: divergent versions on two
    switches, chain ownership rotated on one, a dead row retired on one
    switch only, a shifted bound."""
    import dataclasses

    from repro_torch import coordination_tier as CT

    tables = {f: getattr(directory, f).cpu().numpy()
              for f in ("slot_lo", "slot_hi", "live", "chains", "chain_len")}
    c = CT.make_state(tables, W_FULL, device=dev)
    ver = c.version.clone()
    ver[1, ::2] = 7
    ver[3, :] = 3
    ch = c.chains.clone()
    ch[1] = torch.where(ch[1] >= 0, (ch[1] + 1) % N_FULL, ch[1])
    lv = c.live.clone()
    lv[2, int(torch.nonzero(lv[2])[5])] = False
    lo = c.slot_lo.clone()
    lo[3, 2] += 3
    return dataclasses.replace(c, version=ver, chains=ch, live=lv, slot_lo=lo)


# the serving router's table: 4 shards, one slot for each of
# max(16, 8 x 4) hash-partitioned ranges; a decode step routes 32 slots
ROUTER_SHARDS = 4
ROUTER_B = 32
# the route kernels (K1-K4b): over more than 256 slots each call runs
# span_order, then the route kernel that searches its sorted span table
ROUTE_KERNELS = ("range_match", "range_match_spread",
                 "range_match_spread_dirty", "range_match_apply")
ROUTE_PARTS = ("span_order", "route_kernel")
# K5: span_order over the W switch copies, then the search kernel
STALE_PARTS = ("span_order", "stale_kernel")


# phase dist's shapes of K2, K3 and K4a (phase 2 checks them on its data):
# K2 / K3 route each shard's slice of B_FULL / N_FULL queries with the
# draws of fold_in(key, shard), and K4a takes every shard's inbound
# buckets of a round, (N_FULL, N_FULL x BUCKET_CAP_FULL) queries, in one
# launch against the (N_FULL, C_FULL) slabs
BUCKET_CAP_FULL = B_FULL // N_FULL
DIST_V = 4                 # value width of the K4a round (K4a reads keys)


def _dist_route_check(fn, plain) -> dict:
    """K2 / K3 as the dist plane launches them: ``fn(shard)`` is one
    shard's launch on its slice with its own draws, ``plain(shard)`` the
    plain version on the same inputs; all N_FULL launches bitwise, and
    the time of the whole set (one epoch's routing)."""
    for me in range(N_FULL):
        got, want = fn(me), plain(me)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"shard {me}'s slice: kernel disagrees "
                                     "with its plain version")
    every = lambda f: lambda: [f(me) for me in range(N_FULL)]
    return {"B": B_FULL // N_FULL, "launches": N_FULL, "draws": "fold_in",
            "parity": "bitwise", "ms": time_cuda(every(fn)),
            "plain_ms": time_cuda(every(plain), reps=5, warmup=1)}


def _dist_read_round_check(RMK, REF, slabs, qkeys, target, opcodes,
                           seed: int) -> dict:
    """K4a at phase dist's read round and DEL-probe round: the batch
    bucketed by target shard (``BUCKET_CAP_FULL`` a bucket) and
    exchanged as the bucket plane does, then ``store.shards_read`` on the
    card (one K4a launch a round) against the same call on CPU copies,
    which runs K4a's plain version; and the flat launch itself against
    ``slab_lookup_ref`` on the card, both bitwise."""
    from repro_torch.core import dist_store as DS
    from repro_torch.core import keys as K
    from repro_torch.core import routing as R
    from repro_torch.core import store as TS

    dev = slabs.device
    n, cap = N_FULL, BUCKET_CAP_FULL
    rng = np.random.default_rng(seed + 23)
    values = torch.tensor(rng.normal(size=(n, C_FULL, DIST_V))
                          .astype(np.float32), device=dev)
    store = TS.StoreState(keys=slabs, values=values,
                          overflow=torch.zeros(n, dtype=torch.int64,
                                               device=dev))
    host = TS.StoreState(*(x.cpu() for x in (store.keys, store.values,
                                             store.overflow)))
    rows = lambda x: x.reshape(n, cap)
    # the read round: GETs to their target; the write round: PUTs and
    # DELs to a chain member, whose DEL hits are probed first
    read_t = torch.where(opcodes == K.OP_GET, target, DS.DROP)
    ops_w = torch.tensor(np.where(rng.random(B_FULL) < 0.5, K.OP_DEL,
                                  K.OP_PUT).astype(np.int32), device=dev)
    write_t = torch.where(opcodes != K.OP_GET, target, DS.DROP)
    zeros_v = torch.zeros((), dtype=torch.float32,
                          device=dev).expand(n, n * cap, DIST_V)
    out = {"queries": n * n * cap, "shape": {"N": n, "C": C_FULL},
           "parity": "bitwise"}
    for rnd, tgt, ops in (("read", read_t, opcodes), ("del_probe", write_t,
                                                      ops_w)):
        slot, ovf = DS.bucketize(rows(tgt), n, cap)
        if int(ovf.sum()):
            raise AssertionError(f"K4a {rnd} round: a bucket overflowed")
        bkeys, bop = (DS._a2a(DS.scatter_to_buckets(slot, rows(x), n * cap,
                                                    fill), n)
                      for x, fill in ((qkeys, K.EMPTY_KEY), (ops, K.OP_GET)))
        q = R.QueryBatch(bop, bkeys, torch.zeros_like(bkeys), zeros_v)
        live = bkeys != K.EMPTY_KEY
        if rnd == "read":
            mine = dict(read_mine=(bop == K.OP_GET) & live, del_mine=None)
        else:
            mine = dict(read_mine=None, del_mine=(bop == K.OP_DEL) & live)
        call = lambda st, qq, m: TS.shards_read(
            st, qq, m["read_mine"], max_scan_results=8, scans=False,
            del_mine=m["del_mine"])
        before = RMK.launches["slab_lookup"]
        got = call(store, q, mine)
        torch.cuda.synchronize()
        if RMK.launches["slab_lookup"] - before != 1:
            raise AssertionError(f"K4a {rnd} round: not one launch")
        to_cpu = lambda m: {k: None if v is None else v.cpu()
                            for k, v in m.items()}
        want = call(host, R.QueryBatch(*(x.cpu() for x in (
            q.opcode, q.key, q.end_key, q.value))), to_cpu(mine))
        for f in ("value", "found"):
            a, b = getattr(got, f).cpu(), getattr(want, f)
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"K4a {rnd} round: shards_read {f} on "
                                     "the card differs from the CPU's")
        # the round's one launch, flat, against the plain version
        probe = mine["read_mine"] if rnd == "read" else mine["del_mine"]
        fk = torch.where(probe, bkeys, K.EMPTY_KEY).reshape(-1).contiguous()
        fnode = torch.arange(n, device=dev).repeat_interleave(n * cap)
        k4 = lambda: RMK.slab_lookup(fk, fnode, slabs)
        k4p = lambda: REF.slab_lookup_ref(fk, fnode, slabs)
        for a, b in zip(k4(), k4p()):
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"K4a {rnd} round: kernel disagrees "
                                     "with its plain version")
        out[rnd] = {"live": int(probe.sum()), "found": int(got.found.sum()),
                    "ms": time_cuda(k4),
                    "plain_ms": time_cuda(k4p, reps=5, warmup=1)}
    return out


def phase_kernels(seed: int = 0, grid_study: bool = False) -> list[dict]:
    from repro_torch import prng
    from repro_torch.core import keys as TK
    from repro_torch.kernels.range_match import kernel as RMK
    from repro_torch.kernels.range_match import ops as OPS
    from repro_torch.kernels.range_match import ref as REF
    from repro_torch.serving.router import SequenceRouter
    from repro_torch.telemetry.profiler import HBM_BYTES_PER_S, route_bytes

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    directory = _full_width_tables(rng, dev)
    lo, hi, chains, clen = OPS.pack_tables(directory)
    S = lo.shape[0]
    keys = rng.integers(0, 2**32, B_FULL, dtype=np.uint64).astype(np.int64)
    ops = np.where(rng.random(B_FULL) < 0.9, 0, 1).astype(np.int32)
    mvals = torch.tensor(keys, device=dev)
    opcodes = torch.tensor(ops, device=dev)
    u = torch.tensor(rng.integers(0, 2**31 - 1, (2, B_FULL)).astype(np.int32),
                     device=dev)
    u1, u2 = u[0].contiguous(), u[1].contiguous()
    loads = OPS.to_i32_bits(torch.tensor(
        rng.integers(0, 2**32, N_FULL, dtype=np.uint64).astype(np.int64),
        device=dev))
    slabs = _slabs(rng, dev)
    target = torch.tensor(rng.integers(-1, N_FULL, B_FULL), device=dev)
    t_safe = target.clamp(0, N_FULL - 1)
    resident = slabs[t_safe, torch.tensor(rng.integers(0, C_FULL // 4, B_FULL),
                                          device=dev)]
    fresh = torch.tensor(rng.integers(0, 2**32 - 1, B_FULL, dtype=np.uint64)
                         .astype(np.int64), device=dev)
    qkeys = torch.where(torch.tensor(rng.random(B_FULL) < 0.7, device=dev),
                        resident, fresh).contiguous()

    K1 = lambda: RMK.range_match(mvals, opcodes, lo, hi, chains, clen,
                                 num_slots=directory.num_slots)
    K1p = lambda: REF.range_match_ref(mvals, opcodes, lo, hi, chains, clen,
                                      num_slots=directory.num_slots)
    K2 = lambda: RMK.range_match_spread(mvals, opcodes, u1, u2, lo, hi, chains,
                                        clen, loads, num_slots=directory.num_slots)
    K2p = lambda: REF.range_match_spread_ref(mvals, opcodes, u1, u2, lo, hi,
                                             chains, clen, loads,
                                             num_slots=directory.num_slots)
    K4 = lambda: RMK.slab_lookup(qkeys, target, slabs)
    K4p = lambda: REF.slab_lookup_ref(qkeys, target, slabs)
    # K3 and K4b: CRAQ reads over a dirty table at YCSB-A's write share
    # (about half the slots dirty); the filter's raw keys are the matching
    # values under range partitioning, and K4b probes them in the slabs
    dirty = OPS.pack_dirty(torch.tensor(rng.random((S, R_MAX)) < 0.5,
                                        device=dev))
    kf = torch.tensor(rng.random((S, F_FULL)) < 0.3, device=dev)
    resident_k = slabs[torch.tensor(rng.integers(0, N_FULL, B_FULL), device=dev),
                       torch.tensor(rng.integers(0, C_FULL // 4, B_FULL),
                                    device=dev)]
    ckeys = torch.where(torch.tensor(rng.random(B_FULL) < 0.7, device=dev),
                        resident_k, fresh).contiguous()
    ops_w = torch.tensor(np.where(rng.random(B_FULL) < 0.5, 0, 1)
                         .astype(np.int32), device=dev)
    K3 = lambda: RMK.range_match_spread_dirty(
        ckeys, ops_w, u1, u2, lo, hi, chains, clen, loads, dirty,
        num_slots=directory.num_slots)
    K3p = lambda: REF.range_match_spread_dirty_ref(
        ckeys, ops_w, u1, u2, lo, hi, chains, clen, loads, dirty,
        num_slots=directory.num_slots)
    K3f = lambda: RMK.range_match_spread_dirty(
        ckeys, ops_w, u1, u2, lo, hi, chains, clen, loads, dirty, ckeys, kf,
        num_slots=directory.num_slots)
    K3fp = lambda: REF.range_match_spread_dirty_ref(
        ckeys, ops_w, u1, u2, lo, hi, chains, clen, loads, dirty, ckeys, kf,
        num_slots=directory.num_slots)
    K4b = lambda: RMK.range_match_apply(
        ckeys, ops_w, u1, u2, lo, hi, chains, clen, loads, dirty, ckeys, slabs,
        num_slots=directory.num_slots)
    K4bp = lambda: REF.range_match_apply_ref(
        ckeys, ops_w, u1, u2, lo, hi, chains, clen, loads, dirty, ckeys, slabs,
        num_slots=directory.num_slots)
    # K5: each packet against its ingress switch's copy; reads, writes
    # and deletes, the raw keys matched under range partitioning
    coord = _perturbed_coord(directory, dev)
    packed = OPS.pack_coord_tables(coord)
    ops5 = torch.tensor(rng.choice([0, 1, 2], B_FULL).astype(np.int32),
                        device=dev)
    K5 = lambda: RMK.range_match_stale(mvals, ops5, *packed, num_slots=S)
    K5p = lambda: REF.range_match_stale_ref(mvals, ops5, *packed, num_slots=S)
    # the one-call yardstick for K4a: torch.searchsorted over the
    # node-offset concatenation of the slabs (built outside the timing)
    flat = REF.offset_rows(slabs)
    qoff = (qkeys + t_safe * (1 << 33)).contiguous()
    K4lib = lambda: torch.searchsorted(flat, qoff)
    # K1 at the serving router's shape: a decode step's request ids
    router = SequenceRouter.create(ROUTER_SHARDS, device=dev).directory
    r_lo, r_hi, r_chains, r_clen = OPS.pack_tables(router)
    r_mvals = TK.matching_value(torch.tensor(
        rng.integers(0, 10_000, ROUTER_B), device=dev), hash_partitioned=True)
    r_ops = torch.zeros(ROUTER_B, dtype=torch.int32, device=dev)
    K1r = lambda: RMK.range_match(r_mvals, r_ops, r_lo, r_hi, r_chains,
                                  r_clen, num_slots=router.num_slots)
    K1rp = lambda: REF.range_match_ref(r_mvals, r_ops, r_lo, r_hi, r_chains,
                                       r_clen, num_slots=router.num_slots)
    r_S, r_rmax = router.num_slots, router.r_max
    # phase dist's shapes: K2 / K3 a shard on its slice with its fold_in
    # draws, K4a on a round of every shard's inbound buckets
    Bl = B_FULL // N_FULL
    pkey = prng.PRNGKey(seed)
    draws = [OPS.p2c_draws(prng.fold_in(pkey, me), Bl, dev)
             for me in range(N_FULL)]
    sl = lambda x, me: x[me * Bl:(me + 1) * Bl].contiguous()
    K2d = lambda me: RMK.range_match_spread(
        sl(mvals, me), sl(opcodes, me), *draws[me], lo, hi, chains, clen,
        loads, num_slots=directory.num_slots)
    K2dp = lambda me: REF.range_match_spread_ref(
        sl(mvals, me), sl(opcodes, me), *draws[me], lo, hi, chains, clen,
        loads, num_slots=directory.num_slots)
    K3d = lambda me: RMK.range_match_spread_dirty(
        sl(ckeys, me), sl(ops_w, me), *draws[me], lo, hi, chains, clen,
        loads, dirty, num_slots=directory.num_slots)
    K3dp = lambda me: REF.range_match_spread_dirty_ref(
        sl(ckeys, me), sl(ops_w, me), *draws[me], lo, hi, chains, clen,
        loads, dirty, num_slots=directory.num_slots)
    dist_checks = {
        "range_match_spread": lambda: _dist_route_check(K2d, K2dp),
        "range_match_spread_dirty": lambda: _dist_route_check(K3d, K3dp),
        "slab_lookup": lambda: _dist_read_round_check(
            RMK, REF, slabs, qkeys, target, opcodes, seed),
    }

    # Bounds count the bytes the function needs (the port's
    # telemetry.profiler.route_bytes, which its roofline rows read too):
    # each input read once and each output written once, K4a and K4b the
    # slab words their bisect probes
    probes = math.ceil(math.log2(C_FULL + 1)) + 1
    full = dict(B=B_FULL, S=S, N=N_FULL, r_max=R_MAX)
    specs = [
        ("range_match", K1, K1p, None, route_bytes("range_match", **full),
         "kernel.py:782", "range_match_pallas", {}),
        ("range_match_spread", K2, K2p, None,
         route_bytes("range_match_spread", **full),
         "kernel.py:712", "range_match_spread_pallas", {}),
        ("range_match_spread_dirty", K3, K3p, None,
         route_bytes("range_match_spread_dirty", **full),
         "kernel.py:631", "range_match_spread_dirty_pallas",
         {"filter_bits": 0}),
        ("range_match_spread_dirty", K3f, K3fp, None,
         route_bytes("range_match_spread_dirty", filter_bits=F_FULL, **full),
         "kernel.py:631", "range_match_spread_dirty_pallas",
         {"filter_bits": F_FULL}),
        ("slab_lookup", K4, K4p, K4lib,
         route_bytes("slab_lookup", C=C_FULL, **full),
         "kernel.py:582", "slab_lookup_pallas",
         {"dependent_loads": probes, "C": C_FULL}),
        ("range_match_apply", K4b, K4bp, None,
         route_bytes("range_match_apply", C=C_FULL, **full),
         "kernel.py:481", "range_match_apply_pallas",
         {"dependent_loads": probes, "C": C_FULL}),
        ("range_match_stale", K5, K5p, None,
         route_bytes("range_match_stale", W=W_FULL, **full),
         "kernel.py:406", "range_match_stale_pallas", {"W": W_FULL}),
        ("range_match", K1r, K1rp, None,
         route_bytes("range_match", B=ROUTER_B, S=r_S, N=ROUTER_SHARDS,
                     r_max=r_rmax),
         "kernel.py:782", "range_match_pallas",
         {"case": "serving_router", "main": False,
          "shape": {"B": ROUTER_B, "S": r_S, "r_max": r_rmax,
                    "hash_partitioned": True}}),
    ]
    # a package from before the sorted span tables has no last_order (K1-
    # K4b) or last_stale_order (K5)
    sorted_table = hasattr(RMK, "last_order")
    stale_table = hasattr(RMK, "last_stale_order")
    rows = []
    for name, fn, plain, lib, nbytes, replaces, replaces_fn, extra in specs:
        before = RMK.launches[name]
        got = fn()
        want = plain()
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"{name} {extra}: kernel disagrees with "
                                     "its plain version")
        ms = time_cuda(fn)
        device_ms = time_device(fn)
        plain_ms = time_cuda(plain, reps=5, warmup=1)
        lib_ms = time_cuda(lib) if lib is not None else None
        lib_device_ms = time_device(lib) if lib is not None else None
        if name in ROUTE_KERNELS:
            # the split of the device time between the two kernels, and
            # the match pass an eager call takes, both after the timing
            extra = {**extra,
                     "device_ms_split": device_split(fn, ROUTE_PARTS)}
            if sorted_table:
                fn()
                extra["match"] = RMK.last_order(name)["match"]
                if extra["match"] != "search":
                    raise AssertionError(f"{name}: a controller's directory "
                                         f"took the {extra['match']} pass")
        if name == "range_match_stale":
            # the same for K5, with the pass of each switch copy
            extra = {**extra,
                     "device_ms_split": device_split(fn, STALE_PARTS)}
            if stale_table:
                fn()
                extra["match"] = [c["match"] for c in RMK.last_stale_order()]
                if extra["match"] != ["search"] * W_FULL:
                    raise AssertionError("range_match_stale: a controller "
                                         "copy took the exhaustive pass: "
                                         f"{extra['match']}")
        if name in dist_checks and not extra.get("filter_bits"):
            extra = {**extra, "dist_shape": dist_checks[name]()}
        RMK.launches[name] = before   # comparison launches do not count
        row = {"name": name, "route": "cuda",
               "source": "src/repro_torch/kernels/range_match/csrc/range_match.cu",
               "replaces": "src/repro/kernels/range_match/" + replaces,
               "replaces_fn": replaces_fn,
               "max_abs_err": 0, "parity": "bitwise", "ms": ms,
               "device_ms": device_ms, "plain_ms": plain_ms,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "bound_bytes": nbytes, "library_ms": lib_ms,
               "library_device_ms": lib_device_ms,
               "shape": {"B": B_FULL, "S": S, "N": N_FULL, "r_max": R_MAX},
               **extra}
        if name == "range_match_spread_dirty":
            row["bounced"] = int(got[4].sum())
        if name == "range_match_apply":
            row["found"] = int(got[6].sum())
        if name == "range_match_stale":
            row["divergent"] = int(got[2].sum())
        emit({"phase": "kernels", **row})
        rows.append(row)
    if grid_study:
        _route_grid_study(RMK, {"range_match": K1, "range_match_spread": K2,
                                "range_match_spread_dirty": K3,
                                "range_match_apply": K4b})
    return rows + _decode_attn_rows(seed) + _ssd_chunk_rows(seed)


# blocks an SM of the route grid study; "packets" is one thread a packet,
# at most 4 blocks an SM (the grid of K4a and K5)
GRID_POLICIES = ("packets", 1, 2, 3)


def _route_grid_study(RMK, calls: dict) -> dict:
    """Device time of each route kernel at the phase 2 shape under each
    grid of ``GRID_POLICIES``, in turns (the policies forward, then back),
    twice; the wrappers' own grid (``kernel._grid``, one thread a packet
    up to 4 blocks an SM) is restored after."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    own = RMK._grid

    def grid_of(policy):
        return own if policy == "packets" else lambda B, dev: policy * sms

    out = {"phase": "grid_study", "sms": sms, "B": B_FULL,
           "policies": [str(p) for p in GRID_POLICIES], "device_ms": {}}
    try:
        for name, fn in calls.items():
            times = {str(p): [] for p in GRID_POLICIES}
            for order in (GRID_POLICIES, GRID_POLICIES[::-1]) * 2:
                for policy in order:
                    RMK._grid = grid_of(policy)
                    times[str(policy)].append(time_device(fn))
            out["device_ms"][name] = times
    finally:
        RMK._grid = own
    emit(out)
    return out


# (case, B, S, Hq, Hkv, D, dtype, window, lengths: explicit, a range drawn
# from uniformly, or None for uniform in [1, S]) of K6: decode_32k (S
# 32,768) with its batch of 128 cut to 32 at qwen2-1.5b's heads in bf16,
# the sliding window at gemma3-1b's heads in f32, lengths past S (F8), and
# the serving phase's shape (32 slots of an 8,192-position cache, lengths
# of its 256-2,048-token prompts plus up to 128 new tokens)
K6_CASES = (
    ("decode_32k/qwen2-1.5b/bf16", 32, 32768, 12, 2, 128, torch.bfloat16,
     None, None),
    ("decode_32k/gemma3-1b/f32/window512", 32, 32768, 4, 1, 256,
     torch.float32, 512, None),
    ("length_past_S/qwen2-1.5b/f32", 4, 300, 12, 2, 128, torch.float32, None,
     (305, 400, 300, 1000)),
    ("serve_8k/qwen2-1.5b/bf16", 32, 8192, 12, 2, 128, torch.bfloat16, None,
     range(257, 2177)),
    # the shapes of phase families: G 1 D 128 (deepseek-moe-16b, 16 / 16
    # heads, its 4,096-position cache), G 5 (llama4, 40 / 8, 8,192), G 6
    # (internvl2-26b, 48 / 8, 4,096), and whisper-small's G 1 D 64 self
    # attention (448 positions, lengths 5-132) and cross attention (1,500
    # encoder rows, all valid)
    ("serve_4k/deepseek-moe-16b/bf16", 32, 4096, 16, 16, 128, torch.bfloat16,
     None, range(257, 2177)),
    ("serve_8k/llama4-maverick/bf16", 32, 8192, 40, 8, 128, torch.bfloat16,
     None, range(257, 2177)),
    ("serve_4k/internvl2-26b/bf16", 32, 4096, 48, 8, 128, torch.bfloat16,
     None, range(257, 2177)),
    ("self_448/whisper-small/bf16", 32, 448, 12, 12, 64, torch.bfloat16, None,
     range(5, 133)),
    ("cross_1500/whisper-small/bf16", 32, 1500, 12, 12, 64, torch.bfloat16,
     None, [1500] * 32),
)
# K6 against its plain version, |got - want| <= atol + rtol * |want| for
# every output: f32 at 1e-4; bf16 at two bf16 steps of each output (both
# sides accumulate in f32 and round once, so they may differ by one step).
# Outputs are softmax means over up to S rows, so a typical |want| at
# decode_32k is ~1e-2: an absolute bf16 limit of 3e-2 would pass zeros.
K6_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-5, 2.0 ** -6)}


def _k6_compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Elementwise check of K6's output against its plain version; the
    ratio is the worst |got - want| over its limit (<= 1 passes)."""
    atol, rtol = K6_TOL[want.dtype]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ratio = float((diff / (atol + rtol * w.abs())).max())
    return {"max_abs_err": float(diff.max()), "tolerance":
            f"|err| <= {atol:g} + {rtol:g} * |want|", "tol_ratio": ratio,
            "want_abs_median": float(w.abs().median()),
            "want_abs_max": float(w.abs().max()),
            "ok": got.dtype == want.dtype and got.shape == want.shape
            and ratio <= 1.0}


def _valid_rows(lengths: np.ndarray, S: int, window) -> int:
    """Cache rows the attention reads: p < min(length, S) and, with a
    window, p >= length - window (all S rows when none is valid)."""
    hi = np.minimum(lengths, S)
    lo = np.zeros_like(hi) if window is None else np.maximum(lengths - window, 0)
    n = hi - lo
    return int(np.where(n > 0, n, S).sum())


def _decode_attn_rows(seed: int) -> list[dict]:
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn import kernel as DAK
    from repro_torch.kernels.decode_attn import ref as DAR
    from repro_torch.telemetry.profiler import HBM_BYTES_PER_S

    dev = torch.device("cuda")
    gqa = tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)
    rows = []
    for i, (case, B, S, Hq, Hkv, D, dtype, window, lengths) in \
            enumerate(K6_CASES):
        rng = np.random.default_rng(seed + i)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + i)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
        if lengths is None:
            lengths = range(1, S + 1)
        L = (rng.integers(lengths.start, lengths.stop, B)
             if isinstance(lengths, range) else np.asarray(lengths)
             ).astype(np.int32)
        lengths_t = torch.tensor(L, device=dev)
        fn = lambda: DAK.decode_attn(q, k, v, lengths_t, window=window)
        plain = lambda: DAR.decode_attn_ref(q, k, v, lengths_t, window=window)
        before = DAK.launches["decode_attn"]
        got = fn()
        want = plain()
        torch.cuda.synchronize()
        cmp = _k6_compare(got, want)
        if got.dtype != dtype or not cmp.pop("ok"):
            raise AssertionError(f"decode_attn {case}: {cmp}")
        # the library yardstick: one SDPA call over the same cache with a
        # boolean length / window mask (heads-major copies made outside the
        # timing; before torch 2.5, which added enable_gqa, the kv heads
        # are repeated there too)
        kT = k.transpose(1, 2).contiguous()
        vT = v.transpose(1, 2).contiguous()
        if not gqa:
            kT = kT.repeat_interleave(Hq // Hkv, dim=1)
            vT = vT.repeat_interleave(Hq // Hkv, dim=1)
        pos = torch.arange(S, device=dev)[None]
        lc = lengths_t.long()[:, None]
        mask = pos < lc
        if window is not None:
            mask &= pos >= lc - window
        mask = mask[:, None, None, :]
        q4 = q[:, :, None, :]
        kw = {"enable_gqa": True} if gqa else {}
        lib = lambda: F.scaled_dot_product_attention(q4, kT, vT,
                                                     attn_mask=mask, **kw)
        lib_err = float((lib()[:, :, 0].float() - want.float()).abs().max())
        ms = time_cuda(fn)
        device_ms = time_device(fn)
        plain_ms = time_cuda(plain, reps=5, warmup=1)
        lib_ms = time_cuda(lib)
        lib_device_ms = time_device(lib)
        DAK.launches["decode_attn"] = before   # comparison launches do not count
        esz = torch.finfo(dtype).bits // 8
        rows_read = _valid_rows(L, S, window)
        # the valid K and V rows, q and the output once each, the lengths
        nbytes = rows_read * Hkv * D * 2 * esz + 2 * B * Hq * D * esz + 4 * B
        row = {"name": "decode_attn", "route": "cuda",
               "source": "src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu",
               "replaces": "src/repro/kernels/decode_attn/kernel.py:88",
               "replaces_fn": "decode_attn_pallas", "case": case,
               **cmp, "parity": cmp["tolerance"], "ms": ms,
               "device_ms": device_ms, "plain_ms": plain_ms,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "bound_bytes": nbytes,
               "library_ms": lib_ms, "library_device_ms": lib_device_ms,
               "library": "scaled_dot_product_attention, boolean mask"
                          + (", enable_gqa" if gqa else ", repeated kv heads"),
               "library_max_abs_err": lib_err,
               "shape": {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D},
               "dtype": str(dtype).replace("torch.", ""), "window": window,
               "valid_rows": rows_read, "main": i == 0}
        emit({"phase": "kernels", **row})
        rows.append(row)
        del q, k, v, kT, vT, got, want
        torch.cuda.empty_cache()
    return rows


# (case, B, T, H, P, N, G, Q, dt and A from the model's ranges) of K7:
# (a) mamba2-370m's heads over decode_32k's context of 32,768 tokens as
# one prefill, (b) hymba-1.5b's heads at B 4 over 2,100 tokens (padded to
# 2,176), (c) a chunk of 10 (not a power of two) with G 2, (d) mamba2-370m's
# heads at phase serving_ssm's mean prompt (74,852 / 64 = 1,170 tokens,
# padded to 1,280), the shape of one layer of one admission, (e) mamba2-
# 370m's heads at phase training's and phase dryrun's 8 x 2,048 (the train
# and prefill cells' scans: B 8 covers the prefill's B 1 row for row)
K7_CASES = (
    ("prefill_32k/mamba2-370m", 1, 32768, 32, 64, 128, 1, 128, True),
    ("hymba-1.5b/B4/T2100", 4, 2100, 50, 64, 16, 1, 128, True),
    ("Q10/G2", 2, 250, 8, 16, 16, 2, 10, False),
    ("serve_1170/mamba2-370m", 1, 1170, 32, 64, 128, 1, 128, True),
    ("train_2048/mamba2-370m", 8, 2048, 32, 64, 128, 1, 128, True),
)
# K7 against its plain version, on y and on the final state: tests/
# test_kernels.py's 2e-4, scaled by the output (both sides sum in f32 in
# other orders, over chunks whose terms reach |y| ~ 10 at mamba2's widths)
K7_TOL = 2e-4


def _k7_compare(got, want) -> dict:
    """The worst |got - want| / (K7_TOL (1 + |want|)) over y and the final
    state (<= 1 passes)."""
    out = {"tolerance": f"|err| <= {K7_TOL:g} (1 + |want|)"}
    ok = True
    for name, g, w in zip(("y", "state"), got, want):
        diff = (g - w).abs()
        out[f"{name}_max_abs_err"] = float(diff.max())
        out[f"{name}_tol_ratio"] = float((diff / (K7_TOL * (1 + w.abs()))).max())
        out[f"{name}_want_abs_max"] = float(w.abs().max())
        ok &= (g.dtype == w.dtype and g.shape == w.shape
               and bool(torch.isfinite(g).all()))
    out["max_abs_err"] = max(out["y_max_abs_err"], out["state_max_abs_err"])
    out["tol_ratio"] = max(out["y_tol_ratio"], out["state_tol_ratio"])
    out["ok"] = ok and out["tol_ratio"] <= 1.0
    return out


def _k7_work(B, T, H, P, N, G, Q) -> tuple[int, int]:
    """(multiply-adds, bytes) the chunked scan needs on T real rows: per
    chunk of r rows C.B^T's r (r + 1) / 2 causal products of N a group, a
    head's r (r + 1) / 2 P intra-chunk terms and 2 r P N for the state's
    read and update; x, dt, B, C, the initial state and A read once, y and
    the final state written once, f32."""
    macs = 0
    for c0 in range(0, T, Q):
        r = min(Q, T - c0)
        tri = r * (r + 1) // 2
        macs += G * tri * N + H * (tri * P + 2 * r * P * N)
    nbytes = 4 * (2 * T * H * P + T * H + 2 * T * G * N + 2 * H * P * N + H)
    return B * macs, B * nbytes


def _k7_bound(B, T, H, P, N, G, Q) -> dict:
    """K7's bound on T real rows: the larger of its multiply-adds over the
    float32 peak and its bytes over HBM's (``_k7_work``)."""
    from repro_torch.telemetry.profiler import HBM_BYTES_PER_S, PEAK_F32_FLOPS

    macs, nbytes = _k7_work(B, T, H, P, N, G, Q)
    flop_ms = 2 * macs / PEAK_F32_FLOPS * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "bound_flop": 2 * macs, "bound_bytes": nbytes,
            "bound_flop_ms": flop_ms, "bound_bytes_ms": byte_ms}


def _k7_inputs(seed, B, T, H, P, N, G, model_ranges, dev):
    """Inputs on the card: with the model's ranges, dt = softplus(z) (z
    unit normal, as dt_raw + dt_bias) and A = -linspace(1, 16, H) (its
    A_log init); else the reference test's dt in [0.001, 0.1], A in
    [-2, -0.5].  A nonzero initial state."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    if model_ranges:
        dt = torch.nn.functional.softplus(rn(B, T, H))
        A = -torch.linspace(1.0, 16.0, H, device=dev)
    else:
        dt = 0.001 + 0.099 * torch.rand((B, T, H), generator=gen, device=dev)
        A = -(0.5 + 1.5 * torch.rand((H,), generator=gen, device=dev))
    return (rn(B, T, H, P), dt, A, rn(B, T, G, N), rn(B, T, G, N),
            0.1 * rn(B, H, P, N))


def _ssd_chunk_rows(seed: int) -> list[dict]:
    # the plain version's products in full f32, as the kernel's
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return [_ssd_chunk_row(seed + i, i == 0, *case)
                for i, case in enumerate(K7_CASES)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _ssd_chunk_row(seed, main, case, B, T, H, P, N, G, Q,
                   model_ranges) -> dict:
    """One K7 case: held against the plain version on the same padded
    inputs, timed (CUDA events) beside it, and its bound."""
    from repro_torch.kernels.ssd_chunk import kernel as SSK
    from repro_torch.kernels.ssd_chunk import ops as SSO
    from repro_torch.kernels.ssd_chunk import ref as SSR

    dev = torch.device("cuda")
    x, dt, A, Bm, Cm, s0 = _k7_inputs(seed, B, T, H, P, N, G, model_ranges,
                                      dev)
    xp, dtp, Bp, Cp = (t.contiguous() for t in
                       SSO.pad_to_chunks(x, dt, Bm, Cm, Q))
    fn = lambda: SSK.ssd_chunk(xp, dtp, A, Bp, Cp, s0, chunk=Q)
    plain = lambda: SSR.ssd_chunked_ref(xp, dtp, A, Bp, Cp, s0, chunk=Q)
    before = SSK.launches["ssd_chunk"]
    got = fn()
    want = plain()
    torch.cuda.synchronize()
    cmp = _k7_compare(got, want)
    if not cmp.pop("ok"):
        raise AssertionError(f"ssd_chunk {case}: {cmp}")
    ms = time_cuda(fn, reps=10, warmup=2)
    device_ms = time_device(fn, calls=3, reps=3)
    plain_ms = time_cuda(plain, reps=3, warmup=1)
    SSK.launches["ssd_chunk"] = before   # comparison launches do not count
    row = {"name": "ssd_chunk", "route": "cuda",
           "source": "src/repro_torch/kernels/ssd_chunk/csrc/ssd_chunk.cu",
           "replaces": "src/repro/kernels/ssd_chunk/kernel.py:91",
           "replaces_fn": "ssd_chunk_pallas", "case": case,
           **cmp, "parity": cmp["tolerance"], "ms": ms,
           "device_ms": device_ms, "plain_ms": plain_ms,
           **_k7_bound(B, T, H, P, N, G, Q), "library_ms": None, "library_device_ms": None,
           "library": "none: no one call",
           "shape": {"B": B, "T": T, "T_padded": xp.shape[1], "H": H,
                     "P": P, "N": N, "G": G, "Q": Q},
           "main": main}
    emit({"phase": "kernels", **row})
    del x, dt, Bm, Cm, xp, dtp, Bp, Cp, got, want
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


OUT = Path(__file__).resolve().parent / "build" / "chip_smoke"  # gitignored
# the parity phase's metrics plane: tests/test_metrics_plane.py's ring and
# its forced p999 breach (bound 10, objective 0.9, windows 2 / 4)
PARITY_SLO = dict(name="p999_fleet", series="p999", bound=10.0,
                  objective=0.9, fast_window=2, slow_window=4)


def _parity_driver(policy: str, device: str, fused: bool = True,
                   scenario: str = "shifting_hotspot", skw=None, n_epochs=6,
                   period=2, coord=None, ovl=None, pcfg=None, scfg=None,
                   base=None, planes=None, dist=False, service=None, **ckw):
    """The parity phase's driver: the test configuration of
    ``tests/test_torch_epoch.py``, or ``scfg`` / ``base`` in place of its
    scenario / cluster knobs; ``ovl`` and ``pcfg`` are OverloadConfig and
    PolicyConfig knobs; ``planes`` TelemetryConfig knobs, which turn on
    the trace plane and the metrics plane (``PARITY_SLO``), their flight
    dumps under ``OUT``; ``dist`` the dist backend on an 8-shard mesh on
    ``device``; ``service`` a ServiceModel kind."""
    from repro_torch import cluster as TC
    from repro_torch import coordination_tier as CT
    from repro_torch import overload as OVL
    from repro_torch.core import ServiceModel
    from repro_torch.core.dist_store import make_mesh

    if service is not None:
        ckw["service_model"] = ServiceModel(kind=service)

    if skw is None:
        skw = (dict(theta=1.2, shift_every=2)
               if scenario == "shifting_hotspot" else {})
    scen = TC.make_scenario(
        scenario,
        TC.ScenarioConfig(**(scfg or dict(n_epochs=n_epochs, epoch_ops=256,
                                          n_records=512, value_dim=2,
                                          seed=3))), **skw)
    base = base or dict(num_nodes=8, num_ranges=32, replication=2, r_max=4,
                        n_clients=16, imbalance_threshold=1.1,
                        max_moves_per_round=6)
    if planes is not None:
        flight = (OUT / "parity"
                  / f"{scenario}_{policy}_{device}_{fused}_{int(dist)}")
        ckw.update(
            telemetry=TC.TelemetryConfig(**planes, flight_epochs=4,
                                         flight_dir=str(flight)),
            metrics=TC.MetricsConfig(window=32,
                                     slos=(TC.SLO(**PARITY_SLO),)))
    cfg = TC.ClusterConfig(**base, report_every=period,
                           coordination=(None if coord is None
                                         else CT.CoordConfig(**coord)),
                           overload=(None if ovl is None
                                     else OVL.OverloadConfig(**ovl)),
                           **ckw)
    drv = TC.EpochDriver(scen, TC.make_policy(
        policy, None if pcfg is None else TC.PolicyConfig(**pcfg)), cfg,
        fused=fused, device=device,
        **(dict(backend="dist", mesh=make_mesh(8, device)) if dist else {}))
    return drv, drv.run()


def _same_planes(a, b, snapshots: bool) -> None:
    """The two planes of two runs: every epoch's span table, counts, DES
    times and buckets, the breaches, the ring, the burn arrays over the
    whole run and the alert timeline; with ``snapshots`` (two fused runs)
    also the flight dumps, whose state snapshots are taken a segment."""
    from repro_torch.telemetry import slo as SLOM

    ta, tb = a.telemetry, b.telemetry
    if (ta is None) != (tb is None) or (a.metrics is None) != (b.metrics is None):
        raise AssertionError("one run has a plane the other lacks")
    if ta is not None:
        if len(ta.epochs) != len(tb.epochs):
            raise AssertionError("span records differ in number")
        for ra, rb in zip(ta.epochs, tb.epochs):
            for k in ("span_i", "span_f", "lat", "comps", "issue", "hops"):
                if not np.array_equal(ra[k], rb[k]):
                    raise AssertionError(f"epoch {ra['epoch']}: {k} differs")
            if ra["n_sampled"] != rb["n_sampled"]:
                raise AssertionError(f"epoch {ra['epoch']}: counts differ")
        if ta.breaches != tb.breaches:
            raise AssertionError("breaches differ")
        docs = lambda t: [{k: v for k, v in json.load(open(p)).items()
                           if k != "tag"} for p in t.flight.dumps]
        if snapshots and docs(ta) != docs(tb):
            raise AssertionError("flight dumps differ")
        if ta.verify_exact() != 0.0:
            raise AssertionError("span attribution is not exact")
    if a.metrics is not None:
        if not torch.equal(a.metrics.ring.cpu(), b.metrics.ring.cpu()):
            raise AssertionError("metrics rings differ")
        if int(a.metrics.pos) != int(b.metrics.pos):
            raise AssertionError("metrics ring positions differ")
        n = int(a.metrics.pos)
        burns = [SLOM.evaluate_segment(d.metrics, d.met_layout,
                                       d.met_cfg.slos, n) for d in (a, b)]
        for name, r in burns[0].items():
            for k, v in r.items():
                if not np.array_equal(v, burns[1][name][k]):
                    raise AssertionError(f"SLO {name}: {k} differs")
        if a.alert_timeline() != b.alert_timeline():
            raise AssertionError("alert timelines differ")


def _same_run(a, b, snapshots: bool = True) -> None:
    import dataclasses

    (da, ra), (db, rb) = a, b
    if [dataclasses.asdict(x) for x in ra] != [dataclasses.asdict(x) for x in rb]:
        raise AssertionError("EpochMetrics streams differ")
    for f in ("keys", "values", "overflow"):
        if not torch.equal(getattr(da.store, f).cpu(), getattr(db.store, f).cpu()):
            raise AssertionError(f"final store {f} differs")
    if not torch.equal(da.directory.chains.cpu(), db.directory.chains.cpu()):
        raise AssertionError("directory.chains differ")
    if not torch.equal(da.load_reg.cpu(), db.load_reg.cpu()):
        raise AssertionError("load registers differ")
    for f in ("version", "acked", "key_filter"):
        if not torch.equal(getattr(da.repl, f).cpu(), getattr(db.repl, f).cpu()):
            raise AssertionError(f"replication register {f} differs")
    if (da.coord is None) != (db.coord is None):
        raise AssertionError("one run has the coordination tier")
    if da.coord is not None:
        for f in dataclasses.fields(da.coord):
            if not torch.equal(getattr(da.coord, f.name).cpu(),
                               getattr(db.coord, f.name).cpu()):
                raise AssertionError(f"coordination state {f.name} differs")
        if da.coord_mgr.summary() != db.coord_mgr.summary():
            raise AssertionError("coordination manager summaries differ")
    if (da.ovl is None) != (db.ovl is None):
        raise AssertionError("one run has the overload plane")
    if da.ovl is not None:
        for f in dataclasses.fields(da.ovl):
            a, b = getattr(da.ovl, f.name), getattr(db.ovl, f.name)
            if a.dtype != b.dtype or not torch.equal(a.cpu(), b.cpu()):
                raise AssertionError(f"overload state {f.name} differs")
    if da.growth_events != db.growth_events:
        raise AssertionError("pool growth events differ")
    _same_planes(da, db, snapshots)


LAG1 = dict(n_switches=4, lag_per_hop=1)
SPLIT = dict(skw=dict(split_epoch=2, heal_epoch=7, switch=1), n_epochs=10,
             period=1)
# tests/test_overload.py's OverloadConfig, and its pool-growth run
# (keyspace_growth into an 8-slot pool of 128-entry slabs)
OCFG = dict(queue_cap=32, service_rate=24, inflation=3.0, max_level=3,
            queue_weight=2)
GROW = dict(scfg=dict(n_epochs=10, epoch_ops=512, n_records=2048,
                      read_ratio=0.3, value_dim=2),
            base=dict(num_nodes=4, num_ranges=8, n_slots=8, capacity=128),
            split_overflow=True)

# (label, policy, scenario, driver overrides) of the parity phase; the
# coordination runs are those of tests/test_torch_coordination_tier.py
PARITY_RUNS = (
    ("frozen", "frozen", "shifting_hotspot", {}),
    ("full_adaptive", "full_adaptive", "shifting_hotspot", {}),
    ("chain/frozen", "frozen", "ycsb_a", dict(replication_mode="chain")),
    ("craq/full_adaptive", "full_adaptive", "ycsb_a",
     dict(replication_mode="craq")),
    ("craq_f8/full_adaptive", "full_adaptive", "ycsb_a",
     dict(replication_mode="craq", craq_filter_bits=8)),
    ("coord/full_adaptive", "full_adaptive", "shifting_hotspot",
     dict(coord=LAG1)),
    ("coord/split_brain_quorum", "frozen", "split_brain",
     dict(SPLIT, coord=dict(LAG1, quorum=True))),
    ("coord/split_brain_no_quorum", "frozen", "split_brain",
     dict(SPLIT, coord=dict(LAG1, quorum=False))),
    ("coord/craq/full_adaptive", "full_adaptive", "ycsb_a",
     dict(replication_mode="craq", coord=LAG1)),
    ("overload/cascade_failure", "overload_adaptive", "cascade_failure",
     dict(ovl=OCFG, pcfg=dict(scale_patience=1), standby_nodes=(7,))),
    ("overload/retry_storm", "overload_adaptive", "retry_storm",
     dict(ovl=OCFG, pcfg=dict(scale_patience=1), standby_nodes=(7,))),
    ("overload/craq", "overload_adaptive", "ycsb_a",
     dict(ovl=OCFG, replication_mode="craq")),
    ("split_overflow", "full_adaptive", "keyspace_growth", GROW),
    # both observability planes: tests/test_telemetry.py's traced run;
    # craq under the lag-1 tier (bounce and redirect columns: six-hop
    # plans); the overload plane under pool growth, orbits linked
    ("planes/full_adaptive", "full_adaptive", "shifting_hotspot",
     dict(planes=dict(sample_rate=1 / 2, max_spans=64))),
    ("planes/coord/craq", "full_adaptive", "ycsb_a",
     dict(replication_mode="craq", coord=LAG1,
          planes=dict(sample_rate=1 / 2, max_spans=128))),
    ("planes/overload/split_overflow", "overload_adaptive", "keyspace_growth",
     dict(GROW, ovl=OCFG, planes=dict(sample_rate=1 / 2, max_spans=64,
                                      link_retries=12))),
    # the dist backend on an 8-shard mesh (tests/test_torch_dist_driver.py's
    # cases): p2c with the overload plane and both observability planes;
    # craq on YCSB-A; the lag-1 tier through a split brain; and a
    # lognormal service
    ("dist/overload/planes", "overload_adaptive", "shifting_hotspot",
     dict(dist=True, ovl=OCFG, planes=dict(sample_rate=1 / 4, max_spans=64))),
    ("dist/craq/full_adaptive", "full_adaptive", "ycsb_a",
     dict(dist=True, replication_mode="craq")),
    ("dist/coord/split_brain", "full_adaptive", "split_brain",
     dict(dist=True, coord=LAG1,
          skw=dict(theta=1.2, shift_every=2, split_epoch=2, heal_epoch=5,
                   switch=1))),
    ("dist/lognormal", "full_adaptive", "shifting_hotspot",
     dict(dist=True, service="lognormal")),
)


def phase_parity() -> dict:
    from repro_torch.coordination_tier import bench as CB
    from repro_torch.replication import bench as RB

    from repro_torch import overload as OVL
    from repro_torch.kernels.range_match import kernel as RMK
    from repro_torch.telemetry import SI

    out = {"phase": "parity"}
    for label, policy, scenario, ckw in PARITY_RUNS:
        RMK.reset_launches()
        cuda_f = _parity_driver(policy, "cuda", True, scenario, **ckw)
        launches = {k: n for k, n in RMK.launches.items() if n}
        cpu_f = _parity_driver(policy, "cpu", True, scenario, **ckw)
        _same_run(cuda_f, cpu_f)
        res = {"cuda_vs_cpu": "bitwise", "epochs": len(cuda_f[1]),
               "host_syncs_fused": cuda_f[0].host_syncs,
               "dirty_reads": sum(r.dirty_reads for r in cuda_f[1]),
               "launches": launches}
        if "ovl" in ckw:
            # the p2c kernel of the mode read a nonzero queue_pen: an
            # epoch ended with a queue, so the next one's penalty was not 0
            rows = cuda_f[1]
            k = ("range_match_spread_dirty"
                 if ckw.get("replication_mode") == "craq"
                 else "range_match_spread")
            pen_epochs = [r.epoch + 1 for r in rows[:-1] if r.queue_peak]
            # the dist plane routes shard by shard: 8 launches an epoch
            per_epoch = 8 if ckw.get("dist") else 1
            if launches.get(k, 0) != per_epoch * len(rows) or not pen_epochs:
                raise AssertionError(f"{label}: {k} launched "
                                     f"{launches.get(k, 0)}x in {len(rows)} "
                                     f"epochs, queue_pen epochs {pen_epochs}")
            gap = OVL.conservation_gap(cuda_f[0].ovl)
            summ = cuda_f[0].overload_summary()
            if gap or summ["injected"] != sum(r.ops for r in rows):
                raise AssertionError(f"{label}: conservation broke {summ}")
            res.update(queue_pen_epochs=pen_epochs,
                       deferred=sum(r.deferred for r in rows),
                       shed=sum(r.shed for r in rows),
                       lost=summ["lost"])
        if ckw.get("split_overflow"):
            grows = [e for r in cuda_f[1] for e in r.events
                     if e.startswith("grow_pool:")]
            drv = cuda_f[0]
            if not grows or drv.growth_events != len(grows) or (
                    cuda_f[1][-1].compiled_steps != 1 + drv.growth_events):
                raise AssertionError(f"{label}: growth events {grows}")
            res.update(grow_pool=grows,
                       slots=drv.controller.num_slots)
        if "planes" in ckw:
            tel = cuda_f[0].telemetry
            si = np.concatenate([r["span_i"] for r in tel.epochs])
            res.update(spans=tel.span_count,
                       spans_sampled=tel.summary()["spans_sampled"],
                       bounced_spans=int(si[:, SI["bounced"]].sum()),
                       alerts=len(cuda_f[0].alert_timeline()),
                       flight_dumps=len(tel.flight.dumps))
            if not tel.span_count or not res["alerts"]:
                raise AssertionError(f"{label}: no spans or no alert {res}")
            if "coord" in ckw and not res["bounced_spans"]:
                raise AssertionError(f"{label}: no bounced or redirected span")
        if ckw.get("dist"):
            drv = cuda_f[0]
            if drv.bucket_overflow_total or any(r.retries for r in cuda_f[1]):
                raise AssertionError(f"{label}: bucket overflow")
            if not launches.get("slab_lookup"):
                raise AssertionError(f"{label}: no read round through K4a")
        if ckw.get("replication_mode") != "chain":
            # fused == per-epoch on the card (eventual and craq)
            cuda_e = _parity_driver(policy, "cuda", False, scenario, **ckw)
            _same_run(cuda_e, cuda_f, snapshots=False)
            if not cuda_f[0].host_syncs < cuda_e[0].host_syncs:
                raise AssertionError(f"{label}: fused loop did not save host syncs")
            res.update(fused_vs_per_epoch="bitwise",
                       host_syncs_per_epoch=cuda_e[0].host_syncs)
        if ckw.get("replication_mode") == "craq" and not res["dirty_reads"]:
            raise AssertionError(f"{label}: no dirty-read bounces")
        if "coord" in ckw:
            rows = cuda_f[1]
            red = sum(r.redirected for r in rows)
            mis = sum(r.mis_served for r in rows)
            if not all(r.routed == r.direct + r.redirected == 256 for r in rows):
                raise AssertionError(f"{label}: conservation broke")
            quorum = ckw["coord"].get("quorum", True)
            if not ((red > 0 and mis == 0) if quorum else (mis > 0 and red == 0)):
                raise AssertionError(f"{label}: redirected {red}, mis-served {mis}")
            res.update(redirected=red, mis_served=mis)
        out[label] = res
    # the three-mode replication bench on the card, at the size of its
    # committed reference rows (BENCH_replication.json); at its quick size
    # gate 1 and the filter gate fail in the JAX reference too
    t0 = time.perf_counter()
    rows = RB.run_replication_matrix(False, verbose=False, device="cuda")
    frows = RB.run_filter_arm(False, verbose=False, device="cuda")
    problems = RB.check_replication(rows) + RB.check_filter_arm(frows)
    if problems:
        raise AssertionError(f"replication bench gates: {problems}")
    out["replication_bench"] = {
        "runs": len(rows) + len(frows), "seconds": time.perf_counter() - t0,
        "gates": "empty",
        "dirty_reads": {f"{r['scenario']}/{r['replication']}/{r['policy']}":
                        r["total_dirty_reads"] for r in rows
                        if r["replication"] == "craq"},
        "filter_dirty_reads": {r["filter_bits"]: r["total_dirty_reads"]
                               for r in frows},
    }
    # the coordination-tier bench at its full size (that of the committed
    # BENCH_coord_tier.json): staleness sweep, zero-lag parity, fault arms
    t0 = time.perf_counter()
    crows = (CB.run_sweep(False, verbose=False, device="cuda")
             + CB.run_parity(False, verbose=False, device="cuda")
             + CB.run_faults(False, verbose=False, device="cuda"))
    problems = CB.check_coordination(crows)
    if problems:
        raise AssertionError(f"coordination bench gates: {problems}")
    out["coordination_bench"] = {
        "runs": len(crows), "seconds": time.perf_counter() - t0,
        "gates": "empty",
        "rows": [{k: r.get(k) for k in (
            "bench", "scenario", "lag", "arm", "total_routed",
            "total_redirected", "total_mis_served", "redirect_share",
            "max_stale_switches", "mean_p999")} for r in crows],
    }
    out["serving"] = {arch: _serving_parity(arch) for arch in SERVING_PARITY}
    out["serving"][FACADE_PARITY] = _facade_parity(FACADE_PARITY)
    out["training"] = {arch: _train_parity(arch) for arch in TRAIN_PARITY}
    out["training"]["k7_autograd"] = _k7_autograd()
    emit(out)
    return out


SERVING_PARITY = ("qwen2-1.5b", "gemma3-1b", "mamba2-370m", "hymba-1.5b",
                  "deepseek-moe-16b", "minicpm3-4b", "internvl2-26b",
                  "llama4-maverick-400b-a17b")
FACADE_PARITY = "whisper-small"   # the engine feeds tokens only


def gqa_attentions(cfg) -> int:
    """K6 launches in one decode step of ``cfg``: one a GQA attention,
    that is a layer of the dense, moe and hybrid kinds and two a ``pair``
    (llama4's dense and MoE sublayers), none for ``mla`` (plain einsums
    against the latent) or ``ssm``; an encoder-decoder's decoder layer
    attends to itself and across, two each."""
    from repro_torch.models.transformer import layer_groups

    if cfg.family == "encdec":
        return 2 * cfg.n_layers
    per = {"dense": 1, "moe": 1, "hybrid": 1, "pair": 2, "mla": 0, "ssm": 0}
    return sum(per[g.kind] * g.n_layers for g in layer_groups(cfg))


@contextlib.contextmanager
def _tf32_off():
    """TF32 off for matmuls and cuDNN, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _to(tree: dict, device) -> dict:
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _serve_reduced(cfg, params, device) -> tuple:
    """The reduced engine on ``device``: 7 requests of 4-40 prompt tokens
    (past gemma3's 32 window) and 8 new tokens, 4 slots, a 64-position
    cache, 4 shards, a rebalance every 2 steps, the most-loaded shard
    failed at step 3.  Returns the trace (ops as tuples), the token
    streams, the picked logits rows and the K6 / K1 / K7 launches."""
    from repro_torch.kernels.decode_attn import kernel as DAK
    from repro_torch.kernels.range_match import kernel as RMK
    from repro_torch.kernels.ssd_chunk import kernel as SSK
    from repro_torch.launch.serve import serve_loop
    from repro_torch.serving.engine import ServingEngine

    eng = ServingEngine(cfg, _to(params, device), n_slots=4, cache_len=64,
                        n_shards=4, device=device)
    picked = []
    pick = eng._pick

    def record(logits):
        picked.append(logits[: cfg.vocab_size].copy())
        return pick(logits)

    eng._pick = record
    rng = np.random.default_rng(1)
    for _ in range(7):
        eng.submit(rng.integers(0, cfg.vocab_size, int(rng.integers(4, 41))),
                   max_new_tokens=8)
    DAK.reset_launches()
    RMK.reset_launches()
    SSK.reset_launches()
    trace = serve_loop(eng, rebalance_every=2, fail_shard_at=3)
    for rec in trace:
        if "rebalance" in rec:
            moved, ops = rec["rebalance"]
            rec["rebalance"] = (moved, [(o.lo, o.hi, o.src, o.dst, o.kind)
                                        for o in ops])
    tokens = {rid: r.out_tokens for rid, r in eng.finished.items()}
    return (trace, tokens, picked, DAK.launches["decode_attn"],
            RMK.launches["range_match"], SSK.launches["ssd_chunk"])


def _serving_parity(arch: str) -> dict:
    """The port's serving engine on the card against itself on the CPU, on
    one set of weights, with TF32 off."""
    from repro_torch import models as M
    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced()
    with _tf32_off():
        params = M.init_params(cfg, 0, device="cpu")
        card = _serve_reduced(cfg, params, torch.device("cuda"))
        host = _serve_reduced(cfg, params, torch.device("cpu"))
    (trace, tokens, picked, k6, k1, k7), (htrace, htokens, hpicked, *_) = \
        card, host
    if tokens != htokens or len(tokens) != 7:
        raise AssertionError(f"serving {arch}: token streams differ")
    if trace != htrace:
        raise AssertionError(f"serving {arch}: shards, migrations or "
                             "failovers differ")
    if len(picked) != len(hpicked):
        raise AssertionError(f"serving {arch}: pick counts differ")
    err = max(float(np.abs(a - b).max()) for a, b in zip(picked, hpicked))
    if not err <= 1e-4:
        raise AssertionError(f"serving {arch}: logits differ by {err}")
    # K6 on every GQA attention of every decode step, K7 on every SSM
    # layer of every prefill (7 admissions)
    ssm = cfg.family in ("ssm", "hybrid")
    if (k6 != gqa_attentions(cfg) * len(trace) or k1 <= 0
            or k7 != ssm * cfg.n_layers * 7):
        raise AssertionError(f"serving {arch}: K6 launched {k6}x in "
                             f"{len(trace)} steps, K1 {k1}x, K7 {k7}x")
    failed = [r["failed"] for r in trace if "failed" in r]
    return {"cuda_vs_cpu": "equal tokens, shards, migrations, failovers",
            "steps": len(trace), "picks": len(picked),
            "logits_max_abs_err": err, "launches": {"decode_attn": k6,
                                                    "range_match": k1,
                                                    "ssd_chunk": k7},
            "moved": sum(r["rebalance"][0] for r in trace
                         if "rebalance" in r),
            "failed_over": failed}


# phase 3's train steps: reduced qwen2, deepseek-moe (whose MoE aux loss
# carries a gradient), mamba2 and hymba (whose SSD scans run K7 forward
# and the plain scan's VJP backward), one AdamW step at lr 1e-3 (where one
# step's update stays within 1e-4 of another device's, see
# tests/test_torch_training.py)
TRAIN_PARITY = ("qwen2-1.5b", "deepseek-moe-16b", "mamba2-370m", "hymba-1.5b")


def _train_parity(arch: str) -> dict:
    """One train step of the reduced config (float32, remat, the copy task
    at the reference's test size) on the card against the CPU from the
    same state and batch, TF32 off: loss, every gradient and every
    updated leaf within 1e-4.  An SSM layer's scan launches K7 twice a
    pass (the forward and the remat recompute) and counts one backward
    through the plain scan's VJP (``ssd_chunk_plain_grad``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels.ssd_chunk import kernel as SSK
    from repro_torch.launch.train import device_batch
    from repro_torch.training import step as STEP
    from repro_torch.training import tree as T
    from repro_torch.training.optimizer import OptConfig

    cfg = get_config(arch).reduced()
    tcfg = STEP.TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=0,
                                          total_steps=10), remat=True)
    batch = make_batch(cfg, ShapeSpec("tiny", 64, 8, "train"), 0,
                       DataConfig("copy"))
    runs = {}
    before = dict(SSK.launches)
    with _tf32_off():
        state = STEP.init_train_state(cfg, tcfg, 0, device="cpu")
        for dev in ("cuda", "cpu"):
            st, b = _to(state, dev), device_batch(batch, dev)
            (loss, m), grads = STEP.value_and_grad(cfg, st["params"], b,
                                                   remat=True)
            new, m1 = STEP.make_train_step(cfg, tcfg)(st, b)
            runs[dev] = (float(loss), float(m["moe_aux_loss"]),
                         T.leaves(_to(grads, "cpu")),
                         T.leaves(_to(new, "cpu")), float(m1["loss"]))
    k7 = {k: SSK.launches[k] - before[k] for k in before}

    def err(a, b):
        return max(float((x.double() - y.double()).abs().max()) for x, y in
                   zip(a, b))

    (loss, aux, g, new, l1), (hloss, haux, hg, hnew, hl1) = (
        runs["cuda"], runs["cpu"])
    out = {"loss_err": abs(loss - hloss), "aux_err": abs(aux - haux),
           "grad_max_abs_err": err(g, hg), "updated_max_abs_err": err(new, hnew),
           "step_loss_err": abs(l1 - hl1), "loss": loss, "moe_aux_loss": aux,
           "k7_launches": k7["ssd_chunk"],
           "plain_vjp_backward": k7["ssd_chunk_plain_grad"]}
    if arch == "deepseek-moe-16b" and not aux > 0:
        raise AssertionError(f"training {arch}: no MoE aux loss")
    # each SSM layer's scan: K7 in the forward and in the remat recompute,
    # the plain scan's VJP in the backward
    ssm = cfg.family in ("ssm", "hybrid")
    back = k7["ssd_chunk_plain_grad"]
    if (back > 0) != ssm or k7["ssd_chunk"] != 2 * back:
        raise AssertionError(f"training {arch}: scans {k7}")
    if not max(v for k, v in out.items() if k.endswith("err")) <= 1e-4:
        raise AssertionError(f"training {arch}: card off the CPU {out}")
    return {"cuda_vs_cpu": "within 1e-4", **out}


def _k7_autograd() -> dict:
    """``ssd_scan`` with a gradient asked for on the card: K7's forward
    (one launch, y within ``K7_TOL`` (1 + |cpu|) of the CPU plain
    version's) and the plain scan's VJP backward (one count of
    ``ssd_chunk_plain_grad``; the gradients of A, x, dt, B and C within
    1e-4 (1 + |cpu|) of the CPU's); under no_grad the same call launches
    K7 once, held to its plain version within ``K7_TOL``, and counts no
    backward."""
    from repro_torch.kernels.ssd_chunk import kernel as SSK
    from repro_torch.kernels.ssd_chunk.ops import ssd_scan
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunked_ref

    gen = torch.Generator(device="cuda").manual_seed(3)
    B, T, H, P, N = 1, 32, 2, 8, 8
    x = torch.randn((B, T, H, P), device="cuda", generator=gen)
    dt = torch.rand((B, T, H), device="cuda", generator=gen) * 0.1
    A = -torch.rand((H,), device="cuda", generator=gen)
    Bm, Cm = (torch.randn((B, T, N), device="cuda", generator=gen)
              for _ in range(2))
    w = torch.randn((B, T, H, P), device="cuda", generator=gen)
    grads, counts, ys = {}, {}, {}
    before = dict(SSK.launches)
    for dev in ("cuda", "cpu"):
        a, xd, dtd, b, c = (t.detach().to(dev).requires_grad_(True)
                            for t in (A, x, dt, Bm, Cm))
        n0 = dict(SSK.launches)
        y, fs = ssd_scan(xd, dtd, a, b, c, chunk=16)
        ((y * w.to(dev)).sum() + fs.sum()).backward()
        counts[dev] = {k: SSK.launches[k] - n0[k] for k in n0}
        grads[dev] = [t.grad.cpu() for t in (a, xd, dtd, b, c)]
        ys[dev] = y.detach().cpu()
    errs = {name: float(((g - h).abs() / (1 + h.abs())).max())
            for name, g, h in zip(("A", "x", "dt", "Bm", "Cm"),
                                  grads["cuda"], grads["cpu"])}
    y_err = float(((ys["cuda"] - ys["cpu"]).abs()
                   / (1 + ys["cpu"].abs())).max())
    if counts["cuda"] != {"ssd_chunk": 1, "ssd_chunk_plain_grad": 1}:
        raise AssertionError(f"ssd_scan with a gradient: {counts['cuda']}")
    if not (max(errs.values()) <= 1e-4 and y_err <= K7_TOL):
        raise AssertionError(f"ssd_scan with a gradient, card vs CPU: y "
                             f"{y_err}, gradients {errs}")
    n0 = dict(SSK.launches)
    with torch.no_grad():
        y, _ = ssd_scan(x, dt, A, Bm, Cm, chunk=16)
        want, _ = ssd_chunked_ref(x, dt, A, Bm, Cm,
                                  torch.zeros((B, H, P, N), device="cuda"),
                                  chunk=16)
    served = {k: SSK.launches[k] - n0[k] for k in n0}
    SSK.launches.update(before)   # comparison launches do not count
    e = float((y - want).abs().max())
    if served != {"ssd_chunk": 1, "ssd_chunk_plain_grad": 0} or not bool(
            ((y - want).abs() <= K7_TOL * (1 + want.abs())).all()):
        raise AssertionError(f"K7 without a gradient: {served} launches, "
                             f"error {e}")
    return {"grad_y_scaled_err": y_err, "grad_scaled_err": errs,
            "grad_launches": counts["cuda"], "no_grad_launches": served,
            "no_grad_max_abs_err": e}


def _facade_greedy(cfg, params, batch: dict, cache_len: int, steps: int,
                   device) -> tuple:
    """Prefill ``batch`` and decode ``steps`` greedy tokens through the
    model facade on ``device``.  Returns the tokens (B, steps + 1), every
    step's logits (host float32) and the K6 launches of the decode
    steps."""
    from repro_torch import models as M
    from repro_torch.kernels.decode_attn import kernel as DAK

    params = _to(params, device)
    logits, cache = M.prefill(params, cfg, {k: v.to(device)
                                            for k, v in batch.items()},
                              cache_len=cache_len)
    rows = [logits[:, :cfg.vocab_size].float().cpu().numpy()]
    toks = [rows[-1].argmax(-1)]
    DAK.reset_launches()
    for _ in range(steps):
        logits, cache = M.decode_step(
            params, cfg, torch.tensor(toks[-1], device=device), cache)
        rows.append(logits[:, :cfg.vocab_size].float().cpu().numpy())
        toks.append(rows[-1].argmax(-1))
    return np.stack(toks, 1), rows, DAK.launches["decode_attn"]


def _facade_parity(arch: str) -> dict:
    """The encoder-decoder through the model facade on the card against
    the CPU, TF32 off: 4 utterances of the reduced config's frames, a
    4-token prompt, 8 greedy steps; equal tokens, logits within 1e-4, K6
    on both attentions of every decoder layer of every step."""
    from repro_torch import models as M
    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(2)
    batch = {"frames": torch.randn((4, cfg.encoder_len, cfg.d_model),
                                   generator=gen),
             "tokens": torch.randint(0, cfg.vocab_size, (4, 4), generator=gen)}
    steps = 8
    with _tf32_off():
        params = M.init_params(cfg, 0, device="cpu")
        toks, rows, k6 = _facade_greedy(cfg, params, batch, 32, steps,
                                        torch.device("cuda"))
        htoks, hrows, _ = _facade_greedy(cfg, params, batch, 32, steps,
                                         torch.device("cpu"))
    if not np.array_equal(toks, htoks):
        raise AssertionError(f"facade {arch}: token streams differ")
    err = max(float(np.abs(a - b).max()) for a, b in zip(rows, hrows))
    if not err <= 1e-4:
        raise AssertionError(f"facade {arch}: logits differ by {err}")
    if k6 != gqa_attentions(cfg) * steps:
        raise AssertionError(f"facade {arch}: K6 launched {k6}x in {steps} "
                             "steps")
    return {"cuda_vs_cpu": "equal tokens", "steps": steps,
            "logits_max_abs_err": err, "launches": {"decode_attn": k6}}


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def _expected_values(scen):
    """Every record's last acknowledged value: the preload, then each
    epoch's PUTs in batch order (last write wins)."""
    keys, vals = scen.load()
    expected = vals.copy()
    for e in range(scen.cfg.n_epochs):
        ops, ekeys, _, evals = scen.epoch(e)
        put = np.where(ops == 1)[0]
        # keep the last occurrence of each key
        rk = ekeys[put][::-1]
        _, first = np.unique(rk, return_index=True)
        last = put[::-1][first]
        expected[np.searchsorted(keys, ekeys[last])] = evals[last]
    return keys, expected


def _read_back(drv, keys: np.ndarray, expected: np.ndarray) -> dict:
    """GET every record from every live member of its chain."""
    from repro_torch.kernels.range_match import ops as OPS

    dev = drv.device
    d = drv.directory
    checked = missing = wrong = 0
    chunk = 1 << 17
    for s in range(0, keys.size, chunk):
        k = torch.tensor(keys[s:s + chunk].astype(np.int64), device=dev)
        want = torch.tensor(expected[s:s + chunk], device=dev)
        ridx, _, _ = OPS.range_match(d, k, torch.zeros_like(k, dtype=torch.int32))
        ridx = ridx.long()
        chain, clen = d.chains[ridx], d.chain_len[ridx]
        for p in range(d.r_max):
            member = chain[:, p]
            live = (p < clen) & (member >= 0)
            slot, found = OPS.slab_lookup(k, member, drv.store.keys)
            got = drv.store.values[member.clamp(min=0), slot.long()]
            same = (got.view(torch.int32) == want.view(torch.int32)).all(dim=1)
            checked += int(live.sum())
            missing += int((live & ~found).sum())
            wrong += int((live & found & ~same).sum())
    return {"replica_reads": checked, "missing": missing, "wrong_value": wrong}


# (label, scenario, its knobs, policy, replication, mode, kernels that must
# launch, CoordConfig knobs or None) of the full-width phase: the eventual
# main path of the first slice, then YCSB workload A (Zipf 0.99, 50 %
# updates) over chains of 3, the length CRAQ's paper evaluates, then the
# four-switch lag-1 quorum tier of the reference's coordination bench
# (its sweep and its split-brain fault arm)
COORD_FULL = dict(n_switches=4, lag_per_hop=1, quorum=True)
FULL_RUNS = (
    ("frozen", "shifting_hotspot", dict(theta=1.2, shift_every=2), "frozen",
     2, "eventual", ("range_match", "slab_lookup"), None),
    ("full_adaptive", "shifting_hotspot", dict(theta=1.2, shift_every=2),
     "full_adaptive", 2, "eventual", ("range_match_spread", "slab_lookup"),
     None),
    ("craq/full_adaptive", "ycsb_a", {}, "full_adaptive", 3, "craq",
     ("range_match_spread_dirty", "slab_lookup"), None),
    ("chain/frozen", "ycsb_a", {}, "frozen", 3, "chain",
     ("range_match", "slab_lookup"), None),
    ("coord/full_adaptive", "shifting_hotspot", dict(theta=1.2, shift_every=2),
     "full_adaptive", 2, "eventual",
     ("range_match_spread", "slab_lookup", "range_match_stale"), COORD_FULL),
    ("coord/split_brain", "split_brain",
     dict(theta=1.2, shift_every=2, split_epoch=2, heal_epoch=5, switch=1),
     "frozen", 2, "eventual",
     ("range_match", "slab_lookup", "range_match_stale"), COORD_FULL),
)


def _route_and_lookup_check(drv, scen) -> dict:
    """One more epoch of the scenario's traffic through ``route_and_lookup``
    (K4b) on the craq driver's live directory, store, load registers and
    dirty bits, held bitwise against K3 followed by K4a."""
    from repro_torch import prng
    from repro_torch import replication as RPL
    from repro_torch.core import routing as R
    from repro_torch.kernels.range_match import kernel as RMK
    from repro_torch.kernels.range_match import ops as OPS

    e = scen.cfg.n_epochs
    ops, keys, ends, vals = scen.epoch(e)
    q = R.make_queries(keys, ops, vals, ends, device=drv.device)
    dirty = RPL.dirty_bits(drv.repl)
    rng = prng.split(prng.fold_in(drv.key, e))[0]
    RMK.reset_launches()
    fused = R.route_and_lookup(drv.directory, q, drv.store.keys, drv.load_reg,
                               dirty, rng)
    torch.cuda.synchronize()
    launches = dict(RMK.launches)
    if launches["range_match_apply"] <= 0:
        raise AssertionError("route_and_lookup: range_match_apply never launched")
    dec, _, load2, picked, bounced = R.route_load_aware_dirty(
        drv.directory, q, drv.load_reg, dirty, rng)
    slot, found = OPS.slab_lookup(q.key, dec.target, drv.store.keys)
    for f in ("ridx", "target", "chain", "chain_len", "clength"):
        if not torch.equal(getattr(fused[0], f), getattr(dec, f)):
            raise AssertionError(f"route_and_lookup: decision.{f} differs")
    for a, b, name in zip(fused[2:], (load2, picked, bounced, slot, found),
                          ("load_reg", "picked", "bounced", "slot", "found")):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"route_and_lookup: {name} differs")
    reads = int((q.opcode == 0).sum())
    return {"ops": int(q.batch), "bitwise": True, "launches": launches,
            "bounced": int(bounced.sum()), "found": int(found.sum()),
            "reads": reads}


def _full_run(label, sname, skw, policy, rep, mode, need, coord,
              dist: bool = False) -> tuple:
    """One full-width run of the epoch driver (the oracle backend, or the
    dist backend on an 8-shard mesh with buckets of epoch_ops / N), its
    gates checked: ``(res, drv, rows, scen)``."""
    from repro_torch import cluster as TC
    from repro_torch import coordination_tier as CT
    from repro_torch.core.dist_store import DistConfig, make_mesh
    from repro_torch.kernels.range_match import kernel as RMK

    read_ratio = {"read_ratio": 0.9} if sname != "ycsb_a" else {}
    scfg = TC.ScenarioConfig(n_records=RECORDS_FULL, value_dim=256,
                             epoch_ops=B_FULL, n_epochs=6, seed=0,
                             **read_ratio)
    cfg = TC.ClusterConfig(num_nodes=N_FULL, num_ranges=RANGES_FULL,
                           replication=rep, r_max=R_MAX, n_clients=64,
                           replication_mode=mode,
                           coordination=(None if coord is None
                                         else CT.CoordConfig(**coord)))
    scen = TC.make_scenario(sname, scfg, **skw)
    dkw = (dict(backend="dist", mesh=make_mesh(N_FULL, "cuda"),
                dist_cfg=DistConfig(bucket_cap=BUCKET_CAP_FULL))
           if dist else {})
    torch.cuda.reset_peak_memory_stats()
    RMK.reset_launches()                       # counts of the main path
    t0 = time.perf_counter()
    drv = TC.EpochDriver(scen, TC.make_policy(policy), cfg, fused=True,
                         device="cuda", **dkw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rows = drv.run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(RMK.launches)
    for name in need:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: kernel {name} never launched")
    drops = sum(r.drops for r in rows)
    if drops:
        raise AssertionError(f"{label}: {drops} capacity drops")
    dirty_reads = sum(r.dirty_reads for r in rows)
    if mode == "craq" and dirty_reads <= 0:
        raise AssertionError(f"{label}: no dirty-read bounces")
    for r in rows:
        for f in ("p50", "p99", "p999", "throughput", "imbalance",
                  "read_p99", "clean_read_p99"):
            if not math.isfinite(getattr(r, f)) or getattr(r, f) < 0:
                raise AssertionError(f"{label}: bad {f} at epoch {r.epoch}")
    ss = drv.stage_seconds
    res = {
        "scenario": sname, "policy": policy, "replication": rep,
        "mode": mode,
        "setup_s": t1 - t0,
        "run_s": t2 - t1,
        "epochs_per_s": len(rows) / (t2 - t1),
        "host_inject_s": ss.get("inject", 0.0),
        "host_route_apply_enqueue_s": ss.get("route_apply", 0.0),
        "host_des_s": ss.get("des", 0.0),
        "host_control_s": ss.get("control", 0.0),
        "device_step_s": drv.device_step_seconds,
        "device_step_share": drv.device_step_seconds / (t2 - t1),
        "host_syncs": drv.host_syncs,
        "launches": launches,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
        "p50": [r.p50 for r in rows], "p99": [r.p99 for r in rows],
        "p999": [r.p999 for r in rows],
        "read_p99": [r.read_p99 for r in rows],
        "clean_read_p99": [r.clean_read_p99 for r in rows],
        "dirty_reads": [r.dirty_reads for r in rows],
        "imbalance": [r.imbalance for r in rows],
        "migration_entries": sum(r.migration_entries for r in rows),
        "drops": drops,
    }
    if dist:
        # buckets of epoch_ops / N: a source slice never overflows one, so
        # every acknowledged write reaches every chain member
        ovf = drv.bucket_overflow_total
        if ovf or any(r.retries for r in rows):
            raise AssertionError(f"{label}: bucket overflow {ovf}")
        res.update(bucket_cap=BUCKET_CAP_FULL, bucket_overflow=ovf,
                   bucket_overflow_by_epoch=[r.retries for r in rows],
                   a2a_rounds=drv.exchange_rounds)
    if coord is not None:
        # once an epoch, redirects and never a wrong owner, conserved
        if launches["range_match_stale"] != len(rows):
            raise AssertionError(f"{label}: range_match_stale launched "
                                 f"{launches['range_match_stale']}x in "
                                 f"{len(rows)} epochs")
        if not all(r.routed == r.direct + r.redirected == B_FULL
                   for r in rows):
            raise AssertionError(f"{label}: conservation broke")
        red = [r.redirected for r in rows]
        mis = [r.mis_served for r in rows]
        if sum(red) <= 0 or any(mis):
            raise AssertionError(f"{label}: redirected {red}, "
                                 f"mis-served {mis}")
        res.update(redirected=red, mis_served=mis,
                   stale_switches=[r.stale_switches for r in rows],
                   host_coord_control_s=ss.get("coord_control", 0.0),
                   coord_summary=drv.coord_mgr.summary(),
                   converged=drv.coord_mgr.converged(drv.coord))
    return res, drv, rows, scen


# the expected values of the runs phase dist repeats, kept from phase 4
# (the same scenario and seed: the same data) so the host generates each
# run's workload once more, not twice
_EXPECTED: dict = {}


def _read_back_gate(label, drv, scen, rep) -> dict:
    keys, expected = (_EXPECTED.pop(label) if label in _EXPECTED
                      else _expected_values(scen))
    if drv.backend != "dist" and label in DIST_LABELS:
        _EXPECTED[label] = (keys, expected)
    rb = _read_back(drv, keys, expected)
    if rb["missing"] or rb["wrong_value"] or rb["replica_reads"] < rep * keys.size:
        raise AssertionError(f"{label}: read-back failed {rb}")
    return rb


# phase 4's oracle frozen run (metric stream, and final store copied to
# host memory, out of the later runs' device peaks), which the dist
# phase's frozen run must equal bit for bit
FROZEN_REF: dict = {}


def _keep_frozen(drv, rows) -> None:
    import dataclasses

    FROZEN_REF.update(rows=[dataclasses.asdict(r) for r in rows],
                      keys=drv.store.keys.cpu(), values=drv.store.values.cpu(),
                      overflow=drv.store.overflow.cpu())


def phase_full_width(keep_frozen: bool = False) -> dict:
    """``keep_frozen``: keep the frozen run's stream and store for the dist
    phase."""
    from repro_torch.kernels.range_match import kernel as RMK

    _free_card()          # no earlier phase's garbage in the peaks
    out = {"phase": "full_width"}
    main_launches = {k: 0 for k in RMK.launches}
    for spec in FULL_RUNS:
        label, sname, skw, policy, rep, mode, need, coord = spec
        res, drv, rows, scen = _full_run(*spec)
        for name, n in res["launches"].items():
            main_launches[name] += n
        if mode == "craq":
            rl = _route_and_lookup_check(drv, scen)
            main_launches["range_match_apply"] += rl["launches"]["range_match_apply"]
            res["route_and_lookup"] = rl
        res.update(_read_back_gate(label, drv, scen, rep))
        if label == "frozen" and keep_frozen:
            _keep_frozen(drv, rows)
        # host stage times are taken without a synchronise (host_des_s
        # includes waiting for the period's device work); the device's
        # share is the steps' CUDA-event time
        out[label] = res
        del drv
        _free_card()
    out["launches"] = main_launches
    emit(out)
    return out


def _free_card() -> None:
    """Release a finished driver's tensors now: a driver can sit in a
    reference cycle (its period program holds its bound methods), which
    only the cycle collector frees, and the next run's peak memory must
    not count it."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase dist
# ---------------------------------------------------------------------------

# the dist backend at phase 4's full width: 8 shards on the card, buckets
# of epoch_ops / N; (a) frozen, which must equal phase 4's oracle frozen
# run bit for bit, (b) full_adaptive (K2 a shard), (c) craq on YCSB-A (K3
# a shard), (d) the four-switch lag-1 tier through a split brain (K5)
DIST_LABELS = ("frozen", "full_adaptive", "craq/full_adaptive",
               "coord/split_brain")


def phase_dist() -> dict:
    import dataclasses

    from repro_torch.kernels.range_match import kernel as RMK

    _free_card()          # no earlier phase's garbage in the peaks
    out = {"phase": "dist", "shards": N_FULL, "bucket_cap": BUCKET_CAP_FULL}
    if not FROZEN_REF:
        # phase 4 did not run: its oracle frozen run, for (a)
        spec = next(s for s in FULL_RUNS if s[0] == "frozen")
        _, drv, rows, _ = _full_run(*spec)
        _keep_frozen(drv, rows)
        del drv
        _free_card()
    main_launches = {k: 0 for k in RMK.launches}
    for spec in (s for s in FULL_RUNS if s[0] in DIST_LABELS):
        label, sname, skw, policy, rep, mode, need, coord = spec
        res, drv, rows, scen = _full_run(*spec, dist=True)
        for name, n in res["launches"].items():
            main_launches[name] += n
        if policy != "frozen" and res["launches"][need[0]] != N_FULL * len(rows):
            raise AssertionError(f"{label}: {need[0]} launched "
                                 f"{res['launches'][need[0]]}x, not once a "
                                 "shard and epoch")
        if label == "frozen":
            if [dataclasses.asdict(r) for r in rows] != FROZEN_REF["rows"]:
                raise AssertionError("dist frozen: the metric stream differs "
                                     "from phase 4's oracle run")
            for f in ("keys", "values", "overflow"):
                if not torch.equal(getattr(drv.store, f).cpu(), FROZEN_REF[f]):
                    raise AssertionError(f"dist frozen: final store {f} "
                                         "differs from phase 4's oracle run")
            res["equals_oracle_frozen"] = "bitwise"
            FROZEN_REF.clear()
        res.update(_read_back_gate(label, drv, scen, rep))
        out[label] = res
        del drv
        _free_card()
    out["launches"] = main_launches
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase paper
# ---------------------------------------------------------------------------

# the paper's evaluation on the card (repro_torch.benchmarks): the suite at
# the committed 8,192 ops a workload, held bit for bit to the same run on
# the CPU and to the reference's rows (tests/data/paper_rows_reference.json,
# made by tests/paper_reference.py: no JAX here); fig 13a and the DES
# engine's three-mode sweep at 1,000,000 ops; the balance gate matrix at
# its default size, and its --quick pair against the CPU and the fixture
PAPER_OPS, PAPER_BIG = 8192, 1_000_000
PAPER_FIXTURE = (Path(__file__).resolve().parent / "tests" / "data"
                 / "paper_rows_reference.json")
PAPER_JSON = Path(__file__).resolve().parent / "BENCH_torch_coordination.json"
BALANCE_JSON = Path(__file__).resolve().parent / "BENCH_torch_balance.json"
# the balance rows' run-to-run clock, and the reference's own count of its
# device-to-host round trips (28 in its quick run, 16 in the port's), which
# the fixture's rows are not compared on
BALANCE_WALL = ("wall_s",)
BALANCE_NOT_REFERENCE = ("host_syncs",)


def _json_form(x):
    """``x`` as JSON reads it back (tuples as lists, dataclasses as dicts)."""
    import dataclasses

    return json.loads(json.dumps(
        x, default=lambda o: dataclasses.asdict(o)))


def _paper_ratios(rows: list) -> dict:
    """In-switch over server-driven, from the CLI's rows: throughput over
    fig 13a and 13b/c (their ``us_per_call`` is ticks an op), mean latency
    of reads, writes and scans over tables 1-2."""
    us = {name: v for name, v, _ in rows}
    tput = [us[n[:-len("in_switch")] + "server_driven"] / us[n]
            for n in us if n.startswith("fig13") and n.endswith("/in_switch")]
    lat = [us[n] / us[n.replace("/in_switch/", "/server_driven/")]
           for n in us if n.startswith("table12/") and "/in_switch/" in n]
    return {"throughput_in_switch_over_server": [min(tput), max(tput)],
            "latency_in_switch_over_server": [min(lat), max(lat)]}


def _paper_raw(PT, n_ops: int, device) -> dict:
    return _json_form({
        "fig13a": PT.fig13a_throughput_vs_skew(n_ops, device=device),
        "fig13bc": PT.fig13bc_throughput_vs_write_ratio(n_ops, device=device),
        "tables12": PT.tables12_latency(n_ops, device=device),
        "load_balance": PT.load_balance_effect(n_ops, device=device),
        "hierarchy": PT.hierarchy_stats(n_ops, device=device),
    })


def _paper_cpu(fixture: dict) -> dict:
    """The suite at 8,192 ops on the CPU path: its rows and raw outputs
    equal the fixture's, bit for bit (the card's rows are the CLI's, held
    to these in :func:`phase_paper`)."""
    from repro_torch.benchmarks import paper_tables as PT
    from repro_torch.benchmarks import run as RUN

    want = fixture["paper"][str(PAPER_OPS)]
    t0 = time.perf_counter()
    rows = _json_form(RUN.simulated_rows(PAPER_OPS, device="cpu"))
    raw = _paper_raw(PT, PAPER_OPS, "cpu")
    seconds = time.perf_counter() - t0
    if rows != want["rows"] or raw != want["raw"]:
        raise AssertionError("paper suite: the CPU path's rows differ from "
                             "the reference's")
    return {"rows": rows, "seconds": seconds}


def _host_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def _fig13a_full_scale() -> dict:
    """Fig 13a at 1,000,000 ops a workload: 5 workloads routed through K1
    on the card, 15 lanes of ``plan_hops`` there, stacked on the host and
    simulated in one fused DES call (lane by lane, said in ``reduced``, if
    the host could not hold the stacked plan four times over: the stack,
    its compaction and the engine's copies)."""
    from repro_torch import core as C
    from repro_torch.benchmarks import paper_tables as PT
    from repro_torch.data.ycsb import run_phase
    from repro_torch.kernels.range_match import kernel as RMK

    workloads = PT.fig13a_workloads(PAPER_BIG)
    t0 = time.perf_counter()
    for _, wcfg in workloads:
        run_phase(wcfg)
    gen_s = time.perf_counter() - t0
    k1 = RMK.launches["range_match"]
    t0 = time.perf_counter()
    scenarios, plans = PT.build_scenarios(workloads, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    k1 = RMK.launches["range_match"] - k1
    H = max(p.nodes.shape[1] for p in plans)
    plan_bytes = len(plans) * PAPER_BIG * (H * 8 + 4)   # int32 + f32, reply
    avail = _host_available_bytes()
    fused = 4 * plan_bytes < avail
    t0 = time.perf_counter()
    if fused:
        stacked = C.stack_plans(plans)
        del plans
        stack_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, mk = C.simulate_closed_loop(stacked, n_clients=PT.N_CLIENTS,
                                       num_nodes=PT.N_NODES)
        mks = [float(x) for x in mk.numpy()]
        del stacked
    else:
        stack_s, mks = 0.0, []
        for p in plans:
            _, mk = C.simulate_closed_loop(p, n_clients=PT.N_CLIENTS,
                                           num_nodes=PT.N_NODES)
            mks.append(float(mk))
    des_s = time.perf_counter() - t0
    thr = {}
    for (label, mode, _, wcfg), m in zip(scenarios, mks):
        thr.setdefault(label, {})[mode] = wcfg.n_ops / max(m, 1e-9)
    ratios = {label: v["in_switch"] / v["server_driven"]
              for label, v in thr.items()}
    if len(mks) != 15 or not all(math.isfinite(m) and m > 0 for m in mks):
        raise AssertionError(f"fig13a at 1M ops: makespans {mks}")
    if k1 != len(workloads):
        raise AssertionError(f"fig13a at 1M ops: K1 launched {k1}x")
    out = {} if fused else {"reduced": {
        "des": "lane by lane: the host holds less than four stacked plans"}}
    return {**out, "n_ops": PAPER_BIG, "workloads": len(workloads),
            "lanes": len(mks), "hops": H, "plan_host_bytes": plan_bytes,
            "host_available_bytes": avail,
            "des": "one fused call" if fused else "lane by lane",
            "seconds": {"generate_host": gen_s,
                        "route_and_plan_card": build_s - gen_s,
                        "stack_host": stack_s, "des_host": des_s},
            "k1_launches": k1, "makespans": mks,
            "throughput": thr, "in_switch_over_server": ratios}


def _balance_matrix(fixture: dict) -> dict:
    """The gate matrix at the bench's default size on the card (7
    scenarios x 5 policies, 10 epochs of 1,024 ops, 128 ranges):
    ``check_acceptance`` must come back empty; then the --quick pair of
    the fixture on the card and the CPU."""
    from repro_torch.benchmarks import balance_bench as BB
    from repro_torch.benchmarks.run import card_meta

    t0 = time.perf_counter()
    rows = BB.run_matrix(BB.DEFAULT_SCENARIOS, BB.DEFAULT_POLICIES, False,
                         verbose=False, device="cuda")
    matrix_s = time.perf_counter() - t0
    # the CLI's layout; no steady_eps column (a second drive of each run,
    # left out for the script's time limit)
    BALANCE_JSON.write_text(json.dumps(
        {"quick": False, "service": "fixed",
         "meta": card_meta(torch.device("cuda")), "rows": rows}, indent=1))
    problems = BB.check_acceptance(rows)
    if problems or len(rows) != 35:
        raise AssertionError(f"balance gates: {problems}")
    want = fixture["balance_quick"]
    quick = {}
    for dev in ("cuda", "cpu"):
        got = BB.run_matrix([want["scenario"]], want["policies"], True,
                            verbose=False, device=dev)
        quick[dev] = [{k: v for k, v in r.items() if k not in BALANCE_WALL}
                      for r in _json_form(got)]
    if quick["cuda"] != quick["cpu"]:
        raise AssertionError("balance --quick: the card's rows differ from "
                             "the CPU's")
    skip = set(BALANCE_NOT_REFERENCE)
    for got, ref in zip(quick["cuda"], want["rows"]):
        bad = [k for k in ref if k not in skip and got.get(k) != ref[k]]
        if bad or got.keys() != ref.keys():
            raise AssertionError(f"balance --quick {ref['policy']}: columns "
                                 f"{bad} differ from the reference's")
    by = {(r["scenario"], r["policy"]): r for r in rows}
    return {"runs": len(rows), "seconds": matrix_s, "gates": "empty",
            "quick_card_eq_cpu": "equal but wall_s",
            "quick_eq_fixture": "equal but wall_s, host_syncs",
            "wall_s": [min(r["wall_s"] for r in rows),
                       max(r["wall_s"] for r in rows)],
            "shifting_hotspot": {p: {k: by[("shifting_hotspot", p)][k]
                                     for k in ("mean_imbalance", "mean_p99",
                                               "wall_s")}
                                 for p in ("frozen", "full_adaptive")},
            "multi_hotspot": {p: {k: by[("multi_hotspot", p)][k]
                                  for k in ("mean_imbalance",
                                            "total_migration_entries")}
                              for p in ("migrate", "split_hot")}}


def phase_paper() -> dict:
    """The paper's evaluation on the card: the CLI's full run (the suite
    at 8,192 ops, the DES engine bench with its oracle comparisons and its
    1,000,000-op three-mode sweep), written to
    ``BENCH_torch_coordination.json``, its simulated rows equal to the CPU
    path's and the reference's bit for bit; fig 13a at 1,000,000 ops; the
    balance gate matrix, written to ``BENCH_torch_balance.json``.  K1 (and
    the matrix's K2 / K4a) launches are this path's counts."""
    from repro_torch.benchmarks import run as RUN
    from repro_torch.kernels.range_match import kernel as RMK

    _free_card()
    fixture = json.loads(PAPER_FIXTURE.read_text())
    cpu = _paper_cpu(fixture)
    RMK.reset_launches()                       # counts of the main path
    t0 = time.perf_counter()
    if RUN.main(["--json", str(PAPER_JSON)]) != 0:
        raise AssertionError("repro_torch.benchmarks.run failed")
    cli_s = time.perf_counter() - t0
    bench = json.loads(PAPER_JSON.read_text())
    rows = {r["name"]: r for r in bench["rows"]}
    sim = [[r["name"], r["us_per_call"], r["derived"]] for r in bench["rows"]
           if not r["name"].startswith("des/")]
    if sim != cpu["rows"]:
        raise AssertionError("paper suite: the card's rows differ from the "
                             "CPU path's and the reference's")
    des = {k: v["derived"] for k, v in rows.items() if k.startswith("des/")}
    if len(des) != 4 or not all("bitexact=True" in des[k] for k in (
            f"des/closed_loop/B{PAPER_OPS}", f"des/open_loop/B{PAPER_OPS}")):
        raise AssertionError(f"engine bench: {des}")
    out = {"phase": "paper",
           "suite": {"n_ops": PAPER_OPS, "rows": len(sim),
                     "card_eq_cpu_eq_fixture": "bitwise",
                     "fixture_made_at": fixture["paper"][str(PAPER_OPS)][
                         "made_at"],
                     "cpu_seconds": cpu["seconds"], **_paper_ratios(sim)},
           "cli": {"seconds": cli_s, "rows": len(bench["rows"]),
                   "suite_wall_clock_s": bench["meta"]["suite_wall_clock_s"],
                   "engine_wall_clock": bench["engine_wall_clock"],
                   "des_rows": des, "meta": bench["meta"]},
           "fig13a_1m": _fig13a_full_scale()}
    out["balance"] = _balance_matrix(fixture)
    out["launches"] = dict(RMK.launches)
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase benches
# ---------------------------------------------------------------------------

# the repo's other benches and its six demos on the card, held to the
# reference's rows at their default sizes (tests/data/bench_rows_reference.json,
# made by tests/bench_reference.py: no JAX here); every column but the
# clock's and the host syncs' (repro_torch.benchmarks.compare)
BENCH_FIXTURE = (Path(__file__).resolve().parent / "tests" / "data"
                 / "bench_rows_reference.json")
TRAIN_LM_STEPS = 20


def _rows_equal(label: str, rows: list, want: list) -> None:
    from repro_torch.benchmarks import compare

    got = compare.comparable(rows)
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} rows, the reference "
                             f"{len(want)}")
    for g, w in zip(got, want):
        bad = sorted(k for k in g.keys() | w.keys() if g.get(k) != w.get(k))
        if bad:
            raise AssertionError(f"{label}: row {w.get('scenario')}/"
                                 f"{w.get('arm') or w.get('variant') or w.get('policy')} "
                                 f"differs from the reference's in {bad}")


def _gate(label: str, problems: list) -> None:
    if problems:
        raise AssertionError(f"{label} gate: {problems}")


def _clock_verdict(label: str, ratio: float, gate: float, above: bool) -> dict:
    """A wall-clock gate's verdict, printed on its own line; it does not
    decide ``ok``."""
    met = ratio >= gate if above else ratio <= gate
    verdict = {"gate": label, "ratio": ratio, "limit": gate,
               "met": bool(met)}
    emit({"wall_clock_gate": verdict})
    return verdict


def _eps(rows: list) -> list:
    return [r["epochs"] / r["wall_s"] if r.get("wall_s") else None
            for r in rows]


def _bench_runs(dev, tmp: str, want: dict) -> dict:
    """Items 2-5 of the port's benches at their default sizes."""
    from repro_torch.benchmarks import balance_bench as BB
    from repro_torch.benchmarks import dist_bench as DB
    from repro_torch.benchmarks import history
    from repro_torch.benchmarks import metrics_bench as MB
    from repro_torch.benchmarks import overload_bench as OB
    from repro_torch.replication import bench as RB

    ledger = os.path.join(tmp, history.HISTORY)
    out = {}

    t0 = time.perf_counter()
    rows = OB.run_matrix(list(OB.SCENARIOS), False, verbose=False, device=dev)
    trace_rows, trace_prob = OB.run_trace(False, tmp, device=dev)
    _rows_equal("overload", rows + trace_rows, want["overload"]["default"])
    _gate("overload survival", OB.check_survival(rows, quick=False)
          + trace_prob)
    history.append("overload", {"quick": False, "rows": rows + trace_rows},
                   history_path=ledger)
    out["overload"] = {"seconds": time.perf_counter() - t0,
                       "epochs_per_s": _eps(rows),
                       "lost": [r["lost"] for r in rows],
                       "spans": trace_rows[0]["spans"], "gates": "pass"}

    t0 = time.perf_counter()
    rows_p, prob_p = MB.run_parity(False, device=dev)
    rows_b, prob_b = MB.run_breach(False, tmp, device=dev)
    _rows_equal("metrics", rows_p + rows_b, want["metrics"]["default"]["rows"])
    _gate("metrics", prob_p + prob_b)
    history.append("metrics", MB.gate_doc(False, rows_p + rows_b, prob_p,
                                          prob_b), history_path=ledger)
    out["metrics"] = {"seconds": time.perf_counter() - t0,
                      "fire_epochs": rows_b[0]["fire_epochs"],
                      "flight_dumps": rows_b[0]["flight_dumps"],
                      "gates": "pass"}

    t0 = time.perf_counter()
    rows, prob = DB.run(False, device=dev)
    _rows_equal("dist", rows, want["dist"]["default"]["rows"])
    ratio, roofline = DB.ratios(rows)
    _gate("dist parity / syncs", prob + [p for p in DB.check(rows)
                                         if not p.startswith("ratio:")])
    history.append("dist", {"quick": False, "rows": rows},
                   history_path=ledger)
    out["dist"] = {"seconds": time.perf_counter() - t0,
                   "steady_eps": {r["variant"]: r["steady_eps"] for r in rows},
                   "host_syncs_per_epoch": {r["variant"]:
                                            r["host_syncs_per_epoch"]
                                            for r in rows},
                   "roofline_ratio": roofline,
                   "ratio_gate": _clock_verdict("dist single_host / "
                                                "dist_fused", ratio,
                                                DB.RATIO_GATE, above=False)}

    t0 = time.perf_counter()
    extras = want["balance_extras"]["default"]
    prof, prof_prob = BB.run_profile(False, device=dev)
    _rows_equal("balance --profile", prof, extras["profile"])
    _gate("balance --profile host syncs",
          [p for p in prof_prob if "host syncs" in p])
    trace, trace_prob = BB.run_trace(
        False, os.path.join(tmp, BB.TRACE_ARTIFACT), device=dev)
    _rows_equal("balance --trace", trace, extras["trace"])
    _gate("balance --trace", trace_prob)
    dist = BB.run_dist_parity(False, device=dev)
    _rows_equal("balance --dist", dist, extras["dist"])
    _gate("balance --dist", BB.check_dist(dist))
    repl = (RB.run_replication_matrix(False, verbose=False, device=dev)
            + RB.run_filter_arm(False, verbose=False, device=dev))
    _rows_equal("balance --replication", repl, extras["replication"])
    repl_prob = RB.check_replication(repl) + RB.check_filter_arm(repl)
    if repl_prob != extras["replication_problems"]:
        raise AssertionError(f"balance --replication findings {repl_prob}, "
                             f"the reference's {extras['replication_problems']}")
    history.append("balance", {"quick": False, "service": "fixed",
                               "rows": prof + trace + dist + repl},
                   history_path=ledger)
    out["balance_extras"] = {
        "seconds": time.perf_counter() - t0,
        "profile_steady_eps": {f"{r['policy']}/{'fused' if r['fused'] else 'epoch'}":
                               r["steady_eps"] for r in prof},
        "growth_events": [r["growth_events"] for r in dist
                          if r.get("bench") == "dist_growth"],
        "replication_findings": repl_prob,
        "profile_ratio_gates": [
            _clock_verdict(f"balance --profile {p} fused / per-epoch", r,
                           BB.PROFILE_RATIO_GATE, above=True)
            for p, r in BB.profile_ratios(prof).items()]}
    with open(ledger) as f:
        out["history_records"] = len(f.read().splitlines())
    if out["history_records"] != 4:
        raise AssertionError(f"history ledger: {out['history_records']} "
                             "records")
    return out


def _demo_runs(dev, tmp: str, want: dict) -> dict:
    """The six demos on the card, their lines held to the reference's."""
    import importlib

    from repro_torch.examples._common import timer_free

    out = {}
    for name in ("quickstart", "failover_demo", "balance_demo", "trace_demo",
                 "serve_kvcache"):
        t0 = time.perf_counter()
        got = importlib.import_module(f"repro_torch.examples.{name}").run(
            dev, echo=False)
        lines = timer_free(got["lines"])
        ref = want[name]["lines"]
        if name == "serve_kvcache":
            # the port's own init: its tokens are not the reference's
            # weights' (the CPU tests hold those); the schedule is
            lines, ref = lines[:-1], ref[:-1]
        if lines != ref:
            bad = next(i for i, (a, b) in enumerate(zip(lines + [None],
                                                        ref + [None]))
                       if a != b)
            raise AssertionError(f"demo {name}: line {bad} {lines[bad:bad + 1]}"
                                 f" vs the reference's {ref[bad:bad + 1]}")
        out[name] = {"seconds": time.perf_counter() - t0, "lines": "equal"}
        if name == "serve_kvcache":
            out[name].update(tokens=got["tokens"], steps=got["steps"],
                             tokens_per_s=got["tokens"] / got["seconds"])
    t0 = time.perf_counter()
    from repro_torch.examples import train_lm

    tw = want["train_lm"]
    got = train_lm.run(dev, steps=TRAIN_LM_STEPS, preset=tw["preset"],
                       ckpt_dir=os.path.join(tmp, "train_lm_ckpt"),
                       echo=False)
    hist = got["history"]
    losses = [h["loss"] for h in hist]
    # the port's init: losses are its own; the parameter count and the
    # schedule's rates are the reference's bit for bit
    if (got["n_params"] != tw["n_params"]
            or [np.float32(h["lr"]) for h in hist]
            != [np.float32(h["lr"]) for h in tw["history"]]):
        raise AssertionError("train_lm: parameters or rates differ from "
                             "the reference's")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train_lm: losses {losses}")
    out["train_lm"] = {"seconds": time.perf_counter() - t0,
                       "loss_first_last": [losses[0], losses[-1]],
                       "step_s_median": float(np.median(
                           [h["seconds"] for h in hist[1:]]))}
    return out


def phase_benches() -> dict:
    """The rest of the repo's benches on the card at their default sizes
    (the overload survival matrix and its trace column, the metrics
    plane's parity and forced breach, the scale-out bench's four drivers
    on the 8-shard mesh, the balance bench's --profile, --trace, --dist and
    --replication extras), each row equal to the reference's, every
    correctness gate holding, the two wall-clock gates' verdicts printed;
    then the six demos (``train_lm`` at --preset tiny, 20 steps).  The
    artifacts go to a temporary directory.  The store kernels' launches
    are the ``benches`` path's, and with K6 the ``examples`` path's."""
    import tempfile

    from repro_torch.kernels.decode_attn import kernel as DAK
    from repro_torch.kernels.range_match import kernel as RMK

    _free_card()
    want = json.loads(BENCH_FIXTURE.read_text())
    dev = torch.device("cuda")
    out = {"phase": "benches", "fixture_made_at": want["made_at"]}
    with tempfile.TemporaryDirectory() as tmp:
        RMK.reset_launches()                       # counts of the main path
        out.update(_bench_runs(dev, tmp, want))
        out["launches"] = dict(RMK.launches)
        _free_card()
        DAK.reset_launches()
        RMK.reset_launches()                       # counts of the main path
        out["examples"] = _demo_runs(dev, tmp, want["examples"])
        out["examples_launches"] = {**RMK.launches,
                                    "decode_attn": DAK.launches["decode_attn"]}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase overload
# ---------------------------------------------------------------------------

# the reference's overload bench (benchmarks/overload_bench.py:60-100) at
# phase 4's data: 10 nodes with standby (8, 9), replication 2, eventual,
# a pull every 2 epochs, overload_adaptive with scale_patience 1; its
# OverloadConfig at the bench's ratios of an active node's share (queue
# 192 / 256 and service 320 / 256 there; here the share is 65,536 / 8 =
# 8,192 ops); 8 epochs, the bench's 24 cut for time.  At those ratios
# the queue bound is below the service rate, so every queue drains within
# its epoch: the p2c queue penalty and the service inflation stay 0 (the
# reference's BENCH_overload.json: max_queue_peak 0 in all four arms).
# A third run holds queues across epochs (a queue of 2.5 shares) to put a
# nonzero queue_pen under K2 at full width
OVL_FULL = dict(queue_cap=6144, service_rate=10240, inflation=3.0,
                max_level=3, backoff_base=1, jitter_span=2, queue_weight=2)
OVL_NODES, OVL_STANDBY, OVL_EPOCHS = 10, (8, 9), 8
CASCADE = dict(theta=0.9, fail_epoch=3, rack=(0, 1, 2))
# (label, scenario, its knobs, the failure epoch, OverloadConfig changes,
# whether some epoch must route under a nonzero queue penalty)
OVL_RUNS = (
    ("cascade_failure", "cascade_failure", CASCADE, 3, {}, False),
    ("retry_storm", "retry_storm",
     dict(theta=0.9, fail_epoch=2, recover_epoch=5, rack=(0, 1)), 2, {},
     False),
    ("cascade_failure/deep_queue", "cascade_failure", CASCADE, 3,
     dict(queue_cap=20480), True),
)


def phase_overload() -> dict:
    """The overload plane at full width: each run's kernel launches, the
    plane's conservation after every period, K2 once an epoch with a
    nonzero queue penalty in some epoch, deferred or shed queries after
    the failure, and every acknowledged write read back from every live
    replica."""
    from repro_torch import cluster as TC
    from repro_torch import overload as OVL
    from repro_torch.kernels.range_match import kernel as RMK

    out = {"phase": "overload", "overload_config": OVL_FULL}
    main_launches = {k: 0 for k in RMK.launches}
    for label, sname, skw, fail_epoch, okw, need_pen in OVL_RUNS:
        scfg = TC.ScenarioConfig(n_records=RECORDS_FULL, value_dim=256,
                                 epoch_ops=B_FULL, n_epochs=OVL_EPOCHS,
                                 seed=7)
        cfg = TC.ClusterConfig(num_nodes=OVL_NODES, num_ranges=RANGES_FULL,
                               replication=2, r_max=R_MAX,
                               standby_nodes=OVL_STANDBY, report_every=2,
                               overload=OVL.OverloadConfig(**{**OVL_FULL, **okw}))
        scen = TC.make_scenario(sname, scfg, **skw)
        torch.cuda.reset_peak_memory_stats()
        RMK.reset_launches()                       # counts of the main path
        t0 = time.perf_counter()
        drv = TC.EpochDriver(
            scen, TC.make_policy("overload_adaptive",
                                 TC.PolicyConfig(scale_patience=1)),
            cfg, fused=True, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rows, gaps = [], []
        for seg in drv.segments():
            rows.extend(seg)
            # one small copy a segment, outside the driver's own syncs
            gaps.append(OVL.conservation_gap(drv.ovl))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = dict(RMK.launches)
        for name, n in launches.items():
            main_launches[name] += n
        summ = drv.overload_summary()
        pen_epochs = [r.epoch + 1 for r in rows[:-1] if r.queue_peak]
        after = [r.deferred + r.shed for r in rows if r.epoch >= fail_epoch]
        problems = []
        if any(gaps):
            problems.append(f"conservation gaps {gaps}")
        if summ["injected"] != sum(r.ops for r in rows):
            problems.append(f"injected {summ['injected']} of "
                            f"{sum(r.ops for r in rows)} ops")
        if (launches["range_match_spread"] != len(rows)
                or (need_pen and not pen_epochs)):
            problems.append(f"range_match_spread launched "
                            f"{launches['range_match_spread']}x in "
                            f"{len(rows)} epochs, queue_pen epochs "
                            f"{pen_epochs}")
        if sum(after) <= 0:
            problems.append("nothing deferred or shed after the failure")
        if sum(r.drops for r in rows):
            problems.append(f"{sum(r.drops for r in rows)} capacity drops")
        for r in rows:
            for f in ("p50", "p99", "p999", "throughput", "imbalance"):
                if not math.isfinite(getattr(r, f)) or getattr(r, f) < 0:
                    problems.append(f"bad {f} at epoch {r.epoch}")
        keys, expected = _expected_values(scen)
        rb = _read_back(drv, keys, expected)
        if rb["missing"] or rb["wrong_value"] or rb["replica_reads"] < keys.size:
            problems.append(f"read-back failed {rb}")
        if problems:
            raise AssertionError(f"overload/{label}: {problems}")
        ss = drv.stage_seconds
        out[label] = {
            "overload_changes": okw,
            "setup_s": t1 - t0, "run_s": t2 - t1,
            "epochs_per_s": len(rows) / (t2 - t1),
            "host_inject_s": ss.get("inject", 0.0),
            "host_route_apply_enqueue_s": ss.get("route_apply", 0.0),
            "host_des_s": ss.get("des", 0.0),
            "host_control_s": ss.get("control", 0.0),
            "device_step_s": drv.device_step_seconds,
            "device_step_share": drv.device_step_seconds / (t2 - t1),
            "host_syncs": drv.host_syncs,
            "launches": launches,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
            "conservation_gaps": gaps,
            "queue_pen_epochs": pen_epochs,
            "deferred": [r.deferred for r in rows],
            "shed": [r.shed for r in rows],
            "requeued": [r.requeued for r in rows],
            "queue_peak": [r.queue_peak for r in rows],
            "p999": [r.p999 for r in rows],
            "max_p999": max(r.p999 for r in rows),
            "lost": summ["lost"],
            "retry_backlog": summ["retry_backlog"],
            "summary": summ,
            "autoscale_events": [e for r in rows for e in r.events
                                 if e.startswith("autoscale_")],
            "events": len([e for r in rows for e in r.events]),
            **rb,
        }
        if need_pen:
            # the plane's step alone on the run's final registers (CUDA
            # events around the call, its host work included), beside the
            # run's device step an epoch
            ocfg = OVL.OverloadConfig(**{**OVL_FULL, **okw})
            target = torch.tensor(np.random.default_rng(0).integers(
                -1, OVL_NODES, B_FULL), device="cuda")
            st, key = drv.ovl, np.array([0, 7], np.uint32)
            step = lambda: OVL.step(st, target, key, ocfg)
            step_ms = time_cuda(step)
            # and its device time by kernel, over 5 calls
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    step()
                torch.cuda.synchronize()
            out[label].update(
                overload_step_ms=step_ms,
                overload_step_profile_5_calls=_device_summary(
                    prof, time.perf_counter() - t0, top=8),
                device_step_ms_per_epoch=1e3 * drv.device_step_seconds
                / len(rows))
        del drv
        torch.cuda.empty_cache()
    out["launches"] = main_launches
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase telemetry
# ---------------------------------------------------------------------------

# the metrics bench's own settings (benchmarks/metrics_bench.py:127-148,
# not quick): spans sampled at 1/64 into 64 slots, a 4-epoch flight ring,
# a 64-epoch ring and its forced p999 SLO (slo_spec(False)); the orbit
# register at 12 bits
TEL_FULL = dict(sample_rate=1 / 64, max_spans=64, flight_epochs=4,
                link_retries=12)
SLO_FULL = dict(name="p999_fleet", series="p999", bound=150.0,
                objective=0.9, fast_window=2, slow_window=4, fast_burn=2.0,
                slow_burn=1.0)
# the incident report's keys the metrics bench checks (metrics_bench.py
# :172-173), each non-empty
INCIDENT_KEYS = ("alerts", "slos", "metrics", "breaches", "flight_dumps",
                 "p999_attribution", "stage_timers")


def _telemetry_run(planes: bool) -> dict:
    """Phase overload's retry_storm deployment, with both planes or none:
    the driver, its rows and what the run cost."""
    from repro_torch import cluster as TC
    from repro_torch import overload as OVL
    from repro_torch.kernels.range_match import kernel as RMK

    label, sname, skw, _, okw, _ = OVL_RUNS[1]
    scfg = TC.ScenarioConfig(n_records=RECORDS_FULL, value_dim=256,
                             epoch_ops=B_FULL, n_epochs=OVL_EPOCHS, seed=7)
    extra = {}
    if planes:
        extra = dict(telemetry=TC.TelemetryConfig(
            **TEL_FULL, flight_dir=str(OUT / "telemetry")),
            metrics=TC.MetricsConfig(window=64, slos=(TC.SLO(**SLO_FULL),)))
    cfg = TC.ClusterConfig(num_nodes=OVL_NODES, num_ranges=RANGES_FULL,
                           replication=2, r_max=R_MAX,
                           standby_nodes=OVL_STANDBY, report_every=2,
                           overload=OVL.OverloadConfig(**{**OVL_FULL, **okw}),
                           **extra)
    scen = TC.make_scenario(sname, scfg, **skw)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()       # what another run still holds
    RMK.reset_launches()                       # counts of the main path
    t0 = time.perf_counter()
    drv = TC.EpochDriver(
        scen, TC.make_policy("overload_adaptive",
                             TC.PolicyConfig(scale_patience=1)),
        cfg, fused=True, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rows = drv.run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"drv": drv, "rows": rows, "scen": scen,
            "launches": dict(RMK.launches), "setup_s": t1 - t0,
            "run_s": t2 - t1, "epochs_per_s": len(rows) / (t2 - t1),
            "stage_seconds": dict(drv.stage_seconds),
            "device_step_s": drv.device_step_seconds,
            "host_syncs": drv.host_syncs,
            "max_memory_allocated_gb":
                (torch.cuda.max_memory_allocated() - base) / 2**30}


def _planes_step_ms(drv) -> dict:
    """Milliseconds of one epoch's ``collect_spans`` + ``record_epoch`` on
    the card (CUDA events after an L2 flush, host enqueue included), at the
    run's shapes: 65,536 queries over a six-hop plan, the run's final
    registers, its ring and its sketch."""
    from repro_torch.core import coordination as CO
    from repro_torch.core import routing as R
    from repro_torch.telemetry import collect_spans, rate_threshold
    from repro_torch.telemetry import metrics as MTR

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    B, H, N = B_FULL, R_MAX + 2, OVL_NODES
    S = drv.directory.num_slots
    t = lambda a: torch.as_tensor(a, device=dev)
    key = t(rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.int64))
    q = R.QueryBatch(t(rng.integers(0, 3, B).astype(np.int32)), key, key,
                     torch.zeros((B, 1), device=dev))
    clen = t(np.full(B, 2))
    dec = R.RoutingDecision(t(rng.integers(0, S, B)), t(rng.integers(0, N, B)),
                            t(rng.integers(0, N, (B, R_MAX))), clen, clen)
    plan = CO.HopPlan(t(np.zeros((B, H), np.int32)),
                      t((40 * rng.random((B, H))).astype(np.float32)),
                      t(np.full(B, 2.0, np.float32)))
    ints = t(rng.integers(0, 3, B).astype(np.int32))
    scale = t(np.ones(B, np.float32))
    thr = rate_threshold(TEL_FULL["sample_rate"])
    zero7 = torch.zeros(7, dtype=torch.int32, device=dev)
    zero5 = torch.zeros(5, dtype=torch.int64, device=dev)
    state = MTR.make_state(64, drv.met_layout.n_series, device=dev)
    spans = lambda: collect_spans(q, 5, dec, dec.target, ints > 1, ints,
                                  ints, ints, scale, plan, threshold=thr,
                                  k_slots=TEL_FULL["max_spans"], lookup=0.25)
    ring = lambda: MTR.record_epoch(
        state, node_ops=drv.load_reg, ovl=drv.ovl, ostats=zero7,
        cstats=zero5, coord=None, repl=drv.repl, sketch=drv.sketch,
        keys=key, ridx=dec.ridx, topk=drv.met_layout.topk)
    from torch.profiler import ProfilerActivity, profile

    both = lambda: (spans(), ring())
    out = {"collect_spans_ms": time_cuda(spans),
           "record_epoch_ms": time_cuda(ring), "both_ms": time_cuda(both)}
    # and the device time of the pair by kernel, over 5 calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            both()
        torch.cuda.synchronize()
    prof_5 = _device_summary(prof, time.perf_counter() - t0, top=8)
    return {**out, "both_device_ms": 1e3 * prof_5["device_busy_s"] / 5,
            "both_profile_5_calls": prof_5,
            "shape": {"B": B, "H": H, "N": N, "S": S,
                      "ring": [64, drv.met_layout.n_series]}}


def phase_telemetry() -> dict:
    """Both observability planes at full width on phase overload's
    retry_storm deployment, against the same run with them off: equal
    metric streams, final store and overload state (the orbit register,
    which only the trace plane sizes, aside), exact attribution, the burn
    alerts of the numpy oracle, a complete incident report, and the spans
    sampled past the slot cap counted."""
    from repro_torch.telemetry import incident, rate_threshold, sample_mask
    from repro_torch.telemetry import slo as SLOM

    import dataclasses

    out = {"phase": "telemetry", "telemetry_config": TEL_FULL,
           "slo": SLO_FULL, "metrics_window": 64}
    off = _telemetry_run(False)
    on = _telemetry_run(True)
    d_off, d_on = off["drv"], on["drv"]
    problems = []
    if ([dataclasses.asdict(r) for r in off["rows"]]
            != [dataclasses.asdict(r) for r in on["rows"]]):
        problems.append("EpochMetrics streams differ")
    pairs = [("store." + f, getattr(d_off.store, f), getattr(d_on.store, f))
             for f in ("keys", "values", "overflow")]
    pairs += [("ovl." + f.name, getattr(d_off.ovl, f.name),
               getattr(d_on.ovl, f.name))
              for f in dataclasses.fields(d_off.ovl) if f.name != "first_seen"]
    pairs += [("load_reg", d_off.load_reg, d_on.load_reg),
              ("sketch", d_off.sketch, d_on.sketch),
              ("chains", d_off.directory.chains, d_on.directory.chains)]
    for name, a, b in pairs:
        if a.dtype != b.dtype or not torch.equal(a, b):
            problems.append(f"{name} differs with the planes on")
    tel = d_on.telemetry
    exact = tel.verify_exact()
    if exact != 0.0:
        problems.append(f"attribution off by {exact}")
    spec = d_on.met_cfg.slos[0]
    p999 = np.asarray([r.p999 for r in on["rows"]], np.float32)
    fired = d_on.met_engine.firing_epochs(spec.name)
    want = SLOM.reference_alerts(p999, spec)["fire_epochs"]
    if not fired or fired != want:
        problems.append(f"alerts fired at {fired}, the oracle at {want}")
    doc = incident.report(d_on, out_dir=str(OUT / "telemetry"),
                          tag="telemetry_retry_storm")
    missing = [k for k in INCIDENT_KEYS if not doc.get(k)]
    if missing or "retry_orbits" not in doc:
        problems.append(f"incident report lacks {missing}")
    # every epoch's sampled count, recomputed from the scenario's keys on
    # the host: the spans past the 64 slots are counted, not hidden
    thr = rate_threshold(TEL_FULL["sample_rate"])
    sampled = [int(sample_mask(torch.as_tensor(
        on["scen"].epoch(e)[1].astype(np.int64)), e, thr).sum())
        for e in range(OVL_EPOCHS)]
    summ = tel.summary()
    if ([r["n_sampled"] for r in tel.epochs] != sampled
            or summ["spans"] != sum(min(n, TEL_FULL["max_spans"])
                                    for n in sampled)
            or summ["spans_sampled"] <= summ["spans"]):
        problems.append(f"sampled {sampled}, recorded {summ['spans']}")
    if problems:
        raise AssertionError(f"telemetry: {problems}")
    keep = ("setup_s", "run_s", "epochs_per_s", "stage_seconds",
            "device_step_s", "host_syncs", "max_memory_allocated_gb",
            "launches")
    out.update(
        planes_off={k: off[k] for k in keep},
        planes_on={k: on[k] for k in keep},
        planes_step=_planes_step_ms(d_on),
        spans=summ["spans"], spans_sampled=summ["spans_sampled"],
        spans_dropped=summ["spans_sampled"] - summ["spans"],
        retry_orbits=summ.get("retry_orbits"),
        orbits_completed=summ.get("orbits_completed"),
        reconstruction_max_err=exact, alert_fire_epochs=fired,
        alerts=len(d_on.alert_timeline()), breaches=len(tel.breaches),
        flight_dumps=len(tel.flight.dumps),
        p999_attribution_share=doc["p999_attribution"]["share"],
        max_p999=float(p999.max()),
        launches=on["launches"])
    del off, on, d_off, d_on, tel, doc, pairs
    torch.cuda.empty_cache()
    # the cost of the planes, in turns on one card: off, on (above), on, off
    for planes in (True, False):
        run = _telemetry_run(planes)
        out["planes_on" if planes else "planes_off"].setdefault(
            "turn_2", {k: run[k] for k in keep if k != "launches"})
        del run
        torch.cuda.empty_cache()
    emit(out)
    return out


# the full-width serving runs: decode_32k's batch of 128 cut to 32 slots;
# for qwen2-1.5b its context of 32,768 cut to an 8,192-position cache (the
# bf16 KV cache is then 7.5 GB), mamba2-370m keeps no KV cache (its decode
# state is 48 MiB of f32 a slot); 64 requests of 256-2,048 prompt tokens
# and 128 new tokens each
SERVE_ARCH = "qwen2-1.5b"
SERVE_SSM_ARCH = "mamba2-370m"
SERVE_SLOTS, SERVE_CACHE, SERVE_SHARDS = 32, 8192, 4
SERVE_REQUESTS, SERVE_NEW, SERVE_PROMPT = 64, 128, (256, 2048)
SERVE_REBALANCE_EVERY, SERVE_FAIL_AT = 6, 8
SERVE_K6_CHECK_STEP = 64


def _k6_check(q, k, v, lengths) -> dict:
    """K6 against its plain version on one layer's live cache (a check,
    not a main-path launch)."""
    from repro_torch.kernels.decode_attn import kernel as DAK
    from repro_torch.kernels.decode_attn import ref as DAR

    before = DAK.launches["decode_attn"]
    got = DAK.decode_attn(q, k, v, lengths)
    want = DAR.decode_attn_ref(q, k, v, lengths)
    torch.cuda.synchronize()
    DAK.launches["decode_attn"] = before
    return {**_k6_compare(got, want), "G": q.shape[1] // k.shape[2],
            "D": q.shape[2], "S": k.shape[1]}


def _live_q(cfg, B: int, seed: int, dev) -> torch.Tensor:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn((B, cfg.n_heads, cfg.head_dim), generator=gen,
                       device=dev).to(torch.bfloat16)


def _k6_live_check(e, cfg, seed) -> dict:
    """K6 against its plain version on layer 0's live cache, at the lengths
    of the step just run: the first attention group's ``k`` / ``v``, or a
    pair's two sublayers ``ka`` / ``va`` and ``kb`` / ``vb``."""
    group = next(g for key, g in e.cache.items() if key != "length"
                 and ("k" in g or "ka" in g))
    pairs = ([("k", "v")] if "k" in group else [("ka", "va"), ("kb", "vb")])
    lengths = e.cache["length"]
    q = _live_q(cfg, SERVE_SLOTS, seed, e.device)
    return _k6_checks({f"{kn}/{vn}": (q, group[kn][0], group[vn][0], lengths)
                       for kn, vn in pairs}, lengths)


def _k6_checks(cases: dict, lengths) -> dict:
    """Several ``_k6_check`` s: their worst error and ratio, each case."""
    res = {name: _k6_check(*args) for name, args in cases.items()}
    return {"ok": all(r.pop("ok") for r in res.values()),
            "max_abs_err": max(r["max_abs_err"] for r in res.values()),
            "tol_ratio": max(r["tol_ratio"] for r in res.values()),
            "cases": res, "lengths": lengths.cpu().tolist()}


class _K7Capture:
    """Keeps a copy of the first SSD scan's inputs that the model runs
    (layer 0 of the first admission): ``repro_torch.models.ssm.ssd_scan``
    wrapped while the serving run lasts."""

    def __init__(self):
        from repro_torch.models import ssm as SSM
        self.module, self.scan, self.args = SSM, SSM.ssd_scan, None

    def __enter__(self):
        def scan(x, dt, A, Bm, Cm, init_state=None, *, chunk):
            if self.args is None:
                self.args = (tuple(t.clone() for t in (x, dt, A, Bm, Cm,
                                                       init_state)), chunk)
            return self.scan(x, dt, A, Bm, Cm, init_state, chunk=chunk)
        self.module.ssd_scan = scan
        return self

    def __exit__(self, *exc):
        self.module.ssd_scan = self.scan

    def check(self) -> dict:
        """K7 against its plain version on the captured inputs, padded as
        the wrapper pads them (a check, not a main-path launch)."""
        from repro_torch.kernels.ssd_chunk import kernel as SSK
        from repro_torch.kernels.ssd_chunk import ops as SSO
        from repro_torch.kernels.ssd_chunk import ref as SSR

        (x, dt, A, Bm, Cm, s0), Q = self.args
        xp, dtp, Bp, Cp = (t.contiguous() for t in
                           SSO.pad_to_chunks(x, dt, Bm, Cm, Q))
        before = SSK.launches["ssd_chunk"]
        got = SSK.ssd_chunk(xp, dtp, A, Bp, Cp, s0, chunk=Q)
        want = SSR.ssd_chunked_ref(xp, dtp, A, Bp, Cp, s0, chunk=Q)
        torch.cuda.synchronize()
        SSK.launches["ssd_chunk"] = before
        return {**_k7_compare(got, want), "T": x.shape[1], "Q": Q,
                "dt_range": [float(dt.min()), float(dt.max())]}


def _serve_full_width(arch: str, seed: int, check_step: int, check, *,
                      cfg=None, cache_len: int = SERVE_CACHE,
                      requests: int = SERVE_REQUESTS,
                      reduced: dict | None = None, extra=None) -> dict:
    """The serving path at full width: ``ServingEngine`` on ``arch`` (or on
    ``cfg``, a cut of it) with bf16 weights from the port's seeded init,
    the traffic above (``requests`` of them) into a cache of ``cache_len``
    positions, a rebalance every 6 steps and the most-loaded shard failed
    at step 8.
    ``check(engine, cfg)`` runs after step ``check_step`` (None: no
    check); ``extra(engine, params, cfg)`` after the run, for reports of
    its own; neither's time is the run's.  Gates: every request finishes,
    no sequence stays on the dead shard, and the kernels of the path
    launch as often as its layers need them: K6 on every GQA attention of
    every decode step, K7 on every SSM layer of every prefill."""
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import kernel as DAK
    from repro_torch.kernels.range_match import kernel as RMK
    from repro_torch.kernels.ssd_chunk import kernel as SSK
    from repro_torch.launch.serve import serve_loop
    from repro_torch.serving.engine import ServingEngine

    dev = torch.device("cuda")
    cfg = cfg or get_config(arch)
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed, device=dev)
    eng = ServingEngine(cfg, params, n_slots=SERVE_SLOTS,
                        cache_len=cache_len, n_shards=SERVE_SHARDS,
                        device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    plens = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, requests)
    for n in plens:
        eng.submit(rng.integers(0, cfg.vocab_size, int(n)),
                   max_new_tokens=SERVE_NEW)
    live: dict = {}

    def on_step(step, e):
        if step != check_step or check is None:
            return
        torch.cuda.synchronize()
        tc = time.perf_counter()
        res = check(e, cfg)
        if not res.pop("ok"):
            raise AssertionError(f"serving {arch}: kernel off its plain "
                                 f"version at step {step}: {res}")
        live.update(step=step, **res, seconds=time.perf_counter() - tc)

    DAK.reset_launches()
    RMK.reset_launches()                       # counts of the main path
    SSK.reset_launches()
    t1 = time.perf_counter()
    records = serve_loop(eng, rebalance_every=SERVE_REBALANCE_EVERY,
                         fail_shard_at=SERVE_FAIL_AT, on_step=on_step)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1 - live.get("seconds", 0.0)
    launches = {"decode_attn": DAK.launches["decode_attn"],
                "range_match": RMK.launches["range_match"],
                "ssd_chunk": SSK.launches["ssd_chunk"]}
    decode_ms = eng.decode_ms()
    # gates: every request finished with its tokens; the failover moved
    # every sequence off the dead shard and none sat on it afterwards
    done = eng.finished
    short = [r for r in done.values() if len(r.out_tokens) != SERVE_NEW]
    if len(done) != requests or short:
        raise AssertionError(f"serving {arch}: {len(done)} of "
                             f"{requests} finished, {len(short)} short")
    (victim, failed_over), = [r["failed"] for r in records if "failed" in r]
    # (a step's record holds its seats before that step's failure)
    seated = sum(sh == victim for r in records if r["step"] > SERVE_FAIL_AT
                 for sh in r["slot_shard"])
    stayed = sum(done[rid].shard == victim for rid in failed_over)
    if not failed_over or seated or stayed:
        raise AssertionError(f"serving {arch}: shard {victim} failed over "
                             f"{len(failed_over)}; {seated} seats and "
                             f"{stayed} failed-over requests on it after")
    ssm = cfg.family in ("ssm", "hybrid")
    if (launches["decode_attn"] != gqa_attentions(cfg) * len(decode_ms)
            or launches["ssd_chunk"] != ssm * cfg.n_layers * requests
            or launches["range_match"] <= 0
            or (check is not None and not live)):
        raise AssertionError(f"serving {arch}: launches {launches} over "
                             f"{len(decode_ms)} decode steps and "
                             f"{requests} prefills, check {live}")
    tokens = sum(len(r.out_tokens) for r in done.values())
    rebal = [r["rebalance"] for r in records if "rebalance" in r]
    cut = {"batch": "decode_32k's 128 -> 32 slots"}
    if eng.kv_cache:
        cut["cache_len"] = f"decode_32k's 32,768 -> {cache_len:,}"
    cut.update(reduced or {})
    out = {
        "arch": arch, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
        "params": M.param_count(params), "param_bytes": M.param_bytes(params),
        "cache_bytes": sum(t.numel() * t.element_size()
                           for k, g in eng.cache.items() if k != "length"
                           for t in g.values()),
        "slots": SERVE_SLOTS, "cache_len": cache_len,
        "shards": SERVE_SHARDS, "replication": 2,
        "requests": requests, "new_tokens": SERVE_NEW,
        "prompt_tokens": int(plens.sum()), "reduced": cut,
        "setup_s": setup_s, "run_s": run_s, "steps": len(records),
        "tokens": tokens, "tokens_per_s": tokens / run_s,
        "prefill_s_p50": float(np.percentile(eng.prefill_seconds, 50)),
        "prefill_s_p99": float(np.percentile(eng.prefill_seconds, 99)),
        "prefill_s_total": float(sum(eng.prefill_seconds)),
        "decode_steps": len(decode_ms),
        "decode_ms_p50": float(np.percentile(decode_ms, 50)),
        "decode_ms_p99": float(np.percentile(decode_ms, 99)),
        "decode_ms_total": float(sum(decode_ms)),
        "launches": launches, "live_check": live,
        "rebalances": len(rebal),
        "migration_ops": sum(len(ops) for _, ops in rebal),
        "moved_sequences": sum(m for m, _ in rebal),
        "failed_shard": victim, "failed_over": len(failed_over),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    if extra is not None:
        out.update(extra(eng, params, cfg))
    del eng, params
    _free_card()
    return out


# phase families: the MoE, MLA, vlm and encdec families, at their
# published widths, bf16 weights from the port's seeded init, with the
# serving phases' traffic (whisper through the facade); each cut is in the
# line's ``reduced``.  Parameter ranges are the reference's own
# (tests/test_models.py:102-114); llama4 is cut to one pair (its 400e9
# parameters, 800 GB in bf16, fit no card) and held to that pair's count
FAMILY_PARAMS = {"deepseek-moe-16b": (15e9, 18e9), "minicpm3-4b": (3.5e9, 5e9),
                 "internvl2-26b": (19e9, 27e9), "whisper-small": (0.2e9, 0.35e9)}
FAMILY_CACHE = {"deepseek-moe-16b": 4096, "minicpm3-4b": 8192,
                "internvl2-26b": 4096, "llama4-maverick-400b-a17b": 8192}
# a fifth of the serving phases' 64 requests: the four engine runs took
# 145-270 s of host time with 64 each and 137 s with 32 (NVIDIA H100 80GB
# HBM3, 700 W), and the script must stay well inside its time limit (16
# before phase benches joined it)
FAMILY_REQUESTS = 12
LLAMA4_DEPTH = 2
MOE_PROMPT = 2048                 # the prompt whose MoE drops are reported
VLM_PATCHES, VLM_TOKENS, VLM_STEPS = 256, 256, 16
# whisper: 32 utterances of 30 s (1,500 frames), the start-of-transcript
# prompt <|startoftranscript|><|en|><|transcribe|><|notimestamps|>, 128
# greedy steps in the published 448-position decoder context
WHISPER_BATCH, WHISPER_STEPS, WHISPER_CACHE = 32, 128, 448
WHISPER_PROMPT = (50258, 50259, 50359, 50363)


def _pair_param_count(cfg) -> int:
    """The parameters of a ``pair`` stack counted from its widths:
    embeddings, lm_head and final norm, then per pair a dense layer and a
    MoE layer (two norms and GQA attention each; the MoE's router, routed
    and shared experts)."""
    D, V = cfg.d_model, cfg.padded_vocab
    attn = 2 * D * cfg.q_dim + 2 * D * cfg.kv_dim
    dense = 2 * D + attn + 3 * D * cfg.d_ff
    moe = (2 * D + attn + D * cfg.n_experts
           + 3 * cfg.n_experts * D * cfg.expert_d_ff
           + 3 * D * cfg.expert_d_ff * cfg.n_shared_experts)
    return 2 * V * D + D + cfg.n_layers // 2 * (dense + moe)


def _moe_drops(eng, params, cfg) -> dict:
    """``forward_seq``'s MoE aux on one seeded prompt of 2,048 tokens."""
    from repro_torch.models import transformer as TT

    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, MOE_PROMPT), generator=gen,
                         device="cuda")
    x, _ = TT.assemble_inputs(params, cfg, {"tokens": toks})
    _, aux, _ = TT.forward_seq(params, cfg, x)
    layers = sum(g.n_layers for g in TT.layer_groups(cfg)
                 if g.kind in ("moe", "pair"))
    n = MOE_PROMPT * cfg.top_k * layers
    dropped = int(aux["moe_dropped"])
    return {"moe": {"prompt_tokens": MOE_PROMPT, "layers": layers,
                    "capacity_factor": cfg.moe_capacity_factor,
                    "assignments": n, "dropped": dropped,
                    "dropped_share": dropped / n,
                    "aux_loss": float(aux["moe_aux_loss"])}}


def _decode_vs_prefill(eng, params, cfg) -> dict:
    """One decode step's logits against the teacher-forced prefill of the
    same 257 tokens (reported; phase 3 is the gate)."""
    from repro_torch import models as M

    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (1, 257), generator=gen,
                         device="cuda")
    _, cache = M.prefill(params, cfg, {"tokens": toks[:, :-1]}, cache_len=512)
    dec, _ = M.decode_step(params, cfg, toks[:, -1], cache)
    full, _ = M.prefill(params, cfg, {"tokens": toks}, cache_len=512)
    return {"decode_vs_prefill": {
        "tokens": 257, "max_abs_diff": float((dec.float() - full.float())
                                             .abs().max()),
        "logits_abs_max": float(full.float().abs().max())}}


def _vlm_facade(eng, params, cfg) -> dict:
    """One facade prefill of 256 seeded patch embeddings (width 3,200)
    before 256 tokens, then 16 greedy decode steps; K6 on every layer of
    every step."""
    from repro_torch import models as M
    from repro_torch.kernels.decode_attn import kernel as DAK

    eng.cache = None                    # the engine's KV cache is done
    _free_card()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    batch = {"patches": torch.randn((1, VLM_PATCHES, cfg.vit_embed_dim),
                                    generator=gen, device=dev),
             "tokens": torch.randint(0, cfg.vocab_size, (1, VLM_TOKENS),
                                     generator=gen, device=dev)}
    torch.cuda.synchronize()
    before = DAK.launches["decode_attn"]
    t0 = time.perf_counter()
    logits, cache = M.prefill(params, cfg, batch,
                              cache_len=VLM_PATCHES + VLM_TOKENS + VLM_STEPS)
    tok = logits[:, :cfg.vocab_size].argmax(-1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    events, finite = [], bool(torch.isfinite(logits).all())
    for _ in range(VLM_STEPS):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        logits, cache = M.decode_step(params, cfg, tok, cache)
        ev[1].record()
        events.append(ev)
        tok = logits[:, :cfg.vocab_size].argmax(-1)
        finite &= bool(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    k6 = DAK.launches["decode_attn"] - before
    DAK.launches["decode_attn"] = before      # not the engine run's count
    length = int(cache["length"][0])
    if (not finite or k6 != gqa_attentions(cfg) * VLM_STEPS
            or length != VLM_PATCHES + VLM_TOKENS + VLM_STEPS):
        raise AssertionError(f"vlm facade: finite {finite}, K6 {k6}, "
                             f"length {length}")
    ms = [a.elapsed_time(b) for a, b in events]
    return {"vlm_facade": {"patches": VLM_PATCHES, "tokens": VLM_TOKENS,
                           "decode_steps": VLM_STEPS, "prefill_s": prefill_s,
                           "decode_ms_p50": float(np.percentile(ms, 50)),
                           "decode_ms_p99": float(np.percentile(ms, 99)),
                           "decode_attn_launches": k6, "length": length}}


def _whisper_full_width(seed: int) -> dict:
    """whisper-small at its published widths through the model facade:
    32 utterances of 1,500 seeded frame embeddings, the start-of-transcript
    prompt, 128 greedy steps (host picks, as the engine's) in a cache of
    448 positions.  K6 on the self and the cross attention of every layer
    of every step, held against its plain version on layer 0's self and
    cross caches after step 64."""
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import kernel as DAK
    from repro_torch.kernels.range_match import kernel as RMK

    dev = torch.device("cuda")
    arch = "whisper-small"
    cfg = get_config(arch)
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    frames = torch.randn((WHISPER_BATCH, cfg.encoder_len, cfg.d_model),
                         generator=gen, device=dev)
    prompt = torch.tensor(WHISPER_PROMPT, device=dev).repeat(WHISPER_BATCH, 1)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    DAK.reset_launches()
    RMK.reset_launches()
    t1 = time.perf_counter()
    logits, cache = M.prefill(params, cfg, {"frames": frames,
                                            "tokens": prompt},
                              cache_len=WHISPER_CACHE)
    picks = [logits[:, :cfg.vocab_size].float().cpu().numpy().argmax(-1)]
    prefill_s = time.perf_counter() - t1
    events, live, check_s = [], {}, 0.0
    for step in range(1, WHISPER_STEPS + 1):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        logits, cache = M.decode_step(
            params, cfg, torch.tensor(picks[-1], device=dev), cache)
        ev[1].record()
        events.append(ev)
        picks.append(logits[:, :cfg.vocab_size].float().cpu().numpy()
                     .argmax(-1))
        if step == WHISPER_STEPS // 2:
            tc = time.perf_counter()
            q = _live_q(cfg, WHISPER_BATCH, seed, dev)
            enc = torch.full((WHISPER_BATCH,), cfg.encoder_len,
                             dtype=torch.int32, device=dev)
            live = _k6_checks({
                "self": (q, cache["k"][0], cache["v"][0], cache["length"]),
                "cross": (q, cache["ck"][0], cache["cv"][0], enc)},
                cache["length"])
            if not live.pop("ok"):
                raise AssertionError(f"whisper: K6 off its plain version: "
                                     f"{live}")
            check_s = time.perf_counter() - tc
            live.update(step=step, seconds=check_s)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1 - check_s
    ms = [a.elapsed_time(b) for a, b in events]
    launches = {"decode_attn": DAK.launches["decode_attn"],
                "range_match": RMK.launches["range_match"], "ssd_chunk": 0}
    finite = bool(torch.isfinite(logits).all())
    if (launches["decode_attn"] != gqa_attentions(cfg) * WHISPER_STEPS
            or not finite or int(cache["length"][0])
            != len(WHISPER_PROMPT) + WHISPER_STEPS):
        raise AssertionError(f"whisper: launches {launches}, finite "
                             f"{finite}, length {cache['length'][0]}")
    tokens = WHISPER_BATCH * (WHISPER_STEPS + 1)
    out = {
        "arch": arch, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
        "n_encoder_layers": cfg.n_encoder_layers,
        "params": M.param_count(params), "param_bytes": M.param_bytes(params),
        "cache_bytes": sum(t.numel() * t.element_size() for k, t in
                           cache.items() if k != "length"),
        "batch": WHISPER_BATCH, "frames": cfg.encoder_len,
        "prompt_tokens": len(WHISPER_PROMPT), "cache_len": WHISPER_CACHE,
        "reduced": {"batch": "decode_32k's 128 -> 32 utterances",
                    "cache_len": "the published decoder context, 448"},
        "setup_s": setup_s, "run_s": run_s, "tokens": tokens,
        "tokens_per_s": tokens / run_s,
        # one prefill of the whole batch: its p50 and p99 are its time
        "prefill_s_p50": prefill_s, "prefill_s_p99": prefill_s,
        "prefill_s_total": prefill_s, "decode_steps": len(ms),
        "decode_ms_p50": float(np.percentile(ms, 50)),
        "decode_ms_p99": float(np.percentile(ms, 99)),
        "decode_ms_total": float(sum(ms)), "launches": launches,
        "live_check": live,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    del params, cache, frames
    _free_card()
    return out


def phase_families(seed: int = 0) -> list[dict]:
    """deepseek-moe-16b, minicpm3-4b, internvl2-26b and llama4-maverick
    (one pair) through the engine, whisper-small through the facade; one
    line each, with its parameter gate."""
    import dataclasses

    from repro_torch.configs import get_config

    live = lambda e, cfg: _k6_live_check(e, cfg, seed)  # noqa: E731
    llama4 = get_config("llama4-maverick-400b-a17b")
    llama4 = dataclasses.replace(llama4, n_layers=LLAMA4_DEPTH)
    runs = (
        ("deepseek-moe-16b", dict(check=live, extra=_moe_drops)),
        ("minicpm3-4b", dict(check=None, extra=_decode_vs_prefill)),
        ("internvl2-26b", dict(check=live, extra=_vlm_facade)),
        ("llama4-maverick-400b-a17b", dict(
            check=live, extra=_moe_drops, cfg=llama4,
            reduced={"depth": "48 -> 2 layers (one dense + MoE pair): the "
                              "full model's ~800 GB of bf16 fits no card"})),
    )
    lines = []
    for arch, kw in runs + (("whisper-small", None),):
        if kw is None:
            out = _whisper_full_width(seed)
        else:
            check = kw.pop("check")
            out = _serve_full_width(
                arch, seed, SERVE_K6_CHECK_STEP, check,
                cache_len=FAMILY_CACHE[arch], requests=FAMILY_REQUESTS,
                reduced={"requests": f"{SERVE_REQUESTS} -> "
                                     f"{FAMILY_REQUESTS}: the script's "
                                     "time limit", **kw.pop("reduced", {})},
                **kw)
        if arch in FAMILY_PARAMS:
            lo, hi = FAMILY_PARAMS[arch]
            ok = lo <= out["params"] <= hi
            out["params_gate"] = f"{lo:.3g} <= params <= {hi:.3g}"
        else:
            want = _pair_param_count(llama4)
            ok = out["params"] == want
            out["params_gate"] = f"params == {want} (the pair's count)"
        if not ok:
            raise AssertionError(f"families {arch}: {out['params']} "
                                 f"parameters, gate {out['params_gate']}")
        emit({"phase": "families", **out})
        lines.append(out)
    return lines


def phase_serving(seed: int = 0) -> dict:
    """qwen2-1.5b at full width; K6 held against its plain version on layer
    0's live cache at step 64."""
    out = {"phase": "serving", **_serve_full_width(
        SERVE_ARCH, seed, SERVE_K6_CHECK_STEP,
        lambda e, cfg: _k6_live_check(e, cfg, seed))}
    emit(out)
    return out


def phase_serving_ssm(seed: int = 0) -> dict:
    """mamba2-370m at full width; K7 held against its plain version on
    layer 0's live scan inputs of the first prefill, after step 1."""
    with _K7Capture() as cap:
        out = {"phase": "serving_ssm", **_serve_full_width(
            SERVE_SSM_ARCH, seed, 1, lambda e, cfg: cap.check())}
    emit(out)
    return out



# phase training: qwen2-1.5b and mamba2-370m at their published widths and
# depth, bf16 compute over float32 master weights and AdamW state, remat,
# the copy task, launch/train.py's loop and schedule (warmup
# max(5, steps // 20)); mamba2's SSD scans run K7 forward and the plain
# chunked scan's VJP backward
TRAIN_ARCHS = ("qwen2-1.5b", "mamba2-370m")
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 16
TRAIN_LR, TRAIN_CKPT_EVERY, TRAIN_REPLAY = 3e-4, 8, 2


def train_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one train step (forward and backward, no remat):
    6 x parameters x tokens, plus attention's 12 x layers x q width x
    sequence per token (PaLM's count, the whole T x T square); an
    attention-free config (mamba2, ``n_heads`` 0) has no attention term."""
    tokens = batch * seq
    return (6.0 * n_params * tokens
            + 12.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * seq * tokens)


K7_KERNELS = 4            # K7's four passes, one kernel each


def _scan_ms(cfg, reps: int = 3, queue: int = 10) -> dict:
    """One SSM layer's scan as a remat train step runs it, at the training
    shape (B 8, T 2,048, the config's heads, head dim, groups, state and
    chunk): K7's forward, then K7 again in the recompute and the backward
    through the plain scan's VJP.  K7's forward: CUDA-event ms of
    ``queue`` back-to-back calls over their count (its kernels queue
    behind one another, so the events read device time; a profiler window
    holding K7's launches alone read no kernel in a full run).  The
    recompute and backward: CUDA-event ms, the median of ``reps`` after
    one warm-up (the host's issue gaps included: the VJP issues thousands
    of small kernels), and device time and kernels from ``reps`` more,
    profiled after a profiler warm-up step.  The launches it makes are
    taken back out of the counts."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels.ssd_chunk import kernel as SSK
    from repro_torch.kernels.ssd_chunk.ops import ssd_scan

    B, T = TRAIN_BATCH, TRAIN_SEQ
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.d_state, cfg.ssm_groups
    chunk = min(cfg.ssm_chunk, max(8, T))
    gen = torch.Generator(device="cuda").manual_seed(5)
    leaves = [torch.randn((B, T, H, P), device="cuda", generator=gen),
              torch.rand((B, T, H), device="cuda", generator=gen) * 0.1 + 1e-3,
              -torch.rand((H,), device="cuda", generator=gen) - 0.5,
              torch.randn((B, T, G, N), device="cuda", generator=gen),
              torch.randn((B, T, G, N), device="cuda", generator=gen)]
    leaves = [t.requires_grad_(True) for t in leaves]
    s0 = torch.zeros((B, H, P, N), device="cuda")
    gy = torch.randn((B, T, H, P), device="cuda", generator=gen)

    def timed(fn, n: int = 1) -> float:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(n):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / n

    def forward():
        with torch.no_grad():
            ssd_scan(*leaves, s0, chunk=chunk)

    def recompute_and_backward():
        y, fs = ssd_scan(*leaves, s0, chunk=chunk)
        torch.autograd.backward((y, fs), (gy, torch.ones_like(fs)))
        for t in leaves:
            t.grad = None

    before = dict(SSK.launches)
    timed(forward)
    fwd = timed(forward, queue)
    ms = [timed(recompute_and_backward) for _ in range(reps + 1)]
    got = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=reps),
                 on_trace_ready=lambda p: got.append(
                     _device_summary(p, 1.0))) as prof:
        for _ in range(reps + 1):
            recompute_and_backward()
            torch.cuda.synchronize()
            prof.step()
    SSK.launches.update(before)
    dev, = got
    rest = {"event_ms": float(np.median(ms[1:])),
            "device_ms": dev["device_busy_s"] * 1e3 / reps,
            "kernels": dev["device_events"] / reps}
    return {"reps": reps, "k7_forward_ms": fwd,
            "k7_recompute_and_plain_vjp": rest,
            "layer": {"event_ms": fwd + rest["event_ms"],
                      "device_ms": fwd + rest["device_ms"],
                      "kernels": K7_KERNELS + rest["kernels"]}}


def _train_full_width(arch: str) -> dict:
    """``launch/train.py``'s loop on ``arch`` at full width:
    ``TRAIN_STEPS`` steps of 8 x 2,048 tokens, a checkpoint every
    ``TRAIN_CKPT_EVERY`` on a thread; then that checkpoint restored and
    the next ``TRAIN_REPLAY`` steps replayed.  Gates: the mean loss of
    the last 5 steps under that of the first 5 (the reference's
    ``test_loss_decreases``), finite losses, no kernel of the port
    launched but K7 (the reference trains through jnp, no Pallas kernel;
    an SSM config's scans launch K7 twice a layer and step, the forward
    and the remat recompute, and count one backward through the plain
    scan's VJP, ``ssd_chunk_plain_grad``), the replay within 1e-3 of the
    first run's losses.  For an SSM config, the scans' share of the step:
    :func:`_scan_ms` x layers over the profiled step's device time and
    kernels, and over step ms p50."""
    import shutil

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels.decode_attn import kernel as DAK
    from repro_torch.kernels.range_match import kernel as RMK
    from repro_torch.kernels.ssd_chunk import kernel as SSK
    from repro_torch.launch.train import device_batch, train_config, train_loop
    from repro_torch.models import model as M
    from repro_torch.telemetry.profiler import PEAK_BF16_FLOPS
    from repro_torch.training.step import make_train_step

    cfg = get_config(arch)
    ssm = cfg.family in ("ssm", "hybrid")
    shape = ShapeSpec("chip_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    steps = TRAIN_STEPS
    tcfg = train_config(steps, TRAIN_LR)
    ckpt = OUT / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    lines: list[str] = []
    _free_card()
    # the step's transients (the flash loop's blocks, 4.6 GiB float32 CE
    # chunks) fragment fixed-size segments past the card's 80 GB
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    torch.cuda.reset_peak_memory_stats()
    DAK.reset_launches()
    RMK.reset_launches()                       # counts of the main path
    SSK.reset_launches()
    t0 = time.perf_counter()
    state, recs = train_loop(cfg, shape, tcfg, steps=steps,
                             ckpt_dir=str(ckpt), ckpt_every=TRAIN_CKPT_EVERY,
                             device="cuda", log=lines.append)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {**RMK.launches, "decode_attn": DAK.launches["decode_attn"],
                "ssd_chunk": SSK.launches["ssd_chunk"]}
    plain_grad = SSK.launches["ssd_chunk_plain_grad"]
    peak = torch.cuda.max_memory_allocated()
    n_params = M.param_count(state["params"])
    losses = [r["loss"] for r in recs]
    ms = [r["ms"] for r in recs[1:]]           # the first step warms up
    secs = [r["seconds"] for r in recs[1:]]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    # the device's busy share of one more step (the state it makes is
    # dropped); device activity only: a step issues ~64,000 kernels, and
    # the operator events would take the trace's processing past a minute
    batch = device_batch(make_batch(cfg, shape, steps,
                                    DataConfig("copy")), "cuda")
    step_fn = make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        _, m = step_fn(state, batch)
        float(m["loss"])
        wall = time.perf_counter() - tp
    busy = _device_summary(prof, wall, top=8)
    profile_s = time.perf_counter() - t_prof
    del state, m, batch, prof
    _free_card()
    p50 = float(np.percentile(ms, 50))
    scan = None
    if ssm:
        # the scans' share of the step: one layer's, times the layers,
        # over the profiled step's device time and kernels; and its
        # CUDA-event ms over step ms p50 (both host-bound, so the host's
        # issue of the scans overlaps the device's other work: an upper
        # bound)
        scan = _scan_ms(cfg)
        layer, L = scan["layer"], cfg.n_layers
        scan["share_of_step_device_time"] = (
            L * layer["device_ms"] / 1e3 / busy["device_busy_s"])
        scan["share_of_step_kernels"] = L * layer["kernels"] / busy[
            "device_events"]
        scan["event_ms_over_step_p50"] = L * layer["event_ms"] / p50
        _free_card()
    # the resume: the first checkpoint, the steps after it again
    t1 = time.perf_counter()
    _, replay = train_loop(cfg, shape, tcfg,
                           steps=TRAIN_CKPT_EVERY + TRAIN_REPLAY,
                           ckpt_dir=str(ckpt), ckpt_every=TRAIN_CKPT_EVERY,
                           device="cuda", resume_step=TRAIN_CKPT_EVERY,
                           log=lines.append)
    replay_s = time.perf_counter() - t1
    first = losses[TRAIN_CKPT_EVERY:TRAIN_CKPT_EVERY + TRAIN_REPLAY]
    again = [r["loss"] for r in replay]
    diffs = [abs(a - b) for a, b in zip(first, again)]
    shutil.rmtree(ckpt, ignore_errors=True)
    _free_card()
    torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    out = {
        "phase": "training", "arch": arch, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "vocab": cfg.vocab_size, "params": n_params,
        "compute_dtype": cfg.dtype, "master_dtype": cfg.param_dtype,
        "opt_state_dtype": cfg.opt_state_dtype, "remat": tcfg.remat,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": steps,
        "task": "copy", "lr": TRAIN_LR, "warmup_steps": tcfg.opt.warmup_steps,
        "ckpt_every": TRAIN_CKPT_EVERY, "run_s": run_s,
        "first_step_ms": recs[0]["ms"],
        "step_ms_p50": p50,
        "step_ms_p99": float(np.percentile(ms, 99)),
        "tokens_per_s": tokens * len(secs) / sum(secs),
        "model_flops_per_step": flops,
        "train_mfu": flops / (p50 / 1e3) / PEAK_BF16_FLOPS,
        "max_memory_allocated_gb": peak / 2**30,
        "device_busy_share": busy["device_busy_share"],
        # the profiled step's device time over an unprofiled step's p50
        "device_busy_share_of_p50": busy["device_busy_s"] / (p50 / 1e3),
        "profiled_step": {**{k: busy[k] for k in (
            "wall_s", "device_busy_s", "device_events", "top")},
            "with_processing_s": profile_s},
        "losses": losses, "grad_norms": [r["grad_norm"] for r in recs],
        "launches": launches, "plain_vjp_backward": plain_grad, "log": lines,
        "resume": {"from_step": TRAIN_CKPT_EVERY, "losses": again,
                   "first_run": first, "bitwise": again == first,
                   "max_abs_diff": max(diffs), "seconds": replay_s},
        "reduced": {"steps": "20: the script's time limit"},
    }
    if scan is not None:
        out["scan"] = scan
    emit(out)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training {arch}: non-finite loss {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"training {arch}: the loss did not fall {losses}")
    scans = cfg.n_layers * steps if ssm else 0
    if (any(v for k, v in launches.items() if k != "ssd_chunk")
            or launches["ssd_chunk"] != 2 * scans or plain_grad != scans):
        raise AssertionError(f"training {arch}: kernels launched {launches}, "
                             f"{plain_grad} plain-scan backward passes")
    if len(again) != TRAIN_REPLAY or not max(diffs) <= 1e-3:
        raise AssertionError(f"training {arch}: replay {again} vs {first}")
    return out


def phase_training() -> dict:
    """Each of ``TRAIN_ARCHS`` through :func:`_train_full_width`; returns
    the runs' kernel launches and plain-scan backward passes summed."""
    runs = [_train_full_width(arch) for arch in TRAIN_ARCHS]
    return {"launches": {k: sum(r["launches"][k] for r in runs)
                         for k in runs[0]["launches"]},
            "plain_vjp_backward": sum(r["plain_vjp_backward"] for r in runs)}


# ---------------------------------------------------------------------------
# phase dryrun
# ---------------------------------------------------------------------------

# the dry-run (repro_torch.launch.dryrun) on the GPU machine: (a) the ten
# configs' train_4k and decode_32k cells on the 16x16 mesh, counted on
# meta; (b) qwen2-1.5b and mamba2-370m at full width on the card mesh:
# train at phase training's 8 x 2,048, a 2,048-token prefill, a decode
# step of phase serving's 32 slots of 8,192 positions
DRYRUN_META = ("train_4k", "decode_32k")
DRYRUN_CARD_ARCHS = ("qwen2-1.5b", "mamba2-370m")
DRYRUN_JOBS = 8            # worker processes counting the meta cells
# the caching allocator rounds each block up to 512 bytes: a card cell's
# arguments occupy the predicted bytes plus less than that a leaf
DRYRUN_ALLOC_ROUND = 512


def _kernel_plain_flops(cfg, shape) -> tuple[str | None, int]:
    """The kernel one layer of the cell's step launches and its plain
    version's FLOPs at that layer's shape, counted on ``meta``: the
    prediction counts the plain versions (as ``analyze_hlo`` counts the
    reference's jnp), while ``FlopCounterMode`` on the card does not see a
    kernel launched through ctypes.  K6: a decode step's attention over
    the cache; K7: the SSD scan of a prefill or train step."""
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.ssd_chunk.ops import ssd_scan
    from repro_torch.launch.op_stats import count_flops

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    B, T = shape.global_batch, shape.seq_len
    if cfg.family == "ssm" and shape.kind != "decode":
        H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.d_state, cfg.ssm_groups
        return "ssd_chunk", count_flops(
            ssd_scan, meta(B, T, H, P), meta(B, T, H), meta(H),
            meta(B, T, G, N), meta(B, T, G, N), meta(B, H, P, N),
            chunk=min(cfg.ssm_chunk, max(8, T)))
    if cfg.family == "dense" and shape.kind == "decode":
        dt = getattr(torch, cfg.dtype)
        kv = meta(B, T, cfg.n_kv_heads, cfg.head_dim, dtype=dt)
        return "decode_attn", count_flops(
            decode_attn, meta(B, cfg.n_heads, cfg.head_dim, dtype=dt), kv, kv,
            meta(B, dtype=torch.int32))
    return None, 0


def phase_dryrun() -> dict:
    """(a) and (b) above.  Every cell is predicted on ``meta`` in
    ``DRYRUN_JOBS`` spawned processes (``dryrun.run_cells``); then each
    card cell runs (``dryrun.measure_on_card``: CUDA-event ms, the median
    of ``CARD_REPS`` after one warm-up counted by ``FlopCounterMode``),
    the allocator in expandable segments as in phase training.  Gates: no
    cell errs; a card cell's output is finite, its arguments occupy the
    predicted bytes plus less than ``DRYRUN_ALLOC_ROUND`` a leaf (at least
    the predicted bytes), its warm-up's count plus
    the plain FLOPs of the kernels it launched a layer equals the
    prediction exactly, and K6 (qwen2's decode) and K7 (mamba2's prefill
    and train: forward and remat recompute) launch once a layer and step,
    K7's backward through the plain scan's VJP once a layer and step."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.kernels.decode_attn import kernel as DAK
    from repro_torch.kernels.range_match import kernel as RMK
    from repro_torch.kernels.ssd_chunk import kernel as SSK
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.input_specs import parse_shape

    # the train cells first: they take the longest to count
    meta_jobs = [(a, s, "single", {}) for s in DRYRUN_META for a in ARCH_IDS]
    card_jobs = [(a, s, "card", {"measure": False})
                 for a in DRYRUN_CARD_ARCHS for s in DR.CARD_SHAPES]
    t0 = time.perf_counter()
    recs = list(DR.run_cells(meta_jobs + card_jobs, DRYRUN_JOBS))
    count_s = time.perf_counter() - t0
    bad = {f"{a}/{s}/{m}": r.get("error") for (a, s, m, _), r
           in zip(meta_jobs + card_jobs, recs) if r["status"] == "error"}
    if bad:
        raise AssertionError(f"dryrun: cells failed {bad}")

    def row_of(key, rec):
        r = RL.analyze_cell(key, rec)
        row = {"key": key, "status": rec["status"],
               "argument_gib_per_device": rec["memory"]["argument_bytes"] / 2**30,
               "counted_flops": rec["cost"]["flops"], "count_s": rec["count_s"],
               **{k: r[k] for k in ("model_flops", "bound", "t_compute_s",
                                    "t_memory_s", "t_collective_s",
                                    "roofline_fraction")}}
        if "measured" in rec:
            row.update(step_ms=rec["measured"]["step_ms"],
                       measured_fraction=r["measured_fraction"])
        return row

    meta_rows = []
    for (a, s, m, _), rec in zip(meta_jobs, recs):
        key = DR.cell_key("baseline", a, s, m)
        meta_rows.append(row_of(key, rec) if rec["status"] == "ok" else
                         {"key": key, "status": rec["status"],
                          "reason": rec["reason"]})
    emit({"phase": "dryrun", "part": "meta", "mesh": "16x16",
          "cells": meta_rows, "seconds_all_predictions": count_s,
          "workers": DRYRUN_JOBS})

    _free_card()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    DAK.reset_launches()
    RMK.reset_launches()                       # counts of the main path
    SSK.reset_launches()
    t1 = time.perf_counter()
    for (a, s, m, _), rec in zip(card_jobs, recs[len(meta_jobs):]):
        cfg, shape = get_config(a), parse_shape(s)
        before = (DAK.launches["decode_attn"], dict(SSK.launches))
        rec["measured"] = meas = DR.measure_on_card(a, s, rec)
        _free_card()
        k6 = DAK.launches["decode_attn"] - before[0]
        k7 = SSK.launches["ssd_chunk"] - before[1]["ssd_chunk"]
        vjp = (SSK.launches["ssd_chunk_plain_grad"]
               - before[1]["ssd_chunk_plain_grad"])
        steps = 1 + meas["reps"]
        kname, kflops = _kernel_plain_flops(cfg, shape)
        L = cfg.n_layers
        seen = meas["flops_on_card"] + (L * kflops if kname else 0)
        held, pred = meas["argument_bytes_on_card"], rec["memory"]["argument_bytes"]
        row = {**row_of(DR.cell_key("card", a, s, m), rec),
               "predicted_argument_bytes": pred, "argument_bytes_on_card": held,
               "argument_leaves": meas["argument_leaves"],
               "bytes_ratio": pred / held,
               "temp_bytes": rec["memory"]["temp_bytes"],
               "max_memory_allocated": meas["max_memory_allocated"],
               "step_ms_all": meas["step_ms_all"],
               "flops_on_card": meas["flops_on_card"],
               "kernel_plain_flops_a_layer": {kname: kflops} if kname else {},
               "launches": {"decode_attn": k6, "ssd_chunk": k7,
                            "ssd_chunk_plain_grad": vjp}}
        if kname == "ssd_chunk":      # K7's bound at this cell's scans
            row["k7_bound"] = _k7_bound(
                shape.global_batch, shape.seq_len, cfg.ssm_heads,
                cfg.ssm_head_dim, cfg.d_state, cfg.ssm_groups,
                min(cfg.ssm_chunk, shape.seq_len))
        emit({"phase": "dryrun", "part": "card", **row})
        want_k6 = L * steps if kname == "decode_attn" else 0
        want_k7 = (L * steps * (2 if shape.kind == "train" else 1)
                   if kname == "ssd_chunk" else 0)
        want_vjp = L * steps if kname == "ssd_chunk" and shape.kind == "train" else 0
        if not meas["finite"]:
            raise AssertionError(f"dryrun {a}/{s}: non-finite output")
        if not 0 <= held - pred < DRYRUN_ALLOC_ROUND * meas["argument_leaves"]:
            raise AssertionError(f"dryrun {a}/{s}: predicted {pred} argument "
                                 f"bytes in {meas['argument_leaves']} leaves, "
                                 f"{held} on the card")
        if seen != rec["cost"]["flops"]:
            raise AssertionError(f"dryrun {a}/{s}: {seen} FLOPs on the card "
                                 f"(kernels' plain FLOPs added), "
                                 f"{rec['cost']['flops']} predicted")
        if (k6, k7, vjp) != (want_k6, want_k7, want_vjp):
            raise AssertionError(f"dryrun {a}/{s}: launches K6 {k6}, K7 {k7}, "
                                 f"plain VJP {vjp}; want {want_k6}, "
                                 f"{want_k7}, {want_vjp}")
    torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    launches = {**RMK.launches, "decode_attn": DAK.launches["decode_attn"],
                "ssd_chunk": SSK.launches["ssd_chunk"]}
    emit({"phase": "dryrun", "part": "done", "card_seconds":
          time.perf_counter() - t1, "launches": launches,
          "plain_vjp_backward": SSK.launches["ssd_chunk_plain_grad"]})
    return {"launches": launches,
            "plain_vjp_backward": SSK.launches["ssd_chunk_plain_grad"]}


def phase_profile() -> dict:
    """``torch.profiler`` over a two-epoch full-width ``frozen`` run (after
    its preload): device time by kernel name and the device's busy share
    of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import cluster as TC

    scfg = TC.ScenarioConfig(n_records=RECORDS_FULL, value_dim=256,
                             epoch_ops=B_FULL, n_epochs=2, read_ratio=0.9,
                             seed=0)
    cfg = TC.ClusterConfig(num_nodes=N_FULL, num_ranges=RANGES_FULL,
                           replication=2, r_max=R_MAX, n_clients=64,
                           report_every=2)
    drv = TC.EpochDriver(
        TC.make_scenario("shifting_hotspot", scfg, theta=1.2, shift_every=2),
        TC.make_policy("frozen"), cfg, fused=True, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {"phase": "profile", "epochs": 2, **_device_summary(prof, wall)}
    emit(out)
    del drv
    torch.cuda.empty_cache()
    return out


def _device_summary(prof, wall: float, top: int = 12) -> dict:
    """A profiler window's device busy time and share of ``wall``, its
    device-side event count (kernels and copies) and the ``top`` events by
    device time."""
    from torch.autograd import DeviceType

    # device-side events only: the operator rows of key_averages() repeat
    # their kernels' time
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and _dev_us(e) > 0]
    events.sort(key=_dev_us, reverse=True)
    busy = sum(_dev_us(e) for e in events) / 1e6
    return {"wall_s": wall, "device_busy_s": busy,
            "device_busy_share": busy / wall,
            "device_events": sum(e.count for e in events),
            "top": [{"name": e.key[:80], "device_ms": _dev_us(e) / 1e3,
                     "calls": e.count} for e in events[:top]]}


def phase_serving_profile(seed: int = 0) -> dict:
    """``torch.profiler`` over the full-width serving engine: two decode
    steps with all 32 slots busy (after a warm-up step), then one prefill
    of 2,048 tokens, each window ending in its logits' copy to the host."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import ServingEngine

    dev = torch.device("cuda")
    cfg = get_config(SERVE_ARCH)
    params = M.init_params(cfg, seed, device=dev)
    eng = ServingEngine(cfg, params, n_slots=SERVE_SLOTS,
                        cache_len=SERVE_CACHE, n_shards=SERVE_SHARDS,
                        device=dev)
    rng = np.random.default_rng(seed)
    for n in rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, SERVE_SLOTS):
        eng.submit(rng.integers(0, cfg.vocab_size, int(n)),
                   max_new_tokens=SERVE_NEW)
    eng.step()                                  # admit all, one decode step
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.step()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    decode = _device_summary(prof, wall)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (1, SERVE_PROMPT[1])),
                          device=dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, _ = M.prefill(params, cfg, {"tokens": tokens},
                              cache_len=SERVE_CACHE)
        logits.float().cpu()
        wall = time.perf_counter() - t0
    out = {"phase": "serving_profile", "decode_steps": 2, "decode": decode,
           "prefill_tokens": SERVE_PROMPT[1],
           "prefill": _device_summary(prof, wall)}
    emit(out)
    del eng, params
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + EXTRA_PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    bad = set(phases) - set(PHASES + EXTRA_PHASES)
    if bad:
        ap.error(f"unknown phases {sorted(bad)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t0 = time.perf_counter()
    seconds: dict[str, float] = {}

    def run(name, fn, *args, **kw):
        if name not in phases and name != "device":
            return None
        ts = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - ts
        return out

    dev_info = run("device", phase_device)   # always: the build is every phase's
    kernels = run("kernels", phase_kernels, grid_study="grid_study" in phases)
    run("parity", phase_parity)
    full = run("full_width", phase_full_width, keep_frozen="dist" in phases)
    ovl = run("overload", phase_overload)
    tel = run("telemetry", phase_telemetry)
    dist = run("dist", phase_dist)
    paper = run("paper", phase_paper)
    benches = run("benches", phase_benches)
    serving = run("serving", phase_serving)
    serving_ssm = run("serving_ssm", phase_serving_ssm)
    families = run("families", phase_families)
    training = run("training", phase_training)
    dryrun = run("dryrun", phase_dryrun)
    if families is not None:      # the five runs' launches as one path
        families = {"launches": {name: sum(f["launches"][name]
                                           for f in families)
                                 for name in families[0]["launches"]}}
    if "profile" in phases:
        phase_profile()
    if "serving_profile" in phases:
        phase_serving_profile()
    if kernels is not None:
        # one row a kernel: K3 as the main path runs it (no key filter), K6
        # at decode_32k and K7 over its 32,768-token prefill; their other
        # cases are in the kernels phase's own lines.  Launches: each main
        # path's count, read after its own run (the epoch driver's
        # full-width runs on both backends, the qwen2 and mamba2 serving
        # runs, the five runs of phase families summed), in
        # launches_by_path; launches is their sum
        if benches is not None:   # the benches, then the demos, as two paths
            benches, examples = ({"launches": benches["launches"]},
                                 {"launches": benches["examples_launches"]})
        else:
            examples = None
        paths = {name: p["launches"] for name, p in
                 (("full_width", full), ("overload", ovl),
                  ("telemetry", tel), ("dist", dist), ("paper", paper),
                  ("benches", benches), ("examples", examples),
                  ("serving", serving),
                  ("serving_ssm", serving_ssm), ("families", families),
                  ("training", training), ("dryrun", dryrun))
                 if p is not None}
        main_rows = [r for r in kernels if not r.get("filter_bits")
                     and r.get("main", True)]
        for row in main_rows:
            row["launches_by_path"] = {name: p.get(row["name"], 0)
                                       for name, p in paths.items()}
            row["launches"] = (sum(row["launches_by_path"].values())
                               if paths else None)
            if row["name"] == "ssd_chunk":
                # K7 has no backward kernel: the backward passes through
                # the plain scan's VJP on the training paths
                row["plain_vjp_backward_by_path"] = {
                    name: p["plain_vjp_backward"] for name, p in
                    (("training", training), ("dryrun", dryrun))
                    if p is not None}
        emit({"kernels": [{k: r[k] for k in (
            "name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "parity", "ms", "device_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms", "plain_vjp_backward_by_path") if k in r}
            for r in main_rows]})
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "phase_seconds": seconds})
    print(dev_info["card"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
