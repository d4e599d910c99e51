"""The CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and ``nvcc`` (they build the kernels at
first use); without a card they skip.  Run them on the GPU machine with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

They import torch and the port only, never jax.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import coordination_tier as CT
from repro_torch.core import directory as D
from repro_torch.core import routing as R
from repro_torch.core import store as S
from repro_torch.core.controller import Controller
from repro_torch.kernels.range_match import kernel as RMK
from repro_torch.kernels.range_match import ops as OPS

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _directory(seed, num_ranges, n_slots, device, num_nodes=8):
    rng = np.random.default_rng(seed)
    ctl = Controller(D.make_directory(num_ranges, num_nodes, 2, r_max=4,
                                      n_slots=n_slots, device=device))
    load = rng.random(num_nodes)
    for _ in range(min(num_ranges // 2, 300)):
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


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize("B", [0, 1, 777, 70000])
@pytest.mark.parametrize("n_slots", [64, 2048, 6000])
def test_route_kernels_match_plain(dev, B, n_slots):
    d = _directory(B + n_slots, n_slots // 2, n_slots, dev)
    rng = np.random.default_rng(B)
    keys = torch.tensor(rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.int64),
                        device=dev)
    ops = torch.tensor(rng.integers(0, 4, B).astype(np.int32), device=dev)
    loads = torch.tensor(rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.int64),
                         device=dev)
    rng_key = np.array([0, B], np.uint32)
    before = dict(RMK.launches)
    got1 = OPS.range_match(d, keys, ops)
    got2 = OPS.range_match_spread(d, keys, ops, loads, rng_key)
    # an empty batch launches nothing and counts nothing
    assert RMK.launches["range_match"] == before["range_match"] + (B > 0)
    assert (RMK.launches["range_match_spread"]
            == before["range_match_spread"] + (B > 0))
    dc = _cpu(d)
    _same(got1, OPS.range_match(dc, keys.cpu(), ops.cpu()))
    _same(got2, OPS.range_match_spread(dc, keys.cpu(), ops.cpu(), loads.cpu(),
                                       rng_key))


def _cpu(d):
    return D.Directory(**{f: getattr(d, f).cpu() for f in (
        "slot_lo", "slot_hi", "live", "chains", "chain_len", "parent",
        "generation", "node_addr", "read_count", "write_count")})


@pytest.mark.parametrize("B", [0, 1, 777, 70000])
@pytest.mark.parametrize("filter_bits", [0, 64])
def test_dirty_route_kernel_matches_plain(dev, B, filter_bits):
    """K3 with and without the hashed key filter."""
    d = _directory(B + 7, 1024, 2048, dev)
    rng = np.random.default_rng(B + filter_bits)
    keys = torch.tensor(rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.int64),
                        device=dev)
    ops = torch.tensor(rng.integers(0, 4, B).astype(np.int32), device=dev)
    loads = torch.tensor(rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.int64),
                         device=dev)
    dirty = torch.tensor(rng.random((2048, 4)) < 0.5, device=dev)
    kf = (torch.tensor(rng.random((2048, filter_bits)) < 0.3, device=dev)
          if filter_bits else None)
    rng_key = np.array([1, B], np.uint32)
    before = RMK.launches["range_match_spread_dirty"]
    got = OPS.range_match_spread_dirty(d, keys, ops, loads, dirty, rng_key,
                                       key_filter=kf)
    assert RMK.launches["range_match_spread_dirty"] == before + (B > 0)
    want = OPS.range_match_spread_dirty(
        _cpu(d), keys.cpu(), ops.cpu(), loads.cpu(), dirty.cpu(), rng_key,
        key_filter=None if kf is None else kf.cpu())
    _same(got, want)
    if B > 1000:
        assert bool(got[4].any())


@pytest.mark.parametrize("B", [0, 777, 70000])
@pytest.mark.parametrize("C", [1, 200, 100_003])
def test_apply_kernel_matches_plain(dev, B, C):
    """K4b: the CRAQ route and the slab probe in one kernel."""
    N = 8
    d = _directory(B + C, 512, 1024, dev)
    rng = np.random.default_rng(B + C)
    slabs = np.full((N, C), 0xFFFFFFFF, np.int64)
    for n in range(N):
        m = int(rng.integers(0, C + 1))
        slabs[n, :m] = np.sort(rng.choice(2**32 - 1, m, replace=False))
    resident = slabs[rng.integers(0, N, B), rng.integers(0, C, B)]
    fresh = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.int64)
    keys = torch.tensor(np.where(rng.random(B) < 0.6, resident, fresh), device=dev)
    ops = torch.tensor(rng.integers(0, 3, B).astype(np.int32), device=dev)
    loads = torch.tensor(rng.integers(0, 50, N), device=dev)
    dirty = torch.tensor(rng.random((1024, 4)) < 0.5, device=dev)
    store_keys = torch.tensor(slabs, device=dev)
    rng_key = np.array([2, B], np.uint32)
    before = RMK.launches["range_match_apply"]
    got = OPS.range_match_apply(d, keys, ops, loads, dirty, store_keys, rng_key)
    assert RMK.launches["range_match_apply"] == before + (B > 0)
    want = OPS.range_match_apply(_cpu(d), keys.cpu(), ops.cpu(), loads.cpu(),
                                 dirty.cpu(), store_keys.cpu(), rng_key)
    _same(got, want)


def test_route_kernel_raises_when_tables_exceed_shared_memory(dev):
    """No fallback: tables larger than a block's shared memory (a slot pool
    grown past them) make the wrapper raise before the launch instead of
    taking the plain path."""
    d = _directory(1, 4000, 10000, dev)
    keys = torch.zeros(16, dtype=torch.int64, device=dev)
    ops = torch.zeros(16, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        OPS.range_match(d, keys, ops)


# ---------------------------------------------------------------------------
# The sorted span table of K1-K4b: tables that take each match pass
# ---------------------------------------------------------------------------

MAX32 = 0xFFFFFFFF

# (case, the pass the route kernels take): malformed tables, whose live
# spans overlap, take the exhaustive pass; the rest the binary search
SPAN_CASES = (
    ("partition", "search"), ("overlap", "exhaustive"),
    ("equal_lo", "exhaustive"), ("single_keys", "search"),
    ("full_space", "search"), ("full_space_overlap", "exhaustive"),
    ("gaps", "search"), ("all_dead", "search"),
    ("hits_past_num_slots", "search"),
    ("overlap_past_num_slots", "exhaustive"), ("top_key", "search"),
)


def span_table(case, S=64, seed=0):
    """uint32 ``(lo, hi)`` numpy spans of S slots, dead slots as ``lo =
    MAX32 > hi = 0``, and ``num_slots``, for a case of ``SPAN_CASES``."""
    rng = np.random.default_rng(seed)
    n = S // 2 + 3                                  # live spans
    cuts = np.sort(rng.choice(MAX32, n - 1, replace=False))
    p_lo = np.concatenate([[0], cuts + 1])
    p_hi = np.concatenate([cuts, [MAX32]])         # a partition of [0, MAX32]
    lo = np.full(S, MAX32, np.uint64)
    hi = np.zeros(S, np.uint64)
    slots = rng.permutation(S)[:n]
    num_slots = S
    if case in ("partition", "hits_past_num_slots", "top_key"):
        lo[slots], hi[slots] = p_lo, p_hi
        if case == "hits_past_num_slots":
            num_slots = S // 3
        if case == "top_key":   # a single-key span at the top of the space
            hi[slots[-1]] = MAX32 - 1
            lo[slots[0]], hi[slots[0]] = MAX32, MAX32
            lo[slots[1]], hi[slots[1]] = 0, 0
    elif case in ("overlap", "overlap_past_num_slots"):
        lo[slots] = rng.integers(0, MAX32, n, dtype=np.uint64)
        hi[slots] = np.minimum(lo[slots] + rng.integers(0, 2**30, n).astype(
            np.uint64), MAX32)
        if case == "overlap_past_num_slots":
            num_slots = S // 2
    elif case == "equal_lo":
        lo[slots], hi[slots] = p_lo, p_hi
        # a second span from the same lo: the lower slot id wins
        spare = np.setdiff1d(np.arange(S), slots)[:2]
        lo[spare] = p_lo[[3, n - 1]]
        hi[spare] = p_lo[[3, n - 1]] + np.array([5, 0], np.uint64)
    elif case == "single_keys":
        lo[slots] = hi[slots] = np.sort(rng.choice(MAX32 + 1, n, replace=False))
    elif case == "full_space":
        lo[slots[0]], hi[slots[0]] = 0, MAX32
    elif case == "full_space_overlap":
        lo[slots], hi[slots] = p_lo, p_hi
        lo[S // 2], hi[S // 2] = 0, MAX32
    elif case == "gaps":
        lo[slots], hi[slots] = p_lo, p_lo + (p_hi - p_lo) // 2
    elif case != "all_dead":
        raise ValueError(case)
    return lo, hi, num_slots


def span_values(lo, hi, B, seed=0):
    """B uint64 matching values: the spans' edges and their neighbours, 0
    and MAX32, the rest uniform."""
    live = lo <= hi
    edges = np.concatenate([lo[live], hi[live], (lo[live] - 1) & MAX32,
                            (hi[live] + 1) & MAX32, [0, MAX32]])
    rng = np.random.default_rng(seed + 1)
    return np.concatenate([edges, rng.integers(0, MAX32 + 1, B - len(edges),
                                               dtype=np.uint64)])[:B]


def _route_inputs(lo, hi, B, dev, seed=0, n_nodes=8, r_max=4, F=64, C=300):
    """Every route kernel's inputs over the uint32 spans ``lo`` / ``hi``:
    random chains (some empty), chain lengths 0 to r_max, loads, dirty
    bits, a key filter and slabs that hold some of the values."""
    rng = np.random.default_rng(seed)
    S = len(lo)
    t = lambda a, dt=None: torch.tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
    mvals = span_values(lo, hi, B, seed).astype(np.int64)
    slabs = np.full((n_nodes, C), MAX32, np.int64)
    for n in range(n_nodes):
        m = int(rng.integers(1, C + 1))
        slabs[n, :m] = np.unique(np.concatenate(
            [rng.choice(mvals, m // 2), rng.integers(0, MAX32, m)]))[:m]
        slabs[n].sort()
    return dict(
        mvals=t(mvals), opcodes=t(rng.integers(0, 4, B), torch.int32),
        u1=t(rng.integers(0, 2**31 - 1, B), torch.int32),
        u2=t(rng.integers(0, 2**31 - 1, B), torch.int32),
        lo=OPS.to_i32_bits(t(lo.astype(np.int64))),
        hi=OPS.to_i32_bits(t(hi.astype(np.int64))),
        chains=t(rng.integers(-1, n_nodes, (r_max, S)), torch.int32),
        clen=t(rng.integers(0, r_max + 1, S), torch.int32),
        loads=OPS.to_i32_bits(t(rng.integers(0, MAX32, n_nodes,
                                             dtype=np.uint64).astype(np.int64))),
        dirty=t(rng.random((r_max, S)) < 0.5, torch.uint8),
        kf=t(rng.random((S, F)) < 0.3), slabs=t(slabs))


def _route_calls(x, num_slots):
    """(wrapper name, kernel call, plain call) of K1, K2, K3 without and
    with the key filter, and K4b on ``_route_inputs``."""
    from repro_torch.kernels.range_match import ref as REF

    tail = (x["mvals"], x["opcodes"])
    spread = tail + (x["u1"], x["u2"])
    tables = (x["lo"], x["hi"], x["chains"], x["clen"])
    dirty = spread + tables + (x["loads"], x["dirty"])
    kw = dict(num_slots=num_slots)
    return (
        ("range_match", lambda: RMK.range_match(*tail, *tables, **kw),
         lambda: REF.range_match_ref(*tail, *tables, **kw)),
        ("range_match_spread",
         lambda: RMK.range_match_spread(*spread, *tables, x["loads"], **kw),
         lambda: REF.range_match_spread_ref(*spread, *tables, x["loads"], **kw)),
        ("range_match_spread_dirty",
         lambda: RMK.range_match_spread_dirty(*dirty, **kw),
         lambda: REF.range_match_spread_dirty_ref(*dirty, **kw)),
        ("range_match_spread_dirty",
         lambda: RMK.range_match_spread_dirty(*dirty, x["mvals"], x["kf"], **kw),
         lambda: REF.range_match_spread_dirty_ref(*dirty, x["mvals"], x["kf"],
                                                  **kw)),
        ("range_match_apply",
         lambda: RMK.range_match_apply(*dirty, x["mvals"], x["slabs"], **kw),
         lambda: REF.range_match_apply_ref(*dirty, x["mvals"], x["slabs"], **kw)),
    )


def _check_route_calls(x, num_slots, want_match):
    """Each route kernel bitwise against its plain version, the pass its
    route kernel took, and its sorted span table against the plain one."""
    from repro_torch.kernels.range_match import ref as REF

    slo, shi, sid = REF.span_order_ref(x["lo"].cpu(), x["hi"].cpu())
    for name, call, plain in _route_calls(x, num_slots):
        before = RMK.launches[name]
        got = call()
        assert RMK.launches[name] == before + 1
        _same(got, plain())
        order = RMK.last_order(name)
        assert order["match"] == want_match, name
        assert order["n_live"] == len(sid)
        for a, b in ((order["lo"], slo), (order["hi"], shi), (order["id"], sid)):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("S", [64, 1000])
@pytest.mark.parametrize("case,match", SPAN_CASES)
def test_route_kernels_on_span_tables(dev, case, match, S):
    """K1, K2, K3 (with and without the filter) and K4b on tables that
    take each match pass: overlapping spans, equal lo, single-key spans,
    the full key space alone and over a partition, gaps (total misses),
    every slot dead, hits at slot ids at and past ``num_slots``, and the
    values 0 and 2**32 - 1 at the edges of the space; over 64 slots, which
    each route block orders itself, and over 1,000, which span_order
    orders."""
    lo, hi, num_slots = span_table(case, S, seed=len(case))
    _check_route_calls(_route_inputs(lo, hi, 5000, dev, seed=len(case)),
                       num_slots, match)


@pytest.mark.parametrize("n_slots", [64, 2048, 6000])
def test_route_kernels_search_directories(dev, n_slots):
    """Controller-built directories (after splits, widens and merges) take
    the binary search in every route kernel, up to 6,000 slots."""
    d = _directory(n_slots, n_slots // 2, n_slots, dev)
    lo, hi, _, _ = OPS.pack_tables(d)
    u32 = lambda t: (t.cpu().numpy().astype(np.int64) & MAX32).astype(np.uint64)  # noqa: E731
    x = _route_inputs(u32(lo), u32(hi), 70000, dev, seed=n_slots)
    x["chains"], x["clen"] = OPS.pack_tables(d)[2:]
    _check_route_calls(x, d.num_slots, "search")


@pytest.mark.parametrize("n_slots", [32, 2048])
def test_route_kernel_in_cuda_graph(dev, n_slots):
    """K1 captured in a CUDA graph, in one launch (32 slots) and in two
    (span_order first, 2,048 slots): its kernels and its scratch (from
    PyTorch's allocator) replay to the eager call's outputs bit for bit,
    and a replay reads the inputs as they are then."""
    d = _directory(3, n_slots // 2, n_slots, dev)
    lo, hi, chains, clen = OPS.pack_tables(d)
    rng = np.random.default_rng(3)
    mvals = torch.tensor(rng.integers(0, 2**32, 70000, dtype=np.uint64)
                         .astype(np.int64), device=dev)
    ops = torch.tensor(rng.integers(0, 4, 70000).astype(np.int32), device=dev)
    call = lambda: RMK.range_match(mvals, ops, lo, hi, chains, clen,  # noqa: E731
                                   num_slots=d.num_slots)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for shift in (0, 12345):
        mvals.add_(shift).bitwise_and_(MAX32)
        eager = call()
        graph.replay()
        torch.cuda.synchronize()
        _same(out, eager)


def test_route_kernel_refuses_more_slots_than_ids(dev):
    """Slot ids are staged as 16 bits: the wrappers refuse more than 65,535
    slots before launching anything."""
    S = 1 << 16
    z = lambda n, dt=torch.int32: torch.zeros(n, dtype=dt, device=dev)  # noqa: E731
    before = RMK.launches["range_match"]
    with pytest.raises(ValueError, match="16-bit"):
        RMK.range_match(z(4, torch.int64), z(4), z(S), z(S),
                        torch.zeros((1, S), dtype=torch.int32, device=dev),
                        z(S), num_slots=S)
    assert RMK.launches["range_match"] == before


def _coord_state(d, W, device, seed):
    """A W-switch tier state over ``d``'s tables, perturbed as the
    reference's kernel test perturbs it: divergent versions on two
    switches, rotated chains on one, a dead row retired on one switch
    only, a shifted bound, and chain length 0 on some rows."""
    tables = {f: getattr(d, f).cpu().numpy()
              for f in ("slot_lo", "slot_hi", "live", "chains", "chain_len")}
    c = CT.make_state(tables, W, device=device)
    rng = np.random.default_rng(seed)
    ver = c.version.clone()
    ver[1 % W, ::2] = 7
    ver[W - 1, :] = 3
    ch = c.chains.clone()
    ch[1 % W] = torch.where(ch[1 % W] >= 0, (ch[1 % W] + 1) % 8, ch[1 % W])
    lv = c.live.clone()
    lv[2 % W, int(torch.nonzero(lv[0])[0])] = False
    lo = c.slot_lo.clone()
    lo[W - 1, 0] += 3
    cl = c.chain_len.clone()
    cl[:, torch.tensor(rng.random(cl.shape[1]) < 0.05, device=device)] = 0
    return dataclasses.replace(c, version=ver, chains=ch, live=lv, slot_lo=lo,
                               chain_len=cl)


@pytest.mark.parametrize("B,n_slots", [(0, 64), (777, 64), (65536, 2048)])
@pytest.mark.parametrize("hash_partitioned", [False, True])
def test_stale_kernel_matches_plain(dev, B, n_slots, hash_partitioned):
    """K5 at a small shape and at the full-width one (W = 4, S = 2,048,
    r_max = 4, B = 65,536)."""
    d = _directory(B + n_slots, n_slots // 2, n_slots, dev)
    coord = _coord_state(d, 4, dev, B)
    rng = np.random.default_rng(B + 1)
    keys = torch.tensor(rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.int64),
                        device=dev)
    ops = torch.tensor(rng.integers(0, 4, B).astype(np.int32), device=dev)
    before = RMK.launches["range_match_stale"]
    got = OPS.range_match_stale(coord, keys, ops,
                                hash_partitioned=hash_partitioned)
    assert RMK.launches["range_match_stale"] == before + (B > 0)
    cpu = CT.CoordState(*(getattr(coord, f.name).cpu()
                          for f in dataclasses.fields(CT.CoordState)))
    want = OPS.range_match_stale(cpu, keys.cpu(), ops.cpu(),
                                 hash_partitioned=hash_partitioned)
    _same(got, want)
    if B > 1000:
        assert bool(got[2].any()) and not bool(got[2].all())


def test_stale_kernel_raises_when_spans_exceed_shared_memory(dev):
    """8 W S + 4 W bytes of staged spans and copy words over the opt-in
    limit: the wrapper raises instead of taking the plain path."""
    W, S = 8, 4096
    args = [torch.zeros(16, dtype=torch.int64, device=dev),
            torch.zeros(16, dtype=torch.int32, device=dev)]
    tables = [torch.zeros((W, S), dtype=torch.int32, device=dev)] * 2 + [
        torch.zeros((W * 4, S), dtype=torch.int32, device=dev),
        torch.ones((W, S), dtype=torch.int32, device=dev),
        torch.zeros((W, S), dtype=torch.int32, device=dev),
        torch.zeros(S, dtype=torch.int32, device=dev)]
    before = RMK.launches["range_match_stale"]
    with pytest.raises(ValueError, match="shared memory"):
        RMK.range_match_stale(*args, *tables, num_slots=S)
    assert RMK.launches["range_match_stale"] == before


# ---------------------------------------------------------------------------
# K5 over a sorted span table per switch copy
# ---------------------------------------------------------------------------

# switch copies mixed from SPAN_CASES, covering all eleven: each copy takes
# its own case's pass, so a disjoint copy beside an overlapping or an
# all-dead one keeps the binary search
STALE_MIXES = (
    ("partition", "overlap", "all_dead"),
    ("equal_lo", "single_keys", "full_space_overlap", "gaps"),
    ("top_key", "full_space", "overlap_past_num_slots", "hits_past_num_slots"),
    ("overlap", "partition"),
)
SPAN_PASS = dict(SPAN_CASES)


def stale_tables(cases, S, seed=0, n_nodes=8, r_max=4):
    """Switch tables as a tier state holds them (numpy: uint32 spans and
    versions, chains (W, S, r_max)), copy ``w``'s spans from
    ``span_table(cases[w], S)``, random chains of length 0 to r_max and
    versions equal to the committed one on about half the slots; and
    ``num_slots``, the least of the cases'."""
    rng = np.random.default_rng(seed)
    W = len(cases)
    spans = [span_table(c, S, seed=seed + len(c) + w)
             for w, c in enumerate(cases)]
    lo = np.stack([sp[0] for sp in spans]).astype(np.uint32)
    hi = np.stack([sp[1] for sp in spans]).astype(np.uint32)
    committed = rng.integers(0, MAX32 + 1, S, dtype=np.uint64).astype(np.uint32)
    version = np.where(rng.random((W, S)) < 0.5, committed,
                       committed ^ np.uint32(1)).astype(np.uint32)
    return dict(
        slot_lo=lo, slot_hi=hi, live=lo <= hi,
        chains=rng.integers(-1, n_nodes, (W, S, r_max)).astype(np.int32),
        chain_len=rng.integers(0, r_max + 1, (W, S)).astype(np.int32),
        version=version, committed=committed,
    ), min(sp[2] for sp in spans)


def stale_keys(tables, B, seed=0):
    """B raw keys, the edges of every copy's spans and their neighbours
    first, the rest uniform; and B opcodes (GET, PUT, DEL, SCAN)."""
    keys = span_values(tables["slot_lo"].reshape(-1).astype(np.uint64),
                       tables["slot_hi"].reshape(-1).astype(np.uint64), B, seed)
    ops = np.random.default_rng(seed + 2).integers(0, 4, B).astype(np.int32)
    return keys.astype(np.int64), ops


def stale_packed(tables, dev):
    """K5's packed tables (``ops.pack_coord_tables``) of ``stale_tables``'s
    numpy tables, on ``dev``."""
    from types import SimpleNamespace

    return OPS.pack_coord_tables(SimpleNamespace(**{
        k: torch.tensor(v.astype(np.int64) if v.dtype == np.uint32 else v,
                        device=dev) for k, v in tables.items()}))


def _check_stale_order(lo_w, hi_w, want_passes):
    """K5's last W sorted tables against ``span_order_ref`` copy by copy,
    and the pass each copy took."""
    from repro_torch.kernels.range_match import ref as REF

    order = RMK.last_stale_order()
    assert [c["match"] for c in order] == list(want_passes)
    for w, c in enumerate(order):
        slo, shi, sid = REF.span_order_ref(lo_w[w].cpu(), hi_w[w].cpu())
        assert c["n_live"] == len(sid)
        for a, b in ((c["lo"], slo), (c["hi"], shi), (c["id"], sid)):
            assert torch.equal(a, b), w


@pytest.mark.parametrize("S", [64, 1000, 1001, 2048])
@pytest.mark.parametrize("cases", STALE_MIXES, ids="-".join)
def test_stale_kernel_on_mixed_copies(dev, cases, S):
    """K5 bitwise against its plain version over switch copies that take
    different passes, each copy's pass and sorted table read back, and the
    plain mirror of the kernel's algorithm on the same inputs.  With an odd
    S the odd copies' tables lie off a 16-byte boundary in the scratch, so
    their staging takes 4-byte copies."""
    from repro_torch.kernels.range_match import ref as REF

    tables, num_slots = stale_tables(cases, S, seed=S)
    keys, ops = stale_keys(tables, 70000, seed=S)
    k = torch.tensor(keys, device=dev)
    o = torch.tensor(ops, device=dev)
    packed = stale_packed(tables, dev)
    before = RMK.launches["range_match_stale"]
    got = RMK.range_match_stale(k, o, *packed, num_slots=num_slots)
    assert RMK.launches["range_match_stale"] == before + 1
    want = REF.range_match_stale_ref(k, o, *packed, num_slots=num_slots)
    _same(got, want)
    mirror, passes = REF.stale_sorted_match_ref(k, o, *packed,
                                                num_slots=num_slots)
    _same(mirror, want)
    assert passes == [SPAN_PASS[c] for c in cases]
    _check_stale_order(packed[0], packed[1], passes)


@pytest.mark.parametrize("n_slots", [64, 2048, 6000])
def test_stale_kernel_searches_controller_copies(dev, n_slots):
    """The four perturbed switch copies of controller-built directories
    (rotated chains, a retired row, a shifted bound, chain length 0) each
    take the binary search; 6,000 slots at W = 4 (192,016 B of staged
    spans and copy words) launch."""
    d = _directory(n_slots + 1, n_slots // 2, n_slots, dev)
    coord = _coord_state(d, 4, dev, n_slots)
    packed = OPS.pack_coord_tables(coord)
    lo, hi = (t.cpu().numpy().astype(np.int64) & MAX32 for t in packed[:2])
    keys, ops = stale_keys({"slot_lo": lo, "slot_hi": hi}, 70000, seed=n_slots)
    k = torch.tensor(keys, device=dev)
    o = torch.tensor(ops, device=dev)
    from repro_torch.kernels.range_match import ref as REF

    got = OPS.range_match_stale(coord, k, o)
    _same(got, REF.range_match_stale_ref(k, o, *packed, num_slots=n_slots))
    _check_stale_order(packed[0], packed[1], ["search"] * 4)


def test_stale_kernel_in_cuda_graph(dev):
    """K5 captured in a CUDA graph (span_order over the four copies, then
    the search kernel, over a scratch from PyTorch's allocator) replays to
    the eager call's outputs bit for bit, and reads the inputs as they are
    at the replay."""
    d = _directory(5, 1024, 2048, dev)
    coord = _coord_state(d, 4, dev, 5)
    packed = OPS.pack_coord_tables(coord)
    rng = np.random.default_rng(5)
    keys = torch.tensor(rng.integers(0, 2**32, 70000, dtype=np.uint64)
                        .astype(np.int64), device=dev)
    ops = torch.tensor(rng.integers(0, 4, 70000).astype(np.int32), device=dev)
    call = lambda: RMK.range_match_stale(keys, ops, *packed,  # noqa: E731
                                         num_slots=d.num_slots)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for shift in (0, 12345):
        keys.add_(shift).bitwise_and_(MAX32)
        eager = call()
        graph.replay()
        torch.cuda.synchronize()
        _same(out, eager)


def test_stale_kernel_refuses_more_slots_than_ids(dev):
    """K5 stages 16-bit slot ids too: over 65,535 slots it raises before
    launching anything."""
    S = 1 << 16
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)  # noqa: E731
    before = RMK.launches["range_match_stale"]
    with pytest.raises(ValueError, match="16-bit"):
        RMK.range_match_stale(torch.zeros(4, dtype=torch.int64, device=dev),
                              z(4), z(1, S), z(1, S), z(4, S), z(1, S),
                              z(1, S), z(S), num_slots=S)
    assert RMK.launches["range_match_stale"] == before


@pytest.mark.parametrize("C", [1, 200, 100_003])
def test_slab_lookup_matches_plain(dev, C):
    rng = np.random.default_rng(C)
    N, B = 5, 40_000
    slabs = np.full((N, C), 0xFFFFFFFF, np.int64)
    for n in range(N):
        m = int(rng.integers(0, C + 1))
        slabs[n, :m] = np.sort(rng.choice(2**32 - 1, m, replace=False))
    target = rng.integers(-1, N, B)
    resident = slabs[np.clip(target, 0, N - 1), rng.integers(0, C, B)]
    fresh = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.int64)
    q = np.where(rng.random(B) < 0.6, resident, fresh)
    args = [torch.tensor(a, device=dev) for a in (q, target, slabs)]
    got = OPS.slab_lookup(*args)
    want = OPS.slab_lookup(*(a.cpu() for a in args))
    _same(got, want)


def _edge_slabs(rng, N, C, empty_rows=()):
    slabs = np.full((N, C), 0xFFFFFFFF, np.int64)
    for n in range(N):
        if n in empty_rows:
            continue
        keys = np.unique(rng.integers(0, 2**32 - 1, int(rng.integers(1, C + 1))))
        slabs[n, :len(keys)] = keys
    return slabs


@pytest.mark.parametrize("N,C", [
    (8, 1), (8, 2), (8, 7), (8, 1023), (8, 1024), (8, 1025),
    (8, 100_003), (1000, 5000), (5000, 300)])
@pytest.mark.parametrize("B", [1, 20_000, 150_000])
def test_slab_lookup_edges(dev, N, C, B):
    """K4a at the edges of its search: C 1 and 2, rows one short of, equal
    to and one over a power of two, C 100,003, many rows (N 1,000 and
    5,000), an all-EMPTY row, targets -1 and >= N, keys at every 1,024th
    slot and their neighbours, and more packets than one thread a packet
    of a full card (B 150,000)."""
    rng = np.random.default_rng(N + C + B)
    slabs = _edge_slabs(rng, N, C, empty_rows=(0,))
    target = rng.integers(-1, N + 2, B)
    rows = np.clip(target, 0, N - 1)
    stride_keys = slabs[rows, (rng.integers(0, -(-C // 1024), B) << 10)]
    resident = slabs[rows, rng.integers(0, C, B)]
    fresh = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.int64)
    pick = rng.integers(0, 5, B)
    q = np.select([pick == 0, pick == 1, pick == 2, pick == 3],
                  [stride_keys, stride_keys - 1, stride_keys + 1, resident],
                  fresh)
    args = [torch.tensor(a, device=dev) for a in (q, target, slabs)]
    before = RMK.launches["slab_lookup"]
    got = OPS.slab_lookup(*args)
    assert RMK.launches["slab_lookup"] == before + 1
    _same(got, OPS.slab_lookup(*(a.cpu() for a in args)))
    if B > 1:
        assert bool(got[1].any())


def test_pareto_service_card_matches_cpu(dev):
    """The Pareto service draw (ROADMAP F5): the card's column equals the
    CPU's bit for bit, and both equal the reference's draws, recorded here
    as the SHA-256 of their float32 bytes (computed with
    ``repro.core.ServiceModel``, PRNGKey(8), shape (4096, 3))."""
    import hashlib

    from repro_torch import prng
    from repro_torch.core import coordination as TCo

    recorded = {
        2.2: "a2167379024dfe7bc9fb98724af88494bde7f219b23e6956b48c65c685dd66b7",
        1.5: "4e1e4f108ff263c2ab94fee91bf0be95f6de83f9b060ed681787dc5deb73db89",
    }
    for alpha, digest in recorded.items():
        svc = TCo.ServiceModel(kind="pareto", alpha=alpha)
        card = svc.draw(prng.PRNGKey(8), (4096, 3), dev)
        cpu = svc.draw(prng.PRNGKey(8), (4096, 3), "cpu")
        assert card.device.type == "cuda" and card.dtype == torch.float32
        assert torch.equal(card.cpu().view(torch.int32), cpu.view(torch.int32))
        assert hashlib.sha256(card.cpu().numpy().tobytes()).hexdigest() == digest


def test_apply_routed_card_matches_cpu(dev):
    N, V, C, B = 6, 4, 96, 512
    out = {}
    for device in (dev, torch.device("cpu")):
        d = _directory(5, 12, 24, device, num_nodes=N)
        store = S.make_store(N, C, V, device=device)
        resps = []
        for step in range(3):
            r = np.random.default_rng(step)
            keys = r.integers(0, 2**32 - 2, B, dtype=np.uint64).astype(np.uint32)
            ops = (np.ones(B, np.int32) if step == 0
                   else r.integers(0, 4, B).astype(np.int32))
            ends = np.minimum(keys.astype(np.uint64) + 2**28, 2**32 - 2)
            q = R.make_queries(keys, ops, r.normal(size=(B, V)).astype(np.float32),
                               ends.astype(np.uint32), device=device)
            dec, d = R.route(d, q)
            store, resp = S.apply_routed(store, q, dec, max_scan_results=4)
            resps.append(resp)
        out[device.type] = (store, resps)
    (sg, rg), (sc, rc) = out["cuda"], out["cpu"]
    _same((sg.keys, sg.values, sg.overflow), (sc.keys, sc.values, sc.overflow))
    for a, b in zip(rg, rc):
        _same((a.value, a.found, a.scan_values, a.scan_keys, a.scan_count),
              (b.value, b.found, b.scan_values, b.scan_keys, b.scan_count))
    assert int(sg.overflow.sum()) > 0


# ---------------------------------------------------------------------------
# The sharded data plane and the lognormal draw on the card
# ---------------------------------------------------------------------------

# (strategy, read_spread, craq, queue_pen) of the dist-plane comparison
DIST_CASES = (("bucket_a2a", False, False, False),
              ("bucket_a2a", True, False, False),
              ("bucket_a2a", True, True, True),
              ("allgather", False, False, False),
              ("allgather", True, True, False))


@pytest.mark.parametrize("strategy,spread,craq,qpen", DIST_CASES)
def test_dist_plane_card_matches_cpu(dev, strategy, spread, craq, qpen):
    """``make_dist_apply`` at B 65,536 on an 8-shard mesh, card against
    CPU, bit for bit over three calls (a preload of PUTs, then mixed
    batches with every opcode): responses, store, counters, load
    registers and metrics.  The bucket plane routes shard by shard under
    p2c (8 launches of K2 / K3 a call) and probes each round's inbound
    queries in one launch of K4a (1 + r_max a call: the directory's
    widened chains reach r_max)."""
    from repro_torch import replication as RPL
    from repro_torch.core import dist_store as DS

    N, V, C, B = 8, 4, 131072, 65536
    cfg = DS.DistConfig(strategy=strategy, bucket_cap=B // N,
                        read_spread=spread, return_decision=True,
                        replication_mode="craq" if craq else "eventual",
                        queue_pen=qpen)
    out = {}
    for device in (dev, torch.device("cpu")):
        d = _directory(7, 64, 128, device, num_nodes=N)
        store = S.make_store(N, C, V, device=device)
        f = DS.make_dist_apply(DS.make_mesh(N, device=device), d, cfg)
        load = torch.zeros(N, dtype=torch.int64, device=device)
        dirty = RPL.dirty_bits(RPL.make_state(128, 4, 0, device=device))
        calls = []
        RMK.reset_launches()
        for step in range(3):
            r = np.random.default_rng(step)
            keys = r.integers(0, 2**32 - 2, B, dtype=np.uint64).astype(np.uint32)
            ops = (np.ones(B, np.int32) if step == 0
                   else r.integers(0, 4, B).astype(np.int32))
            ends = np.minimum(keys.astype(np.uint64) + 2**24, 2**32 - 2)
            q = R.make_queries(keys, ops, r.normal(size=(B, V)).astype(np.float32),
                               ends.astype(np.uint32), device=device)
            if spread:
                args = [store, d, load]
                if qpen:
                    args.append(torch.tensor(r.integers(0, 2**32, N),
                                             device=device))
                if craq:
                    dirty = torch.tensor(r.random(dirty.shape) < 0.3,
                                         device=device)
                    args.append(dirty)
                store, resp, d, load, m = f(*args, q,
                                            np.array([0, step], np.uint32))
            else:
                store, resp, d, m = f(store, d, q)
            calls.append((resp, dict(m), d.read_count, d.write_count,
                          load.clone(), store.keys.clone(),
                          store.values.clone(), store.overflow.clone()))
        out[device.type] = (calls, dict(RMK.launches))
    (cg, lg), (cc, _) = out["cuda"], out["cpu"]
    for a, b in zip(cg, cc):
        ra, rb = a[0], b[0]
        _same((ra.value, ra.found, ra.scan_values, ra.scan_keys, ra.scan_count),
              (rb.value, rb.found, rb.scan_values, rb.scan_keys, rb.scan_count))
        assert a[1].keys() == b[1].keys()
        _same([a[1][k] for k in sorted(a[1])], [b[1][k] for k in sorted(b[1])])
        _same(a[2:], b[2:])
    bucket = strategy == "bucket_a2a"
    assert lg["slab_lookup"] == 3 * (1 + 4 if bucket else 1)
    route = ("range_match_spread_dirty" if craq else
             "range_match_spread" if spread else "range_match")
    assert lg[route] == 3 * (N if bucket and spread else 1)
    assert int(cg[-1][-1].sum()) == 0        # room for every write


def test_dist_read_round_is_one_slab_lookup_launch(dev):
    """A read round's inbound queries from all 8 shards against the
    stacked (8, C) slabs: one launch of K4a, equal to its plain version
    (slots, hits, gathered values)."""
    rng = np.random.default_rng(5)
    N, M, C, V = 8, 65536, 131072, 2
    keys = np.sort(rng.integers(0, 2**32 - 1, (N, C), dtype=np.uint64), axis=1)
    keys[:, C - 1000:] = 0xFFFFFFFF
    pick = rng.integers(0, C, (N, M))
    qk = np.take_along_axis(keys, pick, axis=1).astype(np.int64)
    qk[:, ::4] = rng.integers(0, 2**32 - 1, (N, M // 4))
    op = rng.integers(0, 4, (N, M)).astype(np.int32)
    vals = rng.normal(size=(N, C, V)).astype(np.float32)
    got = {}
    for device in (dev, torch.device("cpu")):
        t = lambda a: torch.tensor(a, device=device)
        store = S.StoreState(t(keys.astype(np.int64)), t(vals),
                             torch.zeros(N, dtype=torch.int64, device=device))
        q = R.QueryBatch(t(op), t(qk),
                         torch.zeros((N, M), dtype=torch.int64, device=device),
                         torch.zeros((N, M, V), device=device))
        every = torch.ones((N, M), dtype=torch.bool, device=device)
        before = RMK.launches["slab_lookup"]
        r = S.shards_read(store, q, every, max_scan_results=2, scans=False,
                          del_mine=every)
        got[device.type] = (r.value, r.found,
                            RMK.launches["slab_lookup"] - before)
    assert got["cuda"][2] == 1 and got["cpu"][2] == 0
    _same(got["cuda"][:2], got["cpu"][:2])
    assert bool(got["cuda"][1].any())


def test_lognormal_service_card_matches_cpu(dev):
    """The lognormal draw: the port's reproductions of XLA's float32 log1p
    and exp (``prng.log1p_f32`` / ``exp_f32``, float32 steps and exact
    fused multiply-adds) give the card the CPU's column bit for bit."""
    from repro_torch import prng
    from repro_torch.core import coordination as TCo

    for sigma in (0.6, 1.0):
        svc = TCo.ServiceModel(kind="lognormal", sigma=sigma)
        card = svc.draw(prng.PRNGKey(3), (200_000,), dev)
        cpu = svc.draw(prng.PRNGKey(3), (200_000,), "cpu")
        assert card.device.type == "cuda" and card.dtype == torch.float32
        ulps = (card.cpu().view(torch.int32).to(torch.int64)
                - cpu.view(torch.int32).to(torch.int64)).abs()
        assert int(ulps.max()) == 0, (sigma, int((ulps > 0).sum()))
        assert abs(float(card.mean()) - 1.0) < 0.02


# ---------------------------------------------------------------------------
# The overload plane on the card
# ---------------------------------------------------------------------------

# (queue_cap, service_rate, inflation): the full-width phase's knobs, and
# a tight queue that sheds, escalates and loses
OVL_CASES = ((6144, 10240, 3.0), (512, 256, 3.0))


@pytest.mark.parametrize("cap,rate,inflation", OVL_CASES)
def test_overload_step_card_matches_cpu(dev, cap, rate, inflation):
    """``overload.step`` at B 65,536, N 10 (the full-width phase's shape):
    every output of every epoch and the final state equal the CPU's bit for
    bit, after admission probabilities and retry budgets below their
    defaults on some nodes."""
    from repro_torch import overload as OVL
    from repro_torch import prng

    B, N = 65536, 10
    cfg = OVL.OverloadConfig(queue_cap=cap, service_rate=rate,
                             inflation=inflation, max_level=3,
                             backoff_base=1, jitter_span=2, queue_weight=2)
    rng = np.random.default_rng(3)
    states = {d: OVL.make_state(N, cfg, device=d) for d in ("cuda", "cpu")}
    ap = np.where(np.arange(N) % 3 == 0, 0.7, 1.0).astype(np.float32)
    rb = np.where(np.arange(N) % 2 == 0, 128, 2**30).astype(np.int32)
    for d in states:
        states[d] = dataclasses.replace(
            states[d], admit_prob=torch.tensor(ap, device=d),
            retry_budget=torch.tensor(rb, device=d))
    shed = 0
    for e in range(6):
        # a hot node and a dead-chain share, like a failed rack
        t = np.where(rng.random(B) < 0.4, 0, rng.integers(-1, N, B))
        outs = {}
        for d in states:
            states[d], *outs[d] = OVL.step(
                states[d], torch.tensor(t, device=d),
                prng.fold_in(prng.PRNGKey(9), e), cfg)
        _same(outs["cuda"], outs["cpu"])
        shed += int(outs["cpu"][3][3])
    for f in dataclasses.fields(OVL.OverloadState):
        a, b = getattr(states["cuda"], f.name), getattr(states["cpu"], f.name)
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), f.name
    assert OVL.conservation_gap(states["cuda"]) == 0
    assert shed > 0


def test_queue_pen_wrap_card_matches_cpu(dev):
    """K2 and K3 with a ``queue_pen`` that makes the effective loads wrap
    past 2**32 (the fold sits in the wrapper): each kernel launches and
    equals its plain version fed the same folded registers."""
    from repro_torch import prng

    B, N = 65536, 10
    d = _directory(11, 1024, 2048, dev, num_nodes=N)
    rng = np.random.default_rng(12)
    keys = torch.tensor(rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.int64),
                        device=dev)
    ops = torch.tensor(np.where(rng.random(B) < 0.9, 0, 1).astype(np.int32),
                       device=dev)
    loads = torch.tensor((2**32 - rng.integers(1, 4000, N)).astype(np.int64),
                         device=dev)
    pen = torch.tensor(rng.integers(0, 8000, N).astype(np.int64), device=dev)
    assert bool(((loads + pen) >= 2**32).any())
    dirty = torch.tensor(rng.random((2048, 4)) < 0.3, device=dev)
    key = prng.PRNGKey(5)
    before = dict(RMK.launches)
    got2 = OPS.range_match_spread(d, keys, ops, loads, key, queue_pen=pen)
    got3 = OPS.range_match_spread_dirty(d, keys, ops, loads, dirty, key,
                                        queue_pen=pen)
    assert RMK.launches["range_match_spread"] == before["range_match_spread"] + 1
    assert (RMK.launches["range_match_spread_dirty"]
            == before["range_match_spread_dirty"] + 1)
    dc = _cpu(d)
    args = (keys.cpu(), ops.cpu(), loads.cpu())
    _same(got2, OPS.range_match_spread(dc, *args, key, queue_pen=pen.cpu()))
    _same(got3, OPS.range_match_spread_dirty(dc, *args, dirty.cpu(), key,
                                             queue_pen=pen.cpu()))
    # the penalty changed picks against the unpenalized call
    plain2 = OPS.range_match_spread(dc, *args, key)
    assert not torch.equal(got2[1].cpu(), plain2[1])


# ---------------------------------------------------------------------------
# The trace and metrics planes on the card
# ---------------------------------------------------------------------------

# (scenario, policy, cluster knobs, TelemetryConfig knobs, SLO bound):
# the trace tests' shifting-hotspot run, craq on ycsb_a under the lag-1
# tier (bounce and redirect columns: six-hop plans), the overload breach
# with split_overflow pool growth
PLANE_RUNS = {
    "traced": ("shifting_hotspot", "full_adaptive", {},
               dict(sample_rate=1 / 2, max_spans=64), 10.0),
    "craq_tier": ("ycsb_a", "full_adaptive",
                  dict(replication_mode="craq",
                       coordination=dict(n_switches=4, lag_per_hop=1)),
                  dict(sample_rate=1 / 2, max_spans=128), 10.0),
    "overload_growth": ("keyspace_growth", "overload_adaptive",
                        dict(num_nodes=4, num_ranges=8, n_slots=8,
                             capacity=128, split_overflow=True,
                             overload=dict(queue_cap=32, service_rate=24,
                                           inflation=3.0, queue_weight=2)),
                        dict(sample_rate=1 / 2, max_spans=64,
                             link_retries=12), 10.0),
}


def _plane_driver(name, device, fused, tmp):
    from repro_torch import cluster as TC
    from repro_torch import coordination_tier as CTm
    from repro_torch import overload as OVL
    from repro_torch.telemetry import SLO, MetricsConfig, TelemetryConfig

    scen, pol, ckw, tkw, bound = PLANE_RUNS[name]
    ckw = dict(ckw)
    if "coordination" in ckw:
        ckw["coordination"] = CTm.CoordConfig(**ckw["coordination"])
    if "overload" in ckw:
        ckw["overload"] = OVL.OverloadConfig(**ckw["overload"])
    grow = scen == "keyspace_growth"
    scfg = (TC.ScenarioConfig(n_epochs=10, epoch_ops=512, n_records=2048,
                              read_ratio=0.3, value_dim=2) if grow else
            TC.ScenarioConfig(n_epochs=8, epoch_ops=256, n_records=512,
                              value_dim=2, seed=3))
    base = {} if grow else dict(num_nodes=8, num_ranges=32, n_clients=16,
                                imbalance_threshold=1.1,
                                max_moves_per_round=6)
    slo = SLO(name="p999", series="p999", bound=bound, objective=0.9,
              fast_window=2, slow_window=4)
    cfg = TC.ClusterConfig(
        **base, report_every=2, **ckw,
        telemetry=TelemetryConfig(**tkw, flight_epochs=4,
                                  flight_dir=str(tmp / device)),
        metrics=MetricsConfig(window=32, slos=(slo,)))
    skw = dict(theta=1.2, shift_every=2) if scen == "shifting_hotspot" else {}
    drv = TC.EpochDriver(TC.make_scenario(scen, scfg, **skw),
                         TC.make_policy(pol), cfg, fused=fused, device=device)
    return drv, drv.run()


@pytest.mark.parametrize("name", list(PLANE_RUNS))
def test_telemetry_planes_card_match_cpu(dev, name, tmp_path):
    """Both planes on: the span tables, counts, DES-attributed buckets,
    ring, alert timeline and flight ring on the card equal the CPU's, and
    the card's fused loop equals its per-epoch loop."""
    runs = {(d, f): _plane_driver(name, d, f, tmp_path)
            for d, f in (("cuda", True), ("cpu", True), ("cuda", False))}
    (g, grows), (c, crows) = runs[("cuda", True)], runs[("cpu", True)]
    rows = lambda rs: [dataclasses.asdict(r) for r in rs]
    for other in (runs[("cpu", True)], runs[("cuda", False)]):
        o, orows = other
        assert rows(grows) == rows(orows)
        assert len(g.telemetry.epochs) == len(o.telemetry.epochs)
        for a, b in zip(g.telemetry.epochs, o.telemetry.epochs):
            for k in ("span_i", "span_f", "lat", "comps", "issue", "hops"):
                assert np.array_equal(a[k], b[k]), (a["epoch"], k)
            assert a["n_sampled"] == b["n_sampled"]
        assert torch.equal(g.metrics.ring.cpu(), o.metrics.ring.cpu())
        assert g.alert_timeline() == o.alert_timeline()
    assert list(g.telemetry.flight.ring) == list(c.telemetry.flight.ring)
    assert g.telemetry.verify_exact() == 0.0
    assert g.telemetry.span_count > 0


def test_spans_and_ring_at_full_width_card_match_cpu(dev):
    """``collect_spans`` at B 65,536 over a six-hop plan (keys >= 2**31,
    four-member chains) and ``record_epoch`` whose heat ties across most
    slots: the card equals the CPU bit for bit, ties lowest slot first."""
    from repro_torch import replication as RPL
    from repro_torch.core import coordination as CO
    from repro_torch.core import stats as ST
    from repro_torch.telemetry import collect_spans, rate_threshold
    from repro_torch.telemetry import metrics as MTR

    B, N, S, H = 65536, 10, 2048, 6
    rng = np.random.default_rng(21)
    host = dict(
        key=rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.int64),
        op=rng.integers(0, 3, B).astype(np.int32),
        chain=rng.integers(-1, N, (B, 4)), clen=rng.integers(1, 5, B),
        ridx=rng.integers(0, S, B), target=rng.integers(-1, N, B),
        bounced=rng.random(B) < 0.3, outcome=rng.integers(-1, 3, B),
        depth=rng.integers(0, 90, B), orbit=rng.integers(-1, 3, B),
        scale=(1 + 2 * rng.random(B)).astype(np.float32),
        service=(40 * rng.random((B, H))).astype(np.float32),
        reply=rng.integers(1, 5, B).astype(np.float32),
        version=rng.integers(0, 4, S), acked=rng.integers(0, 4, (S, 4)),
        node_ops=rng.integers(0, 9000, N))
    out = {}
    for d in ("cuda", "cpu"):
        t = {k: torch.tensor(v, device=d) for k, v in host.items()}
        q = R.QueryBatch(t["op"], t["key"], t["key"],
                         torch.zeros((B, 1), device=d))
        dec = R.RoutingDecision(t["ridx"], t["target"], t["chain"],
                                t["clen"], t["clen"])
        plan = CO.HopPlan(torch.zeros((B, H), dtype=torch.int32, device=d),
                          t["service"], t["reply"])
        spans = collect_spans(q, 7, dec, t["target"], t["bounced"],
                              t["outcome"], t["depth"], t["orbit"],
                              t["scale"], plan,
                              threshold=rate_threshold(1 / 64), k_slots=64,
                              lookup=0.25)
        sketch = ST.sketch_update(ST.make_sketch(512, 4, device=d),
                                  t["key"][:300])
        repl = RPL.ReplState(version=t["version"],
                             acked=torch.minimum(t["acked"],
                                                 t["version"][:, None]),
                             key_filter=torch.zeros((S, 1), dtype=torch.bool,
                                                    device=d))
        lay = MTR.build_layout(N, topk=4)
        st = MTR.make_state(8, lay.n_series, device=d)
        st = MTR.record_epoch(
            st, node_ops=t["node_ops"], ovl=None,
            ostats=torch.zeros(7, dtype=torch.int32, device=d),
            cstats=torch.zeros(5, dtype=torch.int64, device=d), coord=None,
            repl=repl, sketch=sketch, keys=t["key"][:300],
            ridx=t["ridx"][:300], topk=4)
        heat = torch.zeros(S, device=d)
        heat[[5, 900, 17]] = 3.0
        out[d] = (*spans, st.ring, *MTR.hot_slots(heat, 4))
    _same(out["cuda"], out["cpu"])
    assert out["cpu"][-1].tolist() == [5, 17, 900, 0]
    assert int(out["cpu"][2][1]) == 64          # the cap binds at 1/64


def test_kernel_roofline_rows_on_card(dev):
    """The roofline rows time K1-K5 themselves on the card (each launch
    counted) against the H100 peaks of ``telemetry.profiler``."""
    from repro_torch.telemetry import profiler as P

    before = dict(RMK.launches)
    rows = P.kernel_roofline_rows(batch=4096, measure_iters=3)
    assert [r["kernel"] for r in rows] == list(P.KERNELS)
    for r in rows:
        assert r["impl"] == "cuda"
        assert r["device"] == torch.cuda.get_device_name(dev)
        assert r["measured_us"] > 0
        assert r["roofline_us"] == r["t_memory_us"] == (
            r["bytes"] / P.HBM_BYTES_PER_S * 1e6)
        assert RMK.launches[r["kernel"]] >= before[r["kernel"]] + 4


# ---------------------------------------------------------------------------
# K6 decode_attn and the serving path
# ---------------------------------------------------------------------------


def _attn_inputs(seed, B, S, Hq, Hkv, D, dtype, lengths, dev):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.tensor(rng.normal(size=s).astype(np.float32), device=dev)
               .to(dtype) for s in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    return q, k, v, torch.tensor(np.asarray(lengths, np.int32), device=dev)


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
@pytest.mark.parametrize("G", [5, 6])
@pytest.mark.parametrize("window", [None, 48])
def test_decode_attn_kernel_matches_plain(dev, no_tf32, dtype, D, G, window):
    """Lengths 1, inside, at and above S (F8), over a cache of several
    chunks with a ragged last one; with the window, a length whose window
    ends before the cache (uniform softmax over the S rows)."""
    from repro_torch.kernels.decode_attn import kernel as DAK
    from repro_torch.kernels.decode_attn import ref as DAR

    S, Hkv = 1300, 2
    lengths = [1, 37, 700, 1300, 1301, 5000, 1300 + 48 + 3]
    q, k, v, L = _attn_inputs(D + G, len(lengths), S, Hkv * G, Hkv, D, dtype,
                              lengths, dev)
    before = DAK.launches["decode_attn"]
    got = DAK.decode_attn(q, k, v, L, window=window)
    assert DAK.launches["decode_attn"] == before + 1
    want = DAR.decode_attn_ref(q, k, v, L, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    # bf16: two bf16 steps of each output (both sides accumulate in f32 and
    # round once); an absolute 3e-2 would pass zeros on the long rows
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-5, 2.0 ** -6)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("G", [1, 8])
def test_decode_attn_kernel_group_edges(dev, no_tf32, G):
    from repro_torch.kernels.decode_attn import kernel as DAK
    from repro_torch.kernels.decode_attn import ref as DAR

    q, k, v, L = _attn_inputs(G, 3, 512, G, 1, 128, torch.float32,
                              [1, 300, 512], dev)
    torch.testing.assert_close(DAK.decode_attn(q, k, v, L),
                               DAR.decode_attn_ref(q, k, v, L),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("G", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_kernel_every_group(dev, no_tf32, G, dtype):
    """Every compile-time group instance (1 to 8) at D 128."""
    from repro_torch.kernels.decode_attn import kernel as DAK
    from repro_torch.kernels.decode_attn import ref as DAR

    q, k, v, L = _attn_inputs(10 * G, 4, 700, 2 * G, 2, 128, dtype,
                              [1, 65, 500, 700], dev)
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-5, 2.0 ** -6)
    torch.testing.assert_close(DAK.decode_attn(q, k, v, L).float(),
                               DAR.decode_attn_ref(q, k, v, L).float(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("splits", [1, 4, 64, None])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_kernel_split_edges(dev, no_tf32, monkeypatch, splits, D,
                                        dtype):
    """Lengths that, at 4 pieces of whole T-row tiles, leave a last piece
    of 0, 1, T - 1, T and T + 1 rows (3T, 3T + 1, 4T - 1, 4T, 5T + 1), one
    row, a length past S (F8), over S = 6T + 3 (not a whole number of
    tiles); one piece, four, the most the host takes (64) and the host's
    own pick; with a window, the uniform case (a window that ends before
    the cache starts) too."""
    from repro_torch.kernels.decode_attn import kernel as DAK
    from repro_torch.kernels.decode_attn import ref as DAR

    if splits is not None:
        monkeypatch.setattr(DAK, "split_count", lambda bh, S, sms: splits)
    T = DAK.tile_rows(D, dtype)
    S = 6 * T + 3
    lengths = [3 * T, 3 * T + 1, 4 * T - 1, 4 * T, 5 * T + 1, 1, S + 5]
    q, k, v, L = _attn_inputs(D + T, len(lengths), S, 6, 2, D, dtype, lengths,
                              dev)
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-5, 2.0 ** -6)
    for window in (None, T + 3):
        before = DAK.launches["decode_attn"]
        got = DAK.decode_attn(q, k, v, L, window=window)
        assert DAK.launches["decode_attn"] == before + 1
        want = DAR.decode_attn_ref(q, k, v, L, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
    # a window ending before the cache: every score -1e30, uniform softmax
    Lu = torch.full_like(L, S + 2 * T)
    torch.testing.assert_close(
        DAK.decode_attn(q, k, v, Lu, window=T).float(),
        DAR.decode_attn_ref(q, k, v, Lu, window=T).float(), atol=atol,
        rtol=rtol)


def test_decode_attn_kernel_refuses_what_it_lacks(dev):
    from repro_torch.kernels.decode_attn import kernel as DAK

    q, k, v, L = _attn_inputs(0, 2, 64, 4, 2, 128, torch.float32, [3, 9], dev)
    with pytest.raises(TypeError):
        DAK.decode_attn(q, k.to(torch.bfloat16), v, L)
    with pytest.raises(TypeError):
        DAK.decode_attn(*(t.half() for t in (q, k, v)), L)
    with pytest.raises(ValueError, match="head dim"):
        DAK.decode_attn(q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous(), L)   # D 32: no instance
    with pytest.raises(ValueError, match="contiguous"):
        DAK.decode_attn(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, L)
    with pytest.raises(ValueError, match="query heads"):
        q9, k9, v9, _ = _attn_inputs(0, 2, 64, 9, 1, 64, torch.float32, [3, 9],
                                     dev)
        DAK.decode_attn(q9, k9, v9, L)
    with pytest.raises(ValueError, match="lengths"):
        DAK.decode_attn(q, k, v, L.long())


def test_serving_card_matches_cpu(dev, no_tf32):
    """The reduced qwen2 engine (f32) on the card against itself on the
    CPU, with a rebalance every 2 steps and a shard failure at step 3:
    equal tokens and traces, every picked logits row within 1e-4, and the
    card's run through K6 and K1."""
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import kernel as DAK
    from repro_torch.launch.serve import serve_loop
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("qwen2-1.5b").reduced()
    params = M.init_params(cfg, 0, device="cpu")
    runs = []
    for device in (dev, torch.device("cpu")):
        eng = ServingEngine(cfg, _to(params, device), n_slots=4, cache_len=64,
                            n_shards=4, device=device)
        picked = []
        pick = eng._pick
        eng._pick = lambda lg, pick=pick, picked=picked: (
            picked.append(lg[: cfg.vocab_size].copy()), pick(lg))[1]
        for i in range(7):
            eng.submit(np.arange(4) + i, max_new_tokens=5)
        DAK.reset_launches()
        RMK.reset_launches()
        trace = serve_loop(eng, rebalance_every=2, fail_shard_at=3)
        for rec in trace:
            if "rebalance" in rec:
                rec["rebalance"] = (rec["rebalance"][0],
                                    [tuple(vars(o).values())
                                     for o in rec["rebalance"][1]])
        runs.append((trace, {r: q.out_tokens for r, q in eng.finished.items()},
                     picked, DAK.launches["decode_attn"],
                     RMK.launches["range_match"]))
    (tc, kc, pc, k6c, k1c), (tp, kp, pp, k6p, k1p) = runs
    assert kc == kp and tc == tp and len(pc) == len(pp)
    for a, b in zip(pc, pp):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert k6c == cfg.n_layers * len(tc) and k1c > 0 and k6p == k1p == 0


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# K7 ssd_chunk
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, B, T, H, P, N, G, dev, dt_hi=0.1, a_hi=2.0):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    return (f(rng.normal(size=(B, T, H, P))),
            f(rng.uniform(0.001, dt_hi, (B, T, H))),
            f(-rng.uniform(0.5, a_hi, H)),
            f(rng.normal(size=(B, T, G, N))), f(rng.normal(size=(B, T, G, N))),
            f(rng.normal(size=(B, H, P, N)) * 0.1))


def _ssd_close(got, want):
    """K7 against its plain version: |err| <= 2e-4 (1 + |want|), the
    tolerance of tests/test_kernels.py scaled by the output."""
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
        err = ((a - b).abs() / (1 + b.abs())).max()
        assert float(err) <= 2e-4, float(err)


@pytest.mark.parametrize("B,T,H,P,N,G,chunk", [
    (1, 32, 2, 8, 4, 1, 8), (2, 128, 4, 16, 8, 1, 32),
    (2, 250, 8, 32, 16, 1, 64),               # test_ssd_sweep's shapes
    (2, 64, 4, 8, 4, 2, 16),                  # test_ssd_grouped_fallback's
    (2, 33, 4, 16, 8, 1, 8),                  # test_ssd_decode_matches_scan_tail's
    (1, 10, 4, 16, 16, 1, 10),                # the reduced configs, Q 10
    (3, 23, 4, 16, 16, 1, 8),                 # ragged T, padded
    (1, 300, 32, 64, 128, 1, 128),            # mamba2's heads
    (2, 230, 50, 64, 16, 1, 100),             # hymba's heads, Q 100
])
def test_ssd_chunk_kernel_matches_plain(dev, B, T, H, P, N, G, chunk):
    from repro_torch.kernels.ssd_chunk import kernel as SK
    from repro_torch.kernels.ssd_chunk import ops as SO

    x, dt, A, Bm, Cm, s0 = _ssd_inputs(T + N, B, T, H, P, N, G, dev)
    before = SK.launches["ssd_chunk"]
    got = SO.ssd_scan(x, dt, A, Bm, Cm, s0, chunk=chunk)
    assert SK.launches["ssd_chunk"] == before + 1
    cpu = [t.cpu() for t in (x, dt, A, Bm, Cm, s0)]
    want = SO.ssd_scan(*cpu, chunk=chunk)
    torch.cuda.synchronize()
    _ssd_close([t.cpu() for t in got], want)


def test_ssd_chunk_kernel_model_ranges(dev):
    """The model's ranges: dt up to softplus(1) and A down to -16, where the
    decays within a chunk of 128 reach exp(-1,700)."""
    from repro_torch.kernels.ssd_chunk import kernel as SK
    from repro_torch.kernels.ssd_chunk import ref as SR

    x, dt, A, Bm, Cm, s0 = _ssd_inputs(3, 1, 512, 32, 64, 128, 1, dev,
                                       dt_hi=1.3, a_hi=16.0)
    got = SK.ssd_chunk(x, dt, A, Bm, Cm, s0, chunk=128)
    want = SR.ssd_chunked_ref(x, dt, A, Bm, Cm, s0, chunk=128)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in got)
    _ssd_close(got, want)


@pytest.mark.parametrize("B,T,H,P,N,G,chunk", [
    (1, 2048, 32, 64, 128, 1, 128),           # mamba2's heads, 16 chunks
    (2, 128, 32, 64, 128, 1, 128),            # T = Q, a single chunk
    (2, 96, 8, 16, 16, 2, 16),                # G 2 over six chunks
], ids=["16-chunks", "one-chunk", "G2-6-chunks"])
def test_ssd_chunk_kernel_passes(dev, B, T, H, P, N, G, chunk):
    """The four passes across chunk counts: pass 3 carries a nonzero
    initial state over 16 chunks, over none, and under two groups."""
    from repro_torch.kernels.ssd_chunk import kernel as SK
    from repro_torch.kernels.ssd_chunk import ref as SR

    x, dt, A, Bm, Cm, s0 = _ssd_inputs(T + G, B, T, H, P, N, G, dev)
    got = SK.ssd_chunk(x, dt, A, Bm, Cm, s0, chunk=chunk)
    cpu = [t.cpu() for t in (x, dt, A, Bm, Cm, s0)]
    want = SR.ssd_chunked_ref(*cpu, chunk=chunk)
    torch.cuda.synchronize()
    _ssd_close([t.cpu() for t in got], want)


def test_ssd_chunk_kernel_in_cuda_graph(dev):
    """The call captured in a CUDA graph and replayed equals the eager call
    bit for bit (its scratch comes from PyTorch's allocator), and a replay
    reads the inputs as they are then."""
    from repro_torch.kernels.ssd_chunk import kernel as SK

    x, dt, A, Bm, Cm, s0 = _ssd_inputs(8, 1, 640, 32, 64, 128, 1, dev)
    args = (x, dt, A, Bm, Cm, s0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        SK.ssd_chunk(*args, chunk=128)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = SK.ssd_chunk(*args, chunk=128)
    for scale in (1.0, 0.5):
        x.mul_(scale)
        eager = SK.ssd_chunk(*args, chunk=128)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])


def test_ssd_chunk_kernel_refuses_what_it_lacks(dev):
    from repro_torch.kernels.ssd_chunk import kernel as SK

    x, dt, A, Bm, Cm, s0 = _ssd_inputs(4, 1, 32, 2, 16, 8, 1, dev)
    with pytest.raises(ValueError, match="CUDA"):
        SK.ssd_chunk(*(t.cpu() for t in (x, dt, A, Bm, Cm, s0)), chunk=8)
    with pytest.raises(TypeError):
        SK.ssd_chunk(x.half(), dt, A, Bm, Cm, s0, chunk=8)
    with pytest.raises(TypeError):
        SK.ssd_chunk(*(t.to(torch.bfloat16) for t in (x, dt, A, Bm, Cm, s0)),
                     chunk=8)
    with pytest.raises(ValueError, match="head dim"):
        x24, dt24, A24, B24, C24, s24 = _ssd_inputs(4, 1, 32, 2, 24, 8, 1, dev)
        SK.ssd_chunk(x24, dt24, A24, B24, C24, s24, chunk=8)
    with pytest.raises(ValueError, match="state dim"):
        x6, dt6, A6, B6, C6, s6 = _ssd_inputs(4, 1, 32, 2, 16, 32, 1, dev)
        SK.ssd_chunk(x6, dt6, A6, B6, C6, s6, chunk=8)
    with pytest.raises(ValueError, match="chunk"):
        SK.ssd_chunk(x, dt, A, Bm, Cm, s0, chunk=12)          # 32 % 12
    with pytest.raises(ValueError, match="contiguous"):
        SK.ssd_chunk(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A,
                     Bm, Cm, s0, chunk=8)
    with pytest.raises(ValueError, match="groups"):
        SK.ssd_chunk(x, dt, A, torch.cat([Bm] * 3, 2), torch.cat([Cm] * 3, 2),
                     s0, chunk=8)


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_ssm_serving_card_matches_cpu(dev, no_tf32, arch):
    """The reduced mamba2 / hymba engine (f32) on the card against itself on
    the CPU: equal tokens and traces, every picked logits row within 1e-4,
    and the card's prefills through K7 (one launch a layer an admission)."""
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_chunk import kernel as SK
    from repro_torch.launch.serve import serve_loop
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    runs = []
    for device in (dev, torch.device("cpu")):
        eng = ServingEngine(cfg, _to(params, device), n_slots=3, cache_len=64,
                            n_shards=4, device=device)
        picked = []
        pick = eng._pick
        eng._pick = lambda lg, pick=pick, picked=picked: (
            picked.append(lg[: cfg.vocab_size].copy()), pick(lg))[1]
        for i in range(7):
            eng.submit(np.arange(4 + 3 * i) % cfg.vocab_size, max_new_tokens=5)
        SK.reset_launches()
        trace = serve_loop(eng, rebalance_every=2, fail_shard_at=3)
        for rec in trace:
            if "rebalance" in rec:
                rec["rebalance"] = (rec["rebalance"][0],
                                    [tuple(vars(o).values())
                                     for o in rec["rebalance"][1]])
        runs.append((trace, {r: q.out_tokens for r, q in eng.finished.items()},
                     picked, SK.launches["ssd_chunk"]))
    (tc, kc, pc, k7c), (tp, kp, pp, k7p) = runs
    assert kc == kp and tc == tp and len(pc) == len(pp)
    for a, b in zip(pc, pp):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert k7c == cfg.n_layers * 7 and k7p == 0


def _train_setup(arch):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.training import step as STEP
    from repro_torch.training.optimizer import OptConfig

    cfg = get_config(arch).reduced()
    tcfg = STEP.TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=0,
                                          total_steps=10), remat=True)
    batch = make_batch(cfg, ShapeSpec("tiny", 64, 8, "train"), 0,
                       DataConfig("copy"))
    return cfg, tcfg, STEP.init_train_state(cfg, tcfg, 0, device="cpu"), batch


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-moe-16b",
                                  "mamba2-370m", "hymba-1.5b"])
def test_train_step_card_matches_cpu(dev, no_tf32, arch):
    """One reduced train step (f32, remat) on the card against the CPU
    from the same state and batch: loss, gradients and every updated leaf
    within 1e-4 (deepseek's MoE aux loss with its gradient; mamba2's and
    hymba's SSD scans through K7 forward, twice a pass with remat, and
    the plain scan's VJP backward, once)."""
    from repro_torch.kernels.ssd_chunk import kernel as SK
    from repro_torch.launch.train import device_batch
    from repro_torch.training import step as STEP
    from repro_torch.training import tree as TR

    cfg, tcfg, state, batch = _train_setup(arch)
    runs = []
    for device in (dev, torch.device("cpu")):
        st, b = _to(state, device), device_batch(batch, device)
        before = dict(SK.launches)
        (loss, m), grads = STEP.value_and_grad(cfg, st["params"], b,
                                               remat=True)
        new, _ = STEP.make_train_step(cfg, tcfg)(st, b)
        runs.append((float(loss), float(m["moe_aux_loss"]),
                     [g.cpu() for g in TR.leaves(grads)],
                     [t.cpu() for t in TR.leaves(new)]))
        if device.type == "cuda":
            k7 = SK.launches["ssd_chunk"] - before["ssd_chunk"]
            back = (SK.launches["ssd_chunk_plain_grad"]
                    - before["ssd_chunk_plain_grad"])
            assert k7 == 2 * back
            assert (back > 0) == (cfg.family in ("ssm", "hybrid"))
    (lc, ac, gc, nc), (lp, ap, gp, np_) = runs
    assert abs(lc - lp) <= 1e-4 and abs(ac - ap) <= 1e-4
    for a, b in zip(gc + nc, gp + np_):
        assert a.dtype == b.dtype
        assert float((a.double() - b.double()).abs().max()) <= 1e-4
    if cfg.family == "moe":
        assert ac > 0


def test_checkpoint_saved_on_card_restores_on_cpu(dev, tmp_path):
    """A train state saved from the card (float32, int32 and bf16 leaves)
    restores on the CPU bit for bit."""
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training import tree as TR

    _, _, state, _ = _train_setup("qwen2-1.5b")
    state["err"] = TR.tree_map(lambda p: (p * 3).to(torch.bfloat16),
                               state["params"])
    card = _to(state, dev)
    CKPT.save(card, str(tmp_path), step=4, blocking=False).join()
    got, step = CKPT.restore(TR.tree_map(torch.zeros_like, state),
                             str(tmp_path))
    assert step == 4
    for a, b in zip(TR.leaves(got), TR.leaves(state)):
        assert a.device.type == "cpu" and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_ssd_scan_trains_through_the_plain_scan_and_serves_through_k7(dev):
    """A CUDA call that asks for a gradient launches K7 for its forward
    (y within 2e-4 (1 + |cpu|) of the CPU plain version's) and trains
    through the plain chunked scan's VJP in its backward (one count of
    ``ssd_chunk_plain_grad``): the gradients of x, dt, A, B and C equal
    the CPU plain version's within 1e-4 (1 + |cpu|) (dt's reach ~113
    here); under no_grad the call launches K7 once, within 2e-4
    (1 + |want|) of the plain version, and counts no backward."""
    from repro_torch.kernels.ssd_chunk import kernel as SK
    from repro_torch.kernels.ssd_chunk.ops import ssd_scan
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunked_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, 32, 2, 8), device=dev, generator=gen)
    dt = torch.rand((1, 32, 2), device=dev, generator=gen) * 0.1
    A = -torch.rand((2,), device=dev, generator=gen)
    Bm, Cm = (torch.randn((1, 32, 8), device=dev, generator=gen)
              for _ in range(2))
    w = torch.randn((1, 32, 2, 8), device=dev, generator=gen)
    grads, outs = [], []
    for d in (dev, torch.device("cpu")):
        leaves = [t.detach().to(d).requires_grad_(True)
                  for t in (x, dt, A, Bm, Cm)]
        before = dict(SK.launches)
        y, fs = ssd_scan(*leaves, chunk=16)
        if d.type == "cuda":
            assert SK.launches["ssd_chunk"] == before["ssd_chunk"] + 1
        ((y * w.to(d)).sum() + fs.sum()).backward()
        if d.type == "cuda":
            assert (SK.launches["ssd_chunk_plain_grad"]
                    == before["ssd_chunk_plain_grad"] + 1)
        grads.append([t.grad.cpu() for t in leaves])
        outs.append((y.detach().cpu(), fs.detach().cpu()))
    _ssd_close(*outs)
    for g, h in zip(*grads):
        assert float(((g - h).abs() / (1 + h.abs())).max()) <= 1e-4
    before = dict(SK.launches)
    with torch.no_grad():
        got = ssd_scan(x, dt, A, Bm, Cm, chunk=16)
        want = ssd_chunked_ref(x, dt, A, Bm, Cm,
                               torch.zeros((1, 2, 8, 8), device=dev),
                               chunk=16)
    assert SK.launches["ssd_chunk"] == before["ssd_chunk"] + 1
    assert SK.launches["ssd_chunk_plain_grad"] == before["ssd_chunk_plain_grad"]
    _ssd_close(got, want)
