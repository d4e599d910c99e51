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
    """No fallback: tables larger than a block's shared memory make the
    launch fail, and the wrapper raises instead of taking the plain path."""
    d = _directory(1, 4000, 10000, dev)
    keys = torch.zeros(16, dtype=torch.int64, device=dev)
    ops = torch.zeros(16, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="launch failed"):
        OPS.range_match(d, keys, ops)


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
    """8 W S bytes of staged spans over the opt-in limit: the wrapper
    raises instead of taking the plain path."""
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
