"""The port's fused route-and-probe entry point, ``core.routing.
route_and_lookup`` (K4b ``range_match_apply``), against the JAX
reference's ``range_match_apply`` (its Pallas kernel in interpret mode
and its jnp oracle) and ``route_and_lookup``, on directories mangled by
random split / merge / widen sequences (the cases of
``tests/test_split.py::test_apply_kernel_parity_after_random_splits``):
all seven outputs, bit for bit."""

import sys

import jax
import jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
    # forget the half-imported `repro` modules that earlier test modules'
    # failed imports left behind (a stale child whose parent is gone
    # breaks later imports of its siblings)
    for _m in sorted(m for m in sys.modules if m.startswith("repro.")):
        if _m.rpartition(".")[0] not in sys.modules:
            del sys.modules[_m]

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as JC
from repro.core import keys as JK
from repro.core.routing import route_and_lookup as j_route_and_lookup
from repro.kernels.range_match.ops import range_match_apply as j_apply
from repro_torch import convert, prng
from repro_torch.core import routing as TR
from repro_torch.kernels.range_match import ops as TOps


def _t64(a):
    return torch.tensor(np.asarray(a).astype(np.int64))


def _mangled(seed, N=8, r_max=5):
    """A directory after random split / merge / widen steps (the reference
    test's sequence), with the live spans still partitioning the keys."""
    rng = np.random.default_rng(seed)
    ctl = JC.Controller(JC.make_directory(16, N, 3, r_max=r_max, n_slots=64))
    node_load = rng.integers(0, 100, N).astype(np.uint32)
    for _ in range(40):
        r = rng.random()
        if r < 0.2:
            kids = ctl.children()
            if kids:
                ctl.merge_range(int(rng.choice(kids)))
                continue
        ridx = int(rng.choice(ctl.live_ranges()))
        if r < 0.45:
            ctl.widen_chain(ridx, node_load)
            continue
        lo, hi = ctl.range_span(ridx)
        if hi - lo < 2:
            continue
        ctl.split_range(ridx, int(rng.integers(lo, hi)))
    d = ctl.directory()
    live = np.asarray(d.live)
    spans = sorted(zip(np.asarray(d.slot_lo)[live].astype(np.int64),
                       np.asarray(d.slot_hi)[live].astype(np.int64)))
    assert spans[0][0] == 0 and spans[-1][1] == JK.MAX_KEY
    assert all(h0 + 1 == l1 for (_, h0), (l1, _) in zip(spans, spans[1:]))
    return rng, node_load, d


@pytest.mark.parametrize("seed", [0, 13])
def test_apply_kernel_parity_after_random_splits(seed):
    N, r_max, cap, B = 8, 5, 96, 300
    rng, node_load, jd = _mangled(seed, N, r_max)
    td = convert.directory_from_numpy(
        {f: np.asarray(getattr(jd, f)) for f in convert.DIRECTORY_FIELDS},
        device="cpu")
    store_keys = np.full((N, cap), 0xFFFFFFFF, np.uint32)
    for n in range(N):
        k = np.unique(rng.integers(1, 2**32 - 2, cap // 2).astype(np.uint32))
        store_keys[n, : len(k)] = np.sort(k)
    keys = rng.integers(0, 2**32 - 2, B).astype(np.uint32)
    keys[: B // 2] = store_keys[rng.integers(0, N, B // 2),
                                rng.integers(0, cap // 3, B // 2)]
    ops = rng.integers(0, 3, B).astype(np.int32)
    dirty = rng.integers(0, 2, (jd.num_slots, r_max)).astype(bool)
    jargs = (jd, jnp.asarray(keys), jnp.asarray(ops), jnp.asarray(node_load),
             jnp.asarray(dirty), jnp.asarray(store_keys),
             jax.random.PRNGKey(seed + 1))
    pallas = j_apply(*jargs, use_pallas=True, fuse=True)
    oracle = j_apply(*jargs, use_pallas=False)
    jdec, jd2, jl2, jp, jb, jslot, jfound = j_route_and_lookup(
        jd, JC.make_queries(jnp.asarray(keys), jnp.asarray(ops)),
        jnp.asarray(store_keys), jnp.asarray(node_load), jnp.asarray(dirty),
        jax.random.PRNGKey(seed + 1))

    tq = TR.make_queries(keys, ops, device="cpu")
    tload = convert.load_reg_from_numpy(node_load, device="cpu")
    tdirty = torch.tensor(dirty)
    tslabs = _t64(store_keys)
    rng_t = prng.PRNGKey(seed + 1)
    plain = TOps.range_match_apply(td, tq.key, tq.opcode, tload, tdirty,
                                   tslabs, rng_t)
    tdec, td2, tl2, tp, tb, tslot, tfound = TR.route_and_lookup(
        td, tq, tslabs, tload, tdirty, rng_t)

    for i, (p, o, t) in enumerate(zip(pallas, oracle, plain)):
        p, o = np.asarray(p), np.asarray(o)
        assert np.array_equal(p, o), i
        assert p.shape == tuple(t.shape) and np.array_equal(p, t.numpy()), i
    ridx, target, chain, picked, bounced, slot, found = plain
    assert np.array_equal(np.asarray(jdec.ridx), tdec.ridx.numpy())
    assert np.array_equal(np.asarray(jdec.target), tdec.target.numpy())
    assert np.array_equal(np.asarray(jdec.chain), tdec.chain.numpy())
    assert np.array_equal(np.asarray(jdec.clength), tdec.clength.numpy())
    assert np.array_equal(chain.T.numpy(), tdec.chain.numpy())
    for j, t in ((jp, tp), (jb, tb), (jslot, tslot), (jfound, tfound)):
        assert np.array_equal(np.asarray(j), t.numpy())
    for f in ("read_count", "write_count"):
        assert np.array_equal(np.asarray(getattr(jd2, f)),
                              getattr(td2, f).numpy())
    assert np.array_equal(np.asarray(jl2), convert.load_reg_to_numpy(tl2))
    # the fixture exercises both branches of the contract
    assert bounced.any() and found.any() and (~found).any()


def test_route_and_lookup_is_dirty_route_then_slab_probe():
    """K4b equals K3 followed by K4a on the serving node (the two-kernel
    path the fused one replaces), here through the plain versions."""
    N, r_max, cap = 8, 5, 96
    rng, node_load, jd = _mangled(5, N, r_max)
    td = convert.directory_from_numpy(
        {f: np.asarray(getattr(jd, f)) for f in convert.DIRECTORY_FIELDS},
        device="cpu")
    slabs = np.full((N, cap), 0xFFFFFFFF, np.int64)
    for n in range(N):
        k = np.unique(rng.integers(1, 2**32 - 2, cap // 2))
        slabs[n, : len(k)] = np.sort(k)
    keys = rng.integers(0, 2**32 - 2, 500).astype(np.uint32)
    keys[:250] = slabs[rng.integers(0, N, 250), rng.integers(0, cap // 3, 250)]
    ops = rng.integers(0, 3, 500).astype(np.int32)
    q = TR.make_queries(keys, ops, device="cpu")
    load = convert.load_reg_from_numpy(node_load, device="cpu")
    dirty = torch.tensor(rng.random((jd.num_slots, r_max)) < 0.5)
    fused = TR.route_and_lookup(td, q, _t64(slabs), load, dirty,
                                prng.PRNGKey(4))
    dec, d2, l2, picked, bounced = TR.route_load_aware_dirty(
        td, q, load, dirty, prng.PRNGKey(4))
    slot, found = TOps.slab_lookup(q.key, dec.target, _t64(slabs))
    for a, b in zip(fused[3:], (picked, bounced, slot, found)):
        assert torch.equal(a, b)
    assert torch.equal(fused[0].target, dec.target)
    assert torch.equal(fused[2], l2)
