"""The port's sorted-slab store against the JAX reference, bit for bit:
the ``tests/test_store_merge.py`` cases (rank-merge put, delete,
compaction, last-write-wins dedupe, overflow, uint32-ceiling keys,
migration round trip) and ``apply_routed`` on mixed GET/PUT/DEL/SCAN
batches with capacity drops and NO_NODE targets."""

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
from repro.core import migration as JM
from repro.core import store as JS
from repro_torch import convert
from repro_torch.core import migration as TM
from repro_torch.core import routing as TR
from repro_torch.core import store as TS

EMPTY = 0xFFFFFFFF


def _t64(a):
    return torch.tensor(np.asarray(a).astype(np.int64))


def _tf(a):
    return torch.tensor(np.asarray(a, np.float32))


def _eq_keys(a, b):
    return np.array_equal(np.asarray(a).astype(np.int64), b.numpy())


def _eq_vals(a, b):
    return np.array_equal(np.asarray(a).view(np.uint32), b.numpy().view(np.uint32))


def _random_slab(rng, C, V, keyspace, fill=None):
    n_live = int(rng.integers(0, C + 1)) if fill is None else fill
    n_live = min(n_live, keyspace)
    keys = np.full(C, EMPTY, np.uint32)
    keys[:n_live] = np.sort(
        rng.choice(keyspace, size=n_live, replace=False).astype(np.uint32))
    vals = np.zeros((C, V), np.float32)
    vals[:n_live] = rng.normal(size=(n_live, V)).astype(np.float32)
    return keys, vals


def _check_put(sk, sv, pkeys, pvals):
    jk, jv, jd = JS.slab_put(jnp.asarray(sk), jnp.asarray(sv),
                             jnp.asarray(pkeys), jnp.asarray(pvals))
    tk, tv, td = TS.slab_put(_t64(sk), _tf(sv), _t64(pkeys), _tf(pvals))
    assert _eq_keys(jk, tk) and _eq_vals(jv, tv)
    assert int(jd) == int(td)


def _check_delete(sk, sv, dkeys):
    jk, jv = JS.slab_delete(jnp.asarray(sk), jnp.asarray(sv), jnp.asarray(dkeys))
    tk, tv = TS.slab_delete(_t64(sk), _tf(sv), _t64(dkeys))
    assert _eq_keys(jk, tk) and _eq_vals(jv, tv)


@pytest.mark.parametrize("seed", range(3))
def test_slab_put_randomized(seed):
    rng = np.random.default_rng(seed)
    C, B, V = 48, 32, 3
    for _ in range(20):
        keyspace = int(rng.integers(40, 200))
        sk, sv = _random_slab(rng, C, V, keyspace)
        pkeys = rng.integers(0, keyspace, B).astype(np.uint32)
        pkeys[rng.random(B) < 0.15] = EMPTY
        pvals = rng.normal(size=(B, V)).astype(np.float32)
        _check_put(sk, sv, pkeys, pvals)


def test_slab_put_overflow_drops_largest_keys():
    rng = np.random.default_rng(1)
    C, B, V = 16, 16, 2
    sk, sv = _random_slab(rng, C, V, keyspace=1000, fill=C)
    pkeys = (2000 + np.arange(B) * 3).astype(np.uint32)
    pvals = rng.normal(size=(B, V)).astype(np.float32)
    _check_put(sk, sv, pkeys, pvals)
    _, _, d = TS.slab_put(_t64(sk), _tf(sv), _t64(pkeys), _tf(pvals))
    assert int(d) == B


def test_slab_put_duplicate_batch_last_write_wins():
    sk = np.full(8, EMPTY, np.uint32)
    sv = np.zeros((8, 2), np.float32)
    pkeys = np.array([5, 5, 5, 9], np.uint32)
    pvals = np.arange(8, dtype=np.float32).reshape(4, 2)
    _check_put(sk, sv, pkeys, pvals)
    k, v, _ = TS.slab_put(_t64(sk), _tf(sv), _t64(pkeys), _tf(pvals))
    vals, found = TS.slab_get(k, v, _t64([5, 9]))
    assert bool(found.all())
    np.testing.assert_array_equal(vals.numpy(), [[4.0, 5.0], [6.0, 7.0]])


def test_slab_put_empty_and_degenerate_batches():
    rng = np.random.default_rng(2)
    C, V = 12, 2
    sk, sv = _random_slab(rng, C, V, keyspace=50, fill=6)
    _check_put(sk, sv, np.full(8, EMPTY, np.uint32), np.zeros((8, V), np.float32))
    live = sk[sk != EMPTY][:4]
    pk2 = np.concatenate([live, np.full(4, EMPTY, np.uint32)])
    _check_put(sk, sv, pk2, rng.normal(size=(8, V)).astype(np.float32))
    _check_put(np.full(C, EMPTY, np.uint32), np.zeros((C, V), np.float32),
               np.array([3, 1, 2, EMPTY], np.uint32),
               rng.normal(size=(4, V)).astype(np.float32))


def test_slab_put_large_uint32_spans():
    sk = np.full(8, EMPTY, np.uint32)
    sv = np.zeros((8, 1), np.float32)
    pkeys = np.array([0xFFFFFFFE, 0, 0x80000000], np.uint32)
    pvals = np.arange(3, dtype=np.float32)[:, None]
    _check_put(sk, sv, pkeys, pvals)


@pytest.mark.parametrize("seed", range(3))
def test_slab_delete_randomized(seed):
    rng = np.random.default_rng(seed + 3)
    C, B, V = 40, 24, 2
    for _ in range(20):
        keyspace = int(rng.integers(30, 150))
        sk, sv = _random_slab(rng, C, V, keyspace)
        dkeys = rng.integers(0, keyspace, B).astype(np.uint32)
        dkeys[rng.random(B) < 0.2] = EMPTY
        _check_delete(sk, sv, dkeys)


def test_compact_and_dedupe_match():
    keys = np.array([2, 5, 7, 11, 13], np.uint32)
    vals = np.arange(10, dtype=np.float32).reshape(5, 2)
    live = np.array([True, False, True, False, True])
    jk, jv = JS._compact_sorted(jnp.asarray(keys), jnp.asarray(vals),
                                jnp.asarray(live))
    tk, tv = TS._compact_sorted(_t64(keys), _tf(vals), torch.tensor(live))
    assert _eq_keys(jk, tk) and _eq_vals(jv, tv)
    qk = np.array([7, 3, 7, EMPTY, 3, 1], np.uint32)
    qv = np.arange(12, dtype=np.float32).reshape(6, 2)
    jk, jv = JS._dedupe_last_write(jnp.asarray(qk), jnp.asarray(qv))
    tk, tv = TS._dedupe_last_write(_t64(qk), _tf(qv))
    assert _eq_keys(jk, tk) and _eq_vals(jv, tv)


def test_slab_scan_matches():
    rng = np.random.default_rng(6)
    sk, sv = _random_slab(rng, 64, 2, keyspace=400, fill=50)
    k0 = rng.integers(0, 400, 32).astype(np.uint32)
    k1 = (k0 + rng.integers(0, 60, 32)).astype(np.uint32)
    k1[0] = EMPTY
    a = JS.slab_scan(jnp.asarray(sk), jnp.asarray(sv), jnp.asarray(k0),
                     jnp.asarray(k1), 8)
    b = TS.slab_scan(_t64(sk), _tf(sv), _t64(k0), _t64(k1), 8)
    assert _eq_keys(a[0], b[0]) and _eq_vals(a[1], b[1])
    assert np.array_equal(np.asarray(a[2]), b[2].numpy())


def _mixed_batch(rng, B, V, record_keys, p_scan=0.1):
    keys = rng.choice(record_keys, B).astype(np.uint32)
    fresh = rng.random(B) < 0.3
    keys[fresh] = rng.integers(0, 2**32 - 2, fresh.sum(), dtype=np.uint64).astype(np.uint32)
    ops = rng.choice(4, B, p=[0.4, 0.35, 0.15, 0.1]).astype(np.int32)
    ends = np.where(ops == 3, np.minimum(keys.astype(np.uint64) + 2**27,
                                         2**32 - 2), 0).astype(np.uint32)
    vals = rng.normal(size=(B, V)).astype(np.float32)
    return keys, ops, ends, vals


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("capacity", [24, 200])
def test_apply_routed_matches_reference(seed, capacity):
    """Several batches through route + apply_routed; small capacity forces
    overflow drops; a fully spliced chain gives NO_NODE targets."""
    rng = np.random.default_rng(seed)
    N, V, B = 5, 3, 96
    jd = JC.make_directory(12, N, 2, r_max=3, n_slots=16)
    tabs = {f: np.asarray(getattr(jd, f)).copy() for f in convert.DIRECTORY_FIELDS}
    tabs["chains"][2] = -1            # live slot, chain spliced to nothing
    tabs["chain_len"][2] = 0
    tabs["chain_len"][5] = 3          # a widened chain
    tabs["chains"][5, 2] = (tabs["chains"][5, 1] + 1) % N
    jd = JC.Directory(**{k: jnp.asarray(v) for k, v in tabs.items()})
    td = convert.directory_from_numpy(tabs, device="cpu")
    js = JC.make_store(N, capacity, V)
    ts = TS.make_store(N, capacity, V, device="cpu")
    record_keys = rng.integers(0, 2**32 - 2, 150, dtype=np.uint64).astype(np.uint32)
    for step in range(4):
        keys, ops, ends, vals = _mixed_batch(rng, B, V, record_keys)
        if step == 0:
            ops[:] = 1                # a preload batch first
        jq = JC.make_queries(jnp.asarray(keys), jnp.asarray(ops),
                             jnp.asarray(vals), jnp.asarray(ends))
        tq = TR.make_queries(keys, ops, vals, ends, device="cpu")
        jdec, jd = JC.route(jd, jq)
        tdec, td = TR.route(td, tq)
        js, jr = JC.apply_routed(js, jq, jdec, max_scan_results=4)
        # the preload batch holds no SCAN: it takes the scan-free path,
        # whose empty scan answer must equal the reference's too
        ts, tr = TS.apply_routed(ts, tq, tdec, max_scan_results=4,
                                 scans=bool((ops == 3).any()))
        got = convert.store_to_numpy(ts)
        assert np.array_equal(np.asarray(js.keys), got["keys"])
        assert _eq_vals(js.values, ts.values)
        assert np.array_equal(np.asarray(js.overflow), got["overflow"])
        assert _eq_vals(jr.value, tr.value)
        assert np.array_equal(np.asarray(jr.found), tr.found.numpy())
        assert _eq_vals(jr.scan_values, tr.scan_values)
        assert _eq_keys(jr.scan_keys, tr.scan_keys)
        assert np.array_equal(np.asarray(jr.scan_count), tr.scan_count.numpy())
    if capacity == 24:
        assert int(got["overflow"].sum()) > 0      # drops were exercised
    assert (tdec.target.numpy() == -1).any()     # NO_NODE reads were routed


def test_migration_roundtrip_matches_reference():
    rng = np.random.default_rng(4)
    js = JC.make_store(3, 64, 2)
    ts = TS.make_store(3, 64, 2, device="cpu")
    keys = np.sort(rng.choice(1000, 40, replace=False).astype(np.uint32))
    vals = rng.normal(size=(40, 2)).astype(np.float32)
    k0, v0, _ = JS.slab_put(js.keys[0], js.values[0], jnp.asarray(keys),
                            jnp.asarray(vals))
    js = JS.StoreState(keys=js.keys.at[0].set(k0), values=js.values.at[0].set(v0),
                       overflow=js.overflow)
    ts = convert.store_from_numpy(np.asarray(js.keys), np.asarray(js.values),
                                  np.asarray(js.overflow), device="cpu")
    lo, hi = int(keys[10]), int(keys[29])
    plan = [("move", 0, 1), ("copy", 1, 2), ("reclaim", 1, 1)]
    for kind, src, dst in plan:
        js = JM.execute(js, [JM.MigrationOp(lo=lo, hi=hi, src=src, dst=dst, kind=kind)])
        ts = TM.execute(ts, [TM.MigrationOp(lo=lo, hi=hi, src=src, dst=dst, kind=kind)])
        assert np.array_equal(np.asarray(js.keys), convert.store_to_numpy(ts)["keys"])
        assert _eq_vals(js.values, ts.values)
    assert np.array_equal(np.asarray(JS.store_fill(js)), TS.store_fill(ts).numpy())
