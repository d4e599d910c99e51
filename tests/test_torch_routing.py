"""Port routing against the JAX reference, bit for bit: ``hash_key``,
``lookup_range``, ``route`` and ``route_load_aware`` on directories after
random split/merge/widen/narrow sequences run by the JAX ``Controller``
and carried across with ``repro_torch.convert``; plus the NO_NODE index
wrap the reference relies on (ROADMAP fault F2)."""

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
from repro.core import directory as JD
from repro.core import keys as JK
from repro.core import routing as JR
from repro_torch import convert, prng
from repro_torch.core import directory as TD
from repro_torch.core import keys as TK
from repro_torch.core import routing as TR


def _jax_tables(d):
    return {f: np.asarray(getattr(d, f)) for f in convert.DIRECTORY_FIELDS}


def _random_directory(seed, num_ranges=16, num_nodes=6, n_slots=48,
                      steps=30, hash_partitioned=False):
    """A JAX directory after a random control history."""
    rng = np.random.default_rng(seed)
    d = JC.make_directory(num_ranges, num_nodes, 2, r_max=4, n_slots=n_slots,
                          hash_partitioned=hash_partitioned)
    ctl = JC.Controller(d)
    load = rng.random(num_nodes)
    for _ in range(steps):
        live = ctl.live_ranges()
        r = int(rng.choice(live))
        act = rng.integers(0, 4)
        if act == 0:
            lo, hi = ctl.range_span(r)
            if hi - lo > 2:
                ctl.split_range(r, int(rng.integers(lo, hi)))
        elif act == 1 and ctl.children():
            ctl.merge_range(int(rng.choice(ctl.children())))
        elif act == 2:
            ctl.widen_chain(r, load)
        else:
            ctl.narrow_chain(r, 2)
    return ctl.directory()


def _both(seed, **kw):
    jd = _random_directory(seed, **kw)
    td = convert.directory_from_numpy(
        _jax_tables(jd), hash_partitioned=jd.hash_partitioned, device="cpu")
    return jd, td


def _queries(seed, B, V=2):
    rng = np.random.default_rng(seed + 1000)
    keys = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    keys[:4] = [0, 0xFFFFFFFF, 0x7FFFFFFF, 0x80000000]
    ops = rng.integers(0, 4, B).astype(np.int32)
    vals = rng.normal(size=(B, V)).astype(np.float32)
    jq = JC.make_queries(jnp.asarray(keys), jnp.asarray(ops), jnp.asarray(vals))
    tq = TR.make_queries(keys, ops, vals, device="cpu")
    return jq, tq


def _same_decision(jdec, tdec):
    for f in ("ridx", "target", "chain", "chain_len", "clength"):
        a, b = np.asarray(getattr(jdec, f)), getattr(tdec, f).numpy()
        assert a.shape == b.shape, f
        assert np.array_equal(a, b), f"decision.{f} diverges"


def _same_directory(jd, td):
    tn = convert.directory_to_numpy(td)
    for f, a in _jax_tables(jd).items():
        assert a.dtype == tn[f].dtype and np.array_equal(a, tn[f]), f


def test_hash_key_and_matching_value():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    keys[:6] = [0, 1, 0xFFFFFFFF, 0xFFFFFFFE, 0x80000000, 0x7FFFFFFF]
    a = np.asarray(JK.hash_key(jnp.asarray(keys)))
    b = TK.hash_key(torch.as_tensor(keys.astype(np.int64))).numpy()
    assert np.array_equal(a.astype(np.int64), b)
    for hp in (False, True):
        a = np.asarray(JK.matching_value(jnp.asarray(keys), hash_partitioned=hp))
        b = TK.matching_value(torch.as_tensor(keys.astype(np.int64)),
                              hash_partitioned=hp).numpy()
        assert np.array_equal(a.astype(np.int64), b)


def test_make_directory_matches():
    jd = JC.make_directory(24, 5, 3, r_max=4, n_slots=40, num_pods=2)
    td = TD.make_directory(24, 5, 3, r_max=4, n_slots=40, num_pods=2,
                           device="cpu")
    _same_directory(jd, td)


@pytest.mark.parametrize("seed", range(4))
def test_lookup_and_range_order_after_control_history(seed):
    jd, td = _both(seed)
    jq, tq = _queries(seed, 512)
    assert np.array_equal(np.asarray(JD.lookup_range(jd, jq.key)),
                          TD.lookup_range(td, tq.key).numpy())
    jo, jr = JD.range_order(jd)
    to, tr = TD.range_order(td)
    assert np.array_equal(np.asarray(jo), to.numpy())
    assert np.array_equal(np.asarray(jr), tr.numpy())
    assert np.array_equal(np.asarray(JD.node_load(jd)), TD.node_load(td).numpy())


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("hash_partitioned", [False, True])
def test_route_after_control_history(seed, hash_partitioned):
    jd, td = _both(seed, hash_partitioned=hash_partitioned)
    jq, tq = _queries(seed, 700)
    jdec, jd2 = JR.route(jd, jq)
    tdec, td2 = TR.route(td, tq)
    _same_decision(jdec, tdec)
    _same_directory(jd2, td2)


@pytest.mark.parametrize("seed", range(4))
def test_route_load_aware_after_control_history(seed):
    jd, td = _both(seed)
    jq, tq = _queries(seed, 700)
    rng = np.random.default_rng(seed)
    load = rng.integers(0, 50, jd.num_nodes).astype(np.uint32)
    jload = jnp.asarray(load)
    tload = convert.load_reg_from_numpy(load, device="cpu")
    jdec, jd2, jl2 = JR.route_load_aware(jd, jq, jload, jax.random.PRNGKey(seed))
    tdec, td2, tl2 = TR.route_load_aware(td, tq, tload, prng.PRNGKey(seed))
    _same_decision(jdec, tdec)
    _same_directory(jd2, td2)
    assert np.array_equal(np.asarray(jl2), convert.load_reg_to_numpy(tl2))
    # the plain p2c helper draws and picks exactly like the reference's
    jp, jpos = JR._p2c_pick(jdec.chain, jdec.chain_len, jload,
                            jax.random.PRNGKey(seed))
    tp, tpos = TR._p2c_pick(tdec.chain, tdec.chain_len, tload,
                            prng.PRNGKey(seed))
    assert np.array_equal(np.asarray(jp), tp.numpy())
    assert np.array_equal(np.asarray(jpos), tpos.numpy())


def test_load_registers_wrap_at_32_bits():
    jd, td = _both(1)
    jq, tq = _queries(1, 300)
    load = np.full(jd.num_nodes, 0xFFFFFFFE, np.uint32)
    jdec, _, jl2 = JR.route_load_aware(jd, jq, jnp.asarray(load),
                                       jax.random.PRNGKey(2))
    tdec, _, tl2 = TR.route_load_aware(
        td, tq, convert.load_reg_from_numpy(load, device="cpu"),
        prng.PRNGKey(2))
    _same_decision(jdec, tdec)
    assert np.array_equal(np.asarray(jl2), convert.load_reg_to_numpy(tl2))


def test_no_node_read_charges_last_node_like_reference():
    """F2: a read routed to a fully spliced (live, chain_len 0) chain has
    target NO_NODE, and the reference's ``.at[-1].add(mode="drop")`` wraps
    that index to node N-1 before dropping — so node N-1 is charged.  The
    port reproduces the wrap on purpose (``directory.wrap_node``)."""
    jd0 = JC.make_directory(8, 4, 2, r_max=3, n_slots=8)
    tabs = _jax_tables(jd0)
    tabs["chains"] = tabs["chains"].copy()
    tabs["chain_len"] = tabs["chain_len"].copy()
    tabs["chains"][3] = JD.NO_NODE
    tabs["chain_len"][3] = 0
    jd = JD.Directory(**{k: jnp.asarray(v) for k, v in tabs.items()})
    td = convert.directory_from_numpy(tabs, device="cpu")
    lo, hi = int(tabs["slot_lo"][3]), int(tabs["slot_hi"][3])
    keys = np.linspace(lo, hi, 16).astype(np.uint32)
    ops = np.zeros(16, np.int32)                  # GETs
    jq = JC.make_queries(jnp.asarray(keys), jnp.asarray(ops), value_dim=1)
    tq = TR.make_queries(keys, ops, device="cpu")
    load = np.zeros(4, np.uint32)
    jdec, _, jl = JR.route_load_aware(jd, jq, jnp.asarray(load),
                                      jax.random.PRNGKey(0))
    tdec, _, tl = TR.route_load_aware(
        td, tq, convert.load_reg_from_numpy(load, device="cpu"),
        prng.PRNGKey(0))
    _same_decision(jdec, tdec)
    assert (tdec.target.numpy() == JD.NO_NODE).all()
    assert np.array_equal(np.asarray(jl), convert.load_reg_to_numpy(tl))
    assert convert.load_reg_to_numpy(tl).tolist() == [0, 0, 0, 16]


def test_expand_scans_matches():
    jd, td = _both(2)
    rng = np.random.default_rng(5)
    B = 64
    keys = rng.integers(0, 2**32 - 2**28, B, dtype=np.uint64).astype(np.uint32)
    ends = (keys.astype(np.uint64) + rng.integers(0, 2**28, B)).astype(np.uint32)
    ops = np.where(rng.random(B) < 0.5, JK.OP_SCAN, JK.OP_GET).astype(np.int32)
    vals = rng.normal(size=(B, 3)).astype(np.float32)
    jq = JC.make_queries(jnp.asarray(keys), jnp.asarray(ops), jnp.asarray(vals),
                         jnp.asarray(ends))
    tq = TR.make_queries(keys, ops, vals, ends, device="cpu")
    a = JR.expand_scans(jd, jq, max_scan_fanout=4)
    b = TR.expand_scans(td, tq, max_scan_fanout=4)
    for f in ("opcode", "key", "end_key", "value"):
        assert np.array_equal(np.asarray(getattr(a, f)).astype(
            getattr(b, f).numpy().dtype), getattr(b, f).numpy()), f


def test_sketch_and_pull_report_match_reference():
    """Count-min update / query (carried across with ``convert``) and the
    controller's report (counters, node load) after routed batches."""
    from repro.core import stats as JSt
    from repro_torch.core import stats as TSt

    jd, td = _both(3)
    js = JSt.make_sketch(64, 4)
    ts = convert.sketch_from_numpy(np.asarray(js), device="cpu")
    for step in range(3):
        jq, tq = _queries(step, 400)
        _, jd = JR.route(jd, jq)
        _, td = TR.route(td, tq)
        js = JSt.sketch_update(js, jq.key)
        ts = TSt.sketch_update(ts, tq.key)
        assert np.array_equal(np.asarray(js), convert.sketch_to_numpy(ts))
    jq, tq = _queries(9, 300)
    assert np.array_equal(np.asarray(JSt.sketch_query(js, jq.key)).astype(np.int64),
                          TSt.sketch_query(ts, tq.key).numpy())
    jr, jd2 = JSt.pull_report(jd, 4)
    tr, td2 = TSt.pull_report(td, 4)
    for f in ("read_count", "write_count", "node_load", "live"):
        a, b = getattr(jr, f), getattr(tr, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    _same_directory(jd2, td2)
