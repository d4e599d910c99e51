"""Hop plans and the DES timing engine against the JAX reference, bit for
bit: ``plan_hops`` in all three coordination modes, and the port's
``simulate`` / ``simulate_closed_loop`` (its own copy of the C event
core) against the reference engine and against the heapq oracles of both
packages, on stacked scenario batches too."""

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
from repro_torch import convert, prng
from repro_torch.core import coordination as TCo
from repro_torch.core import des as TDes
from repro_torch.core import routing as TR


def _random_plan(rng, B, H, N, dead=0.3):
    nodes = rng.integers(0, N, (B, H)).astype(np.int32)
    nodes[rng.random((B, H)) < dead] = -1
    nodes[0, :] = -1                       # an all-NO_HOP query (shed-like)
    service = rng.uniform(0.5, 20.0, (B, H)).astype(np.float32)
    service[nodes == -1] = 0.0
    reply = ((nodes != -1).sum(1) + 1).astype(np.float32)
    return nodes, service, reply


def _plans(nodes, service, reply):
    jp = JC.HopPlan(nodes=jnp.asarray(nodes), service=jnp.asarray(service),
                    reply_links=jnp.asarray(reply))
    tp = TCo.HopPlan(nodes=torch.tensor(nodes), service=torch.tensor(service),
                     reply_links=torch.tensor(reply))
    return jp, tp


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_clients", [1, 8, 64])
def test_closed_loop_matches_reference_engine_and_oracles(seed, n_clients):
    rng = np.random.default_rng(seed)
    N = 6
    jp, tp = _plans(*_random_plan(rng, 300, 4, N))
    jl, jm = JC.simulate_closed_loop(jp, n_clients=n_clients, num_nodes=N,
                                     link=1.0)
    tl, tm, ti, th = TDes.simulate_closed_loop(
        tp, n_clients=n_clients, num_nodes=N, link=1.0, return_issue=True,
        return_hops=True)
    assert np.array_equal(_bits(jl), _bits(tl.numpy()))
    assert _bits(jm) == _bits(tm.numpy())
    ol, om, oh = TCo.simulate_closed_loop_reference(
        tp, n_clients=n_clients, num_nodes=N, link=1.0, return_hops=True)
    assert np.array_equal(_bits(ol.numpy()), _bits(tl.numpy()))
    assert _bits(om.numpy()) == _bits(tm.numpy())
    assert np.array_equal(oh, th)
    jl2, jm2 = JC.simulate_closed_loop_reference(
        jp, n_clients=n_clients, num_nodes=N, link=1.0)
    assert np.array_equal(_bits(jl2), _bits(tl.numpy()))
    _, _, ji = JC.simulate_closed_loop(jp, n_clients=n_clients, num_nodes=N,
                                       link=1.0, return_issue=True)
    assert np.array_equal(np.asarray(ji), ti)


@pytest.mark.parametrize("seed", range(3))
def test_open_loop_matches_reference(seed):
    rng = np.random.default_rng(seed + 10)
    N = 5
    nodes, service, reply = _random_plan(rng, 200, 3, N)
    arrivals = np.sort(rng.uniform(0, 300, 200)).astype(np.float32)
    jp, tp = _plans(nodes, service, reply)
    jl, jm = JC.simulate(jp, jnp.asarray(arrivals), num_nodes=N, link=1.5)
    tl, tm = TDes.simulate(tp, torch.tensor(arrivals), num_nodes=N, link=1.5)
    assert np.array_equal(_bits(jl), _bits(tl.numpy()))
    assert _bits(jm) == _bits(tm.numpy())
    rl, rm = TCo.simulate_reference(tp, arrivals, num_nodes=N, link=1.5)
    assert np.array_equal(_bits(rl.numpy()), _bits(tl.numpy()))


def test_stacked_plans_equal_separate_calls():
    rng = np.random.default_rng(3)
    N = 4
    parts = [_random_plan(rng, 128, h, N) for h in (2, 3, 4)]
    tplans = [_plans(*p)[1] for p in parts]
    jplans = [_plans(*p)[0] for p in parts]
    ts = TDes.stack_plans(tplans)
    js = JC.stack_plans(jplans)
    assert np.array_equal(np.asarray(js.nodes), ts.nodes.numpy())
    tl, tm = TDes.simulate_closed_loop(ts, n_clients=16, num_nodes=N)
    jl, jm = JC.simulate_closed_loop(js, n_clients=16, num_nodes=N)
    assert np.array_equal(_bits(jl), _bits(tl.numpy()))
    assert np.array_equal(_bits(jm), _bits(tm.numpy()))
    for i, tp in enumerate(tplans):
        l1, m1 = TDes.simulate_closed_loop(tp, n_clients=16, num_nodes=N)
        assert np.array_equal(_bits(l1.numpy()), _bits(tl[i].numpy()))


def _routed(seed, spread):
    rng = np.random.default_rng(seed)
    N, B = 6, 256
    jd = JC.make_directory(16, N, 2, r_max=4, n_slots=24)
    tabs = {f: np.asarray(getattr(jd, f)).copy() for f in convert.DIRECTORY_FIELDS}
    tabs["chain_len"][3] = 3
    tabs["chains"][3, 2] = (tabs["chains"][3, 1] + 2) % N
    tabs["chains"][7] = -1
    tabs["chain_len"][7] = 0
    jd = JC.Directory(**{k: jnp.asarray(v) for k, v in tabs.items()})
    td = convert.directory_from_numpy(tabs, device="cpu")
    keys = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    ops = rng.integers(0, 3, B).astype(np.int32)
    jq = JC.make_queries(jnp.asarray(keys), jnp.asarray(ops), value_dim=1)
    tq = TR.make_queries(keys, ops, device="cpu")
    if spread:
        load = np.zeros(N, np.uint32)
        jdec, _, _ = JC.route_load_aware(jd, jq, jnp.asarray(load),
                                         jax.random.PRNGKey(seed))
        tdec, _, _ = TR.route_load_aware(td, tq, torch.zeros(N, dtype=torch.int64),
                                         prng.PRNGKey(seed))
    else:
        jdec, _ = JC.route(jd, jq)
        tdec, _ = TR.route(td, tq)
    return N, jq, jdec, tq, tdec


@pytest.mark.parametrize("mode", ["in_switch", "client_driven", "server_driven"])
@pytest.mark.parametrize("cap", [None, 2])
def test_plan_hops_matches_reference(mode, cap):
    N, jq, jdec, tq, tdec = _routed(1, spread=cap is not None)
    model = JC.LatencyModel()
    jp = JC.plan_hops(jq, jdec, mode, model, rng=jax.random.PRNGKey(4),
                      num_nodes=N, write_chain_cap=cap)
    tp = TCo.plan_hops(tq, tdec, mode, TCo.LatencyModel(), rng=prng.PRNGKey(4),
                       num_nodes=N, write_chain_cap=cap)
    assert np.array_equal(np.asarray(jp.nodes), tp.nodes.numpy())
    assert np.array_equal(_bits(jp.service), _bits(tp.service.numpy()))
    assert np.array_equal(_bits(jp.reply_links), _bits(tp.reply_links.numpy()))


def test_plan_hops_pareto_service_matches_reference():
    """The uniform draws and the Pareto transform's float32 ``pow`` (the
    C library's ``powf``, which XLA's CPU power equals) are bit-identical,
    so the service column is held to 0 ulp."""
    N, jq, jdec, tq, tdec = _routed(2, spread=False)
    jp = JC.plan_hops(jq, jdec, "in_switch", JC.LatencyModel(),
                      rng=jax.random.PRNGKey(8), num_nodes=N,
                      service_model=JC.ServiceModel(kind="pareto"))
    tp = TCo.plan_hops(tq, tdec, "in_switch", TCo.LatencyModel(),
                       rng=prng.PRNGKey(8), num_nodes=N,
                       service_model=TCo.ServiceModel(kind="pareto"))
    assert np.array_equal(np.asarray(jp.nodes), tp.nodes.numpy())
    ulps = np.abs(_bits(jp.service).astype(np.int64)
                  - _bits(tp.service.numpy()).astype(np.int64))
    assert ulps.max() == 0


# ROADMAP fault F14: the lognormal multiplier's largest ulp gap to the
# reference's compiled draw at the default sigma 0.6 (measured: <= 4 ulp in
# about a tenth of the draws; <= 7 at sigma 1.0)
F14_ULP = 4


def _ulps(a, b):
    return np.abs(_bits(a).astype(np.int64) - _bits(b).astype(np.int64))


@pytest.mark.parametrize("sigma,seed,shape,n_diff,max_ulp", [
    (0.6, 0, (200_000,), 19820, 4), (0.6, 5, (400, 500), 20120, 3),
    (1.0, 0, (200_000,), 19919, 4), (1.0, 5, (400, 500), 19967, 7)])
def test_lognormal_service_not_ported_yet(sigma, seed, shape, n_diff,
                                          max_ulp):
    """``ServiceModel("lognormal")`` is ported: its draw against the
    reference's compiled draw (the argument a fused multiply-add with
    sqrt(2) * sigma folded into one constant), held to the measured
    count of differing draws and largest ulp gap (F14).  The name is the
    one the test had while the port refused the model."""
    jsm = JC.ServiceModel(kind="lognormal", sigma=sigma)
    want = np.asarray(jax.jit(lambda k: jsm.draw(k, shape))(
        jax.random.PRNGKey(seed)))
    got = TCo.ServiceModel(kind="lognormal", sigma=sigma).draw(
        prng.PRNGKey(seed), shape, "cpu").numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    d = _ulps(want, got)
    assert int((d > 0).sum()) == n_diff and int(d.max()) == max_ulp


@pytest.mark.parametrize("mode", ["in_switch", "server_driven"])
@pytest.mark.parametrize("spread", [False, True])
def test_plan_hops_lognormal_service_within_f14(mode, spread):
    """The hop plan with lognormal service against the reference's jitted
    ``plan_hops`` (the driver's step compiles it): nodes bitwise, the
    service column within F14's bound."""
    N, jq, jdec, tq, tdec = _routed(2, spread=spread)
    plan = jax.jit(lambda q, d, k: JC.plan_hops(
        q, d, mode, JC.LatencyModel(), rng=k, num_nodes=N,
        service_model=JC.ServiceModel(kind="lognormal")))
    jp = plan(jq, jdec, jax.random.PRNGKey(8))
    tp = TCo.plan_hops(tq, tdec, mode, TCo.LatencyModel(),
                       rng=prng.PRNGKey(8), num_nodes=N,
                       service_model=TCo.ServiceModel(kind="lognormal"))
    assert np.array_equal(np.asarray(jp.nodes), tp.nodes.numpy())
    assert np.array_equal(_bits(jp.reply_links), _bits(tp.reply_links.numpy()))
    d = _ulps(jp.service, tp.service.numpy())
    assert 0 < int((d > 0).sum()) and int(d.max()) <= F14_ULP


def test_service_model_draws_are_reproducible_and_mean_one():
    """The port's counterpart of ``tests/test_split.py``'s case."""
    for kind in ("lognormal", "pareto"):
        sm = TCo.ServiceModel(kind=kind)
        a = sm.draw(prng.PRNGKey(4), (100_000,), "cpu")
        b = sm.draw(prng.PRNGKey(4), (100_000,), "cpu")
        assert torch.equal(a, b)
        assert abs(float(a.mean()) - 1.0) < 0.02
    with pytest.raises(ValueError):
        TCo.ServiceModel(kind="pareto", alpha=0.9).draw(
            prng.PRNGKey(0), (8,), "cpu")


def test_des_falls_back_to_the_oracle_without_a_compiler(monkeypatch,
                                                         tmp_path):
    """With no C compiler the core cannot be built: ``backend=None`` /
    ``"auto"`` time with the heapq oracle under a ``RuntimeWarning`` that
    says why, bit for bit with the native core on a small stacked plan
    (issue and per-hop times too); ``"native"`` still raises."""
    from repro_torch.core import _des_native

    rng = np.random.default_rng(9)
    N = 5
    plans = [TCo.HopPlan(*(torch.tensor(x) for x in _random_plan(rng, 120, 4, N)))
             for _ in range(3)]
    stacked = TDes.stack_plans(plans)
    kw = dict(n_clients=8, num_nodes=N, return_issue=True, return_hops=True)
    native = TDes.simulate_closed_loop(stacked, **kw, backend="native")
    open_native = TDes.simulate(plans[0], torch.zeros(120, dtype=torch.float64),
                                num_nodes=N, return_hops=True)
    monkeypatch.setattr(_des_native, "_lib", None)
    monkeypatch.setattr(_des_native, "_error", None)
    monkeypatch.setattr(_des_native, "_CACHE", tmp_path / "cache")
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    with pytest.warns(RuntimeWarning, match="cannot be built"):
        fallback = TDes.simulate_closed_loop(stacked, **kw)
    assert not _des_native.available()
    for a, b in zip(native, fallback):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.warns(RuntimeWarning):
        open_fb = TDes.simulate(plans[0], torch.zeros(120, dtype=torch.float64),
                                num_nodes=N, return_hops=True, backend="auto")
    for a, b in zip(open_native, open_fb):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(FileNotFoundError):
        TDes.simulate_closed_loop(stacked, **kw, backend="native")


def test_available_backends_lists_the_native_core_and_the_oracle(monkeypatch,
                                                                tmp_path):
    """The counterpart of the reference's ``available_backends``: the
    native core when it builds, and the heapq oracle always (the
    reference's fallback is its XLA engine).  The oracle is what
    ``None`` / ``"auto"`` falls back to, not a backend a caller may name:
    only ``"native"`` is accepted.  The two give the same bits."""
    from repro_torch.core import _des_native

    assert JC.des.available_backends() == ("native", "jax")
    assert TDes.available_backends() == ("native", "reference")
    rng = np.random.default_rng(2)
    plan = TCo.HopPlan(*(torch.tensor(x) for x in _random_plan(rng, 64, 3, 4)))
    native = TDes.simulate_closed_loop(plan, n_clients=4, num_nodes=4,
                                       backend="native")
    oracle = TCo.simulate_closed_loop_reference(plan, n_clients=4, num_nodes=4)
    assert torch.equal(torch.as_tensor(native[0]), torch.as_tensor(oracle[0]))
    assert float(native[1]) == float(oracle[1])
    for name in ("reference", "jax"):
        with pytest.raises(ValueError, match="unknown DES backend"):
            TDes.simulate_closed_loop(plan, n_clients=4, num_nodes=4,
                                      backend=name)
    monkeypatch.setattr(_des_native, "_lib", None)
    monkeypatch.setattr(_des_native, "_error", None)
    monkeypatch.setattr(_des_native, "_CACHE", tmp_path / "cache")
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    assert TDes.available_backends() == ("reference",)
    with pytest.warns(RuntimeWarning, match="cannot be built"):
        assert TDes.resolve_backend(None) == "reference"
