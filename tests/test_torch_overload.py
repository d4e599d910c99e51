"""The overload plane and slot-pool growth against the JAX reference, bit
for bit, on ``tests/test_overload.py``'s own inputs: the state-level
dynamics (``overload.step`` under random streams, closed admission,
overrun, retry budgets, service inflation, the retry-orbit register), the
hop plan with shed and scaled queries, the ``queue_pen`` fold through
``route_load_aware`` / ``route_load_aware_dirty`` and K2's / K3's plain
versions (a sum that wraps past 2**32 too), and the closed loop: the
port's ``EpochDriver`` with the plane on equals the reference's, rows
(``dataclasses.asdict``), final ``OverloadState``, store and chains, on
the cascade and retry-storm scenarios (fused and per-epoch), with standby
capacity, autoscale down, the adaptive pull cadence, chunked p2c and
craq; the backpressure policy's control units; ``split_overflow`` pool
growth with and without the coordination tier; and fault F11, the
float32 service multiplier the reference's compiled step computes."""

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

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import cluster as JCl
from repro import core as JC
from repro import overload as JO
from repro.cluster.policies import OverloadAdaptivePolicy as JOAP
from repro.cluster.policies import PolicyConfig as JPC
from repro.coordination_tier import CoordConfig as JCoordConfig
from repro.core.routing import route_load_aware as j_route_load_aware
from repro.core.routing import route_load_aware_dirty as j_route_dirty
from repro.core.stats import StatsReport as JReport
from repro_torch import cluster as TCl
from repro_torch import convert, prng
from repro_torch import overload as TO
from repro_torch.cluster.policies import OverloadAdaptivePolicy as TOAP
from repro_torch.cluster.policies import PolicyConfig as TPC
from repro_torch.coordination_tier import CoordConfig as TCoordConfig
from repro_torch.core import controller as TCtl
from repro_torch.core import coordination as TCo
from repro_torch.core import directory as TD
from repro_torch.core import routing as TR
from repro_torch.core.stats import StatsReport as TReport
from repro_torch.kernels.range_match import ops as TOPS
from repro_torch.kernels.range_match import ref as TREF

SCFG = dict(n_epochs=6, epoch_ops=256, n_records=512, value_dim=2, seed=3)
OCFG = dict(queue_cap=32, service_rate=24, inflation=3.0, max_level=3,
            queue_weight=2)


def _ocfgs(**kw):
    """The same OverloadConfig in both packages."""
    return JO.OverloadConfig(**kw), TO.OverloadConfig(**kw)


# ---------------------------------------------------------------------------
# state-level dynamics
# ---------------------------------------------------------------------------

def _assert_state_equal(js, ts):
    got = convert.overload_to_numpy(ts)
    for f in convert.OVERLOAD_FIELDS:
        want = np.asarray(getattr(js, f))
        assert want.dtype == got[f].dtype and np.array_equal(want, got[f]), f


def _drive(kw, n_nodes, batches, admit_prob=None, retry_budget=None, seed=0,
           jit=True):
    """Feed (B,) target arrays through both packages' ``step``: every
    epoch's rejected / service_scale / outcome / stats and the final state
    must match bit for bit.  Returns both final states and the stats."""
    jcfg, tcfg = _ocfgs(**kw)
    js = JO.make_state(n_nodes, jcfg)
    ts = TO.make_state(n_nodes, tcfg, device="cpu")
    if admit_prob is not None:
        js = dataclasses.replace(js, admit_prob=jnp.asarray(admit_prob, jnp.float32))
        ts = dataclasses.replace(ts, admit_prob=torch.tensor(
            np.asarray(admit_prob, np.float32)))
    if retry_budget is not None:
        js = dataclasses.replace(js, retry_budget=jnp.asarray(retry_budget, jnp.int32))
        ts = dataclasses.replace(ts, retry_budget=torch.tensor(
            np.asarray(retry_budget, np.int32)))
    jstep = jax.jit(JO.step, static_argnums=(3,)) if jit else JO.step
    jr, tr = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    rows = []
    for i, t in enumerate(batches):
        js, *jout = jstep(js, jnp.asarray(t, jnp.int32),
                          jax.random.fold_in(jr, i), jcfg)
        ts, *tout = TO.step(ts, torch.tensor(np.asarray(t, np.int64)),
                            prng.fold_in(tr, i), tcfg)
        for name, a, b in zip(("rejected", "service_scale", "outcome",
                               "stats"), jout, tout):
            a, b = np.asarray(a), b.numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, name)
        rows.append(tout[3].numpy())
    _assert_state_equal(js, ts)
    return js, ts, np.stack(rows)


@pytest.mark.parametrize("trial", range(3))
def test_conservation_random_streams_match_reference(trial):
    rng = np.random.default_rng(0)
    for t in range(trial + 1):
        n = int(rng.integers(2, 7))
        kw = dict(queue_cap=int(rng.integers(4, 40)),
                  service_rate=int(rng.integers(2, 30)),
                  max_level=int(rng.integers(1, 5)),
                  backoff_base=int(rng.integers(1, 3)),
                  jitter_span=int(rng.integers(0, 3)))
        batches = [rng.integers(-1, n, size=64) for _ in range(12)]
    _, ts, rows = _drive(kw, n, batches, seed=trial)
    assert TO.conservation_gap(ts) == 0
    s = TO.summary(ts)
    assert rows[:, 0].sum() == s["injected"]
    assert rows[:, 5].sum() == s["lost"]


def test_negative_targets_outside_the_plane():
    _, ts, rows = _drive(dict(queue_cap=8, service_rate=4), 4,
                         [np.full(32, -1)])
    assert TO.summary(ts)["injected"] == 0
    assert rows[0].sum() == 0


def test_closed_admission_defers_everything():
    _, ts, _ = _drive(dict(queue_cap=8, service_rate=4), 2,
                      [np.zeros(32, np.int64)] * 3, admit_prob=np.zeros(2))
    s = TO.summary(ts)
    assert s["deferred"] == s["injected"] == 96
    assert s["admitted"] == s["shed"] == 0


def test_overrun_sheds_then_loses():
    _, ts, _ = _drive(dict(queue_cap=4, service_rate=1, max_level=2,
                           backoff_base=1, jitter_span=0), 2,
                      [np.zeros(64, np.int64) for _ in range(10)])
    s = TO.summary(ts)
    assert s["shed"] > 0 and s["lost"] > 0
    assert TO.conservation_gap(ts) == 0
    assert int(ts.queue[1]) == 0 and int(ts.retry[1].sum()) == 0


def test_retry_budget_caps_reentry():
    _, ts, rows = _drive(dict(queue_cap=64, service_rate=64, max_level=4,
                              backoff_base=1, jitter_span=0), 2,
                         [np.zeros(256, np.int64)] + [np.full(256, -1)] * 6,
                         retry_budget=np.full(2, 5))
    assert rows[1:, 4].max() <= 5
    assert TO.conservation_gap(ts) == 0


@pytest.mark.parametrize("jit", [True, False])
def test_service_scale_inflates_with_occupancy(jit):
    """The reference's test calls ``step`` eagerly; at (10, 3.0) the eager
    and the compiled step give the same multipliers at the occupancies
    this stream reaches, so the port matches both."""
    _, ts, _ = _drive(dict(queue_cap=10, service_rate=2, inflation=3.0), 1,
                      [np.zeros(8, np.int64)] * 2, jit=jit)
    tcfg = TO.OverloadConfig(queue_cap=10, service_rate=2, inflation=3.0)
    st = TO.make_state(1, tcfg, device="cpu")
    rng = prng.PRNGKey(0)
    st, _, scale0, _, _ = TO.step(st, torch.zeros(8, dtype=torch.int64), rng, tcfg)
    st, _, scale1, _, _ = TO.step(st, torch.zeros(8, dtype=torch.int64), rng, tcfg)
    assert float(scale0.max()) == 1.0
    assert float(scale1.max()) > 1.0


def test_link_orbit_matches_reference():
    """The retry-orbit identity register at 2**6 slots: rejected queries
    stamp their slot's birth epoch (scatter-min), admitted queries read
    and clear it; key collisions included."""
    jcfg, tcfg = _ocfgs(queue_cap=6, service_rate=3, max_level=2)
    js = JO.make_state(3, jcfg, link_bits=6)
    ts = TO.make_state(3, tcfg, link_bits=6, device="cpu")
    _assert_state_equal(js, ts)
    rng = np.random.default_rng(5)
    keys = rng.choice(2**32 - 2, 24, replace=False).astype(np.uint32)
    jstep = jax.jit(JO.step, static_argnums=(3,))
    born = 0
    for e in range(8):
        k = rng.choice(keys, 40)                    # repeats -> collisions
        t = rng.integers(-1, 3, 40)
        js, jrej, _, jout, _ = jstep(js, jnp.asarray(t, jnp.int32),
                                     jax.random.PRNGKey(e), jcfg)
        ts, trej, _, tout, _ = TO.step(ts, torch.tensor(t), prng.PRNGKey(e), tcfg)
        js, jfirst = JO.link_orbit(js, jnp.asarray(k), jrej,
                                   jout == JO.OUTCOME_ADMITTED, e)
        ts, tfirst = TO.link_orbit(ts, torch.tensor(k.astype(np.int64)), trej,
                                   tout == TO.OUTCOME_ADMITTED, e)
        assert np.array_equal(np.asarray(jfirst), tfirst.numpy()), e
        _assert_state_equal(js, ts)
        born += int((tfirst >= 0).sum())
    assert born > 0
    assert int((ts.first_seen < TO.ORBIT_EMPTY).sum()) > 0
    # the placeholder register is a no-op
    st = TO.make_state(3, tcfg, device="cpu")
    st2, first = TO.link_orbit(st, torch.arange(4), torch.ones(4, dtype=torch.bool),
                               torch.zeros(4, dtype=torch.bool), 1)
    assert st2 is st and bool((first == -1).all())


# ---------------------------------------------------------------------------
# F11: the float32 service multiplier
# ---------------------------------------------------------------------------

def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("cap,inflation", [
    (32, 2.7), (7, 3.0), (26, 3.0), (100, 3.0), (6144, 2.5), (32, 3.0),
    (6144, 3.0)])
def test_service_scale_matches_compiled_reference(cap, inflation):
    """F11: the reference's compiled step computes ``1 + inflation * occ /
    queue_cap`` as ``fma(occ, f32(f32(1 / cap) * inflation), 1)`` (XLA's
    rewrites), not as three float32 steps.  Every occupancy a node can
    admit at, one query a node: the port differs from the reference in 0
    multipliers (0 ulp); the plain float32 steps differ where the two
    roundings disagree (at (32, 2.7) in 5 of 32, each by 1 ulp)."""
    n = min(cap, 2048)
    occ = np.linspace(0, cap - 1, n).astype(np.int32)
    jcfg, tcfg = _ocfgs(queue_cap=cap, service_rate=1, inflation=inflation)
    js = dataclasses.replace(JO.make_state(n, jcfg), queue=jnp.asarray(occ))
    ts = dataclasses.replace(TO.make_state(n, tcfg, device="cpu"),
                             queue=torch.tensor(occ))
    t = np.arange(n)
    _, _, jscale, jout, _ = jax.jit(JO.step, static_argnums=(3,))(
        js, jnp.asarray(t, jnp.int32), jax.random.PRNGKey(1), jcfg)
    _, _, tscale, tout, _ = TO.step(ts, torch.tensor(t), prng.PRNGKey(1), tcfg)
    assert bool((tout == TO.OUTCOME_ADMITTED).all())
    want = np.asarray(jscale)
    got = tscale.numpy()
    d = _ulps(want, got)
    assert (int((d > 0).sum()), int(d.max())) == (0, 0)
    plain = (np.float32(1.0) + np.float32(inflation)
             * (occ.astype(np.float32) / np.float32(cap))).astype(np.float32)
    dp = _ulps(want, plain)
    if (cap, inflation) == (32, 2.7):
        assert (int((dp > 0).sum()), int(dp.max())) == (5, 1)


# ---------------------------------------------------------------------------
# hop plans and queue-aware routing
# ---------------------------------------------------------------------------

def _dir_pair(num_ranges, num_nodes, replication):
    jd = JC.make_directory(num_ranges, num_nodes, replication)
    td = convert.directory_from_numpy(
        {f: np.asarray(getattr(jd, f)) for f in convert.DIRECTORY_FIELDS},
        device="cpu")
    return jd, td


def test_plan_hops_shed_and_scale_match_reference():
    jd, td = _dir_pair(8, 4, 2)
    keys = np.arange(16, dtype=np.uint32) * 1000 + 5
    ops = np.full(16, JC.OP_GET, np.int32)
    jq = JC.make_queries(jnp.asarray(keys), jnp.asarray(ops), value_dim=2)
    tq = TR.make_queries(keys, ops, value_dim=2, device="cpu")
    jdec, _ = JC.route(jd, jq)
    tdec, _ = TR.route(td, tq)
    shed = np.zeros(16, bool)
    shed[3] = True
    scale = np.ones(16, np.float32)
    scale[5] = 4.0
    lat = JC.LatencyModel()
    jp = JC.plan_hops(jq, jdec, "in_switch", lat, rng=jax.random.PRNGKey(1),
                      num_nodes=4, shed=jnp.asarray(shed),
                      service_scale=jnp.asarray(scale))
    tp = TCo.plan_hops(tq, tdec, "in_switch", TCo.LatencyModel(),
                       rng=prng.PRNGKey(1), num_nodes=4,
                       shed=torch.tensor(shed), service_scale=torch.tensor(scale))
    base = TCo.plan_hops(tq, tdec, "in_switch", TCo.LatencyModel(),
                         rng=prng.PRNGKey(1), num_nodes=4)
    for f in ("nodes", "service", "reply_links"):
        assert np.array_equal(np.asarray(getattr(jp, f)),
                              getattr(tp, f).numpy()), f
    assert int(tp.nodes[3].max()) == TCo.NO_HOP
    assert float(tp.service[3].sum()) == 0.0
    assert float(tp.reply_links[3]) <= float(base.reply_links[3])
    assert torch.equal(tp.service[5], base.service[5] * 4.0)


def _pen_inputs(wrap: bool):
    rng0 = np.random.default_rng(7)
    keys = rng0.choice(2**32 - 2, 64, replace=False).astype(np.uint32)
    load = rng0.integers(0, 50, 8).astype(np.uint32)
    qpen = rng0.integers(0, 30, 8).astype(np.uint32)
    if wrap:
        # the sum wraps past 2**32 on most nodes: the effective loads
        # order differently than the raw ones
        load = (np.uint32(2**32 - 40) + load).astype(np.uint32)
    return keys, load, qpen


@pytest.mark.parametrize("wrap", [False, True])
def test_queue_pen_routing_matches_reference_and_kernel_fold(wrap):
    """route_load_aware(queue_pen=) in both packages, and K2's plain
    version fed the folded registers: the same targets, the registers
    bumped raw."""
    jd, td = _dir_pair(16, 8, 3)
    keys, load, qpen = _pen_inputs(wrap)
    ops = np.full(64, JC.OP_GET, np.int32)
    jq = JC.make_queries(jnp.asarray(keys), jnp.asarray(ops), value_dim=2)
    tq = TR.make_queries(keys, ops, value_dim=2, device="cpu")
    jl, tl = jnp.asarray(load), torch.tensor(load.astype(np.int64))
    jqp, tqp = jnp.asarray(qpen), torch.tensor(qpen.astype(np.int64))
    jr, tr = jax.random.PRNGKey(3), prng.PRNGKey(3)
    ja, _, jload = j_route_load_aware(jd, jq, jl, jr, queue_pen=jqp)
    ta, _, tload = TR.route_load_aware(td, tq, tl, tr, queue_pen=tqp)
    assert np.array_equal(np.asarray(ja.target), ta.target.numpy())
    assert np.array_equal(np.asarray(jload), tload.numpy())
    # the fold, through the wrapper and K2's plain version directly
    folded = (load.astype(np.int64) + qpen) & 0xFFFFFFFF
    tb, _, _ = TR.route_load_aware(td, tq, torch.tensor(folded), tr)
    assert torch.equal(ta.target, tb.target)
    ridx, target, chain = TOPS.range_match_spread(td, tq.key, tq.opcode, tl, tr,
                                                  queue_pen=tqp)
    args = TOPS._spread_inputs(td, tq.key, tq.opcode, torch.tensor(folded), tr)
    want = TREF.range_match_spread_ref(*args, num_slots=td.num_slots)
    for a, b in zip((ridx, target, chain), want):
        assert torch.equal(a, b)
    assert torch.equal(target.to(torch.int64), ta.target)
    # the penalty moved some picks (the steer is live)
    tc, _, _ = TR.route_load_aware(td, tq, tl, tr)
    assert not torch.equal(tc.target, ta.target)
    # queue_pen=None is the plain call
    td2, _, _ = TR.route_load_aware(td, tq, tl, tr, queue_pen=None)
    assert torch.equal(td2.target, tc.target)


@pytest.mark.parametrize("wrap", [False, True])
def test_queue_pen_craq_matches_reference_and_kernel_fold(wrap):
    """route_load_aware_dirty(queue_pen=) in both packages, and K3's plain
    version fed the folded registers."""
    jd, td = _dir_pair(16, 8, 3)
    keys, load, qpen = _pen_inputs(wrap)
    rng = np.random.default_rng(9)
    ops = np.where(rng.random(64) < 0.8, JC.OP_GET, JC.OP_PUT).astype(np.int32)
    dirty = rng.random((td.num_slots, td.r_max)) < 0.4
    jq = JC.make_queries(jnp.asarray(keys), jnp.asarray(ops), value_dim=2)
    tq = TR.make_queries(keys, ops, value_dim=2, device="cpu")
    jl, tl = jnp.asarray(load), torch.tensor(load.astype(np.int64))
    jqp, tqp = jnp.asarray(qpen), torch.tensor(qpen.astype(np.int64))
    jr, tr = jax.random.PRNGKey(4), prng.PRNGKey(4)
    jout = j_route_dirty(jd, jq, jl, jnp.asarray(dirty), jr, queue_pen=jqp)
    tout = TR.route_load_aware_dirty(td, tq, tl, torch.tensor(dirty), tr,
                                     queue_pen=tqp)
    assert np.array_equal(np.asarray(jout[0].target), tout[0].target.numpy())
    assert np.array_equal(np.asarray(jout[2]), tout[2].numpy())
    assert np.array_equal(np.asarray(jout[3]), tout[3].numpy())
    assert np.array_equal(np.asarray(jout[4]), tout[4].numpy())
    folded = torch.tensor((load.astype(np.int64) + qpen) & 0xFFFFFFFF)
    got = TOPS.range_match_spread_dirty(td, tq.key, tq.opcode, tl,
                                        torch.tensor(dirty), tr, queue_pen=tqp)
    want = TREF.range_match_spread_dirty_ref(
        *TOPS._spread_inputs(td, tq.key, tq.opcode, folded, tr),
        TOPS.pack_dirty(torch.tensor(dirty)), None, None,
        num_slots=td.num_slots)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the closed loop
# ---------------------------------------------------------------------------

# (scenario, policy, overload knobs or None, cluster knobs, scenario
# knobs, PolicyConfig knobs or None): tests/test_overload.py's runs, plus
# chunked p2c and craq with the plane on
RUNS = {
    "cascade": ("cascade_failure", "overload_adaptive", OCFG, {}, {}, None),
    "retry_storm": ("retry_storm", "overload_adaptive", OCFG, {}, {}, None),
    "disabled": ("shifting_hotspot", "full_adaptive", None, {}, {}, None),
    "standby_cascade": ("cascade_failure", "overload_adaptive", OCFG,
                        dict(num_nodes=8, standby_nodes=(6, 7)),
                        dict(rack=(0, 1)), dict(scale_patience=1)),
    "autoscale_down": ("stationary", "overload_adaptive",
                       dict(queue_cap=4096, service_rate=4096), {}, {},
                       dict(scale_patience=1, min_serving=2)),
    "standby_parked": ("stationary", "overload_adaptive", OCFG,
                       dict(num_nodes=8, standby_nodes=(5, 6, 7)), {}, None),
    "cascade_p2c_chunks": ("cascade_failure", "overload_adaptive", OCFG,
                           dict(p2c_chunks=2), {}, None),
    "craq": ("ycsb_a", "overload_adaptive", OCFG,
             dict(replication_mode="craq"), {}, None),
}


def _ccfg(mod, **kw):
    kw.setdefault("num_nodes", 6)
    kw.setdefault("num_ranges", 12)
    kw.setdefault("report_every", 2)
    return mod.ClusterConfig(**kw)


def _driver(mod, ovl_mod, name, fused=True, device=None):
    scen, pol, okw, ckw, skw, pkw = RUNS[name]
    pcfg = None if pkw is None else mod.PolicyConfig(**pkw)
    ocfg = None if okw is None else ovl_mod.OverloadConfig(**okw)
    kw = {} if device is None else dict(device=device)
    return mod.EpochDriver(
        mod.make_scenario(scen, mod.ScenarioConfig(**SCFG), **skw),
        mod.make_policy(pol, pcfg), _ccfg(mod, overload=ocfg, **ckw),
        fused=fused, **kw)


@functools.lru_cache(maxsize=None)
def _reference(name):
    drv = _driver(JCl, JO, name)
    return drv, drv.run()


@functools.lru_cache(maxsize=None)
def _port(name, fused=True):
    drv = _driver(TCl, TO, name, fused=fused, device="cpu")
    return drv, drv.run()


def _assert_rows_equal(rows_a, rows_b):
    assert len(rows_a) == len(rows_b)
    for a, b in zip(rows_a, rows_b):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da == db, (
            f"epoch {a.epoch}: "
            + str({k: (da[k], db[k]) for k in da if da[k] != db[k]}))


def _assert_same_run(jdrv, tdrv):
    got = convert.store_to_numpy(tdrv.store)
    assert np.array_equal(np.asarray(jdrv.store.keys), got["keys"])
    assert np.array_equal(np.asarray(jdrv.store.values).view(np.uint32),
                          got["values"].view(np.uint32))
    assert np.array_equal(np.asarray(jdrv.store.overflow), got["overflow"])
    assert np.array_equal(np.asarray(jdrv.directory.chains),
                          tdrv.directory.chains.numpy())
    assert jdrv.controller.standby == tdrv.controller.standby
    assert jdrv.controller.failed == tdrv.controller.failed
    if jdrv.ovl is None:
        assert tdrv.ovl is None
    else:
        _assert_state_equal(jdrv.ovl, tdrv.ovl)
    if tdrv.mode_plan.track_state:
        for f, v in convert.repl_to_numpy(tdrv.repl).items():
            assert np.array_equal(np.asarray(getattr(jdrv.repl, f)), v), f


@pytest.mark.parametrize("name", list(RUNS))
def test_driver_matches_reference(name):
    jdrv, jrows = _reference(name)
    tdrv, trows = _port(name)
    _assert_rows_equal(jrows, trows)
    _assert_same_run(jdrv, tdrv)
    assert jdrv.overload_summary() == tdrv.overload_summary()
    assert all(r.compiled_steps == 1 for r in trows)
    if tdrv.ovl is not None:
        assert TO.conservation_gap(tdrv.ovl) == 0
        s = tdrv.overload_summary()
        assert s["injected"] == sum(r.ops for r in trows)
        assert sum(r.shed for r in trows) == s["shed"]
        assert sum(r.lost for r in trows) == s["lost"]


@pytest.mark.parametrize("name", ["cascade", "retry_storm"])
def test_fused_equals_per_epoch_with_overload(name):
    f_drv, f_rows = _port(name)
    e_drv, e_rows = _port(name, fused=False)
    _assert_rows_equal(e_rows, f_rows)
    jdrv, _ = _reference(name)
    _assert_same_run(jdrv, e_drv)
    assert f_drv.host_syncs < e_drv.host_syncs
    # the plane acted: deferred or shed queries from the failure on
    assert sum(r.deferred + r.shed for r in f_rows) > 0


def test_disabled_plane_reports_zeros():
    tdrv, trows = _port("disabled")
    assert tdrv.ovl is None and tdrv.overload_summary() == {}
    for r in trows:
        assert (r.deferred, r.shed, r.requeued, r.lost, r.queue_peak) \
            == (0, 0, 0, 0, 0)


def test_cascade_with_standby_recruits_and_loses_nothing():
    tdrv, trows = _port("standby_cascade")
    evs = [e for r in trows for e in r.events]
    assert any(e.startswith("autoscale_up:") for e in evs)
    assert len(tdrv.controller.standby) < 2
    assert tdrv.overload_summary()["lost"] == 0
    assert float(tdrv.ovl.admit_prob.min()) < 1.0


def test_autoscale_down_parks_idle_capacity():
    tdrv, trows = _port("autoscale_down")
    evs = [e for r in trows for e in r.events]
    assert any(e.startswith("autoscale_down:") for e in evs)
    assert len(tdrv.controller.standby) >= 1
    d = tdrv.controller.directory()
    chains, clen = d.chains.numpy(), d.chain_len.numpy()
    for node in tdrv.controller.standby:
        for i in range(chains.shape[0]):
            assert node not in chains[i][: clen[i]]


def test_standby_nodes_start_parked():
    tdrv = _driver(TCl, TO, "standby_parked", device="cpu")
    assert tdrv.controller.standby == {5, 6, 7}
    d0 = tdrv.controller.directory()
    chains, clen = d0.chains.numpy(), d0.chain_len.numpy()
    live = {int(n) for i in range(chains.shape[0])
            for n in chains[i][: clen[i]]}
    assert not (live & {5, 6, 7})


def test_craq_overload_bounces_and_steers():
    tdrv, trows = _port("craq")
    assert sum(r.dirty_reads for r in trows) > 0
    assert sum(r.deferred + r.shed for r in trows) > 0


def test_auto_period_sets_budget_scale_like_reference():
    seen = {"j": [], "t": []}

    def probe(base, tag):
        class Probe(base):
            def on_report(self, controller, report):
                seen[tag].append(report.budget_scale)
                return super().on_report(controller, report)
        return Probe()

    kw = dict(queue_cap=64, service_rate=64)
    out = {}
    for mod, omod, base, tag, dkw in ((JCl, JO, JOAP, "j", {}),
                                      (TCl, TO, TOAP, "t", dict(device="cpu"))):
        drv = mod.EpochDriver(
            mod.make_scenario("shifting_hotspot", mod.ScenarioConfig(**SCFG)),
            probe(base, tag),
            _ccfg(mod, overload=omod.OverloadConfig(**kw),
                  report_every="auto", auto_band=(2, 4)), **dkw)
        out[tag] = (drv, drv.run())
    _assert_rows_equal(out["j"][1], out["t"][1])
    _assert_state_equal(out["j"][0].ovl, out["t"][0].ovl)
    assert out["j"][0].period_history == out["t"][0].period_history
    assert seen["t"] == seen["j"] and all(s >= 1.0 for s in seen["t"])


# ---------------------------------------------------------------------------
# control-plane units
# ---------------------------------------------------------------------------

def _reports(n=4, depth=None, **kw):
    kw.setdefault("queue_limit", 32)
    kw.setdefault("service_limit", 24)
    out = []
    for cls in (JReport, TReport):
        out.append(cls(
            read_count=np.zeros(8), write_count=np.zeros(8),
            node_load=np.ones(n), period=1,
            queue_depth=np.asarray(depth if depth is not None else np.zeros(n)),
            retry_backlog=np.zeros(n, np.int64), **kw))
    return out


def _controllers():
    jd, td = _dir_pair(8, 4, 2)
    return JC.Controller(jd), TCtl.Controller(td)


def test_aimd_admission_direction_matches_reference():
    jpol, tpol = JOAP(JPC()), TOAP(TPC())
    jctl, tctl = _controllers()
    cfg = tpol.config
    aps = []
    for depth in ([32, 0, 0, 0], [32, 0, 0, 0], [0, 0, 0, 0]):
        jrep, trep = _reports(depth=np.array(depth))
        assert jpol._backpressure(jctl, jrep) == tpol._backpressure(tctl, trep)
        assert np.array_equal(jpol.admit_prob, tpol.admit_prob)
        assert np.array_equal(jpol.retry_budget, tpol.retry_budget)
        aps.append(tpol.admit_prob.copy())
    assert aps[0][0] == pytest.approx(cfg.admit_decrease)
    assert np.all(aps[0][1:] == 1.0)
    assert aps[1][0] == pytest.approx(
        max(cfg.admit_floor, aps[0][0] * cfg.admit_decrease))
    assert aps[2][0] == pytest.approx(aps[1][0] + cfg.admit_increase)
    assert tpol.retry_budget[0] == max(1, int(cfg.retry_frac * 24))


def test_backpressure_noop_without_plane():
    tpol = TOAP(TPC())
    _, tctl = _controllers()
    _, trep = _reports(queue_limit=0)
    assert tpol._backpressure(tctl, trep) == [] and tpol.admit_prob is None


def test_budget_scale_multiplies_move_budget_like_reference():
    rng = np.random.default_rng(0)
    load = rng.permutation(np.arange(8, dtype=np.float64) * 100)
    reads = rng.integers(1, 100, 64).astype(np.float64)

    def moves(mod_make, ctl_cls, rep_cls, cfg_cls, scale):
        ctl = ctl_cls(mod_make(), cfg_cls(imbalance_threshold=1.01,
                                          max_moves_per_round=2))
        rep = rep_cls(read_count=reads.copy(), write_count=np.zeros(64),
                      node_load=load.copy(), period=1, budget_scale=scale)
        return [vars(op) for op in ctl.balance(rep)]

    got = {}
    for scale in (1.0, 4.0):
        j = moves(lambda: JC.make_directory(64, 8, 2), JC.Controller, JReport,
                  JC.ControllerConfig, scale)
        got[scale] = moves(lambda: TD.make_directory(64, 8, 2, device="cpu"),
                           TCtl.Controller, TReport, TCtl.ControllerConfig,
                           scale)
        assert j == got[scale]
    assert len(got[1.0]) <= 2 < len(got[4.0])


# ---------------------------------------------------------------------------
# split_overflow: slot-pool growth in the loop
# ---------------------------------------------------------------------------

GROW_SCFG = dict(n_epochs=10, epoch_ops=512, n_records=2048, read_ratio=0.3,
                 value_dim=2)


def _grow_driver(mod, coord_cls, tier, fused=True, **kw):
    return mod.EpochDriver(
        mod.make_scenario("keyspace_growth", mod.ScenarioConfig(**GROW_SCFG)),
        mod.make_policy("full_adaptive"),
        mod.ClusterConfig(num_nodes=4, num_ranges=8, n_slots=8, capacity=128,
                          split_overflow=True, report_every=2,
                          coordination=(coord_cls(n_switches=4, lag_per_hop=1)
                                        if tier else None)),
        fused=fused, **kw)


@pytest.mark.parametrize("tier", [False, True])
def test_split_overflow_grows_pool_like_reference(tier):
    jdrv = _grow_driver(JCl, JCoordConfig, tier)
    jrows = jdrv.run()
    tdrv = _grow_driver(TCl, TCoordConfig, tier, device="cpu")
    trows = tdrv.run()
    _assert_rows_equal(jrows, trows)
    _assert_same_run(jdrv, tdrv)
    grows = [e for r in trows for e in r.events if e.startswith("grow_pool:")]
    assert grows, "pool never grew under capacity pressure"
    assert tdrv.growth_events == len(grows) == jdrv.growth_events
    assert trows[-1].compiled_steps == jdrv.traces == 1 + tdrv.growth_events
    assert tdrv.controller.num_slots > 8
    assert tdrv.directory.num_slots == tdrv.controller.num_slots
    assert set(tdrv.controller.live_ranges())
    if tier:
        # the tier was rebuilt at the grown width
        assert tdrv.coord.slot_lo.shape[1] == tdrv.controller.num_slots
        for f, v in convert.coord_to_numpy(tdrv.coord).items():
            assert np.array_equal(np.asarray(getattr(jdrv.coord, f)), v), f
        assert jdrv.coord_mgr.summary() == tdrv.coord_mgr.summary()


def test_split_overflow_fused_equals_per_epoch():
    f_drv = _grow_driver(TCl, TCoordConfig, False, device="cpu")
    e_drv = _grow_driver(TCl, TCoordConfig, False, fused=False, device="cpu")
    _assert_rows_equal(e_drv.run(), f_drv.run())
    assert torch.equal(e_drv.directory.chains, f_drv.directory.chains)
    assert e_drv.growth_events == f_drv.growth_events > 0


def test_scenario_registry_has_overload_stressors():
    assert {"cascade_failure", "retry_storm"} <= set(TCl.SCENARIOS)
    scfg = TCl.ScenarioConfig(**SCFG)
    cs = TCl.make_scenario("cascade_failure", scfg, fail_epoch=2, rack=(0, 1))
    assert cs.events(2) == [("rack_fail", (0, 1))]
    assert cs.events(3) == []
    rs = TCl.make_scenario("retry_storm", scfg, fail_epoch=1, recover_epoch=3,
                           rack=(2,))
    assert rs.events(1) == [("rack_fail", (2,))]
    assert rs.events(3) == [("recover", 2)]
