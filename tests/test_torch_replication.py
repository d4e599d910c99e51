"""The port's replication subsystem against the JAX reference, bit for
bit, on the cases of ``tests/test_replication.py``: the ReplState register
file (``advance``, ``apply_events``, a split child inheriting its parent's
dirty state), CRAQ routing (``route_load_aware_dirty`` with and without
the hashed per-key filter, and K3's plain version against the reference's
jnp and Pallas-interpret paths), the bounce's hop plan, the "craq never
serves stale" safety refinement run against the port, and the epoch
driver in chain and craq modes (fused equals per-epoch, bounces only
under writes, chain reads at the tail).  Also the ported bench's gates."""

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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import cluster as JCl
from repro import core as JC
from repro import replication as JRPL
from repro.core import keys as JK
from repro.core import routing as JR
from repro.kernels.range_match import ops as JOps
from repro.replication import bench as JB
from repro_torch import cluster as TCl
from repro_torch import convert, prng
from repro_torch import replication as TRPL
from repro_torch.core import coordination as TCo
from repro_torch.core import directory as TD
from repro_torch.core import routing as TR
from repro_torch.core.controller import Controller as TController
from repro_torch.kernels.range_match import ops as TOps
from repro_torch.replication import bench as TB

SCFG = dict(n_epochs=6, epoch_ops=256, n_records=512, value_dim=2, seed=3,
            read_ratio=0.7)


def _ccfg(mod, mode="craq", period=2, **kw):
    return mod.ClusterConfig(num_nodes=8, num_ranges=32, replication=2,
                             r_max=4, n_clients=16, report_every=period,
                             imbalance_threshold=1.1, max_moves_per_round=6,
                             replication_mode=mode, **kw)


def _same_state(js, ts):
    for f, b in convert.repl_to_numpy(ts).items():
        a = np.asarray(getattr(js, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f


def _t_state(js):
    """The reference's register file as the port's."""
    return convert.repl_from_numpy(js, device="cpu")


def _t64(a):
    return torch.tensor(np.asarray(a).astype(np.int64))


# ---------------------------------------------------------------------------
# register-file semantics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("filter_bits", [0, 8])
def test_advance_marks_written_slots_dirty_for_one_round(filter_bits):
    js = JRPL.make_state(8, 3, filter_bits)
    ts = TRPL.make_state(8, 3, filter_bits, device="cpu")
    _same_state(js, ts)
    ridx = np.array([2, 2, 5, 1, 5, 2], np.int32)
    is_write = np.array([True, True, True, False, False, True])
    keys = np.array([7, 7, 123456, 9, 4000000000, 99], np.uint32)
    kw_j = dict(keys=jnp.asarray(keys)) if filter_bits else {}
    kw_t = dict(keys=_t64(keys)) if filter_bits else {}
    js1 = JRPL.advance(js, jnp.asarray(ridx), jnp.asarray(is_write), **kw_j)
    ts1 = TRPL.advance(ts, _t64(ridx), torch.tensor(is_write), **kw_t)
    _same_state(js1, ts1)
    v = ts1.version.numpy()
    assert v[2] == 3 and v[5] == 1 and v[1] == 0
    d = TRPL.dirty_bits(ts1).numpy()
    assert d[2].all() and d[5].all() and not d[1].any()
    if filter_bits:
        assert ts1.key_filter.sum() > 0
    # the next ack round clears everything not re-written
    js2 = JRPL.advance(js1, jnp.asarray(ridx), jnp.zeros(6, bool), **kw_j)
    ts2 = TRPL.advance(ts1, _t64(ridx), torch.zeros(6, dtype=torch.bool),
                       **kw_t)
    _same_state(js2, ts2)
    assert not TRPL.dirty_bits(ts2).any()
    assert TRPL.summary(ts2) == JRPL.summary(js2)


def test_advance_wraps_versions_at_32_bits():
    js = dataclasses.replace(JRPL.make_state(4, 2),
                             version=jnp.full((4,), 0xFFFFFFFF, jnp.uint32))
    ts = _t_state(js)
    ridx = np.array([0, 0, 3], np.int32)
    w = np.array([True, True, False])
    _same_state(JRPL.advance(js, jnp.asarray(ridx), jnp.asarray(w)),
                TRPL.advance(ts, _t64(ridx), torch.tensor(w)))


def test_apply_events_inherit_merge_reset_kill_grow():
    js = JRPL.ReplState(
        version=jnp.asarray([5, 0, 3, 0], jnp.uint32),
        acked=jnp.asarray([[5, 2], [0, 0], [3, 3], [0, 0]], jnp.uint32),
        key_filter=jnp.asarray([[1, 0, 0], [0, 0, 0], [0, 1, 1], [1, 1, 1]],
                               bool),
    )
    ts = _t_state(js)
    for events in ([("inherit", 0, 1)], [("merge", 0, 2), ("kill", 0)],
                   [("reset", 2)], [("grow", 6)], [("kill", 3), ("grow", 5)]):
        _same_state(JRPL.apply_events(js, events),
                    TRPL.apply_events(ts, events))
    out = TRPL.apply_events(ts, [("inherit", 0, 1)])
    assert out.version[1] == 5 and out.acked[1].tolist() == [5, 2]
    out = TRPL.apply_events(ts, [("merge", 0, 2), ("kill", 0)])
    assert out.version[2] == 5 and out.acked[2].max() == 0
    assert out.version[0] == 0
    assert TRPL.apply_events(ts, [("grow", 6)]).num_slots == 6
    # an empty journal is a no-op (same object)
    assert TRPL.apply_events(ts, []) is ts
    with pytest.raises(ValueError, match="unknown replication event"):
        TRPL.apply_events(ts, [("bogus", 0)])


def test_split_child_inherits_parent_dirty_state():
    jctl = JC.Controller(JC.make_directory(4, 8, 2, r_max=3, n_slots=8))
    tctl = TController(TD.make_directory(4, 8, 2, r_max=3, n_slots=8,
                                         device="cpu"))
    js = JRPL.advance(JRPL.make_state(8, 3), jnp.asarray([1, 1], jnp.int32),
                      jnp.asarray([True, True]))
    ts = TRPL.advance(TRPL.make_state(8, 3, device="cpu"), _t64([1, 1]),
                      torch.tensor([True, True]))
    lo, hi = tctl.range_span(1)
    assert jctl.range_span(1) == (lo, hi)
    child = tctl.split_range(1, (lo + hi) // 2)
    assert jctl.split_range(1, (lo + hi) // 2) == child
    events = tctl.drain_repl_log()
    assert jctl.drain_repl_log() == events
    js = JRPL.apply_events(js, events)
    ts = TRPL.apply_events(ts, events)
    _same_state(js, ts)
    assert ts.version[child] == ts.version[1] == 2
    d = TRPL.dirty_bits(ts)
    assert d[child].all() and d[1].all()


# ---------------------------------------------------------------------------
# dirty-aware routing + hop planning
# ---------------------------------------------------------------------------


def _queries(B, seed=0, write_frac=0.3):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32 - 2, B).astype(np.uint32)
    ops = np.where(rng.random(B) < write_frac, JK.OP_PUT,
                   JK.OP_GET).astype(np.int32)
    return (JC.make_queries(jnp.asarray(keys), jnp.asarray(ops), value_dim=2),
            TR.make_queries(keys, ops, value_dim=2, device="cpu"))


def _directories(*args, **kw):
    jd = JC.make_directory(*args, **kw)
    td = convert.directory_from_numpy(
        {f: np.asarray(getattr(jd, f)) for f in convert.DIRECTORY_FIELDS},
        device="cpu")
    return jd, td


def _same_dirty_route(jout, tout):
    (jdec, jd2, jl2, jp, jb), (tdec, td2, tl2, tp, tb) = jout, tout
    for f in ("ridx", "target", "chain", "chain_len", "clength"):
        assert np.array_equal(np.asarray(getattr(jdec, f)),
                              getattr(tdec, f).numpy()), f
    for f in ("read_count", "write_count"):
        assert np.array_equal(np.asarray(getattr(jd2, f)),
                              getattr(td2, f).numpy()), f
    assert np.array_equal(np.asarray(jl2), convert.load_reg_to_numpy(tl2))
    assert np.array_equal(np.asarray(jp), tp.numpy())
    assert np.array_equal(np.asarray(jb), tb.numpy())


def test_dirty_routing_bounces_to_tail_only_when_dirty():
    jd, td = _directories(16, 8, 3, r_max=5, n_slots=24)
    jq, tq = _queries(256, seed=1)
    load = np.zeros(8, np.uint32)
    all_dirty = np.ones((24, 5), bool)
    jout = JR.route_load_aware_dirty(jd, jq, jnp.asarray(load),
                                     jnp.asarray(all_dirty),
                                     jax.random.PRNGKey(5))
    tout = TR.route_load_aware_dirty(td, tq, _t64(load),
                                     torch.tensor(all_dirty), prng.PRNGKey(5))
    _same_dirty_route(jout, tout)
    dec, _, _, picked, bounced = tout
    tgt, ch, cl = dec.target.numpy(), dec.chain.numpy(), dec.chain_len.numpy()
    pk, b = picked.numpy(), bounced.numpy()
    w = tq.opcode.numpy() == JK.OP_PUT
    assert not b[w].any() and b.sum() > 0
    for i in np.where(~w)[0]:
        tail = ch[i, cl[i] - 1]
        if b[i]:
            assert tgt[i] == tail and pk[i] != tail
        else:
            # with everything dirty, an unbounced read picked the tail
            assert pk[i] == tail and tgt[i] == tail

    clean = torch.zeros((24, 5), dtype=torch.bool)
    dec0, _, _ = TR.route_load_aware(td, tq, _t64(load), prng.PRNGKey(5))
    decC, _, _, _, bouncedC = TR.route_load_aware_dirty(
        td, tq, _t64(load), clean, prng.PRNGKey(5))
    assert torch.equal(dec0.target, decC.target)
    assert not bouncedC.any()


def test_dirty_routing_kernel_parity():
    """K3's plain version (the port's route) against the reference's jnp
    route, its jnp kernel oracle and its Pallas kernel in interpret mode."""
    jd, td = _directories(16, 8, 3, r_max=5, n_slots=24)
    rng0 = np.random.default_rng(0)
    jq, tq = _queries(300, seed=0)
    load = rng0.integers(0, 50, 8).astype(np.uint32)
    dirty = rng0.random((24, 5)) < 0.4
    jout = JR.route_load_aware_dirty(jd, jq, jnp.asarray(load),
                                     jnp.asarray(dirty), jax.random.PRNGKey(7))
    ridx, target, chain, picked, bounced = TOps.range_match_spread_dirty(
        td, tq.key, tq.opcode, _t64(load), torch.tensor(dirty),
        prng.PRNGKey(7))
    for use_pallas in (False, True):
        kout = JOps.range_match_spread_dirty(
            jd, jq.key, jq.opcode, jnp.asarray(load), jnp.asarray(dirty),
            jax.random.PRNGKey(7), use_pallas=use_pallas)
        for a, b in zip(kout, (ridx, target, chain, picked, bounced)):
            assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(np.asarray(jout[0].target), target.numpy())
    assert np.array_equal(np.asarray(jout[4]), bounced.numpy())


@pytest.mark.parametrize("filter_bits", [8, 64])
def test_key_filter_routing_parity(filter_bits):
    """``route_load_aware_dirty(key_filter=)``, which the Pallas K3 lacks:
    the port equals the reference's jnp route, and the filter only ever
    removes bounces."""
    jd, td = _directories(16, 8, 3, r_max=5, n_slots=24)
    rng0 = np.random.default_rng(filter_bits)
    jq, tq = _queries(600, seed=filter_bits, write_frac=0.2)
    load = rng0.integers(0, 50, 8).astype(np.uint32)
    dirty = rng0.random((24, 5)) < 0.6
    kf = rng0.random((24, filter_bits)) < 0.3
    jout = JR.route_load_aware_dirty(
        jd, jq, jnp.asarray(load), jnp.asarray(dirty), jax.random.PRNGKey(3),
        key_filter=jnp.asarray(kf))
    tout = TR.route_load_aware_dirty(
        td, tq, _t64(load), torch.tensor(dirty), prng.PRNGKey(3),
        key_filter=torch.tensor(kf))
    _same_dirty_route(jout, tout)
    _, _, _, _, unfiltered = TR.route_load_aware_dirty(
        td, tq, _t64(load), torch.tensor(dirty), prng.PRNGKey(3))
    b = tout[4]
    assert b.any() and (unfiltered & ~b).any() and not (b & ~unfiltered).any()


def test_plan_hops_charges_the_bounce():
    jd, td = _directories(8, 8, 3, r_max=4)
    jq, tq = _queries(128, seed=2)
    load = np.zeros(8, np.uint32)
    dirty = np.ones((8, 4), bool)
    jdec, _, _, jp, jb = JR.route_load_aware_dirty(
        jd, jq, jnp.asarray(load), jnp.asarray(dirty), jax.random.PRNGKey(3))
    tdec, _, _, tp, tb = TR.route_load_aware_dirty(
        td, tq, _t64(load), torch.tensor(dirty), prng.PRNGKey(3))
    model = JC.LatencyModel()
    tmodel = TCo.LatencyModel()
    jplan = JC.plan_hops(jq, jdec, JC.IN_SWITCH, model,
                         rng=jax.random.PRNGKey(9), num_nodes=8, read_via=jp,
                         read_bounce=jb)
    tplan = TCo.plan_hops(tq, tdec, TCo.IN_SWITCH, tmodel,
                          rng=prng.PRNGKey(9), num_nodes=8, read_via=tp,
                          read_bounce=tb)
    for f in ("nodes", "service", "reply_links"):
        assert np.array_equal(np.asarray(getattr(jplan, f)),
                              getattr(tplan, f).numpy()), f
    nodes, svc = tplan.nodes.numpy(), tplan.service.numpy()
    links, b = tplan.reply_links.numpy(), tb.numpy()
    assert b.any()
    # bounced reads: the pick pays the version check, the tail the read
    assert ((nodes[b] >= 0).sum(axis=1) == 2).all()
    assert np.allclose(svc[b][:, 0], tmodel.lookup)
    assert np.allclose(svc[b][:, 1], tmodel.service)
    assert np.allclose(links[b], 3.0 * tmodel.link)
    assert (nodes[b][:, 0] == tp.numpy()[b]).all()
    assert (nodes[b][:, 1] == tdec.target.numpy()[b]).all()
    with pytest.raises(ValueError, match="together"):
        TCo.plan_hops(tq, tdec, TCo.IN_SWITCH, tmodel, rng=prng.PRNGKey(9),
                      num_nodes=8, read_bounce=tb)


# ---------------------------------------------------------------------------
# safety refinement (hypothesis): clean implies fully known
# ---------------------------------------------------------------------------


def test_craq_never_serves_stale_hypothesis():
    """The port's uint-version dirty bits are conservative against an
    independent set-of-write-ids model of CRAQ message passing (the
    reference's refinement, run on the port's Controller and register
    file): whenever (slot, position) is clean, the model says that
    position knows every committed write of the slot."""
    from hypothesis import given, settings, strategies as st

    S, RMAX, N = 8, 3, 6
    op = st.one_of(
        st.tuples(st.just("epoch"),
                  st.lists(st.integers(0, S - 1), min_size=0, max_size=6)),
        st.tuples(st.just("split"), st.integers(0, S - 1)),
        st.tuples(st.just("widen"), st.integers(0, S - 1)),
        st.tuples(st.just("narrow"), st.integers(0, S - 1)),
        st.tuples(st.just("fail"), st.integers(0, N - 1)),
    )

    @settings(max_examples=20, deadline=None)
    @given(ops=st.lists(op, min_size=1, max_size=12))
    def run(ops):
        ctl = TController(TD.make_directory(4, N, 2, r_max=RMAX, n_slots=S,
                                            device="cpu"))
        state = TRPL.make_state(S, RMAX, device="cpu")
        committed = [set() for _ in range(S)]
        known = [[set() for _ in range(RMAX)] for _ in range(S)]
        next_id = 0

        def check():
            dirty = TRPL.dirty_bits(state).numpy()
            for s in range(S):
                for j in range(RMAX):
                    if not dirty[s, j]:
                        assert known[s][j] >= committed[s], (s, j)

        for kind, arg in ops:
            if kind == "epoch":
                writes = [s for s in arg if ctl.is_live(s)]
                check()   # reads observe the pre-epoch state
                snapshot = [set(c) for c in committed]
                for s in writes:
                    committed[s].add(next_id)
                    next_id += 1
                for s in range(S):
                    for j in range(RMAX):
                        known[s][j] = set(snapshot[s])
                ridx = _t64(writes if writes else [0])
                is_w = torch.tensor([True] * len(writes) if writes else [False])
                state = TRPL.advance(state, ridx, is_w)
            else:
                if kind == "split" and ctl.is_live(arg):
                    lo, hi = ctl.range_span(arg)
                    if hi - lo >= 2:
                        ctl.split_range(arg, lo + (hi - lo) // 2)
                elif kind == "widen" and ctl.is_live(arg):
                    ctl.widen_chain(arg, np.zeros(N))
                elif kind == "narrow" and ctl.is_live(arg):
                    ctl.narrow_chain(arg, 2)
                elif kind == "fail" and arg not in ctl.failed:
                    if len(ctl.live_nodes()) > 2:
                        ctl.handle_node_failure(arg)
                events = ctl.drain_repl_log()
                for ev in events:
                    if ev[0] == "reset":
                        known[ev[1]] = [set() for _ in range(RMAX)]
                    elif ev[0] == "inherit":
                        p_, c_ = ev[1], ev[2]
                        committed[c_] = set(committed[p_])
                        known[c_] = [set(k) for k in known[p_]]
                    elif ev[0] == "merge":
                        c_, p_ = ev[1], ev[2]
                        committed[p_] |= committed[c_]
                        known[p_] = [set() for _ in range(RMAX)]
                    elif ev[0] == "kill":
                        committed[ev[1]] = set()
                        known[ev[1]] = [set() for _ in range(RMAX)]
                state = TRPL.apply_events(state, events)
            check()

    run()


# ---------------------------------------------------------------------------
# driver integration
# ---------------------------------------------------------------------------


def _port(mode, scen="shifting_hotspot", pol="full_adaptive", skw=None,
          fused=True, scfg=None, **ckw):
    drv = TCl.EpochDriver(
        TCl.make_scenario(scen, TCl.ScenarioConfig(**(scfg or SCFG)),
                          **(skw or {})),
        TCl.make_policy(pol), _ccfg(TCl, mode, **ckw), fused=fused,
        device="cpu")
    return drv, drv.run()


def _reference(mode, scen, pol, scfg=None):
    drv = JCl.EpochDriver(
        JCl.make_scenario(scen, JCl.ScenarioConfig(**(scfg or SCFG))),
        JCl.make_policy(pol), _ccfg(JCl, mode))
    return drv, drv.run()


def _rows(rows):
    return [dataclasses.asdict(r) for r in rows]


@pytest.mark.parametrize("mode", ["chain", "craq"])
def test_fused_equals_per_epoch_replication_modes(mode):
    skw = dict(theta=1.2, shift_every=2)
    dr, rows_r = _port(mode, skw=skw, fused=False)
    df, rows_f = _port(mode, skw=skw, fused=True)
    assert _rows(rows_r) == _rows(rows_f)
    for f in ("keys", "values", "overflow"):
        assert torch.equal(getattr(dr.store, f), getattr(df.store, f))
    for f in ("version", "acked", "key_filter"):
        assert torch.equal(getattr(dr.repl, f), getattr(df.repl, f))
    assert df.host_syncs < dr.host_syncs
    if mode == "craq":
        assert sum(r.dirty_reads for r in rows_f) > 0


def test_craq_bounces_under_writes_and_not_without():
    jdrv, jrows = _reference("craq", "ycsb_a", "full_adaptive")
    tdrv, trows = _port("craq", "ycsb_a", "full_adaptive")
    assert _rows(jrows) == _rows(trows)
    _same_state(jdrv.repl, tdrv.repl)
    assert sum(r.dirty_reads for r in trows) > 0
    assert all(r.replication == "craq" for r in trows)
    for r in trows:
        if r.dirty_reads:
            assert r.clean_read_p99 <= r.read_p99 + 1e-9
    # read-only stream after the load phase: nothing is ever dirty
    ro = dict(SCFG, n_epochs=4, read_ratio=1.0)
    _, rows = _port("craq", "stationary", "replicate", scfg=ro)
    assert sum(r.dirty_reads for r in rows) == 0


def test_craq_read_only_matches_eventual_spread():
    """On a read-only stream craq makes eventual's p2c picks, never
    bounces, and has no writes for its write cap to act on: the whole
    metric stream equals eventual's, mode label aside."""
    ro = dict(SCFG, n_epochs=4, read_ratio=1.0)
    rows = {mode: _port(mode, "stationary", "replicate", scfg=ro)[1]
            for mode in ("eventual", "craq")}
    for a, b in zip(rows["eventual"], rows["craq"]):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        da.pop("replication"), db.pop("replication")
        assert da == db, f"epoch {a.epoch} diverges"
    assert all(r.dirty_reads == 0 for r in rows["craq"])


def test_chain_mode_reads_at_tail_writes_full_chain():
    jdrv, jrows = _reference("chain", "ycsb_a", "replicate")
    tdrv, trows = _port("chain", "ycsb_a", "replicate")
    assert _rows(jrows) == _rows(trows)
    _same_state(jdrv.repl, tdrv.repl)
    assert all(r.dirty_reads == 0 for r in trows)
    # chain tracks commit versions too
    assert int(tdrv.repl.version.sum()) > 0


def test_eventual_mode_pays_no_register_sync():
    """The journal is drained in every mode, but only chain and craq pay a
    host round trip to replay it (a failure journals a reset)."""
    skw = dict(fail_epoch=3, fail_node=0, recover_epoch=5)
    syncs = {mode: _port(mode, "node_failure", "migrate", skw=skw)[0].host_syncs
             for mode in ("eventual", "chain")}
    assert syncs["chain"] > syncs["eventual"]


# ---------------------------------------------------------------------------
# the bench gates
# ---------------------------------------------------------------------------


def _bench_row(scenario, mode, policy, **kw):
    row = {"bench": "replication", "scenario": scenario, "replication": mode,
           "policy": policy, "traces": 1, "total_dirty_reads": 0,
           "mean_p99": 10.0, "mean_read_p99": 8.0, "mean_throughput": 1.0,
           "mean_imbalance": 1.2, "read_heavy_epochs": 2,
           "read_heavy_read_p99": 9.0, "read_heavy_clean_p99": 9.0}
    return {**row, **kw}


def test_bench_gates_pass_and_fail_like_the_reference():
    ok = [_bench_row(s, m, p,
                     total_dirty_reads=5 if m == "craq" else 0,
                     read_heavy_clean_p99=7.0 if m == "craq" else 9.0)
          for s in ("diurnal", "ycsb_a") for m in ("eventual", "chain", "craq")
          for p in ("frozen", "full_adaptive")]
    bad = [dict(r) for r in ok]
    bad[0]["traces"] = 2
    bad[1]["total_dirty_reads"] = 3
    assert TB.check_replication(ok) == JB.check_replication(ok) == []
    # "traced" in the reference's wording is "built" in the port's
    assert TB.check_replication(bad) == [
        p.replace("traced", "built") for p in JB.check_replication(bad)]
    assert len(TB.check_replication(bad)) == 2
    arm = [{"bench": "replication_filter", "filter_bits": f, "traces": 1,
            "total_dirty_reads": d, "mean_read_p99": p}
           for f, d, p in ((0, 10, 5.0), (64, 4, 5.0))]
    assert TB.check_filter_arm(arm) == []
    arm[1]["total_dirty_reads"] = 10
    assert len(TB.check_filter_arm(arm)) == 1
