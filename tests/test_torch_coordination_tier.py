"""The switch-replicated directory tier of the port against the JAX
reference, bit for bit, in the ``tests/test_coordination_tier.py``
configuration (8 nodes, 32 ranges, 256 ops an epoch, 512 records, seed 3).

End to end, each case compares the ``EpochMetrics`` stream
(``dataclasses.asdict``), the final store, the chains, every
``CoordState`` leaf and the manager's summary: zero lag (which also equals
the tier-off run), lag 1 (also the port's fused loop against its
per-epoch loop), split brain with and without quorum, lease expiry, quorum
drift, a node failure splice, CRAQ on YCSB-A, and the policy's
``redirect_backoff``.  Then K5's plain version against the reference's
``range_match_stale`` (jnp ref and Pallas interpret) and the
``observe_epoch`` formula, the manager side by side with the reference's
under the chaos seeds, the state converters, the pod hierarchy, the host
sync count, and the ported bench's gates."""

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
import importlib.util
import pathlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import cluster as JCl
from repro import coordination_tier as JCT
from repro import core as JC
from repro.coordination_tier import state as JCTS
from repro.core import keys as JK
from repro.kernels.range_match.ops import range_match_stale as j_range_match_stale
from repro_torch import cluster as TCl
from repro_torch import convert
from repro_torch import coordination_tier as TCT
from repro_torch.coordination_tier import bench as TB
from repro_torch.core import directory as TD
from repro_torch.core import hierarchy as TH
from repro_torch.core import keys as TK
from repro_torch.core import routing as TR
from repro_torch.kernels.range_match import ops as TOps

SCFG = dict(n_epochs=6, epoch_ops=256, n_records=512, value_dim=2, seed=3)
FAULT_SCFG = dict(SCFG, n_epochs=10)
SHIFT = dict(theta=1.2, shift_every=2)
LAG1 = dict(n_switches=4, lag_per_hop=1)

# name -> (scenario, policy, period, scenario knobs, CoordConfig knobs,
# scenario config, other ClusterConfig knobs, policy-config knobs)
CASES = {
    "lag0_full_adaptive": ("shifting_hotspot", "full_adaptive", 2, SHIFT,
                           dict(n_switches=4, lag_per_hop=0), SCFG, {}, {}),
    "lag1_full_adaptive": ("shifting_hotspot", "full_adaptive", 2, SHIFT,
                           LAG1, SCFG, {}, {}),
    "split_brain_quorum": ("split_brain", "frozen", 1,
                           dict(split_epoch=2, heal_epoch=7, switch=1),
                           dict(LAG1, quorum=True), FAULT_SCFG, {}, {}),
    "split_brain_no_quorum": ("split_brain", "frozen", 1,
                              dict(split_epoch=2, heal_epoch=7, switch=1),
                              dict(LAG1, quorum=False), FAULT_SCFG, {}, {}),
    "lease_expiry": ("lease_expiry", "full_adaptive", 1,
                     dict(SHIFT, expire_epoch=3), LAG1, FAULT_SCFG, {}, {}),
    "quorum_drift": ("quorum_drift", "full_adaptive", 1,
                     dict(SHIFT, drift_epoch=2, switch=2),
                     dict(LAG1, drift_mult=4), FAULT_SCFG, {}, {}),
    "node_failure_lag1": ("node_failure", "migrate", 4,
                          dict(fail_epoch=3, fail_node=0, recover_epoch=5),
                          LAG1, SCFG, {}, {}),
    "ycsb_a_craq_lag1": ("ycsb_a", "full_adaptive", 2, {}, LAG1, SCFG,
                         dict(replication_mode="craq"), {}),
    "redirect_backoff": ("shifting_hotspot", "full_adaptive", 2, SHIFT, LAG1,
                         SCFG, {}, dict(redirect_backoff=0.05)),
}
# the reference's per-epoch loop equals its fused loop (its own tests) and
# compiles far faster; the backoff reads the redirect share per segment in
# the fused loop and per epoch in the other, so that case runs fused
REF_FUSED = {"redirect_backoff"}


def _ccfg(mod, period, **kw):
    return mod.ClusterConfig(num_nodes=8, num_ranges=32, replication=2,
                             r_max=4, n_clients=16, report_every=period,
                             imbalance_threshold=1.1, max_moves_per_round=6,
                             **kw)


def _driver(mod, ct, case, fused, coord=True, **drv_kw):
    scen, pol, period, skw, coord_kw, scfg, ckw, pkw = CASES[case]
    policy = mod.make_policy(pol)
    for k, v in pkw.items():
        setattr(policy.config, k, v)
    cfg = _ccfg(mod, period, **ckw,
                coordination=ct.CoordConfig(**coord_kw) if coord else None)
    drv = mod.EpochDriver(mod.make_scenario(scen, mod.ScenarioConfig(**scfg),
                                            **skw),
                          policy, cfg, fused=fused, **drv_kw)
    return drv, drv.run()


@functools.lru_cache(maxsize=None)
def _reference(case):
    return _driver(JCl, JCT, case, case in REF_FUSED)


def _port(case, fused=True, coord=True):
    return _driver(TCl, TCT, case, fused, coord, device="cpu")


def _assert_rows_equal(rows_a, rows_b):
    assert len(rows_a) == len(rows_b)
    for a, b in zip(rows_a, rows_b):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da == db, (
            f"epoch {a.epoch}: "
            + str({k: (da[k], db[k]) for k in da if da[k] != db[k]}))


def _assert_coord_equal(jcoord, tcoord):
    got = convert.coord_to_numpy(tcoord)
    for f in convert.COORD_FIELDS:
        want = np.asarray(getattr(jcoord, f))
        assert want.dtype == got[f].dtype and np.array_equal(want, got[f]), f


def _assert_runs_equal(jrun, trun):
    (jdrv, jrows), (tdrv, trows) = jrun, trun
    _assert_rows_equal(jrows, trows)
    got = convert.store_to_numpy(tdrv.store)
    assert np.array_equal(np.asarray(jdrv.store.keys), got["keys"])
    assert np.array_equal(np.asarray(jdrv.store.values).view(np.uint32),
                          got["values"].view(np.uint32))
    assert np.array_equal(np.asarray(jdrv.store.overflow), got["overflow"])
    assert np.array_equal(np.asarray(jdrv.directory.chains),
                          tdrv.directory.chains.cpu().numpy())
    _assert_coord_equal(jdrv.coord, tdrv.coord)
    assert jdrv.coord_mgr.summary() == tdrv.coord_mgr.summary()


def _conserves(rows, ops):
    return all(r.routed == r.direct + r.redirected == ops for r in rows)


COORD_KEYS = ("routed", "direct", "redirected", "mis_served",
              "stale_switches", "coordination")


def _strip_coord(row) -> dict:
    d = {k: v for k, v in dataclasses.asdict(row).items()
         if k not in COORD_KEYS}
    d["events"] = [e for e in d["events"] if not e.startswith("coord_")]
    return d


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_tier_matches_reference(case):
    ref = _reference(case)
    tdrv, trows = port = _port(case)
    _assert_runs_equal(ref, port)
    ops = CASES[case][5]["epoch_ops"]
    assert _conserves(trows, ops)
    assert all(r.coordination == ("no-quorum" if case == "split_brain_no_quorum"
                                  else "quorum") for r in trows)
    red = sum(r.redirected for r in trows)
    mis = sum(r.mis_served for r in trows)
    events = [e for r in trows for e in r.events]
    if case == "lag0_full_adaptive":
        assert red == mis == 0
        _, off = _port(case, coord=False)
        assert [_strip_coord(r) for r in off] == [_strip_coord(r) for r in trows]
        assert all(r.coordination == "none" and r.routed == 0 for r in off)
    elif case == "split_brain_no_quorum":
        assert mis > 0 and red == 0
    else:
        assert red > 0 and mis == 0, (red, mis)
    if case == "lease_expiry":
        assert tdrv.coord_mgr.failovers >= 1
    if case == "quorum_drift":
        assert tdrv.coord_mgr.lag_mult[2] == 4
    if case == "node_failure_lag1":
        row3 = trows[3]
        assert "fail:0" in row3.events
        assert any(e.startswith("coord_stage:") for e in row3.events)
    if case == "ycsb_a_craq_lag1":
        # a CRAQ bounce and a redirect meet in one hop plan
        assert sum(r.dirty_reads for r in trows) > 0
    if case == "redirect_backoff":
        assert any(e.startswith("redirect_backoff:") for e in events)


def test_lagged_tier_fused_equals_per_epoch():
    f_drv, f_rows = _port("lag1_full_adaptive", fused=True)
    e_drv, e_rows = _port("lag1_full_adaptive", fused=False)
    _assert_rows_equal(e_rows, f_rows)
    for f in convert.COORD_FIELDS:
        assert torch.equal(getattr(e_drv.coord, f), getattr(f_drv.coord, f)), f
    assert e_drv.coord_mgr.summary() == f_drv.coord_mgr.summary()
    assert f_drv.host_syncs < e_drv.host_syncs
    assert e_drv.stage_seconds["coord_control"] > 0


def test_tier_rides_the_fused_copy_home():
    """At lag 0 the tier adds no host round trip to the fused loop: its
    counters come home in the period's one copy."""
    on, _ = _port("lag0_full_adaptive")
    off, _ = _port("lag0_full_adaptive", coord=False)
    assert on.host_syncs == off.host_syncs


# ---------------------------------------------------------------------------
# K5 and the observe_epoch formula
# ---------------------------------------------------------------------------


def _rand_tables(rng, s=16, num_nodes=8, r_max=3):
    lo = np.sort(rng.integers(0, 2**32 - 2, s, dtype=np.uint64)
                 ).astype(np.uint32)
    hi = np.concatenate([lo[1:] - 1, np.array([2**32 - 1], np.uint64)]
                        ).astype(np.uint32)
    chains = np.full((s, r_max), -1, np.int32)
    clen = rng.integers(1, r_max + 1, s).astype(np.int32)
    for i in range(s):
        chains[i, :clen[i]] = rng.choice(num_nodes, clen[i], replace=False)
    return dict(slot_lo=lo, slot_hi=hi, live=np.ones(s, bool),
                chains=chains, chain_len=clen)


def _mutate_tables(rng, tables, num_nodes=8):
    s, r_max = tables["chains"].shape
    for i in rng.choice(s, rng.integers(1, 4), replace=False):
        cl = int(rng.integers(1, r_max + 1))
        row = np.full(r_max, -1, np.int32)
        row[:cl] = rng.choice(num_nodes, cl, replace=False)
        tables["chains"][i] = row
        tables["chain_len"][i] = cl
        if rng.random() < 0.3:
            tables["live"][i] = not tables["live"][i]
        if rng.random() < 0.3:
            tables["slot_hi"][i] = np.uint32(
                max(int(tables["slot_lo"][i]), int(tables["slot_hi"][i]) - 1))


def _perturbed_state(rng, w=4, s=24, num_nodes=8, r_max=4, clen_zero=False):
    """The reference test's perturbed state: divergent versions on two
    switches, rotated chains on one, a dead row retired on one switch
    only, a shifted bound; with ``clen_zero`` some rows of chain length 0
    whose position 0 holds NO_NODE."""
    coord = JCT.make_state(_rand_tables(rng, s=s, num_nodes=num_nodes,
                                        r_max=r_max), w)
    ver = np.zeros((w, s), np.uint32)
    ver[1, ::2] = 7
    ver[3, :] = 3
    ch = np.asarray(coord.chains).copy()
    ch[1] = np.where(ch[1] >= 0, (ch[1] + 1) % num_nodes, ch[1])
    lv = np.asarray(coord.live).copy()
    lv[2, 5] = False
    lo = np.asarray(coord.slot_lo).copy()
    lo[3, 2] = lo[3, 2] + np.uint32(3)
    cl = np.asarray(coord.chain_len).copy()
    if clen_zero:
        cl[:, ::3] = 0
        ch[:, ::6, :] = -1
    return dataclasses.replace(
        coord, version=jnp.asarray(ver), chains=jnp.asarray(ch),
        live=jnp.asarray(lv), slot_lo=jnp.asarray(lo),
        chain_len=jnp.asarray(cl))


def _packets(rng, B=512):
    keys = rng.integers(0, 2**32 - 2, B, dtype=np.uint64).astype(np.uint32)
    ops = rng.choice([JK.OP_GET, JK.OP_PUT, JK.OP_DEL], B).astype(np.int32)
    return keys, ops


@pytest.mark.parametrize("hash_partitioned", [False, True])
@pytest.mark.parametrize("clen_zero", [False, True])
def test_k5_plain_matches_reference_kernel(hash_partitioned, clen_zero):
    """K5's plain version (the wrapper's CPU path) equals the reference's
    range_match_stale, jnp ref and Pallas in interpret mode, and the
    observe_epoch formula of both packages."""
    rng = np.random.default_rng(11 + 2 * clen_zero + hash_partitioned)
    jcoord = _perturbed_state(rng, clen_zero=clen_zero)
    keys, ops = _packets(rng)
    tcoord = convert.coord_from_numpy(jcoord, device="cpu")
    tkeys = torch.tensor(keys.astype(np.int64))
    tops = torch.tensor(ops)
    got = TOps.range_match_stale(tcoord, tkeys, tops,
                                 hash_partitioned=hash_partitioned)
    assert [t.dtype for t in got] == [torch.int32, torch.int32, torch.bool]
    for use_pallas in (False, True):
        want = j_range_match_stale(jcoord, jnp.asarray(keys), jnp.asarray(ops),
                                   hash_partitioned=hash_partitioned,
                                   use_pallas=use_pallas, interpret=True)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), use_pallas
    # the formula observe_epoch's reference computes with gathered rows
    jk = jnp.asarray(keys)
    sw = JCT.ingress_switch(jk, jcoord.n_switches)
    mv = JK.matching_value(jk, hash_partitioned=hash_partitioned)
    sridx = JCT.stale_lookup(jcoord, sw, mv)
    is_write = (jnp.asarray(ops) == JK.OP_PUT) | (jnp.asarray(ops) == JK.OP_DEL)
    server = JCTS._chain_server(jcoord.chains[sw, sridx],
                                jcoord.chain_len[sw, sridx], is_write)
    div = jcoord.version[sw, sridx] != jcoord.committed[sridx]
    for g, w in zip(got, (sridx, server, div)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # and the port's own copy of that formula
    tsw = TCT.ingress_switch(tkeys, tcoord.n_switches)
    assert np.array_equal(tsw.numpy(), np.asarray(sw))
    tsridx = TCT.stale_lookup(
        tcoord, tsw, TK.matching_value(tkeys, hash_partitioned=hash_partitioned))
    assert np.array_equal(tsridx.numpy(), np.asarray(sridx))
    if clen_zero:
        # reads on a clen-0 slot take position 0, NO_NODE on some rows
        assert (got[1] < 0).any()


def _two_switch_state(mod):
    tables = dict(
        slot_lo=np.array([0, 8], np.uint32),
        slot_hi=np.array([7, 2**32 - 1], np.uint32),
        live=np.ones(2, bool),
        chains=np.array([[0], [1]], np.int32),
        chain_len=np.ones(2, np.int32),
    )
    ver = np.zeros((2, 2), np.uint32)
    ver[1] = 9
    if mod is JCT:
        coord = JCT.make_state(tables, 2)
        ch = np.asarray(coord.chains).copy()
        ch[1] = ch[1][::-1]
        return dataclasses.replace(coord, chains=jnp.asarray(ch),
                                   version=jnp.asarray(ver))
    coord = TCT.make_state(tables, 2, device="cpu")
    ch = coord.chains.clone()
    ch[1] = ch[1].flip(0)
    return dataclasses.replace(coord, chains=ch,
                               version=torch.tensor(ver.astype(np.int64)))


@pytest.mark.parametrize("quorum", [True, False])
def test_observe_epoch_accounting_unit(quorum):
    """The reference test's accounting case, both packages side by side:
    a rogue switch with swapped ownership stamped past the commit."""
    keys = np.arange(16, dtype=np.uint32)
    ops = np.where(keys % 3 == 0, JK.OP_PUT, JK.OP_GET).astype(np.int32)
    true_node = np.where(keys < 8, 0, 1).astype(np.int32)
    jq = SimpleNamespace(key=jnp.asarray(keys), opcode=jnp.asarray(ops))
    jdec = SimpleNamespace(chain=jnp.asarray(true_node)[:, None],
                           chain_len=jnp.ones(16, jnp.int32))
    tq = SimpleNamespace(key=torch.tensor(keys.astype(np.int64)),
                         opcode=torch.tensor(ops))
    tdec = SimpleNamespace(chain=torch.tensor(true_node.astype(np.int64))[:, None],
                           chain_len=torch.ones(16, dtype=torch.int64))
    jst, jred, jvia, jcs = JCT.observe_epoch(
        _two_switch_state(JCT), jq, jdec, jnp.int32(0), quorum=quorum)
    tst, tred, tvia, tcs = TCT.observe_epoch(
        _two_switch_state(TCT), tq, tdec, 0, quorum=quorum)
    assert np.array_equal(tred.numpy(), np.asarray(jred))
    assert np.array_equal(tvia.numpy(), np.asarray(jvia))
    assert np.array_equal(tcs.numpy(), np.asarray(jcs))
    _assert_coord_equal(jst, tst)
    sw = TCT.ingress_switch(tq.key, 2).numpy()
    n1 = int((sw == 1).sum())
    assert 0 < n1 < 16
    cs = tcs.numpy()
    if quorum:
        assert np.array_equal(tred.numpy(), sw == 1)
        assert cs.tolist() == [16, 16 - n1, n1, 0, 1]
        assert np.array_equal(tvia.numpy()[sw == 1], 1 - true_node[sw == 1])
    else:
        assert not tred.any() and cs[2] == 0 and cs[3] == n1


def test_install_pending_per_switch_epochs():
    new_chains = np.array([[1], [0]], np.int32)
    pend_v = np.array([4, 4], np.uint32)
    at = np.array([2, 5], np.int32)
    j = dataclasses.replace(_two_switch_state(JCT),
                            pend_chains=jnp.asarray(new_chains),
                            pend_version=jnp.asarray(pend_v),
                            install_at=jnp.asarray(at))
    t = dataclasses.replace(_two_switch_state(TCT),
                            pend_chains=torch.tensor(new_chains.astype(np.int64)),
                            pend_version=torch.tensor(pend_v.astype(np.int64)),
                            install_at=torch.tensor(at.astype(np.int64)))
    for e in (0, 3, 4, 5, 9):
        j = JCT.install_pending(j, jnp.int32(e))
        t = TCT.install_pending(t, e)
        _assert_coord_equal(j, t)
    assert (t.install_at == TCT.INSTALL_NEVER).all()
    assert np.array_equal(t.chains[1].numpy(), new_chains)


# ---------------------------------------------------------------------------
# the manager side by side with the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_chaos_manager_matches_reference(seed):
    """The reference test's chaos interleaving of table rewrites, drift,
    split brain and lease faults, with both managers driven by the same
    draws: their states, notes and summaries agree after every step, and
    the port converges within the bound after quiescence."""
    rng = np.random.default_rng(seed)
    tables = _rand_tables(rng)
    cfg = dict(n_switches=4, lag_per_hop=2, drift_mult=3, lease_epochs=3,
               failover_after=1)
    jm = JCT.CoordManager(JCT.CoordConfig(**cfg), tables, num_nodes=8)
    tm = TCT.CoordManager(TCT.CoordConfig(**cfg), tables, num_nodes=8,
                          device="cpu")
    jc, tc = jm.make_state(), tm.make_state()
    _assert_coord_equal(jc, tc)

    def both(name, *args, now):
        nonlocal jc, tc
        jc, jn = getattr(jm, name)(*args, jc, tables, now=now)
        # on the CPU the reference's jnp.asarray may share the manager's
        # host vector, which its next call bumps in place (ROADMAP F6);
        # a device copy gives the state it has on an accelerator
        jc = jax.tree.map(lambda x: jnp.array(x, copy=True), jc)
        tc, tn = getattr(tm, name)(*args, tc, tables, now=now)
        assert jn == tn
        _assert_coord_equal(jc, tc)
        assert jm.summary() == tm.summary()

    split_active = False
    T = 16
    for e in range(T):
        jc = JCT.install_pending(jc, jnp.int32(e))
        tc = TCT.install_pending(tc, e)
        _assert_coord_equal(jc, tc)
        r = rng.random()
        if r < 0.2 and not split_active:
            both("on_event", "split_brain", int(rng.integers(4)), now=e)
            split_active = True
        elif r < 0.35 and split_active:
            both("on_event", "heal_split", 0, now=e)
            split_active = False
        elif r < 0.45:
            both("on_event", "quorum_drift", int(rng.integers(4)), now=e)
        elif r < 0.55:
            both("on_event", "lease_expire", 0, now=e)
        if rng.random() < 0.7:
            _mutate_tables(rng, tables)
        both("on_control", now=e)
    if split_active:
        both("on_event", "heal_split", 0, now=T)
    both("on_event", "lease_renew", 0, now=T)
    both("on_control", now=T)
    for e in range(T, T + tm.bound() + 1):
        tc = TCT.install_pending(tc, e)
    assert tm.converged(tc)
    with pytest.raises(ValueError, match="unknown coordination event"):
        tm.on_event("bogus", 0, tc, tables, now=T)


def test_manager_copies_never_alias_the_state():
    """``on_control`` bumps its host vector in place after an earlier call
    handed it to the state; on the CPU the state must hold a copy."""
    rng = np.random.default_rng(5)
    tables = _rand_tables(rng)
    tm = TCT.CoordManager(TCT.CoordConfig(), tables, num_nodes=8, device="cpu")
    c0 = tm.make_state()
    _mutate_tables(rng, tables)
    c1, _ = tm.on_control(c0, tables, now=1)
    saved = c1.committed.clone()
    _mutate_tables(rng, tables)
    c2, _ = tm.on_control(c1, tables, now=2)
    assert torch.equal(c1.committed, saved)
    assert not torch.equal(c2.committed, saved)
    c3, _ = tm.on_event("split_brain", 1, c2, tables, now=3)
    assert torch.equal(c2.version, torch.zeros_like(c2.version))
    assert c3.version.data_ptr() != c2.version.data_ptr()


def test_coord_converters_round_trip():
    jcoord = _perturbed_state(np.random.default_rng(2))
    tcoord = convert.coord_from_numpy(jcoord, device="cpu")
    assert all(getattr(tcoord, f).dtype in (torch.int64, torch.bool)
               for f in convert.COORD_FIELDS)
    _assert_coord_equal(jcoord, tcoord)
    back = convert.coord_from_numpy(convert.coord_to_numpy(tcoord),
                                    device="cpu")
    for f in convert.COORD_FIELDS:
        assert torch.equal(getattr(back, f), getattr(tcoord, f)), f


# ---------------------------------------------------------------------------
# the pod hierarchy (tests/test_system.py::test_hierarchy_consistency)
# ---------------------------------------------------------------------------


def test_hierarchy_matches_reference():
    jd = JC.make_directory(32, 8, 3, num_pods=2)
    td = TD.make_directory(32, 8, 3, num_pods=2, device="cpu")
    jt, tt = JC.derive_pod_table(jd, 2), TH.derive_pod_table(td, 2)
    assert np.array_equal(np.asarray(jt.head_pod), tt.head_pod.numpy())
    assert np.array_equal(np.asarray(jt.tail_pod), tt.tail_pod.numpy())
    keys = np.arange(0, 2**32 - 1, 2**27, dtype=np.uint64).astype(np.uint32)
    ops = np.tile(np.array([JK.OP_GET, JK.OP_PUT], np.int32), 16)
    jq = JC.make_queries(jnp.asarray(keys), jnp.asarray(ops))
    tq = TR.make_queries(keys, ops, device="cpu")
    pods = TH.route_pod(tt, td, tq)
    assert np.array_equal(pods.numpy(), np.asarray(JC.route_pod(jt, jd, jq)))
    dec, _ = TR.route(td, tq)
    assert np.array_equal(pods.numpy(),
                          td.node_addr[:, 0][dec.target].numpy())
    from repro.core import hierarchy as JH
    for pod in (0, 1):
        assert np.array_equal(TH.pod_local_view(td, pod).numpy(),
                              np.asarray(JH.pod_local_view(jd, pod)))
    for args in ((1,), (3,), (2, 4), (5, None)):
        assert TH.switch_topology(*args) == JH.switch_topology(*args)


# ---------------------------------------------------------------------------
# the ported bench
# ---------------------------------------------------------------------------


def _reference_bench():
    path = (pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
            / "coordination_tier_bench.py")
    spec = importlib.util.spec_from_file_location("_ref_coord_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_gates_pass_and_fail_like_the_reference():
    """The port's bench at its quick size passes its gates on the CPU;
    broken rows fail them with the reference's findings ("traced" in the
    reference's wording is "built" in the port's)."""
    JB = _reference_bench()
    rows = (TB.run_sweep(True, verbose=False, device="cpu")
            + TB.run_parity(True, verbose=False, device="cpu")
            + TB.run_faults(True, verbose=False, device="cpu"))
    assert len(rows) == 9
    assert TB.check_coordination(rows) == JB.check_coordination(rows) == []
    bad = [dict(r) for r in rows]
    bad[0]["total_redirected"] = 5          # zero lag redirected
    bad[1]["traces"] = 2
    bad[4]["parity_mismatches"] = 1
    bad[5]["total_mis_served"] = 3          # lease_expiry quorum
    bad[8]["conservation_ok"] = False
    bad[8]["total_redirected"] = 1          # split_brain baseline
    got = TB.check_coordination(bad)
    assert got == [p.replace("traced", "built")
                   for p in JB.check_coordination(bad)]
    assert len(got) == 6
    assert TB.check_coordination(rows[:4] + rows[5:6]) == [
        "coord_fault: missing an arm for lease_expiry",
        "coord_fault: missing an arm for split_brain"]


def test_bench_full_size_lag1_run_matches_reference():
    """The sweep's lag-1 run at the bench's full size (the size of the
    committed BENCH_coord_tier.json), in both packages: equal metric
    streams."""
    JB = _reference_bench()
    jdrv, jrows, _ = JB._drive(TB.SWEEP_SCENARIO, False,
                               JCT.CoordConfig(n_switches=4, lag_per_hop=1))
    tdrv, trows, _ = TB._drive(TB.SWEEP_SCENARIO, False,
                               TCT.CoordConfig(n_switches=4, lag_per_hop=1),
                               "cpu")
    _assert_rows_equal(jrows, trows)
    assert TB._row(tdrv, trows, 0.0)["total_redirected"] > 0
