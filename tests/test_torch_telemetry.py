"""The trace plane (``repro_torch.telemetry``) against the JAX reference,
bit for bit, on ``tests/test_telemetry.py``'s own cases: every one of
them runs on both packages with the same inputs.

* sampling: the same ``hash(key, epoch) < rate`` masks (keys >= 2**31
  too), slot-cap truncation counted, not hidden;
* the span tables: each epoch's ``span_i`` / ``span_f`` rows, counts,
  DES latency, issue and per-hop times and the five attribution buckets
  equal the reference's, and ``verify_exact() == 0.0``, under the retry
  storm, a rack failure and CRAQ bounces; the fused loop equals the
  per-epoch loop;
* the planes only observe: the metric stream with tracing on equals the
  stream with it off, and with it off the host syncs are those the
  driver made before the plane was ported;
* the host halves: attribution, span trees, the Chrome trace and JSONL,
  the flight ring and its dumps, the stage timers and the roofline rows.

Pinned beside them: ``routing.pack_chain`` (a four-member chain packs to
a negative word), ``svc_total`` summed left to right where torch's
``sum`` and jax's differ (a plan six hops wide), and ``collect_spans`` on
one batch against the reference.

The reference drivers run the per-epoch loop, which the reference holds
bit-identical to its fused scan (and which compiles in a fraction of the
time); the port runs both."""

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
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import cluster as JCl
from repro import core as JC
from repro import overload as JO
from repro import telemetry as JT
from repro.core import routing as JR
from repro.telemetry import trace as JTR
from repro_torch import cluster as TCl
from repro_torch import overload as TO
from repro_torch import telemetry as TT
from repro_torch.core import coordination as TCo
from repro_torch.core import routing as TR
from repro_torch.telemetry import profiler as TP
from repro_torch.telemetry import trace as TTR
from repro_torch.telemetry.attribution import (
    B_BOUNCE,
    B_INFLATION,
    B_QUEUE,
    B_RETRY,
    B_SERVICE,
)

SCFG = dict(n_epochs=6, epoch_ops=256, n_records=512, value_dim=2, seed=3)
HOT = dict(theta=1.2, shift_every=2)
OVL_PARITY = dict(queue_cap=24, service_rate=40, inflation=3.0, max_level=3,
                  backoff_base=1, jitter_span=2, queue_weight=2)
# service below the per-node epoch share: queues stand across epochs
OVL_STORM = dict(queue_cap=48, service_rate=24, inflation=3.0, max_level=3,
                 backoff_base=1, jitter_span=2, queue_weight=2)
STORM_CKW = dict(standby_nodes=(6, 7), num_ranges=16)

# name -> (scenario, policy, TelemetryConfig knobs, scenario knobs,
# cluster knobs, OverloadConfig knobs or None, PolicyConfig knobs or None,
# ScenarioConfig changes): tests/test_telemetry.py's runs
RUNS = {
    "traced": ("shifting_hotspot", "full_adaptive",
               dict(sample_rate=1 / 2, max_spans=64), HOT, {}, None, None, {}),
    "slot_cap": ("stationary", "frozen", dict(sample_rate=1.0, max_spans=8),
                 {}, {}, None, None, {}),
    "quarter": ("shifting_hotspot", "full_adaptive", dict(sample_rate=1 / 4),
                HOT, {}, None, None, {}),
    "overload": ("retry_storm", "overload_adaptive",
                 dict(sample_rate=1 / 2, max_spans=128), {}, STORM_CKW,
                 OVL_PARITY, dict(scale_patience=1), {}),
    **{f"storm{s}": ("retry_storm", "overload_adaptive",
                     dict(sample_rate=1 / 2, max_spans=256), {}, STORM_CKW,
                     OVL_STORM, dict(scale_patience=1),
                     dict(seed=s, n_epochs=8)) for s in range(3)},
    # the storm once more with the orbit-identity register live
    "storm_linked": ("retry_storm", "overload_adaptive",
                     dict(sample_rate=1 / 2, max_spans=256, link_retries=12),
                     {}, STORM_CKW, OVL_STORM, dict(scale_patience=1),
                     dict(n_epochs=8)),
    "rack": ("rack_failure_hotspot", "migrate",
             dict(sample_rate=1 / 2, max_spans=128),
             dict(fail_epoch=2, rack=(0, 1), recover_epoch=4), {}, None, None,
             {}),
    "craq": ("ycsb_a", "frozen", dict(sample_rate=1.0, max_spans=256), {},
             dict(replication_mode="craq"), None, None, {}),
    "slo": ("stationary", "frozen",
            dict(sample_rate=1 / 4, slo_p999=1e-3, flight_epochs=4), {}, {},
            None, None, {}),
}


def _driver(mod, name, fused, tel=True, flight_dir=None):
    scen, pol, tkw, skw, ckw, okw, pkw, sch = RUNS[name]
    base = dict(num_nodes=8, num_ranges=32, replication=2, r_max=4,
                n_clients=16, report_every=2, imbalance_threshold=1.1,
                max_moves_per_round=6)
    base.update(ckw)
    if okw is not None:
        ovl_mod = TO if mod is TCl else JO
        base["overload"] = ovl_mod.OverloadConfig(**okw)
    if tel:
        # each run dumps into its own directory, so the dumps compare
        if flight_dir is not None:
            side = "port" if mod is TCl else "ref"
            flight_dir = f"{flight_dir}/{side}_{fused}"
        base["telemetry"] = mod.TelemetryConfig(**tkw, flight_dir=flight_dir)
    policy = mod.make_policy(pol, None if pkw is None
                             else mod.PolicyConfig(**pkw))
    scenario = mod.make_scenario(scen, mod.ScenarioConfig(**{**SCFG, **sch}),
                                 **skw)
    kw = dict(device="cpu") if mod is TCl else {}
    return mod.EpochDriver(scenario, policy, mod.ClusterConfig(**base),
                           fused=fused, **kw)


# segments each cached port run went through (the host syncs they cost)
_SEGMENTS: dict = {}


@functools.lru_cache(maxsize=None)
def _run(side, name, fused=True, tel=True, flight_dir=None):
    if side == "ref":
        drv = _driver(JCl, name, fused, tel, flight_dir)
        return drv, drv.run()
    drv = _driver(TCl, name, fused, tel, flight_dir)
    segs = list(drv.segments())
    _SEGMENTS[(name, fused, tel, flight_dir)] = len(segs)
    return drv, [r for seg in segs for r in seg]


def _ref(name, flight_dir=None):
    return _run("ref", name, False, True, flight_dir)


def _port(name, fused=True, flight_dir=None):
    return _run("port", name, fused, True, flight_dir)


def _rows(rows):
    return [dataclasses.asdict(r) for r in rows]


def _assert_same_epochs(a, b):
    """Two recorders' per-epoch span records, bit for bit."""
    assert len(a.epochs) == len(b.epochs)
    for ra, rb in zip(a.epochs, b.epochs):
        for k in ("epoch", "t0", "makespan", "n_sampled"):
            assert ra[k] == rb[k], (ra["epoch"], k)
        for k in ("span_i", "span_f", "lat", "comps", "issue", "hops"):
            x, y = np.asarray(ra[k]), np.asarray(rb[k])
            assert x.dtype == y.dtype and np.array_equal(x, y), (ra["epoch"], k)


def _assert_same_telemetry(jdrv, tdrv, snapshots=True):
    """The recorders of two runs; the flight ring's state snapshots (taken
    a segment) only with ``snapshots``, for two runs of one loop."""
    _assert_same_epochs(jdrv.telemetry, tdrv.telemetry)
    assert jdrv.telemetry.breaches == tdrv.telemetry.breaches
    strip = (lambda e: e) if snapshots else (
        lambda e: {k: v for k, v in e.items() if k != "state"})
    assert ([strip(e) for e in jdrv.telemetry.flight.ring]
            == [strip(e) for e in tdrv.telemetry.flight.ring])
    skip = ("flight_dumps", "stage_s", "stage_calls", "stage_share", "total_s")
    js, ts = jdrv.telemetry.summary(), tdrv.telemetry.summary()
    assert {k: v for k, v in js.items() if k not in skip} == {
        k: v for k, v in ts.items() if k not in skip}


def _parity(name, flight_dir=None, per_epoch=True):
    """Port fused == reference, spans and rows; with ``per_epoch`` the
    port's per-epoch loop too, whose flight ring (state snapshots
    included, taken a segment) equals the reference's loop's."""
    jdrv, jrows = _ref(name, flight_dir)
    tdrv, trows = _port(name, True, flight_dir)
    assert _rows(jrows) == _rows(trows)
    _assert_same_telemetry(jdrv, tdrv, snapshots=False)
    if per_epoch:
        edrv, erows = _port(name, False, flight_dir)
        assert _rows(erows) == _rows(trows)
        _assert_same_telemetry(jdrv, edrv)
    return jdrv, tdrv, trows


# ---------------------------------------------------------------------------
# sampling: deterministic, PRNG-free, slot-capped but never silent
# ---------------------------------------------------------------------------


def test_sample_mask_deterministic_and_rate_extremes():
    keys = np.concatenate([np.arange(1000), 2**32 - 1 - np.arange(1000),
                           2**31 + np.arange(24)]).astype(np.uint32)
    tk = torch.tensor(keys.astype(np.int64))
    thr = TT.rate_threshold(0.25)
    assert thr == JT.rate_threshold(0.25)
    for epoch in (0, 3, 4, 2**20 + 7):
        want = np.asarray(JT.sample_mask(jnp.asarray(keys), epoch, thr))
        assert np.array_equal(TT.sample_mask(tk, epoch, thr).numpy(), want)
    m1 = TT.sample_mask(tk, 3, thr).numpy()
    assert TT.sample_mask(tk, 3, TT.rate_threshold(1.0)).numpy().all()
    assert not TT.sample_mask(tk, 3, TT.rate_threshold(0.0)).numpy().any()
    assert (m1 != TT.sample_mask(tk, 4, thr).numpy()).any()
    assert 0.15 < m1.mean() < 0.35
    for bad in (1.5, -0.1):
        with pytest.raises(ValueError):
            TT.rate_threshold(bad)


def test_slot_cap_truncates_but_reports():
    _, tdrv, _ = _parity("slot_cap", per_epoch=False)
    s = tdrv.telemetry.summary()
    assert s["spans_sampled"] == SCFG["n_epochs"] * SCFG["epoch_ops"]
    assert s["spans"] == SCFG["n_epochs"] * 8
    for rec in tdrv.telemetry.epochs:
        assert rec["span_i"].shape == (8, len(TT.SPAN_I_FIELDS))
        assert rec["span_f"].shape == (8, len(TT.SPAN_F_FIELDS))
        assert (rec["span_i"][:, TT.SI["qid"]] >= 0).all()
        assert rec["n_sampled"] == SCFG["epoch_ops"]
    assert tdrv.telemetry.verify_exact() == 0.0


# ---------------------------------------------------------------------------
# the pure-observer contract
# ---------------------------------------------------------------------------


def test_telemetry_off_on_bit_parity_single_trace():
    base_drv, base = _run("port", "quarter", True, False)
    jdrv, tdrv, rows = _parity("quarter")
    assert _rows(base) == _rows(rows)
    assert all(r.compiled_steps == 1 for r in rows)   # no second program
    assert tdrv.telemetry.span_count > 0
    assert tdrv.telemetry.verify_exact() == 0.0
    assert base_drv.telemetry is None


# planes off: the host syncs the driver made before the trace plane was
# ported (the fused loop: one copy home a segment, plus the pulls)
SYNCS_OFF = {("quarter", True): 12, ("quarter", False): 27,
             ("overload", True): 13, ("overload", False): 36,
             ("craq", True): 12, ("craq", False): 33}


@pytest.mark.parametrize("name,fused", list(SYNCS_OFF))
def test_planes_on_equal_off_host_syncs_and_stream(name, fused):
    """Tracing on: the same metric stream and final overload state; its
    host syncs are the off run's plus one snapshot copy a segment (the
    spans ride the segment's copy in the fused loop, the snapshot's in the
    per-epoch one).  Tracing off: the pre-port count and stages."""
    off, off_rows = _run("port", name, fused, False)
    on, on_rows = _run("port", name, fused, True)
    assert _rows(off_rows) == _rows(on_rows)
    assert off.host_syncs == SYNCS_OFF[(name, fused)]
    assert on.host_syncs == off.host_syncs + _SEGMENTS[(name, fused, False,
                                                        None)]
    if off.ovl is not None:
        for f in dataclasses.fields(off.ovl):
            assert torch.equal(getattr(off.ovl, f.name),
                               getattr(on.ovl, f.name)), f.name
    for a, b in ((off.store.keys, on.store.keys),
                 (off.store.values, on.store.values),
                 (off.store.overflow, on.store.overflow),
                 (off.load_reg, on.load_reg), (off.sketch, on.sketch),
                 (off.repl.version, on.repl.version),
                 (off.repl.acked, on.repl.acked),
                 (off.directory.chains, on.directory.chains)):
        assert torch.equal(a, b)
    assert sorted(off.stage_seconds) == sorted(
        k for k in on.stage_seconds if k != "telemetry")


def test_telemetry_parity_with_overload_plane():
    """The span block reads the PRE-step overload state and must not
    perturb the queue dynamics."""
    base_drv, base = _run("port", "overload", True, False)
    jdrv, tdrv, rows = _parity("overload")
    assert _rows(base) == _rows(rows)
    assert tdrv.telemetry.verify_exact() == 0.0
    for f in dataclasses.fields(base_drv.ovl):
        assert torch.equal(getattr(base_drv.ovl, f.name),
                           getattr(tdrv.ovl, f.name)), f.name


# ---------------------------------------------------------------------------
# exact reconstruction: fail / park / bounce
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reconstruction_exact_under_retry_storm(seed):
    _, tdrv, _ = _parity(f"storm{seed}", per_epoch=False)
    tel = tdrv.telemetry
    assert tel.span_count > 0
    assert tel.verify_exact() == 0.0
    si = np.concatenate([r["span_i"] for r in tel.epochs])
    comps, lat = tel.all_comps(), tel.all_latency()
    rejected = np.isin(si[:, TT.SI["outcome"]], (1, 2))
    assert rejected.any(), "storm produced no deferred/shed spans"
    assert np.array_equal(comps[rejected, B_RETRY], lat[rejected])
    assert (comps[rejected][:, [B_QUEUE, B_INFLATION, B_BOUNCE,
                                B_SERVICE]] == 0.0).all()
    assert (si[:, TT.SI["queue_depth"]] > 0).any()


def test_retry_orbits_link_like_the_reference():
    """``link_retries=12``: the orbit-identity register is sized, stamped
    by ``overload.link_orbit`` in the step, and the stitched orbit trees
    equal the reference's."""
    jdrv, tdrv, _ = _parity("storm_linked", per_epoch=False)
    assert tdrv.ovl.first_seen.shape == (1 << 12,)
    for a, b in ((jdrv.ovl.first_seen, tdrv.ovl.first_seen),):
        assert np.array_equal(np.asarray(a), b.numpy())
    orbits = tdrv.telemetry.retry_orbits()
    assert orbits and orbits == jdrv.telemetry.retry_orbits()
    si = np.concatenate([r["span_i"] for r in tdrv.telemetry.epochs])
    assert (si[:, TT.SI["first_epoch"]] >= 0).any()
    assert tdrv.telemetry.verify_exact() == 0.0


def test_reconstruction_exact_under_rack_failure():
    _, tdrv, rows = _parity("rack", per_epoch=False)
    assert any("rack_fail" in e for r in rows for e in r.events)
    assert tdrv.telemetry.span_count > 0
    assert tdrv.telemetry.verify_exact() == 0.0


def test_reconstruction_exact_under_craq_bounces():
    _, tdrv, rows = _parity("craq")
    assert sum(r.dirty_reads for r in rows) > 0
    si = np.concatenate([r["span_i"] for r in tdrv.telemetry.epochs])
    comps = tdrv.telemetry.all_comps()
    bounced = si[:, TT.SI["bounced"]] == 1
    assert bounced.any(), "craq writes produced no sampled bounces"
    model = tdrv.cfg.latency
    expected = float(np.float32(model.lookup)) + float(np.float32(model.link))
    assert np.allclose(comps[bounced, B_BOUNCE], expected)
    assert (comps[~bounced, B_BOUNCE] == 0.0).all()
    assert tdrv.telemetry.verify_exact() == 0.0


def test_decompose_reconstruct_synthetic_rows():
    model = TCo.LatencyModel()
    link = float(np.float32(model.link))
    lookup = float(np.float32(model.lookup))
    n = 4
    si = np.full((n, len(TT.SPAN_I_FIELDS)), -1, np.int32)
    sf = np.zeros((n, len(TT.SPAN_F_FIELDS)), np.float32)
    si[:, TT.SI["outcome"]] = (0, 0, 0, 2)
    si[:, TT.SI["bounced"]] = (0, 0, 1, 0)
    sf[0] = (10.0, 4.0, 10.0, 10.0, 1.0)
    sf[1] = (30.0, 4.0, 30.0, 10.0, 3.0)
    sf[2] = (12.0 + lookup, 6.0, 12.0, 12.0, 1.0)
    sf[3] = (0.0, 1.0, 0.0, 0.0, 1.0)
    lat = np.array([20.0, 40.0, 25.0, 50.0])
    comps = TT.decompose(si, sf, lat, model)
    want = JT.decompose(si, sf, lat, JC.LatencyModel())
    assert comps.dtype == want.dtype and np.array_equal(comps, want)
    np.testing.assert_array_equal(TT.reconstruct(comps), lat)
    assert comps[0, B_QUEUE] == 6.0 and comps[0, B_SERVICE] == 14.0
    assert comps[1, B_INFLATION] == 20.0
    assert comps[2, B_BOUNCE] == lookup + link
    assert (comps[3] == (0, 0, 0, 50.0, 0)).all()


def test_tail_attribution_shares():
    rng = np.random.default_rng(11)
    lat = rng.exponential(40.0, 500)
    comps = np.zeros((500, len(TT.BUCKETS)))
    comps[:, B_SERVICE] = 10.0
    comps[:, B_QUEUE] = lat - 10.0
    out = TT.tail_attribution(lat, comps, q=99.0)
    assert out == JT.tail_attribution(lat, comps, q=99.0)
    assert out["n"] == 500 and out["n_tail"] >= 1
    assert sum(out["share"].values()) == pytest.approx(1.0)
    assert out["mass"]["queue"] > out["mass"]["service"]
    empty = TT.tail_attribution(np.zeros(0), np.zeros((0, len(TT.BUCKETS))))
    assert empty == JT.tail_attribution(np.zeros(0),
                                        np.zeros((0, len(TT.BUCKETS))))
    assert empty["n"] == 0 and empty["mass"] == {}


# ---------------------------------------------------------------------------
# satellites: masked_p99 vectorization, row round-trip, summarize order
# ---------------------------------------------------------------------------


def _masked_cases():
    rng = np.random.default_rng(7)
    lat = rng.exponential(50.0, size=(13, 257))
    mask = rng.random((13, 257)) < rng.random((13, 1))
    mask[3] = False
    mask[4] = True
    mask[5] = False
    mask[5, 17] = True
    return lat, mask


def test_masked_p99_batch_matches_loop_bitwise():
    lat, mask = _masked_cases()
    got = TCl.masked_p99_batch(lat, mask)
    np.testing.assert_array_equal(got, JCl.masked_p99_batch(lat, mask))
    from repro_torch.cluster.metrics import masked_p99_batch_loop

    np.testing.assert_array_equal(got, masked_p99_batch_loop(lat, mask))
    assert got[3] == 0.0 and got[5] == lat[5, 17]
    np.testing.assert_array_equal(
        TCl.masked_p99_batch(np.zeros((3, 0)), np.zeros((3, 0), bool)),
        np.zeros(3))
    with pytest.raises(ValueError):
        TCl.masked_p99_batch(lat, mask[:, :5])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_masked_p99_batch_property(seed):
    rng = np.random.default_rng(seed)
    P, B = rng.integers(1, 9), rng.integers(1, 400)
    lat = rng.lognormal(3.0, 1.0, size=(P, B))
    mask = rng.random((P, B)) < rng.random()
    np.testing.assert_array_equal(TCl.masked_p99_batch(lat, mask),
                                  JCl.masked_p99_batch(lat, mask))


def test_masked_p99_batch_all_masked_row():
    lat = np.linspace(1.0, 2.0, 4 * 8).reshape(4, 8)
    mask = np.zeros((4, 8), bool)
    with np.errstate(invalid="raise", over="raise"):
        got = TCl.masked_p99_batch(lat, mask)
    np.testing.assert_array_equal(got, np.zeros(4))
    mask[2, :3] = True
    got2 = TCl.masked_p99_batch(lat, mask)
    np.testing.assert_array_equal(got2, JCl.masked_p99_batch(lat, mask))
    assert got2[2] == np.percentile(lat[2, :3], 99)


_ROW = dict(epoch=3, scenario="s", policy="p", ops=10, throughput=1.5,
            p50=1.0, p99=2.0, makespan=9.0, imbalance=1.2, cov=0.3,
            migration_entries=5, migration_bytes=100, drops=1, retries=2,
            compiled_steps=1, events=["rack_fail:0+1"], deferred=1, shed=2,
            requeued=3, lost=0, queue_peak=7, p999=3.25, read_p99=2.5,
            clean_read_p99=2.4, dirty_reads=4, replication="craq")


def test_epoch_metrics_row_round_trip():
    m = TCl.EpochMetrics(**_ROW)
    row = m.to_row()
    assert row == JCl.EpochMetrics(**_ROW).to_row()
    assert TCl.EpochMetrics.from_row(row) == m
    assert TCl.EpochMetrics.from_row(json.loads(json.dumps(row))) == m
    assert TCl.EpochMetrics.from_row(row).events is not row["events"]


def test_summarize_key_order_and_uniqueness():
    kw = dict(epoch=0, scenario="s", policy="p", ops=1, throughput=1.0,
              p50=1.0, p99=2.0, makespan=1.0, imbalance=1.0, cov=0.0,
              migration_entries=0, migration_bytes=0, drops=0, retries=0,
              compiled_steps=1, p999=7.5)
    s = TCl.summarize([TCl.EpochMetrics(**kw)])
    assert list(s) == list(JCl.summarize([JCl.EpochMetrics(**kw)]))
    assert len(s) == len(set(s))
    keys = list(s)
    assert keys.index("max_p999") == keys.index("mean_p999") + 1
    assert s["max_p999"] == 7.5


# ---------------------------------------------------------------------------
# exports: span trees + Chrome trace
# ---------------------------------------------------------------------------


def test_span_tree_structure():
    jdrv, tdrv, _ = _parity("traced")
    n = 0
    for jr, tr in zip(jdrv.telemetry.epochs, tdrv.telemetry.epochs):
        for j in range(tr["span_i"].shape[0]):
            tree = TT.span_tree(tr, j, tdrv.cfg.latency)
            assert tree == JT.span_tree(jr, j, jdrv.cfg.latency)
            n += 1
    assert n > 0
    rec = next(r for r in tdrv.telemetry.epochs if r["span_i"].shape[0] > 0)
    tree = TT.span_tree(rec, 0, tdrv.cfg.latency)
    for key in ("epoch", "qid", "key", "op", "target", "chain", "outcome",
                "start", "latency", "components", "hops"):
        assert key in tree
    assert sum(tree["components"].values()) == pytest.approx(
        tree["latency"], abs=1e-9)
    assert set(tree["components"]) == set(TT.BUCKETS)
    json.dumps(tree)


def test_chrome_trace_and_jsonl_exports(tmp_path):
    jdrv, tdrv, _ = _parity("traced")
    trace = tdrv.telemetry.chrome_trace()
    assert trace == jdrv.telemetry.chrome_trace()
    n_spans = tdrv.telemetry.span_count
    events = trace["traceEvents"]
    roots = [e for e in events if e["cat"] == "query"]
    assert len(roots) == n_spans and len(events) > n_spans
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    path = tdrv.telemetry.write_chrome_trace(str(tmp_path / "trace.json"))
    assert json.load(open(path))["otherData"]["scenario"] == "shifting_hotspot"
    # trace_dir (the reference's jax_trace_dir): run() under torch.profiler
    scen = TCl.make_scenario("stationary", TCl.ScenarioConfig(**{
        **SCFG, "n_epochs": 2}))
    drv = TCl.EpochDriver(scen, TCl.make_policy("frozen"), TCl.ClusterConfig(
        num_ranges=16, report_every=2, telemetry=TCl.TelemetryConfig(
            trace_dir=str(tmp_path / "prof"))), device="cpu")
    assert len(drv.run()) == 2
    prof = tmp_path / "prof" / "trace_stationary_frozen.json"
    assert json.load(open(prof))["traceEvents"]
    jpath = tdrv.telemetry.write_jsonl(str(tmp_path / "spans.jsonl"))
    rpath = jdrv.telemetry.write_jsonl(str(tmp_path / "ref.jsonl"))
    assert open(jpath).read() == open(rpath).read()
    assert len(open(jpath).readlines()) == n_spans


# ---------------------------------------------------------------------------
# profiler: stage timers + kernel roofline
# ---------------------------------------------------------------------------


def test_stage_timers_unit():
    t = TT.StageTimers(enabled=True)
    for name in ("a", "a", "b"):
        with t.stage(name):
            pass
    s = t.summary()
    assert s["stage_calls"] == {"a": 2, "b": 1}
    assert s["total_s"] >= 0.0
    assert sum(s["stage_share"].values()) == pytest.approx(1.0, abs=1e-3)
    assert list(s) == list(JT.StageTimers().summary())
    off = TT.StageTimers(enabled=False)
    with off.stage("a"):
        pass
    assert off.lap("b", 0.0) > 0.0
    assert off.summary()["stage_calls"] == {}
    # sync applies only to an enabled timer, and blocks only on a card
    assert not TT.StageTimers(enabled=False, sync=True).sync
    TT.StageTimers(sync=True).block(torch.device("cpu"))


def test_driver_stage_timers_fire():
    """One timer mechanism: the driver's ``stage_seconds`` is the
    recorder's timers' view.  The port brings the segment home in one copy
    before the DES, inside ``des`` (the reference's ``host_sync`` stage);
    ``telemetry`` times the recorder's segment work."""
    _, tdrv, _ = _parity("traced")
    calls = tdrv.telemetry.timers.calls
    assert tdrv.telemetry.timers is tdrv.timers
    assert tdrv.stage_seconds is tdrv.timers.totals
    for stage in ("inject", "route_apply", "des", "control", "telemetry"):
        assert calls.get(stage, 0) > 0, f"stage {stage} never timed"
    assert tdrv.timers.sync            # profile_stages blocks on the step
    assert "stage_share" in tdrv.telemetry.summary()
    off, _ = _run("port", "traced", True, False)
    assert not off.timers.sync and "telemetry" not in off.stage_seconds


def test_kernel_roofline_rows_smoke():
    rows = TT.kernel_roofline_rows(batch=256, num_ranges=16, num_nodes=4,
                                   measure_iters=1, device="cpu")
    assert [r["kernel"] for r in rows] == list(TP.KERNELS)
    for r in rows:
        assert r["impl"] == "plain" and r["device"] == "cpu"
        assert r["bytes"] == TP.route_bytes(r["kernel"], B=256, S=32, N=4,
                                            r_max=4, C=1024, W=4) > 0
        assert r["flops"] >= 0
        assert r["bound"] in ("memory", "compute")
        assert r["roofline_us"] == max(r["t_compute_us"], r["t_memory_us"])
        assert r["t_memory_us"] == r["bytes"] / TP.HBM_BYTES_PER_S * 1e6
        assert r["measured_us"] > 0
        assert r["intensity_flop_per_byte"] == pytest.approx(
            r["flops"] / r["bytes"])
    assert "| range_match |" in TT.fmt_roofline_md(rows)
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            TT.kernel_roofline_rows(batch=8, measure_iters=1)
        else:
            raise RuntimeError("CUDA present")


# ---------------------------------------------------------------------------
# flight recorder: bounded ring, dedupe, breach dumps
# ---------------------------------------------------------------------------


def _dump_docs(paths):
    return [json.load(open(p)) for p in paths]


def test_flight_recorder_ring_and_dedupe(tmp_path):
    recs = []
    for i, mod in enumerate((TT, JT)):
        fr = mod.FlightRecorder(3, str(tmp_path / str(i)), tag="t")
        for e in range(10):
            fr.record({"epoch": e, "arr": np.arange(2), "f": np.float32(1.5)})
        assert len(fr.ring) == 3
        assert [e["epoch"] for e in fr.ring] == [7, 8, 9]
        p1 = fr.dump("slo_p999:epoch 9")
        assert p1 and json.load(open(p1))["epochs_recorded"] == 3
        assert fr.dump("slo_p999:epoch 10") is None
        assert fr.dump("conservation:gap 2") is not None
        assert fr.dump("slo_p999:epoch 11", force=True) is not None
        assert len(fr.dumps) == 3
        assert json.load(open(p1))["epochs"][0]["arr"] == [0, 1]
        recs.append(_dump_docs(fr.dumps))
    assert recs[0] == recs[1]


def test_flight_dump_dedup_across_mixed_reasons(tmp_path):
    seq = ["slo_p999:epoch 1", "conservation:gap 3", "slo_p999:epoch 2",
           "slo_burn:p999_fleet:epoch 2", "conservation:gap 4",
           "slo_burn:p999_fleet:epoch 3", "slo_p999:epoch 5"]
    docs = []
    for i, mod in enumerate((TT, JT)):
        fr = mod.FlightRecorder(4, str(tmp_path / str(i)), tag="mix")
        fr.record({"epoch": 0})
        paths = [fr.dump(r) for r in seq]
        assert [p is not None for p in paths] == [
            True, True, False, True, False, False, False]
        kinds = [d["reason"].split(":", 1)[0] for d in _dump_docs(fr.dumps)]
        assert kinds == ["slo_p999", "conservation", "slo_burn"]
        assert len(set(fr.dumps)) == 3
        docs.append(_dump_docs(fr.dumps))
    assert docs[0] == docs[1]


def test_flight_ring_wrap_at_exactly_window(tmp_path):
    w = 5
    fr = TT.FlightRecorder(w, str(tmp_path), tag="wrap")
    for i in range(w):
        fr.record({"epoch": i})
    assert [e["epoch"] for e in fr.ring] == list(range(w))
    assert json.load(open(fr.dump("at_window:full")))["epochs_recorded"] == w
    fr.record({"epoch": w})
    assert [e["epoch"] for e in fr.ring] == list(range(1, w + 1))
    p_wrap = fr.dump("post_wrap:one past")
    assert json.load(open(p_wrap))["epochs"][0]["epoch"] == 1


def test_slo_breach_dumps_flight_ring(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("slo_breach"))
    jdrv, tdrv, rows = _parity("slo", out)
    assert rows[0].p999 > 1e-3
    assert tdrv.telemetry.breaches
    assert len(tdrv.telemetry.flight.dumps) == 1
    data = json.load(open(tdrv.telemetry.flight.dumps[0]))
    assert data["reason"].startswith("slo_p999")
    assert 1 <= len(data["epochs"]) <= 4
    entry = data["epochs"][0]
    assert "metrics" in entry and "spans" in entry and "state" in entry
    # the per-epoch loops dump the same ring
    edrv, _ = _port("slo", False, out)
    strip = lambda d: {k: v for k, v in d.items() if k != "tag"}
    assert [strip(d) for d in _dump_docs(edrv.telemetry.flight.dumps)] == [
        strip(d) for d in _dump_docs(jdrv.telemetry.flight.dumps)]


# ---------------------------------------------------------------------------
# the pieces the port had to get right: chain packing, the hop sum, one
# batch of collect_spans
# ---------------------------------------------------------------------------


def test_pack_chain_negative_word_round_trip():
    chain = np.array([[0, 1, 2, 3], [5, 200, -1, -1], [9, 8, 7, 254],
                      [1, 2, 3, 4], [255, 3, -1, 7]], np.int32)
    clen = np.array([4, 2, 4, 3, 2], np.int32)
    want = np.asarray(JR.pack_chain(jnp.asarray(chain), jnp.asarray(clen)))
    got = TR.pack_chain(torch.tensor(chain.astype(np.int64)),
                        torch.tensor(clen.astype(np.int64)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    # a fourth lane of 0x80 or more (empty, or a member >= 128) is the
    # sign byte of the int32 word
    assert got[0] > 0 and got[1] < 0 and got[2] < 0
    np.testing.assert_array_equal(TR.unpack_chain(got.numpy()),
                                  JR.unpack_chain(want))
    assert TR.unpack_chain(got.numpy())[0].tolist() == [0, 1, 2, 3]
    # r_max below the pack width fills the spare lanes
    got2 = TR.pack_chain(torch.tensor(chain[:, :2].astype(np.int64)),
                         torch.tensor(np.minimum(clen, 2).astype(np.int64)))
    want2 = JR.pack_chain(jnp.asarray(chain[:, :2]),
                          jnp.asarray(np.minimum(clen, 2)))
    assert np.array_equal(got2.numpy(), np.asarray(want2))


@pytest.mark.parametrize("H", [3, 6, 12])
def test_hop_sum_left_to_right_matches_jax(H):
    """``svc_total``: jax's compiled ``jnp.sum`` over the hop axis equals a
    left-to-right add; torch's ``sum`` does not at every width (at H 6 and
    12 its blocked order differs in many rows of this matrix)."""
    rng = np.random.default_rng(H)
    svc = (rng.random((100_000, H)) * rng.choice([1.0, 37.0, 1e3], (1, H))
           ).astype(np.float32)
    svc[rng.random(svc.shape) < 0.2] = 0.0
    want = np.asarray(jax.jit(lambda x: jnp.sum(x, axis=1))(jnp.asarray(svc)))
    got = TTR.hop_sum(torch.tensor(svc)).numpy()
    assert np.array_equal(got, want)


def _span_batch(seed=0, B=512, H=6, N=8, r_max=4):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    keys[:64] = 2**31 + rng.integers(0, 2**31, 64).astype(np.uint32)
    ops = rng.integers(0, 3, B).astype(np.int32)
    chain = rng.integers(-1, N, (B, r_max)).astype(np.int32)
    clen = rng.integers(1, r_max + 1, B).astype(np.int32)
    ridx = rng.integers(0, 64, B).astype(np.int32)
    target = rng.integers(-1, N, B).astype(np.int32)
    picked = rng.integers(0, N, B).astype(np.int32)
    bounced = rng.random(B) < 0.3
    outcome = rng.integers(-1, 3, B).astype(np.int32)
    qdepth = rng.integers(0, 50, B).astype(np.int32)
    orbit = rng.integers(-1, 3, B).astype(np.int32)
    scale = (1.0 + rng.random(B) * 2).astype(np.float32)
    first = rng.integers(-1, 6, B).astype(np.int32)
    service = (rng.random((B, H)) * 40).astype(np.float32)
    reply = rng.integers(1, 5, B).astype(np.float32)
    return dict(keys=keys, ops=ops, chain=chain, clen=clen, ridx=ridx,
                target=target, picked=picked, bounced=bounced,
                outcome=outcome, qdepth=qdepth, orbit=orbit, scale=scale,
                first=first, service=service, reply=reply)


@pytest.mark.parametrize("rate,k_slots", [(1.0, 512), (0.5, 64), (1 / 8, 16)])
def test_collect_spans_matches_reference(rate, k_slots):
    """One batch through both ``collect_spans``: keys >= 2**31 (their
    int32 bits), packed chains, a six-hop plan, the slot cap."""
    d = _span_batch()
    thr = TT.rate_threshold(rate)
    jq = JC.make_queries(jnp.asarray(d["keys"]), jnp.asarray(d["ops"]),
                         value_dim=1)
    jdec = JC.RoutingDecision(
        ridx=jnp.asarray(d["ridx"]), target=jnp.asarray(d["target"]),
        chain=jnp.asarray(d["chain"]), chain_len=jnp.asarray(d["clen"]),
        clength=jnp.zeros(len(d["ops"]), jnp.int32))
    jplan = JC.HopPlan(nodes=jnp.zeros(d["service"].shape, jnp.int32),
                       service=jnp.asarray(d["service"]),
                       reply_links=jnp.asarray(d["reply"]))
    want = JTR.collect_spans(
        jq, 5, jdec, jnp.asarray(d["picked"]), jnp.asarray(d["bounced"]),
        jnp.asarray(d["outcome"]), jnp.asarray(d["qdepth"]),
        jnp.asarray(d["orbit"]), jnp.asarray(d["scale"]), jplan,
        threshold=thr, k_slots=k_slots, lookup=0.25,
        first_epoch=jnp.asarray(d["first"]))
    t = lambda a: torch.tensor(np.asarray(a).astype(np.int64))
    tq = TR.make_queries(d["keys"], d["ops"], value_dim=1, device="cpu")
    tdec = TR.RoutingDecision(ridx=t(d["ridx"]), target=t(d["target"]),
                              chain=t(d["chain"]), chain_len=t(d["clen"]),
                              clength=t(np.zeros(len(d["ops"]))))
    tplan = TCo.HopPlan(nodes=torch.zeros(d["service"].shape,
                                          dtype=torch.int32),
                        service=torch.tensor(d["service"]),
                        reply_links=torch.tensor(d["reply"]))
    got = TT.collect_spans(
        tq, 5, tdec, t(d["picked"]), torch.tensor(d["bounced"]),
        torch.tensor(d["outcome"]), torch.tensor(d["qdepth"]),
        torch.tensor(d["orbit"]), torch.tensor(d["scale"]), tplan,
        threshold=thr, k_slots=k_slots, lookup=0.25,
        first_epoch=torch.tensor(d["first"]))
    for a, b in zip(want, got):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())
    live = got[0][:, TT.SI["qid"]] >= 0
    assert (got[0][live, TT.SI["key"]] < 0).any()     # keys >= 2**31 wrapped
    assert (got[0][live, TT.SI["chain"]] < 0).any()   # four-member chains
