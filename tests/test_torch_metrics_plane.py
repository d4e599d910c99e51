"""The fleet metrics plane (``repro_torch.telemetry.{metrics,slo,incident,
dashboard}``) against the JAX reference, bit for bit, on
``tests/test_metrics_plane.py``'s own cases, each run on both packages
with the same inputs:

* the plane only observes: ``metrics=None`` and the ring on give the same
  ``EpochMetrics`` stream, and the ring on the port equals the
  reference's in every cell (host-folded latency columns included), fused
  and per-epoch, with the overload plane, across ``split_overflow`` pool
  growth and past the ring's wrap;
* alerting: the burn-rate arrays, firing masks and alert timelines equal
  the reference's and the numpy oracle's, and a rising edge dumps the
  flight ring;
* the surfaces: SLO validation, incident reports, OpenMetrics text, the
  persisted view and the dashboard render the same bytes.

Pinned beside them: the top-k tie order (``lax.top_k`` takes the lowest
slot first among equal heats; ``torch.topk`` does not), ``record_epoch``
on random end-of-epoch state, and the burn rates as true float32
divisions where a multiply by the reciprocal would differ.

The reference drivers run the per-epoch loop (bit-identical to its fused
scan by the reference's own tests, and far quicker to compile)."""

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
from repro import overload as JO
from repro.replication import state as JRS
from repro.telemetry import dashboard as JDash
from repro.telemetry import incident as JInc
from repro.telemetry import metrics as JM
from repro.telemetry import slo as JS
from repro_torch import cluster as TCl
from repro_torch import overload as TO
from repro_torch import replication as TRP
from repro_torch.telemetry import dashboard as TDash
from repro_torch.telemetry import incident as TInc
from repro_torch.telemetry import metrics as TM
from repro_torch.telemetry import slo as TS

SCFG = dict(n_epochs=8, epoch_ops=256, n_records=512, value_dim=2, seed=3)
GROW_SCFG = dict(n_epochs=10, epoch_ops=512, n_records=2048, read_ratio=0.3,
                 value_dim=2)
OVL = dict(queue_cap=48, service_rate=80, inflation=3.0, queue_weight=2)


def _slo_kw(bound, **kw):
    kw.setdefault("objective", 0.9)
    kw.setdefault("fast_window", 2)
    kw.setdefault("slow_window", 4)
    return dict(name="p999_fleet", series="p999", bound=bound, **kw)


# name -> (MetricsConfig knobs with SLO knob tuples, policy, cluster knobs,
# overload knobs or None, telemetry knobs or None, growth run)
RUNS = {
    "ring": (dict(window=32, topk=4), "full_adaptive", {}, None, None, False),
    "overload": (dict(window=32, topk=4), "overload_adaptive", {}, OVL, None,
                 False),
    "wrap": (dict(window=4, topk=4), "full_adaptive", {}, None, None, False),
    "breach": (dict(window=32, slos=(_slo_kw(10.0),)), "full_adaptive", {},
               None, None, False),
    "quiet": (dict(window=32, slos=(_slo_kw(1e9),)), "full_adaptive", {},
              None, None, False),
    "breach_traced": (dict(window=32, slos=(_slo_kw(10.0),)), "full_adaptive",
                      {}, None, dict(sample_rate=1 / 4, flight_epochs=4),
                      False),
    "grow": (dict(window=16, topk=4), "full_adaptive", {}, None, None, True),
}


def _driver(mod, name, fused, on=True, flight_dir=None):
    mkw, pol, ckw, okw, tkw, grow = RUNS[name]
    slo_mod = TS if mod is TCl else JS
    mcfg = mod.MetricsConfig(**{**mkw, "slos": tuple(
        slo_mod.SLO(**s) for s in mkw.get("slos", ()))}) if on else None
    kw = dict(device="cpu") if mod is TCl else {}
    ovl_mod = TO if mod is TCl else JO
    extra = dict(ckw)
    if okw is not None:
        extra["overload"] = ovl_mod.OverloadConfig(**okw)
    if tkw is not None:
        # each run dumps into its own directory, so the dumps compare
        if flight_dir is not None:
            side = "port" if mod is TCl else "ref"
            flight_dir = f"{flight_dir}/{side}_{fused}"
        extra["telemetry"] = mod.TelemetryConfig(**tkw, flight_dir=flight_dir)
    if grow:
        scen = mod.make_scenario("keyspace_growth",
                                 mod.ScenarioConfig(**GROW_SCFG))
        cfg = mod.ClusterConfig(num_nodes=4, num_ranges=8, n_slots=8,
                                capacity=128, split_overflow=True,
                                report_every=2, metrics=mcfg, **extra)
    else:
        scen = mod.make_scenario("shifting_hotspot", mod.ScenarioConfig(**SCFG),
                                 theta=1.2, shift_every=2)
        cfg = mod.ClusterConfig(num_nodes=8, num_ranges=32, replication=2,
                                r_max=4, n_clients=16, report_every=2,
                                imbalance_threshold=1.1,
                                max_moves_per_round=6, metrics=mcfg, **extra)
    return mod.EpochDriver(scen, mod.make_policy(pol), cfg, fused=fused, **kw)


@functools.lru_cache(maxsize=None)
def _run(side, name, fused=True, on=True, flight_dir=None):
    drv = _driver(TCl if side == "port" else JCl, name, fused, on, flight_dir)
    return drv, drv.run()


def _rows(rows):
    return [dataclasses.asdict(r) for r in rows]


def _ring(drv) -> np.ndarray:
    r = drv.metrics.ring
    return r.numpy() if isinstance(r, torch.Tensor) else np.asarray(r)


def _parity(name, flight_dir=None, per_epoch=True):
    """Port fused (and with ``per_epoch`` the port's per-epoch loop) ==
    reference per-epoch: rows, every ring cell, pos, and the alert
    timeline."""
    jdrv, jrows = _run("ref", name, False, True, flight_dir)
    drvs = [_run("port", name, True, True, flight_dir)]
    if per_epoch:
        drvs.append(_run("port", name, False, True, flight_dir))
    for _, rows in drvs:
        assert _rows(jrows) == _rows(rows)
    tdrv, trows = drvs[0]
    for d, _ in drvs:
        ring = _ring(d)
        assert ring.dtype == np.float32
        assert np.array_equal(ring, _ring(jdrv))
        assert int(d.metrics.pos) == int(jdrv.metrics.pos)
        assert d.met_layout.names == jdrv.met_layout.names
        assert d.alert_timeline() == jdrv.alert_timeline()
    return jdrv, tdrv, trows


# ---------------------------------------------------------------------------
# tentpole: pure observer + every-ring-leaf parity
# ---------------------------------------------------------------------------

def test_metrics_none_bit_parity_and_single_trace():
    drv_off, rows_off = _run("port", "ring", True, False)
    _, drv_on, rows_on = _parity("ring")
    assert _rows(rows_off) == _rows(rows_on)
    assert all(r.compiled_steps == 1 for r in rows_on)
    assert drv_off.metrics is None and drv_off.met_layout is None
    assert int(drv_on.metrics.pos) == SCFG["n_epochs"]
    # planes off: the host syncs of the driver before the plane was ported
    assert drv_off.host_syncs == 16
    assert drv_on.host_syncs == drv_off.host_syncs   # no SLOs: no burn copy
    for f in ("keys", "values", "overflow"):
        assert torch.equal(getattr(drv_off.store, f), getattr(drv_on.store, f))
    for a, b in ((drv_off.load_reg, drv_on.load_reg),
                 (drv_off.sketch, drv_on.sketch),
                 (drv_off.repl.acked, drv_on.repl.acked),
                 (drv_off.directory.chains, drv_on.directory.chains)):
        assert torch.equal(a, b)
    assert sorted(drv_off.stage_seconds) == sorted(
        k for k in drv_on.stage_seconds if k != "metrics")


def test_fused_ring_bitident_to_per_epoch():
    _, drv_f, rows_f = _parity("ring")
    view = drv_f.metrics_view()
    col = view["names"].index("p999")
    np.testing.assert_array_equal(
        np.asarray(view["values"])[:, col],
        np.asarray([r.p999 for r in rows_f], np.float32))


def test_ring_parity_with_overload_plane():
    _, drv_f, _ = _parity("overload")
    base, _ = _run("port", "overload", True, False)
    for f in dataclasses.fields(base.ovl):
        assert torch.equal(getattr(base.ovl, f.name),
                           getattr(drv_f.ovl, f.name)), f.name
    view = drv_f.metrics_view()
    vals = np.asarray(view["values"])
    admit = [i for i, n in enumerate(view["names"])
             if n.startswith("admit_prob/")]
    assert vals[:, admit].max() > 0


def test_ring_survives_pool_growth_traces_counts_growth():
    jdrv, drv, rows = _parity("grow", per_epoch=False)
    grows = [e for r in rows for e in r.events if e.startswith("grow_pool:")]
    assert grows, "pool never grew under capacity pressure"
    assert rows[-1].compiled_steps == 1 + drv.growth_events == jdrv.traces
    assert drv.metrics.ring.shape == (16, drv.met_layout.n_series)
    assert int(drv.metrics.pos) == GROW_SCFG["n_epochs"]


def test_ring_wraps_past_window():
    jdrv, drv, rows = _parity("wrap", per_epoch=False)
    view = drv.metrics_view()
    assert view["epochs"] == [4, 5, 6, 7]
    jview = jdrv.metrics_view()
    assert view["epochs"] == jview["epochs"] and view["pos"] == jview["pos"]
    assert np.array_equal(view["values"], np.asarray(jview["values"]))
    col = view["names"].index("p50")
    np.testing.assert_array_equal(
        np.asarray(view["values"])[:, col],
        np.asarray([r.p50 for r in rows[-4:]], np.float32))


# ---------------------------------------------------------------------------
# SLO burn-rate alerts: exact vs the numpy oracle
# ---------------------------------------------------------------------------

def test_alert_firing_epochs_match_reference_exactly():
    _, drv, rows = _parity("breach")
    spec = drv.met_cfg.slos[0]
    vals = np.asarray([r.p999 for r in rows], np.float32)
    ref = TS.reference_alerts(vals, spec)
    jref = JS.reference_alerts(vals, JS.SLO(**_slo_kw(10.0)))
    for k in ("fast", "slow", "firing"):
        assert np.array_equal(ref[k], jref[k])
    fired = drv.met_engine.firing_epochs("p999_fleet")
    assert fired and fired == ref["fire_epochs"] == jref["fire_epochs"]
    ev = drv.met_engine.timeline[0]
    e = ev["epoch"]
    assert ev["state"] == "fire"
    assert ev["fast_burn"] == float(ref["fast"][e])
    assert ev["slow_burn"] == float(ref["slow"][e])
    assert drv.alert_timeline() == drv.met_engine.timeline


def test_alert_fire_and_resolve_match_reference_per_epoch_too():
    jdrv, drv_f, _ = _parity("breach")
    drv_r, _ = _run("port", "breach", False)
    assert drv_f.met_engine.timeline == drv_r.met_engine.timeline
    assert drv_r.met_engine.timeline == jdrv.met_engine.timeline


def test_no_alert_when_bound_above_tail():
    _, drv, _ = _parity("quiet", per_epoch=False)
    assert drv.met_engine.timeline == []
    assert drv.alert_timeline() == []


def test_burn_alert_triggers_flight_recorder(breached):
    jdrv, drv, _, out = breached
    out = str(out)
    assert any(b.startswith("slo_burn:p999_fleet")
               for b in drv.telemetry.breaches)
    assert drv.telemetry.breaches == jdrv.telemetry.breaches
    data = json.load(open(drv.telemetry.flight.dumps[0]))
    assert data["reason"].startswith("slo_burn:p999_fleet")
    # the dump already holds the firing segment's epochs: the per-epoch
    # loops dump the same ring as the reference's
    edrv, _ = _run("port", "breach_traced", False, True, out)
    strip = lambda p: {k: v for k, v in json.load(open(p)).items()
                       if k != "tag"}
    assert [strip(p) for p in edrv.telemetry.flight.dumps] == [
        strip(p) for p in jdrv.telemetry.flight.dumps]
    fire = drv.met_engine.timeline[0]["epoch"]
    assert data["epochs"][-1]["metrics"]["epoch"] >= fire


def test_driver_validates_slo_series_and_window():
    for mod, slo_mod in ((TCl, TS), (JCl, JS)):
        kw = dict(device="cpu") if mod is TCl else {}
        scen = mod.make_scenario("shifting_hotspot", mod.ScenarioConfig(**SCFG))
        for mcfg, match in (
                (mod.MetricsConfig(window=32, slos=(slo_mod.SLO(
                    name="x", series="nope", bound=1.0),)), "unknown series"),
                (mod.MetricsConfig(window=4, slos=(slo_mod.SLO(
                    **_slo_kw(10.0, slow_window=16)),)), "too")):
            with pytest.raises(ValueError, match=match):
                mod.EpochDriver(scen, mod.make_policy("frozen"),
                                mod.ClusterConfig(report_every=2,
                                                  metrics=mcfg), **kw)


def test_slo_spec_validation():
    for bad, match in ((dict(objective=1.0), "objective"),
                       (dict(cmp="ge"), "cmp"),
                       (dict(fast_window=8, slow_window=4), "fast_window")):
        for mod in (TS, JS):
            with pytest.raises(ValueError, match=match):
                mod.SLO(name="a", series="p999", bound=1.0, **bad)
    assert TS.SLO(name="a", series="p999", bound=1.0,
                  objective=0.98).budget == pytest.approx(0.02)


def test_reference_burn_clamps_to_available_history():
    spec = TS.SLO(**_slo_kw(5.0))
    vals = np.array([10.0, 10.0, 1.0, 1.0], np.float32)
    burn = TS.reference_burn(vals, spec, 4)
    assert np.array_equal(burn, JS.reference_burn(vals, JS.SLO(**_slo_kw(5.0)),
                                                  4))
    assert burn[0] == pytest.approx(1.0 / spec.budget)
    assert burn[3] == pytest.approx(0.5 / spec.budget)


def test_alert_engine_edge_semantics():
    timelines = []
    for mod in (TS, JS):
        fired = []
        eng = mod.AlertEngine((mod.SLO(**_slo_kw(1.0)),),
                              on_fire=lambda s, ev: fired.append(ev))
        mk = lambda firing: {"p999_fleet": {
            "firing": np.array(firing),
            "fast": np.zeros(len(firing), np.float32),
            "slow": np.zeros(len(firing), np.float32),
            "value": np.zeros(len(firing), np.float32)}}
        eng.observe(0, mk([False, True]))
        eng.observe(2, mk([True, False]))
        eng.observe(4, mk([True]))
        states = [(e["epoch"], e["state"]) for e in eng.timeline]
        assert states == [(1, "fire"), (3, "resolve"), (4, "fire")]
        assert eng.firing_epochs("p999_fleet") == [1, 4]
        assert len(fired) == 2
        s = eng.summary()
        assert s["fires"] == 2 and s["active"] == {"p999_fleet": True}
        timelines.append(eng.timeline)
    assert timelines[0] == timelines[1]


# ---------------------------------------------------------------------------
# incident reports + export surfaces
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def breached(tmp_path_factory):
    out = tmp_path_factory.mktemp("incident")
    jdrv, drv, rows = _parity("breach_traced", str(out))
    return jdrv, drv, rows, out


def _comparable(doc: dict) -> dict:
    """An incident document less what names a file or a wall time."""
    skip = ("paths", "flight_dumps", "stage_timers")
    return {k: v for k, v in doc.items() if k not in skip}


def test_incident_report_complete(breached):
    jdrv, drv, rows, out = breached
    doc = TInc.report(drv, out_dir=str(out), tag="t")
    assert doc["alerts"]["fires"] >= 1
    assert doc["epochs_recorded"] == SCFG["n_epochs"]
    assert doc["slos"][0]["name"] == "p999_fleet"
    assert any(b.startswith("slo_burn:") for b in doc["breaches"])
    assert doc["flight_dumps"]
    assert "share" in doc["p999_attribution"]
    assert "retry_orbits" in doc
    assert doc["stage_timers"]["stage_s"]
    assert doc["metrics"]["last"]["p999"] == pytest.approx(rows[-1].p999)
    jdoc = JInc.build(jdrv)
    assert json.loads(json.dumps(_comparable(doc), default=str)) == json.loads(
        json.dumps(_comparable(jdoc), default=str))
    assert json.load(open(doc["paths"][0]))["scenario"] == "shifting_hotspot"
    md = open(doc["paths"][1]).read()
    assert "# Incident report" in md and "| fire |" in md


def test_incident_requires_metrics_plane():
    drv, _ = _run("port", "ring", True, False)
    with pytest.raises(ValueError, match="metrics plane"):
        TInc.build(drv)


def test_openmetrics_and_view_roundtrip(breached):
    jdrv, drv, rows, out = breached
    view = drv.metrics_view()
    om = TM.to_openmetrics(view)
    assert om == JM.to_openmetrics(jdrv.metrics_view())
    assert om.endswith("# EOF\n")
    assert f"turbokv_epoch {SCFG['n_epochs'] - 1}" in om
    assert "turbokv_p999 " in om
    assert 'turbokv_node_load{idx="0"}' in om
    assert om.count("# TYPE turbokv_node_load gauge") == 1
    path = TM.write_view(str(out / "view.json"), view,
                         alerts=drv.alert_timeline())
    jpath = JM.write_view(str(out / "jview.json"), jdrv.metrics_view(),
                          alerts=jdrv.alert_timeline())
    assert open(path).read() == open(jpath).read()
    doc = json.load(open(path))
    assert doc["names"] == view["names"]
    assert doc["alerts"][0]["state"] == "fire"


def test_dashboard_renders_ring_and_alerts(breached):
    jdrv, drv, rows, out = breached
    path = TM.write_view(str(out / "dash.json"), drv.metrics_view(),
                         alerts=drv.alert_timeline())
    view = json.load(open(path))
    text = TDash.render(view)
    assert text == JDash.render(view)
    assert "fleet metrics" in text
    assert "node_load" in text and "p999" in text and "fire" in text
    outfile = str(out / "dash.txt")
    assert TDash.main(["--view", path, "--series", "p999",
                       "--out", outfile]) == 0
    body = open(outfile).read()
    assert "p999" in body and "node_load" not in body


def test_sparkline_downsamples_and_bounds():
    for mod in (TDash, JDash):
        assert mod.sparkline([]) == ""
        assert mod.sparkline([1.0, 1.0, 1.0]) == "▁▁▁"
        s = mod.sparkline(np.arange(1000.0), width=10)
        assert len(s) == 10 and s[0] == "▁" and s[-1] == "█"
        flat = np.zeros(500)
        flat[250] = 100.0
        assert "█" in mod.sparkline(flat, width=10)


def test_fold_host_batched_equals_per_epoch():
    layout = TM.build_layout(4, n_switches=0, topk=2)
    vals = np.arange(12, dtype=np.float32).reshape(3, 4) * 1.5
    s_batch = TM.fold_host(TM.make_state(8, layout.n_series, device="cpu"),
                           0, vals, layout.host_cols)
    s_loop = TM.make_state(8, layout.n_series, device="cpu")
    for i in range(3):
        s_loop = TM.fold_host(s_loop, i, vals[i:i + 1], layout.host_cols)
    np.testing.assert_array_equal(s_batch.ring.numpy(), s_loop.ring.numpy())
    jlay = JM.build_layout(4, n_switches=0, topk=2)
    js = JM.fold_host(JM.make_state(8, jlay.n_series), 0, vals, jlay.host_cols)
    np.testing.assert_array_equal(s_batch.ring.numpy(), np.asarray(js.ring))


def test_layout_blocks_and_switch_lag_presence():
    lay = TM.build_layout(4, n_switches=0, topk=2)
    assert not any(n.startswith("switch_lag") for n in lay.names)
    lay2 = TM.build_layout(4, n_switches=3, topk=2)
    assert [n for n in lay2.names if n.startswith("switch_lag")] == [
        "switch_lag/0", "switch_lag/1", "switch_lag/2"]
    assert lay2.n_series == lay.n_series + 3
    assert lay.host_cols == tuple(range(lay.n_series - 4, lay.n_series))
    assert lay2.names == JM.build_layout(4, n_switches=3, topk=2).names


# ---------------------------------------------------------------------------
# what the port had to get right: tie order, record_epoch, true divisions
# ---------------------------------------------------------------------------

def test_topk_tie_order_matches_lax_top_k():
    """F13: among equal heats ``lax.top_k`` returns the lowest slot first;
    ``torch.topk`` does not (on this vector it starts at slot 40)."""
    heat = np.zeros(64, np.float32)
    heat[[3, 40]] = 2.0
    rng = np.random.default_rng(0)
    cases = [heat, np.zeros(64, np.float32),
             rng.integers(0, 3, 257).astype(np.float32),
             rng.integers(0, 5, 2048).astype(np.float32)]
    for h in cases:
        for k in (1, 4, 9):
            jv, ji = jax.lax.top_k(jnp.asarray(h), k)
            tv, ti = TM.hot_slots(torch.tensor(h), k)
            assert np.array_equal(np.asarray(ji), ti.numpy()), (h[:8], k)
            assert np.array_equal(np.asarray(jv), tv.numpy())
    assert np.asarray(jax.lax.top_k(jnp.asarray(heat), 4)[1]).tolist() == [
        3, 40, 0, 1]


def _state_pair(seed, N=6, S=40, r_max=4, W=3, B=300):
    """Random end-of-epoch state in both packages' layouts."""
    rng = np.random.default_rng(seed)
    version = rng.integers(0, 4, S).astype(np.uint32)
    acked = np.minimum(version[:, None], rng.integers(0, 4, (S, r_max))
                       ).astype(np.uint32)
    sketch = rng.integers(0, 9, (4, 64)).astype(np.uint32)
    keys = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    ridx = rng.integers(0, S, B).astype(np.int32)
    node_ops = rng.integers(0, 90, N).astype(np.int32)
    ostats = rng.integers(0, 300, 7).astype(np.int32)
    cstats = rng.integers(0, 300, 5).astype(np.int32)
    cver = rng.integers(0, 3, (W, S)).astype(np.uint32)
    committed = rng.integers(0, 3, S).astype(np.uint32)
    ovl = dict(queue=rng.integers(0, 20, N).astype(np.int32),
               retry=rng.integers(0, 4, (N, 3)).astype(np.int32),
               admit_prob=rng.random(N).astype(np.float32))
    return dict(version=version, acked=acked, sketch=sketch, keys=keys,
                ridx=ridx, node_ops=node_ops, ostats=ostats, cstats=cstats,
                cver=cver, committed=committed, ovl=ovl)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_record_epoch_matches_reference(seed):
    d = _state_pair(seed)
    t64 = lambda a: torch.tensor(np.asarray(a).astype(np.int64))
    S = d["version"].shape[0]
    W = d["cver"].shape[0]
    for with_planes in (False, True):
        lay = TM.build_layout(6, n_switches=W if with_planes else 0, topk=4)
        jcoord = tcoord = jovl = tovl = None
        if with_planes:
            jcoord = dataclasses.make_dataclass("C", ["version", "committed"])(
                jnp.asarray(d["cver"]), jnp.asarray(d["committed"]))
            tcoord = dataclasses.make_dataclass("C", ["version", "committed"])(
                t64(d["cver"]), t64(d["committed"]))
            jovl = dataclasses.make_dataclass("O", list(d["ovl"]))(
                *[jnp.asarray(v) for v in d["ovl"].values()])
            tovl = dataclasses.make_dataclass("O", list(d["ovl"]))(
                *[torch.tensor(v) for v in d["ovl"].values()])
        jrepl = JRS.ReplState(version=jnp.asarray(d["version"]),
                              acked=jnp.asarray(d["acked"]),
                              key_filter=jnp.zeros((S, 1), jnp.bool_))
        trepl = TRP.ReplState(version=t64(d["version"]), acked=t64(d["acked"]),
                              key_filter=torch.zeros((S, 1), dtype=torch.bool))
        js = JM.make_state(5, lay.n_series)
        ts = TM.make_state(5, lay.n_series, device="cpu")
        for step in range(7):                  # past the wrap
            js = JM.record_epoch(
                js, node_ops=jnp.asarray(d["node_ops"]), ovl=jovl,
                ostats=jnp.asarray(d["ostats"]),
                cstats=jnp.asarray(d["cstats"]), coord=jcoord, repl=jrepl,
                sketch=jnp.asarray(d["sketch"]), keys=jnp.asarray(d["keys"]),
                ridx=jnp.asarray(d["ridx"]), topk=4)
            ts = TM.record_epoch(
                ts, node_ops=t64(d["node_ops"]), ovl=tovl,
                ostats=torch.tensor(d["ostats"]),
                cstats=t64(d["cstats"]), coord=tcoord, repl=trepl,
                sketch=t64(d["sketch"]), keys=t64(d["keys"]),
                ridx=t64(d["ridx"]), topk=4)
            d["node_ops"] = d["node_ops"] + step
        assert np.array_equal(np.asarray(js.ring), ts.ring.numpy())
        assert int(js.pos) == int(ts.pos) == 7


def test_burn_rates_are_true_divisions():
    """``evaluate_segment`` on a ring whose bad fractions make a multiply by
    the reciprocal of the budget round differently from the division the
    reference does: the port's burn arrays and firing masks equal the
    reference's and the numpy oracle's in every cell."""
    rng = np.random.default_rng(5)
    lay = TM.build_layout(2, n_switches=0, topk=1)
    col = lay.index["p999"]
    n = 48
    series = rng.choice([1.0, 20.0], n).astype(np.float32)
    diffs = 0
    for objective in (0.9, 0.993):
        for fw, sw in ((3, 7), (2, 4)):
            kw = dict(name="s", series="p999", bound=10.0,
                      objective=objective, fast_window=fw, slow_window=sw,
                      fast_burn=2.0, slow_burn=1.0)
            tspec, jspec = TS.SLO(**kw), JS.SLO(**kw)
            ring = np.zeros((64, lay.n_series), np.float32)
            ring[:n, col] = series
            ts = TM.MetricsState(ring=torch.tensor(ring),
                                 pos=torch.tensor(n, dtype=torch.int32))
            js = JM.MetricsState(ring=jnp.asarray(ring), pos=jnp.int32(n))
            for L in (1, 8):
                got = TS.evaluate_segment(ts, lay, (tspec,), L)["s"]
                want = JS.evaluate_segment(js, lay, (jspec,), L)["s"]
                for k in ("fast", "slow", "firing", "value"):
                    assert got[k].dtype == want[k].dtype
                    assert np.array_equal(got[k], want[k]), (objective, k)
            oracle = TS.reference_burn(series, tspec, sw)
            full = TS.evaluate_segment(ts, lay, (tspec,), n)["s"]
            assert np.array_equal(full["slow"], oracle)
            bad = series > np.float32(10.0)
            frac = np.array([np.float32(bad[max(0, j - sw + 1):j + 1].sum())
                             / np.float32(min(j + 1, sw)) for j in range(n)],
                            np.float32)
            budget = np.float32(tspec.budget)
            recip = (frac * (np.float32(1) / budget)).astype(np.float32)
            assert np.array_equal(frac / budget, full["slow"])
            diffs += int((recip != full["slow"]).sum())
    assert diffs > 0, "no cell where the reciprocal would round differently"
