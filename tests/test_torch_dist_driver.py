"""The port's ``EpochDriver(..., backend="dist")`` against the reference's
dist driver, bit for bit, on the five ``FUSED_PAIR`` cases of
``tests/test_dist.py``: p2c spreading with the overload plane and span
sampling, a mid-period node failure and recovery, CRAQ on YCSB-A, the
4-switch lag-1 coordination tier through a split-brain fault, and the
fleet metrics ring with an SLO.

The reference's dist backend needs its 8-device mesh, so one subprocess
(8 forced host devices, the ``enable_x64`` shim set in its own code) runs
its fused dist driver on each case and writes the metric stream, the final
store, chains, load registers, replication / overload / coordination /
ring state, span records and alert timeline as ``.npz``; the port runs
the same cases on an 8-shard mesh on the CPU, fused and per-epoch, and
must equal it (no tolerance).  Also: the port's fused loop equals its
per-epoch loop with fewer host syncs, dist ``frozen`` equals the oracle
backend's, the metrics plane stays a pure observer on this backend, and
``craq_filter_bits`` and a mesh that does not fit are refused."""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import cluster as TC
from repro_torch import convert
from repro_torch import coordination_tier as CT
from repro_torch import overload as OVL
from repro_torch.core.dist_store import DistConfig, make_mesh

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

REFERENCE = r'''
import json, os, sys, time
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
import dataclasses
import numpy as np
from repro.cluster import (ClusterConfig, EpochDriver, ScenarioConfig,
                           make_policy, make_scenario)
from repro.coordination_tier import CoordConfig
from repro.overload import OverloadConfig
from repro.telemetry import TelemetryConfig
from repro.telemetry.metrics import MetricsConfig
from repro.telemetry.slo import SLO

out_dir = sys.argv[1]
at = getattr(jax.sharding, "AxisType", None)
mesh = jax.make_mesh((8,), ("data",), axis_types=(at.Auto,))
scfg = ScenarioConfig(n_epochs=6, epoch_ops=256, n_records=512, value_dim=2, seed=3)
base = dict(num_nodes=8, num_ranges=32, replication=2, r_max=4,
            n_clients=16, report_every=2, imbalance_threshold=1.1,
            max_moves_per_round=6)
ovl = dict(queue_cap=48, service_rate=80, inflation=3.0, queue_weight=2)
HOT = dict(theta=1.2, shift_every=2)
CASES = {
    "overload_telemetry": ("shifting_hotspot", "overload_adaptive", dict(
        overload=OverloadConfig(**ovl), telemetry=TelemetryConfig(sample_rate=1 / 4)), HOT),
    "node_failure": ("node_failure", "migrate", {},
                     dict(fail_epoch=3, fail_node=0, recover_epoch=5)),
    "craq_ycsb_a": ("ycsb_a", "full_adaptive", dict(replication_mode="craq"), {}),
    "coordination_tier": ("split_brain", "full_adaptive",
                          dict(coordination=CoordConfig(n_switches=4, lag_per_hop=1)),
                          dict(theta=1.2, shift_every=2, split_epoch=2, heal_epoch=5, switch=1)),
    "metrics_plane": ("shifting_hotspot", "overload_adaptive", dict(
        overload=OverloadConfig(**ovl),
        metrics=MetricsConfig(window=32, topk=4, slos=(SLO(
            name="p999_fleet", series="p999", bound=50.0, objective=0.9,
            fast_window=2, slow_window=4),))), HOT),
}
for name, (scen, pol, ckw, skw) in CASES.items():
    t0 = time.time()
    drv = EpochDriver(make_scenario(scen, scfg, **skw), make_policy(pol),
                      ClusterConfig(**base, **ckw), backend="dist", mesh=mesh,
                      fused=True)
    rows = [dataclasses.asdict(r) for r in drv.run()]
    arrs = {"rows": np.array(json.dumps(rows))}
    for f in ("keys", "values", "overflow"):
        arrs["store_" + f] = np.asarray(getattr(drv.store, f))
    arrs["chains"] = np.asarray(drv.directory.chains)
    arrs["load_reg"] = np.asarray(drv.load_reg)
    for f in ("version", "acked", "key_filter"):
        arrs["repl_" + f] = np.asarray(getattr(drv.repl, f))
    for part, st in (("ovl", drv.ovl), ("coord", drv.coord), ("met", drv.metrics)):
        if st is not None:
            for f in dataclasses.fields(st):
                arrs[f"{part}_{f.name}"] = np.asarray(getattr(st, f.name))
    if drv.telemetry is not None:
        for i, ep in enumerate(drv.telemetry.epochs):
            for leaf in ("span_i", "span_f", "lat", "comps", "issue"):
                arrs[f"tel_{i}_{leaf}"] = np.asarray(ep[leaf])
    if drv.metrics is not None:
        arrs["alerts"] = np.array(json.dumps(drv.alert_timeline()))
    np.savez(os.path.join(out_dir, name + ".npz"), **arrs)
    print(name, round(time.time() - t0, 1), flush=True)
'''

SCFG = dict(n_epochs=6, epoch_ops=256, n_records=512, value_dim=2, seed=3)
BASE = dict(num_nodes=8, num_ranges=32, replication=2, r_max=4,
            n_clients=16, report_every=2, imbalance_threshold=1.1,
            max_moves_per_round=6)
OCFG = dict(queue_cap=48, service_rate=80, inflation=3.0, queue_weight=2)
HOT = dict(theta=1.2, shift_every=2)
SLO = dict(name="p999_fleet", series="p999", bound=50.0, objective=0.9,
           fast_window=2, slow_window=4)
# name -> (scenario, policy, ClusterConfig knobs, scenario knobs)
CASES = {
    "overload_telemetry": (
        "shifting_hotspot", "overload_adaptive",
        lambda: dict(overload=OVL.OverloadConfig(**OCFG),
                     telemetry=TC.TelemetryConfig(sample_rate=1 / 4)), HOT),
    "node_failure": ("node_failure", "migrate", dict,
                     dict(fail_epoch=3, fail_node=0, recover_epoch=5)),
    "craq_ycsb_a": ("ycsb_a", "full_adaptive",
                    lambda: dict(replication_mode="craq"), {}),
    "coordination_tier": (
        "split_brain", "full_adaptive",
        lambda: dict(coordination=CT.CoordConfig(n_switches=4, lag_per_hop=1)),
        dict(theta=1.2, shift_every=2, split_epoch=2, heal_epoch=5,
             switch=1)),
    "metrics_plane": (
        "shifting_hotspot", "overload_adaptive",
        lambda: dict(overload=OVL.OverloadConfig(**OCFG),
                     metrics=TC.MetricsConfig(window=32, topk=4,
                                              slos=(TC.SLO(**SLO),))), HOT),
}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_driver_ref")
    script = out / "reference.py"
    script.write_text(REFERENCE)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    res = subprocess.run([sys.executable, str(script), str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return out


def _driver(name, fused, backend="dist", **over):
    scen, pol, ckw, skw = CASES[name]
    cfg = TC.ClusterConfig(**BASE, **{**ckw(), **over})
    return TC.EpochDriver(
        TC.make_scenario(scen, TC.ScenarioConfig(**SCFG), **skw),
        TC.make_policy(pol), cfg, backend=backend,
        mesh=make_mesh(8, device="cpu") if backend == "dist" else None,
        fused=fused, device="cpu")


@functools.lru_cache(maxsize=None)
def _port(name, fused):
    drv = _driver(name, fused)
    return drv, [dataclasses.asdict(r) for r in drv.run()]


def _same(got, want) -> bool:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == np.float32:
        return np.array_equal(got.astype(np.float32).view(np.uint32),
                              want.view(np.uint32))
    return got.shape == want.shape and np.array_equal(
        got.astype(np.int64), want.astype(np.int64))


def _rows_diff(a, b):
    assert len(a) == len(b)
    return [(x["epoch"], k, x[k], y[k]) for x, y in zip(a, b)
            for k in x if x[k] != y[k]]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", list(CASES))
def test_dist_driver_matches_reference(reference, name, fused):
    z = np.load(reference / f"{name}.npz")
    drv, rows = _port(name, fused)
    assert _rows_diff(rows, json.loads(str(z["rows"]))) == []
    for f in ("keys", "values", "overflow"):
        assert _same(getattr(drv.store, f), z["store_" + f]), f
    assert _same(drv.directory.chains, z["chains"])
    assert _same(drv.load_reg, z["load_reg"])
    for f, v in convert.repl_to_numpy(drv.repl).items():
        assert _same(v, z["repl_" + f]), f
    for part, st in (("ovl", drv.ovl), ("coord", drv.coord),
                     ("met", drv.metrics)):
        names = [k for k in z.files if k.startswith(part + "_")]
        assert (st is None) == (not names), part
        for k in names:
            assert _same(getattr(st, k[len(part) + 1:]), z[k]), k
    if drv.telemetry is not None:
        eps = drv.telemetry.epochs
        assert len(eps) == len({k.split("_")[1] for k in z.files
                                if k.startswith("tel_")})
        for i, ep in enumerate(eps):
            for leaf in ("span_i", "span_f", "lat", "comps", "issue"):
                assert _same(ep[leaf], z[f"tel_{i}_{leaf}"]), (i, leaf)
    if drv.metrics is not None:
        assert drv.alert_timeline() == json.loads(str(z["alerts"]))
    if name == "coordination_tier":
        rows_ = _port(name, fused)[1]
        assert all(r["routed"] == r["direct"] + r["redirected"] for r in rows_)
        assert sum(r["mis_served"] for r in rows_) == 0
        assert sum(r["redirected"] for r in rows_) > 0


@pytest.mark.parametrize("name", list(CASES))
def test_fused_dist_equals_per_epoch_with_fewer_host_syncs(name):
    """The fused loop (one ``make_dist_period`` call and one copy home a
    segment) against the per-epoch loop (``make_dist_apply`` an epoch):
    the metric stream, store, registers, tier and ring; one compiled step
    (``compiled_steps``, the reference's ``traces``) and fewer host
    round trips."""
    (fd, frows), (ed, erows) = _port(name, True), _port(name, False)
    assert _rows_diff(frows, erows) == []
    for f in ("keys", "values", "overflow"):
        assert torch.equal(getattr(fd.store, f), getattr(ed.store, f)), f
    assert torch.equal(fd.load_reg, ed.load_reg)
    for st_f, st_e in ((fd.repl, ed.repl), (fd.ovl, ed.ovl),
                       (fd.coord, ed.coord), (fd.metrics, ed.metrics)):
        if st_f is not None:
            for f in dataclasses.fields(st_f):
                assert torch.equal(getattr(st_f, f.name), getattr(st_e, f.name))
    assert all(r["compiled_steps"] == 1 for r in frows)
    assert fd.host_syncs < ed.host_syncs
    assert fd.bucket_overflow_total == ed.bucket_overflow_total == 0
    assert all(r["retries"] == 0 for r in frows)


@pytest.mark.parametrize("scen,mode,strategy", [
    ("shifting_hotspot", "eventual", "bucket_a2a"),
    ("ycsb_a", "chain", "bucket_a2a"),
    ("shifting_hotspot", "eventual", "allgather")])
def test_dist_frozen_equals_oracle_frozen(scen, mode, strategy):
    """Under ``frozen`` (tail reads, no draws) the sharded plane gives the
    oracle backend's metric stream and final store bit for bit, with
    either strategy (``allgather`` runs in the per-epoch loop only)."""
    runs = {}
    for backend in ("oracle", "dist"):
        drv = TC.EpochDriver(
            TC.make_scenario(scen, TC.ScenarioConfig(**SCFG),
                             **(HOT if scen == "shifting_hotspot" else {})),
            TC.make_policy("frozen"),
            TC.ClusterConfig(**BASE, replication_mode=mode), backend=backend,
            mesh=make_mesh(8, device="cpu") if backend == "dist" else None,
            dist_cfg=DistConfig(strategy=strategy),
            fused=backend == "oracle" or strategy == "bucket_a2a",
            device="cpu")
        runs[backend] = (drv, [dataclasses.asdict(r) for r in drv.run()])
    (od, orows), (dd, drows) = runs["oracle"], runs["dist"]
    assert _rows_diff(orows, drows) == []
    for f in ("keys", "values", "overflow"):
        assert torch.equal(getattr(od.store, f), getattr(dd.store, f)), f
    assert torch.equal(od.load_reg, dd.load_reg)
    for f in ("version", "acked"):
        assert torch.equal(getattr(od.repl, f), getattr(dd.repl, f)), f


def test_metrics_plane_is_a_pure_observer_on_dist():
    """The metrics=None run's stream equals the ring-carrying run's."""
    on = _port("metrics_plane", True)[1]
    off = _driver("metrics_plane", True, metrics=None)
    assert _rows_diff([dataclasses.asdict(r) for r in off.run()], on) == []


def test_dist_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="craq_filter_bits"):
        _driver("craq_ycsb_a", True, craq_filter_bits=8)
    scen, pol, ckw, skw = CASES["node_failure"]
    make = lambda **kw: TC.EpochDriver(
        TC.make_scenario(scen, TC.ScenarioConfig(**SCFG), **skw),
        TC.make_policy(pol), TC.ClusterConfig(**BASE), backend="dist",
        device="cpu", **kw)
    with pytest.raises(ValueError, match="needs a mesh"):
        make()
    with pytest.raises(ValueError, match="one storage node a shard"):
        make(mesh=make_mesh(4, device="cpu"))
    with pytest.raises(ValueError, match="allgather"):
        make(mesh=make_mesh(8, device="cpu"),
             dist_cfg=DistConfig(strategy="allgather"))
