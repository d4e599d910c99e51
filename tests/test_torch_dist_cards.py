"""The sharded data plane split over parts, on the CPU.

A mesh over k cards holds ``n_shards / k`` storage nodes on each card,
driven from one process.  Here the parts are ``("cpu",) * k``: the same
split layout, the same part-by-part code (the routes, the exchange of
buckets between parts, the read and write rounds, the migrations), on
one device.  Everything is held bit for bit to the one-part (stacked)
layout, which ``tests/test_torch_dist.py`` and
``tests/test_torch_dist_driver.py`` hold to the reference:

* :func:`dist_store.exchange` against ``_a2a``'s transpose of the stacked
  buckets;
* migrations (move, copy, reclaim, across parts and within one) and their
  traffic count, and ``apply_routed`` (the preload), against the stacked
  store's;
* the dist driver on 2 and 8 parts against 1 part: a node failure's
  migrations, CRAQ, and ``split_overflow``'s pool growth;
* the scale-out bench's rows with ``cards`` against those without;
* the refusals: shards that do not split over the cards, more cards than
  are present, a driver whose device is not the mesh's first, a store
  split otherwise than its mesh.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import cluster as TC
from repro_torch.cluster.metrics import migration_traffic
from repro_torch.core import dist_store as DS
from repro_torch.core import migration as MIG
from repro_torch.core import store as TS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads buy nothing here, and under
    the parallel test run they only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n, parts):
    if parts == 1:
        return DS.make_mesh(n, device="cpu")
    return DS.make_mesh(n, cards=("cpu",) * parts)


@pytest.mark.parametrize("parts", [1, 2, 4, 8])
def test_exchange_equals_the_stacked_transpose(parts):
    """Part b's inbound queues are rows ``b * P ..`` of ``_a2a`` of the
    stacked buckets (every source's chunk for the target, in source
    order), for an int payload and a (…, V) float one; exchanging the
    result again gives the buckets back (the replies' way home)."""
    n, cap, V = 8, 3, 2
    P = n // parts
    rng = np.random.default_rng(parts)
    devs = _mesh(n, parts).devices
    for x in (torch.arange(n * n * cap).reshape(n, n * cap),
              torch.as_tensor(rng.normal(size=(n, n * cap, V)).astype(
                  np.float32))):
        xs = [x[a * P:(a + 1) * P] for a in range(parts)]
        got = DS.exchange(xs, n, devs)
        assert len(got) == parts
        assert torch.equal(torch.cat(got), DS._a2a(x, n))
        assert torch.equal(torch.cat(DS.exchange(got, n, devs)), x)


def _store(rng, N=8, C=64, V=3, fill=40):
    keys = np.full((N, C), 0xFFFFFFFF, np.uint64)
    for n in range(N):
        keys[n, :fill] = np.sort(rng.choice(2**32 - 2, fill, replace=False))
    vals = rng.normal(size=(N, C, V)).astype(np.float32)
    vals[keys == 0xFFFFFFFF] = 0.0
    return TS.StoreState(torch.as_tensor(keys.astype(np.int64)),
                         torch.as_tensor(vals),
                         torch.zeros(N, dtype=torch.int64))


@pytest.mark.parametrize("parts", [2, 4])
def test_migrations_across_parts_equal_the_stacked_store(parts):
    """Moves and copies between parts and within one, and reclaims, with
    a destination that overflows: the split store equals the stacked one
    after every op (keys, values, overflow), and the traffic count is
    the same."""
    rng = np.random.default_rng(11)
    stacked = _store(rng)
    split = TS.split_store(stacked, _mesh(8, parts).devices)
    assert isinstance(split, TS.StoreParts) and len(split.parts) == parts
    ops = [MIG.MigrationOp(0, 2**32 - 2, 1, 7, "copy")]    # overflows 7
    for i in range(24):
        lo = int(rng.integers(0, 2**31))
        hi = lo + int(rng.integers(2**28, 2**31))
        src, dst = (int(x) for x in rng.choice(8, 2, replace=False))
        kind = ("move", "copy", "reclaim")[i % 3]
        ops.append(MIG.MigrationOp(lo, hi, src, dst, kind))
    for op in ops:
        assert (migration_traffic(stacked, [op], 3)
                == migration_traffic(split, [op], 3))
        MIG.execute(stacked, [op])
        MIG.execute(split, [op])
        got = split.stacked()
        for f in ("keys", "values", "overflow"):
            assert torch.equal(getattr(got, f), getattr(stacked, f)), (op, f)
    assert int(stacked.overflow[7]) > 0
    assert torch.equal(TS.store_fill(split), TS.store_fill(stacked))


@pytest.mark.parametrize("scans", [True, False])
@pytest.mark.parametrize("parts", [2, 4])
def test_apply_routed_on_parts_equals_the_stacked_store(parts, scans):
    """The driver's preload path (``store.apply_routed``) over a split
    store: a PUT batch, then a mix of every opcode with dead keys, each
    part serving the reads it owns; responses and store equal the stacked
    store's bit for bit (without SCANs the scan answers stay the empty
    views)."""
    from repro_torch.core import directory as D
    from repro_torch.core import routing as R

    rng = np.random.default_rng(parts)
    d = D.make_directory(32, 8, 3, r_max=4, device="cpu")
    stacked = TS.make_store(8, 128, 2, device="cpu")
    split = TS.make_store(8, 128, 2, parts=_mesh(8, parts).devices)
    keys = rng.integers(0, 2**32 - 2, 256, dtype=np.uint64).astype(np.uint32)
    for step in range(2):
        if step:
            keys = np.where(rng.random(256) < 0.6, keys, rng.integers(
                0, 2**32 - 2, 256, dtype=np.uint64)).astype(np.uint32)
            keys[:4] = 0xFFFFFFFF
        ops = (np.full(256, 1, np.int32) if step == 0 else
               rng.integers(0, 4 if scans else 3, 256).astype(np.int32))
        ends = np.minimum(keys.astype(np.uint64) + 2**26, 2**32 - 2)
        q = R.make_queries(keys, ops, rng.normal(size=(256, 2)).astype(
            np.float32), ends.astype(np.uint32), device="cpu")
        dec, d = R.route(d, q)
        _, want = TS.apply_routed(stacked, q, dec, scans=scans)
        _, got = TS.apply_routed(split, q, dec, scans=scans)
        for f in ("value", "found", "scan_values", "scan_keys", "scan_count"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
            if not scans and f.startswith("scan"):
                assert getattr(got, f).stride()[0] == 0, f
        st = split.stacked()
        for f in ("keys", "values", "overflow"):
            assert torch.equal(getattr(st, f), getattr(stacked, f)), f
    assert int(TS.store_fill(stacked).sum()) > 0


SCFG = dict(n_epochs=6, epoch_ops=256, n_records=512, value_dim=2, seed=3)
BASE = dict(num_nodes=8, num_ranges=32, replication=2, r_max=4,
            n_clients=16, report_every=2, imbalance_threshold=1.1,
            max_moves_per_round=6)
GROW = dict(scfg=dict(n_epochs=6, epoch_ops=512, n_records=2048,
                      read_ratio=0.3, value_dim=2, seed=1),
            base=dict(num_nodes=8, num_ranges=8, n_slots=8, replication=1,
                      r_max=2, capacity=64, split_overflow=True,
                      report_every=2))
# name -> (scenario, policy, scenario knobs, ClusterConfig knobs)
RUNS = {
    "node_failure": ("node_failure", "migrate",
                     dict(fail_epoch=3, fail_node=0, recover_epoch=5), {}),
    "craq": ("ycsb_a", "full_adaptive", {}, dict(replication_mode="craq")),
    "growth": ("keyspace_growth", "full_adaptive", {}, GROW),
}


@functools.lru_cache(maxsize=None)
def _run(name, parts, fused=True):
    scen, pol, skw, ckw = RUNS[name]
    ckw = dict(ckw)
    scfg = ckw.pop("scfg", SCFG)
    base = ckw.pop("base", BASE)
    drv = TC.EpochDriver(
        TC.make_scenario(scen, TC.ScenarioConfig(**scfg), **skw),
        TC.make_policy(pol), TC.ClusterConfig(**base, **ckw),
        backend="dist", mesh=_mesh(8, parts), fused=fused, device="cpu")
    return drv, [dataclasses.asdict(r) for r in drv.run()]


@pytest.mark.parametrize("parts", [2, 8])
@pytest.mark.parametrize("name", list(RUNS))
def test_dist_driver_split_equals_one_part(name, parts):
    """The metric stream, final store, chains, load registers and
    replication registers of the split mesh equal the one-part run's;
    the node failure moves entries between parts, and the growth run's
    pool grows mid-run (its directory rebuilt, and copied to every
    part)."""
    (da, ra), (db, rb) = _run(name, 1), _run(name, parts)
    assert ra == rb
    sa, sb = da.store, db.store.stacked()
    for f in ("keys", "values", "overflow"):
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    assert torch.equal(da.directory.chains, db.directory.chains)
    assert torch.equal(da.load_reg, db.load_reg)
    for f in ("version", "acked"):
        assert torch.equal(getattr(da.repl, f), getattr(db.repl, f)), f
    assert da.exchange_rounds == db.exchange_rounds > 0
    if name == "node_failure":
        assert sum(r["migration_entries"] for r in rb) > 0
    if name == "growth":
        assert db.growth_events >= 1
        assert any(e.startswith("grow_pool:") for r in rb for e in r["events"])


def test_dist_apply_split_store_must_match_the_mesh():
    """A stacked store on a split mesh, and a split store on a one-part
    mesh, are refused."""
    from repro_torch.core import directory as D
    from repro_torch.core import routing as R

    d = D.make_directory(16, 8, 2, device="cpu")
    q = R.make_queries(np.arange(64, dtype=np.uint32) * 7919,
                       np.zeros(64, np.int32), device="cpu")
    stacked = TS.make_store(8, 16, 1, device="cpu")
    split = TS.make_store(8, 16, 1, parts=("cpu",) * 4)
    for mesh, store in ((_mesh(8, 4), stacked), (_mesh(8, 1), split),
                        (_mesh(8, 2), split)):
        f = DS.make_dist_apply(mesh, d, DS.DistConfig(bucket_cap=8))
        with pytest.raises(ValueError, match="parts"):
            f(store, d, q)


def test_refusals():
    with pytest.raises(ValueError, match="do not split over 4 parts"):
        DS.make_mesh(6, cards=("cpu",) * 4)
    with pytest.raises(ValueError, match="do not split"):
        TS.make_store(6, 16, 1, parts=("cpu",) * 4)
    present = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"{present} CUDA cards present"):
        DS.make_mesh(8, cards=present + 1)
    with pytest.raises(ValueError, match="not the mesh's first"):
        DS.make_mesh(8, device="meta", cards=("cpu",) * 2)
    with pytest.raises(ValueError, match="first part's"):
        DS.ShardMesh(8, torch.device("cpu"), devices=(torch.device("meta"),))
    # a driver whose device is not the mesh's first
    scen, pol, skw, _ = RUNS["node_failure"]
    with pytest.raises(ValueError, match="first part on the driver's device"):
        TC.EpochDriver(
            TC.make_scenario(scen, TC.ScenarioConfig(**SCFG), **skw),
            TC.make_policy(pol), TC.ClusterConfig(**BASE), backend="dist",
            mesh=DS.make_mesh(8, cards=("meta",) * 4), device="cpu")


def test_dist_bench_rows_equal_with_cards():
    """The scale-out bench's ``--quick`` rows with the dist drivers' mesh
    in four parts equal the stacked run's, but the columns a run's clock
    decides."""
    from repro_torch.benchmarks import compare
    from repro_torch.benchmarks import dist_bench as TDB

    rows, problems = TDB.run(True, device="cpu")
    rows4, problems4 = TDB.run(True, device="cpu", cards=("cpu",) * 4)
    assert problems == problems4 == []
    assert compare.comparable(rows4) == compare.comparable(rows)
