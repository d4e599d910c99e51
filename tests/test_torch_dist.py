"""The sharded data plane (``repro_torch.core.dist_store``) against the
reference's ``repro.core.dist_store``, bit for bit (``np.array_equal``, no
tolerance).

The bucket helpers (``bucketize``, ``scatter_to_buckets``,
``gather_from_buckets``) and the store's shard half (``pad_slab``,
``_slab_scan_padded``, ``shard_apply``) run in-process against the
reference's plain functions.  ``make_dist_apply`` needs the reference's
8-device mesh, so one subprocess (8 forced host devices, the
``enable_x64`` shim set in its own code) runs it on the inputs of
``tests/test_dist.py``'s three store cases — PUT then GET with a mixed
batch after, every query at one key through 2-slot buckets, p2c read
spreading — and on craq with and without the queue penalty, for both
strategies, and writes every call's inputs and outputs (responses, store,
directory counters, load registers, decision metrics) as ``.npz``; the
port replays the same calls on an 8-shard mesh on the CPU, in 1, 2, 4 and
8 parts (``("cpu",) * k``: the split layout of a mesh over k cards)."""

import os
import subprocess
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
from repro.core import dist_store as JDS
from repro.core import store as JS
from repro_torch import convert
from repro_torch.core import dist_store as DS
from repro_torch.core import routing as TR
from repro_torch.core import store as TS

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

# the reference side: tests/test_dist.py's store cases (and craq) through
# the reference's make_dist_apply on 8 forced host devices
REFERENCE = r'''
import os, sys
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
import jax.numpy as jnp
import numpy as np
from repro import core as C

out_dir = sys.argv[1]
at = getattr(jax.sharding, "AxisType", None)
mesh = jax.make_mesh((8,), ("data",), axis_types=(at.Auto,))
DFIELDS = ("slot_lo", "slot_hi", "live", "chains", "chain_len", "parent",
           "generation", "node_addr", "read_count", "write_count")


def batch(rng, B, V, ops, dead=0):
    keys = rng.integers(0, 2**32 - 1, B, dtype=np.uint64).astype(np.uint32)
    ends = np.minimum(keys.astype(np.uint64) + rng.integers(0, 2**28, B), 2**32 - 2).astype(np.uint32)
    vals = rng.normal(size=(B, V)).astype(np.float32)
    op = np.asarray(ops, np.int32) if not np.isscalar(ops) else np.full(B, ops, np.int32)
    keys[:dead] = 0xFFFFFFFF
    return op, keys, ends, vals


def run(name, d, store, cfg, calls):
    """calls: list of (op, keys, ends, vals, extras) run in sequence."""
    f = C.make_dist_apply(mesh, d, cfg)
    arrs = {f"dir_{k}": np.asarray(getattr(d, k)) for k in DFIELDS}
    arrs.update(store_keys=np.asarray(store.keys), store_values=np.asarray(store.values),
                store_overflow=np.asarray(store.overflow))
    load = jnp.zeros((8,), jnp.uint32)
    for i, (op, keys, ends, vals, ex) in enumerate(calls):
        q = C.make_queries(jnp.asarray(keys), jnp.asarray(op), jnp.asarray(vals), jnp.asarray(ends))
        for k, v in (("op", op), ("keys", keys), ("ends", ends), ("vals", vals)):
            arrs[f"in{i}_{k}"] = v
        for k, v in ex.items():
            arrs[f"in{i}_{k}"] = np.asarray(v)
        craq = cfg.replication_mode == "craq"
        args = [store, d]
        if cfg.read_spread:
            args.append(load)
            if cfg.queue_pen:
                args.append(jnp.asarray(ex["qpen"], jnp.uint32))
            if craq:
                args.append(jnp.asarray(ex["dirty"]))
            args += [q, jax.random.PRNGKey(int(ex["seed"]))]
            store, resp, d, load, m = f(*args)
        else:
            store, resp, d, m = f(store, d, q)
        for k in ("value", "found", "scan_values", "scan_keys", "scan_count"):
            arrs[f"out{i}_resp_{k}"] = np.asarray(getattr(resp, k))
        for k in ("keys", "values", "overflow"):
            arrs[f"out{i}_store_{k}"] = np.asarray(getattr(store, k))
        for k in ("read_count", "write_count"):
            arrs[f"out{i}_dir_{k}"] = np.asarray(getattr(d, k))
        arrs[f"out{i}_load"] = np.asarray(load)
        for k, v in m.items():
            arrs[f"out{i}_m_{k}"] = np.asarray(v)
    np.savez(os.path.join(out_dir, name + ".npz"), **arrs)


for strat in ("allgather", "bucket_a2a"):
    # test_dist_store_matches_oracle: PUT then GET, then a mix of every
    # opcode (with dead keys and scans)
    rng = np.random.default_rng(0)
    d = C.make_directory(16, 8, 3)
    store = C.make_store(8, 64, 4)
    put = batch(rng, 64, 4, C.OP_PUT)
    get = (np.full(64, C.OP_GET, np.int32), put[1], put[2], np.zeros((64, 4), np.float32))
    mix = batch(rng, 64, 4, rng.integers(0, 4, 64), dead=3)
    mix[1][10:30] = put[1][10:30]
    run(f"oracle_{strat}", d, store, C.DistConfig(strategy=strat, bucket_cap=32,
        return_decision=True), [(*put, {}), (*get, {}), (*mix, {})])
    # test_dist_store_bucket_overflow_counted: every query at one key, cap
    # 2; reads, then writes that overflow the buckets and a slab of 16
    d1 = C.make_directory(16, 8, 1)
    keys = np.full(64, 123, np.uint32)
    keys[40:] = rng.integers(0, 2**32 - 1, 24, dtype=np.uint64).astype(np.uint32)
    g = (np.full(64, C.OP_GET, np.int32), keys, np.zeros(64, np.uint32), np.zeros((64, 1), np.float32))
    pw = (np.full(64, C.OP_PUT, np.int32), keys, np.zeros(64, np.uint32), rng.normal(size=(64, 1)).astype(np.float32))
    run(f"overflow_{strat}", d1, C.make_store(8, 16, 1), C.DistConfig(
        strategy=strat, bucket_cap=2, return_decision=True), [(*g, {}), (*pw, {}), (*g, {})])
    # test_dist_store_read_spread_matches_tail_reads
    rng = np.random.default_rng(0)
    d5 = C.make_directory(16, 8, 3, r_max=5)
    put = batch(rng, 64, 4, C.OP_PUT)
    get = (np.full(64, C.OP_GET, np.int32), put[1], put[2], np.zeros((64, 4), np.float32))
    run(f"spread_{strat}", d5, C.make_store(8, 64, 4), C.DistConfig(
        strategy=strat, bucket_cap=32, read_spread=True, return_decision=True),
        [(*put, dict(seed=1)), (*get, dict(seed=2))])
    # craq, with and without the queue penalty, on a write-heavy mix
    for qp in (False, True):
        rng = np.random.default_rng(7)
        d4 = C.make_directory(16, 8, 3, r_max=4)
        S = np.asarray(d4.chains).shape[0]
        calls = []
        for i in range(3):
            ops = np.where(rng.random(64) < 0.5, C.OP_PUT, C.OP_GET)
            ops[rng.random(64) < 0.1] = C.OP_DEL
            b = batch(rng, 64, 4, ops)
            b[1][:32] = rng.choice(b[1][32:], 32)
            ex = dict(seed=10 + i, dirty=rng.random((S, 4)) < 0.3)
            if qp:
                ex["qpen"] = rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32)
            calls.append((*b, ex))
        run(f"craq{'_qpen' if qp else ''}_{strat}", d4, C.make_store(8, 64, 4), C.DistConfig(
            strategy=strat, bucket_cap=4, read_spread=True, return_decision=True,
            replication_mode="craq", queue_pen=qp), calls)
print("ok")
'''

STRATEGIES = ("allgather", "bucket_a2a")
# (case, bucket_cap, read_spread, craq, queue_pen)
CASES = {
    "oracle": (32, False, False, False),
    "overflow": (2, False, False, False),
    "spread": (32, True, False, False),
    "craq": (4, True, True, False),
    "craq_qpen": (4, True, True, True),
}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_store_ref")
    script = out / "reference.py"
    script.write_text(REFERENCE)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    res = subprocess.run([sys.executable, str(script), str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads buy nothing here, and under
    the parallel test run they only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    if x.dtype == np.float32:
        return x.view(np.uint32).astype(np.int64)
    return x.astype(np.int64)


def _same(got, want) -> bool:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == np.float32:
        got = got.astype(np.float32)
    return got.shape == want.shape and np.array_equal(_bits(got), _bits(want))


def _mesh(parts):
    """An 8-shard CPU mesh in ``parts`` parts."""
    if parts == 1:
        return DS.make_mesh(8, device="cpu")
    return DS.make_mesh(8, cards=("cpu",) * parts)


def _replay(z, case, strategy, parts=1, **kw):
    """The port's replay of a case's calls on an 8-shard CPU mesh in
    ``parts`` parts: yields ``(i, resp, store, directory, load, metrics)``
    after each call, the store stacked."""
    cap, spread, craq, qpen = CASES[case]
    cfg = DS.DistConfig(strategy=strategy, bucket_cap=cap, read_spread=spread,
                        return_decision=True,
                        replication_mode="craq" if craq else "eventual",
                        queue_pen=qpen)
    d = convert.directory_from_numpy(
        {k[4:]: z[k] for k in z.files if k.startswith("dir_")}, device="cpu")
    mesh = _mesh(parts)
    store = TS.split_store(convert.store_from_numpy(
        z["store_keys"], z["store_values"], z["store_overflow"],
        device="cpu"), mesh.devices)
    f = DS.make_dist_apply(mesh, d, cfg)
    load = torch.zeros(8, dtype=torch.int64)
    i = 0
    while f"in{i}_op" in z.files:
        q = TR.make_queries(z[f"in{i}_keys"], z[f"in{i}_op"], z[f"in{i}_vals"],
                            z[f"in{i}_ends"], device="cpu")
        if spread:
            args = [store, d, load]
            if qpen:
                args.append(torch.as_tensor(z[f"in{i}_qpen"].astype(np.int64)))
            if craq:
                args.append(torch.as_tensor(z[f"in{i}_dirty"]))
            rng = np.array([0, int(z[f"in{i}_seed"])], np.uint32)
            store, resp, d, load, m = f(*args, q, rng, **kw)
        else:
            store, resp, d, m = f(store, d, q, **kw)
        yield i, resp, store.stacked(), d, load, m
        i += 1


@pytest.mark.parametrize("parts", [1, 2, 4, 8])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("case", list(CASES))
def test_dist_apply_matches_reference(reference, case, strategy, parts):
    """Every call of the case: responses, store, directory counters, load
    registers and every metric the reference returns (bucket overflow,
    exchange rounds, the decision, craq's picked / bounced), with the
    mesh's 8 shards in 1, 2, 4 or 8 parts."""
    z = np.load(reference / f"{case}_{strategy}.npz")
    calls = 0
    for i, resp, store, d, load, m in _replay(z, case, strategy, parts):
        for k in ("value", "found", "scan_values", "scan_keys", "scan_count"):
            assert _same(getattr(resp, k), z[f"out{i}_resp_{k}"]), (i, k)
        for k in ("keys", "values", "overflow"):
            assert _same(getattr(store, k), z[f"out{i}_store_{k}"]), (i, k)
        for k in ("read_count", "write_count"):
            assert _same(getattr(d, k), z[f"out{i}_dir_{k}"]), (i, k)
        assert _same(load, z[f"out{i}_load"]), i
        names = [k[len(f"out{i}_m_"):] for k in z.files
                 if k.startswith(f"out{i}_m_")]
        assert set(names) <= set(m), names
        for k in names:
            assert _same(m[k], z[f"out{i}_m_{k}"]), (i, k)
        calls += 1
    assert calls >= 2
    if case == "overflow" and strategy == "bucket_a2a":
        # the reference's replicated metric reads the first shard's count
        assert int(m["bucket_overflow"]) > 0
        assert int(m["bucket_overflow"]) == int(m["bucket_overflow_shards"][0])


@pytest.mark.parametrize("case", ["spread", "craq", "craq_qpen"])
def test_dist_apply_write_rounds_shortcut(reference, case):
    """``write_rounds`` at the directory's longest chain (3 here, under
    r_max 5 or 4) skips the empty write rounds and changes
    nothing else: every output equals the ``write_rounds=None`` run's, and
    ``a2a_rounds`` counts the rounds run, ``1 + longest`` against
    ``1 + r_max``."""
    z = np.load(reference / f"{case}_bucket_a2a.npz")
    longest = int(z["dir_chain_len"].max())
    r_max = z["dir_chains"].shape[1]
    assert longest < r_max
    full = _replay(z, case, "bucket_a2a")
    short = _replay(z, case, "bucket_a2a", write_rounds=longest)
    calls = 0
    for a, b in zip(full, short):
        _, ra, sa, da, la, ma = a
        _, rb, sb, db, lb, mb = b
        for k in ("value", "found", "scan_values", "scan_keys", "scan_count"):
            assert _same(getattr(rb, k), getattr(ra, k).numpy()), k
        for k in ("keys", "values", "overflow"):
            assert _same(getattr(sb, k), getattr(sa, k).numpy()), k
        for k in ("read_count", "write_count"):
            assert _same(getattr(db, k), getattr(da, k).numpy()), k
        assert _same(lb, la.numpy())
        assert set(ma) == set(mb)
        for k in ma:
            if k != "a2a_rounds":
                assert _same(mb[k], ma[k].numpy()), k
        assert int(ma["a2a_rounds"]) == 1 + r_max
        assert int(mb["a2a_rounds"]) == 1 + longest
        calls += 1
    assert calls >= 2


def _targets(seed, Bl, n):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, n, Bl)
    t[rng.random(Bl) < 0.15] = DS.DROP
    t[rng.random(Bl) < 0.05] = n + 3          # out of range: dead too
    t[: Bl // 3] = rng.integers(0, 2)         # crowd two buckets
    return t.astype(np.int32)


@pytest.mark.parametrize("seed,Bl,n,cap", [(0, 64, 8, 2), (1, 64, 8, 8),
                                           (2, 257, 5, 16), (3, 33, 3, 64),
                                           (4, 8, 8, 1)])
def test_bucketize_scatter_gather_match_reference(seed, Bl, n, cap):
    """A source slice with dead (``DROP`` and out-of-range) queries and
    overflowing buckets: slots, overflow, the buckets of int, uint32-key
    and (Bl, V) float payloads, and the gather back; then the same rows
    stacked as n sources, each equal to its own 1-D call."""
    rng = np.random.default_rng(seed + 100)
    n_slots = n * cap
    rows = [_targets(seed * 10 + r, Bl, n) for r in range(n)]
    keys = rng.integers(0, 2**32 - 1, (n, Bl), dtype=np.uint64).astype(np.uint32)
    vals = rng.normal(size=(n, Bl, 3)).astype(np.float32)
    slots, ovfs = [], []
    for r, t in enumerate(rows):
        js, jo = JDS.bucketize(jnp.asarray(t), n, cap)
        ts, to = DS.bucketize(torch.as_tensor(t.astype(np.int64)), n, cap)
        assert _same(ts, js) and int(to) == int(jo)
        slots.append(ts)
        ovfs.append(int(to))
        for pay, fill_j, fill_t in (
                (keys[r], jnp.uint32(0xFFFFFFFF), 0xFFFFFFFF),
                (vals[r], 0.0, 0.0),
                (t, jnp.int32(-7), -7)):
            jb = JDS.scatter_to_buckets(js, jnp.asarray(pay), n_slots, fill_j)
            tb = DS.scatter_to_buckets(
                ts, torch.as_tensor(pay.astype(np.int64) if pay.dtype != np.float32 else pay),
                n_slots, fill_t)
            assert _same(tb, jb)
            jg = JDS.gather_from_buckets(js, jb, fill_j)
            tg = DS.gather_from_buckets(ts, tb, fill_t)
            assert _same(tg, jg)
    assert sum(ovfs) > 0 or cap >= Bl
    st, so = DS.bucketize(torch.as_tensor(np.stack(rows).astype(np.int64)),
                          n, cap)
    assert torch.equal(st, torch.stack(slots)) and so.tolist() == ovfs
    sb = DS.scatter_to_buckets(st, torch.as_tensor(vals), n_slots, 0.0)
    for r in range(n):
        assert torch.equal(sb[r], DS.scatter_to_buckets(
            slots[r], torch.as_tensor(vals[r]), n_slots, 0.0))


def test_a2a_is_the_tiled_all_to_all():
    """Row t of the exchange is target t's inbound queue: the sources'
    ``cap`` chunks for t, in source order."""
    n, cap = 4, 3
    x = torch.arange(n * n * cap).reshape(n, n * cap)
    y = DS._a2a(x, n)
    for t in range(n):
        for s in range(n):
            assert torch.equal(y[t, s * cap:(s + 1) * cap],
                               x[s, t * cap:(t + 1) * cap])
    assert torch.equal(DS._a2a(y, n), x)


def test_psum_delta_wraps_like_uint32():
    """The shards' deltas summed, then wrapped: uint32 arithmetic in any
    order, past 2**32 too."""
    base = torch.tensor([0xFFFFFFF0, 5, 0], dtype=torch.int64)
    news = [torch.tensor([(0xFFFFFFF0 + 9) & 0xFFFFFFFF, 7, 2**31]),
            torch.tensor([0xFFFFFFF0 + 3, 5, 2**31])]
    got = DS._psum_delta(base, news)
    want = (np.array([0xFFFFFFF0, 5, 0], np.uint32)
            + np.array([9, 2, 2**31], np.uint32)
            + np.array([3, 0, 2**31], np.uint32))
    assert got.tolist() == want.astype(np.int64).tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shard_apply_and_scan_core_match_reference(seed):
    """One shard's mixed batch (GETs, PUTs with repeated keys, DELs, SCANs,
    dead keys) against a half-full slab, with reads and writes owned at
    random: the reference's ``shard_apply`` bit for bit (new slab,
    dropped count, every response), and ``pad_slab`` /
    ``_slab_scan_padded`` on the same slab."""
    rng = np.random.default_rng(seed)
    C, V, B, S = 48, 3, 40, 5
    live = np.sort(rng.choice(2**31, 30, replace=False)).astype(np.uint32)
    sk = np.full(C, 0xFFFFFFFF, np.uint32)
    sk[:30] = live
    sv = np.zeros((C, V), np.float32)
    sv[:30] = rng.normal(size=(30, V))
    keys = rng.choice(np.concatenate([live, rng.integers(0, 2**31, 20).astype(np.uint32)]), B)
    keys[:2] = 0xFFFFFFFF
    ops = rng.integers(0, 4, B).astype(np.int32)
    ends = np.minimum(keys.astype(np.uint64) + rng.integers(0, 2**29, B),
                      2**32 - 2).astype(np.uint32)
    vals = rng.normal(size=(B, V)).astype(np.float32)
    rm = rng.random(B) < 0.7
    wm = rng.random(B) < 0.7
    jq = JC.make_queries(jnp.asarray(keys), jnp.asarray(ops), jnp.asarray(vals),
                         jnp.asarray(ends))
    tq = TR.make_queries(keys, ops, vals, ends, device="cpu")
    jk, jv, jd, jr = JS.shard_apply(jnp.asarray(sk), jnp.asarray(sv), jq,
                                    jnp.asarray(rm), jnp.asarray(wm),
                                    max_scan_results=S)
    tk, tv, td, tr = TS.shard_apply(torch.as_tensor(sk.astype(np.int64)),
                                    torch.as_tensor(sv), tq, torch.as_tensor(rm),
                                    torch.as_tensor(wm), max_scan_results=S)
    assert _same(tk, jk) and _same(tv, jv) and int(td) == int(jd)
    for k in ("value", "found", "scan_values", "scan_keys", "scan_count"):
        assert _same(getattr(tr, k), getattr(jr, k)), k
    jpk, jpv = JS.pad_slab(jnp.asarray(sk), jnp.asarray(sv), S)
    tpk, tpv = TS.pad_slab(torch.as_tensor(sk.astype(np.int64)),
                           torch.as_tensor(sv), S)
    assert _same(tpk, jpk) and _same(tpv, jpv)
    got = TS._slab_scan_padded(tpk, tpv, torch.as_tensor(keys.astype(np.int64)),
                               torch.as_tensor(ends.astype(np.int64)), S)
    want = JS._slab_scan_padded(jpk, jpv, jnp.asarray(keys), jnp.asarray(ends), S)
    for g, w in zip(got, want):
        assert _same(g, w)


def test_stacked_read_round_matches_each_slab():
    """A read round's inbound queries from every shard in one call, each
    key against its receiving shard's slab, equal shard by shard to
    ``slab_get`` (on the card the call is one launch of K4a:
    ``tests/test_torch_cuda.py``)."""
    from repro_torch.kernels.range_match import kernel as RMK

    rng = np.random.default_rng(3)
    N, M, C, V = 8, 24, 32, 2
    keys = np.sort(rng.integers(0, 2**32 - 1, (N, C), dtype=np.uint64), axis=1)
    store = convert.store_from_numpy(keys.astype(np.uint32),
                                     rng.normal(size=(N, C, V)).astype(np.float32),
                                     np.zeros(N, np.int32), device="cpu")
    pick = rng.integers(0, C, (N, M))
    qk = np.take_along_axis(keys, pick, axis=1)
    qk[:, ::3] = rng.integers(0, 2**32 - 1, (N, (M + 2) // 3))
    q = TR.QueryBatch(torch.zeros((N, M), dtype=torch.int32),
                      torch.as_tensor(qk.astype(np.int64)),
                      torch.zeros((N, M), dtype=torch.int64),
                      torch.zeros((N, M, V)))
    RMK.reset_launches()
    got = TS.shards_read(store, q, torch.ones((N, M), dtype=torch.bool),
                         max_scan_results=2, scans=False)
    for n in range(N):
        want_v, want_f = TS.slab_get(store.keys[n], store.values[n], q.key[n])
        assert torch.equal(got.found[n], want_f)
        assert torch.equal(got.value[n], want_v)
    # the CPU path runs the plain version and counts no launch; on the
    # card the same call is one launch (tests/test_torch_cuda.py)
    assert RMK.launches["slab_lookup"] == 0
