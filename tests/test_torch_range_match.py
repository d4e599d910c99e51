"""The range_match kernels' plain versions (what every wrapper runs on a
CPU tensor, and what ``chip_smoke.py`` holds the CUDA kernels to on the
card) against the reference's jnp refs and its Pallas kernels run in
interpret mode — bit for bit, on the same packed tables: K1, K2, K3 (with
the key filter against the reference's jnp route, which the Pallas K3
lacks), K4a and K4b."""

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
from repro.core import routing as JR
from repro.kernels.range_match import kernel as JKer
from repro.kernels.range_match import ops as JOps
from repro.kernels.range_match import ref as JRef
from repro_torch import convert, prng
from repro_torch import coordination_tier as TCT
from repro_torch.core import controller as TCtl
from repro_torch.core import routing as TR
from repro_torch.kernels.range_match import kernel as TKer
from repro_torch.kernels.range_match import ops as TOps
from repro_torch.kernels.range_match import ref as TRef
from test_torch_cuda import SPAN_CASES, span_table, span_values

B = 1024          # one Pallas grid step of 8 x 128 packets


def _t64(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _t32_bits(a):
    return torch.tensor(np.ascontiguousarray(np.asarray(a)).view(np.int32))


def _directory(seed, hash_partitioned=False):
    rng = np.random.default_rng(seed)
    d = JC.make_directory(20, 6, 2, r_max=4, n_slots=60,
                          hash_partitioned=hash_partitioned)
    ctl = JC.Controller(d)
    load = rng.random(6)
    for _ in range(25):
        r = int(rng.choice(ctl.live_ranges()))
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
    jd = ctl.directory()
    td = convert.directory_from_numpy(
        {f: np.asarray(getattr(jd, f)) for f in convert.DIRECTORY_FIELDS},
        hash_partitioned=hash_partitioned, device="cpu")
    return jd, td


def _packets(seed):
    rng = np.random.default_rng(seed + 7)
    keys = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    keys[:3] = [0, 0xFFFFFFFF, 0x80000000]
    ops = rng.integers(0, 4, B).astype(np.int32)
    return keys, ops


def _packed_jax(jd):
    lo, hi, chains, clen = JOps.pack_tables(jd)
    return lo, hi, chains, clen


def _packed_torch(packed):
    lo, hi, chains, clen = (np.asarray(x) for x in packed)
    return _t32_bits(lo), _t32_bits(hi), torch.tensor(chains), torch.tensor(clen)


def _eq(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_k1_plain_matches_jnp_ref_on_padded_tables(seed):
    jd, _ = _directory(seed)
    keys, ops = _packets(seed)
    packed = _packed_jax(jd)
    ref = JRef.range_match_ref(jnp.asarray(keys), jnp.asarray(ops), *packed,
                               num_slots=jd.num_slots)
    got = TKer.range_match(_t64(keys), torch.as_tensor(ops),
                           *_packed_torch(packed), num_slots=jd.num_slots)
    for a, b in zip(ref, got):
        assert _eq(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_k2_plain_matches_jnp_ref_on_padded_tables(seed):
    jd, _ = _directory(seed)
    keys, ops = _packets(seed)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2**31 - 1, (2, B)).astype(np.int32)
    loads = rng.integers(0, 2**31 - 1, 128).astype(np.int32)
    packed = _packed_jax(jd)
    ref = JRef.range_match_spread_ref(
        jnp.asarray(keys), jnp.asarray(ops), jnp.asarray(u[0]),
        jnp.asarray(u[1]), *packed, jnp.asarray(loads), num_slots=jd.num_slots)
    lo, hi, chains, clen = _packed_torch(packed)
    got = TKer.range_match_spread(
        _t64(keys), torch.as_tensor(ops), torch.as_tensor(u[0]),
        torch.as_tensor(u[1]), lo, hi, chains, clen, torch.as_tensor(loads),
        num_slots=jd.num_slots)
    for a, b in zip(ref, got):
        assert _eq(a, b)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("hash_partitioned", [False, True])
def test_k1_wrapper_matches_pallas_interpret(seed, hash_partitioned):
    jd, td = _directory(seed, hash_partitioned)
    keys, ops = _packets(seed)
    pal = JOps.range_match(jd, jnp.asarray(keys), jnp.asarray(ops),
                           use_pallas=True, interpret=True)
    got = TOps.range_match(td, _t64(keys), torch.as_tensor(ops))
    for a, b in zip(pal, got):
        assert _eq(a, b)


@pytest.mark.parametrize("seed", range(2))
def test_k2_wrapper_matches_pallas_interpret(seed):
    """Same rng -> same (B, 2) randint draw -> same picks.  Loads below
    2**31, where the Pallas wrapper's int32 cast and the kernel's uint32
    compare agree."""
    jd, td = _directory(seed)
    keys, ops = _packets(seed)
    load = np.random.default_rng(seed).integers(0, 100, 6).astype(np.uint32)
    pal = JOps.range_match_spread(jd, jnp.asarray(keys), jnp.asarray(ops),
                                  jnp.asarray(load), jax.random.PRNGKey(seed),
                                  use_pallas=True, interpret=True)
    got = TOps.range_match_spread(td, _t64(keys), torch.as_tensor(ops),
                                  convert.load_reg_from_numpy(load, device="cpu"),
                                  prng.PRNGKey(seed))
    for a, b in zip(pal, got):
        assert _eq(a, b)


def _slabs(seed, N=4, C=200):
    rng = np.random.default_rng(seed)
    slabs = np.full((N, C), 0xFFFFFFFF, np.uint32)
    for n in range(N):
        m = int(rng.integers(0, C + 1))
        slabs[n, :m] = np.sort(rng.choice(2**32 - 1, m, replace=False)).astype(np.uint32)
    return slabs


@pytest.mark.parametrize("seed", range(3))
def test_k4a_plain_matches_jnp_ref_and_pallas_interpret(seed):
    N, C = 4, 200
    slabs = _slabs(seed, N, C)
    rng = np.random.default_rng(seed + 1)
    target = rng.integers(-1, N, B).astype(np.int32)
    resident = slabs[np.clip(target, 0, N - 1), rng.integers(0, C, B)]
    fresh = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    qkeys = np.where(rng.random(B) < 0.6, resident, fresh).astype(np.uint32)
    qkeys[:2] = [0xFFFFFFFF, 0]
    padded = JOps.pack_slabs(jnp.asarray(slabs))
    ref = JRef.slab_lookup_ref(jnp.asarray(qkeys), jnp.asarray(target), padded,
                               slab_len=C)
    pal = JKer.slab_lookup_pallas(jnp.asarray(qkeys), jnp.asarray(target),
                                  padded, slab_len=C, interpret=True)
    got_slot, got_found = TKer.slab_lookup(_t64(qkeys), _t64(target),
                                           _t64(slabs))
    assert _eq(ref[0], got_slot)
    assert _eq(ref[1], got_found)
    assert _eq(pal[0], got_slot)
    assert _eq(np.asarray(pal[1]) != 0, got_found)


@pytest.mark.parametrize("seed", range(3))
def test_k4a_plain_is_a_bisect_left_per_row(seed):
    """The plain K4a's one searchsorted over the node-offset rows equals a
    per-packet ``bisect_left`` on its own row (what the CUDA kernel does),
    including full rows, EMPTY keys and negative targets."""
    import bisect

    N, C = 5, 37
    slabs = _slabs(seed, N, C)
    slabs[0] = np.sort(np.random.default_rng(seed).choice(2**32 - 1, C,
                                                          replace=False))
    rng = np.random.default_rng(seed + 2)
    target = rng.integers(-2, N, 400)
    resident = slabs[np.clip(target, 0, N - 1), rng.integers(0, C, 400)]
    fresh = rng.integers(0, 2**32, 400, dtype=np.uint64)
    qkeys = np.where(rng.random(400) < 0.5, resident, fresh).astype(np.int64)
    qkeys[:3] = [0xFFFFFFFF, 0, 2**32 - 2]
    slot, found = TKer.slab_lookup(_t64(qkeys), _t64(target), _t64(slabs))
    for b in range(400):
        row = slabs[min(max(target[b], 0), N - 1)].tolist()
        pos = min(bisect.bisect_left(row, int(qkeys[b])), C - 1)
        hit = (row[pos] == qkeys[b] and qkeys[b] != 0xFFFFFFFF
               and target[b] >= 0)
        assert int(slot[b]) == pos and bool(found[b]) == hit


def test_k4a_is_store_slab_get_probe():
    """The store's GET probe: slot = searchsorted-left clamped, found =
    the hit mask — exactly ``store.slab_get`` per row."""
    from repro_torch.core.store import slab_get

    slabs = _slabs(4, 3, 64)
    rng = np.random.default_rng(9)
    target = rng.integers(0, 3, 300)
    qkeys = slabs[target, rng.integers(0, 64, 300)]
    slot, found = TOps.slab_lookup(_t64(qkeys), _t64(target), _t64(slabs))
    for n in range(3):
        m = target == n
        _, f = slab_get(_t64(slabs[n]), torch.zeros(64, 1), _t64(qkeys[m]))
        assert np.array_equal(f.numpy(), found.numpy()[m])


def test_wrappers_reject_mixed_devices():
    keys = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="mixed devices"):
        TKer.slab_lookup(keys, keys.to("meta"), torch.zeros(2, 8, dtype=torch.int64))


def _dirty_packed(jd, seed):
    """A random (S, r_max) dirty table, lane-padded for the reference
    ((r_max, Spad) int32) and in the port's (r_max, S) uint8 layout."""
    dirty = np.random.default_rng(seed + 3).random((jd.num_slots, jd.r_max)) < 0.4
    return dirty, JOps.pack_dirty(jd, jnp.asarray(dirty))


def _dirty_torch(dirty_p, S):
    return torch.tensor(np.asarray(dirty_p)[:, :S].astype(np.uint8))


@pytest.mark.parametrize("seed", range(3))
def test_k3_plain_matches_jnp_ref_on_padded_tables(seed):
    jd, _ = _directory(seed)
    keys, ops = _packets(seed)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2**31 - 1, (2, B)).astype(np.int32)
    loads = rng.integers(0, 2**31 - 1, 128).astype(np.int32)
    _, dirty_p = _dirty_packed(jd, seed)
    packed = _packed_jax(jd)
    ref = JRef.range_match_spread_dirty_ref(
        jnp.asarray(keys), jnp.asarray(ops), jnp.asarray(u[0]),
        jnp.asarray(u[1]), *packed, jnp.asarray(loads), dirty_p,
        num_slots=jd.num_slots)
    lo, hi, chains, clen = _packed_torch(packed)
    got = TKer.range_match_spread_dirty(
        _t64(keys), torch.as_tensor(ops), torch.as_tensor(u[0]),
        torch.as_tensor(u[1]), lo, hi, chains, clen, torch.as_tensor(loads),
        torch.tensor(np.asarray(dirty_p).astype(np.uint8)),
        num_slots=jd.num_slots)
    for a, b in zip(ref, got):
        assert _eq(a, b)
    assert got[4].any()


@pytest.mark.parametrize("seed", range(2))
def test_k3_wrapper_matches_pallas_interpret(seed):
    jd, td = _directory(seed)
    keys, ops = _packets(seed)
    load = np.random.default_rng(seed).integers(0, 100, 6).astype(np.uint32)
    dirty, _ = _dirty_packed(jd, seed)
    pal = JOps.range_match_spread_dirty(
        jd, jnp.asarray(keys), jnp.asarray(ops), jnp.asarray(load),
        jnp.asarray(dirty), jax.random.PRNGKey(seed), use_pallas=True,
        interpret=True)
    got = TOps.range_match_spread_dirty(
        td, _t64(keys), torch.as_tensor(ops),
        convert.load_reg_from_numpy(load, device="cpu"), torch.tensor(dirty),
        prng.PRNGKey(seed))
    for a, b in zip(pal, got):
        assert _eq(a, b)


@pytest.mark.parametrize("filter_bits", [8, 64])
def test_k3_key_filter_is_the_reference_route(filter_bits):
    """K3 with the key filter (which the Pallas kernel lacks) against the
    reference's jnp ``route_load_aware_dirty(key_filter=)``; a zero-width
    filter is no filter."""
    jd, td = _directory(1)
    keys, ops = _packets(1)
    rng = np.random.default_rng(filter_bits)
    load = rng.integers(0, 100, 6).astype(np.uint32)
    dirty = rng.random((jd.num_slots, jd.r_max)) < 0.6
    kf = rng.random((jd.num_slots, filter_bits)) < 0.3
    jdec, _, _, jp, jb = JR.route_load_aware_dirty(
        jd, JC.make_queries(jnp.asarray(keys), jnp.asarray(ops)),
        jnp.asarray(load), jnp.asarray(dirty), jax.random.PRNGKey(2),
        key_filter=jnp.asarray(kf))
    tload = convert.load_reg_from_numpy(load, device="cpu")
    got = TOps.range_match_spread_dirty(
        td, _t64(keys), torch.as_tensor(ops), tload, torch.tensor(dirty),
        prng.PRNGKey(2), key_filter=torch.tensor(kf))
    for a, b in zip((jdec.ridx, jdec.target, np.asarray(jdec.chain).T, jp, jb),
                    got):
        assert _eq(a, b)
    plain = TOps.range_match_spread_dirty(
        td, _t64(keys), torch.as_tensor(ops), tload, torch.tensor(dirty),
        prng.PRNGKey(2))
    empty = TOps.range_match_spread_dirty(
        td, _t64(keys), torch.as_tensor(ops), tload, torch.tensor(dirty),
        prng.PRNGKey(2), key_filter=torch.zeros((jd.num_slots, 0), dtype=bool))
    for a, b in zip(plain, empty):
        assert torch.equal(a, b)
    assert (plain[4] & ~got[4]).any()


@pytest.mark.parametrize("seed", range(3))
def test_k4b_plain_matches_jnp_ref_on_padded_tables(seed):
    jd, _ = _directory(seed)
    keys, ops = _packets(seed)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2**31 - 1, (2, B)).astype(np.int32)
    loads = rng.integers(0, 6, 128).astype(np.int32)
    _, dirty_p = _dirty_packed(jd, seed)
    N, C = 6, 200
    slabs = _slabs(seed, N, C)
    qkeys = np.where(rng.random(B) < 0.5,
                     slabs[rng.integers(0, N, B), rng.integers(0, C, B)],
                     keys).astype(np.uint32)
    packed = _packed_jax(jd)
    ref = JRef.range_match_apply_ref(
        jnp.asarray(keys), jnp.asarray(ops), jnp.asarray(u[0]),
        jnp.asarray(u[1]), *packed, jnp.asarray(loads), dirty_p,
        jnp.asarray(qkeys), JOps.pack_slabs(jnp.asarray(slabs)),
        num_slots=jd.num_slots, slab_len=C)
    lo, hi, chains, clen = _packed_torch(packed)
    got = TKer.range_match_apply(
        _t64(keys), torch.as_tensor(ops), torch.as_tensor(u[0]),
        torch.as_tensor(u[1]), lo, hi, chains, clen, torch.as_tensor(loads),
        torch.tensor(np.asarray(dirty_p).astype(np.uint8)), _t64(qkeys),
        _t64(slabs), num_slots=jd.num_slots)
    for a, b in zip(ref, got):
        assert _eq(a, b)
    assert got[6].any()


def test_plain_versions_do_not_count_launches():
    TKer.reset_launches()
    jd, td = _directory(0)
    keys, ops = _packets(0)
    q = TR.make_queries(keys, ops, device="cpu")
    load = torch.zeros(6, dtype=torch.int64)
    dirty = torch.ones((jd.num_slots, jd.r_max), dtype=torch.bool)
    TR.route(td, q)
    TR.route_load_aware_dirty(td, q, load, dirty, prng.PRNGKey(0))
    TR.route_and_lookup(td, q, _t64(_slabs(0, 6, 16)), load, dirty,
                        prng.PRNGKey(0))
    coord = TCT.make_state(TCtl.Controller(td).table_snapshot(), 4,
                           device="cpu")
    TOps.range_match_stale(coord, q.key, q.opcode)
    assert TKer.launches == {"range_match": 0, "range_match_spread": 0,
                             "range_match_spread_dirty": 0,
                             "range_match_apply": 0, "slab_lookup": 0,
                             "range_match_stale": 0}


# ---------------------------------------------------------------------------
# The plain mirror of the route kernels' match over the sorted span table
# ---------------------------------------------------------------------------


def _mirror_vs_reference(lo, hi, live, mvals, num_slots):
    """``sorted_match_ref`` on the port's dead-masked spans against the
    port's min-index match, the reference's Pallas kernel in interpret
    mode on the lane-padded spans and, where ``num_slots`` is the whole
    table, the reference's ``directory.lookup_range``.  Returns the pass
    the mirror took."""
    S = len(lo)
    lo_m = np.where(live, lo, 0xFFFFFFFF).astype(np.uint32)
    hi_m = np.where(live, hi, 0).astype(np.uint32)
    t_lo, t_hi, t_v = _t32_bits(lo_m), _t32_bits(hi_m), _t64(mvals)
    got, match = TRef.sorted_match_ref(t_v, t_lo, t_hi, num_slots)
    assert _eq(TRef._slot_match(t_v, t_lo, t_hi, num_slots), got)
    spad = max(128, -(-S // 128) * 128)
    pad = lambda a, fill: jnp.asarray(np.concatenate(  # noqa: E731
        [a, np.full(spad - S, fill, a.dtype)]))
    ridx, _, _ = JKer.range_match_pallas(
        jnp.asarray(mvals.astype(np.uint32)), jnp.zeros(len(mvals), jnp.int32),
        pad(lo_m, 0xFFFFFFFF), pad(hi_m, 0), jnp.zeros((1, spad), jnp.int32),
        jnp.ones(spad, jnp.int32), num_slots=num_slots, interpret=True)
    assert _eq(ridx, got)
    if num_slots == S:
        jd = JC.make_directory(1, 1, 1, n_slots=S)
        jd = jd.__class__(**{**jd.__dict__, "slot_lo": jnp.asarray(lo, jnp.uint32),
                             "slot_hi": jnp.asarray(hi, jnp.uint32),
                             "live": jnp.asarray(live)})
        assert _eq(JC.lookup_range(jd, jnp.asarray(mvals.astype(np.uint32))),
                   got)
    return match


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("hash_partitioned", [False, True])
def test_sorted_match_mirror_on_directories(seed, hash_partitioned):
    """Controller-built directories (after splits, merges, widens and
    narrows) partition the key space: the mirror takes the binary search
    and equals the reference's lookup and Pallas kernel."""
    jd, _ = _directory(seed, hash_partitioned)
    keys, _ = _packets(seed)
    mvals = np.asarray(JC.keys.matching_value(
        jnp.asarray(keys), hash_partitioned=hash_partitioned)).astype(np.int64)
    lo, hi, live = (np.asarray(x) for x in (jd.slot_lo, jd.slot_hi, jd.live))
    edges = np.concatenate([lo[live], hi[live]]).astype(np.int64)
    mvals[:len(edges)] = edges[:B]
    assert _mirror_vs_reference(lo, hi, live, mvals, jd.num_slots) == "search"


@pytest.mark.parametrize("case,match", SPAN_CASES)
def test_sorted_match_mirror_on_span_tables(case, match):
    """Tables that take each pass (the cases the ``cuda`` tests run on the
    card): overlapping spans, equal lo, single-key spans, the full key
    space, gaps, every slot dead, hits at and past ``num_slots``, and the
    values 0 and 2**32 - 1."""
    lo, hi, num_slots = span_table(case, 64, seed=len(case))
    live = lo <= hi
    mvals = span_values(lo, hi, B, seed=len(case)).astype(np.int64)
    assert _mirror_vs_reference(lo.astype(np.uint32), hi.astype(np.uint32),
                                live, mvals, num_slots) == match


def test_span_order_mirror_ranks():
    """The mirror's order is the live spans sorted by (lo, slot id): dead
    slots (lo > hi as uint32, the top bit set on some) are left out and
    equal lo keep slot order."""
    lo = np.array([9, 0xFFFFFFFF, 5, 9, 0x80000000, 7, 3], np.uint32)
    hi = np.array([9, 0, 6, 12, 0xFFFFFFFF, 2, 0x90000000], np.uint32)
    slo, shi, sid = TRef.span_order_ref(_t32_bits(lo), _t32_bits(hi))
    assert sid.tolist() == [6, 2, 0, 3, 4]
    assert slo.tolist() == [3, 5, 9, 9, 0x80000000]
    assert shi.tolist() == [0x90000000, 6, 9, 12, 0xFFFFFFFF]
