"""K5's match over a sorted span table per switch copy, on the CPU: the
plain mirror of the kernel's algorithm (``ref.stale_sorted_match_ref``:
each copy's own (lo, slot id) order, its own disjoint check, then the
binary search or the exhaustive lowest-id pass) against K5's plain version
(``ref.range_match_stale_ref``, the wrapper's CPU path) and the
reference's ``range_match_stale`` (jnp ref and Pallas kernel in interpret
mode), bit for bit, with the pass each copy takes.  The inputs are
controller-built directories copied to 1, 3 and 4 switches and perturbed
as the tier perturbs them, and copies mixed from the malformed span
tables of ``test_torch_cuda.SPAN_CASES``."""

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

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as JC
from repro.kernels.range_match import ops as JOps
from repro_torch.kernels.range_match import kernel as TKer
from repro_torch.kernels.range_match import ref as TRef
from test_torch_cuda import (SPAN_CASES, SPAN_PASS, STALE_MIXES, stale_keys,
                             stale_packed, stale_tables)

B = 1024          # one Pallas grid step of 8 x 128 packets


def _stale_vs_reference(tables, keys, ops, num_slots, hash_partitioned=False):
    """The mirror, K5's plain version and the wrapper's CPU path on the
    port's packed tables, and the reference's jnp ref and Pallas kernel
    (interpret mode) on its lane-padded ones, all equal.  Returns the pass
    of each copy the mirror took."""
    packed = stale_packed(tables, "cpu")
    tk, to = torch.tensor(keys), torch.tensor(ops)
    kw = dict(num_slots=num_slots, hash_partitioned=hash_partitioned)
    got, passes = TRef.stale_sorted_match_ref(tk, to, *packed, **kw)
    assert [t.dtype for t in got] == [torch.int32, torch.int32, torch.bool]
    for want in (TRef.range_match_stale_ref(tk, to, *packed, **kw),
                 TKer.range_match_stale(tk, to, *packed, **kw)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    jcoord = SimpleNamespace(**{k: jnp.asarray(v) for k, v in tables.items()})
    W, S, r_max = tables["chains"].shape
    for use_pallas in (False, True):
        want = JOps._range_match_stale_packed(
            *JOps.pack_coord_tables(jcoord), jnp.asarray(keys.astype(np.uint32)),
            jnp.asarray(ops), num_slots=num_slots, r_max=r_max, n_switches=W,
            hash_partitioned=hash_partitioned, use_pallas=use_pallas,
            interpret=True, block_rows=JOps.DEFAULT_BLOCK_ROWS)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), use_pallas
    return passes


def _directory_tables(seed, W, hash_partitioned, clen_zero):
    """A controller-built directory (after splits, merges, widens and
    narrows) copied to W switches and perturbed as the tier perturbs them:
    the rogue copy of ``coordination_tier/manager.py``'s split brain
    (chains rotated by one node, versions 1,000 past the committed ones)
    on switch 1 % W, a row retired on switch 2 % W only, a lower bound
    shifted up by 3 on switch W - 1, and with ``clen_zero`` rows of chain
    length 0 whose position 0 holds NO_NODE."""
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
    snap = ctl.table_snapshot()
    t = {f: np.stack([np.asarray(snap[f])] * W)
         for f in ("slot_lo", "slot_hi", "live", "chains", "chain_len")}
    S = t["live"].shape[1]
    committed = rng.integers(0, 2**31, S).astype(np.uint32)
    version = np.stack([committed] * W)
    rogue = 1 % W
    ch = t["chains"][rogue]
    t["chains"][rogue] = np.where(ch >= 0, (ch + 1) % 6, ch)
    version[rogue] = committed + np.uint32(1000)
    live = np.flatnonzero(t["live"][2 % W])
    t["live"][2 % W, live[len(live) // 2]] = False
    wide = np.flatnonzero(t["live"][W - 1] & (t["slot_hi"][W - 1].astype(np.int64)
                                              - t["slot_lo"][W - 1] > 3))
    t["slot_lo"][W - 1, wide[0]] += np.uint32(3)
    if clen_zero:
        t["chain_len"][:, ::3] = 0
        t["chains"][:, ::6, :] = -1
    return dict(t, version=version.astype(np.uint32), committed=committed)


@pytest.mark.parametrize("clen_zero", [False, True])
@pytest.mark.parametrize("hash_partitioned", [False, True])
@pytest.mark.parametrize("W", [1, 3, 4])
def test_stale_mirror_on_directories(W, hash_partitioned, clen_zero):
    """A controller's directory, copied to every switch and perturbed,
    stays disjoint in every copy: each takes the binary search, and the
    mirror equals K5's plain version and the reference's."""
    tables = _directory_tables(W + 10 * hash_partitioned, W, hash_partitioned,
                               clen_zero)
    keys, ops = stale_keys(tables, B, seed=W)
    S = tables["live"].shape[1]
    passes = _stale_vs_reference(tables, keys, ops, S, hash_partitioned)
    assert passes == ["search"] * W


@pytest.mark.parametrize("cases", STALE_MIXES, ids="-".join)
def test_stale_mirror_on_mixed_copies(cases):
    """Copies mixed from the malformed span tables: each copy takes its own
    case's pass, whatever the others take (a disjoint copy beside an
    overlapping or an all-dead one keeps the search), and hits at slot ids
    past ``num_slots`` clamp in every copy."""
    tables, num_slots = stale_tables(cases, 64, seed=len(cases))
    keys, ops = stale_keys(tables, B, seed=len(cases))
    assert (_stale_vs_reference(tables, keys, ops, num_slots)
            == [SPAN_PASS[c] for c in cases])


@pytest.mark.parametrize("case,match", SPAN_CASES)
def test_stale_mirror_on_one_copy(case, match):
    """Each malformed span table alone as a one-switch tier."""
    tables, num_slots = stale_tables((case,), 64, seed=3)
    keys, ops = stale_keys(tables, B, seed=3)
    assert _stale_vs_reference(tables, keys, ops, num_slots) == [match]

