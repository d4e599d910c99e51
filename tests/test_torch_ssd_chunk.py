"""K7's plain versions against the reference on the CPU: the port's
``ssd_scan`` (which runs ``ssd_chunked_ref`` on CPU tensors) and
``ssd_sequential_ref`` against the reference's Pallas kernel in interpret
mode, its jnp chunked version and its exact recurrence, at the shapes of
``tests/test_kernels.py`` and at chunk lengths that are not powers of
two; the padding and the one-token decode step; and the plain mirror of
the CUDA kernel's four passes (``ssd_chunk_passes_ref``) against the
same references and, chunk by chunk, against the carried state."""

import sys

import jax
import jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
    # forget the half-imported `repro` modules that earlier test modules'
    # failed imports left behind
    for _m in sorted(m for m in sys.modules if m.startswith("repro.")):
        if _m.rpartition(".")[0] not in sys.modules:
            del sys.modules[_m]

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk import ops as JO
from repro.kernels.ssd_chunk import ref as JR
from repro_torch.kernels.ssd_chunk import kernel as K
from repro_torch.kernels.ssd_chunk import ops as O
from repro_torch.kernels.ssd_chunk import ref as R

TOL = 2e-4      # tests/test_kernels.py's tolerance for ssd_chunk


def _inputs(seed, B, T, H, P, N, G=None, zero_state=False, dt_hi=0.1,
            a_hi=2.0):
    """The reference test's distributions: dt in [0.001, 0.1], A in
    [-2, -0.5], unit normal x, B, C and a 0.1-scaled initial state
    (``dt_hi`` 1.3 and ``a_hi`` 16 give the model's ranges)."""
    rng = np.random.default_rng(seed)
    bc = (B, T, N) if G is None else (B, T, G, N)
    arrays = {
        "x": rng.normal(size=(B, T, H, P)),
        "dt": rng.uniform(0.001, dt_hi, (B, T, H)),
        "A": -rng.uniform(0.5, a_hi, H),
        "Bm": rng.normal(size=bc),
        "Cm": rng.normal(size=bc),
        "s0": (np.zeros((B, H, P, N)) if zero_state
               else rng.normal(size=(B, H, P, N)) * 0.1),
    }
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def _j(a):
    return {k: jnp.asarray(v) for k, v in a.items()}


def _t(a):
    return {k: torch.tensor(v) for k, v in a.items()}


def _args(d):
    return d["x"], d["dt"], d["A"], d["Bm"], d["Cm"], d["s0"]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol)


def _close_scaled(got, want):
    """K7's parity standard, |err| <= TOL (1 + |want|): at the model's
    ranges outputs reach |y| ~ 10 and the reference sums each chunk's
    prefix of dt * A in f32, which moves them by a few 1e-4 against the
    port's f64 prefix (the port's ``ssd_chunked_ref`` too)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float((np.abs(got - want) / (1 + np.abs(want))).max())
    assert err <= TOL, err


@pytest.mark.parametrize("B,T,H,P,N,chunk", [
    (1, 32, 2, 8, 4, 8), (2, 128, 4, 16, 8, 32), (2, 250, 8, 32, 16, 64),
])
def test_ssd_sweep_matches_reference(B, T, H, P, N, chunk):
    """``test_ssd_sweep``'s shapes: the port's scan within 2e-4 of the
    reference's Pallas kernel (interpret mode) and of its recurrence."""
    a = _inputs(B * T + N, B, T, H, P, N)
    y, fs = O.ssd_scan(*_args(_t(a)), chunk=chunk)
    jy, jfs = JO.ssd_scan(*_args(_j(a)), chunk=chunk, use_pallas=True,
                          interpret=True)
    sy, sfs = JR.ssd_sequential_ref(*_args(_j(a)))
    assert y.shape == (B, T, H, P) and fs.shape == (B, H, P, N)
    for got, want in ((y, jy), (fs, jfs), (y, sy), (fs, sfs)):
        _close(got, want)


@pytest.mark.parametrize("B,T,H,P,N", [(1, 32, 2, 8, 4), (2, 33, 4, 16, 8)])
def test_sequential_ref_matches_reference(B, T, H, P, N):
    a = _inputs(T, B, T, H, P, N)
    y, fs = R.ssd_sequential_ref(*_args(_t(a)))
    jy, jfs = JR.ssd_sequential_ref(*_args(_j(a)))
    _close(y, jy, 1e-5)
    _close(fs, jfs, 1e-5)


def test_ssd_grouped_matches_reference():
    """G 2 (``test_ssd_grouped_fallback``'s shape): the reference falls
    back to its jnp chunked version there, and so does its model; the port
    runs its plain version here and K7 on the card."""
    B, T, H, P, N, G = 2, 64, 4, 8, 4, 2
    a = _inputs(5, B, T, H, P, N, G=G, zero_state=True)
    y, fs = O.ssd_scan(*_args(_t(a)), chunk=16)
    jy, jfs = JR.ssd_chunked_ref(*_args(_j(a)), chunk=16)
    _close(y, jy, 1e-5)
    _close(fs, jfs, 1e-5)
    # and the recurrence, group by group
    hg = H // G
    for g in range(G):
        sl = slice(g * hg, (g + 1) * hg)
        sy, sfs = JR.ssd_sequential_ref(
            a["x"][:, :, sl], a["dt"][:, :, sl], a["A"][sl], a["Bm"][:, :, g],
            a["Cm"][:, :, g], a["s0"][:, sl])
        _close(y[:, :, sl], sy)
        _close(fs[:, sl], sfs)


@pytest.mark.parametrize("T,chunk", [(10, 10), (23, 8), (100, 100)],
                         ids=["Q10", "T23-Q8", "Q100"])
def test_ssd_chunk_not_a_power_of_two(T, chunk):
    """The model runs with Q = min(ssm_chunk, max(8, T)): a 10-token
    reduced prompt at Q 10, a 100-token one at Q 100, and a ragged T that
    the wrapper pads.  The port equals the reference's jnp chunked path and
    its Pallas kernel in interpret mode at the same Q."""
    a = _inputs(T + chunk, 2, T, 4, 16, 16)
    y, fs = O.ssd_scan(*_args(_t(a)), chunk=chunk)
    jy, jfs = JO.ssd_scan(*_args(_j(a)), chunk=chunk, use_pallas=False)
    py, pfs = JO.ssd_scan(*_args(_j(a)), chunk=chunk, use_pallas=True,
                          interpret=True)
    sy, sfs = JR.ssd_sequential_ref(*_args(_j(a)))
    for got, want in ((y, jy), (fs, jfs), (y, py), (fs, pfs), (y, sy),
                      (fs, sfs)):
        _close(got, want)


def test_padding_leaves_the_state_untouched():
    """dt = 0 rows are exact no-ops on the state whatever x, B and C hold
    there: the final state of 23 steps padded to 24 with garbage rows
    equals that of the 23 steps, and the first 23 outputs are the same."""
    a = _inputs(9, 2, 23, 4, 16, 8)
    t = _t(a)
    y, fs = O.ssd_scan(*_args(t), chunk=8)
    rng = np.random.default_rng(10)
    junk = {k: torch.tensor(rng.normal(size=(2, 1) + v.shape[2:])
                            .astype(np.float32))
            for k, v in t.items() if k in ("x", "Bm", "Cm")}
    padded = dict(t)
    for k, v in junk.items():
        padded[k] = torch.cat([t[k], v], dim=1)
    padded["dt"] = torch.cat([t["dt"], torch.zeros(2, 1, 4)], dim=1)
    py, pfs = R.ssd_chunked_ref(*_args(padded), chunk=8)
    assert y.shape[1] == 23
    assert torch.equal(pfs, fs)
    assert torch.equal(py[:, :23], y)
    sy, sfs = JR.ssd_sequential_ref(*_args(_j(a)))
    _close(fs, sfs)


def test_ssd_decode_matches_scan_tail():
    """``test_ssd_decode_matches_scan_tail``: T - 1 steps by the scan, the
    last by the decode step, against the recurrence (and the reference's
    decode step on the same state)."""
    B, T, H, P, N = 2, 33, 4, 16, 8
    a = _inputs(11, B, T, H, P, N, zero_state=True)
    t = _t(a)
    sy, sfs = JR.ssd_sequential_ref(*_args(_j(a)))
    _, fs_pre = O.ssd_scan(t["x"][:, :-1], t["dt"][:, :-1], t["A"],
                           t["Bm"][:, :-1], t["Cm"][:, :-1], t["s0"], chunk=8)
    y_t, fs_t = O.ssd_decode_step(t["x"][:, -1], t["dt"][:, -1], t["A"],
                                  t["Bm"][:, -1], t["Cm"][:, -1], fs_pre)
    _close(y_t, np.asarray(sy)[:, -1])
    _close(fs_t, sfs)
    jy_t, jfs_t = JO.ssd_decode_step(
        jnp.asarray(a["x"][:, -1]), jnp.asarray(a["dt"][:, -1]),
        jnp.asarray(a["A"]), jnp.asarray(a["Bm"][:, -1]),
        jnp.asarray(a["Cm"][:, -1]), jnp.asarray(fs_pre.numpy()))
    _close(y_t, jy_t, 1e-5)
    _close(fs_t, jfs_t, 1e-5)


def test_default_init_state_is_zero():
    a = _inputs(12, 1, 16, 2, 8, 4, zero_state=True)
    t = _t(a)
    y0, fs0 = O.ssd_scan(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], chunk=8)
    y1, fs1 = O.ssd_scan(*_args(t), chunk=8)
    assert torch.equal(y0, y1) and torch.equal(fs0, fs1)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches on CUDA tensors or raises: on CPU
    tensors it refuses before building anything (``ssd_scan`` is what runs
    the plain version there)."""
    t = _t(_inputs(13, 1, 16, 2, 8, 4))
    before = K.launches["ssd_chunk"]
    with pytest.raises(ValueError, match="CUDA"):
        K.ssd_chunk(t["x"], t["dt"], t["A"], t["Bm"][:, :, None],
                    t["Cm"][:, :, None], t["s0"], chunk=8)
    assert K.launches["ssd_chunk"] == before


# (B, T, H, P, N, G, chunk, model ranges): test_ssd_sweep's shapes, G 2,
# Q 10 and 100, a ragged T, and the model's ranges (dt up to softplus(1),
# A down to -16)
PASSES_CASES = [
    (1, 32, 2, 8, 4, None, 8, False), (2, 128, 4, 16, 8, None, 32, False),
    (2, 250, 8, 32, 16, None, 64, False), (2, 64, 4, 8, 4, 2, 16, False),
    (2, 10, 4, 16, 16, None, 10, False), (2, 100, 4, 16, 16, None, 100, False),
    (2, 23, 4, 16, 16, None, 8, False), (1, 256, 4, 16, 16, None, 64, True),
]


def _passes(t, chunk):
    """``ssd_chunk_passes_ref`` on inputs padded as ``ssd_scan`` pads them,
    its outputs trimmed."""
    T = t["x"].shape[1]
    x, dt, Bm, Cm = O.pad_to_chunks(t["x"], t["dt"], t["Bm"], t["Cm"], chunk)
    y, fs, scratch = R.ssd_chunk_passes_ref(x, dt, t["A"], Bm, Cm, t["s0"],
                                            chunk=chunk)
    return y[:, :T], fs, scratch


@pytest.mark.parametrize("B,T,H,P,N,G,chunk,model", PASSES_CASES,
                         ids=["sweep-Q8", "sweep-Q32", "sweep-Q64", "G2",
                              "Q10", "Q100", "T23-Q8", "model-ranges"])
def test_passes_ref_matches_reference(B, T, H, P, N, G, chunk, model):
    """The four-pass mirror within 2e-4 of the reference's jnp chunked
    version, of its Pallas kernel in interpret mode (G 1; the reference
    falls back to jnp for G 2) and of its exact recurrence."""
    ranges = {"dt_hi": 1.3, "a_hi": 16.0} if model else {}
    a = _inputs(7 * T + chunk, B, T, H, P, N, G=G, **ranges)
    y, fs, _ = _passes(_t(a), chunk)
    assert y.shape == (B, T, H, P) and fs.shape == (B, H, P, N)
    jy, jfs = JO.ssd_scan(*_args(_j(a)), chunk=chunk, use_pallas=False)
    wants = [(jy, jfs)]
    if G is None:
        wants.append(JO.ssd_scan(*_args(_j(a)), chunk=chunk, use_pallas=True,
                                 interpret=True))
        wants.append(JR.ssd_sequential_ref(*_args(_j(a))))
    close = _close_scaled if model else _close
    for want_y, want_fs in wants:
        close(y, want_y)
        close(fs, want_fs)


@pytest.mark.parametrize("G,model", [(None, True), (2, False)],
                         ids=["model-ranges", "G2"])
def test_passes_ref_entering_states(G, model):
    """Pass 3's order: the state the mirror leaves in ``S[:, c]`` is the
    state ``ssd_chunked_ref`` carries into chunk c (its final state over
    the first c chunks), within 2e-4, and S[:, 0] is the initial state
    exactly; ``cum`` and ``CB`` are those of the chunked math."""
    B, T, H, P, N, Q = 2, 96, 4, 16, 8, 16
    ranges = {"dt_hi": 1.3, "a_hi": 16.0} if model else {}
    t = _t(_inputs(31, B, T, H, P, N, G=G, **ranges))
    y, fs, scratch = _passes(t, Q)
    S = scratch["S"]
    assert S.shape == (B, T // Q, H, N, P)
    assert torch.equal(S[:, 0], t["s0"].transpose(-1, -2))
    for c in range(1, T // Q):
        _, carried = R.ssd_chunked_ref(
            t["x"][:, :c * Q], t["dt"][:, :c * Q], t["A"], t["Bm"][:, :c * Q],
            t["Cm"][:, :c * Q], t["s0"], chunk=Q)
        _close(S[:, c].transpose(-1, -2), carried)
    cy, cfs = R.ssd_chunked_ref(*_args(t), chunk=Q)
    _close(y, cy)
    _close(fs, cfs)
    cum = torch.cumsum((t["dt"] * t["A"]).reshape(B, T // Q, Q, H), dim=2,
                       dtype=torch.float64).float().reshape(B, T, H)
    assert torch.equal(scratch["cum"], cum)
    bm = t["Bm"] if G else t["Bm"][:, :, None]
    cm = t["Cm"] if G else t["Cm"][:, :, None]
    i, j = 5, 3             # row i of chunk 1 against its column j <= i
    want = (cm[:, Q + i] * bm[:, Q + j]).sum(-1)
    _close(scratch["CB"][:, 1, :, j, i], want, 1e-5)
    assert not scratch["CB"][:, :, :, i, j].any()   # above the diagonal


@pytest.mark.parametrize("G,remat", [(None, False), (2, True)],
                         ids=["G1", "G2-remat"])
def test_k7_autograd_backward_is_the_plain_vjp(monkeypatch, G, remat):
    """The card's autograd Function (K7's forward, the plain chunked
    scan's VJP as its backward), run here with the plain version standing
    in for K7: the gradients of x, dt, A, B, C and the initial state equal
    autograd through the plain scan bit for bit and the reference's jnp
    chunked scan (its training path, ``use_pallas=False``) within 2e-4
    (1 + |want|); one forward a call (two under a non-reentrant
    checkpoint, whose recompute runs it again), one backward counted."""
    a = _inputs(21, 2, 32, 4, 8, 4, G=G)
    w = np.random.default_rng(22).normal(size=(2, 32, 4, 8)).astype(
        np.float32)
    calls = []

    def k7(x, dt, A, Bm, Cm, s0, *, chunk):
        calls.append(Bm.dim())
        return R.ssd_chunked_ref(x, dt, A, Bm, Cm, s0, chunk=chunk)

    monkeypatch.setattr(K, "ssd_chunk", k7)

    def run(scan):
        leaves = [t.requires_grad_(True) for t in _args(_t(a))]
        if remat:
            y, fs = torch.utils.checkpoint.checkpoint(
                scan, *leaves, use_reentrant=False)
        else:
            y, fs = scan(*leaves)
        ((y * torch.tensor(w)).sum() + fs.sum()).backward()
        return [t.grad for t in leaves]

    before = K.launches["ssd_chunk_plain_grad"]
    got = run(lambda *t: O._K7Scan.apply(*t, 8))
    assert K.launches["ssd_chunk_plain_grad"] == before + 1
    assert calls == [4] * (2 if remat else 1)
    plain = run(lambda *t: R.ssd_chunked_ref(*t, chunk=8))
    assert all(torch.equal(g, h) for g, h in zip(got, plain))

    def jloss(*args):
        y, fs = JO.ssd_scan(*args, chunk=8, use_pallas=False)
        return (y * w).sum() + fs.sum()

    want = jax.grad(jloss, argnums=tuple(range(6)))(*_args(_j(a)))
    for g, h in zip(got, want):
        _close_scaled(g, h)


def test_k7_autograd_skips_the_vjp_of_an_unused_output(monkeypatch):
    """A train step's loss reaches y and not the final state: the card's
    autograd Function then takes the VJP of y alone, the work and the
    gradients of autograd through the plain scan (bit for bit, FLOP for
    FLOP), with the plain version standing in for K7."""
    from torch.utils.flop_counter import FlopCounterMode

    a = _inputs(23, 2, 32, 4, 8, 4, G=2)
    w = torch.tensor(np.random.default_rng(24).normal(size=(2, 32, 4, 8)),
                     dtype=torch.float32)
    monkeypatch.setattr(K, "ssd_chunk", lambda *t, chunk: R.ssd_chunked_ref(
        *t, chunk=chunk))

    def run(scan):
        leaves = [t.requires_grad_(True) for t in _args(_t(a))]
        y, _ = scan(*leaves)
        with FlopCounterMode(display=False) as fc:
            (y * w).sum().backward()
        return [t.grad for t in leaves], fc.get_total_flops()

    got, got_flops = run(lambda *t: O._K7Scan.apply(*t, 8))
    plain, plain_flops = run(lambda *t: R.ssd_chunked_ref(*t, chunk=8))
    assert all(torch.equal(g, h) for g, h in zip(got, plain))
    # the backward recomputes the forward once more than autograd does
    with FlopCounterMode(display=False) as fc:
        R.ssd_chunked_ref(*_args(_t(a)), chunk=8)
    assert got_flops == plain_flops + fc.get_total_flops()
