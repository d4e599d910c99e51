"""The port's threefry2x32 stream is bit-identical to ``jax.random``
(``PRNGKey``, ``split``, ``fold_in``, ``randint``, ``uniform``) over
several seeds and shapes — the reason the whole EpochMetrics stream can
match the reference bit for bit; ``normal`` too, through the port's
reproductions of XLA's float32 ``log1p`` and ``exp`` (``prng.log1p_f32``,
``prng.exp_f32``), pinned here on a few million seeded inputs.  No
tolerance."""

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

from repro_torch import prng

SEEDS = [0, 1, 3, 42, 2**31 - 1]
SHAPES = [(1,), (7,), (256, 2), (3, 5, 4)]
INT32_MAX = 2**31 - 1


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    k = jax.random.PRNGKey(seed)
    kt = prng.PRNGKey(seed)
    assert np.array_equal(np.asarray(k), kt)
    for num in (2, 3, 8):
        assert np.array_equal(np.asarray(jax.random.split(k, num)),
                              prng.split(kt, num))
    for data in (0, 1, 5, 2**31 + 7, 2**32 - 1):
        assert np.array_equal(np.asarray(jax.random.fold_in(k, data)),
                              prng.fold_in(kt, data))
    # the driver's chain: fold_in(PRNGKey(seed), e) -> split -> fold_in(ci)
    r_route, r_plan = jax.random.split(jax.random.fold_in(k, 3))
    t_route, t_plan = prng.split(prng.fold_in(kt, 3))
    assert np.array_equal(np.asarray(r_route), t_route)
    assert np.array_equal(np.asarray(jax.random.fold_in(r_route, 2)),
                          prng.fold_in(t_route, 2))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_randint_p2c_draw(seed, shape):
    k = jax.random.PRNGKey(seed)
    a = jax.random.randint(k, shape, 0, jnp.iinfo(jnp.int32).max,
                           dtype=jnp.int32)
    b = prng.randint(prng.PRNGKey(seed), shape, 0, INT32_MAX, "cpu")
    assert b.dtype == torch.int32
    assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("lo,hi", [(0, 8), (3, 11), (-5, 5), (7, 7)])
def test_randint_small_spans(lo, hi):
    for seed in (0, 9):
        a = jax.random.randint(jax.random.PRNGKey(seed), (64,), lo, hi,
                               dtype=jnp.int32)
        b = prng.randint(prng.PRNGKey(seed), (64,), lo, hi, "cpu")
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform(seed, shape):
    a = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                      jnp.float32))
    b = prng.uniform(prng.PRNGKey(seed), shape, "cpu").numpy()
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_uniform_tiny_minval():
    tiny = float(np.finfo(np.float32).tiny)
    k = jax.random.PRNGKey(5)
    a = np.asarray(jax.random.uniform(k, (512,), jnp.float32, minval=tiny))
    b = prng.uniform(prng.PRNGKey(5), (512,), "cpu", minval=tiny).numpy()
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


NORMAL_CASES = [(0, (200_000,)), (1, (400, 500)), (2, (200_000,)),
                (3, (1000, 200))]


@pytest.mark.parametrize("seed,shape", NORMAL_CASES)
def test_normal_matches_reference(seed, shape):
    """``prng.normal`` equals ``jax.random.normal`` bit for bit (before the
    port reproduced XLA's float32 log1p, 1,856-1,945 draws of these
    differed by up to 3 ulp: ROADMAP fault F14, repaired)."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                        jnp.float32))
    got = prng.normal(prng.PRNGKey(seed), shape, "cpu").numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _bits_equal(got: torch.Tensor, want) -> int:
    """The count of float32 values whose bits differ."""
    return int((got.numpy().view(np.int32)
                != np.asarray(want).view(np.int32)).sum())


# (seed, low, high): a few million seeded inputs over the ranges the
# draws reach (log1p: [-1, 0]; exp: the lognormal argument at sigma <= 1,
# and whisper's frequencies down to -9.21), and past them
FN_CASES = [(0, -1.0, 0.0), (1, -16.0, 8.0), (2, -88.0, 88.0)]


@pytest.mark.parametrize("seed,lo,hi", FN_CASES)
def test_exp_f32_matches_xla(seed, lo, hi):
    x = np.random.default_rng(seed).uniform(lo, hi, 1_000_000).astype(np.float32)
    want = jax.jit(jnp.exp)(x)
    assert _bits_equal(prng.exp_f32(torch.from_numpy(x)), want) == 0


@pytest.mark.parametrize("seed,lo,hi", FN_CASES)
def test_log1p_f32_matches_xla(seed, lo, hi):
    """Over [-1, 0] (the normal draw's ``-x * x``) and beyond it; the
    small inputs of [-1, 0] are drawn log-uniformly, where the rational
    branch and its cancellation live."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, 1_000_000).astype(np.float32)
    x = np.concatenate([x[x > -1.0], -np.exp2(rng.uniform(-126, 0, 500_000))
                        .astype(np.float32)])
    want = jax.jit(jnp.log1p)(x)
    assert _bits_equal(prng.log1p_f32(torch.from_numpy(x)), want) == 0


def test_erf_inv_matches_xla():
    """``prng.erf_inv`` against ``jax.jit(lax.erf_inv)`` on 2,000,000
    uniform draws of (-1, 1), bit for bit, both branches (``w >= 5`` is
    where an inexact square root showed)."""
    x = jax.random.uniform(jax.random.PRNGKey(11), (2_000_000,), jnp.float32,
                           np.nextafter(np.float32(-1), np.float32(0)), 1.0)
    want = jax.jit(jax.lax.erf_inv)(x)
    got = prng.erf_inv(torch.from_numpy(np.asarray(x).copy()))
    assert _bits_equal(got, want) == 0


def test_erf_inv_polynomial_given_xla_log1p():
    """Given XLA's own ``w = -log1p(-x * x)`` (jitted alone), the Horner
    steps as fused multiply-adds (``prng.fma_f32``) on the correctly
    rounded square root (``prng.sqrt_f32``) give jax's ``erf_inv`` bit
    for bit; the same steps unfused differ in 2,283 of 50,000 values
    (torch's own float32 ``sqrt`` on the CPU made 2 more differ, in the
    ``w >= 5`` branch)."""
    x = jax.random.uniform(jax.random.PRNGKey(11), (50_000,), jnp.float32,
                           np.nextafter(np.float32(-1), np.float32(0)), 1.0)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(x)).view(np.int32)
    w = np.asarray(jax.jit(lambda v: -jnp.log1p(-v * v))(x))
    xt = torch.from_numpy(np.asarray(x).copy())
    wt = torch.from_numpy(w.copy())
    lt = wt < 5.0
    wt = torch.where(lt, wt - 2.5, prng.sqrt_f32(wt) - 3.0)
    coef = lambda i: torch.where(lt, torch.tensor(prng._ERFINV_LT5[i]),
                                 torch.tensor(prng._ERFINV_GE5[i]))

    def ulps(fused):
        p = coef(0)
        for i in range(1, len(prng._ERFINV_LT5)):
            p = (prng.fma_f32(p, wt, coef(i)) if fused
                 else p * wt + coef(i))
        got = (p * xt).numpy().view(np.int32)
        return np.abs(got.astype(np.int64) - want)

    assert int((ulps(True) > 0).sum()) == 0
    assert int((ulps(False) > 0).sum()) == 2283


def test_fma_f32_rounds_once():
    """``fma_f32`` against an exact rational evaluation, rounded once."""
    from fractions import Fraction

    rng = np.random.default_rng(5)
    a, b, c = (rng.standard_normal(2000).astype(np.float32) for _ in range(3))
    c[:500] = -(a[:500].astype(np.float64) * b[:500]).astype(np.float32)
    got = prng.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(c)).numpy()
    for i in range(a.size):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        # the nearest float32 to the exact value, ties to even
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32)) & 1))
        assert got[i] == best, (i, a[i], b[i], c[i])
