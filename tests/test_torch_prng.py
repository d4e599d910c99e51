"""The port's threefry2x32 stream is bit-identical to ``jax.random``
(``PRNGKey``, ``split``, ``fold_in``, ``randint``, ``uniform``) over
several seeds and shapes — the reason the whole EpochMetrics stream can
match the reference bit for bit.  No tolerance."""

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
