"""Bit-exact threefry2x32 counter-based PRNG (``jax.random``'s default).

The reference draws every random number with ``jax.random`` in the mode
the installed jax runs: the ``threefry2x32`` implementation with
``jax_threefry_partitionable=True``.  This module reproduces that stream
bit for bit, so a port driven from the same seed makes the same p2c
replica picks and service draws as the reference:

* a key is a host-side ``(2,)`` uint32 numpy array — the raw key data of
  ``jax.random.PRNGKey`` (``PRNGKey``, ``split`` and ``fold_in`` are tiny
  host computations and never touch the device);
* ``random_bits`` / ``randint`` / ``uniform`` hash a counter array on the
  requested device (int64 carriers, masked to 32 bits after every add).

Mapping to the reference source (``jax/_src/prng.py``, ``random.py``):
``threefry_seed`` -> :func:`PRNGKey`; ``_threefry2x32_lowering`` ->
:func:`threefry2x32`; ``_threefry_split_foldlike`` -> :func:`split`;
``_threefry_fold_in`` -> :func:`fold_in`;
``_threefry_random_bits_partitionable`` -> :func:`random_bits`;
``_randint`` -> :func:`randint`; ``_uniform`` -> :func:`uniform`.
``normal`` is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M


def _rounds(x0, x1, rots):
    for r in rots:
        x0 = (x0 + x1) & _M
        x1 = _rotl(x1, r) ^ x0
    return x0, x1


def threefry2x32(k1: int, k2: int, x0, x1):
    """The threefry2x32 block function on int64 arrays (numpy or torch)
    holding uint32 counters; ``k1``/``k2`` are the key words."""
    k1, k2 = int(k1) & _M, int(k2) & _M
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M
    x1 = (x1 + ks[1]) & _M
    x0, x1 = _rounds(x0, x1, _ROT0)
    x0, x1 = (x0 + ks[1]) & _M, (x1 + ks[2] + 1) & _M
    x0, x1 = _rounds(x0, x1, _ROT1)
    x0, x1 = (x0 + ks[2]) & _M, (x1 + ks[0] + 2) & _M
    x0, x1 = _rounds(x0, x1, _ROT0)
    x0, x1 = (x0 + ks[0]) & _M, (x1 + ks[1] + 3) & _M
    x0, x1 = _rounds(x0, x1, _ROT1)
    x0, x1 = (x0 + ks[1]) & _M, (x1 + ks[2] + 4) & _M
    x0, x1 = _rounds(x0, x1, _ROT0)
    x0, x1 = (x0 + ks[2]) & _M, (x1 + ks[0] + 5) & _M
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """Raw key data of ``jax.random.PRNGKey(seed)``: the seed's high and
    low 32-bit words."""
    seed = int(seed)
    if seed < 0:
        seed &= (1 << 64) - 1
    return np.array([(seed >> 32) & _M, seed & _M], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 subkeys."""
    hi = np.zeros(num, np.int64)
    lo = np.arange(num, dtype=np.int64)
    b0, b1 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([b0, b1], axis=1).astype(np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: hash ``data`` into the key."""
    b0, b1 = threefry2x32(
        key[0], key[1], np.zeros(1, np.int64),
        np.array([int(data) & _M], np.int64),
    )
    return np.array([b0[0], b1[0]], np.uint32)


def random_bits(key: np.ndarray, shape: tuple[int, ...],
                device: str | torch.device) -> torch.Tensor:
    """32-bit random words of ``shape`` (int64 tensor on ``device``)."""
    n = math.prod(shape)
    if n >= 1 << 32:
        raise NotImplementedError("random bits arrays of 2**32 or more words")
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return (b0 ^ b1).reshape(shape)


def randint(key: np.ndarray, shape: tuple[int, ...], minval: int, maxval: int,
            device: str | torch.device) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)``:
    an int32 tensor on ``device``."""
    i32_max = (1 << 31) - 1
    i32_min = -(1 << 31)
    out_of_range = maxval > i32_max
    lo_v = min(max(int(minval), i32_min), i32_max)
    hi_v = min(max(int(maxval), i32_min), i32_max)
    k1, k2 = split(key)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    span = (hi_v - lo_v) & _M
    if hi_v <= lo_v:
        span = 1
    if out_of_range and hi_v > lo_v:
        span = (span + 1) & _M
    if span == 0:  # span wrapped: the remainders below leave the bits as-is
        offset = (higher * 0 + lower) & _M
    else:
        mult = (1 << 16) % span
        mult = ((mult * mult) & _M) % span
        offset = ((((higher % span) * mult) & _M) + (lower % span)) & _M
        offset = offset % span
    val = (lo_v + offset) & _M
    val = torch.where(val >= (1 << 31), val - (1 << 32), val)
    return val.to(torch.int32)


def uniform(key: np.ndarray, shape: tuple[int, ...],
            device: str | torch.device, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape, device)
    float_bits = (bits >> 9) | 0x3F800000          # mantissa of [1, 2)
    floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo)
