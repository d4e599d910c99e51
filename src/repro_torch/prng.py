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
``_randint`` -> :func:`randint`; ``_uniform`` -> :func:`uniform`;
``_normal_real`` -> :func:`normal` (XLA's ``ErfInv32`` polynomial with
fused multiply-adds, :func:`fma_f32`, on ``torch.log1p``: within a few
ulp of the reference, ROADMAP fault F14).
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


def fma_f32(a, b, c) -> torch.Tensor:
    """``fma(a, b, c)`` of float32 operands with ONE rounding to float32,
    as XLA's CPU backend contracts ``a * b + c``.  The product is exact in
    float64; the float64 sum is rounded to odd (Knuth's two-sum gives its
    error), so the final rounding to float32 is exact too."""
    a, b, c = (torch.as_tensor(x).to(torch.float32).to(torch.float64)
               for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


# XLA's ErfInv32 (the Giles single-precision polynomial), highest power
# first: for w < 5 on w - 2.5, otherwise on sqrt(w) - 3
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: ``w = -log1p(-x * x)``, then the Horner
    steps of the polynomial as fused multiply-adds.  ``torch.log1p`` in
    float64, rounded once to float32 (the same bits on every device),
    stands in for XLA's float32 log1p: the one source of difference."""
    w = -torch.log1p((-x * x).to(torch.float64)).to(torch.float32)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = lambda i: torch.where(
        lt, torch.tensor(_ERFINV_LT5[i], dtype=torch.float32, device=x.device),
        torch.tensor(_ERFINV_GE5[i], dtype=torch.float32, device=x.device))
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = fma_f32(p, w, coef(i))
    out = p * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, out)


SQRT2_F32 = np.float32(np.sqrt(2.0))


def normal_erf_inv(key: np.ndarray, shape: tuple[int, ...],
                   device: str | torch.device) -> torch.Tensor:
    """The normal draw before its ``sqrt(2)`` factor: ``erf_inv(u)`` of a
    uniform draw on ``[nextafter(-1, 0), 1)`` (a caller that scales the
    draw by a constant folds ``sqrt(2)`` into it, as XLA does)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return erf_inv(uniform(key, shape, device, minval=lo, maxval=1.0))


def normal(key: np.ndarray, shape: tuple[int, ...],
           device: str | torch.device) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) *
    erf_inv(u)``."""
    return SQRT2_F32 * normal_erf_inv(key, shape, device)
