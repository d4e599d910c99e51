"""Key spaces and hashing (counterpart of ``repro.core.keys``).

Keys, matching values and every uint32 register of the reference are
carried as ``int64`` tensors holding values in ``[0, 2**32)``: torch on
the CPU lacks uint32 comparison, addition, shifts, ``searchsorted``,
``min`` and ``index_add_``.  Every add and multiply is masked back to 32
bits (:func:`u32`), which reproduces uint32 wraparound exactly.
``EMPTY_KEY`` stays the largest key, so sorted slabs keep their order.
"""

from __future__ import annotations

import torch

KEY_BITS = 32
KEY_SPACE = 1 << KEY_BITS          # exclusive upper bound (python int)
MAX_KEY = KEY_SPACE - 1            # largest representable matching value
EMPTY_KEY = 0xFFFFFFFF             # slab sentinel: slot is unoccupied
MASK32 = 0xFFFFFFFF

OP_GET = 0
OP_PUT = 1
OP_DEL = 2
OP_SCAN = 3

OP_NAMES = {OP_GET: "GET", OP_PUT: "PUT", OP_DEL: "DEL", OP_SCAN: "SCAN"}


def u32(x: torch.Tensor) -> torch.Tensor:
    """Wrap an int64 tensor to its low 32 bits (uint32 arithmetic)."""
    return x & MASK32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """The int32 with the same low 32 bits as ``x`` (a uint32 value or a
    small signed int carried in int64): values of ``2**31`` and up wrap
    negative explicitly, without relying on an int64 -> int32 cast."""
    x = x.to(torch.int64) & MASK32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for ``x`` in ``[0, 2**32)`` without int64
    overflow: ``c`` is split into 16-bit halves, so every partial product
    stays below ``2**48`` (the same bits on CPU and CUDA)."""
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def hash_key(key: torch.Tensor) -> torch.Tensor:
    """Two rounds of the murmur3 fmix32 finalizer (``repro.core.keys``),
    in 32-bit arithmetic carried in int64."""
    x = u32(key.to(torch.int64))
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    x = mul32(x, 0x9E3779B1)
    x = x ^ (x >> 16)
    return x


def matching_value(keys: torch.Tensor, *, hash_partitioned: bool) -> torch.Tensor:
    """The value the switch matches against the table: the key itself
    under range partitioning, its hash under hash partitioning."""
    keys = u32(keys.to(torch.int64))
    return hash_key(keys) if hash_partitioned else keys
