"""Build + load the port's native DES event core (``des_core.c``), which
also holds the float32 power of the Pareto service draw (:func:`powf`).

Compiled once per source hash with the system C compiler into
``_native_cache/`` next to this file, and bound with ctypes.  If the core
cannot be built, :func:`load` raises and :func:`available` says so (with
the reason in :func:`unavailable_reason`); the engine then falls back to
the heapq oracle (:mod:`repro_torch.core.des`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).with_name("des_core.c")
_CACHE = Path(__file__).parent / "_native_cache"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None

_ARGTYPES = [
    ctypes.c_void_p,  # nodes (S,B,H) int32
    ctypes.c_void_p,  # service (S,B,H) float32
    ctypes.c_void_p,  # n_hops (S,B) int32
    ctypes.c_void_p,  # arrivals (S,B) float64 or NULL
    ctypes.c_int64,   # S
    ctypes.c_int64,   # B
    ctypes.c_int64,   # H
    ctypes.c_int64,   # K
    ctypes.c_int64,   # N
    ctypes.c_double,  # link
    ctypes.c_double,  # think
    ctypes.c_int32,   # mode_closed
    ctypes.c_void_p,  # scratch_node_free (N,) f64
    ctypes.c_void_p,  # scratch_hop (B,) i32
    ctypes.c_void_p,  # scratch_heap (B+1,2) f64
    ctypes.c_void_p,  # finish (S,B) f64
    ctypes.c_void_p,  # issue (S,B) f64
    ctypes.c_void_p,  # hop_done (S,B,H) f64 or NULL
]


def _build(out: Path) -> None:
    cc = os.environ.get("CC", "cc")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(out.parent))
    os.close(fd)
    try:
        res = subprocess.run(
            [cc, "-O2", "-shared", "-fPIC", "-o", tmp, str(_SRC), "-lm"],
            capture_output=True, text=True, timeout=120,
        )
        if res.returncode != 0:
            raise RuntimeError(f"building the DES core failed:\n{res.stderr}")
        os.replace(tmp, out)  # atomic under concurrent builders
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def powf(u: np.ndarray, e: float) -> np.ndarray:
    """``powf(u, e)`` elementwise over a float32 array, by the C library's
    float32 power (the reference's bits on the CPU)."""
    u = np.ascontiguousarray(u, dtype=np.float32)
    out = np.empty_like(u)
    load().des_powf(u.ctypes.data, float(np.float32(e)), out.ctypes.data,
                    u.size)
    return out


def available() -> bool:
    """Whether the core builds and loads here (tried once, then cached)."""
    global _error
    if _lib is not None:
        return True
    if _error is None:
        try:
            load()
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
    return _lib is not None


def unavailable_reason() -> str | None:
    """Why :func:`available` is false (None when it is true or untried)."""
    return None if _lib is not None else _error


def load() -> ctypes.CDLL:
    """The compiled core (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
            _CACHE.mkdir(parents=True, exist_ok=True)
            so = _CACHE / f"des_core_{tag}.so"
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.des_simulate_batch.restype = None
            lib.des_simulate_batch.argtypes = _ARGTYPES
            lib.des_powf.restype = None
            lib.des_powf.argtypes = [ctypes.c_void_p, ctypes.c_float,
                                     ctypes.c_void_p, ctypes.c_int64]
            _lib = lib
        return _lib
