"""Build, bind and launch K6, the decode-attention CUDA kernel.

``csrc/decode_attn.cu`` is compiled at first use with ``nvcc`` for
``sm_90a`` (:mod:`repro_torch.kernels._build`) and bound with
:mod:`ctypes`.  Nothing is built at import time: the CPU tests import this
module.  :func:`decode_attn` launches the kernel on CUDA tensors and
raises on anything it does not take; it never falls back to the plain
version.  ``launches["decode_attn"]`` counts its launches.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build

_SRC = Path(__file__).parent / "csrc" / "decode_attn.cu"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

HEAD_DIMS = (16, 64, 128, 256)    # the instances the source has
MAX_GROUP = 8                     # query heads a kv head (kGMax)
CHUNK = 512                       # cache rows of one block (flash-decoding split)

launches = {"decode_attn": 0}

_P = ctypes.c_void_p
_I32 = ctypes.c_int32


def reset_launches() -> None:
    launches["decode_attn"] = 0


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/decode_attn.cu`` (if this source hash is not built
    yet) and return the library path."""
    return _build.build(_SRC, verbose)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.da_decode_attn.argtypes = (
                [_P] * 4 + [_I32] * 7 + [ctypes.c_float, _I32, _I32]
                + [_P] * 5
            )
            lib.da_decode_attn.restype = ctypes.c_int
            lib.da_max_group.restype = ctypes.c_int
            if lib.da_max_group() != MAX_GROUP:
                raise RuntimeError("decode_attn.cu and kernel.py disagree on "
                                   "the largest query group")
            _lib = lib
        return _lib


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor, *, window: int | None = None,
                scale: float | None = None) -> torch.Tensor:
    """K6 (replaces ``decode_attn_pallas``): q (B, Hq, D) against the cache
    k / v (B, S, Hkv, D), all float32 or all bfloat16, contiguous, on one
    CUDA device; lengths (B,) int32.  Returns (B, Hq, D) in q's dtype."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attn kernel: q on {dev}, expected CUDA")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"decode_attn: q {tuple(q.shape)}, k {tuple(k.shape)}")
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"decode_attn: {name} on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"decode_attn: {name} is {t.dtype}, q {q.dtype}")
        if tuple(t.shape) != (B, S, Hkv, D):
            raise ValueError(f"decode_attn: {name} {tuple(t.shape)}, expected "
                             f"{(B, S, Hkv, D)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attn: no instance for {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attn: no instance for head dim {D} "
                         f"(have {HEAD_DIMS})")
    if S < 1 or Hkv < 1 or Hq % Hkv or not 1 <= Hq // Hkv <= MAX_GROUP:
        raise ValueError(f"decode_attn: S {S}, Hq {Hq}, Hkv {Hkv} (a kv head "
                         f"serves 1 to {MAX_GROUP} query heads)")
    if lengths.device != dev or lengths.dtype != torch.int32 \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"decode_attn: lengths {lengths.dtype} "
                         f"{tuple(lengths.shape)} on {lengths.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"decode_attn: {name} not contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attn: {name} not 16-byte aligned")
    if window is not None and window < 0:
        raise ValueError(f"decode_attn: window {window} < 0")
    out = torch.empty_like(q)
    if B == 0:
        return out
    G = Hq // Hkv
    n_chunks = -(-S // CHUNK)
    m_part = torch.empty((B, Hkv, n_chunks, G), dtype=torch.float32, device=dev)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((B, Hkv, n_chunks, G, D), dtype=torch.float32,
                           device=dev)
    rc = _load().da_decode_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        B, S, Hkv, G, D, int(q.dtype == torch.bfloat16),
        -1 if window is None else int(window),
        float(D ** -0.5 if scale is None else scale), CHUNK, n_chunks,
        m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"decode_attn kernel launch failed: CUDA error {rc}")
    launches["decode_attn"] += 1
    return out
