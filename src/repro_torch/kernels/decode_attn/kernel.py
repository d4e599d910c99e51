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
MAX_SPLIT = 64                    # pieces a (sequence, kv head) at most
BLOCKS_PER_SM = 2                 # resident blocks of the partial kernel

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
                [_P] * 4 + [_I32] * 7 + [ctypes.c_float, _I32] + [_P] * 5
            )
            lib.da_decode_attn.restype = ctypes.c_int
            lib.da_max_group.restype = ctypes.c_int
            lib.da_tile_rows.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.da_tile_rows.restype = ctypes.c_int
            if lib.da_max_group() != MAX_GROUP or any(
                    lib.da_tile_rows(D, int(dt == torch.bfloat16))
                    != tile_rows(D, dt) for D in HEAD_DIMS
                    for dt in (torch.float32, torch.bfloat16)):
                raise RuntimeError("decode_attn.cu and kernel.py disagree on "
                                   "the largest query group or the tiles")
            _lib = lib
        return _lib


def tile_rows(D: int, dtype: torch.dtype) -> int:
    """Cache rows of one ring stage (``da_tile_rows``): 16 KB of K, 16 to
    128 rows; each piece of a split is a whole number of them."""
    esz = torch.finfo(dtype).bits // 8
    return max(16, min(128, 16384 // (D * esz)))


def split_count(bh: int, S: int, sms: int) -> int:
    """Pieces each (sequence, kv head) is cut into: enough that the B * Hkv
    (``bh``) rows of blocks cover two waves of ``BLOCKS_PER_SM`` blocks on
    each of ``sms`` SMs, but no more than S has 64-row tiles, nor
    ``MAX_SPLIT``.  It reads no lengths, so the host never waits on the
    card; the kernel cuts each valid range into this many equal pieces."""
    want = -(-2 * BLOCKS_PER_SM * sms // max(bh, 1))
    return max(1, min(want, -(-S // 64), MAX_SPLIT))


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
    n = split_count(
        B * Hkv, S, torch.cuda.get_device_properties(dev).multi_processor_count)
    # one scratch tensor: m and l (B, Hkv, n, G), then acc (B, Hkv, n, G, D)
    parts = B * Hkv * n * G
    scratch = torch.empty(parts * (D + 2), dtype=torch.float32, device=dev)
    base = scratch.data_ptr()
    with torch.cuda.device(dev):
        rc = _load().da_decode_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            B, S, Hkv, G, D, int(q.dtype == torch.bfloat16),
            -1 if window is None else int(window),
            float(D ** -0.5 if scale is None else scale), n,
            base, base + 4 * parts, base + 8 * parts,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"decode_attn kernel launch failed: CUDA error {rc}")
    launches["decode_attn"] += 1
    return out
