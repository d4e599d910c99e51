"""Build, bind and launch K7, the SSD chunked scan in four CUDA kernels.

``csrc/ssd_chunk.cu`` is compiled at first use with ``nvcc`` for
``sm_90a`` (:mod:`repro_torch.kernels._build`) and bound with
:mod:`ctypes`.  Nothing is built at import time: the CPU tests import this
module.  :func:`ssd_chunk` allocates the passes' scratch through
PyTorch's caching allocator (so a CUDA graph can capture the call) and
launches the four passes on CUDA tensors; it raises on anything it does
not take and never falls back to the plain version.
``launches["ssd_chunk"]`` counts its calls, one a call whatever the
number of passes; ``launches["ssd_chunk_plain_grad"]`` counts the
backward passes of :func:`~repro_torch.kernels.ssd_chunk.ops.ssd_scan` on
the card, each the plain scan's vector-Jacobian product (K7 has no
backward kernel).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build

_SRC = Path(__file__).parent / "csrc" / "ssd_chunk.cu"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

HEAD_DIMS = (8, 16, 32, 64)       # P: the instances K7 is held to
STATE_DIMS = (4, 8, 16, 128)      # N
MAX_CHUNK = 128                   # Q (kQMax)

launches = {"ssd_chunk": 0, "ssd_chunk_plain_grad": 0}

_P = ctypes.c_void_p
_I32 = ctypes.c_int32


def reset_launches() -> None:
    launches["ssd_chunk"] = 0
    launches["ssd_chunk_plain_grad"] = 0


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/ssd_chunk.cu`` (if this source hash is not built
    yet) and return the library path."""
    return _build.build(_SRC, verbose)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.ssd_chunk_scan.argtypes = [_P] * 9 + [_I32] * 7 + [_P]
            lib.ssd_chunk_scan.restype = ctypes.c_int
            lib.ssd_chunk_scratch_floats.argtypes = [_I32] * 7
            lib.ssd_chunk_scratch_floats.restype = ctypes.c_longlong
            lib.ssd_chunk_max_chunk.restype = ctypes.c_int
            if lib.ssd_chunk_max_chunk() != MAX_CHUNK:
                raise RuntimeError("ssd_chunk.cu and kernel.py disagree on "
                                   "the longest chunk")
            _lib = lib
        return _lib


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor, init_state: torch.Tensor,
              *, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K7 (replaces ``ssd_chunk_pallas``): x (B, T, H, P), dt (B, T, H),
    A (H,), Bm / Cm (B, T, G, N), init_state (B, H, P, N), all float32,
    contiguous, on one CUDA device, T a multiple of ``chunk``.  Returns
    (y (B, T, H, P), final_state (B, H, P, N)), both float32."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_chunk kernel: x on {dev}, expected CUDA")
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"ssd_chunk: x {tuple(x.shape)}, Bm "
                         f"{tuple(Bm.shape)} (expected 4-d)")
    B, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    want = {"x": (B, T, H, P), "dt": (B, T, H), "A": (H,),
            "Bm": (B, T, G, N), "Cm": (B, T, G, N),
            "init_state": (B, H, P, N)}
    got = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm,
           "init_state": init_state}
    for name, t in got.items():
        if t.device != dev:
            raise ValueError(f"ssd_chunk: {name} on {t.device}, x on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_chunk: {name} is {t.dtype}; the kernel "
                            "takes float32")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_chunk: {name} {tuple(t.shape)}, expected "
                             f"{want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_chunk: {name} not contiguous")
    if P not in HEAD_DIMS:
        raise ValueError(f"ssd_chunk: no instance for head dim {P} "
                         f"(have {HEAD_DIMS})")
    if N not in STATE_DIMS:
        raise ValueError(f"ssd_chunk: no instance for state dim {N} "
                         f"(have {STATE_DIMS})")
    if G < 1 or H % G:
        raise ValueError(f"ssd_chunk: {G} groups do not divide {H} heads")
    if not 1 <= chunk <= MAX_CHUNK or T % chunk:
        raise ValueError(f"ssd_chunk: chunk {chunk} (1 to {MAX_CHUNK}, "
                         f"dividing T {T})")
    lib = _load()
    n_scratch = lib.ssd_chunk_scratch_floats(B, T, H, P, G, N, chunk)
    if n_scratch < 0:
        raise ValueError(f"ssd_chunk: no instance for {tuple(x.shape)}, "
                         f"G {G}, N {N}, chunk {chunk}")
    # the kernels read x, B and C in 16-byte loads
    x, Bm, Cm = (t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (x, Bm, Cm))
    y = torch.empty_like(x)
    fs = torch.empty_like(init_state)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    rc = lib.ssd_chunk_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), init_state.data_ptr(), y.data_ptr(), fs.data_ptr(),
        scratch.data_ptr(), B, T, H, P, G, N, chunk,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: CUDA error {rc}")
    launches["ssd_chunk"] += 1
    return y, fs
