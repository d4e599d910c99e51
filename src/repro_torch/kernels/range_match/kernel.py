"""Build, bind and launch the range_match CUDA kernels.

``csrc/range_match.cu`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface under
``build/repro_torch_kernels/`` at the root of the checkout (one library
per source hash, :mod:`repro_torch.kernels._build`), and bound with
:mod:`ctypes`.  Nothing is built or imported at module import time: the
CPU tests import this module.

Each wrapper takes the plain PyTorch version (:mod:`.ref`) when its
tensors lie on the CPU, and launches its kernel for CUDA tensors — or
raises.  There is no fallback from a CUDA tensor to the plain version.
``launches`` counts kernel launches per wrapper (plain-version calls do
not count), so a run can show that the main path went through the card.

The four route wrappers (K1, K2, K3, K4b) each launch two kernels through
one C entry point: ``span_order``, which writes the live spans in (lo,
slot id) order into a scratch buffer allocated here through PyTorch's
caching allocator (so a CUDA graph can capture the call), then the route
kernel, which searches that table.  Over at most 256 slots (the serving
router's table) the route kernel orders the spans itself, in one launch,
and writes the same table.  :func:`last_order` reads a wrapper's
last table and the match pass it took ("search" over disjoint spans,
"exhaustive" over overlapping ones).

K5 (``range_match_stale``) runs ``span_order`` over its W switch copies
in one launch, a table a copy, then ``stale_kernel``, which decides the
pass of each copy on its own; :func:`last_stale_order` reads the W
tables and passes back.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import torch

from repro_torch.device import on_cpu
from repro_torch.kernels import _build
from repro_torch.kernels.range_match import ref

_SRC = Path(__file__).parent / "csrc" / "range_match.cu"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

launches = {"range_match": 0, "range_match_spread": 0,
            "range_match_spread_dirty": 0, "range_match_apply": 0,
            "slab_lookup": 0, "range_match_stale": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32

MAX_ROUTE_SLOTS = 0xFFFF          # the route kernels stage 16-bit slot ids
MATCH_PASSES = {1: "search", 2: "exhaustive"}

# The last scratch buffer of each wrapper that orders spans (its sorted
# span tables), with its copies W and slots S.
_orders: dict[str, tuple[torch.Tensor, int, int]] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/range_match.cu`` (if this source hash is not built
    yet) and return the library path."""
    return _build.build(_SRC, verbose)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.rm_range_match.argtypes = (
                [_P] * 6 + [_I64, _I32, _I32, _I32, _I32] + [_P] * 5
            )
            lib.rm_range_match_spread.argtypes = (
                [_P] * 9 + [_I64, _I32, _I32, _I32, _I32, _I32] + [_P] * 5
            )
            lib.rm_range_match_spread_dirty.argtypes = (
                [_P] * 12 + [_I64, _I32, _I32, _I32, _I32, _I32, _I32]
                + [_P] * 7
            )
            lib.rm_range_match_apply.argtypes = (
                [_P] * 12 + [_I64, _I32, _I32, _I32, _I32, _I64, _I64, _I32]
                + [_P] * 9
            )
            lib.rm_order_bytes.argtypes = [_I32, _I32]
            lib.rm_order_bytes.restype = _I64
            if lib.rm_order_bytes(1001, 3) != _order_bytes(1001, 3):
                raise RuntimeError("range_match.cu and kernel.py disagree on "
                                   "the sorted span table's layout")
            lib.rm_route_smem_bytes.argtypes = [_I32] * 4
            lib.rm_route_smem_bytes.restype = _I64
            if any(lib.rm_route_smem_bytes(m, 1001, 3, 7)
                   != _route_smem(m, 1001, 3, 7) for m in range(4)):
                raise RuntimeError("range_match.cu and kernel.py disagree on "
                                   "the route kernel's shared memory")
            lib.rm_slab_lookup.argtypes = [_P] * 3 + [_I64] * 3 + [_P] * 3
            lib.rm_range_match_stale.argtypes = (
                [_P] * 8 + [_I64, _I32, _I32, _I32, _I32, _I32, _I32]
                + [_P] * 5
            )
            lib.rm_max_smem_optin.argtypes = [ctypes.c_int]
            for fn in (lib.rm_range_match, lib.rm_range_match_spread,
                       lib.rm_range_match_spread_dirty,
                       lib.rm_range_match_apply, lib.rm_slab_lookup,
                       lib.rm_range_match_stale, lib.rm_max_smem_optin):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    return _load().rm_max_smem_optin(index)


def _grid(B: int, device: torch.device) -> int:
    return max(1, min((B + 255) // 256, 4 * _sm_count(device.index)))


def _order_bytes(S: int, W: int = 1) -> int:
    """Bytes of W sorted span tables of S slots: a 16-byte header a copy
    (the live count, the match pass), then W x S (lo, hi) pairs and W x S
    16-bit slot ids."""
    return W * (16 + 10 * S)


# the route kernel's mode of each route wrapper (range_match.cu kTail ..
# kApply)
_ROUTE_MODE = {"range_match": 0, "range_match_spread": 1,
               "range_match_spread_dirty": 2, "range_match_apply": 3}


def _route_smem(mode: int, S: int, r_max: int, n_loads: int) -> int:
    """Shared-memory bytes a route block stages (range_match.cu
    ``route_smem``): the (lo, hi) spans, chains, chain lengths, the load
    registers from K2 on, the 16-bit slot ids, the dirty bytes from K3 on,
    each table on a 16-byte boundary."""
    a = lambda x: (x + 15) & ~15
    chain = a(8 * S)
    clen = a(chain + 4 * r_max * S)
    loads = a(clen + 4 * S)
    ids = a(loads + (4 * n_loads if mode >= 1 else 0))
    dirty = a(ids + 2 * S)
    return a(dirty + (r_max * S if mode >= 2 else 0))


def _check_smem(name: str, S: int, r_max: int, n_loads: int,
                dev: torch.device) -> None:
    """Raise when route wrapper ``name``'s tables (a grown slot pool, say)
    pass the 16-bit slot ids or the shared memory a block may opt in to:
    no plain fallback."""
    _check_ids(name, S)
    need = _route_smem(_ROUTE_MODE[name], S, r_max, n_loads)
    limit = _smem_optin(torch.cuda.current_device() if dev.index is None
                        else dev.index)
    if need > limit:
        raise ValueError(f"{name}: tables of {S} slots x r_max {r_max} need "
                         f"{need} B of shared memory, over the {limit} B a "
                         "block may opt in to")


def _check_ids(name: str, S: int) -> None:
    if S > MAX_ROUTE_SLOTS:
        raise ValueError(f"{name}: {S} slots, over the {MAX_ROUTE_SLOTS} "
                         "that 16-bit slot ids can name")


def _order(name: str, S: int, dev: torch.device) -> torch.Tensor:
    """A fresh scratch buffer for route wrapper ``name``'s sorted span
    table."""
    _check_ids(name, S)
    scratch = torch.empty(_order_bytes(S), dtype=torch.uint8, device=dev)
    _orders[name] = (scratch, 1, S)
    return scratch


def _read_orders(name: str) -> list[dict]:
    """Wrapper ``name``'s last W sorted span tables, read back to the
    host."""
    scratch, W, S = _orders[name]
    scratch = scratch.cpu()
    header = scratch[:16 * W].view(torch.int32).reshape(W, 4)
    base = 16 * W
    spans = (scratch[base:base + 8 * W * S].view(torch.int32).to(torch.int64)
             & 0xFFFFFFFF).reshape(W, S, 2)
    base += 8 * W * S
    ids = (scratch[base:base + 2 * W * S].view(torch.int16).to(torch.int64)
           & 0xFFFF).reshape(W, S)
    out = []
    for w in range(W):
        n = int(header[w, 0])
        out.append({"n_live": n, "match": MATCH_PASSES.get(int(header[w, 1])),
                    "lo": spans[w, :n, 0], "hi": spans[w, :n, 1],
                    "id": ids[w, :n]})
    return out


def last_order(name: str) -> dict:
    """The sorted span table of route wrapper ``name``'s last launch, read
    back to the host (this waits for the device): ``n_live``, the live
    spans' ``lo``, ``hi`` (uint32 values as int64) and slot ``id`` in
    (lo, id) order, and ``match``, the pass its route kernel took."""
    return _read_orders(name)[0]


def last_stale_order() -> list[dict]:
    """K5's last W sorted span tables, one dict a switch copy as
    :func:`last_order` gives it; ``match`` is the pass that copy took."""
    return _read_orders("range_match_stale")


def range_match(mvals, opcodes, slot_lo, slot_hi, chains, chain_len, *,
                num_slots: int):
    """K1 (replaces ``range_match_pallas``): ``(ridx, target, chain)``.

    mvals (B,) int64; opcodes (B,) int32; slot_lo / slot_hi (S,) int32
    (uint32 bits, dead-masked); chains (r_max, S) int32; chain_len (S,)
    int32.  Returns int32 ``ridx (B,)``, ``target (B,)``, ``chain
    (r_max, B)``."""
    if on_cpu(mvals, opcodes, slot_lo, slot_hi, chains, chain_len):
        return ref.range_match_ref(mvals, opcodes, slot_lo, slot_hi, chains,
                                   chain_len, num_slots=num_slots)
    dev = mvals.device
    B = mvals.shape[0]
    r_max, S = chains.shape
    _check("mvals", mvals, torch.int64, (B,), dev)
    _check("opcodes", opcodes, torch.int32, (B,), dev)
    for name, t in (("slot_lo", slot_lo), ("slot_hi", slot_hi),
                    ("chain_len", chain_len)):
        _check(name, t, torch.int32, (S,), dev)
    _check("chains", chains, torch.int32, (r_max, S), dev)
    if not 1 <= num_slots <= S:
        raise ValueError(f"num_slots {num_slots} outside [1, {S}]")
    ridx, target, chain = _route_outputs(B, r_max, dev)
    if B == 0:
        return ridx, target, chain
    _check_smem("range_match", S, r_max, 0, dev)
    rc = _load().rm_range_match(
        mvals.data_ptr(), opcodes.data_ptr(), slot_lo.data_ptr(),
        slot_hi.data_ptr(), chains.data_ptr(), chain_len.data_ptr(),
        B, S, r_max, num_slots, _grid(B, dev),
        _order("range_match", S, dev).data_ptr(), ridx.data_ptr(),
        target.data_ptr(), chain.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "range_match")
    launches["range_match"] += 1
    return ridx, target, chain


def range_match_spread(mvals, opcodes, u1, u2, slot_lo, slot_hi, chains,
                       chain_len, loads, *, num_slots: int):
    """K2 (replaces ``range_match_spread_pallas``): K1 plus the p2c read
    pick.  u1 / u2 (B,) int32 non-negative draws; loads (N,) int32 (uint32
    bits of the load registers)."""
    if on_cpu(mvals, opcodes, u1, u2, slot_lo, slot_hi, chains, chain_len,
               loads):
        return ref.range_match_spread_ref(
            mvals, opcodes, u1, u2, slot_lo, slot_hi, chains, chain_len,
            loads, num_slots=num_slots,
        )
    dev, B, r_max, S, n = _check_spread(mvals, opcodes, u1, u2, slot_lo,
                                        slot_hi, chains, chain_len, loads,
                                        num_slots)
    ridx, target, chain = _route_outputs(B, r_max, dev)
    if B == 0:
        return ridx, target, chain
    _check_smem("range_match_spread", S, r_max, n, dev)
    rc = _load().rm_range_match_spread(
        mvals.data_ptr(), opcodes.data_ptr(), u1.data_ptr(), u2.data_ptr(),
        slot_lo.data_ptr(), slot_hi.data_ptr(), chains.data_ptr(),
        chain_len.data_ptr(), loads.data_ptr(), B, S, r_max, num_slots, n,
        _grid(B, dev), _order("range_match_spread", S, dev).data_ptr(),
        ridx.data_ptr(), target.data_ptr(), chain.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "range_match_spread")
    launches["range_match_spread"] += 1
    return ridx, target, chain


def _check_spread(mvals, opcodes, u1, u2, slot_lo, slot_hi, chains,
                  chain_len, loads, num_slots):
    """Checks shared by K2, K3 and K4b; returns ``(device, B, r_max, S,
    n_loads)``."""
    dev = mvals.device
    B = mvals.shape[0]
    r_max, S = chains.shape
    n = loads.shape[0]
    _check("mvals", mvals, torch.int64, (B,), dev)
    for name, t in (("opcodes", opcodes), ("u1", u1), ("u2", u2)):
        _check(name, t, torch.int32, (B,), dev)
    for name, t in (("slot_lo", slot_lo), ("slot_hi", slot_hi),
                    ("chain_len", chain_len)):
        _check(name, t, torch.int32, (S,), dev)
    _check("chains", chains, torch.int32, (r_max, S), dev)
    _check("loads", loads, torch.int32, (n,), dev)
    if not 1 <= num_slots <= S:
        raise ValueError(f"num_slots {num_slots} outside [1, {S}]")
    return dev, B, r_max, S, n


def _route_outputs(B: int, r_max: int, dev, dirty: bool = False):
    """Empty ``(ridx, target, chain)`` and, for K3/K4b, ``(picked,
    bounced)`` output tensors."""
    out = (torch.empty(B, dtype=torch.int32, device=dev),
           torch.empty(B, dtype=torch.int32, device=dev),
           torch.empty((r_max, B), dtype=torch.int32, device=dev))
    if dirty:
        out += (torch.empty(B, dtype=torch.int32, device=dev),
                torch.empty(B, dtype=torch.bool, device=dev))
    return out


def range_match_spread_dirty(mvals, opcodes, u1, u2, slot_lo, slot_hi, chains,
                             chain_len, loads, dirty, keys=None,
                             key_filter=None, *, num_slots: int):
    """K3 (replaces ``range_match_spread_dirty_pallas``): K2 plus the CRAQ
    tail bounce.  dirty (r_max, S) uint8; with the hashed key filter,
    keys (B,) int64 raw keys and key_filter (S, F) bool (F = 0 or None
    turns it off).  Returns int32 ``ridx``, ``target``, ``chain (r_max,
    B)``, ``picked`` and bool ``bounced``."""
    F = 0 if key_filter is None else key_filter.shape[1]
    extra = (keys, key_filter) if F else ()
    if on_cpu(mvals, opcodes, u1, u2, slot_lo, slot_hi, chains, chain_len,
               loads, dirty, *extra):
        return ref.range_match_spread_dirty_ref(
            mvals, opcodes, u1, u2, slot_lo, slot_hi, chains, chain_len,
            loads, dirty, keys, key_filter, num_slots=num_slots,
        )
    dev, B, r_max, S, n = _check_spread(mvals, opcodes, u1, u2, slot_lo,
                                        slot_hi, chains, chain_len, loads,
                                        num_slots)
    _check("dirty", dirty, torch.uint8, (r_max, S), dev)
    if F:
        _check("keys", keys, torch.int64, (B,), dev)
        _check("key_filter", key_filter, torch.bool, (S, F), dev)
    out = _route_outputs(B, r_max, dev, dirty=True)
    if B == 0:
        return out
    _check_smem("range_match_spread_dirty", S, r_max, n, dev)
    rc = _load().rm_range_match_spread_dirty(
        mvals.data_ptr(), opcodes.data_ptr(), u1.data_ptr(), u2.data_ptr(),
        slot_lo.data_ptr(), slot_hi.data_ptr(), chains.data_ptr(),
        chain_len.data_ptr(), loads.data_ptr(), dirty.data_ptr(),
        keys.data_ptr() if F else None, key_filter.data_ptr() if F else None,
        B, S, r_max, num_slots, n, F, _grid(B, dev),
        _order("range_match_spread_dirty", S, dev).data_ptr(),
        *(t.data_ptr() for t in out),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "range_match_spread_dirty")
    launches["range_match_spread_dirty"] += 1
    return out


def range_match_apply(mvals, opcodes, u1, u2, slot_lo, slot_hi, chains,
                      chain_len, loads, dirty, qkeys, slabs, *,
                      num_slots: int):
    """K4b (replaces ``range_match_apply_pallas``): K3 without the key
    filter, then K4a's probe of ``qkeys`` (B,) int64 in the serving node's
    row of ``slabs`` (N, C) int64, in one pass.  Returns K3's five outputs
    plus int32 ``slot`` and bool ``found``."""
    if on_cpu(mvals, opcodes, u1, u2, slot_lo, slot_hi, chains, chain_len,
               loads, dirty, qkeys, slabs):
        return ref.range_match_apply_ref(
            mvals, opcodes, u1, u2, slot_lo, slot_hi, chains, chain_len,
            loads, dirty, qkeys, slabs, num_slots=num_slots,
        )
    dev, B, r_max, S, n = _check_spread(mvals, opcodes, u1, u2, slot_lo,
                                        slot_hi, chains, chain_len, loads,
                                        num_slots)
    N, C = slabs.shape
    _check("dirty", dirty, torch.uint8, (r_max, S), dev)
    _check("qkeys", qkeys, torch.int64, (B,), dev)
    _check("slabs", slabs, torch.int64, (N, C), dev)
    if C < 1:
        raise ValueError("slabs: empty rows")
    out = _route_outputs(B, r_max, dev, dirty=True) + (
        torch.empty(B, dtype=torch.int32, device=dev),
        torch.empty(B, dtype=torch.bool, device=dev))
    if B == 0:
        return out
    _check_smem("range_match_apply", S, r_max, n, dev)
    rc = _load().rm_range_match_apply(
        mvals.data_ptr(), opcodes.data_ptr(), u1.data_ptr(), u2.data_ptr(),
        slot_lo.data_ptr(), slot_hi.data_ptr(), chains.data_ptr(),
        chain_len.data_ptr(), loads.data_ptr(), dirty.data_ptr(),
        qkeys.data_ptr(), slabs.data_ptr(), B, S, r_max, num_slots, n, N, C,
        _grid(B, dev), _order("range_match_apply", S, dev).data_ptr(),
        *(t.data_ptr() for t in out),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "range_match_apply")
    launches["range_match_apply"] += 1
    return out


def range_match_stale(keys, opcodes, lo_w, hi_w, chains_w, clen_w, version_w,
                      committed, *, num_slots: int,
                      hash_partitioned: bool = False):
    """K5 (replaces ``range_match_stale_pallas``): each packet matched
    against its ingress switch's table copy.  ``(sridx, server,
    divergent)``.

    keys (B,) int64 raw keys (the ingress switch is ``hash_key(key) % W``
    and, with ``hash_partitioned``, the matching value is the hash);
    opcodes (B,) int32; lo_w / hi_w (W, S) int32 (uint32 bits,
    dead-masked); chains_w (W * r_max, S) int32 switch-major; clen_w (W, S)
    int32; version_w (W, S) and committed (S,) int32 (uint32 bits).
    Returns int32 ``sridx``, int32 ``server`` (chain head for PUT/DEL, tail
    otherwise) and bool ``divergent``.  Raises when the W copies of the
    spans and a word a copy (8 W S + 4 W bytes) exceed a block's shared
    memory, or S exceeds the 65,535 slots that 16-bit ids name."""
    if on_cpu(keys, opcodes, lo_w, hi_w, chains_w, clen_w, version_w,
               committed):
        return ref.range_match_stale_ref(
            keys, opcodes, lo_w, hi_w, chains_w, clen_w, version_w, committed,
            num_slots=num_slots, hash_partitioned=hash_partitioned)
    dev = keys.device
    B = keys.shape[0]
    W, S = lo_w.shape
    r_max = chains_w.shape[0] // max(W, 1)
    _check("keys", keys, torch.int64, (B,), dev)
    _check("opcodes", opcodes, torch.int32, (B,), dev)
    for name, t in (("lo_w", lo_w), ("hi_w", hi_w), ("clen_w", clen_w),
                    ("version_w", version_w)):
        _check(name, t, torch.int32, (W, S), dev)
    _check("chains_w", chains_w, torch.int32, (W * r_max, S), dev)
    _check("committed", committed, torch.int32, (S,), dev)
    if W < 1 or r_max < 1 or not 1 <= num_slots <= S:
        raise ValueError(f"bad tables: W {W}, r_max {r_max}, "
                         f"num_slots {num_slots}, S {S}")
    _check_ids("range_match_stale", S)
    lib = _load()
    smem, limit = 8 * W * S + 4 * W, _smem_optin(
        torch.cuda.current_device() if dev.index is None else dev.index)
    if smem > limit:
        raise ValueError(f"range_match_stale: the {W} switches' spans need "
                         f"{smem} B of shared memory, over the {limit} B a "
                         "block may opt in to")
    sridx = torch.empty(B, dtype=torch.int32, device=dev)
    server = torch.empty(B, dtype=torch.int32, device=dev)
    divergent = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return sridx, server, divergent
    scratch = torch.empty(_order_bytes(S, W), dtype=torch.uint8, device=dev)
    _orders["range_match_stale"] = (scratch, W, S)
    rc = lib.rm_range_match_stale(
        keys.data_ptr(), opcodes.data_ptr(), lo_w.data_ptr(), hi_w.data_ptr(),
        chains_w.data_ptr(), clen_w.data_ptr(), version_w.data_ptr(),
        committed.data_ptr(), B, S, W, r_max, num_slots,
        int(bool(hash_partitioned)), _grid(B, dev), scratch.data_ptr(),
        sridx.data_ptr(), server.data_ptr(), divergent.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "range_match_stale")
    launches["range_match_stale"] += 1
    return sridx, server, divergent


def slab_lookup(qkeys, target, slabs):
    """K4a (replaces ``slab_lookup_pallas``): ``(slot int32, found bool)``.

    qkeys (B,) int64; target (B,) int64; slabs (N, C) int64 sorted rows."""
    if on_cpu(qkeys, target, slabs):
        return ref.slab_lookup_ref(qkeys, target, slabs)
    dev = qkeys.device
    B = qkeys.shape[0]
    N, C = slabs.shape
    _check("qkeys", qkeys, torch.int64, (B,), dev)
    _check("target", target, torch.int64, (B,), dev)
    _check("slabs", slabs, torch.int64, (N, C), dev)
    if C < 1:
        raise ValueError("slabs: empty rows")
    slot = torch.empty(B, dtype=torch.int32, device=dev)
    found = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return slot, found
    rc = _load().rm_slab_lookup(
        qkeys.data_ptr(), target.data_ptr(), slabs.data_ptr(), B, N, C,
        slot.data_ptr(), found.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "slab_lookup")
    launches["slab_lookup"] += 1
    return slot, found
