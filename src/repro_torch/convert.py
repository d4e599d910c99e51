"""Carry state between the JAX reference and the port, as numpy arrays.

The ``*_from_numpy`` functions take the reference's state (a Directory's,
a StoreState's, a count-min sketch's, the load registers', the
replication register file's, the coordination tier's or the overload
plane's arrays, a model's
parameter pytree or its decode cache, each converted with
``np.asarray``) and build the port's tensors on a device;
the ``*_to_numpy`` inverses return arrays in the reference's dtypes, so a
test can start both packages from one state and compare the results.
Nothing here imports the reference: the arrays are duck-typed by field
name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.coordination_tier.state import CoordState
from repro_torch.core.directory import Directory
from repro_torch.core.store import StoreState
from repro_torch.device import resolve_device
from repro_torch.overload.state import OverloadState
from repro_torch.replication.state import ReplState

DIRECTORY_FIELDS = ("slot_lo", "slot_hi", "live", "chains", "chain_len",
                    "parent", "generation", "node_addr", "read_count",
                    "write_count")
_DIRECTORY_DTYPES = {
    "slot_lo": np.uint32, "slot_hi": np.uint32, "live": np.bool_,
    "chains": np.int32, "chain_len": np.int32, "parent": np.int32,
    "generation": np.int32, "node_addr": np.int32, "read_count": np.uint32,
    "write_count": np.uint32,
}


def _t(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype != np.bool_:
        a = a.astype(np.int64)
    return torch.tensor(a, device=device)


def directory_from_numpy(arrays, *, hash_partitioned: bool = False,
                         device=None) -> Directory:
    """``arrays``: a mapping (or object with attributes) of the
    Directory's ten table fields."""
    dev = resolve_device(device)
    get = arrays.__getitem__ if isinstance(arrays, dict) else (
        lambda k: getattr(arrays, k))
    return Directory(**{f: _t(get(f), dev) for f in DIRECTORY_FIELDS},
                     hash_partitioned=hash_partitioned)


def directory_to_numpy(directory: Directory) -> dict[str, np.ndarray]:
    return {f: getattr(directory, f).cpu().numpy().astype(_DIRECTORY_DTYPES[f])
            for f in DIRECTORY_FIELDS}


def store_from_numpy(keys, values, overflow, *, device=None) -> StoreState:
    dev = resolve_device(device)
    return StoreState(
        keys=_t(keys, dev),
        values=torch.tensor(np.asarray(values, np.float32), device=dev),
        overflow=_t(overflow, dev),
    )


def store_to_numpy(store: StoreState) -> dict[str, np.ndarray]:
    return {
        "keys": store.keys.cpu().numpy().astype(np.uint32),
        "values": store.values.cpu().numpy(),
        "overflow": store.overflow.cpu().numpy().astype(np.int32),
    }


def sketch_from_numpy(sketch, *, device=None) -> torch.Tensor:
    return _t(sketch, resolve_device(device))


def sketch_to_numpy(sketch: torch.Tensor) -> np.ndarray:
    return sketch.cpu().numpy().astype(np.uint32)


def load_reg_from_numpy(load_reg, *, device=None) -> torch.Tensor:
    return _t(load_reg, resolve_device(device))


def load_reg_to_numpy(load_reg: torch.Tensor) -> np.ndarray:
    return load_reg.cpu().numpy().astype(np.uint32)


def repl_from_numpy(state, *, device=None) -> ReplState:
    """The replication register file (``version``, ``acked``,
    ``key_filter`` attributes) on ``device``."""
    dev = resolve_device(device)
    return ReplState(version=_t(state.version, dev), acked=_t(state.acked, dev),
                     key_filter=_t(state.key_filter, dev))


def repl_to_numpy(state: ReplState) -> dict[str, np.ndarray]:
    return {"version": state.version.cpu().numpy().astype(np.uint32),
            "acked": state.acked.cpu().numpy().astype(np.uint32),
            "key_filter": state.key_filter.cpu().numpy()}


COORD_FIELDS = tuple(f.name for f in dataclasses.fields(CoordState))
_COORD_DTYPES = {
    "slot_lo": np.uint32, "slot_hi": np.uint32, "live": np.bool_,
    "chains": np.int32, "chain_len": np.int32, "version": np.uint32,
    "committed": np.uint32, "pend_lo": np.uint32, "pend_hi": np.uint32,
    "pend_live": np.bool_, "pend_chains": np.int32, "pend_clen": np.int32,
    "pend_version": np.uint32, "install_at": np.int32,
}


def coord_from_numpy(state, *, device=None) -> CoordState:
    """The coordination tier's state (the reference's ``CoordState`` or a
    mapping of its fourteen leaves) on ``device``."""
    dev = resolve_device(device)
    get = state.__getitem__ if isinstance(state, dict) else (
        lambda k: getattr(state, k))
    return CoordState(**{f: _t(get(f), dev) for f in COORD_FIELDS})


def coord_to_numpy(state: CoordState) -> dict[str, np.ndarray]:
    return {f: getattr(state, f).cpu().numpy().astype(_COORD_DTYPES[f])
            for f in COORD_FIELDS}


OVERLOAD_FIELDS = tuple(f.name for f in dataclasses.fields(OverloadState))


def overload_to_numpy(state: OverloadState) -> dict[str, np.ndarray]:
    """Every leaf as a numpy array (int32 registers and counters, float32
    ``admit_prob``), in the reference's dtypes."""
    return {f: getattr(state, f).cpu().numpy() for f in OVERLOAD_FIELDS}


def _float_tensor(a, device, dtype: torch.dtype | None) -> torch.Tensor:
    """A float array (bfloat16 arrives as numpy's ml_dtypes extension
    type, which torch cannot read: it goes through float32, exactly) as a
    tensor of ``dtype`` (default: the array's own)."""
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"
    t = torch.tensor(a.astype(np.float32) if bf16 else a, device=device)
    if dtype is None:
        dtype = torch.bfloat16 if bf16 else t.dtype
    return t.to(dtype)


def _tree_from_numpy(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, device, dtype) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.kind in "iub":
        return torch.tensor(a, device=device)
    return _float_tensor(a, device, dtype)


def params_from_numpy(cfg, tree, device=None, dtype: torch.dtype | None = None):
    """The reference's parameter pytree (nested dicts of numpy arrays) ->
    the port's dict of tensors, leaf for leaf (every family's tree: the
    ``moe`` router / experts / ``shared`` leaves, a pair's ``a`` / ``b``,
    the MLA leaves, the vlm's ``mlp1``, whisper's ``enc`` / ``dec`` stacks
    and layer-norm biases), every float leaf cast to
    ``dtype`` (default ``cfg.dtype``, the dtype the model serves in: the
    reference's float32 master weights do not serve under a bfloat16
    config, ROADMAP F7; the SSM's float32 ``A_log``, ``D`` and ``dt_bias``
    are cast too, as the reference's training step casts them)."""
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
    return _tree_from_numpy(tree, resolve_device(device), dtype)


def cache_from_numpy(tree, device=None) -> dict:
    """The reference's decode cache (``length`` and each group's stacked
    ``k`` / ``v``, a pair's ``ka`` / ``va`` / ``kb`` / ``vb``, MLA's
    ``ckv`` / ``krope``, the Mamba ``conv`` / ``ssm`` states; whisper's
    flat ``k`` / ``v`` / ``ck`` / ``cv``) as the port's tensors, in the
    arrays' own dtypes."""
    return _tree_from_numpy(tree, resolve_device(device), None)


def cache_to_numpy(cache: dict) -> dict:
    """The port's decode cache as numpy arrays: ``length`` int32, K/V and
    the states in their dtype (bfloat16 as float32, which holds it
    exactly).  Copies: ``decode_step`` writes into the cache's tensors in
    place."""
    def host(t):
        if isinstance(t, dict):
            return {k: host(v) for k, v in t.items()}
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()

    return host(cache)


def train_state_from_numpy(tree, device=None) -> dict:
    """The reference's train state (``params``, ``opt`` with ``m`` / ``v``
    or Adafactor's ``f`` and the int32 ``step``, ``err``; nested dicts of
    numpy arrays) as the port's, every leaf in its own dtype: float32
    master weights stay float32, the bfloat16 error buffers (ml_dtypes
    arrays) become ``torch.bfloat16``."""
    return _tree_from_numpy(tree, resolve_device(device), None)


def train_state_to_numpy(state: dict) -> dict:
    """The port's train state as numpy arrays (bfloat16 leaves as float32,
    which holds them exactly)."""
    return cache_to_numpy(state)
