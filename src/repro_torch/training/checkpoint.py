"""Checkpoint / restore with async writes and atomic commits, in the
reference's on-disk layout (counterpart of ``repro.training.checkpoint``),
so a checkpoint moves between the two packages in either direction.

``<dir>/step_XXXXXXXX/`` holds one ``.npy`` file per leaf, numbered in
the reference's (sorted-key) leaf order, and ``manifest.json``:
``{"step": s, "leaves": {key: {"file", "shape", "dtype"}}}``, a leaf's
key its dict path joined with ``|``.  A save copies the tree to the host,
writes it (on a thread unless ``blocking``) into ``.tmp_step_XXXXXXXX``
and commits by renaming that directory, so a crash mid-write never
corrupts a committed step; it then keeps the newest ``keep`` steps.
Restore reads the newest committed step (or the one asked for) into the
structure of a template tree, on the template leaves' devices.

A tree of ``DTensor`` leaves (a state placed over a process group) is
gathered leaf by leaf, with every rank joining, and the group's rank 0
writes the same files the one-device path writes; a restore into such a
template reads the files on every rank and keeps each rank's shards, laid
out as the template's leaves.

A bfloat16 leaf is written as the reference writes it: its raw 16-bit
patterns as numpy's ``<V2`` and ``"bfloat16"`` in the manifest.  It is
read back through a 16-bit integer view bit-cast to ``torch.bfloat16``, with
no numpy bfloat16 type (ROADMAP F17: the reference cannot restore such a
leaf itself).
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed.tensor_parallel import from_whole
from repro_torch.training import tree as T

_SEP = "|"


def _host(t) -> np.ndarray:
    """A leaf as the reference's ``np.asarray`` of it (bfloat16 as its raw
    16-bit patterns)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _save(path: str, arr: np.ndarray, dtype: str) -> None:
    """``np.save``; a bfloat16 leaf with the header numpy writes for the
    ml_dtypes type, ``'descr': '<V2'``."""
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = "<V2"
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        f.write(np.ascontiguousarray(arr).tobytes())


def _dtype_name(t, arr: np.ndarray) -> str:
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def save(tree: dict, directory: str, step: int, *, keep: int = 3,
         blocking: bool = True):
    """Checkpoint ``tree`` at ``step``.  Atomic: tmp dir -> rename.  The
    copy to the host happens now; with ``blocking=False`` the writes run
    on a thread, which is returned (join it before the next save).  Of
    a placed tree (``DTensor`` leaves) every rank must call this, since
    each gathered leaf is a collective; only the group's rank 0 copies it
    to the host and writes, the others drop it and return None."""
    placed = any(isinstance(leaf, DTensor) for leaf in T.leaves(tree))
    writer = not placed or dist.get_rank() == 0
    flat = {}
    for path, leaf in T.items(tree):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        if not writer:
            continue
        arr = _host(leaf)
        flat[_SEP.join(map(str, path))] = (arr, _dtype_name(leaf, arr))
    if not writer:
        return None
    os.makedirs(directory, exist_ok=True)

    def _write():
        tmp = os.path.join(directory, f".tmp_step_{step:08d}")
        final = os.path.join(directory, f"step_{step:08d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {}
        for key, (arr, dtype) in flat.items():
            fname = f"{len(manifest):06d}.npy"
            _save(os.path.join(tmp, fname), arr, dtype)
            manifest[key] = {"file": fname, "shape": list(arr.shape),
                             "dtype": dtype}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)  # commit point
        _gc(directory, keep)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _gc(directory: str, keep: int) -> None:
    for s in latest_steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_steps(directory: str) -> list[int]:
    """The committed steps in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(name[5:]) for name in os.listdir(directory)
                  if name.startswith("step_") and os.path.exists(
                      os.path.join(directory, name, "manifest.json")))


def _load(path: str, dtype_name: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(template: dict, directory: str, step: int | None = None, *,
            device=None):
    """Restore into the structure of ``template`` (shapes must match; each
    leaf takes the template leaf's dtype, and its device unless
    ``device`` is given).  A ``DTensor`` template leaf gives a ``DTensor``
    laid out as it, each rank keeping its own shard.

    Returns (tree, step).  Raises FileNotFoundError if no checkpoint."""
    steps = latest_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints in {directory}")
    step = steps[-1] if step is None else step
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]

    def one(path, leaf):
        key = _SEP.join(map(str, path))
        if key not in manifest:
            raise KeyError(f"checkpoint missing leaf {key}")
        entry = manifest[key]
        t = _load(os.path.join(d, entry["file"]), entry["dtype"])
        if list(t.shape) != list(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt "
                             f"{tuple(t.shape)} vs {tuple(leaf.shape)}")
        t = t.to(dtype=leaf.dtype)
        if isinstance(leaf, DTensor):
            return from_whole(t, leaf.device_mesh, leaf.placements,
                              leaf.to_local().device)
        return t.to(device=device if device is not None else leaf.device)

    return T.map_with_path(one, template), step
