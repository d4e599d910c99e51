"""Elastic scaling and failure recovery for the training driver
(counterpart of ``repro.training.elastic``).

The failure model: a node drops, the job restarts on whatever devices
survive, and training resumes from the newest committed checkpoint.
Checkpoints are device-agnostic numpy (``training.checkpoint``), so
recovery is: fit a mesh to the devices there are (:func:`fit_mesh`),
restore, and place the state (:func:`resume`).

Two kinds of mesh answer ``shape`` and ``axis_names``, which is all the
placement rules read:

* :class:`Mesh`, the devices of an ``(n_data, model_parallel)`` grid
  driven from one process (the layout of the sharded data plane,
  ``core.dist_store``); the single-controller step runs on its first
  device.
* :class:`DistMesh`, the ranks of a ``torch.distributed`` process group
  (one process a device, started by ``torchrun``) on an ``(n_data,
  model_parallel)`` ``DeviceMesh``; the state lives on it as ``DTensor``s
  (``distributed.sharding.place``), the counterpart of the reference's
  one SPMD program over a ``jax.sharding.Mesh``.  :func:`init_process_group`
  joins the group; :func:`fit_mesh` returns a ``DistMesh`` once one is up.

Steps beyond ``factor`` x the trailing median are flagged as stragglers
(:class:`StragglerMonitor`).
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import rank_device
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import tree as T


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices on a named grid (the reference's ``jax.sharding.Mesh``)."""
    devices: np.ndarray           # object array of torch.device
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def visible_devices() -> list[torch.device]:
    """The CUDA cards this process sees; raises when there is none (pass
    ``devices=[torch.device("cpu")]`` to run on the host)."""
    n = torch.cuda.device_count()
    if not n:
        raise RuntimeError("no CUDA device is available; pass the devices "
                           "explicitly to run on the host")
    return [torch.device("cuda", i) for i in range(n)]


@dataclasses.dataclass(frozen=True)
class DistMesh:
    """The ranks of the process group on a named grid: ``device_mesh`` is
    the ``torch.distributed`` ``DeviceMesh``, ``device`` this rank's
    device, ``backend`` the group's (``nccl`` or ``gloo``)."""
    device_mesh: object           # torch.distributed.device_mesh.DeviceMesh
    device: torch.device
    backend: str

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.device_mesh.shape))

    @property
    def size(self) -> int:
        return self.device_mesh.size()

    @property
    def rank(self) -> int:
        return dist.get_rank()


TORCHRUN_USAGE = (
    "a sharded run is one process a rank: start it with torchrun, e.g. "
    "python -m torch.distributed.run --nproc_per_node 4 "
    "-m repro_torch.launch.train --model-parallel 2 ... (add --device cpu "
    "to run the ranks on the host over gloo)")

SHARED_CARD = (
    "{ranks} ranks on this node but {cards} CUDA card(s): ranks that share "
    "a card are not supported (NCCL refuses two ranks on one card, and "
    "gloo's path for DTensor's all-gather of CUDA tensors crashes); start "
    "at most one rank a card (--nproc_per_node {cards}), or add --device "
    "cpu to run the ranks on the host over gloo")


def init_process_group(device=None) -> torch.device:
    """Join the process group that the ``torchrun`` environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``; a multi-node rendezvous sets the same), unless the
    caller has one up already, and return this rank's device
    (``device.rank_device``).  Without that environment it is a usage
    error.

    The backend is NCCL on the cards, each rank of a node on a card of its
    own, and gloo on the CPU; ``dist.get_backend()`` says which.  More
    ranks on a node than cards is an error, not a switch to gloo: NCCL
    refuses two ranks on one card, and gloo's DTensor all-gather of CUDA
    tensors crashes (torch 2.11)."""
    dev = rank_device(device)
    if dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        return dev
    if not {"RANK", "WORLD_SIZE"} <= set(os.environ):
        raise RuntimeError(TORCHRUN_USAGE)
    if dev.type != "cuda":
        dist.init_process_group("gloo")
        return dev
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ["WORLD_SIZE"]))
    cards = torch.cuda.device_count()
    if local_world > cards:
        raise RuntimeError(SHARED_CARD.format(ranks=local_world, cards=cards))
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", device_id=dev)
    return dev


def fit_mesh(axis_names=("data", "model"), *, devices=None,
             model_parallel: int = 1, device=None):
    """The largest mesh the surviving devices support.

    model_parallel is held fixed (memory dictates it); the data axis
    absorbs device loss: n_data = n_devices // model_parallel.  Given
    ``devices``, or with no process group up, a single-controller
    :class:`Mesh`; otherwise a :class:`DistMesh` over the group's ranks,
    this rank on ``device`` (default ``device.rank_device``), whose world
    size ``model_parallel`` must divide (a rank cannot be left out of the
    ``DeviceMesh``)."""
    if devices is None and dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        world = dist.get_world_size()
        if world % model_parallel:
            raise ValueError(f"--model-parallel {model_parallel} does not "
                             f"divide the {world} ranks")
        dev = rank_device(device)
        dm = init_device_mesh(dev.type, (world // model_parallel,
                                         model_parallel),
                              mesh_dim_names=tuple(axis_names))
        return DistMesh(dm, dev, dist.get_backend())
    devices = list(devices if devices is not None else visible_devices())
    n_data = max(1, len(devices) // model_parallel)
    grid = np.empty(n_data * model_parallel, dtype=object)
    grid[:] = devices[:n_data * model_parallel]
    return Mesh(grid.reshape(n_data, model_parallel), tuple(axis_names))


def resume(template: dict, ckpt_dir: str, mesh, specs: dict | None = None):
    """Restore the newest checkpoint onto ``mesh``.  Works across
    device-count and mesh changes because checkpoints are unsharded
    numpy.  Returns (tree, step).

    On a :class:`Mesh` the tree goes to its first device (the single
    controller's).  On a :class:`DistMesh` every rank reads the files
    and keeps its shards: laid out as ``template``'s ``DTensor`` leaves,
    or, given ``specs``, as those specs place them on ``mesh`` (the
    reference's ``resume(template, ckpt_dir, mesh, shardings)``)."""
    if isinstance(mesh, DistMesh):
        if specs is None:
            return CKPT.restore(template, ckpt_dir)
        from repro_torch.distributed.sharding import place

        host = T.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                device="meta"), template)
        tree, step = CKPT.restore(host, ckpt_dir, device="cpu")
        return place(tree, specs, mesh), step
    tree, step = CKPT.restore(template, ckpt_dir)
    dev = mesh.devices.flat[0]
    return T.tree_map(lambda t: t.to(dev), tree), step


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 2.0
    window: int = 20
    times: list[float] = dataclasses.field(default_factory=list)
    flagged: int = 0

    def record(self, seconds: float) -> bool:
        """Record a step time; returns True if this step was a straggler."""
        self.times.append(seconds)
        hist = self.times[-self.window - 1: -1]
        if len(hist) >= 5:
            med = statistics.median(hist)
            if seconds > self.factor * med:
                self.flagged += 1
                return True
        return False


def _sync(metrics: dict) -> dict:
    """Wait for the step's device work; the metrics as host numpy."""
    for v in metrics.values():
        if v.is_cuda:
            torch.cuda.synchronize(v.device)
            break
    return {k: v.detach().cpu().numpy() for k, v in metrics.items()}


def run_with_recovery(step_fn, state: dict, batches: list, *, ckpt_dir: str,
                      interval: int = 50, keep: int = 3,
                      monitor: StragglerMonitor | None = None,
                      fail_at: dict | None = None):
    """The fault-tolerant train loop (used by the tests).

    ``fail_at`` maps a step to an exception to raise there (an injected
    failure); recovery restores the last committed checkpoint and
    replays.  Returns (state, the metrics of every step run, replays
    included, the monitor)."""
    monitor = monitor or StragglerMonitor()
    metrics_log = []
    step_idx = 0
    pending = None
    i = 0
    while i < len(batches):
        try:
            if fail_at and step_idx in fail_at:
                raise fail_at.pop(step_idx)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batches[i])
            host = _sync(metrics)
            monitor.record(time.perf_counter() - t0)
            metrics_log.append(host)
            step_idx += 1
            i += 1
            if step_idx % interval == 0:
                if pending is not None:
                    pending.join()
                pending = CKPT.save(state, ckpt_dir, step_idx, keep=keep,
                                    blocking=False)
        except Exception:  # noqa: BLE001 (any node failure)
            if pending is not None:
                pending.join()
            try:
                state, restored = CKPT.restore(state, ckpt_dir)
            except FileNotFoundError:
                restored = 0  # no checkpoint yet: restart from this state
            # replay from the restored step
            i -= step_idx - restored
            step_idx = restored
    if pending is not None:
        pending.join()
    return state, metrics_log, monitor
