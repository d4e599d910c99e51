"""Elastic scaling and failure recovery for the training driver
(counterpart of ``repro.training.elastic``).

The failure model: a node drops, the job restarts on whatever devices
survive, and training resumes from the newest committed checkpoint.
Checkpoints are device-agnostic numpy (``training.checkpoint``), so
recovery is: fit a mesh to the devices there are (:func:`fit_mesh`),
restore, and place the state (:func:`resume`).

The port drives its devices from one process (the layout of its sharded
data plane, ``core.dist_store``): a :class:`Mesh` names the devices of
an ``(n_data, model_parallel)`` grid, and the single-controller step runs
on its first device.  Steps beyond ``factor`` x the trailing median are
flagged as stragglers (:class:`StragglerMonitor`).
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import numpy as np
import torch

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


def fit_mesh(axis_names=("data", "model"), *, devices=None,
             model_parallel: int = 1) -> Mesh:
    """The largest mesh the surviving devices support.

    model_parallel is held fixed (memory dictates it); the data axis
    absorbs device loss: n_data = n_devices // model_parallel."""
    devices = list(devices if devices is not None else visible_devices())
    n_data = max(1, len(devices) // model_parallel)
    grid = np.empty(n_data * model_parallel, dtype=object)
    grid[:] = devices[:n_data * model_parallel]
    return Mesh(grid.reshape(n_data, model_parallel), tuple(axis_names))


def resume(template: dict, ckpt_dir: str, mesh: Mesh):
    """Restore the newest checkpoint and place it on ``mesh``'s first
    device (the single controller's).  Works across device-count changes
    because checkpoints are unsharded numpy.  Returns (tree, step)."""
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
