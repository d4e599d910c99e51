"""Mesh layouts and the H100's constants for the dry-run's roofline
(counterpart of ``repro.launch.mesh``).

Single pod: 16x16 = 256 cards, axes ("data", "model").
Multi-pod:  2x16x16 = 512 cards, axes ("pod", "data", "model"), the "pod"
axis being the hierarchical level of the paper (Core/AGG switches).

The production layouts are plain data (:class:`MeshLayout`): axis names
and sizes, no devices, the same shapes as the reference's, so the
placement rules of ``distributed.sharding`` compare spec for spec.  A mesh
over real cards is ``training.elastic``'s :class:`~repro_torch.training.
elastic.Mesh`; both answer ``shape`` and ``axis_names``, which is all the
rules read.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.training.elastic import Mesh, fit_mesh, visible_devices


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """Named mesh axes and their sizes, with no devices behind them."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    if multi_pod:
        return MeshLayout(("pod", "data", "model"), (2, 16, 16))
    return MeshLayout(("data", "model"), (16, 16))


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a production mesh."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def make_host_mesh(n_data: int | None = None, n_model: int = 1, *,
                   devices: list[torch.device] | None = None) -> Mesh:
    """An (n_data, n_model) ("data", "model") mesh over the visible cards
    (raises without one) or over ``devices``; ``n_data`` defaults to as
    many as the devices allow."""
    devices = list(devices if devices is not None else visible_devices())
    n_data = n_data or max(1, len(devices) // n_model)
    if n_data * n_model > len(devices):
        raise ValueError(f"a {n_data}x{n_model} mesh needs {n_data * n_model} "
                         f"devices; {len(devices)} are given")
    return fit_mesh(("data", "model"), devices=devices[:n_data * n_model],
                    model_parallel=n_model)


# NVIDIA H100 80GB HBM3 (SXM) at its full 700 W power limit, per card: the
# links (the compute and memory peaks are telemetry.profiler's)
NVLINK_BW = 450e9      # bytes/s a direction, NVLink 4 (18 links x 25 GB/s)
IB_BW = 50e9           # bytes/s a card, InfiniBand NDR (400 Gb/s)
CARDS_PER_NODE = 8     # an HGX H100 node: 8 cards on one NVLink switch fabric


def group_bandwidth(mesh, axes: tuple[str, ...]) -> float:
    """The per-card bandwidth of a collective over ``axes``: NVLink while
    the group stays inside one node (its cards, with every axis inner to
    it, number at most :data:`CARDS_PER_NODE`: the last mesh axis is the
    innermost), else InfiniBand."""
    names = list(mesh.axis_names)
    outer = min(names.index(a) for a in axes)
    span = math.prod(mesh.shape[a] for a in names[outer:])
    return NVLINK_BW if span <= CARDS_PER_NODE else IB_BW
