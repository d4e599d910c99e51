"""Query statistics: the controller's report and the count-min sketch
(counterpart of ``repro.core.stats``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import directory as D
from repro_torch.core import keys as K


@dataclasses.dataclass(frozen=True)
class StatsReport:
    """Host-side snapshot the controller consumes (numpy).  Fields as in
    the reference: per-slot counters, per-node load, the period, slot
    liveness, the sketch's key sample / heat view, the overload fields
    (zero until the overload plane is ported) and ``budget_scale``."""

    read_count: np.ndarray
    write_count: np.ndarray
    node_load: np.ndarray
    period: int
    live: np.ndarray | None = None
    key_sample: np.ndarray | None = None
    key_heat: np.ndarray | None = None
    queue_depth: np.ndarray | None = None
    retry_backlog: np.ndarray | None = None
    queue_limit: int = 0
    service_limit: int = 0
    budget_scale: float = 1.0

    @property
    def total_ops(self) -> int:
        return int(self.read_count.sum() + self.write_count.sum())


def pull_report(directory: D.Directory, period: int
                ) -> tuple[StatsReport, D.Directory]:
    """Harvest and reset the data-plane counters (the only reset path)."""
    report = StatsReport(
        read_count=directory.read_count.cpu().numpy().astype(np.uint32),
        write_count=directory.write_count.cpu().numpy().astype(np.uint32),
        node_load=D.node_load(directory).cpu().numpy(),
        period=period,
        live=directory.live.cpu().numpy(),
    )
    return report, D.reset_counters(directory)


_SKETCH_SALTS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)


def make_sketch(width: int = 1024, depth: int = 4, *, device=None) -> torch.Tensor:
    """(depth, width) int64 count-min table (uint32 counters)."""
    from repro_torch.device import resolve_device

    if depth > len(_SKETCH_SALTS):
        raise ValueError(f"depth <= {len(_SKETCH_SALTS)}")
    return torch.zeros((depth, width), dtype=torch.int64,
                       device=resolve_device(device))


def sketch_update(sketch: torch.Tensor, qkeys: torch.Tensor) -> torch.Tensor:
    """Count-min update for a key batch (EMPTY keys ignored)."""
    depth, width = sketch.shape
    live = (qkeys != K.EMPTY_KEY).to(torch.int64)
    add = torch.zeros_like(sketch)
    for d in range(depth):
        h = K.hash_key(qkeys ^ _SKETCH_SALTS[d]) % width
        add[d].index_add_(0, h, live)
    return K.u32(sketch + add)


def sketch_query(sketch: torch.Tensor, qkeys: torch.Tensor) -> torch.Tensor:
    """Point estimate: min over rows."""
    depth, width = sketch.shape
    ests = [sketch[d][K.hash_key(qkeys ^ _SKETCH_SALTS[d]) % width]
            for d in range(depth)]
    return torch.stack(ests, dim=0).amin(dim=0)
