"""The fleet metrics plane: a device-resident time-series ring
(counterpart of ``repro.telemetry.metrics``).

TurboKV's switches double as monitoring stations (paper §5.1).  One
fixed-shape ``(window, n_series)`` float32 ring lives on the device next
to the store slabs and takes one row every epoch, written in place by
the device step:

* per-node series: routed ops, admission-queue depth, retry backlog,
  admission probability (zeros when the overload plane is off);
* the overload counters (``overload.STAT_FIELDS``) and a loss rate;
* the coordination tier's counters (``coordination_tier.CSTAT_FIELDS``),
  the redirect share, and each switch's staleness lag (slots its table
  copy holds at a non-committed version);
* CRAQ's dirty window: dirty slot count, max and mean dirty-chain width;
* top-k hot-range heat: this epoch's keys against the count-min sketch,
  scatter-maxed onto their routed slots, then the k hottest slots.

Four columns (p50/p99/p999/imbalance) come from the DES on the host, so
the driver folds them into the rows at each segment boundary
(:func:`fold_host`); the per-epoch loop folds one row at a time, which
writes the same cells with the same values.

Contracts (held against the reference in ``tests/test_torch_metrics_plane.py``):

* ``metrics=None`` runs the same device step and gives the same
  ``EpochMetrics`` stream;
* recording draws no PRNG and touches no store or counter, so the
  stream is also the same with the ring on: the plane only observes;
* the ring keeps its shape across ``split_overflow`` pool growth (per-slot
  detail is aggregated into fixed-width series).

The k hottest slots are taken from a stable descending sort, not from
``torch.topk``: most slots' heat is 0, so nearly every epoch breaks ties,
and the reference's ``lax.top_k`` puts the lowest index first among equal
values, as a stable sort does (ROADMAP fault F13).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

# the columns the host folds in after the DES call (everything else is
# written on the device by record_epoch)
HOST_FIELDS = ("p50", "p99", "p999", "imbalance")


@dataclasses.dataclass(frozen=True)
class MetricsConfig:
    """Static knobs of the metrics plane."""

    window: int = 64          # ring length in epochs
    topk: int = 4             # hot-range heat series count
    # declarative SLO specs (repro_torch.telemetry.slo.SLO), evaluated as
    # fast+slow multi-window burn rates at every segment boundary
    slos: tuple = ()


@dataclasses.dataclass(frozen=True)
class MetricsState:
    """The device-resident ring: ``ring[(pos - 1) % window]`` is the last
    row.  ``pos`` (a 0-d int32 tensor on the device, so recording needs no
    host sync) counts recorded epochs."""

    ring: torch.Tensor   # (window, n_series) float32
    pos: torch.Tensor    # () int32


class SeriesLayout:
    """Host-side name <-> column map for one driver geometry; the column
    order is the concatenation order of :func:`record_epoch`."""

    def __init__(self, names: tuple, *, num_nodes: int, n_switches: int,
                 topk: int):
        self.names = tuple(names)
        self.index = {n: i for i, n in enumerate(self.names)}
        self.num_nodes = num_nodes
        self.n_switches = n_switches
        self.topk = topk
        self.host_cols = tuple(self.index[f] for f in HOST_FIELDS)

    @property
    def n_series(self) -> int:
        return len(self.names)


def build_layout(num_nodes: int, *, n_switches: int = 0,
                 topk: int = 4) -> SeriesLayout:
    """The series schema for one cluster geometry.

    ``n_switches == 0`` (coordination tier off) omits the per-switch lag
    block; everything else is always present (zeros when the producing
    subsystem is off) so one layout serves every arm of a bench.
    """
    from repro_torch import coordination_tier as CT
    from repro_torch import overload as OVL

    names: list[str] = []
    for fam in ("node_load", "queue_depth", "retry_backlog", "admit_prob"):
        names.extend(f"{fam}/{i}" for i in range(num_nodes))
    names.extend(f"ovl_{f}" for f in OVL.STAT_FIELDS)
    names.append("loss_rate")
    names.extend(f"coord_{f}" for f in CT.CSTAT_FIELDS)
    names.append("redirect_share")
    names.extend(f"switch_lag/{w}" for w in range(n_switches))
    names.extend(("craq_dirty_slots", "craq_dirty_width_max",
                  "craq_dirty_width_mean"))
    for j in range(topk):
        names.append(f"heat_val/{j}")
    for j in range(topk):
        names.append(f"heat_slot/{j}")
    names.extend(HOST_FIELDS)
    return SeriesLayout(tuple(names), num_nodes=num_nodes,
                        n_switches=n_switches, topk=topk)


def make_state(window: int, n_series: int, *, device=None) -> MetricsState:
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    return MetricsState(
        ring=torch.zeros((window, n_series), dtype=torch.float32, device=dev),
        pos=torch.zeros((), dtype=torch.int32, device=dev),
    )


def hot_slots(slot_heat: torch.Tensor, k: int):
    """The ``k`` largest heats and their slots, ties broken lowest slot
    first (``lax.top_k``'s order; a stable descending sort gives it on
    every device)."""
    vals, idx = torch.sort(slot_heat, descending=True, stable=True)
    return vals[:k], idx[:k]


def record_epoch(state: MetricsState, *, node_ops, ovl, ostats, cstats,
                 coord, repl, sketch, keys, ridx, topk: int) -> MetricsState:
    """Write one epoch's row into the ring, on the device, in place.

    Draws no PRNG; reads the post-step ``ovl``, post-observe ``coord`` and
    post-advance ``repl`` (end-of-epoch state, like the flight ring's
    snapshots).  ``ovl`` / ``coord`` may be None: their series record as
    zeros / are absent from the layout; ``ostats`` / ``cstats`` are then
    zero rows.
    """
    from repro_torch.core.stats import sketch_query

    f32 = torch.float32
    dev = node_ops.device
    N = node_ops.shape[0]
    parts = [node_ops.to(f32)]
    if ovl is not None:
        parts.append(ovl.queue.to(f32))
        parts.append(ovl.retry.sum(dim=1).to(f32))
        parts.append(ovl.admit_prob.to(f32))
    else:
        z = torch.zeros(N, dtype=f32, device=dev)
        parts.extend((z, z, z))
    ost = ostats.to(f32)
    parts.append(ost)
    parts.append((ost[5] / torch.clamp(ost[0], min=1.0))[None])   # loss_rate
    cst = cstats.to(f32)
    parts.append(cst)
    parts.append((cst[2] / torch.clamp(cst[0], min=1.0))[None])   # redirects
    if coord is not None:
        # per-switch staleness lag: slots whose table copy sits at a
        # non-committed version (what the install chain drains)
        lag = (coord.version != coord.committed[None, :]).sum(dim=1)
        parts.append(lag.to(f32))
    # CRAQ dirty-window width per slot, aggregated to a fixed shape so the
    # ring survives pool growth
    width = (repl.acked < repl.version[:, None]).sum(dim=1).to(f32)
    dirty_slots = (width > 0).sum().to(f32)
    parts.append(torch.stack([
        dirty_slots,
        width.max(),
        width.sum() / torch.clamp(dirty_slots, min=1.0),
    ]))
    # top-k hot-range heat: this epoch's keys against the sketch,
    # scatter-maxed onto their routed slots; an out-of-range ridx goes to
    # a spare slot (the reference drops it) and must not alias slot 0
    n_slots = repl.version.shape[0]
    est = sketch_query(sketch, keys).to(f32)
    r = torch.where(ridx < 0, ridx + n_slots, ridx)
    r = torch.where((r >= 0) & (r < n_slots), r, n_slots)
    slot_heat = torch.zeros(n_slots + 1, dtype=f32, device=dev)
    slot_heat.scatter_reduce_(0, r, est, reduce="amax")
    heat_val, heat_slot = hot_slots(slot_heat[:n_slots], topk)
    parts.append(heat_val)
    parts.append(heat_slot.to(f32))
    parts.append(torch.zeros(len(HOST_FIELDS), dtype=f32, device=dev))
    row = torch.cat(parts)
    window = state.ring.shape[0]
    state.ring.index_copy_(0, (state.pos % window).to(torch.int64)[None],
                           row[None])
    return MetricsState(ring=state.ring, pos=state.pos + 1)


def fold_host(state: MetricsState, start_pos: int, vals: np.ndarray,
              host_cols: tuple) -> MetricsState:
    """Fold the host-computed latency/imbalance columns into the ``L``
    rows the device just wrote (positions ``start_pos .. start_pos+L-1``).

    One batched update a segment; the per-epoch loop calls it with L == 1:
    the same cells, the same float32 values."""
    vals = np.asarray(vals, np.float32)
    L = vals.shape[0]
    window = state.ring.shape[0]
    dev = state.ring.device
    rows = torch.as_tensor((start_pos + np.arange(L)) % window, device=dev)
    cols = torch.as_tensor(np.asarray(host_cols, np.int64), device=dev)
    state.ring[rows[:, None], cols[None, :]] = torch.as_tensor(vals,
                                                               device=dev)
    return state


# ---------------------------------------------------------------------------
# host views / export
# ---------------------------------------------------------------------------

def series_view(state: MetricsState, layout: SeriesLayout) -> dict:
    """Chronological host view of the ring: the retained epochs oldest
    first, with their absolute epoch ids (one device-to-host copy; the
    caller counts it)."""
    ring, pos = state.ring.cpu().numpy(), int(state.pos)
    window = ring.shape[0]
    n = min(pos, window)
    start = pos - n
    rows = (start + np.arange(n)) % window
    return {
        "names": list(layout.names),
        "epochs": [int(start + i) for i in range(n)],
        "values": ring[rows],
        "window": window,
        "pos": pos,
    }


def _metric_parts(name: str) -> tuple[str, str | None]:
    if "/" in name:
        fam, idx = name.rsplit("/", 1)
        return fam, idx
    return name, None


def to_openmetrics(view: dict, *, prefix: str = "turbokv") -> str:
    """OpenMetrics-style text exposition of the LATEST ring row (every
    series a gauge; indexed families get an ``idx`` label)."""
    lines: list[str] = []
    if not view["epochs"]:
        return "# EOF\n"
    last = np.asarray(view["values"])[-1]
    lines.append(f"# TYPE {prefix}_epoch gauge")
    lines.append(f"{prefix}_epoch {view['epochs'][-1]}")
    seen: set[str] = set()
    for name, val in zip(view["names"], last):
        fam, idx = _metric_parts(name)
        metric = f"{prefix}_{fam}"
        if fam not in seen:
            seen.add(fam)
            lines.append(f"# TYPE {metric} gauge")
        label = "" if idx is None else f'{{idx="{idx}"}}'
        lines.append(f"{metric}{label} {float(val):g}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def write_view(path: str, view: dict, *, alerts: list | None = None) -> str:
    """Persist a series view (plus an optional alert timeline) as JSON,
    the dashboard CLI's input format."""
    doc = dict(view)
    doc["values"] = np.asarray(view["values"], np.float64).tolist()
    if alerts is not None:
        doc["alerts"] = alerts
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
