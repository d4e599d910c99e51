"""Declarative SLOs over the metrics ring: multi-window burn-rate alerts
(counterpart of ``repro.telemetry.slo``).

The SRE playbook's alerting rule, applied to the fleet metrics plane
(:mod:`repro_torch.telemetry.metrics`): an :class:`SLO` names one ring series,
a bound, and an objective (the fraction of epochs allowed to violate the
bound).  Each epoch is classified good/bad against the bound; the **burn
rate** over a trailing window is::

    burn(w) = mean(bad over last w epochs) / (1 - objective)

— burn 1.0 exactly spends the error budget at the sustainable rate.  An
alert FIRES at the first epoch where both the fast window (quick to
react) and the slow window (immune to single-epoch blips) exceed their
thresholds, and resolves when either recovers.  Evaluation runs on the
device ring (:func:`evaluate_segment`, one copy home per segment);
:func:`reference_alerts` is the independent numpy oracle the acceptance
gate checks the firing epoch against, bit-for-bit in float32.

The host-side :class:`AlertEngine` walks segment results in epoch order,
keeps the per-SLO firing state, builds the rising/falling-edge alert
timeline, and triggers the flight recorder on each rising edge via
its ``on_fire`` hook.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SLO:
    """One service-level objective over a named ring series.

    ``cmp`` is the direction of *badness*: ``"gt"`` marks an epoch bad
    when the series exceeds ``bound`` (latency, loss, redirect share),
    ``"lt"`` when it falls below (throughput-style floors)."""

    name: str
    series: str               # a SeriesLayout name, e.g. "p999"
    bound: float
    cmp: str = "gt"
    objective: float = 0.99   # fraction of epochs allowed to be good
    fast_window: int = 4      # epochs — page-fast window
    slow_window: int = 16     # epochs — sustained-burn window
    fast_burn: float = 2.0    # firing threshold on the fast window
    slow_burn: float = 1.0    # firing threshold on the slow window

    def __post_init__(self):
        if not 0.0 <= self.objective < 1.0:
            raise ValueError(f"SLO {self.name}: objective must be in [0,1)")
        if self.cmp not in ("gt", "lt"):
            raise ValueError(f"SLO {self.name}: cmp must be 'gt' or 'lt'")
        if self.fast_window > self.slow_window:
            raise ValueError(
                f"SLO {self.name}: fast_window > slow_window"
            )

    @property
    def budget(self) -> float:
        return 1.0 - self.objective


def _f32(x: float) -> float:
    """``x`` rounded to float32 (the reference's weak-typed scalars)."""
    return float(np.float32(x))


def _burn_device(col_vals, pos, seg_len: int, bound: float, gt: bool,
                 budget: float, w: int):
    """(seg_len,) f32 burn rates at epochs ``pos-seg_len .. pos-1``.

    The window is clamped to the available history (epoch j has seen
    j+1 epochs), so early epochs are judged on what exists rather than
    diluted by phantom good epochs.  Both divisions are true float32
    divisions by tensors: a CUDA division by a host scalar multiplies by
    its reciprocal, which rounds differently."""
    window = col_vals.shape[0]
    dev = col_vals.device
    j = pos - seg_len + torch.arange(seg_len, device=dev)   # absolute ids
    offs = torch.arange(w, device=dev)
    idx = j[:, None] - offs[None, :]
    v = col_vals[idx % window]
    bad = (v > _f32(bound)) if gt else (v < _f32(bound))
    bad = bad & (idx >= 0)
    n_av = torch.clamp(j + 1, max=w).to(torch.float32)
    frac = bad.sum(dim=1).to(torch.float32) / torch.clamp(n_av, min=1.0)
    return frac / torch.full_like(frac, _f32(budget))


def evaluate_segment(state, layout, specs: tuple, seg_len: int) -> dict:
    """Evaluate every SLO over the segment's epochs, on the device.

    Requires ``state.pos >= seg_len`` (the segment's rows are written)
    and ``ring window >= slow_window + seg_len`` (driver-validated), so
    no window reaches past retained history.  Returns per spec the
    fast/slow burn-rate arrays, the firing mask, and the raw series
    values, as numpy: every spec's arrays come home in one copy (the
    caller counts it)."""
    pos = state.pos.to(torch.int64)
    window = state.ring.shape[0]
    j = pos - seg_len + torch.arange(seg_len, device=state.ring.device)
    stacked = []
    for s in specs:
        cv = state.ring[:, layout.index[s.series]]
        gt = s.cmp == "gt"
        fast = _burn_device(cv, pos, seg_len, s.bound, gt, s.budget,
                            s.fast_window)
        slow = _burn_device(cv, pos, seg_len, s.bound, gt, s.budget,
                            s.slow_window)
        firing = (fast >= _f32(s.fast_burn)) & (slow >= _f32(s.slow_burn))
        stacked.append(torch.stack([fast, slow, firing.to(torch.float32),
                                    cv[j % window]]))
    host = torch.stack(stacked).cpu().numpy() if stacked else None
    out = {}
    for i, s in enumerate(specs):
        fast, slow, firing, vals = host[i]
        out[s.name] = {"fast": fast, "slow": slow, "firing": firing > 0,
                       "value": vals}
    return out


# ---------------------------------------------------------------------------
# numpy reference (the ground-truth oracle the gate compares against)
# ---------------------------------------------------------------------------

def reference_burn(values: np.ndarray, spec: SLO, w: int) -> np.ndarray:
    """Burn rate at every epoch of a full series — float32 arithmetic in
    the exact operation order of :func:`_burn_device`, so device and
    reference agree bitwise."""
    v = np.asarray(values, np.float32)
    bad = (v > spec.bound) if spec.cmp == "gt" else (v < spec.bound)
    out = np.empty(v.shape[0], np.float32)
    for j in range(v.shape[0]):
        lo = max(0, j - w + 1)
        n_av = np.float32(min(j + 1, w))
        frac = np.float32(bad[lo:j + 1].sum()) / max(n_av, np.float32(1.0))
        out[j] = frac / np.float32(spec.budget)
    return out


def reference_alerts(values: np.ndarray, spec: SLO) -> dict:
    """Firing mask + rising-edge epochs for a full series (numpy)."""
    fast = reference_burn(values, spec, spec.fast_window)
    slow = reference_burn(values, spec, spec.slow_window)
    firing = (fast >= np.float32(spec.fast_burn)) & (
        slow >= np.float32(spec.slow_burn)
    )
    edges = np.flatnonzero(firing & ~np.concatenate(([False], firing[:-1])))
    return {
        "fast": fast,
        "slow": slow,
        "firing": firing,
        "fire_epochs": [int(e) for e in edges],
    }


# ---------------------------------------------------------------------------
# the host-side alert engine
# ---------------------------------------------------------------------------

class AlertEngine:
    """Walks segment burn-rate results in epoch order and keeps the
    alert timeline (rising edge -> ``fire``, falling edge ->
    ``resolve``); ``on_fire(spec, event)`` runs at each rising edge —
    the driver points it at ``TelemetryRecorder.breach`` so a burn alert
    dumps the flight ring like any other invariant breach."""

    def __init__(self, specs: tuple, on_fire=None):
        self.specs = tuple(specs)
        self.on_fire = on_fire
        self.active = {s.name: False for s in self.specs}
        self.timeline: list[dict] = []

    def observe(self, epoch0: int, results: dict) -> None:
        for s in self.specs:
            r = results[s.name]
            for i in range(len(r["firing"])):
                firing = bool(r["firing"][i])
                if firing == self.active[s.name]:
                    continue
                ev = {
                    "slo": s.name,
                    "series": s.series,
                    "epoch": int(epoch0 + i),
                    "state": "fire" if firing else "resolve",
                    "fast_burn": float(r["fast"][i]),
                    "slow_burn": float(r["slow"][i]),
                    "value": float(r["value"][i]),
                    "bound": float(s.bound),
                }
                self.timeline.append(ev)
                self.active[s.name] = firing
                if firing and self.on_fire is not None:
                    self.on_fire(s, ev)

    def firing_epochs(self, name: str) -> list[int]:
        return [ev["epoch"] for ev in self.timeline
                if ev["slo"] == name and ev["state"] == "fire"]

    def summary(self) -> dict:
        return {
            "fires": sum(1 for e in self.timeline if e["state"] == "fire"),
            "active": {k: v for k, v in self.active.items() if v},
            "timeline": list(self.timeline),
        }
