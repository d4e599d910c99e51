"""Tail-latency attribution: explain the p999, don't just gate it
(counterpart of ``repro.telemetry.attribution``).

Each sampled span (``telemetry/trace.py``) carries five f32 components
of its hop plan; together with the DES closed-loop latency they
decompose **exactly** into the five buckets of :data:`BUCKETS`:

* ``queue``         — time spent waiting in per-node FIFO lines (the DES
  residual: latency minus planned service minus links);
* ``inflation``     — the overload plane's occupancy-dependent service
  inflation (scaled minus base storage service);
* ``bounce``        — CRAQ dirty-read overhead: the version check at the
  picked replica plus the extra tail link;
* ``retry_backoff`` — the whole latency of a deferred/shed query (its
  plan is the one-link NACK; the *wait* it suffers lives in later
  re-injections, which sample independently);
* ``service``       — base storage service plus the ordinary links.

Exactness: every operand is an f32 (24-bit mantissa) of magnitude
``~2^-1..2^21`` in any scenario this repo runs, so each f64 sum or
difference below is exact (< 53 mantissa bits needed) and the bucket
rows sum back to the recorded DES latency **bit for bit** — the
acceptance gate ``reconstruct(decompose(...)) == latency`` asserted in
``tests/test_torch_telemetry.py`` (against the reference too) and by
``chip_smoke.py``'s phase ``telemetry`` on the card.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.coordination import LatencyModel
from repro_torch.telemetry.trace import SF, SI

BUCKETS = ("queue", "inflation", "bounce", "retry_backoff", "service")
B_QUEUE, B_INFLATION, B_BOUNCE, B_RETRY, B_SERVICE = range(5)


def decompose(span_i: np.ndarray, span_f: np.ndarray, latency: np.ndarray,
              model: LatencyModel) -> np.ndarray:
    """(n, |I|) int rows + (n, |F|) float rows + (n,) DES latency ->
    (n, 5) f64 bucket matrix whose rows sum exactly to ``latency``."""
    si = np.asarray(span_i)
    sf = np.asarray(span_f, np.float32)
    lat = np.asarray(latency, np.float32).astype(np.float64)
    svc_total = sf[:, SF["svc_total"]].astype(np.float64)
    links = sf[:, SF["links"]].astype(np.float64)
    svc_store = sf[:, SF["svc_store"]].astype(np.float64)
    svc_base = sf[:, SF["svc_base"]].astype(np.float64)
    bounced = si[:, SI["bounced"]] == 1
    outcome = si[:, SI["outcome"]]
    rejected = (outcome == 1) | (outcome == 2)   # deferred | shed
    link = float(np.float32(model.link))
    blink = np.where(bounced, link, 0.0)

    comps = np.stack(
        [
            lat - svc_total - links,             # queue (DES residual)
            svc_store - svc_base,                # inflation
            (svc_total - svc_store) + blink,     # bounce
            np.zeros_like(lat),                  # retry_backoff
            svc_base + (links - blink),          # service
        ],
        axis=1,
    )
    # a rejected query's plan is the one-link NACK: its whole latency is
    # retry-storm cost, not service
    rej = np.zeros_like(comps)
    rej[:, B_RETRY] = lat
    return np.where(rejected[:, None], rej, comps)


def reconstruct(comps: np.ndarray) -> np.ndarray:
    """(n, 5) bucket matrix -> (n,) latency; exact for :func:`decompose`
    output (the partial sums telescope with no f64 rounding)."""
    c = np.asarray(comps, np.float64)
    out = c[:, 0]
    for j in range(1, c.shape[1]):
        out = out + c[:, j]
    return out


def tail_attribution(latency: np.ndarray, comps: np.ndarray,
                     q: float = 99.9) -> dict:
    """Bucket the tail's latency mass: where does the p99/p999 live?

    ``latency`` (n,) and ``comps`` (n, 5) over all sampled spans; the
    tail is every span at or above the ``q``-th percentile.  Returns the
    threshold, tail size, per-bucket mass and share, plus the same
    shares over the full sample for contrast.
    """
    lat = np.asarray(latency, np.float64)
    c = np.asarray(comps, np.float64)
    if lat.size == 0:
        return {"q": q, "n": 0, "n_tail": 0, "threshold": 0.0,
                "mass": {}, "share": {}, "share_overall": {}}
    thr = float(np.percentile(lat, q))
    tail = lat >= thr
    mass = c[tail].sum(axis=0)
    total = mass.sum()
    overall = c.sum(axis=0)
    otot = overall.sum()
    return {
        "q": q,
        "n": int(lat.size),
        "n_tail": int(tail.sum()),
        "threshold": thr,
        "mean_tail_latency": float(lat[tail].mean()),
        "mass": {b: float(mass[i]) for i, b in enumerate(BUCKETS)},
        "share": {
            b: float(mass[i] / total) if total > 0 else 0.0
            for i, b in enumerate(BUCKETS)
        },
        "share_overall": {
            b: float(overall[i] / otot) if otot > 0 else 0.0
            for i, b in enumerate(BUCKETS)
        },
    }
