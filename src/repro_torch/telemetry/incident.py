"""One-command incident reports: the postmortem artifact builder
(counterpart of ``repro.telemetry.incident``).

``incident.report(driver)`` stitches everything the observability plane
knows about a run into one JSON (+ optional markdown) artifact:

* the SLO alert timeline (rising/falling edges with burn rates),
* the flight-recorder breach list and dump paths,
* the p999 tail-latency attribution shares,
* the cross-epoch retry-orbit trees,
* the coordination tier's staleness summary,
* the last metrics-ring row + per-series worst values,
* the pipeline stage-timer breakdown.

Pieces degrade gracefully: a driver without telemetry still reports its
alert timeline and metrics view; a driver without the metrics plane
raises (there is nothing to report on).  The function duck-types
``EpochDriver`` — it only reads public-ish attributes — so the module
stays import-cycle-free under ``repro_torch.telemetry``.
"""

from __future__ import annotations

import json

import numpy as np


def build(driver) -> dict:
    """Assemble the postmortem dict from a finished (or mid-run) driver."""
    if getattr(driver, "metrics", None) is None:
        raise ValueError(
            "incident.report needs the metrics plane: construct the "
            "driver with ClusterConfig(metrics=MetricsConfig(...))"
        )
    view = driver.metrics_view()
    vals = np.asarray(view["values"], np.float64)
    names = view["names"]
    engine = driver.met_engine
    doc: dict = {
        "scenario": driver.scenario.name,
        "policy": driver.policy.name,
        "epochs_recorded": int(view["pos"]),
        "alerts": engine.summary() if engine is not None else {
            "fires": 0, "active": {}, "timeline": []},
        "slos": [
            {"name": s.name, "series": s.series, "bound": s.bound,
             "cmp": s.cmp, "objective": s.objective,
             "fast_window": s.fast_window, "slow_window": s.slow_window}
            for s in (driver.met_cfg.slos or ())
        ],
        "metrics": {
            "window": int(view["window"]),
            "last_epoch": view["epochs"][-1] if view["epochs"] else None,
            "last": {n: float(v) for n, v in zip(names, vals[-1])}
            if len(vals) else {},
            "worst": {n: float(v) for n, v in
                      zip(names, vals.max(axis=0))} if len(vals) else {},
        },
    }
    tel = getattr(driver, "telemetry", None)
    if tel is not None:
        doc["breaches"] = list(tel.breaches)
        doc["flight_dumps"] = list(tel.flight.dumps)
        doc["flight_epochs_recorded"] = len(tel.flight.ring)
        if tel.span_count:
            doc["p999_attribution"] = tel.attribution(99.9)
            doc["retry_orbits"] = tel.retry_orbits()
        doc["stage_timers"] = tel.timers.summary()
    coord_mgr = getattr(driver, "coord_mgr", None)
    if coord_mgr is not None:
        doc["coordination"] = coord_mgr.summary()
    if getattr(driver, "ovl", None) is not None:
        doc["overload"] = driver.overload_summary()
    return doc


def to_markdown(doc: dict) -> str:
    """Render the postmortem as a short human-readable markdown page."""
    lines = [
        f"# Incident report — {doc['scenario']} / {doc['policy']}",
        "",
        f"Epochs recorded: {doc['epochs_recorded']}  ·  "
        f"alert fires: {doc['alerts']['fires']}",
        "",
        "## Alert timeline",
    ]
    tl = doc["alerts"]["timeline"]
    if tl:
        lines.append("| epoch | slo | state | value | fast burn | slow burn |")
        lines.append("|---|---|---|---|---|---|")
        for ev in tl:
            lines.append(
                f"| {ev['epoch']} | {ev['slo']} | {ev['state']} "
                f"| {ev['value']:.2f} | {ev['fast_burn']:.2f} "
                f"| {ev['slow_burn']:.2f} |"
            )
    else:
        lines.append("*(no alerts fired)*")
    if doc.get("p999_attribution"):
        lines += ["", "## p999 attribution"]
        shares = doc["p999_attribution"].get("share", {})
        for k, v in shares.items():
            lines.append(f"- {k}: {100.0 * v:.1f}%")
    if doc.get("retry_orbits"):
        lines += ["", f"## Retry orbits ({len(doc['retry_orbits'])})"]
        for orb in doc["retry_orbits"][:8]:
            lines.append(f"- {json.dumps(orb)[:200]}")
    if doc.get("breaches"):
        lines += ["", "## Breaches"]
        lines += [f"- {b}" for b in doc["breaches"]]
    if doc.get("flight_dumps"):
        lines += ["", "## Flight dumps"]
        lines += [f"- {p}" for p in doc["flight_dumps"]]
    if doc.get("coordination"):
        lines += ["", "## Coordination tier",
                  f"`{json.dumps(doc['coordination'])}`"]
    if doc.get("stage_timers"):
        lines += ["", "## Stage timers",
                  f"`{json.dumps(doc['stage_timers'].get('stage_s', {}))}`"]
    return "\n".join(lines) + "\n"


def report(driver, *, out_dir: str = ".", tag: str | None = None,
           markdown: bool = True) -> dict:
    """Build and write the postmortem artifact(s).

    Returns the document with ``paths`` added — ``INCIDENT_<tag>.json``
    and (by default) ``INCIDENT_<tag>.md`` under ``out_dir``."""
    import os

    doc = build(driver)
    if tag is None:
        tag = f"{driver.scenario.name}_{driver.policy.name}"
    paths = []
    jpath = os.path.join(out_dir, f"INCIDENT_{tag}.json")
    with open(jpath, "w") as f:
        json.dump(doc, f, indent=1, default=_jsonable)
    paths.append(jpath)
    if markdown:
        mpath = os.path.join(out_dir, f"INCIDENT_{tag}.md")
        with open(mpath, "w") as f:
            f.write(to_markdown(doc))
        paths.append(mpath)
    doc["paths"] = paths
    return doc


def _jsonable(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


__all__ = ["build", "report", "to_markdown"]
