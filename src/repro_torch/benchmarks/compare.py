"""What two runs of a bench are held equal on: every column of a row but
those a run's clock or its host syncs decide, artifact paths by file
name.  The tests hold the port's rows to the reference's through this
form (``tests/data/bench_rows_reference.json`` keeps it), and
``chip_smoke.py`` the card's."""

from __future__ import annotations

import dataclasses
import json
import os

# columns a run's clock or its host syncs decide: not results of the run
# (the two packages count host syncs at different points by design)
RUN_COLUMNS = ("wall_s", "steady_eps", "compile_s", "host_syncs",
               "host_syncs_per_epoch", "stage_s", "stage_share")
PATH_COLUMNS = ("artifact", "artifacts", "incident_paths")
# the reference's artifact names and the port's for the same artifact
PORT_NAMES = {
    "TRACE_overload.json": "TRACE_torch_overload.json",
    "ATTRIB_retry_storm.json": "ATTRIB_torch_retry_storm.json",
    "TRACE_balance.json": "TRACE_torch_balance.json",
    "INCIDENT_metrics_smoke.json": "INCIDENT_torch_metrics_smoke.json",
    "INCIDENT_metrics_smoke.md": "INCIDENT_torch_metrics_smoke.md",
}


def _plain(x):
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if hasattr(x, "item"):          # numpy and torch scalars
        return x.item()
    raise TypeError(f"{type(x).__name__} is not JSON")


def as_json(x):
    """``x`` as it reads back from JSON (tuples as lists)."""
    return json.loads(json.dumps(x, default=_plain))


def _name(path: str) -> str:
    base = os.path.basename(path)
    return PORT_NAMES.get(base, base)


def comparable(rows: list) -> list[dict]:
    """``rows`` without ``RUN_COLUMNS``, artifact paths cut to their file
    names (a reference name given as the port's)."""
    out = []
    for r in as_json(rows):
        r = {k: v for k, v in r.items() if k not in RUN_COLUMNS}
        for k in PATH_COLUMNS:
            if k in r:
                v = r[k]
                r[k] = [_name(p) for p in v] if isinstance(v, list) else _name(v)
        out.append(r)
    return out
