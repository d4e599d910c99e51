"""Flight recorder: a bounded postmortem ring over the last N epochs
(counterpart of ``repro.telemetry.flight``).

The survival/SLO gates today say *that* a run violated its bound; they
throw away the state that explains *why*.  The flight recorder keeps a
``deque(maxlen=N)`` of per-epoch entries (metrics row, sampled spans,
overload queue depths, retry backlog, load registers, replication dirty
summary) and, when a breach fires — an SLO p999 excursion, a non-zero
overload conservation gap, or an explicit bench-gate failure — dumps the
ring to a JSON artifact for offline inspection.  One dump per distinct
reason per run; the ring keeps recording after a dump.
"""

from __future__ import annotations

import collections
import json
import os

import numpy as np


def jsonable(x):
    """Best-effort conversion of nested numpy containers to JSON types."""
    if isinstance(x, dict):
        return {str(k): jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, (np.bool_,)):
        return bool(x)
    return x


class FlightRecorder:
    """Ring buffer of per-epoch state snapshots with breach dumps."""

    def __init__(self, n_epochs: int, out_dir: str | None = None,
                 tag: str = "run"):
        self.ring: collections.deque = collections.deque(maxlen=n_epochs)
        self.out_dir = out_dir or "."
        self.tag = tag
        self.dumps: list[str] = []
        self._reasons_seen: set[str] = set()

    def record(self, entry: dict) -> None:
        self.ring.append(jsonable(entry))

    def dump(self, reason: str, *, force: bool = False) -> str | None:
        """Write the ring to a postmortem artifact; returns the path.

        Deduplicates on the reason's kind (the text before the first
        ':') so a sustained breach produces one artifact, not one per
        epoch; ``force=True`` always writes.
        """
        kind = reason.split(":", 1)[0]
        if not force and kind in self._reasons_seen:
            return None
        self._reasons_seen.add(kind)
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(
            self.out_dir, f"flight_{self.tag}_{len(self.dumps)}.json"
        )
        with open(path, "w") as f:
            json.dump(
                {"reason": reason, "tag": self.tag,
                 "epochs_recorded": len(self.ring),
                 "epochs": list(self.ring)},
                f, indent=1,
            )
        self.dumps.append(path)
        return path
