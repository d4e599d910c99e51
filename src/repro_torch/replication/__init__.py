"""Consistency modes over the replica chains (``eventual``, ``chain``,
``craq``) and the version/dirty register file that ``chain`` and ``craq``
thread through the epoch step (counterpart of ``repro.replication``).

    protocol.py - mode semantics and driver wiring (ModePlan)
    state.py    - ReplState register file: advance / dirty_bits /
                  apply_events
    bench.py    - the three-mode tail-latency comparison and its gates
"""

from repro_torch.replication.protocol import (
    CHAIN,
    CRAQ,
    EVENTUAL,
    REPLICATION_MODES,
    ModePlan,
    resolve_mode,
)
from repro_torch.replication.state import (
    ReplState,
    advance,
    apply_events,
    dirty_bits,
    make_state,
    summary,
    summary_of,
)

__all__ = [
    "CHAIN", "CRAQ", "EVENTUAL", "REPLICATION_MODES", "ModePlan",
    "resolve_mode", "ReplState", "make_state", "advance", "apply_events",
    "dirty_bits", "summary", "summary_of",
]
