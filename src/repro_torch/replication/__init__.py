"""Consistency modes over the replica chains (only ``eventual`` runs in
the port so far; ``chain`` and ``craq`` need the version/dirty register
file, ROADMAP module-port step 7)."""

from repro_torch.replication.protocol import (
    CHAIN,
    CRAQ,
    EVENTUAL,
    REPLICATION_MODES,
    ModePlan,
    resolve_mode,
)

__all__ = ["CHAIN", "CRAQ", "EVENTUAL", "REPLICATION_MODES", "ModePlan",
           "resolve_mode"]
