"""The switch-replicated directory tier on PyTorch (counterpart of
``repro.coordination_tier``): stale-table routing on K5
``range_match_stale``, versioned redirects, leases and split-brain
survival.  See state.py for the design note."""

from repro_torch.coordination_tier.manager import EVENT_KINDS, CoordManager
from repro_torch.coordination_tier.state import (
    CSTAT_FIELDS,
    INSTALL_NEVER,
    CoordConfig,
    CoordState,
    empty_cstats,
    ingress_switch,
    install_pending,
    make_state,
    observe_epoch,
    stale_lookup,
)

__all__ = [
    "CSTAT_FIELDS",
    "EVENT_KINDS",
    "INSTALL_NEVER",
    "CoordConfig",
    "CoordState",
    "CoordManager",
    "empty_cstats",
    "ingress_switch",
    "install_pending",
    "make_state",
    "observe_epoch",
    "stale_lookup",
]
