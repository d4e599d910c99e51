"""repro_torch.overload — bounded admission queues, retry storms,
backpressure (counterpart of ``repro.overload``).

Per-node admission queues with occupancy-dependent service inflation,
explicit admit/defer/shed outcomes per routed query, exponential-backoff
retry orbits, and the two knobs (admission probability, retry budget)
the backpressure policies steer.  See :mod:`repro_torch.overload.state`.
"""

from repro_torch.overload.state import (
    ORBIT_EMPTY,
    OUTCOME_ADMITTED,
    OUTCOME_DEFERRED,
    OUTCOME_INVALID,
    OUTCOME_SHED,
    STAT_FIELDS,
    OverloadConfig,
    OverloadState,
    conservation_gap,
    link_orbit,
    make_state,
    service_scale,
    step,
    summary,
)

__all__ = [
    "ORBIT_EMPTY", "STAT_FIELDS", "OverloadConfig", "OverloadState",
    "OUTCOME_ADMITTED", "OUTCOME_DEFERRED", "OUTCOME_SHED",
    "OUTCOME_INVALID",
    "conservation_gap", "link_orbit", "make_state", "service_scale", "step",
    "summary",
]
