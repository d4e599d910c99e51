"""The three selectable consistency modes over slot-pool chains.

A copy of ``repro.replication.protocol`` for the port (numpy only).

TurboKV's directory stores a *chain* per key range and the switch routes
reads and writes along it (paper §IV); what the chain *means* is a
consistency choice this module makes explicit:

* ``eventual`` — the pre-replication-subsystem behaviour, unchanged bit
  for bit: reads go to the tail (or spread by p2c when the policy says
  so), widened chain members are lazily-refreshed read replicas and the
  write's client-visible path is the base chain only
  (``plan_hops(write_chain_cap=replication)``).  No staleness or version
  accounting.
* ``chain`` — classic chain replication (van Renesse & Schneider):
  writes propagate head→tail through **every** live member (widened ones
  included) and only the tail serves reads.  Strong consistency, tail
  bottleneck, write latency grows with chain length.
* ``craq`` — CRAQ apportioned reads: writes broadcast versions down the
  whole chain; every member keeps per-slot dirty bits
  (:mod:`repro.replication.state`).  A read picks a replica by the p2c
  spread; a **clean** replica answers locally, a **dirty** one forwards
  the version check to the tail (one extra hop — the read "bounces").
  Clean reads divide the read load across the chain like ``eventual``
  while keeping ``chain``'s consistency story.

The mode changes only *routing and hop accounting* — the batch-converged
store applies writes along the whole chain in every mode (§4.1.2), so the
three modes are store-state-identical on the same op stream; what moves
is who serves which read and how many node visits each op pays.
"""

from __future__ import annotations

import dataclasses

EVENTUAL = "eventual"
CHAIN = "chain"
CRAQ = "craq"
REPLICATION_MODES = (EVENTUAL, CHAIN, CRAQ)


@dataclasses.dataclass(frozen=True)
class ModePlan:
    """How the epoch driver wires one replication mode.

    spread:           route reads by p2c over the live chain (data-plane
                      read spreading); forced on for craq (apportioned
                      reads are the protocol), forced off for chain
                      (tail is the only read server).
    dirty_reads:      routing consults the dirty table and bounces dirty
                      picks to the tail (craq only).
    track_state:      thread the version/dirty register file through the
                      epoch step (chain + craq; eventual keeps the
                      pre-subsystem program byte for byte).
    write_cap_spread: ``plan_hops(write_chain_cap=)`` under a spreading
                      policy — the base replication factor for eventual
                      (widened members sync off the reply path), None
                      (full chain) for chain/craq, whose writes visit
                      every member to broadcast the version.
    """

    spread: bool
    dirty_reads: bool
    track_state: bool
    write_cap_spread: int | None


def resolve_mode(mode: str, policy_read_spread: bool, replication: int) -> ModePlan:
    """Validate ``mode`` and derive the driver wiring for it."""
    if mode not in REPLICATION_MODES:
        raise ValueError(
            f"unknown replication mode {mode!r}; pick from {REPLICATION_MODES}"
        )
    if mode == EVENTUAL:
        return ModePlan(
            spread=policy_read_spread,
            dirty_reads=False,
            track_state=False,
            write_cap_spread=replication if policy_read_spread else None,
        )
    if mode == CHAIN:
        return ModePlan(
            spread=False, dirty_reads=False, track_state=True,
            write_cap_spread=None,
        )
    return ModePlan(  # CRAQ
        spread=True, dirty_reads=True, track_state=True,
        write_cap_spread=None,
    )
