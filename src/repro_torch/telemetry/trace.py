"""Device-resident query tracing: the span-record plane (counterpart of
``repro.telemetry.trace``).

The epoch driver's device step already carries the store slabs, load
registers, sketch, replication register file and overload queues.  This
module adds the observability buffer: a fixed-shape per-epoch span table
for a deterministic sampled subset of queries, built on the device next
to the hop plan and brought home with the segment's one device-to-host
copy.

Sampling is ``hash(key, epoch) < rate`` (:func:`sample_mask`), a pure
function of data the step already holds: no PRNG stream is drawn, so the
metric stream is bit-identical with tracing on or off.  The first
``max_spans`` sampled queries of each epoch get a slot (cumsum rank, the
overload plane's admission-rank idiom); the total sampled count is kept
so the host reports slot-cap truncation instead of hiding it.

A span record is two fixed-width rows per slot:

* ``SPAN_I_FIELDS`` (int32): epoch, qid, key (its uint32 bits), opcode,
  routed slot, target node, p2c pick, the packed chain
  (``routing.pack_chain``), chain length, bounce flag, admission outcome
  (``overload.OUTCOME_*``), queue depth at entry and retry-orbit level
  (both read from the PRE-epoch overload state), and the orbit's birth
  epoch (``overload.link_orbit``; -1 outside any orbit);
* ``SPAN_F_FIELDS`` (float32): total planned service, link traversals,
  storage-only service (total minus the bounce's version check), its
  unscaled base, and the occupancy inflation factor.

:mod:`repro_torch.telemetry.attribution` rebuilds each sampled query's
DES latency exactly from these floats.  That needs ``svc_total`` to be
the sum of the hop columns in one fixed order on every device: a left to
right add, one column at a time, which is also what the reference's
compiled ``jnp.sum`` gives.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import keys as K
from repro_torch.core import routing as R


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Static knobs of the trace plane.

    ``None`` in ``ClusterConfig.telemetry`` turns the subsystem off: the
    driver runs the same device step and produces the same metric stream
    as without it.
    """

    sample_rate: float = 1.0 / 64.0   # hash(key, epoch) < rate samples a query
    max_spans: int = 64               # span slots per epoch (first-K sampled)
    flight_epochs: int = 32           # flight-recorder ring length (epochs)
    slo_p999: float | None = None     # per-epoch p999 breach -> postmortem dump
    flight_dir: str | None = None     # postmortem artifact directory (None: cwd)
    profile_stages: bool = True       # stage timers block on the device step
    trace_dir: str | None = None      # torch.profiler Chrome trace of run()
    # cross-epoch retry linking: hash bits of the overload plane's orbit-
    # identity register (overload.link_orbit); 0 turns it off
    link_retries: int = 0


SPAN_I_FIELDS = (
    "epoch", "qid", "key", "opcode", "ridx", "target", "picked", "chain",
    "chain_len", "bounced", "outcome", "queue_depth", "orbit_level",
    "first_epoch",
)
SPAN_F_FIELDS = ("svc_total", "links", "svc_store", "svc_base", "scale")
SI = {name: i for i, name in enumerate(SPAN_I_FIELDS)}
SF = {name: i for i, name in enumerate(SPAN_F_FIELDS)}

_EPOCH_MIX = 0x9E3779B9


def rate_threshold(rate: float) -> int:
    """Map a sample rate in [0, 1] to the uint32 hash threshold."""
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"sample_rate must be in [0, 1], got {rate}")
    return int(round(rate * float(1 << 32)))


def sample_mask(key: torch.Tensor, epoch: int, threshold: int) -> torch.Tensor:
    """(B,) bool deterministic span sampling: ``hash(key, epoch) < rate``,
    the store's avalanche mixer over ``key ^ (epoch * 0x9E3779B9 mod
    2**32)``; no PRNG stream is drawn."""
    if threshold >= (1 << 32):
        return torch.ones(key.shape, dtype=torch.bool, device=key.device)
    e = (int(epoch) * _EPOCH_MIX) & K.MASK32
    return K.hash_key(K.u32(key.to(torch.int64)) ^ e) < threshold


def hop_sum(service: torch.Tensor) -> torch.Tensor:
    """(B, H) -> (B,) float32 row sums, added left to right one column at a
    time (the order the attribution's exactness rests on)."""
    total = service[:, 0]
    for j in range(1, service.shape[1]):
        total = total + service[:, j]
    return total


def collect_spans(q, epoch: int, decision: R.RoutingDecision,
                  picked: torch.Tensor, bounced: torch.Tensor,
                  outcome: torch.Tensor, queue_depth: torch.Tensor,
                  orbit_level: torch.Tensor, service_scale: torch.Tensor,
                  plan, *, threshold: int, k_slots: int, lookup: float,
                  first_epoch: torch.Tensor | None = None):
    """Build one epoch's span table on the device (no host sync).

    Returns ``(span_i (K, |I|) int32, span_f (K, |F|) float32, counts (2,)
    int32)`` with ``counts = (n_sampled, n_recorded)``.  Unfilled slots
    hold -1 in every int column (``qid >= 0`` marks a live row); sampled
    queries past the ``k_slots`` cap are counted but dropped.
    """
    B = q.opcode.shape[0]
    dev = q.opcode.device
    samp = sample_mask(q.key, epoch, threshold)
    rank = torch.cumsum(samp.to(torch.int64), dim=0) - 1
    # unselected and overflowed rows land on a spare slot, sliced off below
    slot = torch.where(samp & (rank < k_slots), rank, k_slots)

    svc_total = hop_sum(plan.service)
    # a bounce's first visit is a version check (model.lookup), not a
    # storage op: split it out, so inflation applies to storage only
    svc_store = svc_total - torch.where(
        bounced, float(np.float32(lookup)), 0.0).to(torch.float32)
    svc_base = svc_store / service_scale

    if first_epoch is None:
        first_epoch = torch.full((B,), -1, dtype=torch.int32, device=dev)
    i32 = lambda x: x.to(torch.int32)
    ints = torch.stack([
        torch.full((B,), int(epoch), dtype=torch.int32, device=dev),
        torch.arange(B, dtype=torch.int32, device=dev),
        K.to_i32(q.key),
        i32(q.opcode),
        i32(decision.ridx),
        i32(decision.target),
        i32(picked),
        R.pack_chain(decision.chain, decision.chain_len),
        i32(decision.chain_len),
        i32(bounced),
        i32(outcome),
        i32(queue_depth),
        i32(orbit_level),
        i32(first_epoch),
    ], dim=1)
    flts = torch.stack(
        [svc_total, plan.reply_links, svc_store, svc_base, service_scale],
        dim=1).to(torch.float32)

    span_i = torch.full((k_slots + 1, len(SPAN_I_FIELDS)), -1,
                        dtype=torch.int32, device=dev)
    span_i[slot] = ints
    span_f = torch.zeros((k_slots + 1, len(SPAN_F_FIELDS)),
                         dtype=torch.float32, device=dev)
    span_f[slot] = flts
    n_samp = samp.sum(dtype=torch.int32)
    counts = torch.stack([n_samp, torch.clamp(n_samp, max=k_slots)])
    return span_i[:k_slots], span_f[:k_slots], counts
