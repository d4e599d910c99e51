"""Bounded admission queues + retry-storm dynamics, the overload plane
(counterpart of ``repro.overload.state``).

Every storage node carries a bounded admission queue (``queue_cap``
entries) drained at ``service_rate`` queries an epoch; a query admitted
behind a deep queue pays ``1 + inflation * occupancy / queue_cap`` times
the base storage service.  Every routed query gets an explicit outcome:
**admitted** (joins the queue), **deferred** (turned away by the node's
admission probability, terminally accounted) or **shed** (queue full,
enters the retry backlog).  Shed queries re-arrive after an exponential
backoff with jitter; a query re-shed out of the top backoff level is
**lost**.  The control plane steers two per-node registers from the
period report: ``admit_prob`` and ``retry_budget``.

The plane is an accounting plane: the store applies every op either way,
and the plane decides each query's timing fate (an admitted query's
service is inflated, a rejected one gets a plan with no node visits).

The state is a dataclass of tensors on one device, updated by
:func:`step` once an epoch inside the driver's device step; it draws its
randomness with :mod:`repro_torch.prng` exactly as the reference does
with ``jax.random`` (``split``, then ``uniform`` for the admission gate
and ``randint`` for the backoff jitter).  Integer registers are int32, as
in the reference; cumulative sums and scatters run on int32 / int64
tensors (the CPU has no uint32 ``index_add_``).

Conservation invariant::

    cum_injected == cum_admitted + cum_requeued + cum_deferred
                    + cum_lost + retry.sum()
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import keys as K


@dataclasses.dataclass(frozen=True)
class OverloadConfig:
    """Static knobs of the admission/queue plane."""

    queue_cap: int = 64        # per-node admission queue bound
    service_rate: int = 96     # queries drained per node per epoch
    inflation: float = 3.0     # service multiplier slope vs. occupancy
    backoff_base: int = 1      # retry delay at level 0 (epochs)
    max_level: int = 4         # backoff levels; re-shed past the top -> lost
    jitter_span: int = 2       # uniform extra delay in [0, jitter_span]
    # weight of the queue depth in the p2c read-spreading penalty
    # (routing.route_load_aware queue_pen; 0 turns the steer off)
    queue_weight: int = 0


# empty sentinel of the hashed retry-orbit register: INT32_MAX, so the
# stamp is a scatter-min (first shed epoch wins, batch-order independent)
ORBIT_EMPTY = 2**31 - 1

# stat-vector layout shared with the epoch driver (one (7,) int32 row an
# epoch)
STAT_FIELDS = (
    "injected", "admitted", "deferred", "shed", "requeued", "lost",
    "queue_peak",
)

# per-query outcome codes
OUTCOME_INVALID = -1   # target < 0: outside the overload plane
OUTCOME_ADMITTED = 0
OUTCOME_DEFERRED = 1
OUTCOME_SHED = 2


@dataclasses.dataclass(frozen=True)
class OverloadState:
    """Per-node queue/retry registers on one device.

    queue:        (N,)   int32 admission-queue occupancy
    retry:        (N, L) int32 shed queries awaiting retry, by backoff level
    timer:        (N, L) int32 epochs until that level's bucket releases
    admit_prob:   (N,)   float32 admission probability (control-plane set)
    retry_budget: (N,)   int32 released retries admitted an epoch (ditto)
    cum_*:        ()     int32 lifetime outcome counters
    first_seen:   (F,)   int32 hashed retry-orbit birth epochs
                  (:func:`link_orbit`; (1,) placeholder when off)
    """

    queue: torch.Tensor
    retry: torch.Tensor
    timer: torch.Tensor
    admit_prob: torch.Tensor
    retry_budget: torch.Tensor
    cum_injected: torch.Tensor
    cum_admitted: torch.Tensor
    cum_deferred: torch.Tensor
    cum_shed: torch.Tensor
    cum_requeued: torch.Tensor
    cum_lost: torch.Tensor
    first_seen: torch.Tensor


def make_state(num_nodes: int, cfg: OverloadConfig, link_bits: int = 0, *,
               device) -> OverloadState:
    """Fresh overload plane on ``device``: empty queues, open admission,
    an effectively unlimited retry budget.  ``link_bits`` sizes the hashed
    retry-orbit register at ``2**link_bits`` slots (0 keeps the (1,)
    placeholder and :func:`link_orbit` is a no-op)."""
    L = cfg.max_level
    F = (1 << link_bits) if link_bits > 0 else 1
    i32 = dict(dtype=torch.int32, device=device)
    z = lambda: torch.zeros((), **i32)
    return OverloadState(
        queue=torch.zeros(num_nodes, **i32),
        retry=torch.zeros((num_nodes, L), **i32),
        timer=torch.zeros((num_nodes, L), **i32),
        admit_prob=torch.ones(num_nodes, dtype=torch.float32, device=device),
        retry_budget=torch.full((num_nodes,), 2**30, **i32),
        cum_injected=z(), cum_admitted=z(), cum_deferred=z(),
        cum_shed=z(), cum_requeued=z(), cum_lost=z(),
        first_seen=torch.full((F,), ORBIT_EMPTY, **i32),
    )


def service_scale(occ: torch.Tensor, cfg: OverloadConfig) -> torch.Tensor:
    """``1 + inflation * occ / queue_cap`` in float32, as the reference's
    compiled step computes it (ROADMAP fault F11): XLA rewrites the
    division by the constant into a product with ``1 / queue_cap``, folds
    ``inflation`` into that constant, and contracts the add into a fused
    multiply-add, ``fma(occ, f32(f32(1 / queue_cap) * inflation), 1)``.
    The fma is taken in float64, where the product is exact; the sum is
    rounded to odd there, so the one rounding to float32 is exact too."""
    k = float(np.float32(np.float32(1.0) / np.float32(cfg.queue_cap))
              * np.float32(cfg.inflation))
    p = occ.to(torch.float32).to(torch.float64) * k
    s = p + 1.0
    bb = s - p
    err = (p - (s - bb)) + (1.0 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def step(state: OverloadState, target: torch.Tensor, rng: np.ndarray,
         cfg: OverloadConfig):
    """One epoch of queue/retry dynamics (shape-stable, no host sync).

    ``target``: (B,) routed node per query (NO_NODE < 0 queries are
    outside the plane).  Returns ``(state', rejected (B,) bool,
    service_scale (B,) float32, outcome (B,) int32, stats (7,) int32)``
    in :data:`STAT_FIELDS` order.

    Within the epoch: expired retry buckets release (most-escalated level
    first, capped by ``retry_budget``; the held remainder waits one more
    epoch without escalating); released retries fill queue room before
    new arrivals; new arrivals pass the admission gate, then compete for
    the remaining room in batch order; the queue drains ``service_rate``
    at epoch end.  Shed arrivals enter level 0; re-shed releases escalate
    one level (timer ``backoff_base * 2^level`` plus jitter); escalation
    past the top level is a loss.
    """
    N, L = state.retry.shape
    B = target.shape[0]
    dev = state.queue.device
    i32 = torch.int32
    occ = state.queue                                      # pre-epoch
    r_gate, r_jit = prng.split(rng)

    # ---- 1. backoff timers tick; expired buckets want to release ----
    has = state.retry > 0
    ticked = torch.where(has, torch.clamp(state.timer - 1, min=0), 0)
    ready = has & (ticked == 0)
    want = torch.where(ready, state.retry, 0)              # (N, L)

    # the retry budget caps re-entry a node, most-escalated level first;
    # the held remainder keeps its level and retries next epoch
    want_rev = want.flip(1)
    cum_w = torch.cumsum(want_rev, dim=1, dtype=i32)
    rel_rev = torch.minimum(
        torch.clamp(state.retry_budget[:, None] - (cum_w - want_rev), min=0),
        want_rev)
    released = rel_rev.flip(1)                             # (N, L)
    held = want - released

    # ---- 2. released retries fill queue room first ----
    room = torch.clamp(cfg.queue_cap - occ, min=0)         # (N,)
    cum_r = torch.cumsum(rel_rev, dim=1, dtype=i32)
    acc_rev = torch.minimum(
        torch.clamp(room[:, None] - (cum_r - rel_rev), min=0), rel_rev)
    acc_rel = acc_rev.flip(1)                              # re-admitted
    reshed = released - acc_rel                            # escalate
    requeued_n = acc_rel.sum(dim=1, dtype=i32)
    room2 = room - requeued_n

    # ---- 3. new arrivals: admission gate, then room in batch order ----
    valid = target >= 0
    t_safe = torch.clamp(target, 0, N - 1).to(torch.int64)
    u = prng.uniform(r_gate, (B,), dev)
    gate = valid & (u < state.admit_prob[t_safe])
    deferred_q = valid & ~gate
    # each gated query's place among the gated queries of its node, in
    # batch order: a cumulative sum along an (N, B) one-hot's batch axis
    onehot = ((torch.arange(N, device=dev)[:, None] == t_safe[None, :])
              & gate[None, :])
    rank = torch.cumsum(onehot, dim=1, dtype=torch.int64).gather(
        0, t_safe[None, :])[0] - 1
    admitted_q = gate & (rank < room2.to(torch.int64)[t_safe])
    shed_q = gate & ~admitted_q
    shed_new = torch.zeros(N, dtype=i32, device=dev).index_add_(
        0, t_safe, shed_q.to(i32))
    adm_new = torch.zeros(N, dtype=i32, device=dev).index_add_(
        0, t_safe, admitted_q.to(i32))

    # ---- 4. retry table: level 0 takes fresh sheds, escalations shift
    # one level right, the top level's re-sheds are lost ----
    lost_n = reshed[:, L - 1]
    esc = torch.cat([shed_new[:, None], reshed[:, :L - 1]], dim=1)
    retry2 = state.retry - released + esc

    # timers: inflow into an empty bucket arms level l at
    # backoff_base * 2^l + jitter; inflow into a counting bucket rides its
    # countdown; budget-held buckets retry next epoch (timer 1)
    backoff = cfg.backoff_base * (
        torch.ones(L, dtype=i32, device=dev) << torch.arange(L, dtype=i32,
                                                             device=dev))
    jit_draw = prng.randint(r_jit, (N, L), 0, cfg.jitter_span + 1, dev)
    t_new = backoff[None, :] + jit_draw
    remaining = state.retry - released
    base_t = torch.where(held > 0, torch.clamp(ticked, min=1), ticked)
    timer2 = torch.where((esc > 0) & (remaining == 0), t_new, base_t)
    timer2 = torch.where(retry2 > 0, torch.clamp(timer2, min=1), 0)

    # ---- 5. the queue drains service_rate at epoch end ----
    filled = occ + requeued_n + adm_new                    # <= queue_cap
    queue2 = torch.clamp(filled - cfg.service_rate, min=0)

    # ---- 6. outcomes back onto the batch ----
    rejected = deferred_q | shed_q
    scale = torch.where(admitted_q, service_scale(occ[t_safe], cfg),
                        torch.ones((), dtype=torch.float32, device=dev))
    outcome = torch.where(
        admitted_q, OUTCOME_ADMITTED,
        torch.where(deferred_q, OUTCOME_DEFERRED,
                    torch.where(shed_q, OUTCOME_SHED, OUTCOME_INVALID)),
    ).to(i32)

    e = lambda x: x.sum(dtype=i32)
    injected = e(valid)
    admitted = e(admitted_q)
    deferred = e(deferred_q)
    shed = e(shed_q)
    requeued = e(requeued_n)
    lost = e(lost_n)
    stats = torch.stack([injected, admitted, deferred, shed, requeued, lost,
                         queue2.max()])

    state2 = OverloadState(
        queue=queue2,
        retry=retry2,
        timer=timer2,
        admit_prob=state.admit_prob,
        retry_budget=state.retry_budget,
        cum_injected=state.cum_injected + injected,
        cum_admitted=state.cum_admitted + admitted,
        cum_deferred=state.cum_deferred + deferred,
        cum_shed=state.cum_shed + shed,
        cum_requeued=state.cum_requeued + requeued,
        cum_lost=state.cum_lost + lost,
        first_seen=state.first_seen,
    )
    return state2, rejected, scale, outcome, stats


def link_orbit(state: OverloadState, key: torch.Tensor,
               rejected: torch.Tensor, admitted: torch.Tensor, epoch: int):
    """Cross-epoch retry linking through the hashed ``key -> birth epoch``
    register: a rejected query scatter-mins the epoch into its slot (first
    shed wins), an admitted query whose slot is live reads its orbit's
    birth epoch and clears the slot.  Returns ``(state', first_epoch (B,)
    int32)``, -1 outside any orbit.  Scatters go to a spare slot F for
    the masked-out queries, so nothing syncs with the host."""
    F = state.first_seen.shape[0]
    B = key.shape[0]
    dev = state.first_seen.device
    if F <= 1:
        return state, torch.full((B,), -1, dtype=torch.int32, device=dev)
    h = K.hash_key(key) & (F - 1)                          # int64
    born = state.first_seen[h]                             # pre-epoch view
    in_orbit = born < ORBIT_EMPTY
    eid = torch.full((B,), int(epoch), dtype=torch.int32, device=dev)
    first_epoch = torch.where(
        rejected, torch.minimum(born, eid),
        torch.where(admitted & in_orbit, born, -1)).to(torch.int32)
    # clear completed orbits first, then stamp this epoch's rejects: a
    # slot both completing and re-shedding in one batch stays in orbit
    success = admitted & in_orbit
    fs = torch.cat([state.first_seen,
                    torch.full((1,), ORBIT_EMPTY, dtype=torch.int32,
                               device=dev)])
    fs[torch.where(success, h, F)] = ORBIT_EMPTY
    fs.scatter_reduce_(0, torch.where(rejected, h, F), eid, reduce="amin")
    return dataclasses.replace(state, first_seen=fs[:F]), first_epoch


def conservation_gap(state: OverloadState) -> int:
    """``injected - (admitted + requeued + deferred + lost + backlog)``:
    zero iff the accounting closed (host-side check, one copy)."""
    inj, adm, req, dfr, lost, backlog = torch.stack([
        state.cum_injected, state.cum_admitted, state.cum_requeued,
        state.cum_deferred, state.cum_lost, state.retry.sum(dtype=torch.int32),
    ]).tolist()
    return inj - (adm + req + dfr + lost + backlog)


def summary(state: OverloadState) -> dict:
    """Host-side snapshot for benches and tests."""
    vals = torch.stack([
        state.cum_injected, state.cum_admitted, state.cum_deferred,
        state.cum_shed, state.cum_requeued, state.cum_lost,
        state.retry.sum(dtype=torch.int32), state.queue.sum(dtype=torch.int32),
    ]).tolist()
    out = dict(zip(("injected", "admitted", "deferred", "shed", "requeued",
                    "lost", "retry_backlog", "queue_backlog"), vals))
    out["conservation_gap"] = out["injected"] - (
        out["admitted"] + out["requeued"] + out["deferred"] + out["lost"]
        + out["retry_backlog"])
    return out
