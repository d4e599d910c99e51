"""Key-based routing: the switch ingress/egress pipeline (counterpart of
``repro.core.routing``).

Steps 1-4 (matching value, range match, chain fetch, head/tail or p2c
target) run in the range_match kernels (:mod:`repro_torch.kernels.
range_match`: K1 for :func:`route`, K2 for :func:`route_load_aware`, K3
for :func:`route_load_aware_dirty`, K4b for :func:`route_and_lookup`);
the statistics counters and load registers are bumped here in torch
around the kernel, exactly as the reference's kernel wrappers assume.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import directory as D
from repro_torch.core import keys as K
from repro_torch.kernels.range_match import ops as RM
from repro_torch.kernels.range_match.ref import p2c_ref


@dataclasses.dataclass(frozen=True)
class QueryBatch:
    """A batch of TurboKV packets.

    opcode (B,) int32; key (B,) int64 (uint32 values); end_key (B,) int64;
    value (B, V) float32 PUT payload (zeros otherwise).
    """

    opcode: torch.Tensor
    key: torch.Tensor
    end_key: torch.Tensor
    value: torch.Tensor

    @property
    def batch(self) -> int:
        return self.opcode.shape[0]


@dataclasses.dataclass(frozen=True)
class RoutingDecision:
    """Per-packet routing output: ridx, target, chain_len, clength (B,)
    int64 and chain (B, r_max) int64 (head first)."""

    ridx: torch.Tensor
    target: torch.Tensor
    chain: torch.Tensor
    chain_len: torch.Tensor
    clength: torch.Tensor


def _is_write(opcode: torch.Tensor) -> torch.Tensor:
    return (opcode == K.OP_PUT) | (opcode == K.OP_DEL)


def _decision(directory, ridx, target, chain_t, is_write):
    ridx = ridx.to(torch.int64)
    clen = directory.chain_len[ridx]
    return RoutingDecision(
        ridx=ridx,
        target=target.to(torch.int64),
        chain=chain_t.T.to(torch.int64),
        chain_len=clen,
        clength=torch.where(is_write, clen + 1, 2),
    )


def route(directory: D.Directory, q: QueryBatch
          ) -> tuple[RoutingDecision, D.Directory]:
    """Route a packet batch (K1): reads to the chain tail, writes to the
    head; returns the decision and the directory with bumped counters."""
    ridx, target, chain = RM.range_match(directory, q.key, q.opcode)
    is_write = _is_write(q.opcode)
    decision = _decision(directory, ridx, target, chain, is_write)
    return decision, D.bump_counters(directory, decision.ridx, is_write)


def route_load_aware(directory: D.Directory, q: QueryBatch,
                     load_reg: torch.Tensor, rng: np.ndarray, *,
                     queue_pen: torch.Tensor | None = None,
                     ) -> tuple[RoutingDecision, D.Directory, torch.Tensor]:
    """Route with power-of-two-choices read spreading (K2).  ``load_reg``
    is the (N,) int64 uint32 load-register file; ``rng`` the raw
    threefry key of the epoch's routing stream.  ``queue_pen`` ((N,)
    uint32 values in int64, optional) is added to the registers for the
    p2c comparison only (the overload plane's scaled queue depths); the
    registers still bump raw."""
    ridx, target, chain = RM.range_match_spread(
        directory, q.key, q.opcode, load_reg, rng, queue_pen=queue_pen
    )
    is_write = _is_write(q.opcode)
    decision = _decision(directory, ridx, target, chain, is_write)
    directory = D.bump_counters(directory, decision.ridx, is_write)
    load_reg = _bump_load(load_reg, decision.chain, decision.chain_len,
                          is_write, decision.target)
    return decision, directory, load_reg


# byte lanes in a packed chain word; members past this ride the plan only
CHAIN_PACK_SLOTS = 4
_CHAIN_PACK_EMPTY = 0xFF


def pack_chain(chain: torch.Tensor, chain_len: torch.Tensor) -> torch.Tensor:
    """(B, r_max) chain + (B,) len -> (B,) int32, one member per byte.

    The span table (:mod:`repro_torch.telemetry`) keeps each sampled
    query's hop path in one int32: the live chain prefix in byte lanes,
    ``0xFF`` empty, lossless for up to :data:`CHAIN_PACK_SLOTS` members of
    clusters under 255 nodes.  A word whose fourth lane is set is
    negative: the uint32 word is wrapped to int32 explicitly
    (:func:`keys.to_i32`).  :func:`unpack_chain` is the host-side inverse.
    """
    B, r_max = chain.shape
    k = min(r_max, CHAIN_PACK_SLOTS)
    pos = torch.arange(k, device=chain.device)[None, :]
    member = chain[:, :k].to(torch.int64)
    live = (pos < chain_len[:, None]) & (member >= 0) & (member < 255)
    byte = torch.where(live, member, _CHAIN_PACK_EMPTY)
    packed = torch.zeros(B, dtype=torch.int64, device=chain.device)
    for i in range(CHAIN_PACK_SLOTS):
        lane = byte[:, i] if i < k else _CHAIN_PACK_EMPTY
        packed = packed | (lane << (8 * i))
    return K.to_i32(packed)


def unpack_chain(packed) -> np.ndarray:
    """Host-side inverse of :func:`pack_chain`: (n,) packed words ->
    (n, CHAIN_PACK_SLOTS) int32 members, -1 where empty."""
    p = np.asarray(packed, np.int32).view(np.uint32)
    shifts = 8 * np.arange(CHAIN_PACK_SLOTS, dtype=np.uint32)
    bytes_ = (p[:, None] >> shifts[None, :]) & np.uint32(0xFF)
    return np.where(
        bytes_ == _CHAIN_PACK_EMPTY, -1, bytes_.astype(np.int64)
    ).astype(np.int32)


def route_load_aware_dirty(
    directory: D.Directory, q: QueryBatch, load_reg: torch.Tensor,
    dirty: torch.Tensor, rng: np.ndarray, *,
    queue_pen: torch.Tensor | None = None,
    key_filter: torch.Tensor | None = None,
) -> tuple[RoutingDecision, D.Directory, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """CRAQ apportioned reads (K3): the p2c pick of
    :func:`route_load_aware` plus the dirty-bit tail bounce.  ``dirty`` is
    the (S, r_max) bool table of ``repro_torch.replication``; the optional
    (S, F) bool ``key_filter`` bounces only reads whose key hashes onto a
    set bit; ``queue_pen`` as in :func:`route_load_aware`.  Returns
    ``(decision, directory', load_reg', picked, bounced)``:
    ``decision.target`` is the serving node (the tail when bounced),
    ``picked`` the p2c winner the read visits first."""
    ridx, target, chain, picked, bounced = RM.range_match_spread_dirty(
        directory, q.key, q.opcode, load_reg, dirty, rng,
        queue_pen=queue_pen, key_filter=key_filter,
    )
    return (*_craq_bumps(directory, q, load_reg, ridx, target, chain, bounced),
            picked.to(torch.int64), bounced)


def route_and_lookup(directory: D.Directory, q: QueryBatch,
                     store_keys: torch.Tensor, load_reg: torch.Tensor,
                     dirty: torch.Tensor, rng: np.ndarray):
    """Fused route and slab probe (K4b): :func:`route_load_aware_dirty`
    (no key filter) followed by the searchsorted-left probe of each key in
    its serving node's row of the (N, C) ``store_keys`` table.  Returns
    ``(decision, directory', load_reg', picked, bounced, slot, found)``;
    ``slot`` is clamped into ``[0, C)``, ``found`` is the point hit (off
    for EMPTY keys and unrouted packets)."""
    ridx, target, chain, picked, bounced, slot, found = RM.range_match_apply(
        directory, q.key, q.opcode, load_reg, dirty, store_keys, rng,
    )
    return (*_craq_bumps(directory, q, load_reg, ridx, target, chain, bounced),
            picked.to(torch.int64), bounced, slot, found)


def _craq_bumps(directory, q, load_reg, ridx, target, chain, bounced):
    """The decision of a CRAQ route, with the counter and load-register
    bumps: ``(decision, directory', load_reg')``."""
    is_write = _is_write(q.opcode)
    decision = _decision(directory, ridx, target, chain, is_write)
    # writes walk the chain then reply; clean reads pay 2 hops, bounced 3
    decision = dataclasses.replace(decision, clength=torch.where(
        is_write, decision.chain_len + 1, torch.where(bounced, 3, 2)))
    directory = D.bump_counters(directory, decision.ridx, is_write)
    load_reg = _bump_load(load_reg, decision.chain, decision.chain_len,
                          is_write, decision.target)
    return decision, directory, load_reg


def _p2c_pick(chain: torch.Tensor, clen: torch.Tensor, load_reg: torch.Tensor,
              rng: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """The p2c pick on a fetched (B, r_max) chain: ``(picked, ppos)``
    (plain form, shared with the kernel's plain version)."""
    u1, u2 = RM.p2c_draws(rng, chain.shape[0], chain.device)
    return p2c_ref(chain.T, clen, u1, u2, load_reg)


def _bump_load(load_reg: torch.Tensor, chain: torch.Tensor,
               clen: torch.Tensor, is_write: torch.Tensor,
               target: torch.Tensor) -> torch.Tensor:
    """Reads hit their serving node, writes every live chain member.

    The read bump reproduces the reference's index wrap: a NO_NODE
    target (a fully spliced chain) charges node N-1 (``D.wrap_node``,
    ROADMAP fault F2)."""
    N = load_reg.shape[0]
    r_max = chain.shape[1]
    live = (torch.arange(r_max, device=chain.device)[None, :] < clen[:, None]) & (
        chain != D.NO_NODE
    )
    w_hit = live & is_write[:, None]
    safe_chain = torch.where(w_hit, chain, 0)
    add = torch.zeros(N, dtype=torch.int64, device=load_reg.device)
    add.index_add_(0, safe_chain.reshape(-1), w_hit.reshape(-1).to(torch.int64))
    add.index_add_(0, D.wrap_node(target, N), (~is_write).to(torch.int64))
    return K.u32(load_reg + add)


def expand_scans(directory: D.Directory, q: QueryBatch, *,
                 max_scan_fanout: int) -> QueryBatch:
    """Clone-and-circulate for range queries (static fanout unroll)."""
    if directory.hash_partitioned:
        raise ValueError("scans are not supported under hash partitioning (paper §4.1.1)")
    F = max_scan_fanout
    B = q.batch
    dev = q.key.device
    is_scan = q.opcode == K.OP_SCAN
    order, rank = D.range_order(directory)
    start_r = D.lookup_range(directory, q.key)
    end_r = D.lookup_range(directory, torch.maximum(q.end_key, q.key))
    start_k = rank[start_r]
    end_k = rank[end_r]
    span = torch.where(is_scan, end_k - start_k + 1, 1)
    j = torch.arange(F, dtype=torch.int64, device=dev)
    rank_j = torch.minimum(start_k[:, None] + j[None, :], end_k[:, None])
    ridx_j = order[rank_j]
    live = j[None, :] < span[:, None]
    lo = directory.slot_lo[ridx_j]
    hi = directory.slot_hi[ridx_j]
    sub_key = torch.maximum(q.key[:, None], lo)
    sub_end = torch.minimum(q.end_key[:, None], hi)
    opcode = torch.where(
        live,
        torch.where(is_scan[:, None], K.OP_SCAN, q.opcode[:, None]),
        K.OP_GET,
    ).to(torch.int32)
    key = torch.where(live, torch.where(is_scan[:, None], sub_key, q.key[:, None]),
                      q.key[:, None])
    end_key = torch.where(live & is_scan[:, None], sub_end, 0)
    key = torch.where(live, key, K.EMPTY_KEY)
    value = q.value[:, None, :].expand(B, F, q.value.shape[-1])
    return QueryBatch(
        opcode=opcode.reshape(B * F),
        key=key.reshape(B * F),
        end_key=end_key.reshape(B * F),
        value=value.reshape(B * F, q.value.shape[-1]),
    )


def make_queries(keys, opcodes, values=None, end_keys=None, value_dim: int = 1,
                 *, device=None) -> QueryBatch:
    """Build a :class:`QueryBatch` on ``device`` from numpy arrays or
    tensors (keys as uint32 values)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)

    def t(x, dtype):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=dtype)
        a = np.asarray(x)
        if dtype == torch.int64:
            a = a.astype(np.int64)
        return torch.as_tensor(a, device=dev).to(dtype)

    key = t(keys, torch.int64)
    B = key.shape[0]
    if values is None:
        values = torch.zeros((B, value_dim), dtype=torch.float32, device=dev)
    if end_keys is None:
        end_keys = torch.zeros(B, dtype=torch.int64, device=dev)
    return QueryBatch(
        opcode=t(opcodes, torch.int32),
        key=K.u32(key),
        end_key=K.u32(t(end_keys, torch.int64)),
        value=t(values, torch.float32),
    )
