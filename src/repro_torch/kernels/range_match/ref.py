"""Plain PyTorch versions of the range_match CUDA kernels.

Each function computes exactly what its kernel in ``csrc/range_match.cu``
computes, on the same tensors (see that file for the integer
conventions).  The CPU path of every wrapper in :mod:`.kernel` runs
these; ``chip_smoke.py`` holds each kernel against them on the card, and
the tests hold them against the reference's jnp refs and Pallas kernels.
"""

from __future__ import annotations

import torch

_M = 0xFFFFFFFF
_EMPTY_KEY = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """uint32 bits of an int32 (or int64) tensor, as int64 values."""
    return x.to(torch.int64) & _M


def _slot_match(mvals, slot_lo, slot_hi, num_slots: int):
    """Masked interval match: (B,) matching values -> (B,) int64 slot ids
    (the lowest hit; a total miss clamps to ``num_slots - 1``)."""
    v = _u32(mvals)[:, None]
    hit = (v >= _u32(slot_lo)[None, :]) & (v <= _u32(slot_hi)[None, :])
    S = slot_lo.shape[0]
    iota = torch.arange(S, dtype=torch.int64, device=mvals.device)
    ridx = torch.where(hit, iota[None, :], S).amin(dim=-1)
    return torch.clamp(ridx, max=num_slots - 1)


def span_order_ref(slot_lo, slot_hi):
    """The sorted span table the CUDA ``span_order`` kernel writes: the
    live spans (``lo <= hi`` as uint32) in (lo, slot id) order, each slot
    placed at its rank, the count of live spans before it in that order.
    Returns int64 ``(lo, hi, id)`` of the ``n_live`` live spans."""
    lo, hi = _u32(slot_lo), _u32(slot_hi)
    S = lo.shape[0]
    live = lo <= hi
    iota = torch.arange(S, dtype=torch.int64, device=lo.device)
    before = live[None, :] & ((lo[None, :] < lo[:, None])
                              | ((lo[None, :] == lo[:, None])
                                 & (iota[None, :] < iota[:, None])))
    rank = before.sum(dim=1)[live]
    order = torch.empty_like(rank)
    order[rank] = iota[live]
    return lo[order], hi[order], order


def sorted_match_ref(mvals, slot_lo, slot_hi, num_slots: int):
    """Plain mirror of the route kernels' match over the sorted span table
    (used by the tests): :func:`span_order_ref`'s order, the disjoint
    check of adjacent spans, then an upper-bound search of each value over
    the sorted lo (disjoint spans) or an exhaustive pass keeping the
    lowest slot id among the hits.  Returns ``(ridx, match)``: (B,) int64
    slot ids clamped to ``num_slots - 1`` on a total miss, as
    :func:`_slot_match`, and ``"search"`` or ``"exhaustive"``."""
    lo, hi, ids = span_order_ref(slot_lo, slot_hi)
    S = slot_lo.shape[0]
    v = _u32(mvals)
    if bool((hi[:-1] < lo[1:]).all()):
        k = torch.searchsorted(lo, v, right=True)
        prev = torch.clamp(k - 1, min=0)
        if ids.numel():
            hit = (k > 0) & (v <= hi[prev])
            ridx = torch.where(hit, ids[prev], S)
        else:
            ridx = torch.full_like(v, S)
        match = "search"
    else:
        hit = (v[:, None] >= lo[None, :]) & (v[:, None] <= hi[None, :])
        ridx = torch.where(hit, ids[None, :], S).amin(dim=-1)
        match = "exhaustive"
    return torch.clamp(ridx, max=num_slots - 1), match


def _fetch(chains, chain_len, ridx):
    chain = chains[:, ridx]                                  # (r_max, B)
    clen = chain_len[ridx].to(torch.int64)
    return chain, clen


def range_match_ref(mvals, opcodes, slot_lo, slot_hi, chains, chain_len, *,
                    num_slots: int):
    """K1: ``(ridx, target, chain)`` — head for PUT/DEL, tail otherwise."""
    ridx = _slot_match(mvals, slot_lo, slot_hi, num_slots)
    chain, clen = _fetch(chains, chain_len, ridx)
    tail = torch.gather(chain, 0, torch.clamp(clen - 1, min=0)[None, :])[0]
    is_write = (opcodes == 1) | (opcodes == 2)
    target = torch.where(is_write, chain[0], tail)
    return ridx.to(torch.int32), target.to(torch.int32), chain.to(torch.int32)


def p2c_ref(chain, clen, u1, u2, loads):
    """The power-of-two-choices pick: two positions ``u % max(clen, 1)``,
    the replica with the smaller (uint32) load wins, first pick on ties."""
    c = torch.clamp(clen, min=1)
    p1 = torch.remainder(u1.to(torch.int64), c)
    p2 = torch.remainder(u2.to(torch.int64), c)
    n1 = torch.gather(chain, 0, p1[None, :])[0]
    n2 = torch.gather(chain, 0, p2[None, :])[0]
    lu = _u32(loads)
    l1 = lu[torch.clamp(n1, min=0).to(torch.int64)]
    l2 = lu[torch.clamp(n2, min=0).to(torch.int64)]
    first_wins = l1 <= l2
    return torch.where(first_wins, n1, n2), torch.where(first_wins, p1, p2)


def range_match_spread_ref(mvals, opcodes, u1, u2, slot_lo, slot_hi, chains,
                           chain_len, loads, *, num_slots: int):
    """K2: K1 with p2c read spreading; writes still go to the head."""
    ridx = _slot_match(mvals, slot_lo, slot_hi, num_slots)
    chain, clen = _fetch(chains, chain_len, ridx)
    picked, _ = p2c_ref(chain, clen, u1, u2, loads)
    is_write = (opcodes == 1) | (opcodes == 2)
    target = torch.where(is_write, chain[0], picked)
    return ridx.to(torch.int32), target.to(torch.int32), chain.to(torch.int32)


def range_match_spread_dirty_ref(mvals, opcodes, u1, u2, slot_lo, slot_hi,
                                 chains, chain_len, loads, dirty, keys=None,
                                 key_filter=None, *, num_slots: int):
    """K3: K2 plus the CRAQ serving rule.  ``dirty`` (r_max, S) uint8; the
    optional ``key_filter`` (S, F) bool is indexed at bit
    ``hash_key(keys) % F`` of the raw ``keys`` (B,) int64.  A read whose
    pick is dirty (and, with the filter, whose bit is set), is not the
    tail and is a real node bounces to the tail.  Returns ``(ridx, target,
    chain, picked, bounced)``; ``target`` is the serving node."""
    ridx = _slot_match(mvals, slot_lo, slot_hi, num_slots)
    chain, clen = _fetch(chains, chain_len, ridx)
    picked, ppos = p2c_ref(chain, clen, u1, u2, loads)
    tail = torch.gather(chain, 0, torch.clamp(clen - 1, min=0)[None, :])[0]
    d_pick = dirty[ppos, ridx] != 0
    if key_filter is not None and key_filter.shape[1] > 0:
        # imported here: repro_torch.core imports this package
        from repro_torch.core.keys import hash_key

        hb = hash_key(keys) % key_filter.shape[1]
        d_pick = d_pick & key_filter[ridx, hb]
    is_write = (opcodes == 1) | (opcodes == 2)
    bounced = ~is_write & d_pick & (ppos != clen - 1) & (picked >= 0)
    target = torch.where(is_write, chain[0], torch.where(bounced, tail, picked))
    return (ridx.to(torch.int32), target.to(torch.int32), chain.to(torch.int32),
            picked.to(torch.int32), bounced)


def _stale_switch(keys, W: int, hash_partitioned: bool):
    """Each packet's ingress switch, ``hash_key(key) % W``, and matching
    value: that hash under hash partitioning, else the key."""
    # imported here: repro_torch.core imports this package
    from repro_torch.core.keys import hash_key

    h = hash_key(keys)
    return h % W, (h if hash_partitioned else _u32(keys))


def _stale_serve(sw, sridx, opcodes, chains_w, clen_w, version_w, committed):
    """K5's outputs for slot ``sridx`` of switch ``sw``: ``(sridx, server,
    divergent)``."""
    W, S = clen_w.shape
    r_max = chains_w.shape[0] // W
    ws = sw * S + sridx
    clen = clen_w.reshape(-1)[ws].to(torch.int64)
    is_write = (opcodes == 1) | (opcodes == 2)
    pos = torch.where(is_write, 0, torch.clamp(clen - 1, min=0))
    server = chains_w.reshape(-1)[(sw * r_max + pos) * S + sridx]
    divergent = version_w.reshape(-1)[ws] != committed[sridx]
    return sridx.to(torch.int32), server.to(torch.int32), divergent


def range_match_stale_ref(keys, opcodes, lo_w, hi_w, chains_w, clen_w,
                          version_w, committed, *, num_slots: int,
                          hash_partitioned: bool = False):
    """K5: each packet matched against its ingress switch's table copy.
    The switch is ``hash_key(key) % W``; the matching value is that hash
    under hash partitioning, else the key.  The match runs once per switch
    over the whole batch and is selected by switch id (as the Pallas kernel
    does; a per-packet (B, S) gather of the rows would not fit at full
    width).  Returns ``(sridx, server, divergent)``: the serving node is
    the chain head for PUT/DEL and ``chain[max(clen - 1, 0)]`` otherwise,
    ``divergent`` the slot's version against the committed one."""
    sw, v = _stale_switch(keys, lo_w.shape[0], hash_partitioned)
    sridx = torch.zeros_like(sw)
    for w in range(lo_w.shape[0]):
        sridx = torch.where(sw == w, _slot_match(v, lo_w[w], hi_w[w], num_slots),
                            sridx)
    return _stale_serve(sw, sridx, opcodes, chains_w, clen_w, version_w,
                        committed)


def stale_sorted_match_ref(keys, opcodes, lo_w, hi_w, chains_w, clen_w,
                           version_w, committed, *, num_slots: int,
                           hash_partitioned: bool = False):
    """Plain mirror of K5's match over a sorted span table per switch copy
    (used by the tests): each copy's own :func:`sorted_match_ref` (its
    (lo, slot id) order, its disjoint check, then the search or the
    exhaustive pass), selected by the packet's switch.  Returns
    ``((sridx, server, divergent), passes)``, ``passes[w]`` the pass of
    copy ``w``."""
    sw, v = _stale_switch(keys, lo_w.shape[0], hash_partitioned)
    sridx = torch.zeros_like(sw)
    passes = []
    for w in range(lo_w.shape[0]):
        ridx, match = sorted_match_ref(v, lo_w[w], hi_w[w], num_slots)
        sridx = torch.where(sw == w, ridx, sridx)
        passes.append(match)
    return _stale_serve(sw, sridx, opcodes, chains_w, clen_w, version_w,
                        committed), passes


# Row offset of the node-offset concatenation below: larger than every
# uint32 key, so row n's keys land in [n * _ROW, (n + 1) * _ROW).
_ROW = 1 << 33


def offset_rows(slabs: torch.Tensor) -> torch.Tensor:
    """The sorted (N, C) slab rows as one ascending (N*C,) sequence: row
    ``n`` shifted up by ``n * 2**33``."""
    N = slabs.shape[0]
    off = torch.arange(N, dtype=torch.int64, device=slabs.device) * _ROW
    return (slabs + off[:, None]).reshape(-1)


def row_searchsorted(seq: torch.Tensor, C: int, node: torch.Tensor,
                     k: torch.Tensor, side: str = "left") -> torch.Tensor:
    """``searchsorted`` of each key ``k`` in its own row ``node`` (in
    ``[0, N)``) of :func:`offset_rows`'s sequence: positions in
    ``[0, C]``."""
    return torch.searchsorted(seq, k + node * _ROW, side=side) - node * C


def slab_lookup_ref(qkeys, target, slabs):
    """K4a: ``bisect_left`` of each key in row ``clip(target)`` of the
    sorted (N, C) slab table (one searchsorted over the node-offset rows;
    the (B, C) rank count of the reference's jnp ref does not fit at full
    width).  ``slot`` clamps into ``[0, C)``; ``found`` is the probe hit,
    masked for EMPTY keys and unrouted (negative) targets."""
    N, C = slabs.shape
    t = target.to(torch.int64)
    ts = torch.clamp(t, 0, N - 1)
    q = qkeys.to(torch.int64)
    pos = row_searchsorted(offset_rows(slabs), C, ts, q)
    slot = torch.clamp(pos, max=C - 1)
    probe = slabs.reshape(-1)[ts * C + slot]
    found = (probe == q) & (q != _EMPTY_KEY) & (t >= 0)
    return slot.to(torch.int32), found


def range_match_apply_ref(mvals, opcodes, u1, u2, slot_lo, slot_hi, chains,
                          chain_len, loads, dirty, qkeys, slabs, *,
                          num_slots: int):
    """K4b: K3 (no key filter) then K4a's probe of ``qkeys`` in the serving
    node's slab row.  Returns ``(ridx, target, chain, picked, bounced,
    slot, found)``."""
    ridx, target, chain, picked, bounced = range_match_spread_dirty_ref(
        mvals, opcodes, u1, u2, slot_lo, slot_hi, chains, chain_len, loads,
        dirty, num_slots=num_slots)
    slot, found = slab_lookup_ref(qkeys, target, slabs)
    return ridx, target, chain, picked, bounced, slot, found
