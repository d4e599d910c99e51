"""Vectorized discrete-event coordination engine (counterpart of
``repro.core.des``).

Hop plans are compacted on the host (NO_HOP slots squeezed out by a
stable argsort, live hop counts per query), scenarios stacked along a
leading ``S`` axis, and the exact per-node-FIFO event loop runs in the
port's own copy of the C core (:mod:`repro_torch.core._des_native`).
Events pop in the identical ``(time, qid)`` order as the heapq oracle and
perform the identical float64 ``max``/``add`` sequence, so latency and
makespan match :func:`repro_torch.core.coordination.
simulate_closed_loop_reference` bit for bit.  The DES stays on the host:
it is one sequential event order, not a kernel.

``backend``: ``"native"`` (the C core; raises if it cannot be built) or
``None`` / ``"auto"``: native, falling back to the heapq oracle (query by
query in Python) with a ``RuntimeWarning`` that says why when the C
compiler cannot build the core.  This is the counterpart of the reference's fallback to its XLA
engine; the oracle gives the native core's bits, only slower.
"""

from __future__ import annotations

import ctypes
import warnings

import numpy as np
import torch

from repro_torch.core import _des_native
from repro_torch.core.coordination import (
    NO_HOP,
    HopPlan,
    _closed_loop_heapq,
    _open_loop_heapq,
)

__all__ = ["simulate", "simulate_closed_loop", "stack_plans", "compact_plans",
           "resolve_backend", "available_backends"]

BACKENDS = ("native",)


def available_backends() -> tuple[str, ...]:
    """The engines that can time here: ``"native"`` (the C core) when it
    builds, and always ``"reference"``, the heapq oracle that ``None`` /
    ``"auto"`` falls back to (the reference's fallback is its XLA engine,
    ``"jax"``).  Only ``"native"`` may be named as a ``backend``."""
    return ("native", "reference") if _des_native.available() else ("reference",)


def resolve_backend(backend: str | None) -> str:
    """``None`` / ``"auto"`` -> ``"native"`` when the C core builds here,
    else the heapq oracle (``"reference"``, an internal value) with a
    ``RuntimeWarning`` naming the reason; ``"native"`` stays native."""
    if backend in (None, "auto"):
        if _des_native.available():
            return "native"
        warnings.warn(
            "the native DES core cannot be built "
            f"({_des_native.unavailable_reason()}); timing with the heapq "
            "oracle instead (same bits, slower)", RuntimeWarning,
            stacklevel=3)
        return "reference"
    if backend not in BACKENDS:
        raise ValueError(f"unknown DES backend {backend!r}")
    return backend


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def stack_plans(plans: list[HopPlan]) -> HopPlan:
    """Stack per-scenario (B, H) plans into one (S, B, H) plan (host
    tensors), right-padding the hop axis with NO_HOP / 0."""
    if not plans:
        raise ValueError("stack_plans needs at least one plan")
    nodes = [_host(p.nodes) for p in plans]
    service = [_host(p.service) for p in plans]
    B = nodes[0].shape[0]
    if any(n.ndim != 2 or n.shape[0] != B for n in nodes):
        raise ValueError("all plans must be (B, H) with a common B")
    H = max(n.shape[1] for n in nodes)
    S = len(plans)
    nodes_s = np.full((S, B, H), NO_HOP, np.int32)
    service_s = np.zeros((S, B, H), np.float32)
    reply_s = np.zeros((S, B), np.float32)
    for i, (n, sv) in enumerate(zip(nodes, service)):
        nodes_s[i, :, : n.shape[1]] = n
        service_s[i, :, : sv.shape[1]] = sv
        reply_s[i] = _host(plans[i].reply_links)
    return HopPlan(nodes=torch.from_numpy(nodes_s),
                   service=torch.from_numpy(service_s),
                   reply_links=torch.from_numpy(reply_s))


def compact_plans(plan: HopPlan, return_order: bool = False):
    """(S, B, H) plan -> (nodes, service, n_hops) numpy with live hops
    first (``return_order`` adds the compaction permutation)."""
    nodes = _host(plan.nodes)
    service = _host(plan.service).astype(np.float32)
    if nodes.ndim == 2:
        nodes, service = nodes[None], service[None]
    dead = nodes == NO_HOP
    order = np.argsort(dead, axis=-1, kind="stable")
    nodes_c = np.take_along_axis(nodes, order, axis=-1).astype(np.int32)
    service_c = np.take_along_axis(service, order, axis=-1)
    service_c = np.where(nodes_c == NO_HOP, np.float32(0.0), service_c)
    n_hops = (~dead).sum(-1).astype(np.int32)
    if return_order:
        return nodes_c, service_c, n_hops, order
    return nodes_c, service_c, n_hops


def _validate(nodes_c: np.ndarray, n_hops: np.ndarray, num_nodes: int) -> None:
    live = np.arange(nodes_c.shape[-1])[None, None, :] < n_hops[..., None]
    bad = live & ((nodes_c < 0) | (nodes_c >= num_nodes))
    if bad.any():
        raise ValueError(
            f"hop plan references nodes outside [0, {num_nodes}); "
            "pass the num_nodes the plan was built for"
        )


def _run_reference(nodes_c, service_c, arrivals, *, K, N, link, think,
                   closed, want_hops):
    """The fallback: the heapq oracle scenario by scenario on the compacted
    plans (it skips the NO_HOP tail the compaction leaves)."""
    S, B, H = nodes_c.shape
    finish = np.zeros((S, B), np.float64)
    issue = np.zeros((S, B), np.float64)
    hops = np.zeros((S, B, H), np.float64) if want_hops else None
    for s in range(S):
        sv = service_c[s].astype(np.float64)
        if closed:
            finish[s], issue[s], hd = _closed_loop_heapq(
                nodes_c[s], sv, K, N, link, think)
        else:
            issue[s] = arrivals[s]
            finish[s], hd = _open_loop_heapq(nodes_c[s], sv, arrivals[s],
                                             N, link)
        if want_hops:
            hops[s] = hd
    return finish, issue, hops


def _run(nodes_c, service_c, n_hops, arrivals, *, K, N, link, think, closed,
         want_hops=False, backend="native"):
    if backend == "reference":
        return _run_reference(nodes_c, service_c, arrivals, K=K, N=N,
                              link=link, think=think, closed=closed,
                              want_hops=want_hops)
    lib = _des_native.load()
    S, B, H = nodes_c.shape
    nodes = np.ascontiguousarray(nodes_c, np.int32)
    service = np.ascontiguousarray(service_c, np.float32)
    nh = np.ascontiguousarray(n_hops, np.int32)
    arr = None
    if not closed:
        arr = np.ascontiguousarray(np.broadcast_to(arrivals, (S, B)), np.float64)
    finish = np.zeros((S, B), np.float64)
    issue = np.zeros((S, B), np.float64)
    hops = np.zeros((S, B, H), np.float64) if want_hops else None
    scratch_nf = np.zeros((N,), np.float64)
    scratch_hop = np.zeros((max(B, 1),), np.int32)
    scratch_heap = np.zeros((B + 1, 2), np.float64)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.des_simulate_batch(
        p(nodes), p(service), p(nh), None if arr is None else p(arr),
        S, B, H, int(K), int(N), float(link), float(think), 1 if closed else 0,
        p(scratch_nf), p(scratch_hop), p(scratch_heap), p(finish), p(issue),
        None if hops is None else p(hops),
    )
    return finish, issue, hops


def _finalize(finish, issue, stacked):
    latency = (finish - issue).astype(np.float32)
    if finish.shape[1] == 0:
        makespan = np.zeros((finish.shape[0],), np.float32)
    else:
        makespan = finish.max(axis=1).astype(np.float32)
    if not stacked:
        return torch.from_numpy(latency[0].copy()), torch.tensor(makespan[0])
    return torch.from_numpy(latency), torch.from_numpy(makespan)


def _uncompact_hops(hops_c: np.ndarray, order: np.ndarray) -> np.ndarray:
    out = np.zeros_like(hops_c)
    np.put_along_axis(out, order, hops_c, axis=-1)
    return out


def simulate(plan: HopPlan, arrivals, *, num_nodes: int, link: float = 1.0,
             return_hops: bool = False, backend: str | None = None):
    """Open-loop DES over a (B, H) plan or an (S, B, H) stack."""
    backend = resolve_backend(backend)
    stacked = _host(plan.nodes).ndim == 3
    nodes_c, service_c, n_hops, order = compact_plans(plan, return_order=True)
    S, B, H = nodes_c.shape
    if B == 0:
        z = np.zeros((S, 0), np.float64)
        out = _finalize(z, z, stacked)
        if return_hops:
            zh = np.zeros((S, 0, H), np.float64)
            return (*out, zh if stacked else zh[0])
        return out
    _validate(nodes_c, n_hops, num_nodes)
    arr = _host(arrivals).astype(np.float64)
    if arr.ndim == 1:
        arr = np.broadcast_to(arr[None], (S, B))
    finish, issue, hops = _run(
        nodes_c, service_c, n_hops, arr, K=0, N=num_nodes, link=link,
        think=0.0, closed=False, want_hops=return_hops, backend=backend,
    )
    out = _finalize(finish, issue, stacked)
    if return_hops:
        hops = _uncompact_hops(hops, order)
        return (*out, hops if stacked else hops[0])
    return out


def simulate_closed_loop(plan: HopPlan, *, n_clients: int, num_nodes: int,
                         link: float = 1.0, think: float = 0.0,
                         return_issue: bool = False, return_hops: bool = False,
                         backend: str | None = None):
    """Closed-loop DES (K clients replaying the stream back to back);
    accepts an (S, B, H) stack.  ``return_issue`` / ``return_hops`` add the
    float64 issue and per-hop completion times as numpy arrays."""
    backend = resolve_backend(backend)
    stacked = _host(plan.nodes).ndim == 3
    nodes_c, service_c, n_hops, order = compact_plans(plan, return_order=True)
    S, B, H = nodes_c.shape
    if B == 0 or n_clients <= 0:
        z = np.zeros((S, B), np.float64)
        out = _finalize(z, z, stacked)
        if return_issue:
            out = (*out, z if stacked else z[0])
        if return_hops:
            zh = np.zeros((S, B, H), np.float64)
            out = (*out, zh if stacked else zh[0])
        return out
    _validate(nodes_c, n_hops, num_nodes)
    finish, issue, hops = _run(
        nodes_c, service_c, n_hops, None, K=n_clients, N=num_nodes, link=link,
        think=think, closed=True, want_hops=return_hops, backend=backend,
    )
    out = _finalize(finish, issue, stacked)
    if return_issue:
        out = (*out, issue if stacked else issue[0])
    if return_hops:
        hops = _uncompact_hops(hops, order)
        out = (*out, hops if stacked else hops[0])
    return out
