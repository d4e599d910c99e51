"""Request-coordination models and the hop planner (counterpart of
``repro.core.coordination``).

``plan_hops`` builds the (B, H) per-query hop plan of a coordination
model from a routing decision on the device; the heapq pair
``simulate_reference`` / ``simulate_closed_loop_reference`` is the slow,
obviously correct timing oracle the vectorized engine
(:mod:`repro_torch.core.des`) is held to bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import _des_native
from repro_torch.core import keys as K
from repro_torch.core.routing import QueryBatch, RoutingDecision

IN_SWITCH = "in_switch"
CLIENT_DRIVEN = "client_driven"
SERVER_DRIVEN = "server_driven"
MODES = (IN_SWITCH, CLIENT_DRIVEN, SERVER_DRIVEN)

NO_HOP = -1


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """Cost constants (abstract ticks): link, service, lookup, coordinator."""

    link: float = 1.0
    service: float = 10.0
    lookup: float = 1.5
    coordinator: float = 1.0


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    """Per-hop mean-one service multiplier: ``fixed``, ``lognormal`` or
    ``pareto``, each the reference's draw bit for bit (see :meth:`draw`)."""

    kind: str = "fixed"
    sigma: float = 0.6
    alpha: float = 2.2

    def draw(self, rng: np.ndarray, shape: tuple[int, ...], device) -> torch.Tensor:
        """(shape) float32 mean-one service multipliers."""
        if self.kind == "fixed":
            return torch.ones(shape, dtype=torch.float32, device=device)
        if self.kind == "lognormal":
            # exp(sigma * z - sigma^2 / 2) as the reference's compiled
            # step computes it: z = sqrt(2) * erf_inv(u), the two constant
            # factors folded into one, f32(sqrt(2)) * f32(sigma), the
            # argument one fused multiply-add, and XLA's float32 exp
            e = prng.normal_erf_inv(rng, shape, device)
            k = prng.SQRT2_F32 * np.float32(self.sigma)
            arg = prng.fma_f32(e, k, -np.float32(0.5 * self.sigma * self.sigma))
            return prng.exp_f32(arg)
        if self.kind == "pareto":
            if self.alpha <= 1.0:
                raise ValueError(f"pareto alpha must be > 1, got {self.alpha}")
            u = prng.uniform(rng, shape, device,
                             minval=float(np.finfo(np.float32).tiny))
            # the C library's powf on the host gives the reference's
            # float32 bits (torch's pow and a rounded float64 power do
            # not); on the card that is one round trip a plan
            e = np.float32(-1.0 / self.alpha)
            x = torch.from_numpy(_des_native.powf(u.cpu().numpy(), e))
            return x.to(device) * np.float32((self.alpha - 1.0) / self.alpha)
        raise ValueError(f"unknown service model kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class HopPlan:
    """nodes (B, H) int32 visit order (NO_HOP padding); service (B, H)
    float32 per-visit ticks; reply_links (B,) float32."""

    nodes: torch.Tensor
    service: torch.Tensor
    reply_links: torch.Tensor


def _shift_left(x: torch.Tensor, fill) -> torch.Tensor:
    pad = torch.full((x.shape[0], 1), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[:, 1:], pad], dim=1)


def plan_hops(
    q: QueryBatch,
    decision: RoutingDecision,
    mode: str,
    model: LatencyModel,
    *,
    rng: np.ndarray,
    num_nodes: int,
    write_chain_cap: int | None = None,
    service_model: ServiceModel | None = None,
    read_via: torch.Tensor | None = None,
    read_bounce: torch.Tensor | None = None,
    shed: torch.Tensor | None = None,
    service_scale: torch.Tensor | None = None,
    redirect: torch.Tensor | None = None,
    redirect_via: torch.Tensor | None = None,
) -> HopPlan:
    """The per-query hop plan of a coordination model (see the reference
    for the meaning of every argument; the bounce / shed / redirect
    columns are wired the same way)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    if (read_via is None) != (read_bounce is None):
        raise ValueError("read_via and read_bounce must be passed together")
    if (redirect is None) != (redirect_via is None):
        raise ValueError("redirect and redirect_via must be passed together")
    B, r_max = decision.chain.shape
    dev = decision.chain.device
    f32 = torch.float32
    is_write = (q.opcode == K.OP_PUT) | (q.opcode == K.OP_DEL)
    visit_len = decision.chain_len
    if write_chain_cap is not None:
        visit_len = torch.clamp(visit_len, max=write_chain_cap)
    pos = torch.arange(r_max, device=dev)[None, :]
    live = pos < visit_len[:, None]

    chain = decision.chain.to(torch.int32)
    target = decision.target.to(torch.int32)
    write_nodes = torch.where(live, chain, NO_HOP)
    if read_bounce is None:
        rb = None
        read_nodes = torch.cat(
            [target[:, None],
             torch.full((B, r_max - 1), NO_HOP, dtype=torch.int32, device=dev)],
            dim=1,
        )
    else:
        if r_max < 2:
            raise ValueError("dirty-read tail bounces need r_max >= 2")
        rb = read_bounce & ~is_write
        first = torch.where(rb, read_via.to(torch.int32), target)
        second = torch.where(rb, target, NO_HOP)
        read_nodes = torch.cat(
            [first[:, None], second[:, None],
             torch.full((B, r_max - 2), NO_HOP, dtype=torch.int32, device=dev)],
            dim=1,
        )
    chain_nodes = torch.where(is_write[:, None], write_nodes, read_nodes)

    base = torch.where(chain_nodes != NO_HOP, torch.tensor(model.service, dtype=f32, device=dev),
                       torch.tensor(0.0, dtype=f32, device=dev))
    # the service column's last product, (base, factor), kept for the
    # fused multiply-add below
    product = None
    if service_model is not None and service_model.kind != "fixed":
        rng, r_service = prng.split(rng)
        product = (base, service_model.draw(r_service, (B, r_max), dev))
        base = product[0] * product[1]
    if service_scale is not None:
        product = (base, service_scale[:, None].to(f32))
        base = product[0] * product[1]
    if rb is not None:
        col0 = torch.where(rb, torch.tensor(model.lookup, dtype=f32, device=dev),
                           base[:, 0])
        base = torch.cat([col0[:, None], base[:, 1:]], dim=1)
    needs_lookup = (
        is_write[:, None]
        & (chain_nodes != NO_HOP)
        & (pos < (visit_len - 1)[:, None])
    )
    lookup_cost = torch.where(needs_lookup,
                              torch.tensor(model.lookup, dtype=f32, device=dev),
                              torch.tensor(0.0, dtype=f32, device=dev))

    def with_lookup() -> torch.Tensor:
        """``base + lookup_cost`` as the reference's compiled plan adds it:
        XLA contracts the column's last product into the add, one fused
        multiply-add (but where a bounced read's first visit replaced
        it)."""
        if product is None:
            return base + lookup_cost
        out = prng.fma_f32(product[0], product[1], lookup_cost)
        if rb is not None:
            out[:, 0] = base[:, 0] + lookup_cost[:, 0]
        return out

    if mode == IN_SWITCH:
        nodes, service = chain_nodes, base
    elif mode == CLIENT_DRIVEN:
        nodes, service = chain_nodes, with_lookup()
    else:  # SERVER_DRIVEN: random entry coordinator, forwards if wrong
        coord = prng.randint(rng, (B,), 0, num_nodes, dev)
        entry_target = torch.where(is_write, chain[:, 0], target)
        wrong = coord != entry_target
        full_service = with_lookup()
        first = coord[:, None]
        rest = torch.where(wrong[:, None], chain_nodes,
                           _shift_left(chain_nodes, NO_HOP))
        nodes = torch.cat([first, rest], dim=1)
        coord_only = np.float32(model.lookup + model.coordinator)
        first_service = torch.where(
            wrong[:, None],
            torch.full((B, 1), float(coord_only), dtype=f32, device=dev),
            full_service[:, :1] + np.float32(model.coordinator),
        )
        rest_service = torch.where(wrong[:, None], full_service,
                                   _shift_left(full_service, 0.0))
        service = torch.cat([first_service, rest_service], dim=1)

    if redirect is not None:
        r_node = torch.where(redirect, redirect_via.to(torch.int32), NO_HOP)
        r_service = torch.where(redirect,
                                torch.tensor(model.lookup, dtype=f32, device=dev),
                                torch.tensor(0.0, dtype=f32, device=dev))
        nodes = torch.cat([r_node[:, None], nodes], dim=1)
        service = torch.cat([r_service[:, None], service], dim=1)

    if shed is not None:
        nodes = torch.where(shed[:, None], NO_HOP, nodes)
        service = torch.where(shed[:, None], 0.0, service)

    n_visits = (nodes != NO_HOP).to(f32).sum(dim=1)
    reply_links = (n_visits + 1.0) * np.float32(model.link)
    return HopPlan(nodes=nodes.to(torch.int32), service=service,
                   reply_links=reply_links)


# ---------------------------------------------------------------------------
# the heapq oracle (host side)
# ---------------------------------------------------------------------------


def _plan_host(plan: HopPlan):
    nodes = np.asarray(plan.nodes.cpu() if isinstance(plan.nodes, torch.Tensor)
                       else plan.nodes)
    service = plan.service.cpu().numpy() if isinstance(plan.service, torch.Tensor) \
        else np.asarray(plan.service)
    return nodes, service.astype(np.float64)


def _open_loop_heapq(nodes: np.ndarray, service: np.ndarray,
                     arr: np.ndarray, num_nodes: int, link: float):
    """The open-loop event loop on host arrays: ``(finish, hop_done)``
    float64 (each query's arrival is ``arr``)."""
    import heapq

    B, H = nodes.shape
    node_free = np.zeros((num_nodes,), np.float64)
    finish = np.zeros((B,), np.float64)
    hop_done = np.zeros((B, H), np.float64)
    heap: list[tuple[float, int, int]] = []
    for qid in range(B):
        heapq.heappush(heap, (arr[qid] + link, qid, 0))
    while heap:
        t, qid, hop = heapq.heappop(heap)
        while hop < H and nodes[qid, hop] == NO_HOP:
            hop += 1
        if hop >= H:
            finish[qid] = t
            continue
        n = nodes[qid, hop]
        start = max(t, node_free[n])
        done = start + service[qid, hop]
        node_free[n] = done
        hop_done[qid, hop] = done
        heapq.heappush(heap, (done + link, qid, hop + 1))
    return finish, hop_done


def _closed_loop_heapq(nodes: np.ndarray, service: np.ndarray,
                       n_clients: int, num_nodes: int, link: float,
                       think: float):
    """The closed-loop event loop on host arrays: ``(finish, issue,
    hop_done)`` float64 (client c issues ops c, c+K, c+2K, ...)."""
    import heapq

    B, H = nodes.shape
    K_ = min(n_clients, B)
    node_free = np.zeros((num_nodes,), np.float64)
    issue = np.zeros((B,), np.float64)
    finish = np.zeros((B,), np.float64)
    hop_done = np.zeros((B, H), np.float64)
    heap: list[tuple[float, int, int]] = []
    for c in range(K_):
        issue[c] = 0.0
        heapq.heappush(heap, (link, c, 0))
    while heap:
        t, qid, hop = heapq.heappop(heap)
        while hop < H and nodes[qid, hop] == NO_HOP:
            hop += 1
        if hop >= H:
            finish[qid] = t
            nxt = qid + K_
            if nxt < B:
                issue[nxt] = t + think
                heapq.heappush(heap, (t + think + link, nxt, 0))
            continue
        n = nodes[qid, hop]
        start = max(t, node_free[n])
        done = start + service[qid, hop]
        node_free[n] = done
        hop_done[qid, hop] = done
        heapq.heappush(heap, (done + link, qid, hop + 1))
    return finish, issue, hop_done


def _latency_out(finish, issue, hop_done, return_hops: bool):
    latency = finish - issue
    makespan = float(finish.max()) if finish.size else 0.0
    out = (torch.from_numpy(latency.astype(np.float32)),
           torch.tensor(makespan, dtype=torch.float32))
    return out + (hop_done,) if return_hops else out


def simulate_reference(plan: HopPlan, arrivals, *, num_nodes: int,
                       link: float = 1.0, return_hops: bool = False):
    """Discrete-event per-node-FIFO queueing simulation (heapq).  Returns
    ``(latency (B,) float32, makespan float32)`` tensors, plus the
    (B, H) float64 per-hop completion times with ``return_hops``."""
    nodes, service = _plan_host(plan)
    arr = np.asarray(arrivals.cpu() if isinstance(arrivals, torch.Tensor)
                     else arrivals, dtype=np.float64)
    finish, hop_done = _open_loop_heapq(nodes, service, arr, num_nodes, link)
    return _latency_out(finish, arr, hop_done, return_hops)


def simulate_closed_loop_reference(plan: HopPlan, *, n_clients: int,
                                   num_nodes: int, link: float = 1.0,
                                   think: float = 0.0,
                                   return_hops: bool = False):
    """Closed-loop heapq DES: client c issues ops c, c+K, c+2K, ...
    back to back."""
    nodes, service = _plan_host(plan)
    finish, issue, hop_done = _closed_loop_heapq(nodes, service, n_clients,
                                                 num_nodes, link, think)
    return _latency_out(finish, issue, hop_done, return_hops)
