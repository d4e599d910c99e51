"""Mixture-of-experts layer: shared + routed experts, top-k dispatch
(counterpart of ``repro.models.moe``).

The token -> expert dispatch is key-based routing: the router's top-k is
the key, experts are the storage nodes, and capacity-bounded dispatch
mirrors the bounded switch queues of the data plane (tokens past an
expert's capacity are dropped, like bucket overflow in
``core.dist_store``, and keep the shared-expert path).

Two dispatch modes, as in the reference:

* ``gather`` (default): each assignment's place in its expert's queue
  from a stable sort, then token gathers into (E, C, D) expert batches.
  The combine is a gather too: each token adds its kept contributions in
  ascending slot (= ascending expert) order, each add rounded to the
  activations' dtype.  That is the order of the reference's scatter-add
  ``y.at[tos].add(...)`` on the CPU, and a gather fixes it on the card,
  where ``index_add_`` is atomic and its order is not.
* ``einsum``: Switch-style one-hot dispatch, kept as the readable oracle
  (it materializes (N, E, C) one-hots).

Parameter leaves carry no layer axis here; the transformer stacks them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.constraints import constrain
from repro_torch.models.common import activation, dense_init
from repro_torch.models.ffn import init_swiglu, swiglu


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
             n_layers: int) -> dict:
    """The MoE parameters of ``n_layers`` stacked layers."""
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    L = (n_layers,)
    p = {
        "router": dense_init(gen, L + (D, E), dtype, scale=0.02),
        "wg": dense_init(gen, L + (E, D, Fe), dtype),
        "wu": dense_init(gen, L + (E, D, Fe), dtype),
        "wo": dense_init(gen, L + (E, Fe, D), dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_swiglu(gen, D, Fe * cfg.n_shared_experts, dtype,
                                  n_layers)
    return p


def _capacity(T: int, cfg: ArchConfig) -> int:
    c = int(T * cfg.top_k / cfg.n_experts * cfg.moe_capacity_factor)
    return max(8, ((c + 7) // 8) * 8)  # sublane-aligned


def top_k(probs: torch.Tensor, k: int):
    """The ``k`` largest of each row and their indices, ties broken lowest
    index first (``lax.top_k``'s order, which ``torch.topk`` does not
    keep; a stable descending sort gives it on every device)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_layer(x: torch.Tensor, p: dict, cfg: ArchConfig, *,
              dispatch: str = "gather"):
    """x (B, T, D) -> (y (B, T, D), aux): ``moe_aux_loss`` (the Switch
    load-balance term, float32) and ``moe_dropped`` (assignments past
    capacity, int32), both 0-d tensors on x's device."""
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    xf = x.reshape(B * T, D)
    N = B * T
    C = _capacity(N, cfg)

    logits = (xf @ p["router"]).float()                       # (N, E)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    gate_vals, topk_idx = top_k(probs, K)                     # (N, K)
    if cfg.router_softmax_after_topk:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp(
            min=1e-9)

    # load-balance auxiliary loss (Switch): E * sum_e f_e * P_e
    me = probs.mean(dim=0)                                    # (E,)
    flat = topk_idx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=x.device).index_add_(
        0, flat, torch.ones_like(flat))        # bincount (no meta shape)
    ce = counts.float() / (N * K)
    aux_loss = E * (me * ce).sum()

    if dispatch == "einsum":
        y, dropped = _dispatch_einsum(xf, p, cfg, topk_idx, gate_vals, C)
    else:
        y, dropped = _dispatch_gather(xf, p, cfg, topk_idx, gate_vals, C)

    if cfg.n_shared_experts:
        y = y + swiglu(xf, p["shared"], cfg)

    aux = {"moe_aux_loss": aux_loss, "moe_dropped": dropped}
    return y.reshape(B, T, D), aux


def _expert_ffn(p: dict, cfg: ArchConfig, xe: torch.Tensor) -> torch.Tensor:
    """xe (E, C, D) -> (E, C, D), batched over the expert axis."""
    act = activation(cfg.act)
    h = act(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wu"])
    return torch.bmm(h, p["wo"])


def _dispatch_gather(xf, p, cfg: ArchConfig, topk_idx, gate_vals, C: int):
    N, D = xf.shape
    E, K = cfg.n_experts, cfg.top_k
    dev = xf.device
    EC = E * C

    flat_e = topk_idx.reshape(N * K)                          # (NK,)
    flat_g = gate_vals.reshape(N * K)
    token_of = torch.arange(N * K, device=dev) // K

    # position of each assignment within its expert queue (stable by token)
    sorted_e, order = torch.sort(flat_e, stable=True)
    group_start = torch.searchsorted(sorted_e,
                                     torch.arange(E + 1, device=dev))
    pos_sorted = torch.arange(N * K, device=dev) - group_start[sorted_e]
    keep = pos_sorted < C
    slot_sorted = torch.where(keep, sorted_e * C + pos_sorted, EC)
    dropped = (~keep).sum().to(torch.int32)

    # token and gate per (expert, slot): padding slots point at row N (a
    # zero row); the drops all land in a spare slot EC, sliced off (the
    # reference's ``mode="drop"``)
    tos = torch.full((EC + 1,), N, dtype=torch.int64, device=dev).scatter_(
        0, slot_sorted, token_of[order])[:EC]
    gos = torch.zeros((EC + 1,), dtype=torch.float32, device=dev).scatter_(
        0, slot_sorted, flat_g[order])[:EC]

    x_pad = torch.cat([xf, xf.new_zeros((1, D))])
    xe = constrain(x_pad[tos].reshape(E, C, D), "moe_expert")
    ye = constrain(_expert_ffn(p, cfg, xe), "moe_expert").reshape(EC, D)
    contrib = (ye * gos[:, None]).to(xf.dtype)

    slot_of = torch.empty_like(slot_sorted)
    slot_of[order] = slot_sorted
    return combine(contrib, slot_of.reshape(N, K)), dropped


def combine(contrib: torch.Tensor, slot_of: torch.Tensor) -> torch.Tensor:
    """y (N, D) from the expert slots' weighted outputs ``contrib`` (EC, D)
    and each (token, k)'s slot ``slot_of`` (N, K), EC where dropped.  A
    token adds its kept slots in ascending order into a zero row, each add
    rounded to contrib's dtype: the reference's scatter-add
    ``zeros.at[tos].add(contrib)``, which walks the slots in order, but as
    a gather, so the order holds on the card too."""
    EC, D = contrib.shape
    contrib = torch.cat([contrib, contrib.new_zeros((1, D))])  # slot EC: 0
    slots = slot_of.sort(dim=1).values
    y = contrib.new_zeros((slot_of.shape[0], D))
    for j in range(slots.shape[1]):
        s = slots[:, j]
        y = torch.where((s < EC)[:, None], y + contrib[s], y)
    return y


def _dispatch_einsum(xf, p, cfg: ArchConfig, topk_idx, gate_vals, C: int):
    """Readable Switch-style oracle (materializes (N, E, C) one-hots)."""
    N, D = xf.shape
    E, K = cfg.n_experts, cfg.top_k

    onehot = F.one_hot(topk_idx, E).float()                   # (N, K, E)
    # position within expert queue, in token order, accounting all K slots
    flat = onehot.reshape(N * K, E)
    pos = flat.cumsum(dim=0) - flat                           # (NK, E)
    pos_of = (pos * flat).sum(dim=-1).reshape(N, K)           # (N, K)
    keep = pos_of < C
    dropped = (~keep).sum().to(torch.int32)
    # a dropped assignment's one-hot is all zeros (class C is sliced off)
    slot_oh = F.one_hot(torch.where(keep, pos_of, C).long(), C + 1)[..., :C]
    disp = torch.einsum("nke,nkc->nec", onehot * keep[..., None],
                        slot_oh.float())
    comb = torch.einsum("nec,nk,nke->nec", disp, gate_vals, onehot)

    xe = torch.einsum("nec,nd->ecd", disp, xf.float()).to(xf.dtype)
    ye = _expert_ffn(p, cfg, xe)
    y = torch.einsum("nec,ecd->nd", comb, ye.float()).to(xf.dtype)
    return y, dropped
