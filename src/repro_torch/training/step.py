"""Train-step factory: loss -> grads -> (optional compressed sum) -> opt
(counterpart of ``repro.training.step``).

A step is a plain function ``(state, batch) -> (new_state, metrics)`` on
tensor dicts; it never changes the state it is given.  The master
weights stay in ``cfg.param_dtype``; the cast to the compute dtype
``cfg.dtype`` happens inside the autograd graph, so the gradients land on
the master leaves in their own dtype.  Microbatching (gradient
accumulation) sums the microbatches' float32 gradients in order; remat
is forwarded to the layer loop (``models.transformer.forward_seq``).

``state``: ``params`` (the master weights), ``opt`` (the optimizer
state, ``step`` an int32 count) and, with ``grad_compression``, ``err``
(bf16 error-feedback buffers), the reference's layout leaf for leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import model as MODEL
from repro_torch.models.transformer import model_dtype
from repro_torch.training import optimizer as OPT
from repro_torch.training import tree as T
from repro_torch.training.grad_compression import (all_gather_rows,
                                                   compressed_psum,
                                                   f32_recip,
                                                   gather_mean,
                                                   init_error_feedback,
                                                   quantize_payload,
                                                   rank_sum)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OPT.OptConfig = OPT.OptConfig()
    microbatches: int = 1           # gradient-accumulation steps
    remat: bool = True              # checkpoint layer bodies
    grad_compression: bool = False  # int8 DP sum with error feedback


def init_train_state(cfg: ArchConfig, tcfg: TrainConfig, seed: int = 0, *,
                     device=None) -> dict:
    """Master weights from the port's seeded init in ``cfg.param_dtype``,
    optimizer state in ``cfg.opt_state_dtype``, on ``device`` (default
    the card)."""
    params = MODEL.init_params(cfg, seed, device=device,
                               dtype=cfg.param_dtype)
    state = {"params": params,
             "opt": OPT.opt_init(params, tcfg.opt, cfg.opt_state_dtype)}
    if tcfg.grad_compression:
        state["err"] = init_error_feedback(params)
    return state


def init_placed_train_state(cfg: ArchConfig, tcfg: TrainConfig, mesh,
                            specs: dict, seed: int = 0) -> dict:
    """:func:`init_train_state` placed on ``mesh`` (a
    ``training.elastic.DistMesh``) by ``specs``: every rank draws the
    same master weights on its device, keeps its shards and frees the
    whole leaves, and makes only its shards of the optimizer's zeros, so
    the placed state equals the one-device state leaf for leaf."""
    from repro_torch.distributed.sharding import place, to_placements

    if tcfg.grad_compression:
        raise NotImplementedError(
            "the placed (DTensor) state has no int8-compressed step: the "
            "compressed sum runs over ranks in make_dp_train_step(cfg, tcfg, "
            "mesh), on init_train_state's replicated state and "
            "init_placed_dp_error_feedback's error buffers")
    params = place(MODEL.init_params(cfg, seed, device=mesh.device,
                                     dtype=cfg.param_dtype),
                   specs["params"], mesh)

    def zeros(leaf, spec):
        placements = to_placements(spec, mesh)
        shape = TP.local_shard(leaf, mesh.device_mesh, placements).shape
        local = torch.zeros(shape, dtype=leaf.dtype, device=mesh.device)
        return TP.from_local_layout(local, mesh.device_mesh, placements)

    abstract = abstract_train_state(cfg, tcfg)
    return {"params": params,
            "opt": T.tree_map(zeros, abstract["opt"], specs["opt"])}


def abstract_train_state(cfg: ArchConfig, tcfg: TrainConfig) -> dict:
    """The train state's shapes and dtypes on the ``meta`` device (no
    allocation)."""
    return init_train_state(cfg, tcfg, device="meta")


def value_and_grad(cfg: ArchConfig, params: dict, batch: dict, *,
                   remat: bool = False):
    """((loss, metrics), grads) of ``models.loss_fn`` at ``params``, each
    float32 / bfloat16 leaf cast to ``cfg.dtype`` inside the graph.  The
    gradients have the master leaves' dtypes; a leaf the loss does not
    reach gets zeros."""
    cast = model_dtype(cfg)
    floats = (torch.float32, torch.bfloat16)
    paths = [path for path, _ in T.items(params)]
    req = T.tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        compute = T.tree_map(
            lambda p: p.to(cast) if p.dtype in floats else p, req)
        loss, metrics = MODEL.loss_fn(compute, cfg, batch, remat=remat)
        flat = T.leaves(req)
        got = torch.autograd.grad(loss, flat, allow_unused=True)
    by_path = {path: torch.zeros_like(p) if g is None else g
               for path, p, g in zip(paths, flat, got)}
    grads = T.map_with_path(lambda path, _: by_path[path], params)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), grads


def _split_micro(batch: dict, n: int) -> list[dict]:
    """(B, ...) -> n microbatches of B/n consecutive rows.  A batch split
    over the data axes (``DTensor``) is gathered, cut the same way, and
    each microbatch split over the data axes again: consecutive rows lie
    on one rank, and the microbatches' rows must be those of the one-card
    step (their token counts weight the mean)."""
    whole = {k: TP.whole(v) for k, v in batch.items()}
    return [{k: TP.laid_out_as(
        w.reshape(n, w.shape[0] // n, *w.shape[1:])[i], batch[k])
        for k, w in whole.items()} for i in range(n)]


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig) -> Callable:
    def grads_of(params, batch):
        if tcfg.microbatches == 1:
            return value_and_grad(cfg, params, batch, remat=tcfg.remat)
        gsum = lsum = None
        for mb in _split_micro(batch, tcfg.microbatches):
            (loss, metrics), grads = value_and_grad(cfg, params, mb,
                                                    remat=tcfg.remat)
            grads = T.tree_map(lambda g: g.float(), grads)
            gsum = grads if gsum is None else T.tree_map(
                torch.add, gsum, grads)
            lsum = loss if lsum is None else lsum + loss
        inv = f32_recip(tcfg.microbatches)
        # the metrics are the last microbatch's
        return ((lsum * inv, metrics),
                T.tree_map(lambda g: g * inv, gsum))

    def train_step(state: dict, batch: dict):
        params = state["params"]
        (loss, metrics), grads = grads_of(params, batch)
        new_state = {}
        if tcfg.grad_compression:   # one rank: its own error feedback
            grads, err = compressed_psum(
                T.tree_map(lambda g: g[None], grads),
                T.tree_map(lambda e: e[None], state["err"]))
            new_state["err"] = T.tree_map(lambda e: e[0], err)
        new_params, new_opt, opt_metrics = OPT.opt_update(
            params, grads, state["opt"], tcfg.opt)
        new_state.update(params=new_params, opt=new_opt)
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_dp_train_step(cfg: ArchConfig, tcfg: TrainConfig, mesh,
                       dp_axes=("data",)) -> Callable:
    """The data-parallel step with the int8-compressed gradient sum (the
    reference's ``make_dp_train_step``): rank r takes rows [r B / n_dp,
    (r + 1) B / n_dp) of the batch and its own error buffer; the
    parameters and optimizer state are the ranks' common replica.

    ``mesh`` chooses the form:

    * an ``int`` ``n_dp``: one controller runs the ``n_dp`` ranks in turn
      on one device (``dp_axes`` unused);
    * a ``training.elastic.DistMesh``: this process is one rank of the
      group of ``dp_axes`` (:func:`_ranked_dp_step`).

    Signature of the returned fn: (state, err, batch) -> (state, err,
    metrics), err leaves (n_dp, *param_shape).  Floating metrics are the
    ranks' mean, integer ones their sum (the reference's pmean / psum),
    each added in rank order; both forms agree bit for bit."""
    assert tcfg.grad_compression, "use make_train_step for the uncompressed path"
    if not isinstance(mesh, int):
        return _ranked_dp_step(cfg, tcfg, mesh, tuple(dp_axes))
    n_dp = mesh

    def dp_step(state: dict, err: dict, batch: dict):
        params = state["params"]
        per_rank = []
        for mb in _split_micro(batch, n_dp):
            (loss, metrics), grads = value_and_grad(cfg, params, mb,
                                                    remat=tcfg.remat)
            per_rank.append(({"loss": loss, **metrics}, grads))
        stacked = T.tree_map(lambda *gs: torch.stack(gs),
                             *(g for _, g in per_rank))
        grads, new_err = compressed_psum(stacked, err)
        new_params, new_opt, opt_metrics = OPT.opt_update(
            params, grads, state["opt"], tcfg.opt)
        metrics = {}
        for k in (*per_rank[0][0], *opt_metrics):
            # the optimizer's metrics are every rank's, alike
            metrics[k] = _rank_mean(torch.stack([
                m[k] if k in m else opt_metrics[k] for m, _ in per_rank]))
        return {"params": new_params, "opt": new_opt}, new_err, metrics

    return dp_step


def _rank_mean(x: torch.Tensor) -> torch.Tensor:
    """A metric over its leading rank axis: the ranks' sum in rank order,
    times float32(1) / float32(n) for a floating one."""
    total = rank_sum(x)
    if not total.is_floating_point():
        return total
    return total * f32_recip(x.shape[0])


def dp_group(mesh, dp_axes=("data",)):
    """(the process group of ``mesh``'s ``dp_axes``, its size, this rank's
    place in it).  Several axes are flattened, the first major, as the
    reference's ``P(dp_axes)`` orders the rows."""
    dm = mesh.device_mesh
    if len(dp_axes) == 1:
        group = dm.get_group(dp_axes[0])
    else:
        group = dm[tuple(dp_axes)]._flatten().get_group()
    return group, dist.get_world_size(group), dist.get_rank(group)


def _own_rows(x: torch.Tensor, n: int, r: int) -> torch.Tensor:
    """Rank r's rows of a batch leaf: a ``DTensor`` split over the DP axes
    (``launch.train.mesh_batch``) is already this rank's rows; a plain
    tensor is the whole batch, which every rank holds."""
    if not TP.is_dtensor(x):
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])[r]
    if x.to_local().shape[0] * n != x.shape[0]:
        raise ValueError(f"a batch DTensor {x.placements} is not split over "
                         f"the {n} DP ranks alone")
    return x.to_local()


def _ranked_dp_step(cfg: ArchConfig, tcfg: TrainConfig, mesh,
                    dp_axes) -> Callable:
    """:func:`make_dp_train_step` as one rank of the group of ``dp_axes``
    on ``mesh``.  This rank holds the replicated state as plain tensors on
    its device (``init_train_state`` without ``err``), its rows of the
    batch, and its own error buffers: the leaves of
    :func:`init_placed_dp_error_feedback`, ``DTensor``s (n_dp, *shape)
    split over ``dp_axes``, of which it unwraps its (1, *shape) slice.
    The loss runs on plain tensors, as on one card;
    the gradient's sum is :func:`~grad_compression.quantize_payload` and
    :func:`~grad_compression.gather_mean`, the metrics are all-gathered
    and added in rank order, so every rank applies the same update to the
    same replica.  On a mesh with other axes their ranks of a DP row
    compute the same step.

    The returned fn also takes ``spans=`` (a dict): the compressed sum's
    quantize, gather and dequantize-and-add blocks as (start, end) pairs,
    CUDA events on a card."""
    group, n, r = dp_group(mesh, dp_axes)

    def dp_step(state: dict, err: dict, batch: dict, *, spans=None):
        params = state["params"]
        rows = {k: _own_rows(v, n, r) for k, v in batch.items()}
        (loss, metrics), grads = value_and_grad(cfg, params, rows,
                                                remat=tcfg.remat)
        local = T.tree_map(lambda e: e.to_local()[0], err)
        payload, new_err = quantize_payload(grads, local, spans)
        del grads, local
        grads = gather_mean(payload, group, spans)
        del payload
        new_params, new_opt, opt_metrics = OPT.opt_update(
            params, grads, state["opt"], tcfg.opt)
        ranked = _gather_metrics({"loss": loss, **metrics}, group, n)
        # the optimizer's metrics are every rank's, alike
        ranked.update({k: v.expand(n) for k, v in opt_metrics.items()})
        new_err = T.tree_map(lambda e, like: TP.from_local_layout(
            e[None], like.device_mesh, like.placements), new_err, err)
        return ({"params": new_params, "opt": new_opt}, new_err,
                {k: _rank_mean(v) for k, v in ranked.items()})

    return dp_step


def _gather_metrics(metrics: dict, group, n: int) -> dict:
    """Each metric's (n,) values over the group's ranks, in rank order:
    one all-gather a dtype, never through host floats."""
    out = {}
    for dtype in dict.fromkeys(v.dtype for v in metrics.values()):
        keys = [k for k, v in metrics.items() if v.dtype == dtype]
        every = all_gather_rows(torch.stack([metrics[k] for k in keys]),
                                group, n)
        out.update({k: every[:, i] for i, k in enumerate(keys)})
    return {k: out[k] for k in metrics}


def init_dp_error_feedback(cfg: ArchConfig, params: dict, n_dp: int) -> dict:
    """(n_dp, *shape) bf16 error-feedback buffers for make_dp_train_step."""
    return T.tree_map(lambda p: torch.zeros((n_dp,) + tuple(p.shape),
                                            dtype=torch.bfloat16,
                                            device=p.device), params)


def init_placed_dp_error_feedback(cfg: ArchConfig, params: dict, mesh,
                                  dp_axes=("data",)) -> dict:
    """:func:`init_dp_error_feedback` for the ranked
    :func:`make_dp_train_step`: (n_dp, *shape) bf16 zeros as ``DTensor``s
    split over ``dp_axes`` of ``mesh`` (a ``DistMesh``) and replicated
    over its other axes; each rank makes only its (1, *shape) slice."""
    from torch.distributed.tensor import Replicate, Shard

    placements = [Shard(0) if a in dp_axes else Replicate()
                  for a in mesh.axis_names]

    def zeros(p):
        local = torch.zeros((1,) + tuple(p.shape), dtype=torch.bfloat16,
                            device=mesh.device)
        return TP.from_local_layout(local, mesh.device_mesh, placements)

    return T.tree_map(zeros, params)
