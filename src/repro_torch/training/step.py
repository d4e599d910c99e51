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

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as MODEL
from repro_torch.models.transformer import model_dtype
from repro_torch.training import optimizer as OPT
from repro_torch.training import tree as T
from repro_torch.training.grad_compression import (compressed_psum,
                                                   init_error_feedback,
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


def abstract_train_state(cfg: ArchConfig, tcfg: TrainConfig) -> dict:
    """The train state's shapes and dtypes on the ``meta`` device (no
    allocation)."""
    return init_train_state(cfg, tcfg, device="meta")


def _recip(n: int) -> float:
    return float(np.float32(1) / np.float32(n))


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
    """(B, ...) -> n microbatches of B/n consecutive rows."""
    return [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(n)]


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
        inv = _recip(tcfg.microbatches)
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


def make_dp_train_step(cfg: ArchConfig, tcfg: TrainConfig,
                       n_dp: int) -> Callable:
    """The data-parallel step with the int8-compressed gradient sum, as
    one controller over ``n_dp`` ranks on one device: rank r takes rows
    [r B / n_dp, (r + 1) B / n_dp) of the batch and its own error buffer;
    the parameters and optimizer state are the ranks' common replica.

    Signature of the returned fn: (state, err, batch) -> (state, err,
    metrics), err leaves (n_dp, *param_shape).  Floating metrics are the
    ranks' mean, integer ones their sum (the reference's pmean / psum)."""
    assert tcfg.grad_compression, "use make_train_step for the uncompressed path"

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
            total = rank_sum(torch.stack([
                m[k] if k in m else opt_metrics[k] for m, _ in per_rank]))
            metrics[k] = (total * _recip(n_dp) if total.is_floating_point()
                          else total)
        return {"params": new_params, "opt": new_opt}, new_err, metrics

    return dp_step


def init_dp_error_feedback(cfg: ArchConfig, params: dict, n_dp: int) -> dict:
    """(n_dp, *shape) bf16 error-feedback buffers for make_dp_train_step."""
    return T.tree_map(lambda p: torch.zeros((n_dp,) + tuple(p.shape),
                                            dtype=torch.bfloat16,
                                            device=p.device), params)
