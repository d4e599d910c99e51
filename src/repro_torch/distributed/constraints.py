"""Activation sharding constraints (counterpart of
``repro.distributed.constraints``).

Pinning the hidden-state layout at layer boundaries leaves the runtime no
freedom to reshard mid-stack.  The model code stays mesh-agnostic: it
calls ``constrain(x, kind)`` through a contextvar-installed policy, and a
launcher installs a policy built from its mesh.  The default is identity
(no constraints: the paper-faithful baseline).

A policy redistributes only a ``DTensor``, onto the placements of the
kind's spec on the tensor's own device mesh.  A plain tensor on one card
comes back unchanged, so the single-card paths run as before.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable

_POLICY: contextvars.ContextVar[Callable | None] = contextvars.ContextVar(
    "activation_policy", default=None)


def constrain(x, kind: str):
    """Apply the installed activation-sharding policy (identity if none)."""
    policy = _POLICY.get()
    return x if policy is None else policy(x, kind)


@contextlib.contextmanager
def activation_policy(policy: Callable):
    token = _POLICY.set(policy)
    try:
        yield
    finally:
        _POLICY.reset(token)


class MeshPolicy:
    """The standard layout pins on ``mesh``:

    hidden   (B, T, D)  -> (dp, None, None)
    ffn      (B, T, F)  -> (dp, None, model)
    logits   (B, T, V)  -> (dp, None, model)
    moe_expert (E, C, D) -> (model, None, None)
    tokens2d (N, D)     -> (dp, None)

    ``seq_attn`` adds sequence-parallel attention (Ulysses-style: q and
    the attention output sharded over T, K/V gathered); ``seq_residual``
    shards the residual stream itself over T (Megatron sequence
    parallelism)."""

    def __init__(self, mesh, dp_axes, model_axis: str = "model",
                 seq_residual: bool = False, seq_attn: bool = False):
        # imported here: the models import this module, and the rules'
        # tree helpers (training.tree) import the models
        from repro_torch.distributed.sharding import P, spec_axes

        self.mesh = mesh
        dp = spec_axes(tuple(dp_axes) if not isinstance(dp_axes, str) else dp_axes)
        self.specs = {
            "hidden": P(dp, None, None),
            "ffn": P(dp, None, model_axis),
            "logits": P(dp, None, model_axis),
            "moe_expert": P(model_axis, None, None),
            "tokens2d": P(dp, None),
        }
        if seq_attn:
            self.specs.update({
                "attn_q": P(dp, model_axis, None, None),
                "attn_kv": P(dp, None, None, None),
                "attn_out": P(dp, model_axis, None, None),
            })
        if seq_residual:
            self.specs["hidden"] = P(dp, model_axis, None)

    def spec(self, shape: tuple[int, ...], kind: str):
        """The spec (a ``sharding.P``) a ``kind`` tensor of ``shape`` is
        pinned to, or None (no pin for the kind, another rank, or a dim
        the mesh does not divide: a constraint must be satisfiable)."""
        from repro_torch.distributed.sharding import mesh_size

        spec = self.specs.get(kind)
        if spec is None or len(shape) != len(spec):
            return None
        if any(dim % mesh_size(self.mesh, s) for dim, s in zip(shape, spec)):
            return None
        return spec

    def __call__(self, x, kind: str):
        from torch.distributed.tensor import DTensor

        from repro_torch.distributed.sharding import to_placements

        spec = self.spec(tuple(x.shape), kind)
        if spec is None or not isinstance(x, DTensor):
            return x
        return x.redistribute(x.device_mesh, to_placements(spec, self.mesh))


def make_mesh_policy(mesh, dp_axes, model_axis: str = "model",
                     seq_residual: bool = False,
                     seq_attn: bool = False) -> MeshPolicy:
    return MeshPolicy(mesh, dp_axes, model_axis, seq_residual, seq_attn)
