"""Sharding rules: parameter / optimizer-state / activation / cache specs
(counterpart of ``repro.distributed.sharding``).

Logical layout on the production mesh:

  * "model"          tensor parallel: attention head-dim columns, FFN
                     hidden, expert axis (EP), vocab.
  * ("pod", "data")  data parallel (training batch; serving batch) and
                     ZeRO partitioning of optimizer state.
  * decode caches    batch on DP axes; sequence axis on "model"
                     (flash-decoding combine) or, for batch-1 long
                     context, on *all* axes.

Every rule checks divisibility against the mesh axis size and falls back
to replication: a config never fails to place because of a rule.

A spec is plain data, :class:`P`: one entry a tensor dim, each ``None``
(replicated), an axis name or a tuple of names (the dim split over those
axes, major first).  Spec trees mirror the port's nested-dict pytrees,
``P`` at the leaves.  :func:`to_placements` maps a spec to
``torch.distributed.tensor`` placements, one per mesh axis, with no
process group; a rule reads nothing of a mesh but ``shape`` and
``axis_names``.
"""

from __future__ import annotations

import math

from torch.distributed.tensor import Replicate, Shard

from repro_torch.training import tree as T


def _normal(entry):
    """A one-axis tuple is that axis, an empty one ``None`` (the same
    placement; JAX's PartitionSpec spells it so too)."""
    if isinstance(entry, tuple) and len(entry) <= 1:
        return entry[0] if entry else None
    return entry


class P(tuple):
    """A PartitionSpec: ``P(None, "model")``, ``P(("pod", "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, map(_normal, entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# leaves whose LAST axis is column-sharded on "model"
_COL = {
    "wq", "wk", "wv", "wg", "wu", "wi", "wuq", "wdq", "wdkv", "wukv",
    "in_proj", "w1", "w2", "bq", "bk", "bv", "bi", "conv_w", "conv_b",
    "norm_w",
}
# leaves whose second-to-last axis is row-sharded on "model"
_ROW = {"wo", "out_proj"}
_EMBED = {"embed"}
_HEAD = {"lm_head"}


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (``None``, a name or names)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def mesh_size(mesh, axis) -> int:
    """How many devices one spec entry splits a dim over."""
    return math.prod(mesh.shape[a] for a in spec_axes(axis))


def _spec_with(ndim: int, axis_idx: int, axis_name) -> P:
    spec = [None] * ndim
    spec[axis_idx] = axis_name
    return P(*spec)


def _replicated(ndim: int) -> P:
    return P(*([None] * ndim))


def _is_expert_leaf(path: tuple, ndim: int) -> bool:
    """A routed expert's (L, E, D, F) weight: its E axis goes on "model"."""
    return ("moe" in path and "shared" not in path and ndim >= 3
            and path[-1] in ("wg", "wu", "wo"))


def param_specs(abstract_params: dict, mesh, *,
                model_axis: str = "model") -> dict:
    """Spec tree for the parameters (matching ``abstract_params``)."""
    msize = mesh_size(mesh, model_axis)

    def rule(path, leaf):
        name, shape, nd = path[-1], tuple(leaf.shape), leaf.dim()
        if _is_expert_leaf(path, nd):
            e_axis = nd - 3
            if shape[e_axis] % msize == 0:
                return _spec_with(nd, e_axis, model_axis)
            return _replicated(nd)
        if name in _EMBED and nd == 2:
            return _spec_with(2, 0, model_axis) if shape[0] % msize == 0 else P(None, None)
        if name in _HEAD and nd == 2:
            return _spec_with(2, 1, model_axis) if shape[1] % msize == 0 else P(None, None)
        if name in _COL and nd >= 1 and shape[-1] % msize == 0:
            return _spec_with(nd, nd - 1, model_axis)
        if name in _ROW and nd >= 2 and shape[-2] % msize == 0:
            return _spec_with(nd, nd - 2, model_axis)
        return _replicated(nd)

    return T.map_with_path(rule, abstract_params)


def is_row_sharded(path: tuple, spec: P, model_axis: str = "model") -> bool:
    """A ``wo`` / ``out_proj`` leaf whose rows lie on ``model_axis``: its
    matmul's output is a partial sum that an all-reduce completes."""
    return (path[-1] in _ROW and len(spec) >= 2
            and model_axis in spec_axes(spec[-2]))


def zero_extend(specs: dict, abstract: dict, mesh, dp_axes) -> dict:
    """ZeRO: additionally shard each leaf over the DP axes on the first
    still-unsharded, divisible dimension (optimizer m/v and, optionally,
    master params)."""
    dsize = mesh_size(mesh, dp_axes)
    dp = spec_axes(dp_axes)

    def rule(spec, leaf):
        dims = list(spec) + [None] * (leaf.dim() - len(spec))
        # idempotent: leaves already carrying a DP axis are left untouched
        if any(a in dp for s in dims for a in spec_axes(s)):
            return P(*dims)
        for i, (s, n) in enumerate(zip(dims, leaf.shape)):
            if s is None and n > 0 and n % dsize == 0:
                dims[i] = dp
                break
        return P(*dims)

    return T.tree_map(rule, specs, abstract)


def sharded_bytes_per_device(abstract: dict, specs: dict, mesh) -> int:
    """Per-device resident bytes under the given specs."""
    total = 0
    for (_, leaf), (_, spec) in zip(T.items(abstract), T.items(specs)):
        n = leaf.numel() * leaf.element_size()
        for s in spec:
            for ax in spec_axes(s):
                n //= mesh.shape[ax]
        total += n
    return total


def state_specs(abstract_state: dict, mesh, *, model_axis: str = "model",
                dp_axes=("data",), zero: bool = True,
                fsdp_params: bool = False) -> dict:
    """Specs for the full train state {params, opt{m,v,step}, [err]}."""
    p_specs = param_specs(abstract_state["params"], mesh,
                          model_axis=model_axis)
    if fsdp_params:
        # ZeRO-3/FSDP: master params also sharded over the DP axes
        p_specs = zero_extend(p_specs, abstract_state["params"], mesh, dp_axes)
    opt = {}
    for k, sub in abstract_state["opt"].items():
        if k == "step":
            opt[k] = P()
        elif k == "f":  # adafactor's factored state: replicated
            opt[k] = T.tree_map(lambda l: _replicated(l.dim()), sub)
        else:  # m / v mirror params (+ ZeRO over dp)
            opt[k] = zero_extend(p_specs, sub, mesh, dp_axes) if zero else p_specs
    out = {"params": p_specs, "opt": opt}
    if "err" in abstract_state:
        out["err"] = p_specs
    return out


def batch_specs(abstract_batch: dict, dp_axes) -> dict:
    """Batch-leading activations sharded over the DP axes."""
    dp = spec_axes(dp_axes)
    return T.tree_map(lambda leaf: P(dp, *([None] * (leaf.dim() - 1))),
                      abstract_batch)


_SEQ_LEAVES = ("k", "v", "ka", "va", "kb", "vb", "ckv", "krope")


def cache_specs(abstract_cache: dict, mesh, *, dp_axes=("data",),
                model_axis: str = "model", seq_policy: str = "auto") -> dict:
    """Decode-cache specs.

    seq axis placement:
      * batch divisible by DP -> batch on DP; seq on "model" if divisible
        (flash-decoding combine across model shards), or with
        ``seq_policy="heads"`` the kv heads on "model".
      * batch == 1 long context -> seq over (DP + model) jointly.
    """
    dp = spec_axes(dp_axes)
    dsize = mesh_size(mesh, dp)
    msize = mesh.shape[model_axis]

    def rule(path, leaf):
        name, nd, shape = path[-1], leaf.dim(), tuple(leaf.shape)
        if name == "length":
            return P(dp) if shape[0] % dsize == 0 else P()
        # stacked leaves (L, B, ...): batch on dp only
        dims = [None] * nd
        batch_on_dp = nd >= 2 and shape[1] % dsize == 0
        if batch_on_dp:
            dims[1] = dp
        if name in _SEQ_LEAVES:
            S = shape[2]
            if batch_on_dp:
                if seq_policy == "heads" and nd >= 4 and shape[3] % msize == 0:
                    dims[3] = model_axis       # kv heads: local attention
                elif S % msize == 0:
                    dims[2] = model_axis
            else:
                # long-context batch-1: spread the sequence over everything
                if S % (dsize * msize) == 0:
                    dims[2] = dp + (model_axis,)
                elif S % msize == 0:
                    dims[2] = model_axis
        elif name == "ssm" and nd >= 3:
            if shape[2] % msize == 0:
                dims[2] = model_axis
        elif name == "conv" and nd >= 4:
            if shape[3] % msize == 0:
                dims[3] = model_axis
        elif name in ("ck", "cv") and nd >= 3:  # whisper cross K/V
            if shape[2] % msize == 0:
                dims[2] = model_axis
        return P(*dims)

    return T.map_with_path(rule, abstract_cache)


def to_placements(spec: P, mesh) -> tuple:
    """The ``torch.distributed.tensor`` placements of ``spec`` on
    ``mesh``: one per mesh axis, ``Shard(d)`` where the axis splits tensor
    dim d, else ``Replicate()``.  A dim split over several axes takes them
    major first, which DTensor expresses only in the mesh's own order."""
    names = list(mesh.axis_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"dim {d} of {spec} lists its axes out of the "
                             f"mesh's order {tuple(names)}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return tuple(out)
