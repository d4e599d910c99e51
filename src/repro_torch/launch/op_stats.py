"""Op, byte and collective counts of one step, without HLO: the port's
counterpart of ``repro.launch.hlo_stats``, rebuilt on PyTorch's tooling
rather than transliterated (there is no HLO to parse).

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the port's own
  step on ``meta`` tensors, which counts what ``analyze_hlo`` counts:
  matmuls and convolutions (2 x output x contraction), no elementwise
  work.  Where the reference multiplies a ``while`` body by its trip
  count, this counts **one layer of each kind** (:func:`layer_census`:
  gemma3's local and global layers, llama4's dense + MoE pair, deepseek's
  leading dense layer, hymba's local and global mixed layers, whisper's
  encoder and decoder layers) and multiplies it by how many layers of
  that kind the config has; the embedding, the head and the loss are
  counted once, from the step at the least depth that keeps every layer
  group (:func:`cut_config`).  A production cell counts in seconds; the
  whole step at full depth would run the flash block loop of every
  layer.
* Bytes: the step's compulsory HBM traffic per device, each argument
  read once and each output written once (a lower bound, where
  ``analyze_hlo`` sums its fusions' operands and outputs).
* Collectives: a ring model of the placement, with the reference's wire
  factors (all-reduce 2x the payload, the rest 1x): for a train step the
  gradient reduction over the DP axes (an all-reduce, or a
  reduce-scatter plus an all-gather of the updated leaf where ZeRO shards
  its optimizer state), and one all-reduce over "model" of the output of
  each row-sharded matmul (``wo``, ``out_proj``) in every layer, for each
  pass the step runs (forward; recompute under remat; backward).
"""

from __future__ import annotations

import collections
import dataclasses

import torch
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed import sharding as SH
from repro_torch.launch import input_specs as ISPEC
from repro_torch.launch.mesh import group_bandwidth
from repro_torch.models import encdec as ED
from repro_torch.models import model as MODEL
from repro_torch.models import transformer as TF
from repro_torch.training import tree as T
from repro_torch.training.step import (TrainConfig, abstract_train_state,
                                       make_train_step)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter")
WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0}
_FLOATS = (torch.float32, torch.bfloat16)


def count_flops(fn, *args, **kw) -> int:
    """Dot and convolution FLOPs of ``fn(*args, **kw)``."""
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kw)
    return int(fc.get_total_flops())


def _meta(shape, dtype, grad: bool = False) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


# ---------------------------------------------------------------------------
# the step, whole
# ---------------------------------------------------------------------------


def step_fn(cfg: ArchConfig, shape: ShapeSpec, tcfg: TrainConfig):
    """The step the shape's kind runs: train_step(state, batch),
    prefill(params, batch) or decode_step(params, tokens, cache)."""
    if shape.kind == "train":
        return make_train_step(cfg, tcfg)
    if shape.kind == "prefill":
        return lambda params, batch: MODEL.prefill(params, cfg, batch,
                                                   cache_len=shape.seq_len)
    return lambda params, tokens, cache: MODEL.decode_step(params, cfg,
                                                           tokens, cache)


def abstract_args(cfg: ArchConfig, shape: ShapeSpec,
                  tcfg: TrainConfig) -> tuple:
    """:func:`step_fn`'s arguments on ``meta``."""
    spec = ISPEC.input_specs(cfg, shape)
    if shape.kind == "train":
        return abstract_train_state(cfg, tcfg), spec["batch"]
    params = MODEL.init_params(cfg, device="meta")    # served in cfg.dtype
    if shape.kind == "prefill":
        return params, spec["batch"]
    return params, spec["tokens"], spec["cache"]


def whole_step_flops(cfg: ArchConfig, shape: ShapeSpec,
                     tcfg: TrainConfig) -> int:
    """FLOPs of the whole step at the config's full depth (the reference
    the per-layer count is held to; slow at production shapes)."""
    return count_flops(step_fn(cfg, shape, tcfg),
                       *abstract_args(cfg, shape, tcfg))


# ---------------------------------------------------------------------------
# one layer of each kind
# ---------------------------------------------------------------------------


def cut_config(cfg: ArchConfig) -> ArchConfig:
    """``cfg`` at the least depth that keeps every layer group: one layer
    (deepseek's dense layer and one MoE layer; llama4's one pair;
    whisper's one encoder and one decoder layer)."""
    n = cfg.first_dense_layers + max(cfg.moe_layer_step, 1) if cfg.n_experts else 1
    kw = {"n_layers": n}
    if cfg.n_encoder_layers:
        kw["n_encoder_layers"] = 1
    return dataclasses.replace(cfg, **kw)


def layer_census(cfg: ArchConfig) -> dict[tuple[str, bool], int]:
    """How many layers of each kind the config runs, keyed by (kind,
    attends globally); whisper's are ("enc", False) and ("dec", False)."""
    if cfg.family == "encdec":
        return {("enc", False): cfg.n_encoder_layers,
                ("dec", False): cfg.n_layers}
    census: dict = collections.Counter()
    for g in TF.layer_groups(cfg):
        for flag in TF.global_flags(cfg, g.layer_ids):
            census[(g.kind, flag)] += 1
    return dict(census)


def _layer_params(cfg: ArchConfig, params: dict, kind: str) -> dict:
    """One layer's parameters of ``kind`` (views of the stacked leaves)."""
    if cfg.family == "encdec":
        return TF._layer(params[kind], 0)
    group = next(g for g in TF.layer_groups(cfg) if g.kind == kind)
    return TF._layer(params[group.name], 0)


def positions(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """The positions a decoder layer sees: seq_len (the vlm's patches are
    part of it, ``input_specs``) and hymba's meta tokens."""
    return shape.seq_len + cfg.n_meta_tokens


def _train_layer(cfg, kind, flag, lp_master, B, n_pos, remat):
    """Forward, recompute (with remat) and backward of one layer."""
    dt = TF.model_dtype(cfg)
    req = T.tree_map(lambda p: p.detach().requires_grad_(True), lp_master)
    lp = T.tree_map(lambda p: p.to(dt) if p.dtype in _FLOATS else p, req)
    leaves = T.leaves(req)
    if kind == "enc":
        x = _meta((B, cfg.encoder_len, cfg.d_model), dt, grad=True)
        outs, ins = [ED._enc_layer(x, lp, cfg)], [x]
    elif kind == "dec":
        x = _meta((B, n_pos, cfg.d_model), dt, grad=True)
        enc = _meta((B, cfg.encoder_len, cfg.d_model), dt, grad=True)
        outs, ins = [ED._dec_layer(x, lp, cfg, enc)[0]], [x, enc]
    else:
        x = _meta((B, n_pos, cfg.d_model), dt, grad=True)
        layer = ((lambda *a: checkpoint(TF._layer_seq, *a, use_reentrant=False))
                 if remat else TF._layer_seq)
        y, aux, _ = layer(x, lp, cfg, kind, flag, False)
        outs, ins = [y, *aux.values()], [x]
        outs = [o for o in outs if o.is_floating_point()]
    torch.autograd.grad(outs, ins + leaves,
                        grad_outputs=[torch.ones_like(o) for o in outs],
                        allow_unused=True)


def _prefill_layer(cfg, kind, flag, lp, B, n_pos):
    dt = TF.model_dtype(cfg)
    if kind == "enc":
        ED._enc_layer(_meta((B, cfg.encoder_len, cfg.d_model), dt), lp, cfg)
    elif kind == "dec":
        ED._dec_layer(_meta((B, n_pos, cfg.d_model), dt), lp, cfg,
                      _meta((B, cfg.encoder_len, cfg.d_model), dt))
    else:
        TF._layer_seq(_meta((B, n_pos, cfg.d_model), dt), lp, cfg, kind,
                      flag, True)


def _decode_layer(cfg, kind, flag, lp, cache):
    dt = TF.model_dtype(cfg)
    B = cache["length"].shape[0]
    x, length = _meta((B, 1, cfg.d_model), dt), cache["length"]
    if kind == "dec":
        enc_len = _meta((B,), torch.int32)
        ED._dec_layer_decode(x, lp, cfg, cache, 0, length, enc_len)
        return
    group = next(g for g in TF.layer_groups(cfg) if g.kind == kind)
    TF._layer_decode(x, lp, cfg, kind, cache[group.name], 0, length, flag)


def step_flops(cfg: ArchConfig, shape: ShapeSpec, tcfg: TrainConfig) -> dict:
    """The step's FLOPs (whole job), one layer of each kind times its
    count plus the rest once.  Returns ``flops``, ``rest`` and ``layers``
    ({"kind/global": {"count", "flops"}}, a train layer's over all
    microbatches)."""
    cut = cut_config(cfg)
    args = abstract_args(cfg, shape, tcfg)
    m = tcfg.microbatches if shape.kind == "train" else 1
    B = shape.global_batch // m
    # a step of m microbatches is m steps of one (the split, the sum of
    # their gradients and the update do no dot)
    micro = (dataclasses.replace(shape, global_batch=B),
             dataclasses.replace(tcfg, microbatches=1))
    params = args[0]["params"] if shape.kind == "train" else args[0]
    n_pos = positions(cfg, shape)
    with torch.no_grad():
        cut_flops = m * whole_step_flops(cut, *micro)
    full, short = layer_census(cfg), layer_census(cut)
    layers, total = {}, cut_flops
    for (kind, flag), n in full.items():
        if kind == "enc" and shape.kind == "decode":
            continue                    # a decode step runs no encoder
        lp = _layer_params(cfg, params, kind)
        if shape.kind == "train":
            f = m * count_flops(_train_layer, cfg, kind, flag, lp, B, n_pos,
                                tcfg.remat and cfg.family != "encdec")
        else:
            with torch.no_grad():
                if shape.kind == "prefill":
                    f = count_flops(_prefill_layer, cfg, kind, flag, lp, B,
                                    n_pos)
                else:
                    f = count_flops(_decode_layer, cfg, kind, flag, lp,
                                    args[2])
        layers[f"{kind}/{'global' if flag else 'local'}"] = {"count": n,
                                                            "flops": f}
        total += (n - short.get((kind, flag), 0)) * f
    rest = total - sum(v["count"] * v["flops"] for v in layers.values())
    return {"flops": total, "rest": rest, "layers": layers}


# ---------------------------------------------------------------------------
# bytes and collectives
# ---------------------------------------------------------------------------


def _tokens_local(B: int, n_dp: int) -> int:
    """Batch rows a device holds (batch_specs shard B over DP; a batch the
    DP axes do not divide is replicated)."""
    return B // n_dp if B % n_dp == 0 else B


def collective_stats(cfg: ArchConfig, shape: ShapeSpec, mesh, dp: tuple,
                     p_specs: dict, params: dict, *, m_specs: dict | None,
                     remat: bool, n_pos: int, microbatches: int = 1,
                     model_axis: str = "model") -> dict:
    """Per-device collective payloads and wire bytes of one step under
    the placement (a ring model; see the module docstring).  ``params``
    are the step's weights (the master leaves for train), ``p_specs``
    their specs, ``m_specs`` the optimizer's first-moment specs (train
    only; a DP axis there means ZeRO); ``n_pos`` the positions a decoder
    layer sees (:func:`positions`); a train step reduces its gradients
    once, after its ``microbatches``.  Returns the per-kind {"count",
    "bytes"}, ``wire_bytes`` and ``wire_bytes_by_axes``
    ({"data": ..., "model": ...}, axes joined by "+")."""
    stats = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
    by_axes: dict[str, float] = collections.defaultdict(float)
    n_dp = SH.mesh_size(mesh, dp)

    def add(kind, axes, payload, times=1):
        stats[kind]["count"] += times
        stats[kind]["bytes"] += times * payload
        by_axes["+".join(axes)] += times * WIRE_FACTOR[kind] * payload

    if shape.kind == "train" and n_dp > 1:
        for (path, leaf), (_, spec), (_, mspec) in zip(
                T.items(params), T.items(p_specs), T.items(m_specs)):
            # the gradient of the model shard a device holds
            payload = leaf.numel() * leaf.element_size()
            for s in spec:
                for a in SH.spec_axes(s):
                    if a not in dp:
                        payload //= mesh.shape[a]
            if any(a in dp for s in mspec for a in SH.spec_axes(s)):
                add("reduce-scatter", dp, payload)
                add("all-gather", dp, payload)
            else:
                add("all-reduce", dp, payload)

    msize = mesh.shape.get(model_axis, 1)
    if msize > 1:
        act = torch.empty((), dtype=TF.model_dtype(cfg)).element_size()
        B_loc = _tokens_local(shape.global_batch, n_dp)
        passes = 1
        if shape.kind == "train":
            passes = microbatches * (3 if remat and cfg.family != "encdec"
                                     else 2)
            B_loc //= microbatches
        # each layer stack and the positions its layers see
        n_dec = 1 if shape.kind == "decode" else n_pos
        if cfg.family != "encdec":
            stacks = {g.name: n_dec for g in TF.layer_groups(cfg)}
        elif shape.kind == "decode":      # a decode step runs no encoder
            stacks = {"dec": n_dec}
        else:
            stacks = {"enc": cfg.encoder_len, "dec": n_dec}
        for name, tokens in stacks.items():
            for (path, leaf), (_, spec) in zip(T.items(params[name]),
                                               T.items(p_specs[name])):
                # (a routed expert's wo shards E, not its rows)
                if not SH.is_row_sharded(path, spec, model_axis):
                    continue
                L = leaf.shape[0]
                payload = B_loc * tokens * leaf.shape[-1] * act
                add("all-reduce", (model_axis,), payload, times=passes * L)
    wire = sum(by_axes.values())
    return {**{k: {"count": v["count"], "bytes": int(v["bytes"])}
               for k, v in stats.items()},
            "wire_bytes": int(wire),
            "wire_bytes_by_axes": {k: int(v) for k, v in by_axes.items()}}


def collective_seconds(mesh, wire_bytes_by_axes: dict) -> float:
    """The wire bytes of each axis group over its per-card bandwidth
    (``mesh.group_bandwidth``), summed."""
    return sum(b / group_bandwidth(mesh, tuple(axes.split("+")))
               for axes, b in wire_bytes_by_axes.items())


def output_bytes(cfg: ArchConfig, shape: ShapeSpec, mesh, dp: tuple,
                 args: tuple, arg_specs: tuple, *, n_pos: int) -> int:
    """Per-device bytes the step writes once: train its new state;
    prefill the cache (of max(seq_len, n_pos) positions) and the last
    logits; decode the logits and the SSM states (the new K/V row, 1/S of
    the cache, is left out).  The prefill cache is laid out by the "auto"
    policy, as the prefill step builds it."""
    if shape.kind == "train":
        return SH.sharded_bytes_per_device(args[0], arg_specs[0], mesh)
    B = shape.global_batch
    act = torch.empty((), dtype=TF.model_dtype(cfg)).element_size()
    out = _tokens_local(B, SH.mesh_size(mesh, dp)) * cfg.padded_vocab * act
    if shape.kind == "prefill":
        cache = MODEL.empty_cache(cfg, B, max(shape.seq_len, n_pos),
                                  device="meta")
        return out + SH.sharded_bytes_per_device(
            cache, SH.cache_specs(cache, mesh, dp_axes=dp), mesh)
    for (path, leaf), (_, spec) in zip(T.items(args[2]), T.items(arg_specs[2])):
        if path[-1] in TF.STATE_KEYS:
            out += SH.sharded_bytes_per_device({"x": leaf}, {"x": spec}, mesh)
    return out
