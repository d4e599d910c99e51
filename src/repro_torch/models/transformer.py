"""Decoder-only transformer stack for every LM family: the ``dense``,
``mla``, ``moe``, ``pair`` (llama4's dense + MoE sublayers), ``ssm`` and
``hybrid`` layer kinds, and the ``vlm`` family's patch prefix
(counterpart of ``repro.models.transformer``).

Parameters are a dict of tensors mirroring the reference's pytree: every
layer leaf is stacked with a leading layer axis under its group's name
(``"g0"``), so :mod:`repro_torch.convert` carries the reference's weights
across leaf for leaf.  The reference scans the layer axis with
``lax.scan``; here a Python loop indexes it, which also makes each
layer's ``is_global`` flag a host bool (window or no window).

The cache returned by :func:`prefill` and threaded by :func:`decode_step`
keeps one stacked entry per group and the shared ``length`` (B,) int32:
``{"k", "v"}`` (L, B, S, Hkv, Dh) for ``dense`` and ``moe``; ``{"ka",
"va", "kb", "vb"}`` for ``pair`` (one K/V a sublayer); the latent
``{"ckv", "krope"}`` (L, B, S, kvr) and (L, B, S, rd) for ``mla``; the
Mamba states ``{"conv", "ssm"}``, (L, B, d_conv - 1, conv_ch) in
``cfg.dtype`` and (L, B, H, P, N) float32, for ``ssm``; ``k``, ``v`` and
the states for ``hybrid``.  The states are not sequence-indexed, so
:func:`prefill` pads only the rest.  :func:`decode_step` writes the new
token's rows and the new states into those tensors in place.

Every floating parameter must be in ``cfg.dtype`` (ROADMAP F7): the
reference's serving path fails on float32 weights under a bfloat16 config,
and PyTorch does not promote ``bf16 @ f32`` either, so a mismatch raises.
That includes the SSM's ``A_log``, ``D`` and ``dt_bias``, which the
reference keeps in float32 and its training step casts like the rest.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.constraints import constrain
from repro_torch.models import attention as A
from repro_torch.models import ffn as FF
from repro_torch.models import hybrid as HY
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as S
from repro_torch.models.common import dense_init, generator, rms_norm


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    name: str
    kind: str       # dense | mla | moe | ssm | hybrid | pair
    n_layers: int   # layers in the group (pairs count as one)
    layer_ids: tuple[int, ...]  # absolute layer indices (first sublayer for pairs)


def layer_groups(cfg: ArchConfig) -> list[GroupSpec]:
    fam = cfg.family
    L = cfg.n_layers
    if fam == "ssm":
        return [GroupSpec("g0", "ssm", L, tuple(range(L)))]
    if fam == "hybrid":
        return [GroupSpec("g0", "hybrid", L, tuple(range(L)))]
    if fam == "moe":
        if cfg.moe_layer_step == 2:
            assert L % 2 == 0
            return [GroupSpec("g0", "pair", L // 2, tuple(range(0, L, 2)))]
        groups = []
        if cfg.first_dense_layers:
            groups.append(GroupSpec("g0", "dense", cfg.first_dense_layers,
                                    tuple(range(cfg.first_dense_layers))))
        rest = L - cfg.first_dense_layers
        groups.append(GroupSpec(f"g{len(groups)}", "moe", rest,
                                tuple(range(cfg.first_dense_layers, L))))
        return groups
    kind = "mla" if cfg.use_mla else "dense"
    return [GroupSpec("g0", kind, L, tuple(range(L)))]


def global_flags(cfg: ArchConfig, layer_ids: tuple[int, ...]) -> list[bool]:
    """Which layers attend globally (no sliding window)."""
    flags = []
    for l in layer_ids:
        g = cfg.sliding_window is None
        if cfg.global_layer_every:
            g |= (l + 1) % cfg.global_layer_every == 0
        if cfg.global_layers:
            g |= l in cfg.global_layers
        flags.append(g)
    return flags


STATE_KEYS = ("conv", "ssm")    # cache entries that are not sequence-indexed


def model_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_param_dtypes(params: dict, cfg: ArchConfig) -> None:
    """Raise when a floating parameter is not in ``cfg.dtype`` (F7)."""
    want = model_dtype(cfg)

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{path}{k}.")
            elif v.is_floating_point() and v.dtype != want:
                raise TypeError(
                    f"parameter {path}{k} is {v.dtype} under a {cfg.dtype} "
                    "config: cast the weights to cfg.dtype first "
                    "(convert.params_from_numpy does)")

    walk(params, "")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layers(gen: torch.Generator, cfg: ArchConfig, kind: str,
                 dtype: torch.dtype, L: int) -> dict:
    """The stacked parameters of ``L`` layers of ``kind``."""
    D = cfg.d_model
    fill = torch.zeros if cfg.norm_plus_one else torch.ones
    norm = lambda: fill((L, D), dtype=dtype, device=gen.device)  # noqa: E731
    if kind == "ssm":
        return {"ln1": norm(), "ssm": S.init_ssm(gen, cfg, dtype, L)}
    if kind == "hybrid":
        return {"ln1": norm(), "mix": HY.init_hybrid(gen, cfg, dtype, L),
                "ln2": norm(),
                "mlp": FF.init_swiglu(gen, D, cfg.d_ff, dtype, L)}
    if kind == "pair":
        return {"a": _init_layers(gen, cfg, "dense", dtype, L),
                "b": _init_layers(gen, cfg, "moe", dtype, L)}
    attn = (A.init_mla if kind == "mla" else A.init_gqa)(gen, cfg, dtype, L)
    p = {"ln1": norm(), "attn": attn, "ln2": norm()}
    if kind == "moe":
        p["moe"] = MOE.init_moe(gen, cfg, dtype, L)
    else:
        p["mlp"] = FF.init_swiglu(gen, D, cfg.d_ff, dtype, L)
    if cfg.post_norms:
        p["ln1_post"] = norm()
        p["ln2_post"] = norm()
    return p


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None,
                dtype: str | None = None) -> dict:
    """The port's own seeded init (truncated normals from a
    ``torch.Generator`` on ``device``; it cannot equal ``jax.random``, so
    parity tests carry the reference's weights across instead).  Weights
    are made in ``dtype``: by default ``cfg.dtype``, the dtype they serve
    in; training makes ``cfg.param_dtype`` master weights.  On the
    ``meta`` device nothing is drawn (``model.abstract_params``)."""
    dev = resolve_device(device)
    dtype = getattr(torch, dtype or cfg.dtype)
    gen = generator(dev, seed)
    D = cfg.d_model
    fill = torch.zeros if cfg.norm_plus_one else torch.ones
    params: dict = {
        "embed": dense_init(gen, (cfg.padded_vocab, D), dtype, scale=0.02),
        "final_norm": fill((D,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (D, cfg.padded_vocab), dtype)
    if cfg.family == "vlm":
        params["mlp1"] = {
            "w1": dense_init(gen, (cfg.vit_embed_dim, D), dtype),
            "w2": dense_init(gen, (D, D), dtype),
        }
    if cfg.n_meta_tokens:
        params["meta_tokens"] = dense_init(gen, (cfg.n_meta_tokens, D), dtype,
                                           scale=0.02)
    for g in layer_groups(cfg):
        params[g.name] = _init_layers(gen, cfg, g.kind, dtype, g.n_layers)
    return params


def _layer(tree: dict, l: int) -> dict:
    """Layer ``l``'s parameters: views into the stacked leaves."""
    return {k: _layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# sequence forward (prefill)
# ---------------------------------------------------------------------------


def _norm(x, w, cfg: ArchConfig):
    """RMSNorm; on a ``DTensor`` its gradient is summed over the mesh where
    it arises (``tensor_parallel.reduce_grad``): the norm's output feeds
    the column-sharded projections."""
    return TP.reduce_grad(rms_norm(x, w, cfg.norm_eps,
                                   plus_one=cfg.norm_plus_one))


def _residual(x, y, cfg: ArchConfig):
    """x + residual_scale * y, the scale rounded to y's dtype first (the
    reference's weakly typed Python float)."""
    return x + _in_dtype(cfg.residual_scale, y.dtype) * y


def _attn_seq(x, lp, cfg: ArchConfig, kind: str, is_global: bool,
              return_cache: bool):
    h = _norm(x, lp["ln1"], cfg)
    if kind == "mla":
        out = A.mla_seq(h, lp["attn"], cfg, return_kv=return_cache)
    else:
        out = A.gqa_seq(h, lp["attn"], cfg, is_global=is_global,
                        return_kv=return_cache)
    y, kv = out if return_cache else (out, None)
    y = TP.like(y, x)
    if cfg.post_norms:
        y = _norm(y, lp["ln1_post"], cfg)
    return _residual(x, y, cfg), kv


def _ffn_seq(x, lp, cfg: ArchConfig, kind: str = "dense"):
    """The FFN sublayer; returns (x, aux), aux the MoE's terms or {}."""
    h = _norm(x, lp["ln2"], cfg)
    aux = {}
    if kind == "moe":
        y, aux = MOE.moe_layer(h, lp["moe"], cfg)
    else:
        y = FF.swiglu(h, lp["mlp"], cfg)
    y = TP.like(y, x)
    if cfg.post_norms:
        y = _norm(y, lp["ln2_post"], cfg)
    return _residual(x, y, cfg), aux


def _layer_seq(x, lp, cfg: ArchConfig, kind: str, is_global: bool,
               return_cache: bool):
    """One layer of ``kind``; returns (x, aux, its cache entry or None)."""
    if kind == "ssm":
        h = _norm(x, lp["ln1"], cfg)
        if return_cache:
            y, sstate, cstate = S.ssm_seq(h, lp["ssm"], cfg, return_state=True)
            return x + y, {}, {"conv": cstate, "ssm": sstate}
        return x + TP.like(S.ssm_seq(h, lp["ssm"], cfg), x), {}, None
    if kind == "hybrid":
        h = _norm(x, lp["ln1"], cfg)
        cache = None
        if return_cache:
            y, (k, v), (cstate, sstate) = HY.hybrid_seq(
                h, lp["mix"], cfg, is_global=is_global, return_state=True)
            cache = {"k": k, "v": v, "conv": cstate, "ssm": sstate}
        else:
            y = HY.hybrid_seq(h, lp["mix"], cfg, is_global=is_global)
        x, _ = _ffn_seq(x + y, lp, cfg)     # _mix completes both branches
        return x, {}, cache
    if kind == "pair":
        x, kva = _attn_seq(x, lp["a"], cfg, "dense", is_global, return_cache)
        x, _ = _ffn_seq(x, lp["a"], cfg)
        x, kvb = _attn_seq(x, lp["b"], cfg, "dense", is_global, return_cache)
        x, aux = _ffn_seq(x, lp["b"], cfg, "moe")
        cache = None
        if return_cache:
            cache = {"ka": kva[0], "va": kva[1], "kb": kvb[0], "vb": kvb[1]}
        return x, aux, cache
    # dense / mla / moe
    x, kv = _attn_seq(x, lp, cfg, kind, is_global, return_cache)
    x, aux = _ffn_seq(x, lp, cfg, kind)
    cache = None
    if return_cache:
        cache = ({"ckv": kv[0], "krope": kv[1]} if kind == "mla"
                 else {"k": kv[0], "v": kv[1]})
    return x, aux, cache


def forward_seq(params: dict, cfg: ArchConfig, x: torch.Tensor, *,
                return_cache: bool = False, remat: bool = False):
    """Run all layer groups over x (B, T, D) embeddings (already scaled).

    Returns ``(x, aux, caches)``: aux sums the MoE layers' ``moe_aux_loss``
    (float32) and ``moe_dropped`` (int32) in layer order; caches maps each
    group to its stacked entries (K/V (L, B, T, Hkv, Dh), the latent, the
    Mamba states (L, B, ...)), or is None.  ``remat`` runs each layer body
    under ``torch.utils.checkpoint``, as the reference puts its scan body
    under ``jax.checkpoint``: the backward recomputes a layer's
    activations from its input instead of keeping them."""
    caches = {}
    aux_total = {"moe_aux_loss": TP.zeros_like_scalar(x, torch.float32),
                 "moe_dropped": TP.zeros_like_scalar(x, torch.int32)}
    for g in layer_groups(cfg):
        flags = global_flags(cfg, g.layer_ids)
        entries = []
        for l in range(g.n_layers):
            lp = _layer(params[g.name], l)
            x = constrain(x, "hidden")
            if remat:
                x, aux, entry = checkpoint(_layer_seq, x, lp, cfg, g.kind,
                                           flags[l], return_cache,
                                           use_reentrant=False)
            else:
                x, aux, entry = _layer_seq(x, lp, cfg, g.kind, flags[l],
                                           return_cache)
            x = constrain(x, "hidden")
            for k, v in aux.items():
                aux_total[k] = aux_total[k] + v
            entries.append(entry)
        if return_cache:
            caches[g.name] = {k: torch.stack([e[k] for e in entries])
                              for k in entries[0]}
    return x, aux_total, (caches if return_cache else None)


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` on the host, as the reference's
    ``jnp.asarray(value, dtype)`` operand (the product or quotient of two
    bf16 values is exact in the f32 a bf16 kernel computes in)."""
    return float(torch.tensor(value, dtype=dtype))


def embed_tokens(params: dict, cfg: ArchConfig, tokens: torch.Tensor):
    """The scaled embeddings of ``tokens``; on a ``DTensor`` table the
    vocab-parallel lookup (``distributed.tensor_parallel``)."""
    if TP.is_dtensor(params["embed"]):
        x = TP.vocab_parallel_embed(params["embed"], tokens)
    else:
        x = params["embed"][tokens.long()]
    x = x.to(model_dtype(cfg))
    return x * _in_dtype(cfg.embed_scale, x.dtype)


def project_patches(params: dict, cfg: ArchConfig, patches: torch.Tensor):
    """The vlm's stub frontend output (B, P, vit_embed_dim) -> d_model
    tokens (InternVL's mlp1, tanh-approximate gelu).

    On ``DTensor``s the rules column-shard both ``w1`` and ``w2`` on
    "model", so the hidden's columns are split where ``w2`` contracts
    them: the hidden is gathered over "model" before ``w2`` and the prefix
    after it, (B, P, D) each (no weight is gathered).  Both are explicit
    redistributions, whose backward sums the hidden's partial gradient
    over "model" (a reduce-scatter) and keeps each rank's columns of the
    prefix's whole one: the prefix comes out as the token embeddings lie,
    split over the batch and replicated on "model"."""
    h = F.gelu(patches.to(model_dtype(cfg)) @ params["mlp1"]["w1"],
               approximate="tanh")
    h = TP.like(h, patches)
    return TP.like(h @ params["mlp1"]["w2"], patches)


def assemble_inputs(params: dict, cfg: ArchConfig, batch: dict):
    """Token embeds + the vlm's patch prefix + the meta-token prefix.
    Returns (x, n_prefix)."""
    x = embed_tokens(params, cfg, batch["tokens"])
    B = x.shape[0]
    n_prefix = 0
    if cfg.family == "vlm" and "patches" in batch:
        pv = project_patches(params, cfg, batch["patches"])
        x = torch.cat([pv, x], dim=1)
        n_prefix += pv.shape[1]
    if cfg.n_meta_tokens:
        meta = params["meta_tokens"].to(x.dtype)
        if TP.is_dtensor(x):          # each rank's rows, laid out as x
            meta = TP.batch_rows(meta, x)
        else:
            meta = meta[None].expand(B, cfg.n_meta_tokens, cfg.d_model)
        x = torch.cat([meta, x], dim=1)
        n_prefix += cfg.n_meta_tokens
    return x, n_prefix


def lm_head(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ w.to(x.dtype)
    if cfg.logit_divisor == 1.0:    # exact: no (B, T, V) copy
        return logits
    return logits / _in_dtype(cfg.logit_divisor, logits.dtype)


# ---------------------------------------------------------------------------
# loss (training)
# ---------------------------------------------------------------------------


def _ce_chunk(params: dict, cfg: ArchConfig, xc: torch.Tensor,
              lc: torch.Tensor):
    """One chunk's (nll sum, scored tokens): float32 logits, log-sum-exp
    less the gold logit.  The reference contracts the logits with a
    one-hot of the labels; a gather takes the same value (the other terms
    are exact zeros) without the (B, chunk, V) one-hot.  On ``DTensor``
    inputs the vocab-parallel version, which never gathers the logits."""
    logits = constrain(lm_head(params, cfg, xc).float(), "logits")
    if TP.is_dtensor(logits):
        return TP.vocab_parallel_ce(logits, lc)
    mask = lc >= 0
    safe = lc.clamp(min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(mask, lse - gold, 0.0)
    return nll.sum(), mask.sum().to(torch.int32)


def chunked_ce_loss(params: dict, cfg: ArchConfig, x: torch.Tensor,
                    labels: torch.Tensor, *, chunk: int = 1024):
    """Cross-entropy over T chunks, each under ``torch.utils.checkpoint``,
    so the (B, T, V) logits are never all alive: a chunk's logits are
    recomputed in the backward.  labels (B, T), -1 = masked.  Returns
    (loss_sum float32, token_count int32), the chunks' sums added in
    order."""
    B, T, _ = x.shape
    chunk = min(chunk, T)
    pad = -T % chunk
    if pad:
        x = TP.pad(x, (0, 0, 0, pad))
        labels = TP.pad(labels, (0, pad), value=-1)
    loss_sum = TP.zeros_like_scalar(x, torch.float32)
    count = TP.zeros_like_scalar(x, torch.int32)
    for c0 in range(0, T + pad, chunk):
        nll, n = checkpoint(_ce_chunk, params, cfg, x[:, c0:c0 + chunk],
                            labels[:, c0:c0 + chunk], use_reentrant=False)
        loss_sum = loss_sum + nll
        count = count + n
    return loss_sum, count


def loss_fn(params: dict, cfg: ArchConfig, batch: dict, *,
            remat: bool = False, aux_weight: float = 0.01):
    """Next-token cross-entropy plus ``aux_weight`` times the MoE
    load-balance term.  batch: ``tokens`` and ``labels`` (B, T), the
    vlm's ``patches``; the prefix positions (patches, meta tokens) are
    not scored.  Returns (loss, metrics: ``ce``, ``tokens``,
    ``moe_aux_loss``, ``moe_dropped``)."""
    check_param_dtypes(params, cfg)
    x, n_prefix = assemble_inputs(params, cfg, batch)
    x, aux, _ = forward_seq(params, cfg, x, remat=remat)
    x = _norm(x, params["final_norm"], cfg)
    if n_prefix:
        x = x[:, n_prefix:]
    loss_sum, count = chunked_ce_loss(params, cfg, x, batch["labels"])
    ce = loss_sum / count.float().clamp(min=1.0)
    loss = ce + _in_dtype(aux_weight, torch.float32) * aux["moe_aux_loss"]
    return loss, {"ce": ce, "tokens": count, **aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def prefill(params: dict, cfg: ArchConfig, batch: dict, *, cache_len: int):
    """Full forward building the cache, its sequence-indexed entries sized
    to ``cache_len`` (or to T when the prompt and its patch or meta
    prefix are longer); the Mamba states are not sequence-indexed and stay
    as they are.

    Returns (last_logits (B, V), cache dict)."""
    check_param_dtypes(params, cfg)
    x, _ = assemble_inputs(params, cfg, batch)
    B, T, _ = x.shape
    cache_len = max(cache_len, T)  # prefix tokens (meta/patches) may exceed it
    x, _, caches = forward_seq(params, cfg, x, return_cache=True)
    xl = _norm(x[:, -1:], params["final_norm"], cfg)
    logits = lm_head(params, cfg, xl)[:, 0]
    padded: dict = {
        gname: {k: (t if k in STATE_KEYS else _pad_positions(t, cache_len))
                for k, t in cache.items()}
        for gname, cache in caches.items()
    }
    padded["length"] = torch.full((B,), T, dtype=torch.int32, device=x.device)
    return logits, padded


def _pad_positions(t: torch.Tensor, cache_len: int) -> torch.Tensor:
    """A stacked (L, B, T, ...) cache entry zero-padded to ``cache_len``
    positions."""
    return F.pad(t, (0, 0) * (t.dim() - 3) + (0, cache_len - t.shape[2]))


def decode_step(params: dict, cfg: ArchConfig, tokens_t: torch.Tensor,
                cache: dict):
    """One decode step.  tokens_t (B,) ids; cache from prefill/empty_cache,
    whose K/V and latent tensors take the new token's rows, and whose
    Mamba states the new states, in place.

    Returns (logits (B, V), new cache)."""
    check_param_dtypes(params, cfg)
    x = embed_tokens(params, cfg, tokens_t[:, None])
    length = cache["length"]
    new_cache: dict = {"length": length + 1}
    for g in layer_groups(cfg):
        flags = global_flags(cfg, g.layer_ids)
        gc = cache[g.name]
        for l in range(g.n_layers):
            x = _layer_decode(x, _layer(params[g.name], l), cfg, g.kind, gc,
                              l, length, flags[l])
        new_cache[g.name] = gc
    x = _norm(x, params["final_norm"], cfg)
    logits = lm_head(params, cfg, x)[:, 0]
    return logits, new_cache


def _layer_decode(x, lp, cfg: ArchConfig, kind: str, gc: dict, l: int,
                  length, is_global: bool):
    """One layer of ``kind`` for one token against layer ``l`` of its
    group's stacked cache ``gc``, whose rows and states it writes in
    place.  Returns x."""
    if kind in ("dense", "moe"):
        x = _attn_decode(x, lp, cfg, gc["k"][l], gc["v"][l], length,
                         is_global)
        return _ffn_seq(x, lp, cfg, kind)[0]
    if kind == "pair":
        x = _attn_decode(x, lp["a"], cfg, gc["ka"][l], gc["va"][l], length,
                         is_global)
        x, _ = _ffn_seq(x, lp["a"], cfg)
        x = _attn_decode(x, lp["b"], cfg, gc["kb"][l], gc["vb"][l], length,
                         is_global)
        return _ffn_seq(x, lp["b"], cfg, "moe")[0]
    h = _norm(x, lp["ln1"], cfg)
    if kind == "mla":
        y, _, _ = A.mla_decode(h, lp["attn"], cfg, gc["ckv"][l],
                               gc["krope"][l], length)
        if cfg.post_norms:
            y = _norm(y, lp["ln1_post"], cfg)
        return _ffn_seq(_residual(x, y, cfg), lp, cfg)[0]
    if kind == "ssm":
        y, conv, sst = S.ssm_decode(h, lp["ssm"], cfg, gc["conv"][l],
                                    gc["ssm"][l])
        x = x + y
    else:
        y, _, _, conv, sst = HY.hybrid_decode(
            h, lp["mix"], cfg, gc["k"][l], gc["v"][l], length,
            gc["conv"][l], gc["ssm"][l], is_global=is_global)
        x, _ = _ffn_seq(x + y, lp, cfg)
    gc["conv"][l].copy_(conv)
    gc["ssm"][l].copy_(sst)
    return x


def _attn_decode(xc, lp, cfg: ArchConfig, k_cache, v_cache, length,
                 is_global: bool):
    h = _norm(xc, lp["ln1"], cfg)
    y, _, _ = A.gqa_decode(h, lp["attn"], cfg, k_cache, v_cache, length,
                           is_global=is_global)
    if cfg.post_norms:
        y = _norm(y, lp["ln1_post"], cfg)
    return _residual(xc, y, cfg)


def empty_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
                length: int = 0, device=None) -> dict:
    """A zeroed cache of ``batch`` sequences of ``cache_len`` positions:
    K/V and the latent in ``cfg.dtype``, the conv state in ``cfg.dtype``,
    the SSM state in float32."""
    dev = resolve_device(device)
    dtype = model_dtype(cfg)
    caches: dict = {"length": torch.full((batch,), length, dtype=torch.int32,
                                         device=dev)}
    zeros = lambda *shape, dt=dtype: torch.zeros(  # noqa: E731
        shape, dtype=dt, device=dev)
    for g in layer_groups(cfg):
        L, entry = g.n_layers, {}
        kv = (L, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
        if g.kind in ("dense", "moe", "hybrid"):
            entry["k"], entry["v"] = zeros(*kv), zeros(*kv)
        elif g.kind == "pair":
            entry = {name: zeros(*kv) for name in ("ka", "va", "kb", "vb")}
        elif g.kind == "mla":
            entry["ckv"] = zeros(L, batch, cache_len, cfg.kv_lora_rank)
            entry["krope"] = zeros(L, batch, cache_len, cfg.qk_rope_dim)
        if g.kind in ("ssm", "hybrid"):
            H, P, N, _, _, conv_ch, _ = S._dims(cfg)
            entry["conv"] = zeros(L, batch, cfg.d_conv - 1, conv_ch)
            entry["ssm"] = zeros(L, batch, H, P, N, dt=torch.float32)
        caches[g.name] = entry
    return caches
