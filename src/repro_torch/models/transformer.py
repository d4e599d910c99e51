"""Decoder-only transformer stack, the ``dense``, ``ssm`` and ``hybrid``
layer kinds (counterpart of ``repro.models.transformer``).

Parameters are a dict of tensors mirroring the reference's pytree: every
layer leaf is stacked with a leading layer axis under its group's name
(``"g0"``), so :mod:`repro_torch.convert` carries the reference's weights
across leaf for leaf.  The reference scans the layer axis with
``lax.scan``; here a Python loop indexes it, which also makes each
layer's ``is_global`` flag a host bool (window or no window).

The cache returned by :func:`prefill` and threaded by :func:`decode_step`
keeps one stacked entry per group and the shared ``length`` (B,) int32:
``{"k", "v"}`` (L, B, S, Hkv, Dh) for ``dense``; the Mamba states
``{"conv", "ssm"}``, (L, B, d_conv - 1, conv_ch) in ``cfg.dtype`` and (L,
B, H, P, N) float32, for ``ssm``; all four for ``hybrid``.  The states are
not sequence-indexed, so :func:`prefill` pads only K/V.
:func:`decode_step` writes the new token's K/V and the new states into
those tensors in place.

Every floating parameter must be in ``cfg.dtype`` (ROADMAP F7): the
reference's serving path fails on float32 weights under a bfloat16 config,
and PyTorch does not promote ``bf16 @ f32`` either, so a mismatch raises.
That includes the SSM's ``A_log``, ``D`` and ``dt_bias``, which the
reference keeps in float32 and its training step casts like the rest.
The ``mla``, ``moe`` and ``pair`` kinds and the ``vlm`` family are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import ffn as FF
from repro_torch.models import hybrid as HY
from repro_torch.models import ssm as S
from repro_torch.models.common import dense_init, rms_norm


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


PORTED_KINDS = ("dense", "ssm", "hybrid")
STATE_KEYS = ("conv", "ssm")    # cache entries that are not sequence-indexed


def _ported_groups(cfg: ArchConfig) -> list[GroupSpec]:
    groups = layer_groups(cfg)
    if cfg.family == "vlm":
        raise NotImplementedError(f"{cfg.name}: the vlm family is not ported yet")
    for g in groups:
        if g.kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: layer kind {g.kind!r} is not ported yet")
    return groups


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


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None) -> dict:
    """The port's own seeded init (truncated normals from a
    ``torch.Generator`` on ``device``; it cannot equal ``jax.random``, so
    parity tests carry the reference's weights across instead).  Weights
    are made in ``cfg.dtype``, the dtype they serve in."""
    dev = resolve_device(device)
    dtype = model_dtype(cfg)
    groups = _ported_groups(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    D = cfg.d_model
    fill = torch.zeros if cfg.norm_plus_one else torch.ones
    params: dict = {
        "embed": dense_init(gen, (cfg.padded_vocab, D), dtype, scale=0.02),
        "final_norm": fill((D,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (D, cfg.padded_vocab), dtype)
    if cfg.n_meta_tokens:
        params["meta_tokens"] = dense_init(gen, (cfg.n_meta_tokens, D), dtype,
                                           scale=0.02)
    for g in groups:
        L = g.n_layers
        norm = lambda: fill((L, D), dtype=dtype, device=dev)  # noqa: E731
        if g.kind == "ssm":
            params[g.name] = {"ln1": norm(),
                              "ssm": S.init_ssm(gen, cfg, dtype, L)}
            continue
        mlp = lambda: FF.init_swiglu(gen, D, cfg.d_ff, dtype, L)  # noqa: E731
        if g.kind == "hybrid":
            params[g.name] = {"ln1": norm(),
                              "mix": HY.init_hybrid(gen, cfg, dtype, L),
                              "ln2": norm(), "mlp": mlp()}
            continue
        p = {"ln1": norm(), "attn": A.init_gqa(gen, cfg, dtype, L),
             "ln2": norm(), "mlp": mlp()}
        if cfg.post_norms:
            p["ln1_post"] = norm()
            p["ln2_post"] = norm()
        params[g.name] = p
    return params


def _layer(tree: dict, l: int) -> dict:
    """Layer ``l``'s parameters: views into the stacked leaves."""
    return {k: _layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# sequence forward (prefill)
# ---------------------------------------------------------------------------


def _norm(x, w, cfg: ArchConfig):
    return rms_norm(x, w, cfg.norm_eps, plus_one=cfg.norm_plus_one)


def _attn_seq(x, lp, cfg: ArchConfig, is_global: bool, return_cache: bool):
    h = _norm(x, lp["ln1"], cfg)
    out = A.gqa_seq(h, lp["attn"], cfg, is_global=is_global,
                    return_kv=return_cache)
    y, kv = out if return_cache else (out, None)
    if cfg.post_norms:
        y = _norm(y, lp["ln1_post"], cfg)
    return x + cfg.residual_scale * y, kv


def _ffn_seq(x, lp, cfg: ArchConfig):
    y = FF.swiglu(_norm(x, lp["ln2"], cfg), lp["mlp"], cfg)
    if cfg.post_norms:
        y = _norm(y, lp["ln2_post"], cfg)
    return x + cfg.residual_scale * y


def _layer_seq(x, lp, cfg: ArchConfig, kind: str, is_global: bool,
               return_cache: bool):
    """One layer of ``kind``; returns (x, its cache entry or None)."""
    if kind == "ssm":
        h = _norm(x, lp["ln1"], cfg)
        if return_cache:
            y, sstate, cstate = S.ssm_seq(h, lp["ssm"], cfg, return_state=True)
            return x + y, {"conv": cstate, "ssm": sstate}
        return x + S.ssm_seq(h, lp["ssm"], cfg), None
    if kind == "hybrid":
        h = _norm(x, lp["ln1"], cfg)
        cache = None
        if return_cache:
            y, (k, v), (cstate, sstate) = HY.hybrid_seq(
                h, lp["mix"], cfg, is_global=is_global, return_state=True)
            cache = {"k": k, "v": v, "conv": cstate, "ssm": sstate}
        else:
            y = HY.hybrid_seq(h, lp["mix"], cfg, is_global=is_global)
        return _ffn_seq(x + y, lp, cfg), cache
    x, kv = _attn_seq(x, lp, cfg, is_global, return_cache)
    return _ffn_seq(x, lp, cfg), ({"k": kv[0], "v": kv[1]} if return_cache
                                  else None)


def forward_seq(params: dict, cfg: ArchConfig, x: torch.Tensor, *,
                return_cache: bool = False):
    """Run all layer groups over x (B, T, D) embeddings (already scaled).

    Returns ``(x, caches)``: caches maps each group to its stacked entries
    (K/V (L, B, T, Hkv, Dh), the Mamba states (L, B, ...)), or is None."""
    caches = {}
    for g in _ported_groups(cfg):
        flags = global_flags(cfg, g.layer_ids)
        entries = []
        for l in range(g.n_layers):
            lp = _layer(params[g.name], l)
            x, entry = _layer_seq(x, lp, cfg, g.kind, flags[l], return_cache)
            entries.append(entry)
        if return_cache:
            caches[g.name] = {k: torch.stack([e[k] for e in entries])
                              for k in entries[0]}
    return x, (caches if return_cache else None)


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` on the host, as the reference's
    ``jnp.asarray(value, dtype)`` operand (the product or quotient of two
    bf16 values is exact in the f32 a bf16 kernel computes in)."""
    return float(torch.tensor(value, dtype=dtype))


def embed_tokens(params: dict, cfg: ArchConfig, tokens: torch.Tensor):
    x = params["embed"][tokens.long()].to(model_dtype(cfg))
    return x * _in_dtype(cfg.embed_scale, x.dtype)


def assemble_inputs(params: dict, cfg: ArchConfig, batch: dict):
    """Token embeds + meta-token prefix.  Returns (x, n_prefix)."""
    x = embed_tokens(params, cfg, batch["tokens"])
    B = x.shape[0]
    n_prefix = 0
    if cfg.n_meta_tokens:
        meta = params["meta_tokens"].to(x.dtype)[None].expand(
            B, cfg.n_meta_tokens, cfg.d_model)
        x = torch.cat([meta, x], dim=1)
        n_prefix += cfg.n_meta_tokens
    return x, n_prefix


def lm_head(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ w.to(x.dtype)
    return logits / _in_dtype(cfg.logit_divisor, logits.dtype)


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def prefill(params: dict, cfg: ArchConfig, batch: dict, *, cache_len: int):
    """Full forward building the cache, K/V sized to ``cache_len`` (or to
    T when the prompt and its meta tokens are longer); the Mamba states
    are not sequence-indexed and stay as they are.

    Returns (last_logits (B, V), cache dict)."""
    check_param_dtypes(params, cfg)
    x, _ = assemble_inputs(params, cfg, batch)
    B, T, _ = x.shape
    cache_len = max(cache_len, T)  # prefix tokens (meta) may exceed it
    x, caches = forward_seq(params, cfg, x, return_cache=True)
    xl = _norm(x[:, -1:], params["final_norm"], cfg)
    logits = lm_head(params, cfg, xl)[:, 0]
    padded: dict = {
        gname: {k: (t if k in STATE_KEYS
                    else F.pad(t, (0, 0, 0, 0, 0, cache_len - T)))
                for k, t in cache.items()}
        for gname, cache in caches.items()
    }
    padded["length"] = torch.full((B,), T, dtype=torch.int32, device=x.device)
    return logits, padded


def decode_step(params: dict, cfg: ArchConfig, tokens_t: torch.Tensor,
                cache: dict):
    """One decode step.  tokens_t (B,) ids; cache from prefill/empty_cache,
    whose K/V tensors take the new token's rows, and whose Mamba states
    the new states, in place.

    Returns (logits (B, V), new cache)."""
    check_param_dtypes(params, cfg)
    x = embed_tokens(params, cfg, tokens_t[:, None])
    length = cache["length"]
    new_cache: dict = {"length": length + 1}
    for g in _ported_groups(cfg):
        flags = global_flags(cfg, g.layer_ids)
        gc = cache[g.name]
        for l in range(g.n_layers):
            lp = _layer(params[g.name], l)
            if g.kind == "dense":
                x = _attn_decode(x, lp, cfg, gc["k"][l], gc["v"][l], length,
                                 flags[l])
                x = _ffn_seq(x, lp, cfg)
                continue
            h = _norm(x, lp["ln1"], cfg)
            if g.kind == "ssm":
                y, conv, sst = S.ssm_decode(h, lp["ssm"], cfg, gc["conv"][l],
                                            gc["ssm"][l])
                x = x + y
            else:
                y, _, _, conv, sst = HY.hybrid_decode(
                    h, lp["mix"], cfg, gc["k"][l], gc["v"][l], length,
                    gc["conv"][l], gc["ssm"][l], is_global=flags[l])
                x = _ffn_seq(x + y, lp, cfg)
            gc["conv"][l].copy_(conv)
            gc["ssm"][l].copy_(sst)
        new_cache[g.name] = gc
    x = _norm(x, params["final_norm"], cfg)
    logits = lm_head(params, cfg, x)[:, 0]
    return logits, new_cache


def _attn_decode(xc, lp, cfg: ArchConfig, k_cache, v_cache, length,
                 is_global: bool):
    h = _norm(xc, lp["ln1"], cfg)
    y, _, _ = A.gqa_decode(h, lp["attn"], cfg, k_cache, v_cache, length,
                           is_global=is_global)
    if cfg.post_norms:
        y = _norm(y, lp["ln1_post"], cfg)
    return xc + cfg.residual_scale * y


def empty_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
                length: int = 0, device=None) -> dict:
    """A zeroed cache of ``batch`` sequences of ``cache_len`` positions:
    K/V in ``cfg.dtype``, the conv state in ``cfg.dtype``, the SSM state in
    float32."""
    dev = resolve_device(device)
    dtype = model_dtype(cfg)
    caches: dict = {"length": torch.full((batch,), length, dtype=torch.int32,
                                         device=dev)}
    for g in _ported_groups(cfg):
        L, entry = g.n_layers, {}
        if g.kind in ("dense", "hybrid"):
            shape = (L, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
            entry["k"] = torch.zeros(shape, dtype=dtype, device=dev)
            entry["v"] = torch.zeros(shape, dtype=dtype, device=dev)
        if g.kind in ("ssm", "hybrid"):
            H, P, N, _, _, conv_ch, _ = S._dims(cfg)
            entry["conv"] = torch.zeros((L, batch, cfg.d_conv - 1, conv_ch),
                                        dtype=dtype, device=dev)
            entry["ssm"] = torch.zeros((L, batch, H, P, N),
                                       dtype=torch.float32, device=dev)
        caches[g.name] = entry
    return caches
