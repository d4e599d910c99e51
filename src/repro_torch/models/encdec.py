"""Whisper-style encoder-decoder (counterpart of ``repro.models.encdec``;
the audio frontend is a stub: the caller feeds frame embeddings (B, F, D)).

Both stacks add fixed sinusoidal positions.  The encoder attends both
ways; the decoder attends causally to itself and across to the encoder
states, whose K/V it computes once at prefill and keeps.  Prefill runs
the blockwise flash attention (``models/flash.py``); a decode step runs
both its attentions through the decode-attention wrapper, K6 on the card:
the self attention over the cache ``k`` / ``v`` (L, B, S, H, Dh), the
cross attention over ``ck`` / ``cv`` (L, B, encoder_len, H, Dh).  Every
projection but the key's has a bias.  Parameters are stacked (L, ...)
under ``enc`` and ``dec``, as the reference's pytree, in ``cfg.dtype``
(ROADMAP F7).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import attention as A
from repro_torch.models import ffn as FF
from repro_torch.models.common import (dense_init, generator, layer_norm,
                                      sinusoid_pos)
from repro_torch.models.flash import flash_attention
from repro_torch.models.transformer import _layer, check_param_dtypes, model_dtype


def _init_attn(gen: torch.Generator, cfg: ArchConfig, dtype, L: int) -> dict:
    D, H, Dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    zeros = lambda n: torch.zeros((L, n), dtype=dtype,  # noqa: E731
                                  device=gen.device)
    return {
        "wq": dense_init(gen, (L, D, H * Dh), dtype), "bq": zeros(H * Dh),
        "wk": dense_init(gen, (L, D, H * Dh), dtype),
        "wv": dense_init(gen, (L, D, H * Dh), dtype), "bv": zeros(H * Dh),
        "wo": dense_init(gen, (L, H * Dh, D), dtype), "bo": zeros(D),
    }


def _ln_init(cfg: ArchConfig, dtype, dev, L: int | None = None) -> dict:
    shape = (cfg.d_model,) if L is None else (L, cfg.d_model)
    return {"w": torch.ones(shape, dtype=dtype, device=dev),
            "b": torch.zeros(shape, dtype=dtype, device=dev)}


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None,
                dtype: str | None = None) -> dict:
    """The port's own seeded init, in ``dtype`` (default ``cfg.dtype``;
    see ``transformer.init_params``)."""
    dev = resolve_device(device)
    dtype = getattr(torch, dtype or cfg.dtype)
    gen = generator(dev, seed)
    Le, Ld, D = cfg.n_encoder_layers, cfg.n_layers, cfg.d_model
    return {
        "embed": dense_init(gen, (cfg.padded_vocab, D), dtype, scale=0.02),
        "enc": {"ln1": _ln_init(cfg, dtype, dev, Le),
                "attn": _init_attn(gen, cfg, dtype, Le),
                "ln2": _ln_init(cfg, dtype, dev, Le),
                "mlp": FF.init_mlp(gen, D, cfg.d_ff, dtype, Le)},
        "dec": {"ln1": _ln_init(cfg, dtype, dev, Ld),
                "self": _init_attn(gen, cfg, dtype, Ld),
                "lnx": _ln_init(cfg, dtype, dev, Ld),
                "cross": _init_attn(gen, cfg, dtype, Ld),
                "ln2": _ln_init(cfg, dtype, dev, Ld),
                "mlp": FF.init_mlp(gen, D, cfg.d_ff, dtype, Ld)},
        "enc_ln": _ln_init(cfg, dtype, dev),
        "dec_ln": _ln_init(cfg, dtype, dev),
    }


def _ln(x, p, cfg: ArchConfig):
    """LayerNorm; on a ``DTensor`` its gradient is summed over the mesh
    where it arises (``tensor_parallel.reduce_grad``): every norm's output
    feeds column-sharded projections (the last one the vocab-sharded
    logits)."""
    return TP.reduce_grad(layer_norm(x, p["w"], p["b"], cfg.norm_eps))


def _heads(t: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    B, T, _ = t.shape
    return t.reshape(B, T, cfg.n_heads, cfg.head_dim)


def _kv(x, p):
    """K (no bias) and V of x (B, S, D), (B, S, H * Dh) each."""
    return x @ p["wk"], x @ p["wv"] + p["bv"]


def _self_kv(x, p, cfg: ArchConfig):
    """K and V of x (B, T, D), (B, T, H, Dh) each."""
    return tuple(_heads(t, cfg) for t in _kv(x, p))


def _attn(x, p, cfg: ArchConfig, *, causal: bool, kv=None):
    """kv: precomputed (k, v) (B, S, H * Dh) for cross attention.  On a
    ``DTensor`` x, each rank attends with its own heads
    (``tensor_parallel.local_heads``), and ``wo``'s partial sum over
    "model" is completed before the replicated ``bo`` is added once."""
    B, T, _ = x.shape
    q = x @ p["wq"] + p["bq"]
    k, v = _kv(x, p) if kv is None else kv
    if TP.is_dtensor(q):
        H = cfg.n_heads
        q, k, v, like = TP.local_heads(q, k, v, H, H, p["wo"])
        out = flash_attention(q, k, v, causal=causal)
        y = TP.from_local_heads(out, like, p["wo"]) @ p["wo"]
        return TP.like(y, x) + p["bo"]
    out = flash_attention(_heads(q, cfg), _heads(k, cfg), _heads(v, cfg),
                          causal=causal)
    return out.reshape(B, T, -1) @ p["wo"] + p["bo"]


def _positions(T: int, cfg: ArchConfig, x) -> torch.Tensor:
    """The sinusoidal positions (T, D) in x's dtype; replicated on a
    ``DTensor`` x's mesh."""
    dev = x.to_local().device if TP.is_dtensor(x) else x.device
    return TP.replicated(sinusoid_pos(T, cfg.d_model, dev).to(x.dtype), x)


def encode(params: dict, cfg: ArchConfig, frames: torch.Tensor):
    """frames (B, F, D) stub embeddings -> encoder states."""
    x = frames.to(model_dtype(cfg))
    x = x + _positions(x.shape[1], cfg, x)[None]
    for l in range(cfg.n_encoder_layers):
        x = _enc_layer(x, _layer(params["enc"], l), cfg)
    return _ln(x, params["enc_ln"], cfg)


def _enc_layer(x, lp, cfg: ArchConfig):
    x = x + _attn(_ln(x, lp["ln1"], cfg), lp["attn"], cfg, causal=False)
    return x + FF.mlp(_ln(x, lp["ln2"], cfg), lp["mlp"], cfg)


def _dec_layer(x, lp, cfg: ArchConfig, enc_out):
    """One teacher-forced decoder layer; returns (x, (k, v, ck, cv)), its
    self and cross K/V (B, S, H * Dh)."""
    h = _ln(x, lp["ln1"], cfg)
    k, v = _kv(h, lp["self"])
    x = x + _attn(h, lp["self"], cfg, causal=True, kv=(k, v))
    h = _ln(x, lp["lnx"], cfg)
    ck, cv = _kv(enc_out, lp["cross"])
    x = x + _attn(h, lp["cross"], cfg, causal=False, kv=(ck, cv))
    x = x + FF.mlp(_ln(x, lp["ln2"], cfg), lp["mlp"], cfg)
    return x, (k, v, ck, cv)


def _logits(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The tied head's logits (B, T, V); vocab-sharded on a ``DTensor``
    table."""
    x = _ln(x, params["dec_ln"], cfg)
    return x @ params["embed"].T.to(x.dtype)


def _embed(params: dict, cfg: ArchConfig, tokens) -> torch.Tensor:
    """The tied table's rows of ``tokens``; on a ``DTensor`` table the
    vocab-parallel lookup."""
    if TP.is_dtensor(params["embed"]):
        x = TP.vocab_parallel_embed(params["embed"], tokens)
    else:
        x = params["embed"][tokens.long()]
    return x.to(model_dtype(cfg))


def decode_seq(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
               enc_out: torch.Tensor, *, return_cache: bool = False,
               cache_len: int | None = None):
    """Teacher-forced decoder pass; optionally returns the serving cache
    (self K/V padded to ``cache_len`` positions, the cross K/V, length).
    Returns (logits (B, T, V), cache or None)."""
    x = _embed(params, cfg, tokens)
    B, T, _ = x.shape
    x = x + _positions(T, cfg, x)[None]
    ks, vs, cks, cvs = [], [], [], []
    for l in range(cfg.n_layers):
        x, kvs = _dec_layer(x, _layer(params["dec"], l), cfg, enc_out)
        for acc, t in zip((ks, vs, cks, cvs), kvs):
            acc.append(t)
    logits = _logits(params, cfg, x)
    if not return_cache:
        return logits, None
    stack = lambda ts: torch.stack([_heads(t, cfg) for t in ts])  # noqa: E731
    pad = lambda t: torch.nn.functional.pad(  # noqa: E731
        t, (0, 0, 0, 0, 0, cache_len - T))
    cache = {"k": pad(stack(ks)), "v": pad(stack(vs)),
             "ck": stack(cks), "cv": stack(cvs),
             "length": torch.full((B,), T, dtype=torch.int32,
                                  device=x.device)}
    return logits, cache


def loss_fn(params: dict, cfg: ArchConfig, batch: dict, **_):
    """Teacher-forced cross-entropy over the full (B, T, V) float32 logits
    (whisper's vocabulary is small enough), the gold logit gathered.
    batch: ``frames`` (B, F, D), ``tokens`` and ``labels`` (B, T), -1 =
    masked.  Returns (ce, metrics), the metrics' MoE terms zero.  On
    ``DTensor``s the vocab-parallel cross-entropy, which never gathers the
    vocab-sharded logits."""
    check_param_dtypes(params, cfg)
    enc_out = encode(params, cfg, batch["frames"])
    logits, _ = decode_seq(params, cfg, batch["tokens"], enc_out)
    logits = logits.float()
    labels = batch["labels"]
    if TP.is_dtensor(logits):
        nll, tokens = TP.vocab_parallel_ce(logits, labels)
    else:
        mask = labels >= 0
        safe = labels.clamp(min=0).long()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, safe[..., None])[..., 0]
        nll = torch.where(mask, lse - gold, 0.0).sum()
        tokens = mask.sum().to(torch.int32)
    ce = nll / tokens.clamp(min=1).float()
    return ce, {"ce": ce, "tokens": tokens,
                "moe_aux_loss": TP.zeros_like_scalar(logits, torch.float32),
                "moe_dropped": TP.zeros_like_scalar(logits, torch.int32)}


def prefill(params: dict, cfg: ArchConfig, batch: dict, *, cache_len: int):
    """Encode ``batch["frames"]`` and run the decoder over
    ``batch["tokens"]``.  Returns (last logits (B, V), cache)."""
    check_param_dtypes(params, cfg)
    enc_out = encode(params, cfg, batch["frames"])
    logits, cache = decode_seq(params, cfg, batch["tokens"], enc_out,
                               return_cache=True, cache_len=cache_len)
    return logits[:, -1], cache


def decode_step(params: dict, cfg: ArchConfig, tokens_t: torch.Tensor,
                cache: dict):
    """One decoder token against the self cache (its row written in place)
    and the static cross K/V.  Returns (logits (B, V), new cache)."""
    check_param_dtypes(params, cfg)
    B = tokens_t.shape[0]
    length = cache["length"]
    x = _embed(params, cfg, tokens_t[:, None])
    S_max = cache["k"].shape[2]
    # the reference's gather clamps a position past the table
    pos = _positions(S_max, cfg, x)[length.long().clamp(0, S_max - 1)]
    x = x + pos[:, None, :]
    enc_len = torch.full((B,), cache["ck"].shape[2], dtype=torch.int32,
                         device=x.device)
    for l in range(cfg.n_layers):
        x = _dec_layer_decode(x, _layer(params["dec"], l), cfg, cache, l,
                              length, enc_len)
    logits = _logits(params, cfg, x)[:, 0]
    return logits, {**cache, "length": length + 1}


def _dec_layer_decode(x, lp, cfg: ArchConfig, cache: dict, l: int, length,
                      enc_len):
    """One decoder layer for one token against layer ``l`` of the cache
    (its self K/V row written in place).  Returns x."""
    B = x.shape[0]
    ps, px = lp["self"], lp["cross"]
    h = _ln(x, lp["ln1"], cfg)
    q = _heads(h @ ps["wq"] + ps["bq"], cfg)
    k_t, v_t = _self_kv(h, ps, cfg)
    A._write_at(cache["k"][l], k_t[:, 0], length)
    A._write_at(cache["v"][l], v_t[:, 0], length)
    y = A._decode_attend(q[:, 0], cache["k"][l], cache["v"][l], length + 1)
    x = x + y.reshape(B, 1, -1) @ ps["wo"] + ps["bo"]
    h = _ln(x, lp["lnx"], cfg)
    qx = _heads(h @ px["wq"] + px["bq"], cfg)
    yx = A._decode_attend(qx[:, 0], cache["ck"][l], cache["cv"][l], enc_len)
    x = x + yx.reshape(B, 1, -1) @ px["wo"] + px["bo"]
    return x + FF.mlp(_ln(x, lp["ln2"], cfg), lp["mlp"], cfg)


def empty_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
                length: int = 0, device=None) -> dict:
    """A zeroed cache: self K/V of ``cache_len`` positions and cross K/V of
    ``cfg.encoder_len``, in ``cfg.dtype``."""
    dev = resolve_device(device)
    dtype = model_dtype(cfg)
    L, H, Dh = cfg.n_layers, cfg.n_heads, cfg.head_dim
    zeros = lambda S: torch.zeros((L, batch, S, H, Dh), dtype=dtype,  # noqa: E731
                                  device=dev)
    return {"k": zeros(cache_len), "v": zeros(cache_len),
            "ck": zeros(cfg.encoder_len), "cv": zeros(cfg.encoder_len),
            "length": torch.full((batch,), length, dtype=torch.int32,
                                 device=dev)}
