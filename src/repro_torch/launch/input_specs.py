"""Stand-ins for every model input on the ``meta`` device: shapes and
dtypes, nothing allocated (counterpart of ``repro.launch.input_specs``,
whose ``jax.ShapeDtypeStruct`` leaves become ``meta`` tensors).

``input_specs(cfg, shape)`` returns the tree the step of the shape's kind
takes:

  * train   -> {"batch": {tokens, labels, [patches|frames]}}
  * prefill -> {"batch": {tokens, [patches|frames]}}
  * decode  -> {"tokens": (B,), "cache": the cache sized to seq_len}

Modality stubs: the vlm gets precomputed patch embeddings and the audio
family precomputed frame embeddings; the vlm's text is shortened so the
whole sequence is seq_len long.  Token ids are ``TOKEN_DTYPE``, the
reference's int32 (the port's batches, ``data.pipeline``, carry int32).
"""

from __future__ import annotations

import re

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.models import model as MODEL

TOKEN_DTYPE = torch.int32
_SHAPE_NAME = re.compile(r"(train|prefill|decode)@B(\d+)xT(\d+)")


def parse_shape(name: str) -> ShapeSpec:
    """One of the assigned ``SHAPES`` by name, or a shape written
    ``<kind>@B<batch>xT<seq>`` (``train@B8xT2048``: 8 sequences of 2,048
    tokens; ``decode@B32xT8192``: 32 slots of an 8,192-position cache)."""
    if name in SHAPES:
        return SHAPES[name]
    m = _SHAPE_NAME.fullmatch(name)
    if m is None:
        raise KeyError(f"unknown shape {name!r}: one of {sorted(SHAPES)} or "
                       "<train|prefill|decode>@B<batch>xT<seq>")
    return ShapeSpec(name, int(m.group(3)), int(m.group(2)), m.group(1))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs_for(cfg: ArchConfig, shape: ShapeSpec, *,
                    with_labels: bool) -> dict:
    B, T = shape.global_batch, shape.seq_len
    t_text = T
    out = {}
    if cfg.family == "vlm":
        t_text = T - cfg.n_patches
        out["patches"] = _meta((B, cfg.n_patches, cfg.vit_embed_dim),
                               torch.float32)
    if cfg.family == "encdec":
        out["frames"] = _meta((B, cfg.encoder_len, cfg.d_model), torch.float32)
    out["tokens"] = _meta((B, t_text), TOKEN_DTYPE)
    if with_labels:
        out["labels"] = _meta((B, t_text), TOKEN_DTYPE)
    return out


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Inputs for the step kind the shape dictates."""
    if shape.kind == "train":
        return {"batch": batch_specs_for(cfg, shape, with_labels=True)}
    if shape.kind == "prefill":
        return {"batch": batch_specs_for(cfg, shape, with_labels=False)}
    # decode: one new token against a seq_len-sized cache
    B = shape.global_batch
    return {"tokens": _meta((B,), TOKEN_DTYPE),
            "cache": MODEL.empty_cache(cfg, B, shape.seq_len, length=0,
                                       device="meta")}
