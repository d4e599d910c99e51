"""Feed-forward variants: SwiGLU (LM standard) and biased MLP (whisper)
(counterpart of ``repro.models.ffn``)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import activation, dense_init


def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int,
                dtype: torch.dtype, n_layers: int) -> dict:
    L = (n_layers,)
    return {
        "wg": dense_init(gen, L + (d_model, d_ff), dtype),
        "wu": dense_init(gen, L + (d_model, d_ff), dtype),
        "wo": dense_init(gen, L + (d_ff, d_model), dtype),
    }


def swiglu(x, p, cfg: ArchConfig):
    act = activation(cfg.act)
    return (act(x @ p["wg"]) * (x @ p["wu"])) @ p["wo"]


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype, n_layers: int) -> dict:
    L, dev = (n_layers,), gen.device
    return {
        "wi": dense_init(gen, L + (d_model, d_ff), dtype),
        "bi": torch.zeros(L + (d_ff,), dtype=dtype, device=dev),
        "wo": dense_init(gen, L + (d_ff, d_model), dtype),
        "bo": torch.zeros(L + (d_model,), dtype=dtype, device=dev),
    }


def mlp(x, p, cfg: ArchConfig):
    act = activation(cfg.act)
    return act(x @ p["wi"] + p["bi"]) @ p["wo"] + p["bo"]
