"""Synthetic data pipeline: deterministic, learnable token streams (the
port's own copy of ``repro.data.pipeline``; numpy only, so its batches
equal the reference's bit for bit).

Real corpora are out of scope for the container; the pipeline produces
structured synthetic batches whose loss provably decreases under training:

  * ``copy``   — second half of each sequence repeats the first half; a
                 model with attention (or a long-state SSM) learns it fast.
  * ``markov`` — order-1 Markov chain with a sparse random transition
                 matrix (perplexity floor = entropy of the chain).
  * ``uniform``— i.i.d. tokens (sanity floor: loss == log V).

Batches are generated with a counter-based PRNG so any step's batch can be
re-materialized after restart (checkpoint/restore replays identically) —
the same property a production sharded-file pipeline gets from file+offset
checkpoints, here by construction.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeSpec


@dataclasses.dataclass(frozen=True)
class DataConfig:
    task: str = "copy"       # copy | markov | uniform
    seed: int = 0
    markov_fanout: int = 4   # successors per state


def _rng_for(step: int, seed: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def make_batch(cfg: ArchConfig, shape: ShapeSpec, step: int,
               dcfg: DataConfig = DataConfig(), *, batch_override: int | None = None):
    """One global batch for ``step`` (numpy; the caller moves it to its
    device)."""
    B = batch_override or shape.global_batch
    T = shape.seq_len
    V = cfg.vocab_size
    rng = _rng_for(step, dcfg.seed)

    t_text = T
    extra = {}
    if cfg.family == "vlm":
        t_text = T - cfg.n_patches
        extra["patches"] = rng.normal(size=(B, cfg.n_patches, cfg.vit_embed_dim)).astype(np.float32)
    if cfg.family == "encdec":
        extra["frames"] = rng.normal(size=(B, cfg.encoder_len, cfg.d_model)).astype(np.float32)

    if dcfg.task == "copy":
        half = t_text // 2
        first = rng.integers(0, V, size=(B, half), dtype=np.int64)
        toks = np.concatenate([first, first], axis=1)
        if toks.shape[1] < t_text:
            pad = rng.integers(0, V, size=(B, t_text - toks.shape[1]), dtype=np.int64)
            toks = np.concatenate([toks, pad], axis=1)
        labels = np.roll(toks, -1, axis=1)
        labels[:, :half] = -1       # only the copied half is scored
        labels[:, -1] = -1
    elif dcfg.task == "markov":
        trans = _markov_table(V, dcfg.markov_fanout, dcfg.seed)
        toks = np.empty((B, t_text), dtype=np.int64)
        toks[:, 0] = rng.integers(0, V, size=B)
        choice = rng.integers(0, dcfg.markov_fanout, size=(B, t_text))
        for t in range(1, t_text):
            toks[:, t] = trans[toks[:, t - 1], choice[:, t]]
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1
    else:
        toks = rng.integers(0, V, size=(B, t_text), dtype=np.int64)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1

    return {
        "tokens": toks.astype(np.int32),
        "labels": labels.astype(np.int32),
        **extra,
    }


_MARKOV_CACHE: dict[tuple[int, int, int], np.ndarray] = {}


def _markov_table(V: int, fanout: int, seed: int) -> np.ndarray:
    key = (V, fanout, seed)
    if key not in _MARKOV_CACHE:
        rng = np.random.default_rng(seed + 1234)
        _MARKOV_CACHE[key] = rng.integers(0, V, size=(V, fanout), dtype=np.int64)
    return _MARKOV_CACHE[key]


def batch_iterator(cfg: ArchConfig, shape: ShapeSpec, n_steps: int,
                   dcfg: DataConfig = DataConfig(), **kw):
    for step in range(n_steps):
        yield make_batch(cfg, shape, step, dcfg, **kw)

