"""Public model facade (counterpart of ``repro.models.model``): family
dispatch for init / loss / prefill / decode, the encoder-decoder family
(whisper) to ``encdec``, every other to ``transformer``."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF


def _family(cfg: ArchConfig):
    return ED if cfg.family == "encdec" else TF


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None,
                dtype: str | None = None) -> dict:
    return _family(cfg).init_params(cfg, seed, device=device, dtype=dtype)


def loss_fn(params: dict, cfg: ArchConfig, batch: dict, *,
            remat: bool = False):
    return _family(cfg).loss_fn(params, cfg, batch, remat=remat)


def prefill(params: dict, cfg: ArchConfig, batch: dict, *, cache_len: int):
    return _family(cfg).prefill(params, cfg, batch, cache_len=cache_len)


def decode_step(params: dict, cfg: ArchConfig, tokens_t, cache: dict):
    return _family(cfg).decode_step(params, cfg, tokens_t, cache)


def empty_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
                length: int = 0, device=None) -> dict:
    return _family(cfg).empty_cache(cfg, batch, cache_len, length=length,
                                    device=device)


def _leaves(tree: dict):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def param_count(params: dict) -> int:
    return sum(t.numel() for t in _leaves(params))


def param_bytes(params: dict) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def abstract_params(cfg: ArchConfig) -> dict:
    """The master weights' shapes and dtypes (``cfg.param_dtype``) as
    tensors on the ``meta`` device: nothing is allocated or drawn (the
    reference's ``jax.eval_shape`` of its init)."""
    return init_params(cfg, device="meta", dtype=cfg.param_dtype)
