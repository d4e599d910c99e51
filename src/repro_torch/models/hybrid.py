"""Hymba-style hybrid mixer: parallel attention and Mamba heads in one
layer (counterpart of ``repro.models.hybrid``).

Both branches read the same (pre-normed) hidden states; their outputs are
magnitude-normalized (an RMSNorm each) and averaged.  Sliding-window
attention everywhere except the configured global layers; the meta
tokens are prepended by the transformer (``assemble_inputs``).  The
attention branch decodes through K6, the Mamba branch prefills through K7.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import attention as A
from repro_torch.models import ssm as S
from repro_torch.models.common import rms_norm


def init_hybrid(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
                n_layers: int) -> dict:
    ones = lambda: torch.ones((n_layers, cfg.d_model), dtype=dtype,  # noqa: E731
                              device=gen.device)
    return {
        "attn": A.init_gqa(gen, cfg, dtype, n_layers),
        "ssm": S.init_ssm(gen, cfg, dtype, n_layers),
        "attn_out_norm": ones(),
        "ssm_out_norm": ones(),
    }


def _mix(ya, ys, p, cfg: ArchConfig, x):
    """The branches' RMSNorms, averaged.  On ``DTensor``s each branch's
    partial sum over "model" (its row-sharded output projection) is
    completed in ``x``'s layout first: the norm of a partial sum is not
    the sum of the norms."""
    ya, ys = TP.like(ya, x), TP.like(ys, x)
    return 0.5 * (rms_norm(ya, p["attn_out_norm"], cfg.norm_eps)
                  + rms_norm(ys, p["ssm_out_norm"], cfg.norm_eps))


def hybrid_seq(x, p, cfg: ArchConfig, *, is_global: bool = False,
               positions=None, return_state: bool = False):
    """Full sequence; with ``return_state`` also the attention's (k, v)
    and the Mamba branch's (conv_state, ssm_state)."""
    if return_state:
        ya, (k, v) = A.gqa_seq(x, p["attn"], cfg, is_global=is_global,
                               positions=positions, return_kv=True)
        ys, ssm_state, conv_state = S.ssm_seq(x, p["ssm"], cfg,
                                              return_state=True)
        return _mix(ya, ys, p, cfg, x), (k, v), (conv_state, ssm_state)
    ya = A.gqa_seq(x, p["attn"], cfg, is_global=is_global, positions=positions)
    ys = S.ssm_seq(x, p["ssm"], cfg)
    return _mix(ya, ys, p, cfg, x)


def hybrid_decode(x_t, p, cfg: ArchConfig, k_cache, v_cache, length,
                  conv_state, ssm_state, *, is_global: bool = False):
    """One token: the attention branch writes its K/V into the caches in
    place.  Returns (y, k_cache, v_cache, conv_state, ssm_state)."""
    ya, k_cache, v_cache = A.gqa_decode(x_t, p["attn"], cfg, k_cache, v_cache,
                                        length, is_global=is_global)
    ys, conv_state, ssm_state = S.ssm_decode(x_t, p["ssm"], cfg, conv_state,
                                             ssm_state)
    return _mix(ya, ys, p, cfg, x_t), k_cache, v_cache, conv_state, ssm_state
