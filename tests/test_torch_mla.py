"""The port's multi-head latent attention (MLA, minicpm3) against the
reference's on the CPU: the full-sequence path through the flash
attention (q / k of width nd + rd, v of vd, its own scale) with the
latent cache it returns, and the absorbed-form decode against a latent
cache, lengths past the cache included."""

import sys

import jax
import jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
    # forget the half-imported `repro` modules that earlier test modules'
    # failed imports left behind
    for _m in sorted(m for m in sys.modules if m.startswith("repro.")):
        if _m.rpartition(".")[0] not in sys.modules:
            del sys.modules[_m]

import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as JA
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import attention as TA

ARCH = "minicpm3-4b"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _params(seed):
    """The reference's MLA init with non-unit norm weights, carried
    across."""
    jcfg = j_get_config(ARCH).reduced()
    p = JA.init_mla(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    rng = np.random.default_rng(seed)
    p = {k: (jnp.asarray(1 + 0.2 * rng.normal(size=v.shape).astype(np.float32))
             if k.endswith("norm") else v) for k, v in p.items()}
    cfg = get_config(ARCH).reduced()
    return jcfg, p, cfg, convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, p), "cpu")


def test_mla_seq_matches_reference():
    """A 150-token sequence over several q and kv blocks (64 each, the
    last ragged): output within 1e-5, the latent ckv and the rotary key
    krope within 1e-5."""
    jcfg, jp, cfg, tp = _params(0)
    x = np.random.default_rng(1).normal(
        size=(2, 150, cfg.d_model)).astype(np.float32)
    kw = dict(q_block=64, kv_block=64, return_kv=True)
    jy, (jckv, jkr) = JA.mla_seq(jnp.asarray(x), jp, jcfg, **kw)
    ty, (tckv, tkr) = TA.mla_seq(torch.tensor(x), tp, cfg, **kw)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5)
    np.testing.assert_allclose(_np(tckv), _np(jckv), atol=1e-5)
    np.testing.assert_allclose(_np(tkr), _np(jkr), atol=1e-5)
    assert tuple(tckv.shape) == (2, 150, cfg.kv_lora_rank)
    assert tuple(tkr.shape) == (2, 150, cfg.qk_rope_dim)


def test_mla_decode_matches_reference():
    """One token in the absorbed form against a latent cache of 48 rows,
    at lengths 0, 20, 47 and 60 (past the cache: the write drops, the
    scores cover every row): output within 1e-5, the caches equal after
    the in-place write."""
    jcfg, jp, cfg, tp = _params(2)
    rng = np.random.default_rng(3)
    B, S = 4, 48
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.normal(size=(B, S, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(B, S, cfg.qk_rope_dim)).astype(np.float32)
    length = np.array([0, 20, 47, 60], np.int32)
    jy, jckv, jkr = JA.mla_decode(jnp.asarray(x), jp, jcfg, jnp.asarray(ckv),
                                  jnp.asarray(kr), jnp.asarray(length))
    tckv, tkr = torch.tensor(ckv), torch.tensor(kr)
    ty, ockv, okr = TA.mla_decode(torch.tensor(x), tp, cfg, tckv, tkr,
                                  torch.tensor(length))
    assert ockv is tckv and okr is tkr                # written in place
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5)
    np.testing.assert_allclose(_np(tckv), _np(jckv), atol=1e-6)
    np.testing.assert_allclose(_np(tkr), _np(jkr), atol=1e-6)
    np.testing.assert_array_equal(_np(tckv)[3], ckv[3])
