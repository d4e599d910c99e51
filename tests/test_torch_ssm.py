"""The port's SSM and hybrid model path against the reference on the CPU:
the Mamba-2 mixer (``ssm_seq`` / ``ssm_decode``, the conv tail of a
prompt shorter than the conv), the Hymba mixer (``hybrid_seq`` /
``hybrid_decode``), then prefill + decode of reduced mamba2-370m and
hymba-1.5b in f32 and mamba2 in bf16, with the reference's weights carried
across by ``convert.params_from_numpy``."""

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

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as JM
from repro.configs import get_config as j_get_config
from repro.models import hybrid as JH
from repro.models import ssm as JS
from repro_torch import convert
from repro_torch import models as TM
from repro_torch.configs import get_config
from repro_torch.models import hybrid as TH
from repro_torch.models import ssm as TS


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch):
    return get_config(arch).reduced(), j_get_config(arch).reduced()


def _ssm_params(jcfg, seed):
    """The reference's init with its constant leaves made random, so that
    every term (A, D, dt_bias, conv bias, gated norm) shows."""
    p = JS.init_ssm(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    rng = np.random.default_rng(seed)
    H = jcfg.ssm_heads
    p = dict(p)
    p["A_log"] = jnp.asarray(np.log(rng.uniform(1.0, 16.0, H)), jnp.float32)
    p["D"] = jnp.asarray(rng.normal(size=H), jnp.float32)
    p["dt_bias"] = jnp.asarray(rng.normal(size=H) * 0.5, jnp.float32)
    p["conv_b"] = jnp.asarray(rng.normal(size=p["conv_b"].shape) * 0.1,
                              jnp.float32)
    p["norm_w"] = jnp.asarray(1 + 0.1 * rng.normal(size=p["norm_w"].shape),
                              jnp.float32)
    return p


@pytest.mark.parametrize("T", [1, 2, 3, 10, 40])
def test_ssm_seq_matches_reference(T):
    """The mixer over T tokens (Q = min(16, max(8, T)): 8, 10 and 16 with
    a ragged last chunk), its final SSM state and the conv tail: the last
    d_conv - 1 pre-conv rows, zero-padded on the left when T < d_conv - 1."""
    cfg, jcfg = _cfgs("mamba2-370m")
    jp = _ssm_params(jcfg, T)
    tp = convert.params_from_numpy(cfg, _tree_np(jp), "cpu")
    x = np.random.default_rng(T).normal(size=(2, T, cfg.d_model)).astype(
        np.float32)
    jy, jstate, jtail = JS.ssm_seq(jnp.asarray(x), jp, jcfg, return_state=True)
    ty, tstate, ttail = TS.ssm_seq(torch.tensor(x), tp, cfg, return_state=True)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-4)
    np.testing.assert_allclose(_np(tstate), _np(jstate), atol=1e-4)
    assert ttail.shape == (2, cfg.d_conv - 1, tuple(jtail.shape)[-1])
    np.testing.assert_allclose(_np(ttail), _np(jtail), atol=1e-5)
    if T < cfg.d_conv - 1:
        assert torch.all(ttail[:, : cfg.d_conv - 1 - T] == 0)
    np.testing.assert_allclose(_np(TS.ssm_seq(torch.tensor(x), tp, cfg)),
                               _np(jy), atol=1e-4)


def test_ssm_decode_matches_reference():
    """Three decode steps from a prefilled state, each against the
    reference's step from the same state."""
    cfg, jcfg = _cfgs("mamba2-370m")
    jp = _ssm_params(jcfg, 21)
    tp = convert.params_from_numpy(cfg, _tree_np(jp), "cpu")
    rng = np.random.default_rng(21)
    x = rng.normal(size=(3, 12, cfg.d_model)).astype(np.float32)
    _, state, conv = TS.ssm_seq(torch.tensor(x), tp, cfg, return_state=True)
    for step in range(3):
        xt = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
        jy, jconv, jstate = JS.ssm_decode(
            jnp.asarray(xt), jp, jcfg, jnp.asarray(conv.numpy()),
            jnp.asarray(state.numpy()))
        ty, conv, state = TS.ssm_decode(torch.tensor(xt), tp, cfg, conv, state)
        np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-4,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(_np(conv), _np(jconv), atol=1e-6)
        np.testing.assert_allclose(_np(state), _np(jstate), atol=1e-5)


@pytest.mark.parametrize("is_global", [False, True])
def test_hybrid_seq_and_decode_match_reference(is_global):
    """The Hymba mixer over 40 tokens (past the reduced window of 32, or
    global), its (k, v) and (conv, ssm) states in the reference's order,
    then two decode steps against a cache of 64 positions."""
    cfg, jcfg = _cfgs("hymba-1.5b")
    p = dict(JH.init_hybrid(jax.random.PRNGKey(7), jcfg, jnp.float32))
    p["ssm"] = _ssm_params(jcfg, 7)
    rng = np.random.default_rng(8)
    p["attn_out_norm"] = jnp.asarray(1 + 0.1 * rng.normal(size=cfg.d_model),
                                     jnp.float32)
    tp = convert.params_from_numpy(cfg, _tree_np(p), "cpu")
    T, S = 40, 64
    x = rng.normal(size=(2, T, cfg.d_model)).astype(np.float32)
    jy, (jk, jv), (jconv, jstate) = JH.hybrid_seq(
        jnp.asarray(x), p, jcfg, is_global=jnp.asarray(is_global),
        return_state=True)
    ty, (tk, tv), (tconv, tstate) = TH.hybrid_seq(
        torch.tensor(x), tp, cfg, is_global=is_global, return_state=True)
    for got, want in ((ty, jy), (tk, jk), (tv, jv), (tconv, jconv),
                      (tstate, jstate)):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)
    np.testing.assert_allclose(
        _np(TH.hybrid_seq(torch.tensor(x), tp, cfg, is_global=is_global)),
        _np(jy), atol=1e-4)

    pad = ((0, 0), (0, S - T), (0, 0), (0, 0))
    jk, jv = jnp.pad(jk, pad), jnp.pad(jv, pad)
    tk = torch.tensor(np.asarray(jk))
    tv = torch.tensor(np.asarray(jv))
    length = np.full((2,), T, np.int32)
    jconv, jstate = jnp.asarray(tconv.numpy()), jnp.asarray(tstate.numpy())
    for step in range(2):
        xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jy, jk, jv, jconv, jstate = JH.hybrid_decode(
            jnp.asarray(xt), p, jcfg, jk, jv, jnp.asarray(length), jconv,
            jstate, is_global=jnp.asarray(is_global))
        ty, tk, tv, tconv, tstate = TH.hybrid_decode(
            torch.tensor(xt), tp, cfg, tk, tv, torch.tensor(length), tconv,
            tstate, is_global=is_global)
        for got, want in ((ty, jy), (tk, jk), (tv, jv), (tconv, jconv),
                          (tstate, jstate)):
            np.testing.assert_allclose(_np(got), _np(want), atol=1e-4,
                                       err_msg=f"step {step}")
        length = length + 1


def _run_reference(jcfg, jparams, prompts, cache_len, steps):
    jl, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompts)},
                        cache_len=cache_len)
    logits, caches = [_np(jl)], [_tree_np(jc)]
    tok = np.asarray(jl)[:, :jcfg.vocab_size].argmax(-1).astype(np.int32)
    toks = [tok]
    for _ in range(steps):
        jl, jc = JM.decode_step(jparams, jcfg, jnp.asarray(tok), jc)
        logits.append(_np(jl))
        caches.append(_tree_np(jc))
        tok = np.asarray(jl)[:, :jcfg.vocab_size].argmax(-1).astype(np.int32)
        toks.append(tok)
    return logits, caches, toks


def _run_port(cfg, params, prompts, cache_len, toks):
    """Prefill + decode, fed the reference's tokens."""
    tl, tc = TM.prefill(params, cfg, {"tokens": torch.tensor(prompts)},
                        cache_len=cache_len)
    logits, caches = [_np(tl)], [convert.cache_to_numpy(tc)]
    for tok in toks[:-1]:
        tl, tc = TM.decode_step(params, cfg, torch.tensor(tok), tc)
        logits.append(_np(tl))
        caches.append(convert.cache_to_numpy(tc))
    return logits, caches


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_prefill_and_decode_f32(arch):
    """Reduced configs in f32: logits and every cache entry within 1e-4
    over prefill and three decode steps.  The 40-token prompt (48 with
    hymba's 8 meta tokens) runs the scan at Q 16 with a ragged last chunk
    and outruns hymba's window of 32."""
    cfg, jcfg = _cfgs(arch)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(cfg, _tree_np(jparams), "cpu")
    prompts = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    jlog, jcache, toks = _run_reference(jcfg, jparams, prompts, 64, 3)
    tlog, tcache = _run_port(cfg, params, prompts, 64, toks)
    names = ("conv", "ssm") if arch == "mamba2-370m" else ("k", "v", "conv",
                                                            "ssm")
    for i, (a, b) in enumerate(zip(tlog, jlog)):
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=f"step {i}")
    for i, (a, b) in enumerate(zip(tcache, jcache)):
        np.testing.assert_array_equal(a["length"], b["length"])
        assert sorted(a["g0"]) == sorted(b["g0"]) == sorted(names)
        for name in names:
            assert a["g0"][name].shape == b["g0"][name].shape
            np.testing.assert_allclose(a["g0"][name], b["g0"][name],
                                       atol=1e-4, err_msg=f"step {i} {name}")
    # the reference's prefill cache carried across decodes like its own
    tl, _ = TM.decode_step(params, cfg, torch.tensor(toks[0]),
                           convert.cache_from_numpy(jcache[0], "cpu"))
    np.testing.assert_allclose(_np(tl), jlog[1], atol=1e-4)


def test_mamba2_prefill_and_decode_bf16():
    """F7 on the SSM: the reference serves a bfloat16 config once every
    float leaf, ``A_log``, ``D`` and ``dt_bias`` included, is cast to
    bfloat16 (its training step's cast); the port casts them in
    ``params_from_numpy``.  The conv state is bf16, the SSM state f32.
    Logits within 3e-2."""
    cfg = dataclasses.replace(get_config("mamba2-370m").reduced(),
                              dtype="bfloat16")
    jcfg = dataclasses.replace(j_get_config("mamba2-370m").reduced(),
                               dtype="bfloat16")
    master = JM.init_params(jcfg, jax.random.PRNGKey(1))
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), master)
    params = convert.params_from_numpy(cfg, _tree_np(master), "cpu")
    for leaf in ("A_log", "D", "dt_bias", "in_proj"):
        assert params["g0"]["ssm"][leaf].dtype == torch.bfloat16
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jlog, jcache, toks = _run_reference(jcfg, jparams, prompts, 32, 3)
    tlog, tcache = _run_port(cfg, params, prompts, 32, toks)
    for i, (a, b) in enumerate(zip(tlog, jlog)):
        np.testing.assert_allclose(a, b, atol=3e-2, err_msg=f"step {i}")
    _, tc = TM.prefill(params, cfg, {"tokens": torch.tensor(prompts)},
                       cache_len=32)
    assert tc["g0"]["conv"].dtype == torch.bfloat16
    assert tc["g0"]["ssm"].dtype == torch.float32
    assert jcache[0]["g0"]["ssm"].dtype == np.float32


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_empty_cache_matches_reference(arch):
    """``empty_cache``'s entries, shapes and dtypes equal the reference's
    (bf16 conv state and f32 SSM state under a bf16 config)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), dtype="bfloat16")
    jc = _tree_np(JM.empty_cache(jcfg, 3, 24, length=2))
    tc = TM.empty_cache(cfg, 3, 24, length=2, device="cpu")
    assert sorted(tc) == sorted(jc) and sorted(tc["g0"]) == sorted(jc["g0"])
    for name, t in tc["g0"].items():
        assert tuple(t.shape) == jc["g0"][name].shape
        want = torch.float32 if jc["g0"][name].dtype == np.float32 \
            else torch.bfloat16
        assert t.dtype == want and not t.any()
    np.testing.assert_array_equal(tc["length"].numpy(), jc["length"])
