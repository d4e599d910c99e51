"""The port's model path against the reference on the CPU: the building
blocks (RMSNorm, RoPE, the blockwise prefill attention, GQA decode and its
cache write), then prefill + decode of the dense family and of the MoE
(deepseek, llama4's pairs), MLA (minicpm3) and vlm (internvl2, with its
patch prefix) families at the reduced sizes, with the reference's weights
carried across by ``convert.params_from_numpy``; the init layouts and
layer groups of every family (the ssm and hybrid model path is in
``test_torch_ssm.py``, whisper's in ``test_torch_encdec.py``, the MoE
layer and MLA alone in ``test_torch_moe.py`` / ``test_torch_mla.py``)."""

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
from repro.models import attention as JA
from repro.models import common as JCm
from repro.models import flash as JF
from repro_torch import convert
from repro_torch import models as TM
from repro_torch.configs import get_config
from repro_torch.models import attention as TA
from repro_torch.models import common as TCm
from repro_torch.models import flash as TF
from repro_torch.models import transformer as TT


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm(plus_one):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    got = TCm.rms_norm(torch.tensor(x), torch.tensor(w), 1e-6, plus_one=plus_one)
    want = JCm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, plus_one=plus_one)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("batched_positions", [False, True])
def test_apply_rope(batched_positions):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = (rng.integers(0, 5000, (2, 7)) if batched_positions
           else np.arange(7)).astype(np.int32)
    got = TCm.apply_rope(torch.tensor(x), torch.tensor(pos), 1e6)
    want = JCm.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


@pytest.mark.parametrize("window,is_global", [(None, False), (40, False),
                                              (40, True)])
def test_flash_attention(window, is_global):
    """Causal, windowed and global (window lifted) prefill attention over
    several q and kv blocks with a ragged last block."""
    rng = np.random.default_rng(2)
    B, T, Hq, Hkv, D = 2, 300, 4, 2, 16
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    kw = dict(causal=True, window=window, q_block=64, kv_block=128)
    got = TF.flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                             is_global=is_global, **kw)
    want = JF.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        is_global=None if window is None else jnp.asarray(is_global), **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)


def _gqa_params(cfg, seed):
    p = JA.init_gqa(jax.random.PRNGKey(seed), cfg, jnp.float32)
    rng = np.random.default_rng(seed)
    # non-zero biases and norm weights so every branch shows
    p = {k: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32)) * 0.1
             if k.startswith("b") or k.endswith("norm") else v)
         for k, v in p.items()}
    return p, convert.params_from_numpy(cfg, _tree_np(p), "cpu")


@pytest.mark.parametrize("arch,is_global", [("qwen2-1.5b", False),
                                            ("gemma3-1b", False),
                                            ("gemma3-1b", True)])
def test_gqa_decode(arch, is_global):
    """One token against a cache, lengths past the window and past S."""
    cfg = get_config(arch).reduced()
    jcfg = j_get_config(arch).reduced()
    jp, tp = _gqa_params(jcfg, 3)
    rng = np.random.default_rng(4)
    B, S = 3, 64
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    kc = rng.normal(size=(B, S, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    vc = rng.normal(size=(B, S, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    length = np.array([5, 50, 70], np.int32)
    jy, jk, jv = JA.gqa_decode(jnp.asarray(x), jp, jcfg, jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(length),
                               is_global=jnp.asarray(is_global))
    ty, tk, tv = TA.gqa_decode(torch.tensor(x), tp, cfg, torch.tensor(kc),
                               torch.tensor(vc), torch.tensor(length),
                               is_global=is_global)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-4)
    np.testing.assert_allclose(_np(tk), _np(jk), atol=1e-5)
    np.testing.assert_allclose(_np(tv), _np(jv), atol=1e-5)


def test_write_at_drops_positions_outside_the_cache():
    """The reference's masked blend writes nothing at idx >= S (a free
    slot's length keeps growing); the port's in-place write matches it."""
    rng = np.random.default_rng(5)
    cache = rng.normal(size=(4, 8, 2, 3)).astype(np.float32)
    row = rng.normal(size=(4, 2, 3)).astype(np.float32)
    idx = np.array([0, 7, 8, 100], np.int32)
    want = JA._write_at(jnp.asarray(cache), jnp.asarray(row), jnp.asarray(idx))
    got = TA._write_at(torch.tensor(cache), torch.tensor(row), torch.tensor(idx))
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got)[2:], cache[2:])


def _run_reference(jcfg, jparams, prompts, cache_len, steps):
    jl, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompts)},
                        cache_len=cache_len)
    logits, caches = [np.asarray(jnp.asarray(jl, jnp.float32))], [_tree_np(jc)]
    tok = np.asarray(jl)[:, :jcfg.vocab_size].argmax(-1).astype(np.int32)
    toks = [tok]
    for _ in range(steps):
        jl, jc = JM.decode_step(jparams, jcfg, jnp.asarray(tok), jc)
        logits.append(np.asarray(jnp.asarray(jl, jnp.float32)))
        caches.append(_tree_np(jc))
        tok = np.asarray(jl)[:, :jcfg.vocab_size].argmax(-1).astype(np.int32)
        toks.append(tok)
    return logits, caches, toks


def _run_port(cfg, params, prompts, cache_len, toks):
    """Prefill + decode, fed the reference's tokens so both see the same
    inputs whatever a near-tie does to an argmax."""
    tl, tc = TM.prefill(params, cfg, {"tokens": torch.tensor(prompts)},
                        cache_len=cache_len)
    logits, caches = [_np(tl)], [convert.cache_to_numpy(tc)]
    for tok in toks[:-1]:
        tl, tc = TM.decode_step(params, cfg, torch.tensor(tok), tc)
        logits.append(_np(tl))
        caches.append(convert.cache_to_numpy(tc))
    return logits, caches


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-14b", "gemma3-1b"])
def test_prefill_and_decode_f32(arch):
    """Reduced configs in f32: logits and caches within 1e-4 over prefill
    and five decode steps.  The 40-token prompt outruns gemma3's window
    (32) in prefill, and its decode mixes local and global layers."""
    cfg = get_config(arch).reduced()
    jcfg = j_get_config(arch).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(cfg, _tree_np(jparams), "cpu")
    prompts = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    jlog, jcache, toks = _run_reference(jcfg, jparams, prompts, 64, 5)
    tlog, tcache = _run_port(cfg, params, prompts, 64, toks)
    for i, (a, b) in enumerate(zip(tlog, jlog)):
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=f"step {i}")
    for i, (a, b) in enumerate(zip(tcache, jcache)):
        np.testing.assert_array_equal(a["length"], b["length"])
        for name in ("k", "v"):
            np.testing.assert_allclose(a["g0"][name], b["g0"][name], atol=1e-4,
                                       err_msg=f"step {i} {name}")
    # the reference's prefill cache carried across decodes like its own
    tl, _ = TM.decode_step(params, cfg, torch.tensor(toks[0]),
                           convert.cache_from_numpy(jcache[0], "cpu"))
    np.testing.assert_allclose(_np(tl), jlog[1], atol=1e-4)


def test_prefill_and_decode_bf16():
    """F7's repair on both sides: the reference serves a bfloat16 config
    once its float32 master weights are cast to bfloat16 (as its training
    step casts them); the port casts them in ``params_from_numpy``.
    Logits within 3e-2."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                              dtype="bfloat16")
    jcfg = dataclasses.replace(j_get_config("qwen2-1.5b").reduced(),
                               dtype="bfloat16")
    master = JM.init_params(jcfg, jax.random.PRNGKey(1))
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), master)
    params = convert.params_from_numpy(cfg, _tree_np(master), "cpu")
    assert params["g0"]["attn"]["wq"].dtype == torch.bfloat16
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jlog, _, toks = _run_reference(jcfg, jparams, prompts, 32, 5)
    tlog, _ = _run_port(cfg, params, prompts, 32, toks)
    for i, (a, b) in enumerate(zip(tlog, jlog)):
        np.testing.assert_allclose(a, b, atol=3e-2, err_msg=f"step {i}")


def test_f32_weights_under_bf16_config_raise_f7():
    """F7: the reference cannot serve its own float32 master weights under
    a bfloat16 config (its layer scan's carry changes dtype); the port
    refuses them with a TypeError instead of upcasting silently."""
    jcfg = dataclasses.replace(j_get_config("qwen2-1.5b").reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                              dtype="bfloat16")
    master = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tokens = np.arange(5, dtype=np.int32)[None]
    with pytest.raises(TypeError):
        JM.prefill(master, jcfg, {"tokens": jnp.asarray(tokens)}, cache_len=16)
    params = convert.params_from_numpy(cfg, _tree_np(master), "cpu",
                                       dtype=torch.float32)
    with pytest.raises(TypeError, match="cfg.dtype"):
        TM.prefill(params, cfg, {"tokens": torch.tensor(tokens)}, cache_len=16)
    with pytest.raises(TypeError, match="cfg.dtype"):
        TM.decode_step(params, cfg, torch.zeros(1, dtype=torch.int32),
                       TM.empty_cache(cfg, 1, 16, device="cpu"))


def test_port_init_layout_matches_reference():
    """The port's own init (seeded, not jax.random) gives the reference's
    tree: the same leaves, shapes, and ones/zeros norm weights."""
    for arch in ("qwen2-1.5b", "gemma3-1b"):
        cfg = get_config(arch).reduced()
        jshapes = jax.tree.map(lambda a: tuple(a.shape), _tree_np(
            JM.init_params(j_get_config(arch).reduced(), jax.random.PRNGKey(0))))
        params = TM.init_params(cfg, 0, device="cpu")
        tshapes = jax.tree.map(lambda t: tuple(t.shape), params)
        assert tshapes == jshapes
        w = params["g0"]["attn"]["wq"]
        assert float(w.abs().max()) <= 3 * 0.02 + 1e-6
        assert 0.015 < float(w.std()) < 0.02
        fill = 0.0 if cfg.norm_plus_one else 1.0
        assert torch.all(params["final_norm"] == fill)


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_ssm_family_init_layout_matches_reference(arch):
    """The port's own init of the ssm and hybrid families gives the
    reference's tree (leaves and shapes), every float leaf in cfg.dtype
    (F7), and the reference's formulas for the SSM's constant leaves:
    A_log = log(linspace(1, 16, H)), D ones, dt_bias zeros."""
    cfg = get_config(arch).reduced()
    jparams = JM.init_params(j_get_config(arch).reduced(),
                             jax.random.PRNGKey(0))
    jshapes = jax.tree.map(lambda a: tuple(a.shape), _tree_np(jparams))
    params = TM.init_params(cfg, 0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), params) == jshapes
    TT.check_param_dtypes(params, cfg)
    ssm = params["g0"]["ssm" if arch == "mamba2-370m" else "mix"]
    ssm = ssm if arch == "mamba2-370m" else ssm["ssm"]
    jssm = jparams["g0"]["ssm" if arch == "mamba2-370m" else "mix"]
    jssm = jssm if arch == "mamba2-370m" else jssm["ssm"]
    for leaf in ("A_log", "D", "dt_bias", "norm_w", "conv_b"):
        np.testing.assert_allclose(_np(ssm[leaf]), _np(jssm[leaf]), rtol=1e-6)
    assert float(ssm["in_proj"].abs().max()) <= 3 * 0.02 + 1e-6
    assert float(ssm["conv_w"].abs().max()) <= 3 * 0.2 + 1e-6
    assert 0.18 < float(ssm["conv_w"].std()) < 0.22   # 0.197 at +-3 sigma


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-14b", "minicpm3-4b",
                                  "qwen2-1.5b", "internvl2-26b", "hymba-1.5b",
                                  "llama4-maverick-400b-a17b",
                                  "deepseek-moe-16b", "whisper-small",
                                  "mamba2-370m"])
def test_layer_groups_match_reference(arch):
    """The layer groups of every config equal the reference's."""
    cfg = get_config(arch).reduced()
    assert TT.layer_groups(cfg) == [
        TT.GroupSpec(**dataclasses.asdict(g))
        for g in __import__("repro.models.transformer",
                            fromlist=["x"]).layer_groups(
                                j_get_config(arch).reduced())]


FAMILIES = ["deepseek-moe-16b", "llama4-maverick-400b-a17b", "minicpm3-4b",
            "internvl2-26b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_init_layout_matches_reference(arch):
    """The port's own init of the MoE, pair, MLA and vlm layouts gives the
    reference's tree (the ``moe`` router / experts / shared leaves, the
    ``a`` / ``b`` sublayers, the MLA leaves, ``mlp1``), every float leaf in
    cfg.dtype, and an empty cache of the reference's shapes."""
    cfg = get_config(arch).reduced()
    jcfg = j_get_config(arch).reduced()
    jshapes = jax.tree.map(lambda a: tuple(a.shape), _tree_np(
        JM.init_params(jcfg, jax.random.PRNGKey(0))))
    params = TM.init_params(cfg, 0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), params) == jshapes
    TT.check_param_dtypes(params, cfg)
    jcache = jax.tree.map(lambda a: tuple(a.shape),
                          JM.empty_cache(jcfg, 3, 16))
    assert jax.tree.map(lambda t: tuple(t.shape),
                        TM.empty_cache(cfg, 3, 16, device="cpu")) == jcache


def _family_batch(cfg, B=2, T=12, seed=8):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(
            size=(B, cfg.n_patches, cfg.vit_embed_dim)).astype(np.float32)
    return batch


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_prefill_and_decode(arch, dtype, tol):
    """Prefill (internvl2 with 8 patch embeddings before its 12 tokens)
    then 3 decode steps fed the reference's greedy tokens: logits and
    every cache entry (K/V, the pair's ka / va / kb / vb, the latent ckv /
    krope) within ``tol``, in f32 and in bf16 (the reference's weights
    cast to bf16 on both sides, F7)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), dtype=dtype)
    master = JM.init_params(jcfg, jax.random.PRNGKey(2))
    jparams = jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)), master)
    params = convert.params_from_numpy(cfg, _tree_np(master), "cpu")
    batch = _family_batch(cfg)
    jl, jc = JM.prefill(jparams, jcfg,
                        {k: jnp.asarray(v) for k, v in batch.items()},
                        cache_len=32)
    tl, tc = TM.prefill(params, cfg,
                        {k: torch.tensor(v) for k, v in batch.items()},
                        cache_len=32)
    for step in range(4):
        np.testing.assert_allclose(_np(tl), _np(jl), atol=tol,
                                   err_msg=f"step {step}")
        got, want = convert.cache_to_numpy(tc), _tree_np(jc)
        np.testing.assert_array_equal(got["length"], want["length"])
        for g in (k for k in want if k != "length"):
            assert sorted(got[g]) == sorted(want[g])
            for name in want[g]:
                np.testing.assert_allclose(
                    got[g][name], np.asarray(want[g][name], np.float32),
                    atol=tol, err_msg=f"step {step} {g}.{name}")
        if step == 3:
            break
        tok = _np(jl)[:, :cfg.vocab_size].argmax(-1).astype(np.int32)
        jl, jc = JM.decode_step(jparams, jcfg, jnp.asarray(tok), jc)
        tl, tc = TM.decode_step(params, cfg, torch.tensor(tok), tc)
