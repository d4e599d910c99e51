"""The port's encoder-decoder (whisper, ``repro_torch.models.encdec``)
against the reference's on the CPU, through the model facade: the
sinusoidal positions, the init layout, the encoder, and prefill + 3
decode steps of reduced whisper-small (the decoder's self attention and
its cross attention over the encoder states both through the decode
attention wrapper) in f32 at 1e-4 and in bf16 at 3e-2."""

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
from repro.models import common as JCm
from repro.models import encdec as JED
from repro_torch import convert
from repro_torch import models as TM
from repro_torch.configs import get_config
from repro_torch.models import common as TCm
from repro_torch.models import encdec as TED

ARCH = "whisper-small"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _model(dtype="float32", seed=0):
    """Reduced whisper (2 encoder and 4 decoder layers, 32 frames): the
    reference's weights, with nonzero biases and layer-norm weights so
    every term shows, in ``dtype`` on both sides (F7)."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)
    jcfg = dataclasses.replace(j_get_config(ARCH).reduced(), dtype=dtype)
    master = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                     jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = path[-1].key
        if name.startswith("b") or (name == "w" and a.ndim <= 2):
            return (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return a

    master = jax.tree_util.tree_map_with_path(perturb, master)
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.dtype(dtype)),
                           master)
    return jcfg, jparams, cfg, convert.params_from_numpy(cfg, master, "cpu")


def _batch(cfg, B=2, T=4, seed=1):
    rng = np.random.default_rng(seed)
    return {"frames": rng.normal(size=(B, cfg.encoder_len, cfg.d_model))
            .astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}


@pytest.mark.parametrize("T,D", [(32, 64), (448, 768)])
def test_sinusoid_pos_matches_reference(T, D):
    """Within 5e-5 at whisper's 448-position decoder table (the float32
    ``exp`` of the two libraries differs by an ulp in some frequencies,
    which the position multiplies)."""
    np.testing.assert_allclose(TCm.sinusoid_pos(T, D).numpy(),
                               np.asarray(JCm.sinusoid_pos(T, D)), atol=5e-5)


def test_init_layout_matches_reference():
    """The port's own init gives the reference's tree (``enc`` / ``dec``
    stacks, layer norms with biases, no key bias), in cfg.dtype, with
    ones / zeros layer norms and zero biases."""
    cfg = get_config(ARCH).reduced()
    jshapes = jax.tree.map(lambda a: tuple(a.shape), JM.init_params(
        j_get_config(ARCH).reduced(), jax.random.PRNGKey(0)))
    params = TM.init_params(cfg, 0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), params) == jshapes
    assert "bk" not in params["dec"]["self"]
    assert torch.all(params["enc_ln"]["w"] == 1)
    assert torch.all(params["dec"]["cross"]["bv"] == 0)


def test_encode_matches_reference():
    """The encoder (bidirectional flash attention over 32 frames) within
    1e-5."""
    jcfg, jp, cfg, tp = _model()
    frames = _batch(cfg)["frames"]
    want = JED.encode(jp, jcfg, jnp.asarray(frames))
    got = TED.encode(tp, cfg, torch.tensor(frames))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_prefill_and_decode(dtype, tol):
    """Prefill of 4 start tokens over 32 frames, then 3 decode steps fed
    the reference's greedy tokens: logits and the self / cross caches
    within ``tol``, lengths equal."""
    jcfg, jp, cfg, tp = _model(dtype)
    batch = _batch(cfg)
    jl, jc = JM.prefill(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                        cache_len=16)
    tl, tc = TM.prefill(tp, cfg, {k: torch.tensor(v) for k, v in batch.items()},
                        cache_len=16)
    for step in range(4):
        np.testing.assert_allclose(_np(tl), _np(jl), atol=tol,
                                   err_msg=f"step {step}")
        got = convert.cache_to_numpy(tc)
        for name in ("k", "v", "ck", "cv"):
            np.testing.assert_allclose(got[name], _np(jc[name]), atol=tol,
                                       err_msg=f"step {step} {name}")
        np.testing.assert_array_equal(got["length"], np.asarray(jc["length"]))
        if step == 3:
            break
        tok = _np(jl)[:, :cfg.vocab_size].argmax(-1).astype(np.int32)
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(tok), jc)
        tl, tc = TM.decode_step(tp, cfg, torch.tensor(tok), tc)
