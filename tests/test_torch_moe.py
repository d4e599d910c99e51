"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's on the CPU: both dispatches at the reduced capacity factor
(4.0) and at the published one (1.25), where tokens drop; the top-k tie
order (``lax.top_k``: lowest expert first); the combine's add order (the
reference's scatter-add walks the slots in order); and the aux terms
summed over the layers in ``forward_seq``."""

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
from repro.models import moe as JMoE
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import moe as TMoE
from repro_torch.models import transformer as TT


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _configs(arch, **over):
    return (dataclasses.replace(get_config(arch).reduced(), **over),
            dataclasses.replace(j_get_config(arch).reduced(), **over))


def _moe_params(cfg, jcfg, seed, router_scale=1.0):
    """The reference's init, the experts scaled so the output is O(1) (and
    a 1e-5 check means something), the router by ``router_scale`` (a
    sharper router crowds some experts past capacity)."""
    p = JMoE.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    p = dict(p, router=p["router"] * router_scale,
             wg=p["wg"] * 8.0, wu=p["wu"] * 8.0, wo=p["wo"] * 8.0)
    tree = jax.tree.map(np.asarray, p)
    return p, convert.params_from_numpy(cfg, tree, "cpu")


def _x(cfg, B, T, seed, shift=0.0):
    """Normal activations; a common ``shift`` adds the same per-expert
    offset to every token's router logits, crowding a few experts."""
    return (np.random.default_rng(seed).normal(size=(B, T, cfg.d_model))
            + shift).astype(np.float32)


@pytest.mark.parametrize("capacity_factor,router_scale,shift", [
    (4.0, 1.0, 0.0), (1.25, 10.0, 1.0)])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_layer_matches_reference(arch, capacity_factor, router_scale,
                                     shift):
    """The port's gather dispatch against the reference's gather and
    einsum dispatches, and its einsum oracle against the reference's, in
    f32 at 1e-5; ``moe_dropped`` exactly equal (0 at the reduced factor,
    some drops at the published 1.25) and the aux loss within 1e-6.
    deepseek: top-2 of 8 with 2 shared experts; llama4: top-1 with 1."""
    cfg, jcfg = _configs(arch, moe_capacity_factor=capacity_factor)
    jp, tp = _moe_params(cfg, jcfg, 1, router_scale)
    x = _x(cfg, 2, 64, 2, shift)
    ty, ta = TMoE.moe_layer(torch.tensor(x), tp, cfg)
    te, tea = TMoE.moe_layer(torch.tensor(x), tp, cfg, dispatch="einsum")
    for dispatch in ("gather", "einsum"):
        jy, ja = JMoE.moe_layer(jnp.asarray(x), jp, jcfg, dispatch=dispatch)
        np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5)
        assert int(ta["moe_dropped"]) == int(ja["moe_dropped"])
        np.testing.assert_allclose(float(ta["moe_aux_loss"]),
                                   float(ja["moe_aux_loss"]), atol=1e-6)
    np.testing.assert_allclose(_np(te), _np(jy), atol=1e-5)
    assert int(tea["moe_dropped"]) == int(ja["moe_dropped"])
    assert ta["moe_dropped"].dtype == torch.int32
    assert float(np.abs(_np(ty)).max()) > 0.1
    if capacity_factor == 4.0:
        assert int(ta["moe_dropped"]) == 0
    else:
        assert int(ta["moe_dropped"]) > 0


def test_topk_tie_order_matches_lax_top_k():
    """F13's order, here in the router: among equal probabilities
    ``lax.top_k`` takes the lowest expert first; ``torch.topk`` need not.
    The port's stable descending sort agrees with ``lax.top_k``."""
    rng = np.random.default_rng(3)
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 8
    probs[:8] = 0.125                                # whole rows tied
    for k in (1, 2, 6):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = TMoE.top_k(torch.tensor(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(TMoE.top_k(torch.tensor(probs[:1]), 6)[1],
                                  [[0, 1, 2, 3, 4, 5]])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_with_tied_router_matches_reference(dtype):
    """Router logits that tie exactly (duplicated router columns and
    integer activations: every product and sum is exact), so the top-k
    breaks ties in every token: the same experts, drops and outputs as the
    reference's (1e-5 in f32; bf16 within two bf16 steps of the largest
    output: the experts' sums cancel, so a small output carries the
    rounding of large terms).
    A capacity factor of 0.5 makes the ties decide the drops too."""
    cfg, jcfg = _configs("deepseek-moe-16b", moe_capacity_factor=0.5,
                         dtype=dtype)
    jp, _ = _moe_params(cfg, jcfg, 4)
    rng = np.random.default_rng(5)
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    base = rng.integers(-2, 3, (cfg.d_model, 4)).astype(np.float32) / 16
    router[:, [0, 1, 2, 3]] = base
    router[:, [5, 4, 7, 6]] = base                     # each column twice
    tree = jax.tree.map(np.asarray, dict(jp, router=jnp.asarray(router)))
    jdt = jnp.dtype(dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), tree)
    tp = convert.params_from_numpy(cfg, tree, "cpu")
    x = rng.integers(-3, 4, (2, 32, cfg.d_model)).astype(np.float32)
    logits = x.reshape(-1, cfg.d_model) @ router
    assert np.all(logits[:, [0, 1, 2, 3]] == logits[:, [5, 4, 7, 6]])
    jy, ja = JMoE.moe_layer(jnp.asarray(x).astype(jdt), jp, jcfg)
    ty, ta = TMoE.moe_layer(torch.tensor(x).to(getattr(torch, dtype)), tp, cfg)
    assert int(ta["moe_dropped"]) == int(ja["moe_dropped"]) > 0
    want = _np(jy)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6 * np.abs(want).max()
    assert np.abs(_np(ty) - want).max() <= tol
    # torch.topk's own order would pick other experts on these ties
    probs = torch.softmax(torch.tensor(logits), -1)
    assert not torch.equal(torch.topk(probs, 2).indices,
                           TMoE.top_k(probs, 2)[1])


def test_combine_adds_in_slot_order_like_the_reference_scatter_add():
    """The combine, bit for bit against the reference's scatter-add
    ``zeros.at[tos].add(contrib)`` in bf16, on contributions of mixed
    magnitude where the add order changes the rounded sum; adding a
    token's slots in descending order instead gives other bits."""
    rng = np.random.default_rng(6)
    N, K, E, C, D = 40, 3, 8, 16, 24
    EC = E * C
    contrib = (rng.normal(size=(EC, D))
               * 10.0 ** rng.integers(-3, 3, (EC, 1))).astype(np.float32)
    contrib = jnp.asarray(contrib).astype(jnp.bfloat16)
    slot_of = np.full((N, K), EC, np.int64)
    for n in range(N):
        experts = rng.choice(E, K, replace=False)
        slot_of[n] = experts * C + rng.integers(0, C, K)
    slot_of[rng.random((N, K)) < 0.1] = EC             # a few dropped
    # make the slots unique, as the dispatch does
    _, first = np.unique(slot_of, return_index=True)
    dup = np.ones(slot_of.size, bool)
    dup[first] = False
    slot_of.reshape(-1)[dup] = EC
    tos = np.full((EC,), N, np.int32)
    for n in range(N):
        for s in slot_of[n]:
            if s < EC:
                tos[s] = n
    want = jnp.zeros((N + 1, D), jnp.bfloat16).at[jnp.asarray(tos)].add(
        contrib)[:N]
    t_contrib = torch.tensor(np.asarray(contrib.astype(jnp.float32))).to(
        torch.bfloat16)
    got = TMoE.combine(t_contrib, torch.tensor(slot_of))
    np.testing.assert_array_equal(_np(got), _np(want))
    backwards = torch.zeros((N, D), dtype=torch.bfloat16)
    padded = torch.cat([t_contrib, torch.zeros((1, D), dtype=torch.bfloat16)])
    for s in torch.tensor(slot_of).sort(dim=1, descending=True).values.T:
        backwards = backwards + padded[s]
    assert not np.array_equal(_np(backwards), _np(want))


def test_forward_seq_sums_the_aux_over_layers():
    """``forward_seq``'s aux: the MoE layers' load-balance terms and drops
    summed in layer order (deepseek's three MoE layers after its dense
    one), as the reference's scan sums them; f32, 1e-6 and exact."""
    cfg, jcfg = _configs("deepseek-moe-16b", moe_capacity_factor=1.25)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(7))
    params = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                       "cpu")
    x = _x(cfg, 2, 48, 8) * 4.0
    jx, jaux, _ = JT.forward_seq(jparams, jcfg, jnp.asarray(x))
    tx, taux, _ = TT.forward_seq(params, cfg, torch.tensor(x))
    np.testing.assert_allclose(_np(tx), _np(jx), atol=1e-4)
    np.testing.assert_allclose(float(taux["moe_aux_loss"]),
                               float(jaux["moe_aux_loss"]), atol=1e-6)
    assert int(taux["moe_dropped"]) == int(jaux["moe_dropped"])
