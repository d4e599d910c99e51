"""The port's training path against the reference on the CPU: every case
of ``tests/test_training.py`` as a port-vs-reference comparison, from
the reference's train state carried across by ``convert`` (float32 master
weights, optimizer state, step) at the reference's test size
(``ShapeSpec("tiny", 64, 8, "train")``, reduced configs in float32);
``loss_fn`` and its gradients for every family (f32 1e-4, bf16 3e-2);
the synthetic batches bit for bit; the optimizer on identical gradients,
its host scalars against the reference's compiled step (ROADMAP F18) and
``global_norm``'s leaf order; checkpoints across the two packages in
both directions, bf16 leaves included (F17); ``abstract_params`` leaf by
leaf against the reference's ``jax.eval_shape``.  The data-parallel step
is in ``test_torch_train_dist.py``."""

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
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.data import pipeline as JDATA
from repro.models import model as JMODEL
from repro.training import checkpoint as JCKPT
from repro.training import elastic as JEL
from repro.training import optimizer as JOPT
from repro.training import step as JSTEP
from repro.training.grad_compression import dequantize_int8 as j_dequantize
from repro.training.grad_compression import quantize_int8 as j_quantize
from repro_torch import convert
from repro_torch import models as TM
from repro_torch.configs import all_configs, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import pipeline as DATA
from repro_torch.launch.train import device_batch
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import elastic as EL
from repro_torch.training import optimizer as OPT
from repro_torch.training import step as STEP
from repro_torch.training import tree as T
from repro_torch.training.grad_compression import (dequantize_int8,
                                                   quantize_int8)

KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' tensors are small: torch's intra-op threads buy
    nothing on them, and beside other test workers they oversubscribe
    the cores and run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
SHAPE = ShapeSpec("tiny", 64, 8, "train")
J_SHAPE = JShapeSpec("tiny", 64, 8, "train")
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(j_get_config(arch).reduced(), dtype=dtype))


def _tcfgs(**kw):
    opt = kw.pop("opt", {})
    return (STEP.TrainConfig(opt=OPT.OptConfig(**opt), **kw),
            JSTEP.TrainConfig(opt=JOPT.OptConfig(**opt), **kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=()):
    """{path: float64 array} of a nested dict of arrays or tensors."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            if isinstance(v, torch.Tensor):
                v = v.detach().float().numpy()
            out[prefix + (k,)] = np.asarray(v, np.float64)
    return out


def _max_diff(a, b) -> float:
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    return max(float(np.abs(fa[k] - fb[k]).max(initial=0.0)) for k in fa)


def _states(arch, tcfgs, dtype="float32"):
    """The reference's initial train state and the port's copy of it."""
    cfg, jcfg = _cfgs(arch, dtype)
    jstate = JSTEP.init_train_state(jcfg, tcfgs[1], KEY)
    return (convert.train_state_from_numpy(_np_tree(jstate), "cpu"), jstate,
            cfg, jcfg)


def _batch(cfg, i, task="copy"):
    return DATA.make_batch(cfg, SHAPE, i, DATA.DataConfig(task))


@functools.lru_cache(maxsize=None)
def _jit_step(jcfg, jtcfg):
    return jax.jit(JSTEP.make_train_step(jcfg, jtcfg))


def _one_step(arch, **kw):
    """One train step of both packages from the same state and batch."""
    tcfg, jtcfg = _tcfgs(**kw)
    state, jstate, cfg, jcfg = _states(arch, (tcfg, jtcfg))
    b = _batch(cfg, 0)
    new, m = STEP.make_train_step(cfg, tcfg)(state, device_batch(b, "cpu"))
    jnew, jm = _jit_step(jcfg, jtcfg)(jstate, {k: jnp.asarray(v)
                                                for k, v in b.items()})
    return new, m, _np_tree(jnew), jm


# ---------------------------------------------------------------------------
# the cases of tests/test_training.py, port against reference
# ---------------------------------------------------------------------------


def test_loss_decreases():
    """30 steps from the reference's state: the losses track the
    reference's, and fall (its criterion: the mean of the last 5 under
    that of the first 5)."""
    tcfg, jtcfg = _tcfgs(opt=dict(lr=1e-3, warmup_steps=5, total_steps=100),
                         remat=False)
    state, jstate, cfg, jcfg = _states("qwen2-1.5b", (tcfg, jtcfg))
    step, jstep = STEP.make_train_step(cfg, tcfg), _jit_step(jcfg, jtcfg)
    losses, jlosses = [], []
    for i in range(30):
        b = _batch(cfg, i)
        state, m = step(state, device_batch(b, "cpu"))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        jlosses.append(float(jm["loss"]))
    np.testing.assert_allclose(losses, jlosses, atol=1e-4)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


# One AdamW step from zero moments moves a parameter by lr * m / (sqrt(v)
# + eps): where a gradient is below eps (1e-8), the float32 reduction-order
# noise of the two packages' gradients (~2e-10 at ~3e-9) moves that ratio
# by ~1e-2.  So the updated leaves are held to 1e-4 at lr 1e-3, the
# reference's own cross-layout test's rate (``tests/test_dist.py:324``);
# at lr 1e-2 the same noise reaches 1.4e-4.
PARITY_OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
REF_OPT = dict(lr=1e-2, warmup_steps=0, total_steps=10)   # the reference's


def test_one_step_matches_reference():
    """Loss, metrics and every updated leaf (params, m, v, step) after one
    AdamW step within 1e-4."""
    new, m, jnew, jm = _one_step("qwen2-1.5b", opt=PARITY_OPT, remat=False)
    for k in ("loss", "ce", "grad_norm", "lr", "moe_aux_loss"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-4, k
    assert int(m["tokens"]) == int(jm["tokens"])
    assert float(m["lr"]) == float(jm["lr"])
    assert _max_diff(convert.train_state_to_numpy(new), jnew) <= 1e-4
    assert int(new["opt"]["step"]) == int(jnew["opt"]["step"]) == 1


def test_train_state_converts_both_ways():
    """The reference's state with bf16 error buffers: every leaf keeps its
    dtype in the port (float32 masters stay float32) and comes back equal."""
    tcfg, jtcfg = _tcfgs(grad_compression=True)
    state, jstate, *_ = _states("qwen2-1.5b", (tcfg, jtcfg))
    assert all(t.dtype == torch.float32 for t in T.leaves(state["params"]))
    assert all(t.dtype == torch.bfloat16 for t in T.leaves(state["err"]))
    assert state["opt"]["step"].dtype == torch.int32
    back = convert.train_state_to_numpy(state)
    want = _np_tree(jstate)
    assert _flat(back).keys() == _flat(want).keys()
    assert _max_diff(back, want) == 0.0


def test_microbatching_matches_full_batch():
    """4 microbatches against the reference's 4 within 1e-4; the port's 4
    against its single batch within the reference's 5e-2 (at its lr)."""
    new4, m4, jnew4, jm4 = _one_step("qwen2-1.5b", opt=PARITY_OPT,
                                     microbatches=4, remat=False)
    assert abs(float(m4["loss"]) - float(jm4["loss"])) <= 1e-4
    assert _max_diff(new4, jnew4) <= 1e-4
    outs = [_one_step("qwen2-1.5b", opt=REF_OPT, microbatches=mb,
                      remat=False)[0]["params"] for mb in (1, 4)]
    assert _max_diff(*outs) < 5e-2


def test_remat_matches_no_remat():
    """remat against the reference's remat within 1e-4; the port's remat
    against its no remat within the reference's 5e-4 (at its lr)."""
    new_r, m_r, jnew_r, jm_r = _one_step("qwen2-1.5b", opt=PARITY_OPT,
                                         remat=True)
    assert abs(float(m_r["loss"]) - float(jm_r["loss"])) <= 1e-4
    assert _max_diff(new_r, jnew_r) <= 1e-4
    outs = [_one_step("qwen2-1.5b", opt=REF_OPT, remat=remat)[0]["params"]
            for remat in (True, False)]
    assert _max_diff(*outs) <= 5e-4


def test_adafactor_runs():
    """Adafactor on mamba2 (the SSM through the plain chunked scan): three
    steps within 1e-4 of the reference, finite, factored state."""
    tcfg, jtcfg = _tcfgs(opt=dict(name="adafactor", lr=1e-3, warmup_steps=2,
                                  total_steps=20), remat=False)
    state, jstate, cfg, jcfg = _states("mamba2-370m", (tcfg, jtcfg))
    step, jstep = STEP.make_train_step(cfg, tcfg), _jit_step(jcfg, jtcfg)
    for i in range(3):
        b = _batch(cfg, i)
        state, m = step(state, device_batch(b, "cpu"))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        assert bool(torch.isfinite(m["loss"]))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-4
    assert _max_diff(state, _np_tree(jstate)) <= 1e-4
    p_sz = sum(x.numel() for x in T.leaves(state["params"]))
    f_sz = sum(x.numel() for x in T.leaves(state["opt"]["f"]))
    assert f_sz < 0.2 * p_sz


def test_schedule_warmup_and_decay():
    ocfg = OPT.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                         min_lr_ratio=0.1)
    assert OPT.schedule(ocfg, 5) == pytest.approx(0.5)
    assert OPT.schedule(ocfg, 10) == pytest.approx(1.0, abs=1e-2)
    assert OPT.schedule(ocfg, 100) == pytest.approx(0.1, abs=1e-3)


@pytest.mark.parametrize("opt", [
    dict(),
    dict(lr=1e-3, warmup_steps=5, total_steps=100),
    dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
    dict(lr=3e-4, warmup_steps=1000, total_steps=20_000),
    dict(lr=1e-2, warmup_steps=0, total_steps=10),
])
def test_schedule_matches_compiled_reference(opt):
    """F18: the schedule of every step equals the reference's compiled
    one (its reciprocal products, fused multiply-add and ``cosf``)."""
    ocfg, jocfg = OPT.OptConfig(**opt), JOPT.OptConfig(**opt)
    steps = np.arange(ocfg.total_steps + 1, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda s: JOPT.schedule(jocfg, s)))(jnp.asarray(steps)))
    got = np.array([OPT.schedule(ocfg, s) for s in steps], np.float32)
    assert int((got != want).sum()) == 0


def test_step_scalars_match_compiled_reference():
    """F18: AdamW's bias corrections (``optimizer.py:77-78``) and
    Adafactor's decay (``:125``) over 20,000 steps equal the compiled
    reference's bit for bit; torch's float32 ``pow`` does not."""
    ocfg = OPT.OptConfig()
    steps = np.arange(1, 20_001, dtype=np.int32)

    @jax.jit
    @jax.vmap
    def ref(step):
        t = step.astype(jnp.float32)
        return (1.0 - ocfg.b1 ** t, 1.0 - ocfg.b2 ** t,
                1.0 - (t + 1.0) ** -0.8)

    want = np.stack([np.asarray(a) for a in ref(jnp.asarray(steps))], 1)
    got = np.array([(*OPT.bias_corrections(ocfg, int(s)),
                     OPT.adafactor_decay(int(s))) for s in steps], np.float32)
    assert int((got != want).sum()) == 0
    t = torch.tensor(steps, dtype=torch.float32)
    plain = 1.0 - torch.pow(torch.tensor(ocfg.b2), t).numpy()
    assert int((plain != want[:, 1]).sum()) > 0


def test_checkpoint_roundtrip(tmp_path):
    tcfg, jtcfg = _tcfgs(remat=False)
    state, *_ = _states("qwen2-1.5b", (tcfg, jtcfg))
    CKPT.save(state, str(tmp_path), step=7)
    restored, step = CKPT.restore(state, str(tmp_path))
    assert step == 7
    for a, b in zip(T.leaves(state), T.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_gc_keeps_latest(tmp_path):
    tree = {"x": torch.arange(4)}
    for s in (1, 2, 3, 4, 5):
        CKPT.save(tree, str(tmp_path), step=s, keep=2)
    assert CKPT.latest_steps(str(tmp_path)) == [4, 5]


def test_recovery_resumes_from_checkpoint(tmp_path):
    """An injected failure at step 6: the port's loop restores step 4's
    checkpoint, replays, and logs the reference's losses within 1e-4."""
    tcfg, jtcfg = _tcfgs(opt=dict(lr=1e-3, warmup_steps=2, total_steps=60),
                         remat=False)
    state, jstate, cfg, jcfg = _states("qwen2-1.5b", (tcfg, jtcfg))
    bs = [_batch(cfg, i) for i in range(12)]
    state, log, mon = EL.run_with_recovery(
        STEP.make_train_step(cfg, tcfg), state,
        [device_batch(b, "cpu") for b in bs], ckpt_dir=str(tmp_path / "p"),
        interval=4, fail_at={6: RuntimeError("injected node failure")})
    jstate, jlog, _ = JEL.run_with_recovery(
        _jit_step(jcfg, jtcfg), jstate,
        [{k: jnp.asarray(v) for k, v in b.items()} for b in bs],
        ckpt_dir=str(tmp_path / "j"), interval=4,
        fail_at={6: RuntimeError("injected node failure")})
    assert len(log) == len(jlog) >= len(bs)
    np.testing.assert_allclose([float(m["loss"]) for m in log],
                               [float(m["loss"]) for m in jlog], atol=1e-4)
    assert float(log[-1]["loss"]) < float(log[0]["loss"])
    assert mon.times and len(mon.times) == len(log)


def test_resume_places_the_newest_checkpoint(tmp_path):
    """``resume`` restores the newest committed step onto the mesh's
    device; a leftover temporary directory is not a step."""
    tree = {"w": torch.arange(6.0).reshape(2, 3),
            "step": torch.tensor(3, dtype=torch.int32)}
    CKPT.save(tree, str(tmp_path), 2)
    CKPT.save(T.tree_map(lambda t: t * 2, tree), str(tmp_path), 5)
    (tmp_path / ".tmp_step_00000009").mkdir()
    mesh = EL.fit_mesh(devices=[torch.device("cpu")])
    got, step = EL.resume(T.tree_map(torch.zeros_like, tree), str(tmp_path),
                          mesh)
    assert step == 5 and CKPT.latest_steps(str(tmp_path)) == [2, 5]
    assert torch.equal(got["w"], tree["w"] * 2)
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 6


def test_straggler_monitor():
    mon = EL.StragglerMonitor(factor=2.0, window=10)
    jmon = JEL.StragglerMonitor(factor=2.0, window=10)
    times = [1.0] * 8 + [5.0, 1.1, 0.9, 3.0, 1.0]
    assert [mon.record(t) for t in times] == [jmon.record(t) for t in times]
    assert mon.flagged == jmon.flagged == 2


def test_int8_quantization_bounded_error():
    """q and scale equal the reference's compiled quantization bit for bit;
    the error is at most half a step."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(128, 64)) * 0.1).astype(np.float32)
    q, scale = quantize_int8(torch.tensor(x))
    jq, jscale = jax.jit(j_quantize)(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    deq = dequantize_int8(q, scale)
    assert np.array_equal(deq.numpy(), np.asarray(jax.jit(j_dequantize)(
        jq, jscale)))
    err = (deq - torch.tensor(x)).abs()
    assert float(err.max()) <= float(scale) / 2 + 1e-9


def test_fit_mesh_absorbs_device_loss():
    devs = [torch.device("cpu")] * 3
    m = EL.fit_mesh(devices=devs, model_parallel=1)
    assert m.shape == {"data": 3, "model": 1}
    m2 = EL.fit_mesh(devices=devs, model_parallel=2)
    assert m2.shape == {"data": 1, "model": 2}
    jm = JEL.fit_mesh(devices=jax.devices(), model_parallel=1)
    assert dict(jm.shape) == {"data": len(jax.devices()), "model": 1}


# ---------------------------------------------------------------------------
# loss_fn and its gradients, every family
# ---------------------------------------------------------------------------

LOSS_ARCHS = ("qwen2-1.5b", "mamba2-370m", "hymba-1.5b", "deepseek-moe-16b",
              "internvl2-26b", "whisper-small")
# hymba in float32 alone: that case holds every gradient at 1e-4, and
# mamba2's bfloat16 case covers the SSD scan's bf16 path; each case costs
# the reference a compile of several seconds
LOSS_CASES = [(arch, dtype) for arch in LOSS_ARCHS
              for dtype in ("float32", "bfloat16")
              if (arch, dtype) != ("hymba-1.5b", "bfloat16")]


@pytest.mark.parametrize("arch,dtype", LOSS_CASES)
def test_loss_and_grads_match_reference(arch, dtype):
    """The loss, its metrics and the gradient of every float32 master leaf
    through the train step's cast to ``cfg.dtype``, with remat: f32 within
    1e-4, bf16 within 3e-2.  deepseek's aux loss carries a gradient
    (``moe.py:66-68``); internvl2 scores only the text after its patch
    prefix; whisper feeds its frames."""
    cfg, jcfg = _cfgs(arch, dtype)
    jparams = JMODEL.init_params(jcfg, KEY)
    params = convert.train_state_from_numpy(_np_tree(jparams), "cpu")
    b = _batch(cfg, 0)
    cast = jnp.dtype(dtype)

    def jloss(p):
        return JMODEL.loss_fn(jax.tree.map(lambda x: x.astype(cast), p), jcfg,
                              {k: jnp.asarray(v) for k, v in b.items()},
                              remat=True)

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    (loss, m), grads = STEP.value_and_grad(cfg, params, device_batch(b, "cpu"),
                                           remat=True)
    tol = TOL[dtype]
    assert abs(float(loss) - float(jl)) <= tol
    assert abs(float(m["moe_aux_loss"]) - float(jm["moe_aux_loss"])) <= tol
    assert int(m["tokens"]) == int(jm["tokens"])
    assert _max_diff(grads, _np_tree(jg)) <= tol
    if arch == "deepseek-moe-16b":
        assert float(m["moe_aux_loss"]) > 0
        assert int(m["moe_dropped"]) == int(jm["moe_dropped"])
    assert all(g.dtype == torch.float32 for g in T.leaves(grads))


def test_remat_changes_no_loss():
    cfg, _ = _cfgs("qwen2-1.5b")
    params = TM.init_params(cfg, 0, device="cpu")
    b = device_batch(_batch(cfg, 1), "cpu")
    (l0, _), g0 = STEP.value_and_grad(cfg, params, b, remat=False)
    (l1, _), g1 = STEP.value_and_grad(cfg, params, b, remat=True)
    assert float(l0) == float(l1)
    assert _max_diff(g0, g1) <= 1e-6


@pytest.mark.parametrize("T_len,chunk", [(64, 1024), (100, 32)])
def test_chunked_ce_matches_reference(T_len, chunk):
    """The chunked cross-entropy with a ragged last chunk: the same sum and
    count as the reference's one-hot contraction."""
    from repro.models import transformer as JTF
    from repro_torch.models import transformer as TTF

    cfg, jcfg = _cfgs("qwen2-1.5b")
    jparams = JMODEL.init_params(jcfg, KEY)
    params = convert.train_state_from_numpy(_np_tree(jparams), "cpu")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, T_len, cfg.d_model)).astype(np.float32)
    labels = rng.integers(-1, cfg.vocab_size, (2, T_len)).astype(np.int32)
    s, n = TTF.chunked_ce_loss(params, cfg, torch.tensor(x),
                               torch.tensor(labels), chunk=chunk)
    js, jn = JTF.chunked_ce_loss(jparams, jcfg, jnp.asarray(x),
                                 jnp.asarray(labels), chunk=chunk)
    assert int(n) == int(jn) == int((labels >= 0).sum())
    assert abs(float(s) - float(js)) <= 1e-4 * max(1.0, abs(float(js)))


# ---------------------------------------------------------------------------
# data, optimizer, checkpoints across the packages, abstract shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,task", [
    ("qwen2-1.5b", "copy"), ("qwen2-1.5b", "markov"), ("qwen2-1.5b", "uniform"),
    ("internvl2-26b", "copy"), ("whisper-small", "markov")])
def test_make_batch_bit_for_bit(arch, task):
    """Every array of several steps' batches equals the reference's (the
    vlm's patches and whisper's frames too), in dtype and value."""
    cfg, jcfg = _cfgs(arch)
    for i in (0, 3):
        got = DATA.make_batch(cfg, SHAPE, i, DATA.DataConfig(task))
        want = JDATA.make_batch(jcfg, J_SHAPE, i, JDATA.DataConfig(task))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k
    it = DATA.batch_iterator(cfg, SHAPE, 2, DATA.DataConfig(task),
                             batch_override=3)
    jit_ = JDATA.batch_iterator(jcfg, J_SHAPE, 2, JDATA.DataConfig(task),
                                batch_override=3)
    for a, b in zip(it, jit_):
        assert all(np.array_equal(a[k], b[k]) for k in b)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_on_identical_gradients(name):
    """Two updates of both optimizers from the same params, state and
    gradients: every leaf within 1e-6 of the reference's compiled update,
    the learning rate bit for bit."""
    ocfg = OPT.OptConfig(name=name, lr=1e-2, warmup_steps=1, total_steps=7)
    jocfg = JOPT.OptConfig(name=name, lr=1e-2, warmup_steps=1, total_steps=7)
    rng = np.random.default_rng(5)
    shapes = {"w": (3, 8, 16), "b": (16,), "e": (40, 8)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tstate = OPT.opt_init(tparams, ocfg)
    jstate = JOPT.opt_init(jparams, jocfg)
    jupd = jax.jit(lambda p, g, s: JOPT.opt_update(p, g, s, jocfg))
    for _ in range(2):
        grads = {k: (rng.normal(size=s) * 3).astype(np.float32)
                 for k, s in shapes.items()}
        tparams, tstate, m = OPT.opt_update(
            tparams, {k: torch.tensor(v) for k, v in grads.items()}, tstate,
            ocfg)
        jparams, jstate, jm = jupd(
            jparams, {k: jnp.asarray(v) for k, v in grads.items()}, jstate)
        assert float(m["lr"]) == float(jm["lr"])
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5
        assert _max_diff(tparams, _np_tree(jparams)) <= 1e-6
        assert _max_diff(tstate, _np_tree(jstate)) <= 1e-6


def test_global_norm_walks_sorted_keys():
    """The leaves are added in the reference's (sorted-key) order, whatever
    order the dict was built in: the float sum differs otherwise."""
    big = np.full((1,), 2.0 ** 12, np.float32)
    small = np.full((1,), 1.25, np.float32)
    tree = {"z": big, "a": small, "m": -big, "b": small}
    want = float(JOPT.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    got = float(OPT.global_norm({k: torch.tensor(v) for k, v in tree.items()}))
    assert got == want
    inserted = torch.sqrt(sum(torch.tensor(v).square().sum()
                              for v in tree.values()))
    assert float(inserted) != want


def _mixed_tree():
    rng = np.random.default_rng(6)
    return {"params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                       "n": {"k": rng.normal(size=(5,)).astype(np.float32)}},
            "step": np.int32(9), "count": np.arange(6, dtype=np.int32)}


def test_reference_checkpoint_restores_in_port(tmp_path):
    """A reference-written checkpoint: f32 and int32 leaves bit for bit,
    and a bf16 leaf (raw ``<V2`` bytes) read through its bit patterns."""
    tree = _mixed_tree()
    jtree = jax.tree.map(jnp.asarray, tree)
    jtree["err"] = jnp.asarray(tree["params"]["w"]).astype(jnp.bfloat16)
    JCKPT.save(jtree, str(tmp_path), step=3)
    template = convert.train_state_from_numpy(_np_tree(jtree), "cpu")
    template = T.tree_map(torch.zeros_like, template)
    got, step = CKPT.restore(template, str(tmp_path))
    assert step == 3
    want = convert.train_state_from_numpy(_np_tree(jtree), "cpu")
    for (path, a), (_, b) in zip(T.items(got), T.items(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert got["err"].dtype == torch.bfloat16


def test_port_checkpoint_restores_in_reference(tmp_path):
    """A port-written checkpoint: the same files, manifest and bytes as the
    reference writes; the reference restores its f32 and int32 leaves bit
    for bit and, F17, raises on the bf16 leaf it wrote itself."""
    tree = _mixed_tree()
    ttree = convert.train_state_from_numpy(tree, "cpu")
    ttree["err"] = torch.tensor(tree["params"]["w"]).to(torch.bfloat16)
    CKPT.save(ttree, str(tmp_path / "p"), step=5)
    jtree = jax.tree.map(jnp.asarray, tree)
    jtree["err"] = jnp.asarray(tree["params"]["w"]).astype(jnp.bfloat16)
    JCKPT.save(jtree, str(tmp_path / "j"), step=5)
    dirs = [tmp_path / d / "step_00000005" for d in ("p", "j")]
    mans = [json.loads((d / "manifest.json").read_text()) for d in dirs]
    assert mans[0] == mans[1]
    assert mans[0]["leaves"]["err"]["dtype"] == "bfloat16"
    for entry in mans[0]["leaves"].values():
        a, b = ((d / entry["file"]).read_bytes() for d in dirs)
        assert a == b, entry
    no_bf16 = {k: v for k, v in jtree.items() if k != "err"}
    only = tmp_path / "p_noerr"
    CKPT.save({k: v for k, v in ttree.items() if k != "err"}, str(only), 1)
    restored, _ = JCKPT.restore(jax.tree.map(jnp.zeros_like, no_bf16),
                                str(only))
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(no_bf16)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="No cast function"):
        JCKPT.restore(jax.tree.map(jnp.zeros_like, jtree),
                      str(tmp_path / "p"))


def _shapes(tree):
    return {path: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for path, t in T.items(tree)}


def _jshapes(tree):
    return {tuple(p.key for p in path): (tuple(a.shape), str(a.dtype))
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_abstract_params_match_reference(arch):
    """Full-size master weights' shapes and dtypes, leaf for leaf, with
    nothing allocated (the meta device)."""
    got = TM.abstract_params(get_config(arch))
    assert all(t.device.type == "meta" for t in T.leaves(got))
    assert _shapes(got) == _jshapes(JMODEL.abstract_params(j_get_config(arch)))


def test_abstract_train_state_matches_reference():
    tcfg, jtcfg = _tcfgs(grad_compression=True)
    got = STEP.abstract_train_state(get_config("qwen2-1.5b"), tcfg)
    want = JSTEP.abstract_train_state(j_get_config("qwen2-1.5b"), jtcfg)
    assert _shapes(got) == _jshapes(want)
    tcfg, jtcfg = _tcfgs(opt=dict(name="adafactor"))
    got = STEP.abstract_train_state(get_config("mamba2-370m").reduced(), tcfg)
    want = JSTEP.abstract_train_state(j_get_config("mamba2-370m").reduced(),
                                      jtcfg)
    assert _shapes(got) == _jshapes(want)
