"""The sharded train step of the MoE family over a process group: reduced
deepseek-moe and llama4 (its dense + MoE pairs) on 2 x 2 and 2 x 4
against the one-process ``make_train_step`` and the reference's sharded
``jax.jit``, and the MoE layer on ``DTensor``s
(``tensor_parallel.ExpertShard``) against the plain one.

Each rank routes its own batch rows and computes its own experts (the
rules split E over "model"); the capacity, each assignment's place in
its expert's queue, the drops and the aux term are the whole batch's, so
the drops must equal the one-process step's exactly.

The groups are CPU processes on gloo, spawned as in
``test_torch_train_sharded.py`` (whose helpers this file shares).  The
ranks write their steps' gathered states; the one-process steps run once
here, in the test process, while the reference runs in one subprocess on
8 forced host devices.  Tolerances, the sharded dense step's tightened: loss
1e-3; m and v within 1e-4 of their largest value; the gradient norm 1e-4
relative; parameters 1e-5; the MoE layer's output and gradients 1e-5."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch.train import device_batch
from repro_torch.training import tree as T
from repro_torch.training.step import init_train_state, make_train_step

from test_torch_train_sharded import (SRC, STEP_SHAPE, _against_reference,
                                      _implicit_redistributions, _rel_err,
                                      _tcfg)

DEEPSEEK, LLAMA4 = "deepseek-moe-16b", "llama4-maverick-400b-a17b"
# float32 masters and moments: llama4's published bf16 ones cannot meet
# 1e-5 (one launcher step runs them, _launcher_bf16)
F32 = {"param_dtype": "float32", "opt_state_dtype": "float32"}
# the reduced configs' capacity factor 4.0 drops nothing; at 1.0 the
# one-process step drops 198 of the 1,536 assignments of its 3 MoE layers
LOW_CAPACITY = {"moe_capacity_factor": 1.0}
# case -> (arch, config overrides)
CASES = {
    "deepseek": (DEEPSEEK, {}),
    "llama4": (LLAMA4, F32),
    "drops": (DEEPSEEK, LOW_CAPACITY),
    # 6 experts do not split over 4 "model" ranks: the rules replicate them
    "uneven": (DEEPSEEK, {"n_experts": 6, **LOW_CAPACITY}),
}
REFERENCE_CASES = ("deepseek", "llama4", "drops")
# group -> [(case, TrainConfig keywords)]
STEPS = {
    "2x2": [("deepseek", {"remat": True, "microbatches": 2}),
            ("llama4", {"remat": True}),
            ("drops", {"remat": True, "microbatches": 2})],
    "2x4": [("deepseek", {"remat": False}), ("llama4", {"remat": False}),
            ("drops", {"remat": False}), ("uneven", {"remat": False})],
}


def _cfg(case: str):
    arch, over = CASES[case]
    return dataclasses.replace(get_config(arch).reduced(), **over)


def _batch(cfg) -> dict:
    return make_batch(cfg, STEP_SHAPE, 0, DataConfig("copy"))


# ---------------------------------------------------------------------------
# the ranks (spawned children)
# ---------------------------------------------------------------------------


def _step(mesh, out: dict, case: str, tcfg_kw: dict) -> None:
    """One sharded step from the placed init: its loss, gradient norm and
    MoE terms, whether the new state keeps the specs' layout, the ops
    DTensor redistributed implicitly, and the gathered state on the first
    and the last rank (a replica on another model or data rank that went
    its own way shows there)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.constraints import (activation_policy,
                                                     make_mesh_policy)
    from repro_torch.launch.mesh import dp_axes
    from repro_torch.launch.train import mesh_batch, placed_state

    cfg, tcfg = _cfg(case), _tcfg(**tcfg_kw)
    state, specs = placed_state(cfg, tcfg, mesh)
    with _implicit_redistributions() as seen, activation_policy(
            make_mesh_policy(mesh, dp_axes(mesh))):
        new, m = make_train_step(cfg, tcfg)(state, mesh_batch(_batch(cfg),
                                                               mesh))
    rec = {k: TP.whole(m[k]).item() for k in ("loss", "grad_norm",
                                              "moe_dropped", "moe_aux_loss")}
    rec["implicit_ndims"] = sorted({n for _, n in seen})
    rec["layout_kept"] = ({p: tuple(t.placements) for p, t in T.items(new)}
                          == {p: SH.to_placements(s, mesh)
                              for p, s in T.items(specs)})
    rec["experts_split"] = all(
        "model" in [a for e in spec for a in SH.spec_axes(e)]
        for p, spec in T.items(specs["params"])
        if "moe" in p and "shared" not in p and p[-1] == "wg")
    whole = SH.gather(new)
    if mesh.rank in (0, mesh.size - 1):
        rec["state"] = {"/".join(p): t for p, t in T.items(whole)}
    out[f"step_{case}"] = rec


def _moe_layer(mesh, out: dict, tag: str, cfg) -> None:
    """``moe_layer`` on placed parameters (one layer) and a batch-split x
    against the plain layer: output, aux terms and the gradients of x and
    every leaf, from a loss that weights the output at random and adds
    the aux term (its gradient must count once)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import moe as MOE

    g = torch.Generator().manual_seed(17)
    p = {"moe": T.tree_map(lambda v: v + 0.1 * torch.randn(v.shape,
                                                           generator=g),
                           MOE.init_moe(g, cfg, torch.float32, 1))}
    x = torch.randn(4, 24, cfg.d_model, generator=g)
    w = torch.randn(4, 24, cfg.d_model, generator=g)
    first = lambda tree: T.tree_map(lambda v: v[0], tree)  # noqa: E731

    leaves = T.tree_map(lambda v: v.clone().requires_grad_(True), p)
    xp = x.clone().requires_grad_(True)
    y, aux = MOE.moe_layer(xp, first(leaves)["moe"], cfg)
    ((y * w).sum() + 0.37 * aux["moe_aux_loss"]).backward()

    dm, bat = mesh.device_mesh, (Shard(0), Replicate())
    placed = T.tree_map(lambda v: v.requires_grad_(True),
                        SH.place(p, SH.param_specs(p, mesh), mesh))
    xd = TP.from_whole(x, dm, bat, "cpu").requires_grad_(True)
    yd, auxd = MOE.moe_layer(TP.reduce_grad(xd), first(placed)["moe"], cfg)
    yd = TP.like(yd, xd)
    ((yd * TP.from_whole(w, dm, bat, "cpu")).sum().full_tensor()
     + 0.37 * auxd["moe_aux_loss"].full_tensor()).backward()

    errs = {"y": _rel_err(yd.full_tensor(), y),
            "x": _rel_err(xd.grad.full_tensor(), xp.grad)}
    errs.update({"/".join(k): _rel_err(d.grad.full_tensor(), v.grad)
                 for (k, d), (_, v) in zip(T.items(placed), T.items(leaves))})
    out[f"layer_{tag}"] = {
        "errs": errs,
        "dropped": (int(auxd["moe_dropped"].full_tensor()),
                    int(aux["moe_dropped"])),
        "aux": (float(auxd["moe_aux_loss"].full_tensor()),
                float(aux["moe_aux_loss"])),
        "experts_split": TP.ExpertShard(
            xd, first(placed)["moe"]).split != [],
    }


def _refusals(mesh, out: dict) -> None:
    """x split over its sequence on "model" (Megatron's sequence
    parallelism) and an expert leaf split otherwise than the rules do:
    the layer raises instead of gathering."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import moe as MOE

    cfg = _cfg("deepseek")
    g = torch.Generator().manual_seed(19)
    p = {"moe": MOE.init_moe(g, cfg, torch.float32, 1)}
    placed = T.tree_map(lambda v: v[0], SH.place(p, SH.param_specs(p, mesh),
                                                 mesh))["moe"]
    x = torch.randn(4, 8, cfg.d_model, generator=g)
    dm = mesh.device_mesh
    said = []
    for xl, pl in (((Shard(0), Shard(1)), placed),
                   ((Shard(0), Replicate()),
                    {**placed, "wg": placed["wg"].redistribute(
                        dm, (Replicate(), Shard(2)))})):
        try:
            MOE.moe_layer(TP.from_whole(x, dm, xl, "cpu"), pl, cfg)
            said.append("")
        except NotImplementedError as e:
            said.append(str(e))
    out["refusals"] = said


def _launcher_bf16(mesh, out: dict, tmp: str) -> None:
    """One step of the launcher's loop for reduced llama4 with its
    published bf16 masters and moments."""
    from repro_torch.launch import train as TRAIN

    cfg = get_config(LLAMA4).reduced()
    _, recs = TRAIN.train_loop(cfg, STEP_SHAPE, TRAIN.train_config(1, 1e-3),
                               steps=1, ckpt_dir=os.path.join(tmp, "llama4"),
                               ckpt_every=100, mesh=mesh, log=lambda s: None)
    out["launcher_bf16"] = (cfg.param_dtype, cfg.opt_state_dtype,
                            [r["loss"] for r in recs])


def _rank(rank: int, world: int, shape: tuple, tmp: str, group: str):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    from repro_torch.training import elastic as EL

    dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{group}",
                            rank=rank, world_size=world)
    try:
        mesh = EL.fit_mesh(model_parallel=shape[1], device="cpu")
        out = {}
        if group == "2x2":
            _moe_layer(mesh, out, "2x2", _cfg("deepseek"))
            _moe_layer(mesh, out, "2x2_drops", _cfg("drops"))
            # top-1, gates normalized to 1: the router learns from the aux
            # term alone
            _moe_layer(mesh, out, "2x2_llama4", _cfg("llama4"))
            _refusals(mesh, out)
            _launcher_bf16(mesh, out, tmp)
        else:
            _moe_layer(mesh, out, "2x4_uneven", _cfg("uneven"))
        for case, kw in STEPS[group]:
            _step(mesh, out, case, kw)
        torch.save(out, os.path.join(tmp, f"{group}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _run_group(tmp, group: str, shape: tuple) -> list[dict]:
    world = shape[0] * shape[1]
    mp.start_processes(_rank, args=(world, shape, str(tmp), group),
                       nprocs=world, start_method="forkserver")
    return [torch.load(os.path.join(tmp, f"{group}_rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# the reference's sharded step (one subprocess, 8 forced host devices)
# ---------------------------------------------------------------------------

REFERENCE = r'''
import dataclasses, json, os, sys
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
import jax.numpy as jnp
import numpy as np
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.data.pipeline import make_batch, DataConfig
from repro.distributed import sharding as SH
from repro.training.optimizer import OptConfig
from repro.training.step import TrainConfig, make_train_step

out_dir, cases = sys.argv[1], json.loads(sys.argv[2])
at = jax.sharding.AxisType
# a case is (arch, overrides) on 2 x 4 without remat, or (arch, overrides,
# mesh shape, TrainConfig keywords)
for name, (arch, over, *rest) in cases.items():
    shape, tkw = rest if rest else ((2, 4), {"remat": False})
    mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(at.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=10), **tkw)
    flat = dict(np.load(os.path.join(out_dir, f"init_{name}.npz")))
    state = {}
    for key, arr in flat.items():
        node = state
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(arr)
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    batch = {k: jnp.asarray(v) for k, v in make_batch(
        cfg, ShapeSpec("tiny", 32, 8, "train"), 0, DataConfig("copy")).items()}
    ssp = SH.state_specs(jax.eval_shape(lambda: state), mesh,
                         dp_axes=("data",))
    bsp = SH.batch_specs(jax.eval_shape(lambda: batch), ("data",))
    step = jax.jit(make_train_step(cfg, tcfg), in_shardings=(
        SH.to_named(ssp, mesh), SH.to_named(bsp, mesh)))
    new, m = step(state, batch)
    leaves = {"/".join(p.key for p in path): np.asarray(a, np.float32)
              for path, a in jax.tree_util.tree_flatten_with_path(new)[0]}
    np.savez(os.path.join(out_dir, f"ref_{name}.npz"),
             loss=np.float32(m["loss"]), grad_norm=np.float32(m["grad_norm"]),
             moe_dropped=np.int64(m["moe_dropped"]), **leaves)
print("ok", flush=True)
'''


def _start_reference(tmp) -> subprocess.Popen:
    for name in REFERENCE_CASES:
        state = init_train_state(_cfg(name), _tcfg(remat=False), device="cpu")
        np.savez(os.path.join(tmp, f"init_{name}.npz"),
                 **{"/".join(p): t.numpy() for p, t in T.items(state)})
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    cases = json.dumps({n: CASES[n] for n in REFERENCE_CASES})
    return subprocess.Popen([sys.executable, "-c", REFERENCE, str(tmp), cases],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _one_process_step(case: str, tcfg_kw: dict) -> dict:
    """The one-process step from the same init and batch: its metrics and
    new state."""
    cfg, tcfg = _cfg(case), _tcfg(**tcfg_kw)
    new, m = make_train_step(cfg, tcfg)(
        init_train_state(cfg, tcfg, device="cpu"),
        device_batch(_batch(cfg), "cpu"))
    return {"state": new, **{k: m[k].item() for k in (
        "loss", "grad_norm", "moe_dropped", "moe_aux_loss")}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Every group's results by rank, the one-process steps, and the
    reference's steps; the reference runs while the groups do."""
    mp.get_context("forkserver").set_forkserver_preload(
        ["torch", "torch.distributed.tensor", "repro_torch.launch.train",
         __name__])
    tmp = tmp_path_factory.mktemp("sharded_moe")
    ref = _start_reference(tmp)
    try:
        res = {"2x2": _run_group(tmp, "2x2", (2, 2)),
               "2x4": _run_group(tmp, "2x4", (2, 4))}
        res["one"] = {(g, case): _one_process_step(case, kw)
                      for g, steps in STEPS.items() for case, kw in steps}
        stdout, stderr = ref.communicate(timeout=600)
    finally:
        ref.kill()
    assert ref.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr[-3000:]}"
    res["reference"] = {n: dict(np.load(tmp / f"ref_{n}.npz"))
                        for n in REFERENCE_CASES}
    return res


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _held(want: dict, rec: dict, case: str) -> float:
    """``_against_reference`` of a rank's step record against ``want``
    (flat arrays, loss and gradient norm): the worst parameter difference
    where the first moment is under 1e-5 of its largest value."""
    return _against_reference(want, {
        f"step_{case}_loss": (rec["loss"],),
        f"step_{case}_gnorm": (rec["grad_norm"],),
        f"step_{case}_state": rec["state"]}, f"step_{case}", m_floor=1e-5)

STEP_CASES = [(g, case) for g, steps in STEPS.items() for case, _ in steps]


@pytest.mark.parametrize("group,case", STEP_CASES)
def test_sharded_moe_step_matches_one_process(groups, group, case):
    """One step of reduced deepseek-moe (1 dense + 3 MoE layers, 8
    experts top-2, 2 shared) and llama4 (2 dense + MoE pairs, 8 experts
    top-1, 1 shared; float32 masters) from the same state and batch as the
    one-process step: on 2 x 2 with remat (deepseek with 2 microbatches
    too), on 2 x 4 without; deepseek at capacity factor 1.0 (drops), and
    with 6 experts on 2 x 4 (replicated: every rank computes every
    expert).  Held as against the reference (``_held``): loss 1e-3, the
    gradient norm 1e-4 relative, m and v within 1e-4 of their largest
    value, parameters 1e-5 where the first moment is at least 1e-5 of its
    largest (measured: a dense ``wu`` entry of deepseek on 2 x 4, m
    3.8e-11 of 4.5e-3, lands 1.18e-5 away: Adam's first update divides
    the gradient's float noise by eps) and within lr below it; the aux
    term 1e-5 relative; the drops equal; the new state in the specs'
    layout."""
    one = groups["one"][(group, case)]
    for out in groups[group]:
        rec = out[f"step_{case}"]
        assert abs(rec["loss"] - one["loss"]) < 1e-3
        assert rec["moe_dropped"] == one["moe_dropped"]
        assert abs(rec["moe_aux_loss"] - one["moe_aux_loss"]) <= 1e-5 * one[
            "moe_aux_loss"]
        assert rec["layout_kept"]
    want = {"loss": np.float32(one["loss"]),
            "grad_norm": np.float32(one["grad_norm"]),
            **{"/".join(p): t.numpy() for p, t in T.items(one["state"])}}
    for out in (groups[group][0], groups[group][-1]):
        assert _held(want, out[f"step_{case}"], case) < 1e-3


@pytest.mark.parametrize("group", sorted(STEPS))
def test_drops_equal_the_one_process_step(groups, group):
    """At capacity factor 1.0 the step drops assignments (the capacity,
    queue order and drops are the whole batch's), as many as the
    one-process step, on every rank; at 4.0 none."""
    want = groups["one"][(group, "drops")]["moe_dropped"]
    assert want > 0
    for out in groups[group]:
        assert out["step_drops"]["moe_dropped"] == want
        assert out["step_deepseek"]["moe_dropped"] == 0


def test_experts_split_over_model_unless_uneven(groups):
    """8 experts split over "model" on 2 x 2 and 2 x 4; 6 experts on 2 x 4
    are replicated by the rules (every rank computes them all)."""
    for g in ("2x2", "2x4"):
        for out in groups[g]:
            assert out["step_deepseek"]["experts_split"]
            assert out["step_llama4"]["experts_split"]
    for out in groups["2x4"]:
        assert not out["step_uneven"]["experts_split"]


@pytest.mark.parametrize("case", REFERENCE_CASES)
def test_sharded_moe_step_matches_the_reference_sharded_step(groups, case):
    """The port's 2 x 4 step (remat off) against the reference's ``jax.jit``
    with the same specs on 8 host devices, from the same state and batch:
    loss 1e-3, the gradient norm 1e-4 relative, m and v within 1e-4 of
    their largest value, parameters 1e-5 where the first moment is at
    least 1e-5 of its largest value (below it Adam's first update turns
    the gradient's float noise into the weight: those within lr), and the
    drops equal."""
    ref = groups["reference"][case]
    for out in (groups["2x4"][0], groups["2x4"][-1]):
        assert out[f"step_{case}"]["moe_dropped"] == int(ref["moe_dropped"])
        assert _held(ref, out[f"step_{case}"], case) < 1e-3


@pytest.mark.parametrize("group,case", [("2x2", "deepseek"),
                                        ("2x4", "deepseek"),
                                        ("2x2", "llama4")])
def test_a_step_redistributes_only_scalars_implicitly(groups, group, case):
    """Over a whole MoE step only 0-dim tensors are redistributed
    implicitly (the optimizer's global norm); the layer's collectives are
    the ones ``ExpertShard`` asks for."""
    for out in groups[group]:
        assert out[f"step_{case}"]["implicit_ndims"] in ([], [0])


@pytest.mark.parametrize("tag", ["2x2", "2x2_drops", "2x2_llama4",
                                 "2x4_uneven"])
def test_moe_layer_on_dtensors_matches_the_plain_layer(groups, tag):
    """``moe_layer`` on placed parameters and a batch-split x against the
    plain layer: the output and the gradients of x, the router, the
    routed and the shared experts within 1e-5 of the largest value (at
    least 1); the drops equal, the aux term within 1e-6 relative.  On 2 x
    2 each rank computes its 4 of 8 experts (at capacity factor 4.0 and
    1.0, with drops; llama4's top-1, whose router learns from the aux term
    alone); on 2 x 4, 6 experts, replicated, every rank computes all."""
    group = tag[:3]
    for out in groups[group]:
        rec = out[f"layer_{tag}"]
        assert rec["experts_split"] == (tag != "2x4_uneven")
        assert max(rec["errs"].values()) < 1e-5, rec["errs"]
        got, want = rec["dropped"]
        assert got == want and (want > 0) == (tag in ("2x2_drops",
                                                      "2x4_uneven"))
        got, want = rec["aux"]
        assert abs(got - want) <= 1e-6 * want


def test_moe_layer_refuses_other_layouts(groups):
    """x split over its sequence on "model", or ``wg`` split on its last
    dim: the layer raises, naming the layout it takes."""
    for out in groups["2x2"]:
        seq, col = out["refusals"]
        assert "replicated on the experts' mesh dims" in seq
        assert "split on E alone" in col


def test_launcher_step_with_published_bf16_dtypes(groups):
    """Reduced llama4 with its bf16 masters and moments: one step of the
    launcher's loop on 2 x 2 gives a finite loss, the same on every
    rank."""
    recs = {(param, opt, tuple(losses))
            for param, opt, losses in (out["launcher_bf16"]
                                       for out in groups["2x2"])}
    (param, opt, losses), = recs
    assert (param, opt) == ("bfloat16", "bfloat16")
    assert len(losses) == 1 and np.isfinite(losses[0])

def test_train_flops_count_active_parameters():
    """``chip_smoke.train_flops`` counts an MoE config's active
    parameters, ``launch.roofline``'s rule (routed weights x top_k /
    n_experts): for reduced deepseek, 6 x the active count x tokens plus
    the attention term, below the count over all parameters."""
    from repro_torch.launch import roofline as RL
    from repro_torch.models.model import abstract_params, param_count

    path = os.path.join(os.path.dirname(SRC), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = _cfg("deepseek")
    params = abstract_params(cfg)
    total, active = RL.tree_param_counts(cfg, params)
    B, S = 8, 32
    attn = 12.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * S * B * S
    assert total == param_count(params) and active < total
    assert smoke.train_flops(cfg, params, B, S) == 6.0 * active * B * S + attn
    dense = get_config("qwen2-1.5b").reduced()
    assert smoke.train_flops(dense, abstract_params(dense), B, S) == (
        6.0 * param_count(abstract_params(dense)) * B * S
        + 12.0 * dense.n_layers * dense.n_heads * dense.head_dim * S * B * S)
