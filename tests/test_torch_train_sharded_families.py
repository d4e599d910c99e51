"""The sharded train step of the MLA, vlm and encoder-decoder families over
a process group: reduced minicpm3 (MLA), internvl2 (the patch prefix) and
whisper on 2 x 2 and 2 x 4 against the one-process ``make_train_step``
and the reference's sharded ``jax.jit``, and their sharded layers on
``DTensor``s against the plain ones.

The reduced configs cross the awkward boundaries: minicpm3's ``wdkv`` (64,
16 + 8) splits at 12 columns on 2 ranks and at 6 on 4, so the latent /
rope boundary at 16 lies inside a shard; internvl2's ``mlp1.w1`` (48, 64)
and ``w2`` (64, 64) split on their last axis, where ``w2`` contracts the
hidden; whisper's padded vocab 512 and 4 heads split on "model", with the
replicated ``bo`` added once after ``wo``'s sum.

The groups are CPU processes on gloo, spawned as in
``test_torch_train_sharded.py`` (whose helpers this file shares, with
``test_torch_train_sharded_moe.py``'s).  The ranks write what they
measured; the one-process steps run once here, in the test process, while
the reference runs in one subprocess on 8 forced host devices.
Tolerances, those of the MoE file: loss 1e-3; m and v within 1e-4 of
their largest value; the gradient norm 1e-4 relative; parameters 1e-5;
the layers' output and gradients 1e-5."""

import contextlib
import dataclasses
import importlib.util
import io
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

from test_torch_train_sharded import (SRC, STEP_SHAPE,
                                      _implicit_redistributions, _placement,
                                      _rel_err, _tcfg)
from test_torch_train_sharded_moe import REFERENCE, _held

CASES = {"minicpm3": "minicpm3-4b", "internvl2": "internvl2-26b",
         "whisper": "whisper-small"}
# group -> [(case, TrainConfig keywords)]
STEPS = {
    "2x2": [(case, {"remat": True, "microbatches": 2}) for case in CASES],
    "2x4": [(case, {"remat": False}) for case in CASES],
}
STEP_CASES = [(g, case) for g, steps in STEPS.items() for case, _ in steps]


def _cfg(case: str):
    return get_config(CASES[case]).reduced()


def _batch(cfg) -> dict:
    return make_batch(cfg, STEP_SHAPE, 0, DataConfig("copy"))


def _first(tree: dict) -> dict:
    """Layer 0's leaves of stacked (1, ...) ones."""
    return T.tree_map(lambda v: v[0], tree)


# ---------------------------------------------------------------------------
# the ranks (spawned children)
# ---------------------------------------------------------------------------


def _step(mesh, out: dict, case: str, tcfg_kw: dict) -> None:
    """One sharded step from the placed init: its loss and gradient norm,
    whether the new state keeps the specs' layout, the ops DTensor
    redistributed implicitly, and the gathered state on the first and the
    last rank."""
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
    whole = SH.gather(new)
    if mesh.rank in (0, mesh.size - 1):
        rec["state"] = {"/".join(p): t for p, t in T.items(whole)}
    out[f"step_{case}"] = rec


def _against_plain(mesh, params: dict, run, inputs: list, weights: list):
    """``run(params, *inputs)`` (a tuple of outputs) on plain tensors and
    on the rules' placement of ``params`` with the inputs split over
    "data", each output's gradient given (``weights``, random): the
    outputs' and every gradient's error (``_rel_err``), the ops DTensor
    redistributed implicitly in the sharded forward and backward, and the
    outputs' placements."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TP

    leaves = T.tree_map(lambda v: v.clone().requires_grad_(True), params)
    xs = [x.clone().requires_grad_(True) for x in inputs]
    ys = run(leaves, *xs)
    torch.autograd.backward(ys, weights)

    dm, bat = mesh.device_mesh, (Shard(0), Replicate())
    placed = T.tree_map(lambda v: v.requires_grad_(True),
                        SH.place(params, SH.param_specs(params, mesh), mesh))
    xds = [TP.from_whole(x, dm, bat, "cpu").requires_grad_(True)
           for x in inputs]
    with _implicit_redistributions() as seen:
        yds = run(placed, *(TP.reduce_grad(x) for x in xds))
        torch.autograd.backward(yds, [TP.from_whole(w, dm, bat, "cpu")
                                      for w in weights])
    errs = {f"y{i}": _rel_err(yd.full_tensor(), y)
            for i, (yd, y) in enumerate(zip(yds, ys))}
    errs.update({f"x{i}": _rel_err(xd.grad.full_tensor(), x.grad)
                 for i, (xd, x) in enumerate(zip(xds, xs))})
    errs.update({"/".join(k): _rel_err(d.grad.full_tensor(), v.grad)
                 for (k, d), (_, v) in zip(T.items(placed), T.items(leaves))})
    return errs, [what for what, _ in seen], [tuple(y.placements)
                                              for y in yds], placed


def _noisy(tree: dict, g: torch.Generator) -> dict:
    """``tree`` plus noise: norms off 1, biases off 0."""
    return T.tree_map(lambda v: v + 0.1 * torch.randn(v.shape, generator=g),
                      tree)


def _mla_layer(mesh, out: dict, tag: str, n_heads: int) -> None:
    """``mla_seq`` of reduced minicpm3 with ``n_heads`` heads on placed
    parameters (``TP.like`` completing ``wo``'s sum) against the plain
    attention; whether each rank computed its own heads; and the refusal
    of ``return_kv`` on a ``DTensor``."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import attention as A

    cfg = dataclasses.replace(_cfg("minicpm3"), n_heads=n_heads,
                              n_kv_heads=n_heads)
    g = torch.Generator().manual_seed(23)
    p = {"attn": _noisy(A.init_mla(g, cfg, torch.float32, 1), g)}
    x = torch.randn(4, 24, cfg.d_model, generator=g)
    w = torch.randn(4, 24, cfg.d_model, generator=g)

    def run(params, x):
        y = A.mla_seq(x, _first(params)["attn"], cfg)
        return (TP.like(y, x),)

    errs, seen, _, placed = _against_plain(mesh, p, run, [x], [w])
    xd = TP.from_whole(x, mesh.device_mesh, (Shard(0), Replicate()), "cpu")
    try:
        A.mla_seq(xd, _first(placed)["attn"], cfg, return_kv=True)
        refused = ""
    except NotImplementedError as e:
        refused = str(e)
    out[f"mla_{tag}"] = {
        "errs": errs, "implicit": seen,
        "local": TP.MLAHeads(xd, _first(placed)["attn"], n_heads).local,
        "wdkv_split": TP._shard_offset(_first(placed)["attn"]["wdkv"], 1),
        "refused": refused}


def _patch_prefix(mesh, out: dict, tag: str) -> None:
    """``project_patches`` of reduced internvl2 (``mlp1``: w1 (48, 64), w2
    (64, 64), both column-sharded) on placed parameters and batch-split
    patches against the plain prefix, and its layout."""
    from repro_torch.models import transformer as TF

    cfg = _cfg("internvl2")
    g = torch.Generator().manual_seed(29)
    p = {"mlp1": {"w1": torch.randn(cfg.vit_embed_dim, cfg.d_model,
                                    generator=g) * 0.2,
                  "w2": torch.randn(cfg.d_model, cfg.d_model,
                                    generator=g) * 0.2}}
    patches = torch.randn(4, cfg.n_patches, cfg.vit_embed_dim, generator=g)
    w = torch.randn(4, cfg.n_patches, cfg.d_model, generator=g)
    errs, seen, layouts, placed = _against_plain(
        mesh, p, lambda params, x: (TF.project_patches(params, cfg, x),),
        [patches], [w])
    out[f"prefix_{tag}"] = {
        "errs": errs, "implicit": seen, "layout": layouts[0],
        "w_split": [tuple(t.placements) for t in T.leaves(placed)]}


def _whisper_layers(mesh, out: dict, tag: str) -> None:
    """One encoder layer and one decoder layer (self and cross attention,
    the MLP) of reduced whisper on placed parameters against the plain
    layers: the encoder's input, the decoder's (12 tokens) and the encoder
    states it attends to (20 frames), every leaf's gradient, and both
    outputs' layouts."""
    from repro_torch.models import encdec as ED

    cfg = _cfg("whisper")
    g = torch.Generator().manual_seed(31)
    full = ED.init_params(cfg, device="cpu")
    p = _noisy({k: T.tree_map(lambda v: v[:1], full[k])
                for k in ("enc", "dec")}, g)
    D = cfg.d_model
    xe, xd, enc = (torch.randn(4, n, D, generator=g) for n in (20, 12, 20))
    we, wd = (torch.randn(4, n, D, generator=g) for n in (20, 12))

    def run(params, xe, xd, enc):
        ye = ED._enc_layer(xe, _first(params["enc"]), cfg)
        yd, _ = ED._dec_layer(xd, _first(params["dec"]), cfg, enc)
        return ye, yd

    errs, seen, layouts, _ = _against_plain(mesh, p, run, [xe, xd, enc],
                                            [we, wd])
    out[f"whisper_{tag}"] = {"errs": errs, "implicit": seen,
                             "layouts": layouts}


def _ce_padding(mesh, out: dict) -> None:
    """``chunked_ce_loss`` of reduced internvl2 over 24 positions in
    chunks of 10 (the last padded by 6, as 1,792 text tokens are in chunks
    of 1,024 at full width) on a vocab-sharded head against the plain
    loss: the sum, the count and the gradients."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import transformer as TF

    cfg = _cfg("internvl2")
    g = torch.Generator().manual_seed(37)
    p = {"lm_head": torch.randn(cfg.d_model, cfg.padded_vocab,
                                generator=g) * 0.2}
    x = torch.randn(4, 24, cfg.d_model, generator=g)
    labels = torch.randint(0, cfg.vocab_size, (4, 24), generator=g)
    labels[:, :5] = -1
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xp = x.clone().requires_grad_(True)
    loss, n = TF.chunked_ce_loss(leaves, cfg, xp, labels, chunk=10)
    loss.backward()
    dm, bat = mesh.device_mesh, (Shard(0), Replicate())
    placed = {k: v.requires_grad_(True) for k, v in SH.place(
        p, SH.param_specs(p, mesh), mesh).items()}
    xd = TP.from_whole(x, dm, bat, "cpu").requires_grad_(True)
    with _implicit_redistributions() as seen:
        loss_d, n_d = TF.chunked_ce_loss(placed, cfg, xd, TP.from_whole(
            labels, dm, bat, "cpu"), chunk=10)
        loss_d.full_tensor().backward()
    out["ce_padding"] = {
        "loss": abs(float(loss_d.full_tensor()) - float(loss)) / float(loss),
        "count": (int(n_d.full_tensor()), int(n)),
        "x": _rel_err(xd.grad.full_tensor(), xp.grad),
        "lm_head": _rel_err(placed["lm_head"].grad.full_tensor(),
                            leaves["lm_head"].grad),
        "implicit": sorted({n for _, n in seen})}


def _launcher_whisper(mesh, out: dict, tmp: str) -> None:
    """``main`` with ``--model-parallel 2`` under these four ranks for
    reduced whisper."""
    from repro_torch.launch import train as TRAIN

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TRAIN.main(["--arch", "whisper-small", "--reduced",
                    "--model-parallel", "2", "--steps", "2", "--seq", "32",
                    "--ckpt-dir", os.path.join(tmp, "main_whisper"),
                    "--device", "cpu"])
    out["main_stdout"] = buf.getvalue()


def _rank(rank: int, world: int, shape: tuple, tmp: str, group: str):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    # the launcher's main takes its sharded path under torchrun's variables
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    from repro_torch.training import elastic as EL

    dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{group}",
                            rank=rank, world_size=world)
    try:
        mesh = EL.fit_mesh(model_parallel=shape[1], device="cpu")
        out = {}
        _mla_layer(mesh, out, group, 4)
        _patch_prefix(mesh, out, group)
        _whisper_layers(mesh, out, group)
        if group == "2x2":
            _ce_padding(mesh, out)
            _launcher_whisper(mesh, out, tmp)
        else:
            # 6 heads over 4 ranks: every rank computes every head
            _mla_layer(mesh, out, "2x4_uneven", 6)
        for case in CASES:
            _placement(mesh, out, f"place_{group}_{case}", CASES[case])
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


def _start_reference(tmp) -> subprocess.Popen:
    """The reference's step of every (group, case) of STEPS, on the
    group's mesh with its remat and microbatches, as ``ref_{case}_{group}``."""
    cases = {}
    for group, steps in STEPS.items():
        shape = tuple(int(n) for n in group.split("x"))
        for case, kw in steps:
            state = init_train_state(_cfg(case), _tcfg(**kw), device="cpu")
            np.savez(os.path.join(tmp, f"init_{case}_{group}.npz"),
                     **{"/".join(p): t.numpy() for p, t in T.items(state)})
            cases[f"{case}_{group}"] = (CASES[case], {}, shape, kw)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    cases = json.dumps(cases)
    return subprocess.Popen([sys.executable, "-c", REFERENCE, str(tmp), cases],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _one_process_step(case: str, tcfg_kw: dict) -> dict:
    cfg, tcfg = _cfg(case), _tcfg(**tcfg_kw)
    new, m = make_train_step(cfg, tcfg)(
        init_train_state(cfg, tcfg, device="cpu"),
        device_batch(_batch(cfg), "cpu"))
    return {"state": new, "loss": m["loss"].item(),
            "grad_norm": m["grad_norm"].item()}


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
    tmp = tmp_path_factory.mktemp("sharded_families")
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
    res["reference"] = {(g, case): dict(np.load(tmp / f"ref_{case}_{g}.npz"))
                        for g, case in STEP_CASES}
    return res


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group,case", STEP_CASES)
def test_sharded_family_step_matches_one_process(groups, group, case):
    """One step of reduced minicpm3 (MLA, embed scale 12, depth-scaled
    residuals, logits divided by 10 before the vocab-parallel CE),
    internvl2 (8 patches ahead of 24 text tokens) and whisper (2 encoder
    and 4 decoder layers, 32 frames) from the same state and batch as the
    one-process step: on 2 x 2 with remat and 2 microbatches, on 2 x 4
    without.  Loss 1e-3, the gradient norm 1e-4 relative, m and v within
    1e-4 of their largest value, parameters 1e-5 where the first moment is
    at least 1e-5 of its largest (``_held``), on every rank; the new state
    in the specs' layout and its MoE terms zero."""
    one = groups["one"][(group, case)]
    for out in groups[group]:
        rec = out[f"step_{case}"]
        assert abs(rec["loss"] - one["loss"]) < 1e-3
        assert rec["moe_dropped"] == 0 and rec["moe_aux_loss"] == 0.0
        assert rec["layout_kept"]
    want = {"loss": np.float32(one["loss"]),
            "grad_norm": np.float32(one["grad_norm"]),
            **{"/".join(p): t.numpy() for p, t in T.items(one["state"])}}
    for out in (groups[group][0], groups[group][-1]):
        assert _held(want, out[f"step_{case}"], case) < 1e-3


@pytest.mark.parametrize("group,case", STEP_CASES)
def test_sharded_family_step_matches_the_reference_sharded_step(groups, group,
                                                                case):
    """The port's step against the reference's ``jax.jit`` with the same
    specs, mesh and train config (2 x 2 on 4 of the 8 host devices with
    remat and 2 microbatches, 2 x 4 without remat), from the same state
    and batch: loss 1e-3, the gradient norm 1e-4 relative, m and v within
    1e-4 of their largest value, parameters 1e-5 where the first moment is
    at least 1e-5 of its largest (below it within lr)."""
    ref = groups["reference"][(group, case)]
    for out in (groups[group][0], groups[group][-1]):
        assert _held(ref, out[f"step_{case}"], case) < 1e-3


@pytest.mark.parametrize("group,case", STEP_CASES)
def test_a_step_redistributes_only_scalars_implicitly(groups, group, case):
    """Over a whole step only 0-dim tensors are redistributed implicitly
    (the optimizer's global norm): the gathers of MLA's down projections,
    of the patch prefix and the sums of whisper's ``wo`` products are the
    ones the model asks for."""
    for out in groups[group]:
        assert out[f"step_{case}"]["implicit_ndims"] in ([], [0])


PLACEMENTS = [(g, case) for g in ("2x2", "2x4") for case in sorted(CASES)]


@pytest.mark.parametrize("group,case", PLACEMENTS)
def test_placement_holds_the_rules_bytes(groups, group, case):
    """Every rank's local bytes equal ``sharded_bytes_per_device`` of the
    state specs (ZeRO: m and v split over "data" too, below the bytes
    without it)."""
    for out in groups[group]:
        every, want, no_zero = out[f"place_{group}_{case}_bytes"]
        assert every == [want] * len(every)
        assert want < no_zero
        assert out[f"place_{group}_{case}_m_on_data"] > 0


@pytest.mark.parametrize("group,case", PLACEMENTS)
def test_placement_gathers_to_the_state_bit_for_bit(groups, group, case):
    assert all(out[f"place_{group}_{case}_gather_equal"]
               for out in groups[group])


@pytest.mark.parametrize("tag,local", [("2x2", True), ("2x4", True),
                                       ("2x4_uneven", False)])
def test_mla_on_dtensors_matches_the_plain_attention(groups, tag, local):
    """``mla_seq`` on placed parameters and a batch-split x against the
    plain attention: output and the gradients of x and every leaf within
    1e-5 of the largest value (at least 1), with no implicit
    redistribution.  ``wdkv`` (64, 24) splits at 12 columns on 2 x 2 and
    at 6 on 2 x 4, inside the latent: it is gathered, as ``wdq`` is.  4
    heads split over "model" (each rank its own); 6 heads over 4 ranks do
    not, so every rank computes every head and keeps its own columns for
    ``wo``'s rows.  ``return_kv`` on a ``DTensor`` is refused."""
    for out in groups[tag[:3]]:
        rec = out[f"mla_{tag}"]
        assert rec["local"] == local
        assert max(rec["errs"].values()) < 1e-5, rec["errs"]
        assert rec["implicit"] == []
        assert rec["wdkv_split"][1] == 24 // (2 if tag == "2x2" else 4)
        assert "sharded serving caches" in rec["refused"]


@pytest.mark.parametrize("group", ["2x2", "2x4"])
def test_patch_prefix_on_dtensors_matches_the_plain_prefix(groups, group):
    """``project_patches`` with ``mlp1``'s w1 and w2 column-sharded on
    "model" against the plain prefix: output and every gradient within
    1e-5, no implicit redistribution, and the prefix split over the batch
    and replicated on "model", as the token embeddings it joins."""
    from torch.distributed.tensor import Replicate, Shard

    for out in groups[group]:
        rec = out[f"prefix_{group}"]
        assert all(p == (Replicate(), Shard(1)) for p in rec["w_split"])
        assert max(rec["errs"].values()) < 1e-5, rec["errs"]
        assert rec["implicit"] == []
        assert rec["layout"] == (Shard(0), Replicate())


@pytest.mark.parametrize("group", ["2x2", "2x4"])
def test_whisper_layers_on_dtensors_match_the_plain_layers(groups, group):
    """Whisper's encoder layer and decoder layer (causal self attention,
    cross attention over 20 encoder frames from 12 tokens, the biased
    MLP) on placed parameters against the plain layers: both outputs and
    the gradients of the inputs, the encoder states and every leaf (the
    replicated ``bo`` and the norms' too) within 1e-5, with no implicit
    redistribution, and both outputs in x's layout."""
    from torch.distributed.tensor import Replicate, Shard

    for out in groups[group]:
        rec = out[f"whisper_{group}"]
        assert max(rec["errs"].values()) < 1e-5, rec["errs"]
        assert rec["implicit"] == []
        assert rec["layouts"] == [(Shard(0), Replicate())] * 2


def test_cross_entropy_pads_its_last_chunk_on_each_rank(groups):
    """The chunked cross-entropy pads the sequence to whole chunks (24
    positions in chunks of 10) on each rank's own shard
    (``tensor_parallel.pad``): the loss sum within 1e-5 relative of the
    plain loss's, the count exact, the gradients of x and the
    vocab-sharded head within 1e-5, and only scalars redistributed
    implicitly."""
    for out in groups["2x2"]:
        rec = out["ce_padding"]
        assert rec["loss"] < 1e-5 and rec["x"] < 1e-5 and rec["lm_head"] < 1e-5
        got, want = rec["count"]
        assert got == want == 4 * 19
        assert rec["implicit"] in ([], [0])


def test_launcher_main_trains_whisper_under_four_ranks(groups):
    """``main`` with ``--model-parallel 2`` under four ranks for reduced
    whisper: rank 0 logs the mesh line and both steps with a finite loss;
    the other ranks print nothing."""
    outs = groups["2x2"]
    text = outs[0]["main_stdout"]
    assert "mesh: {'data': 2, 'model': 2} | arch: whisper-small" in text
    lines = [ln for ln in text.splitlines() if ln.startswith("step ")]
    assert [ln.split()[1] for ln in lines] == ["0", "1"]
    assert all(np.isfinite(float(ln.split()[3])) for ln in lines)
    assert "done at step 2" in text
    assert all(out["main_stdout"] == "" for out in outs[1:])


def _smoke():
    path = os.path.join(os.path.dirname(SRC), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_train_flops_count_mla_widths():
    """``chip_smoke.train_flops`` for reduced minicpm3 against a hand
    count: 6 x its parameters (counted from the widths) x tokens, plus
    attention's scores at the query / key width nd + rd and its context at
    v's width vd, 6 x layers x heads x (nd + rd + vd) x seq a token."""
    from repro_torch.models.model import abstract_params

    cfg = _cfg("minicpm3")
    D, V, L, H = cfg.d_model, cfg.padded_vocab, cfg.n_layers, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    layer = (2 * D + D * qr + qr + qr * H * (nd + rd) + D * (kvr + rd) + kvr
             + kvr * H * (nd + vd) + H * vd * D + 3 * D * cfg.d_ff)
    params = 2 * V * D + D + L * layer
    B, S = 8, 32
    want = 6.0 * params * B * S + 6.0 * L * H * (nd + rd + vd) * S * B * S
    assert _smoke().train_flops(cfg, abstract_params(cfg), B, S) == want


def test_train_flops_count_whisper_frames():
    """``chip_smoke.train_flops`` for reduced whisper against a hand count:
    the encoder's weights and the cross attention's K / V projections run
    on the frames (B x encoder_len), the rest on the decoder's tokens;
    attention's 12 x heads x head dim a key: the encoder's self attention
    over the frames, the decoder's over its tokens, the cross attention
    over the frames from each token."""
    from repro_torch.models.model import abstract_params

    cfg = _cfg("whisper")
    D, V, F_ = cfg.d_model, cfg.padded_vocab, cfg.d_ff
    HD, Fr = cfg.n_heads * cfg.head_dim, cfg.encoder_len
    attn = 4 * D * HD + 2 * HD + D            # wq wk wv wo, bq bv, bo
    mlp = 2 * D * F_ + F_ + D
    enc = cfg.n_encoder_layers * (2 * D + attn + 2 * D + mlp) + 2 * D
    cross_kv = cfg.n_layers * (2 * D * HD + HD)
    dec = (V * D + cfg.n_layers * (3 * 2 * D + 2 * attn + mlp) + 2 * D
           - cross_kv)
    B, S = 8, 32
    frames, tokens = B * Fr, B * S
    want = (6.0 * (enc + cross_kv) * frames + 6.0 * dec * tokens
            + 12.0 * HD * (cfg.n_encoder_layers * Fr * frames
                           + cfg.n_layers * (S + Fr) * tokens))
    assert _smoke().train_flops(cfg, abstract_params(cfg), B, S) == want
