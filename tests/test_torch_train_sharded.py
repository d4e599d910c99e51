"""The sharded train step over a process group: the state placed as
``DTensor``s by ``distributed.sharding``, the model's vocab-parallel
embedding and cross-entropy, the SSD mixer on each rank's own heads, the
2 x 4 and 2 x 2 steps of the dense, SSM (mamba2) and hybrid (hymba)
families against the one-process ``make_train_step`` and the reference's
sharded ``jax.jit``, and the launcher's checkpoints across meshes.

Each group is CPU processes on gloo (``torch.multiprocessing`` from a fork
server, one intra-op thread a process), joined through a file store under
``tmp_path``.  A group runs once a module (a fixture), writes what it
measured with ``torch.save``, and the tests read it.  The reference runs
in one subprocess on 8 forced host devices, with the ``enable_x64`` shim
set in its own code, from the port's initial state written as ``.npz``.
Tolerances: the steps, loss 1e-3 and parameters 2e-3 (those of the
reference's ``tests/test_dist.py`` 8-devices-equal-1 test); the
vocab-parallel pieces 1e-5 against the plain ones; placement and
same-mesh replays bit for bit."""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch.train import device_batch, train_config
from repro_torch.training import tree as T
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.step import (TrainConfig, init_train_state,
                                       make_train_step, value_and_grad)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
ARCH = "qwen2-1.5b"
# the SSM and hybrid families (ROADMAP step 16c(b)), by their tags' suffix
SSM_ARCHS = {"mamba2": "mamba2-370m", "hymba": "hymba-1.5b"}
REFERENCE_ARCHS = (ARCH, *SSM_ARCHS.values())
# the inputs of the reference's tests/test_dist.py 8-devices-equal-1 test
STEP_SHAPE = ShapeSpec("tiny", 32, 8, "train")
LAUNCH_SHAPE = ShapeSpec("launch", 32, 8, "train")
LAUNCH_STEPS, LAUNCH_CKPT = 6, 4


def _cfg():
    return get_config(ARCH).reduced()


def _tcfg(**kw) -> TrainConfig:
    return TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=10),
                       **kw)


def _rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b|'s largest entry over b's largest magnitude (at least 1)."""
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)


def _worst(a: dict, b: dict) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(T.leaves(a), T.leaves(b)))


# ---------------------------------------------------------------------------
# the ranks (spawned children)
# ---------------------------------------------------------------------------


def _placement(mesh, out: dict, tag: str, arch: str = ARCH) -> None:
    """Every rank's local bytes against the rules', and the gathered
    state against the one-process init, bit for bit."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.train import placed_state
    from repro_torch.training.step import abstract_train_state

    cfg, tcfg = get_config(arch).reduced(), _tcfg()
    state, specs = placed_state(cfg, tcfg, mesh)
    abstract = abstract_train_state(cfg, tcfg)
    want = SH.sharded_bytes_per_device(abstract, specs, mesh)
    got = torch.tensor([SH.local_bytes(state)])
    every = [torch.zeros_like(got) for _ in range(mesh.size)]
    dist.all_gather(every, got)
    whole = SH.gather(state)
    ref = init_train_state(cfg, tcfg, device="cpu")
    same = all(torch.equal(a, b) for a, b in zip(T.leaves(whole),
                                                 T.leaves(ref)))
    # ZeRO: m leaves split over "data" too
    m_data = [p for p, spec in T.items(specs["opt"]["m"])
              if any("data" in SH.spec_axes(e) for e in spec)]
    out[f"{tag}_bytes"] = ([int(t) for t in every], want,
                           SH.sharded_bytes_per_device(
                               abstract, SH.state_specs(
                                   abstract, mesh, zero=False), mesh))
    out[f"{tag}_gather_equal"] = same
    out[f"{tag}_m_on_data"] = len(m_data)


def _step(mesh, out: dict, tag: str, tcfg: TrainConfig,
          arch: str = ARCH) -> None:
    """One sharded step from the placed init against the one-process
    step from the same init and batch."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.constraints import (activation_policy,
                                                     make_mesh_policy)
    from repro_torch.launch.mesh import dp_axes
    from repro_torch.launch.train import mesh_batch, placed_state

    cfg = get_config(arch).reduced()
    state, specs = placed_state(cfg, tcfg, mesh)
    b = make_batch(cfg, STEP_SHAPE, 0, DataConfig("copy"))
    with _implicit_redistributions() as seen, activation_policy(
            make_mesh_policy(mesh, dp_axes(mesh))):
        new, m = make_train_step(cfg, tcfg)(state, mesh_batch(b, mesh))
    out[f"{tag}_step_implicit_ndims"] = sorted({n for _, n in seen})
    placements = {p: tuple(t.placements) for p, t in T.items(new)}
    want = {p: SH.to_placements(s, mesh) for p, s in T.items(specs)}
    whole = SH.gather(new)
    ref = init_train_state(cfg, tcfg, device="cpu")
    ref_new, ref_m = make_train_step(cfg, tcfg)(ref, device_batch(b, "cpu"))
    m_max, v_max = (max(float(t.abs().max()) for t in T.leaves(
        ref_new["opt"][k])) for k in ("m", "v"))
    out[f"{tag}_loss"] = (float(m["loss"].full_tensor()), float(ref_m["loss"]))
    out[f"{tag}_gnorm"] = (float(TP.whole(m["grad_norm"])),
                           float(ref_m["grad_norm"]))
    out[f"{tag}_params_worst"] = _worst(whole["params"], ref_new["params"])
    out[f"{tag}_m_worst"] = _worst(whole["opt"]["m"],
                                   ref_new["opt"]["m"]) / m_max
    out[f"{tag}_v_worst"] = _worst(whole["opt"]["v"],
                                   ref_new["opt"]["v"]) / v_max
    out[f"{tag}_layout_kept"] = placements == want
    if tag.startswith("step_2x4") and arch in REFERENCE_ARCHS:
        out[f"{tag}_state"] = {"/".join(p): t for p, t in T.items(whole)}
    if arch in SSM_ARCHS.values():
        # the model's forward and backward once more, watched
        with _implicit_redistributions() as seen, activation_policy(
                make_mesh_policy(mesh, dp_axes(mesh))):
            value_and_grad(cfg, state["params"], mesh_batch(b, mesh),
                           remat=tcfg.remat)
        out[f"{tag}_implicit"] = [what for what, _ in seen]


@contextlib.contextmanager
def _implicit_redistributions():
    """The ops for which DTensor's dispatch redistributes an argument by
    itself (an implicit collective or copy), listed while inside: (what,
    the argument's number of dims)."""
    from torch.distributed.tensor._dispatch import OpDispatcher

    seen = []
    plain = OpDispatcher.redistribute_local_args

    def watched(op_info, schema, *args):
        want = schema.args_schema
        if op_info.args_tree_spec is not None:
            want = tuple(torch.utils._pytree.tree_leaves(want))
        seen.extend((f"{schema.op}: {a.placements} -> {b.placements}",
                     len(a.shape))
                    for a, b in zip(op_info.flat_args_schema, want)
                    if hasattr(a, "placements") and a != b)
        return plain(op_info, schema, *args)

    OpDispatcher.redistribute_local_args = staticmethod(watched)
    try:
        yield seen
    finally:
        OpDispatcher.redistribute_local_args = staticmethod(plain)


def _ssd_mixer(mesh, out: dict, tag: str, heads: int) -> None:
    """``ssm_seq`` on a ``DTensor`` (placed by the rules, x split over
    "data") against the plain mixer: output and every gradient, from a
    loss that weights the output at random.  ``heads`` SSD heads of
    reduced mamba2's width 16: 4 split over "model" on 2 x 2, 6 on 2 x 4
    (no split: every rank computes every head)."""
    import dataclasses

    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import ssm as S

    cfg = dataclasses.replace(get_config("mamba2-370m").reduced(),
                              ssm_heads=heads)
    g = torch.Generator().manual_seed(11)
    p = {k: v + 0.1 * torch.randn(v.shape, generator=g)
         for k, v in S.init_ssm(g, cfg, torch.float32, 1).items()}
    x = torch.randn(4, 24, cfg.d_model, generator=g)
    w = torch.randn(4, 24, cfg.d_model, generator=g)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xp = x.clone().requires_grad_(True)
    y = S.ssm_seq(xp, {k: v[0] for k, v in leaves.items()}, cfg)
    (y * w).sum().backward()
    dm, bat = mesh.device_mesh, (Shard(0), Replicate())
    placed = {k: v.requires_grad_(True) for k, v in SH.place(
        p, SH.param_specs(p, mesh), mesh).items()}
    xd = TP.from_whole(x, dm, bat, "cpu").requires_grad_(True)
    yd = TP.like(S.ssm_seq(TP.reduce_grad(xd), {k: v[0] for k, v
                                                 in placed.items()}, cfg), xd)
    (yd * TP.from_whole(w, dm, bat, "cpu")).sum().full_tensor().backward()

    errs = {"y": _rel_err(yd.full_tensor(), y),
            "x": _rel_err(xd.grad.full_tensor(), xp.grad)}
    errs.update({k: _rel_err(placed[k].grad.full_tensor(), leaves[k].grad)
                 for k in p})
    out[f"{tag}_errs"] = errs
    out[f"{tag}_local_heads"] = TP.SSDHeads(
        xd, {k: v[0] for k, v in placed.items()}, heads,
        cfg.ssm_head_dim, cfg.d_state, cfg.ssm_groups).h


def _uneven_q_heads(mesh, out: dict) -> None:
    """``gqa_seq`` with 6 q and 2 kv heads over 4 "model" ranks (hymba's
    25 and 5 on 2, in small): q and kv are gathered, every rank attends
    with every head and keeps its own columns for ``wo``'s rows.  Output
    and gradients against the plain attention, and the implicit
    redistributions of its forward and backward (none)."""
    import dataclasses

    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import attention as A

    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), n_heads=6,
                              n_kv_heads=2)
    g = torch.Generator().manual_seed(13)
    p = {k: v + 0.1 * torch.randn(v.shape, generator=g)
         for k, v in A.init_gqa(g, cfg, torch.float32, 1).items()}
    x = torch.randn(4, 24, cfg.d_model, generator=g)
    w = torch.randn(4, 24, cfg.d_model, generator=g)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xp = x.clone().requires_grad_(True)
    y = A.gqa_seq(xp, {k: v[0] for k, v in leaves.items()}, cfg)
    y.backward(w)
    dm, bat = mesh.device_mesh, (Shard(0), Replicate())
    placed = {k: v.requires_grad_(True) for k, v in SH.place(
        p, SH.param_specs(p, mesh), mesh).items()}
    xd = TP.from_whole(x, dm, bat, "cpu").requires_grad_(True)
    with _implicit_redistributions() as seen:
        yd = A.gqa_seq(TP.reduce_grad(xd),
                       {k: v[0] for k, v in placed.items()}, cfg)
        yd = TP.like(yd, xd)
        yd.backward(TP.from_whole(w, dm, bat, "cpu"))
    errs = {"y": _rel_err(yd.full_tensor(), y),
            "x": _rel_err(xd.grad.full_tensor(), xp.grad)}
    errs.update({k: _rel_err(placed[k].grad.full_tensor(), leaves[k].grad)
                 for k in p})
    out["uneven_q"] = (errs, [what for what, _ in seen], TP._heads_split(
        placed["wq"][0], cfg.n_heads))


def _layer_layouts(mesh, out: dict) -> None:
    """One ``ssm`` and one ``hybrid`` layer of the reduced configs on a
    ``DTensor`` x: the layer's output keeps x's layout (the mixer's
    partial sum over "model" completed before the residual add), and
    ``ssd_scan`` refuses a ``DTensor``."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.kernels.ssd_chunk.ops import ssd_scan
    from repro_torch.models import transformer as TF

    g = torch.Generator().manual_seed(3)
    for name, arch in SSM_ARCHS.items():
        cfg = get_config(arch).reduced()
        params = TF.init_params(cfg, device="cpu")["g0"]
        lp = TF._layer(SH.place(params, SH.param_specs(params, mesh), mesh), 0)
        x = TP.from_whole(torch.randn(4, 16, cfg.d_model, generator=g),
                          mesh.device_mesh, (Shard(0), Replicate()), "cpu")
        y, _, _ = TF._layer_seq(x, lp, cfg, "ssm" if name == "mamba2"
                                else "hybrid", True, False)
        out[f"layout_{name}"] = (tuple(y.placements) == tuple(x.placements))
    xs = TP.from_whole(torch.zeros(4, 16, 2, 4), mesh.device_mesh,
                       (Shard(0), Replicate()), "cpu")
    try:
        ssd_scan(xs, xs[..., 0].abs(), torch.full((2,), -1.0),
                 xs[:, :, 0], xs[:, :, 0])
        out["scan_refused"] = ""
    except TypeError as e:
        out["scan_refused"] = str(e)


def _vocab_parallel(mesh, out: dict) -> None:
    """The model's embedding lookup and cross-entropy chunk on a
    vocab-sharded table (values and gradients) against the same functions
    on plain tensors."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.constraints import (activation_policy,
                                                     make_mesh_policy)
    from repro_torch.models import transformer as TF

    cfg = _cfg()
    g = torch.Generator().manual_seed(5)
    V, D, B, C = cfg.padded_vocab, cfg.d_model, 4, 8
    table = torch.randn(V, D, generator=g) * 0.5
    tokens = torch.randint(0, V, (B, C), generator=g)
    x = torch.randn(B, C, D, generator=g)
    labels = torch.randint(0, V, (B, C), generator=g)
    labels[0, :3] = -1                                   # masked positions
    w = torch.randn(B, C, D, generator=g)
    dm = mesh.device_mesh
    row, bat = (Replicate(), Shard(0)), (Shard(0), Replicate())

    def run(table, tokens, x, labels, w):
        emb = TF.embed_tokens({"embed": table}, cfg, tokens)
        nll, n = TF._ce_chunk({"embed": table}, cfg, x, labels)
        return emb, (emb * w).sum() + nll, nll, n

    leaves = [t.clone().requires_grad_(True) for t in (table, x)]
    emb, total, nll, n = run(leaves[0], tokens, leaves[1], labels, w)
    total.backward()
    # the rules' vocab split, and a table they leave replicated (a vocab
    # "model" does not divide)
    for tag, layout in (("", row), ("_replicated", (Replicate(),) * 2)):
        placed = [TP.from_whole(table, dm, layout, "cpu").requires_grad_(True),
                  TP.from_whole(x, dm, bat, "cpu").requires_grad_(True)]
        with activation_policy(make_mesh_policy(mesh, ("data",))):
            emb_d, total_d, nll_d, n_d = run(
                placed[0], TP.from_whole(tokens, dm, bat, "cpu"), placed[1],
                TP.from_whole(labels, dm, bat, "cpu"),
                TP.from_whole(w, dm, bat, "cpu"))
        total_d.full_tensor().backward()
        grads = [float((d.grad.full_tensor() - p.grad).abs().max())
                 for d, p in zip(placed, leaves)]
        rows = (emb_d.full_tensor() - emb).detach()
        out[f"embed_err{tag}"] = (float(rows.abs().max()), grads[0])
        out[f"ce_err{tag}"] = (
            abs(float(nll_d.full_tensor()) - float(nll)) / float(nll),
            grads[1], int(n_d.full_tensor()), int(n))


def _heads_crossing(mesh, out: dict) -> None:
    """2 x 4 with reduced qwen2's 2 kv heads: DTensor refuses the reshape
    to heads, and ``local_heads`` gives each rank the kv heads of its own
    q heads."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed import tensor_parallel as TP

    cfg = _cfg()
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator().manual_seed(7)
    q = torch.randn(4, 8, Hq * Dh, generator=g)
    k = torch.randn(4, 8, Hkv * Dh, generator=g)
    dm, col = mesh.device_mesh, (Shard(0), Shard(2))
    kd = TP.from_whole(k, dm, col, "cpu")
    try:
        kd.reshape(4, 8, Hkv, Dh)
        out["reshape_refused"] = ""
    except RuntimeError as e:
        out["reshape_refused"] = str(e).splitlines()[0]
    ql, kl, vl, like = TP.local_heads(TP.from_whole(q, dm, col, "cpu"), kd,
                                      kd, Hq, Hkv)
    lo = TP._shard_offset(like, 2)[0] // Dh
    h = ql.shape[2]
    kv_of = (lo + torch.arange(h)) // (Hq // Hkv)   # each q head's kv head
    want_k = k.reshape(4, 8, Hkv, Dh)[:, :, kv_of]
    rows = slice(mesh.device_mesh.get_coordinate()[0] * 2,
                 mesh.device_mesh.get_coordinate()[0] * 2 + 2)
    ok = torch.equal(kl, want_k[rows]) and torch.equal(
        ql, q.reshape(4, 8, Hq, Dh)[rows, :, lo:lo + h])
    flags = torch.tensor([int(ok)])
    dist.all_reduce(flags, op=dist.ReduceOp.MIN)
    out["heads_local_ok"] = bool(flags.item())


def _launcher(mesh, out: dict, tmp: str) -> None:
    """The launcher's loop: 6 steps with a checkpoint at 4, then a resume
    from it on the same mesh; and ``main`` under these ranks."""
    import contextlib
    import io

    from repro_torch.launch import train as TRAIN

    cfg = _cfg()
    tcfg = train_config(LAUNCH_STEPS, 1e-3, microbatches=2)
    ckpt = os.path.join(tmp, "ckpt_2x2")
    _, recs = TRAIN.train_loop(cfg, LAUNCH_SHAPE, tcfg, steps=LAUNCH_STEPS,
                               ckpt_dir=ckpt, ckpt_every=LAUNCH_CKPT,
                               mesh=mesh, log=lambda s: None)
    _, again = TRAIN.train_loop(cfg, LAUNCH_SHAPE, tcfg, steps=LAUNCH_STEPS,
                                ckpt_dir=ckpt, ckpt_every=100, mesh=mesh,
                                resume_step=LAUNCH_CKPT, log=lambda s: None)
    out["launch_losses"] = [r["loss"] for r in recs]
    out["launch_gnorms"] = [r["grad_norm"] for r in recs]
    out["replay_losses"] = [r["loss"] for r in again]
    out["replay_gnorms"] = [r["grad_norm"] for r in again]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TRAIN.main(["--reduced", "--model-parallel", "2", "--steps", "2",
                    "--seq", "32", "--ckpt-dir", os.path.join(tmp, "main"),
                    "--device", "cpu"])
    out["main_stdout"] = buf.getvalue()


def _resume_1x2(mesh, out: dict, tmp: str) -> None:
    from repro_torch.launch import train as TRAIN

    cfg = _cfg()
    tcfg = train_config(LAUNCH_STEPS, 1e-3, microbatches=2)
    _, recs = TRAIN.train_loop(cfg, LAUNCH_SHAPE, tcfg, steps=LAUNCH_STEPS,
                               ckpt_dir=os.path.join(tmp, "ckpt_2x2"),
                               ckpt_every=100, mesh=mesh,
                               resume_step=LAUNCH_CKPT, log=lambda s: None)
    out["resume_1x2_losses"] = [r["loss"] for r in recs]
    out["resume_1x2_gnorms"] = [r["grad_norm"] for r in recs]
    # elastic.resume with the specs of this mesh, from a template on meta
    from repro_torch.distributed import sharding as SH
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training import elastic as EL
    from repro_torch.training.step import abstract_train_state

    ckpt = os.path.join(tmp, "ckpt_2x2")
    abstract = abstract_train_state(cfg, tcfg)
    specs = SH.state_specs(abstract, mesh, dp_axes=("data",))
    placed, step = EL.resume(abstract, ckpt, mesh, specs)
    host, _ = CKPT.restore(abstract, ckpt, device="cpu")
    out["resume_specs"] = (step, all(
        torch.equal(a, b) for a, b in zip(T.leaves(SH.gather(placed)),
                                          T.leaves(host))),
        SH.local_bytes(placed) == SH.sharded_bytes_per_device(
            abstract, specs, mesh))
    # saving it again: every rank gathers, only rank 0 copies to the host
    copies = []
    host_copy = CKPT._host
    CKPT._host = lambda leaf: copies.append(1) or host_copy(leaf)
    try:
        CKPT.save(placed, os.path.join(tmp, "ckpt_1x2"), step)
    finally:
        CKPT._host = host_copy
    dist.barrier()                                   # rank 0 has written
    again, _ = CKPT.restore(abstract, os.path.join(tmp, "ckpt_1x2"),
                            device="cpu")
    out["resave"] = (len(copies), len(T.leaves(host)), all(
        torch.equal(a, b) for a, b in zip(T.leaves(again), T.leaves(host))))


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
        out = {"mesh": (mesh.shape, mesh.axis_names, mesh.backend,
                        str(mesh.device))}
        if group == "2x2":
            _placement(mesh, out, "place_2x2")
            _vocab_parallel(mesh, out)
            _step(mesh, out, "step_2x2", _tcfg(remat=True, microbatches=2))
            # one kv head (gathered over "model"), sliding windows, post norms
            _step(mesh, out, "step_2x2_gemma3", _tcfg(remat=True),
                  arch="gemma3-1b")
            _ssd_mixer(mesh, out, "mixer_2x2", heads=4)
            _layer_layouts(mesh, out)
            for name, arch in SSM_ARCHS.items():
                _placement(mesh, out, f"place_2x2_{name}", arch)
                _step(mesh, out, f"step_2x2_{name}", _tcfg(remat=True),
                      arch=arch)
            _launcher(mesh, out, tmp)
        elif group == "2x4":
            _placement(mesh, out, "place_2x4")
            _heads_crossing(mesh, out)
            _step(mesh, out, "step_2x4", _tcfg(remat=False))
            # qk-norm: a replicated weight used on each rank's own heads
            _step(mesh, out, "step_2x4_qwen3", _tcfg(remat=False),
                  arch="qwen3-14b")
            _ssd_mixer(mesh, out, "mixer_2x4", heads=6)
            _uneven_q_heads(mesh, out)
            for name, arch in SSM_ARCHS.items():
                _placement(mesh, out, f"place_2x4_{name}", arch)
                _step(mesh, out, f"step_2x4_{name}", _tcfg(remat=False),
                      arch=arch)
        else:
            _resume_1x2(mesh, out, tmp)
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
import os, sys
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

out_dir = sys.argv[1]
at = jax.sharding.AxisType
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(at.Auto,) * 2)
tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=10),
                   remat=False)
for arch in sys.argv[2:]:
    flat = dict(np.load(os.path.join(out_dir, f"init_{arch}.npz")))
    state = {}
    for key, arr in flat.items():
        node = state
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(arr)
    cfg = get_config(arch).reduced()
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
    np.savez(os.path.join(out_dir, f"ref_{arch}.npz"),
             loss=np.float32(m["loss"]), grad_norm=np.float32(m["grad_norm"]),
             **leaves)
print("ok", flush=True)
'''


def _start_reference(tmp) -> subprocess.Popen:
    for arch in REFERENCE_ARCHS:
        state = init_train_state(get_config(arch).reduced(),
                                 _tcfg(remat=False), device="cpu")
        np.savez(os.path.join(tmp, f"init_{arch}.npz"),
                 **{"/".join(p): t.numpy() for p, t in T.items(state)})
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    return subprocess.Popen([sys.executable, "-c", REFERENCE, str(tmp),
                             *REFERENCE_ARCHS],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so the one-device steps do not
    oversubscribe the cores beside the ranks and other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Every group's results by rank, and the reference's step; the
    reference runs while the groups do.  The ranks fork from one server
    process that has imported torch and the port once (``forkserver``),
    not each a fresh interpreter."""
    mp.get_context("forkserver").set_forkserver_preload(
        ["torch", "torch.distributed.tensor", "repro_torch.launch.train",
         __name__])
    tmp = tmp_path_factory.mktemp("sharded")
    ref = _start_reference(tmp)
    try:
        res = {"2x2": _run_group(tmp, "2x2", (2, 2)),
               "2x4": _run_group(tmp, "2x4", (2, 4)),
               "1x2": _run_group(tmp, "1x2", (1, 2))}
        stdout, stderr = ref.communicate(timeout=600)
    finally:
        ref.kill()
    assert ref.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr[-3000:]}"
    res["references"] = {arch: dict(np.load(tmp / f"ref_{arch}.npz"))
                         for arch in REFERENCE_ARCHS}
    res["reference"] = res["references"][ARCH]
    res["tmp"] = tmp
    return res


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group,shape", [("2x2", (2, 2)), ("2x4", (2, 4)),
                                         ("1x2", (1, 2))])
def test_fit_mesh_over_the_group(groups, group, shape):
    """``fit_mesh`` under a process group: a ("data", "model") DeviceMesh
    of the ranks, n_data = world // model_parallel, over gloo on the
    CPU."""
    for out in groups[group]:
        mshape, names, backend, dev = out["mesh"]
        assert mshape == {"data": shape[0], "model": shape[1]}
        assert names == ("data", "model")
        assert backend == "gloo" and dev == "cpu"


PLACEMENTS = ["2x2", "2x4", *(f"{g}_{n}" for n in sorted(SSM_ARCHS)
                             for g in ("2x2", "2x4"))]


@pytest.mark.parametrize("group", PLACEMENTS)
def test_placement_holds_the_rules_bytes(groups, group):
    """Every rank's local bytes equal ``sharded_bytes_per_device`` of the
    state specs (ZeRO: m and v split over "data" too, below the bytes
    without it); for qwen2, and for reduced mamba2 and hymba."""
    for out in groups[group[:3]]:
        every, want, no_zero = out[f"place_{group}_bytes"]
        assert every == [want] * len(every)
        assert want < no_zero
        assert out[f"place_{group}_m_on_data"] > 0


@pytest.mark.parametrize("group", PLACEMENTS)
def test_placement_gathers_to_the_state_bit_for_bit(groups, group):
    assert all(out[f"place_{group}_gather_equal"]
               for out in groups[group[:3]])


def test_vocab_parallel_embedding_matches_the_plain_lookup(groups):
    """``embed_tokens`` on a table split by vocab rows over "model": rows
    bit for bit (one nonzero term a sum), the table's gradient (the
    embedding's and the tied head's) within 1e-5."""
    for out in groups["2x2"]:
        rows, grad = out["embed_err"]
        assert rows == 0.0 and grad <= 1e-5


def test_vocab_parallel_ce_matches_the_plain_chunk(groups):
    """``_ce_chunk`` on vocab-sharded logits: the nll sum (relative) and
    the gradient of its input within 1e-5 of the plain chunk's, masked
    labels included; the count exact."""
    for out in groups["2x2"]:
        nll, grad, n, want_n = out["ce_err"]
        assert nll <= 1e-5 and grad <= 1e-5
        assert n == want_n


def test_vocab_parallel_pieces_take_a_replicated_table(groups):
    """The embedding and the cross-entropy chunk on a table the rules
    leave replicated (a vocab "model" does not divide): rows bit for bit,
    the nll sum and every gradient within 1e-5 of the plain ones, the
    count exact."""
    for out in groups["2x2"]:
        rows, grad = out["embed_err_replicated"]
        nll, x_grad, n, want_n = out["ce_err_replicated"]
        assert rows == 0.0 and grad <= 1e-5
        assert nll <= 1e-5 and x_grad <= 1e-5 and n == want_n


def test_kv_heads_crossing_shards_on_2x4(groups):
    """Reduced qwen2's 2 kv heads over 4 "model" ranks: DTensor refuses
    the reshape to heads (recorded), and each rank's local q and kv heads
    are the plain ones it attends with."""
    for out in groups["2x4"]:
        assert "unflatten unevenly sharded" in out["reshape_refused"]
        assert out["heads_local_ok"]


@pytest.mark.parametrize("group,tag", [
    ("2x4", "step_2x4"), ("2x2", "step_2x2"), ("2x4", "step_2x4_qwen3"),
    ("2x2", "step_2x2_gemma3"), ("2x2", "step_2x2_mamba2"),
    ("2x4", "step_2x4_mamba2"), ("2x2", "step_2x2_hymba"),
    ("2x4", "step_2x4_hymba")])
def test_sharded_step_matches_one_process(groups, group, tag):
    """One step of a reduced config (batch 8 of 32 tokens, lr 1e-3) from
    the same state as the one-process ``make_train_step``: qwen2 on 2 x 4
    with remat off and on 2 x 2 with remat and 2 microbatches; qwen3
    (qk-norm) on 2 x 4; gemma3 (one kv head, sliding windows, post norms)
    on 2 x 2 with remat; reduced mamba2 (SSD heads split over "model")
    and hymba (meta tokens, both branches completed before their norms) on
    2 x 2 with remat and on 2 x 4 without.  Loss within 1e-3 and
    parameters within 2e-3
    (the reference's 8-devices-equal-1 tolerance; measured: the losses
    equal, parameters within 5e-5); the first moment, 0.1 x the clipped
    gradient, within 1e-4 of its largest value (measured: 1.1e-6); the
    gradient's global norm, which the clip divides out of m, within 1e-4
    relative; and the new state keeps the specs' layout.  The SSM and
    hybrid steps are held to the tightened standard: parameters within
    1e-5 and v, too, within 1e-4 of its largest value."""
    ssm = tag.rsplit("_", 1)[-1] in SSM_ARCHS
    for out in groups[group]:
        loss, ref = out[f"{tag}_loss"]
        assert abs(loss - ref) < 1e-3
        assert out[f"{tag}_params_worst"] < (1e-5 if ssm else 2e-3)
        assert out[f"{tag}_m_worst"] < 1e-4
        assert not ssm or out[f"{tag}_v_worst"] < 1e-4
        gnorm, ref_gnorm = out[f"{tag}_gnorm"]
        assert abs(gnorm - ref_gnorm) <= 1e-4 * ref_gnorm
        assert out[f"{tag}_layout_kept"]


def _against_reference(ref: dict, out: dict, tag: str,
                       m_floor: float = 0.0) -> float:
    """Holds ``out``'s step to the reference's; returns the worst
    parameter difference where |m| is below ``m_floor`` of its largest
    value (there Adam's first update divides the gradient's float noise
    by eps, and only m and v are held)."""
    assert abs(out[f"{tag}_loss"][0] - float(ref["loss"])) < 1e-3
    gnorm = out[f"{tag}_gnorm"][0]
    assert abs(gnorm - float(ref["grad_norm"])) <= 1e-4 * float(ref["grad_norm"])
    state = out[f"{tag}_state"]

    def worst(prefix: str) -> tuple[float, float]:
        keys = {k for k in ref if k.startswith(prefix)}
        assert keys and keys == {k for k in state if k.startswith(prefix)}
        diff = max(float(np.abs(state[k].float().numpy() - ref[k]).max())
                   for k in keys)
        return diff, max(float(np.abs(ref[k]).max()) for k in keys)

    m_top = worst("opt/m/")[1]
    held, under = [0.0], [0.0]
    for k in (k for k in ref if k.startswith("params/")):
        diff = np.abs(state[k].float().numpy() - ref[k])
        small = np.abs(ref["opt/m/" + k[len("params/"):]]) < m_floor * m_top
        held.append(float(diff[~small].max(initial=0.0)))
        under.append(float(diff[small].max(initial=0.0)))
    assert max(held) < 1e-5
    for moment in ("opt/m/", "opt/v/"):
        diff, top = worst(moment)
        assert top > 0 and diff < 1e-4 * top, (moment, diff, top)
    return max(under)


def test_sharded_step_matches_the_reference_sharded_step(groups):
    """The port's 2 x 4 step against the reference's ``jax.jit`` with the
    same specs on 8 host devices, from the same state and batch.  Loss
    within 1e-3 (the reference's tolerance; measured: equal).  Adam's
    first update is about lr x sign(g), so the parameters, within 1e-5
    (inside the reference's 2e-3; measured: 2.9e-6), see the gradient's
    signs only; its scale is held by the global norm (relative 1e-4;
    measured: equal) and its values, after the clip, by the moments m and
    v, each within 1e-4 of its largest value (measured: 4.8e-7, 5.6e-7)."""
    _against_reference(groups["reference"], groups["2x4"][0], "step_2x4")


@pytest.mark.parametrize("name", sorted(SSM_ARCHS))
def test_ssm_and_hybrid_steps_match_the_reference_sharded_step(groups, name):
    """Reduced mamba2 and hymba on 2 x 4 (remat off) against the
    reference's sharded ``jax.jit`` on 8 host devices, to the standard of
    the qwen2 case above: loss 1e-3, the global norm 1e-4 relative, the
    parameters 1e-5, m and v within 1e-4 of their largest value.  There
    ``in_proj`` (164 columns) stays replicated, ``conv_w`` / ``conv_b``
    split at 24 columns, off the heads' 16, and each rank scans one of the
    4 SSD heads.

    The parameters are held to 1e-5 where the first moment is at least
    1e-5 of its largest value.  Below that the gradient is under about 20
    x Adam's eps, and the first update, lr x g / (|g| + eps), turns the
    gradient's float noise into the weight: at one of hymba's ``in_proj``
    entries (g 8.9e-9 here, 7.8e-9 in the reference, the largest 0.022)
    the port's one-process step, unsharded, already lands 1.7e-5 from the
    reference, and the 2 x 4 step 2.3e-5.  Those entries are held through
    m and v, and their weights within lr."""
    under = _against_reference(groups["references"][SSM_ARCHS[name]],
                               groups["2x4"][0], f"step_2x4_{name}",
                               m_floor=1e-5)
    assert under < 1e-3


@pytest.mark.parametrize("group,tag", [
    ("2x4", "step_2x4"), ("2x2", "step_2x2"), ("2x2", "step_2x2_mamba2"),
    ("2x4", "step_2x4_hymba")])
def test_a_step_redistributes_only_scalars_implicitly(groups, group, tag):
    """Over a whole step only 0-dim tensors are redistributed implicitly:
    the optimizer's global norm adds each leaf's sum of squares, partial
    over that leaf's own mesh dims (a few scalar all-reduces a step)."""
    for out in groups[group]:
        assert out[f"{tag}_step_implicit_ndims"] in ([], [0])


@pytest.mark.parametrize("group", ["2x2", "2x4"])
@pytest.mark.parametrize("name", sorted(SSM_ARCHS))
def test_ssm_and_hybrid_layers_leave_no_implicit_redistribution(
        groups, group, name):
    """The forward and backward of reduced mamba2 and hymba on a mesh
    (``value_and_grad`` under the mesh's pins): DTensor's dispatch
    redistributes no argument by itself; every collective is one that
    ``tensor_parallel`` asks for."""
    for out in groups[group]:
        assert out[f"step_{group}_{name}_implicit"] == []


@pytest.mark.parametrize("group,heads,local", [("2x2", 4, 2), ("2x4", 6, 6)])
def test_ssd_mixer_on_dtensors_matches_the_plain_mixer(groups, group, heads,
                                                       local):
    """``ssm_seq`` on placed parameters and a batch-split x against the
    plain mixer: output and the gradients of x and of every leaf within
    1e-5 of the largest value (at least 1).  On 2 x 2 each rank scans its
    own 2 of 4 heads (the gated norm's squares summed over "model"); on
    2 x 4, 6 heads do not split over 4 ranks, so every rank scans all six
    and keeps its columns of the normed output for ``out_proj``'s rows.
    The B / C columns, the conv channels, ``A_log``, ``D`` and ``dt_bias``
    are used by every rank, so their gradients are sums over "model"."""
    for out in groups[group]:
        assert out[f"mixer_{group}_local_heads"] == local
        errs = out[f"mixer_{group}_errs"]
        assert max(errs.values()) < 1e-5, errs


def test_q_heads_crossing_shards_keep_their_own_output_columns(groups):
    """6 q heads over 4 "model" ranks (as hymba's 25 over 2): every rank
    attends with every head and hands ``wo`` only its own columns, so the
    attention's forward and backward redistribute nothing implicitly;
    output and every gradient within 1e-5 of the plain attention's."""
    for out in groups["2x4"]:
        errs, seen, split = out["uneven_q"]
        assert not split
        assert seen == []
        assert max(errs.values()) < 1e-5, errs


@pytest.mark.parametrize("name", sorted(SSM_ARCHS))
def test_ssm_and_hybrid_layers_complete_the_residual(groups, name):
    """An ``ssm`` and a ``hybrid`` layer on a ``DTensor`` x return x's
    layout: the row-sharded ``out_proj`` 's partial sum over "model" does
    not ride down the residual stream."""
    for out in groups["2x2"]:
        assert out[f"layout_{name}"]


def test_ssd_scan_refuses_a_dtensor(groups):
    """``ssd_scan`` raises on a ``DTensor`` argument instead of handing
    its storage to K7."""
    for out in groups["2x2"]:
        assert "plain tensors" in out["scan_refused"]


def test_launcher_resume_replays_bit_for_bit(groups):
    """6 steps on 2 x 2 (2 microbatches) with a checkpoint at step 4, then
    a resume from it on the same mesh: steps 4 and 5 again, bit for bit,
    the same on every rank."""
    outs = groups["2x2"]
    first = outs[0]
    assert len(first["launch_losses"]) == LAUNCH_STEPS
    assert np.isfinite(first["launch_losses"]).all()
    for out in outs:
        assert out["launch_losses"] == first["launch_losses"]
        assert out["replay_losses"] == first["launch_losses"][LAUNCH_CKPT:]
        assert out["replay_gnorms"] == first["launch_gnorms"][LAUNCH_CKPT:]


def test_checkpoint_from_2x2_restores_on_1x2(groups):
    """The 2 x 2 run's step-4 checkpoint, restored on 1 x 2, runs steps 4
    and 5 as the 2 x 2 run did (other reduction orders: 1e-5)."""
    first = groups["2x2"][0]
    for out in groups["1x2"]:
        np.testing.assert_allclose(out["resume_1x2_losses"],
                                   first["launch_losses"][LAUNCH_CKPT:],
                                   rtol=0, atol=1e-5)


def test_resume_places_a_checkpoint_by_the_specs_of_the_mesh(groups):
    """``elastic.resume(template, ckpt_dir, mesh, specs)`` on 1 x 2: the
    newest step, every rank holding its specs' bytes, gathered bit for bit
    the files' tensors."""
    for out in groups["1x2"]:
        assert out["resume_specs"] == (LAUNCH_CKPT, True, True)


def test_placed_save_copies_to_the_host_on_rank_0_only(groups):
    """Saving a placed state on 1 x 2: both ranks join every leaf's
    gather, rank 0 alone copies the leaves to the host and writes them,
    and the files hold the state bit for bit."""
    (n0, leaves, same), (n1, _, _) = (out["resave"] for out in groups["1x2"])
    assert (n0, n1) == (leaves, 0) and same


def test_ranks_sharing_a_card_are_refused(monkeypatch):
    """More ranks on a node than CUDA cards: ``init_process_group`` raises
    with the way out before it joins a group (NCCL refuses two ranks on a
    card; gloo's DTensor all-gather of CUDA tensors crashes)."""
    from repro_torch.training import elastic as EL

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for name, value in (("RANK", "1"), ("WORLD_SIZE", "4"),
                        ("LOCAL_RANK", "1"), ("LOCAL_WORLD_SIZE", "4")):
        monkeypatch.setenv(name, value)
    with pytest.raises(RuntimeError, match="share a card are not supported"):
        EL.init_process_group()
    assert not dist.is_initialized()


def test_checkpoint_from_2x2_restores_on_one_device(groups):
    """The one-device launcher loop reads the 2 x 2 checkpoint (the files
    and manifest of a one-device save) and runs steps 4 and 5 as the 2 x 2
    run did, within 1e-5."""
    from repro_torch.launch.train import train_loop
    from repro_torch.training import checkpoint as CKPT

    ckpt = str(groups["tmp"] / "ckpt_2x2")
    assert CKPT.latest_steps(ckpt) == [LAUNCH_CKPT]
    cfg = _cfg()
    tcfg = train_config(LAUNCH_STEPS, 1e-3, microbatches=2)
    _, recs = train_loop(cfg, LAUNCH_SHAPE, tcfg, steps=LAUNCH_STEPS,
                         ckpt_dir=ckpt, ckpt_every=100, device="cpu",
                         resume_step=LAUNCH_CKPT, log=lambda s: None)
    np.testing.assert_allclose([r["loss"] for r in recs],
                               groups["2x2"][0]["launch_losses"][LAUNCH_CKPT:],
                               rtol=0, atol=1e-5)


def test_launcher_main_under_four_ranks(groups):
    """``main`` with ``--model-parallel 2`` under four ranks: rank 0 logs
    the mesh line (mesh, backend, every rank's device) and the steps; the
    other ranks print nothing."""
    outs = groups["2x2"]
    text = outs[0]["main_stdout"]
    assert "mesh: {'data': 2, 'model': 2}" in text
    assert "backend: gloo" in text
    assert "devices: ['cpu', 'cpu', 'cpu', 'cpu']" in text
    assert "step     1 loss" in text and "done at step 2" in text
    assert all(out["main_stdout"] == "" for out in outs[1:])


def test_model_parallel_without_torchrun_is_a_usage_error(monkeypatch):
    """Without the torchrun environment, ``--model-parallel`` above 1 (or
    ``--distributed``) exits with the command that launches it."""
    from repro_torch.launch import train as TRAIN

    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    for argv in (["--model-parallel", "2"], ["--distributed"]):
        with pytest.raises(SystemExit, match="torch.distributed.run"):
            TRAIN.main([*argv, "--reduced", "--device", "cpu"])


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_sharded_step_admits_every_family(arch, tmp_path, monkeypatch):
    """``main``'s sharded path (``--model-parallel 1`` under a one-rank
    gloo group) trains every registered config, reduced: no family is
    refused; rank 0 logs the mesh line and the step."""
    import contextlib
    import io

    from repro_torch.launch import train as TRAIN

    for name, value in (("RANK", "0"), ("WORLD_SIZE", "1"),
                        ("LOCAL_RANK", "0"), ("LOCAL_WORLD_SIZE", "1")):
        monkeypatch.setenv(name, value)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            TRAIN.main(["--arch", arch, "--reduced", "--model-parallel", "1",
                        "--steps", "1", "--seq", "32", "--batch", "2",
                        "--ckpt-dir", str(tmp_path / "ckpt"),
                        "--device", "cpu"])
    finally:
        dist.destroy_process_group()
    text = buf.getvalue()
    assert f"mesh: {{'data': 1, 'model': 1}} | arch: {arch}" in text
    loss = float(text.split("step     0 loss ")[1].split()[0])
    assert np.isfinite(loss) and "done at step 1" in text
