"""The sharded train step over a process group: the state placed as
``DTensor``s by ``distributed.sharding``, the model's vocab-parallel
embedding and cross-entropy, the 2 x 4 and 2 x 2 steps against the
one-process ``make_train_step`` and the reference's sharded ``jax.jit``,
and the launcher's checkpoints across meshes.

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

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch.train import device_batch, train_config
from repro_torch.training import tree as T
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.step import (TrainConfig, init_train_state,
                                       make_train_step)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
ARCH = "qwen2-1.5b"
# the inputs of the reference's tests/test_dist.py 8-devices-equal-1 test
STEP_SHAPE = ShapeSpec("tiny", 32, 8, "train")
LAUNCH_SHAPE = ShapeSpec("launch", 32, 8, "train")
LAUNCH_STEPS, LAUNCH_CKPT = 6, 4


def _cfg():
    return get_config(ARCH).reduced()


def _tcfg(**kw) -> TrainConfig:
    return TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=10),
                       **kw)


def _worst(a: dict, b: dict) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(T.leaves(a), T.leaves(b)))


# ---------------------------------------------------------------------------
# the ranks (spawned children)
# ---------------------------------------------------------------------------


def _placement(mesh, out: dict, tag: str) -> None:
    """Every rank's local bytes against the rules', and the gathered
    state against the one-process init, bit for bit."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.train import placed_state
    from repro_torch.training.step import abstract_train_state

    cfg, tcfg = _cfg(), _tcfg()
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
    with activation_policy(make_mesh_policy(mesh, dp_axes(mesh))):
        new, m = make_train_step(cfg, tcfg)(state, mesh_batch(b, mesh))
    placements = {p: tuple(t.placements) for p, t in T.items(new)}
    want = {p: SH.to_placements(s, mesh) for p, s in T.items(specs)}
    whole = SH.gather(new)
    ref = init_train_state(cfg, tcfg, device="cpu")
    ref_new, ref_m = make_train_step(cfg, tcfg)(ref, device_batch(b, "cpu"))
    m_max = max(float(t.abs().max()) for t in T.leaves(ref_new["opt"]["m"]))
    out[f"{tag}_loss"] = (float(m["loss"].full_tensor()), float(ref_m["loss"]))
    out[f"{tag}_gnorm"] = (float(TP.whole(m["grad_norm"])),
                           float(ref_m["grad_norm"]))
    out[f"{tag}_params_worst"] = _worst(whole["params"], ref_new["params"])
    out[f"{tag}_m_worst"] = _worst(whole["opt"]["m"],
                                   ref_new["opt"]["m"]) / m_max
    out[f"{tag}_layout_kept"] = placements == want
    if tag == "step_2x4":
        out["step_2x4_state"] = {"/".join(p): t for p, t in T.items(whole)}


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
    placed = [TP.from_whole(table, dm, row, "cpu").requires_grad_(True),
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
    out["embed_err"] = (float(rows.abs().max()), grads[0])
    out["ce_err"] = (abs(float(nll_d.full_tensor()) - float(nll)) / float(nll),
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
            _launcher(mesh, out, tmp)
        elif group == "2x4":
            _placement(mesh, out, "place_2x4")
            _heads_crossing(mesh, out)
            _step(mesh, out, "step_2x4", _tcfg(remat=False))
            # qk-norm: a replicated weight used on each rank's own heads
            _step(mesh, out, "step_2x4_qwen3", _tcfg(remat=False),
                  arch="qwen3-14b")
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
flat = dict(np.load(os.path.join(out_dir, "init.npz")))
state = {}
for key, arr in flat.items():
    node = state
    *head, last = key.split("/")
    for k in head:
        node = node.setdefault(k, {})
    node[last] = jnp.asarray(arr)
cfg = get_config("qwen2-1.5b").reduced()
tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=10),
                   remat=False)
batch = {k: jnp.asarray(v) for k, v in make_batch(
    cfg, ShapeSpec("tiny", 32, 8, "train"), 0, DataConfig("copy")).items()}
at = jax.sharding.AxisType
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(at.Auto,) * 2)
ssp = SH.state_specs(jax.eval_shape(lambda: state), mesh, dp_axes=("data",))
bsp = SH.batch_specs(jax.eval_shape(lambda: batch), ("data",))
step = jax.jit(make_train_step(cfg, tcfg),
               in_shardings=(SH.to_named(ssp, mesh), SH.to_named(bsp, mesh)))
new, m = step(state, batch)
leaves = {"/".join(p.key for p in path): np.asarray(a, np.float32) for path, a
          in jax.tree_util.tree_flatten_with_path(new)[0]}
np.savez(os.path.join(out_dir, "ref.npz"), loss=np.float32(m["loss"]),
         grad_norm=np.float32(m["grad_norm"]), **leaves)
print("ok", flush=True)
'''


def _start_reference(tmp) -> subprocess.Popen:
    cfg = _cfg()
    state = init_train_state(cfg, _tcfg(remat=False), device="cpu")
    np.savez(os.path.join(tmp, "init.npz"),
             **{"/".join(p): t.numpy() for p, t in T.items(state)})
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    return subprocess.Popen([sys.executable, "-c", REFERENCE, str(tmp)],
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
    res["reference"] = dict(np.load(tmp / "ref.npz"))
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


@pytest.mark.parametrize("group", ["2x2", "2x4"])
def test_placement_holds_the_rules_bytes(groups, group):
    """Every rank's local bytes equal ``sharded_bytes_per_device`` of the
    state specs (ZeRO: m and v split over "data" too, below the bytes
    without it)."""
    for out in groups[group]:
        every, want, no_zero = out[f"place_{group}_bytes"]
        assert every == [want] * len(every)
        assert want < no_zero
        assert out[f"place_{group}_m_on_data"] > 0


@pytest.mark.parametrize("group", ["2x2", "2x4"])
def test_placement_gathers_to_the_state_bit_for_bit(groups, group):
    assert all(out[f"place_{group}_gather_equal"] for out in groups[group])


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


def test_kv_heads_crossing_shards_on_2x4(groups):
    """Reduced qwen2's 2 kv heads over 4 "model" ranks: DTensor refuses
    the reshape to heads (recorded), and each rank's local q and kv heads
    are the plain ones it attends with."""
    for out in groups["2x4"]:
        assert "unflatten unevenly sharded" in out["reshape_refused"]
        assert out["heads_local_ok"]


@pytest.mark.parametrize("group,tag", [
    ("2x4", "step_2x4"), ("2x2", "step_2x2"), ("2x4", "step_2x4_qwen3"),
    ("2x2", "step_2x2_gemma3")])
def test_sharded_step_matches_one_process(groups, group, tag):
    """One step of a reduced config (batch 8 of 32 tokens, lr 1e-3) from
    the same state as the one-process ``make_train_step``: qwen2 on 2 x 4
    with remat off and on 2 x 2 with remat and 2 microbatches; qwen3
    (qk-norm) on 2 x 4; gemma3 (one kv head, sliding windows, post norms)
    on 2 x 2 with remat.  Loss within 1e-3 and parameters within 2e-3
    (the reference's 8-devices-equal-1 tolerance; measured: the losses
    equal, parameters within 5e-5); the first moment, 0.1 x the clipped
    gradient, within 1e-4 of its largest value (measured: 1.1e-6); the
    gradient's global norm, which the clip divides out of m, within 1e-4
    relative; and the new state keeps the specs' layout."""
    for out in groups[group]:
        loss, ref = out[f"{tag}_loss"]
        assert abs(loss - ref) < 1e-3
        assert out[f"{tag}_params_worst"] < 2e-3
        assert out[f"{tag}_m_worst"] < 1e-4
        gnorm, ref_gnorm = out[f"{tag}_gnorm"]
        assert abs(gnorm - ref_gnorm) <= 1e-4 * ref_gnorm
        assert out[f"{tag}_layout_kept"]


def test_sharded_step_matches_the_reference_sharded_step(groups):
    """The port's 2 x 4 step against the reference's ``jax.jit`` with the
    same specs on 8 host devices, from the same state and batch.  Loss
    within 1e-3 (the reference's tolerance; measured: equal).  Adam's
    first update is about lr x sign(g), so the parameters, within 1e-5
    (inside the reference's 2e-3; measured: 2.9e-6), see the gradient's
    signs only; its scale is held by the global norm (relative 1e-4;
    measured: equal) and its values, after the clip, by the moments m and
    v, each within 1e-4 of its largest value (measured: 4.8e-7, 5.6e-7)."""
    ref = groups["reference"]
    out = groups["2x4"][0]
    assert abs(out["step_2x4_loss"][0] - float(ref["loss"])) < 1e-3
    gnorm = out["step_2x4_gnorm"][0]
    assert abs(gnorm - float(ref["grad_norm"])) <= 1e-4 * float(ref["grad_norm"])
    state = out["step_2x4_state"]

    def worst(prefix: str) -> tuple[float, float]:
        keys = {k for k in ref if k.startswith(prefix)}
        assert keys and keys == {k for k in state if k.startswith(prefix)}
        diff = max(float(np.abs(state[k].float().numpy() - ref[k]).max())
                   for k in keys)
        return diff, max(float(np.abs(ref[k]).max()) for k in keys)

    assert worst("params/")[0] < 1e-5
    for moment in ("opt/m/", "opt/v/"):
        diff, top = worst(moment)
        assert top > 0 and diff < 1e-4 * top, (moment, diff, top)


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


@pytest.mark.parametrize("arch", ["mamba2-370m", "deepseek-moe-16b",
                                  "minicpm3-4b"])
def test_sharded_step_names_the_families_it_waits_for(arch):
    from repro_torch.launch.train import sharded_families_check

    with pytest.raises(NotImplementedError, match="16c\\(b\\)"):
        sharded_families_check(get_config(arch).reduced())
    sharded_families_check(get_config("qwen3-14b").reduced())
