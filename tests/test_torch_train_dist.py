"""The port's data-parallel step with the int8-compressed gradient sum, in
both forms, against the reference's ``shard_map`` step on 8 devices and
against each other.

The reference needs its 8-device mesh, so one subprocess (8 forced host
devices, the ``enable_x64`` shim set in its own code) runs (a) its
``compressed_psum`` under ``shard_map`` on seeded per-rank gradients and
error buffers, with each rank's ``quantize_int8`` of its corrected
gradient, and (b) the 8 steps of ``tests/test_dist.py``'s
``test_compressed_dp_train_step`` (reduced qwen2, batch 16 of 32 tokens,
AdamW with error feedback), and writes them as ``.npz``.

The single controller stacks the 8 ranks along a leading axis on the CPU.
The ranked step runs over a process group: CPU processes on gloo, spawned
from a fork server (one intra-op thread each) as in
``test_torch_train_sharded.py``, an 8-rank group on ("data",) and a 2 x 2
("data", "model") group.  Both forms must give the reference's ``q``,
scale, new error and mean bit for bit, and its loss trajectory within
1e-4 from its initial state; the ranked step must equal the single
controller bit for bit after every step (parameters, moments, every
rank's error buffer, metrics), and every rank must hold the same replica.
"""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch.train import device_batch
from repro_torch.training import tree as T
from repro_torch.training.grad_compression import (compressed_psum,
                                                   quantize_int8)
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.step import (TrainConfig, init_dp_error_feedback,
                                       init_placed_train_state,
                                       make_dp_train_step)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
SHAPES = {"w": (16, 24), "b": (24,), "s": (3, 5, 7)}
STEP_SHAPE = ShapeSpec("tiny", 32, 16, "train")
STEPS = 8
METRICS = ("loss", "ce", "grad_norm", "lr", "tokens")
# the ranked sum's buckets (``grad_compression.BUCKET_BYTES`` in the
# ranks), in int8 bytes a rank: (a) 97 (the 513 elements of SHAPES in 6
# buckets, every leaf across a boundary); (c) 4,099 (reduced qwen2's
# 181,312 parameters in 45); (b) the default (one)
PSUM_BUCKET, SMALL_BUCKET = 97, 4099
# the 2 x 2 group's cases: (DP axes, n_dp, the batch placed as DTensors
# split over the DP axes, or the whole batch on every rank)
GRID_CASES = {"data": (("data",), 2, True),
              "data_model": (("data", "model"), 4, False)}
GRID_STEPS = 2

REFERENCE = r'''
import os, sys
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.core.dist_store import shard_map_compat
from repro.data.pipeline import make_batch, DataConfig
from repro.training.grad_compression import compressed_psum, quantize_int8
from repro.training.optimizer import OptConfig
from repro.training.step import (TrainConfig, make_dp_train_step,
                                 init_train_state, init_dp_error_feedback)

out_dir = sys.argv[1]
at = getattr(jax.sharding, "AxisType", None)
mesh = jax.make_mesh((8,), ("data",), axis_types=(at.Auto,))

# (a) compressed_psum on seeded per-rank gradients and error buffers
rng = np.random.default_rng(11)
SHAPES = {"w": (16, 24), "b": (24,), "s": (3, 5, 7)}
g = {k: (rng.normal(size=(8,) + s) * 10.0 ** rng.integers(-3, 1, (8,) + (1,) * len(s))
         ).astype(np.float32) for k, s in SHAPES.items()}
e = {k: (rng.normal(size=(8,) + s) * 1e-2).astype(np.float32) for k, s in SHAPES.items()}
e_bf = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), e)

def local(gl, el):
    mean, new_e = compressed_psum(jax.tree.map(lambda x: x[0], gl),
                                  jax.tree.map(lambda x: x[0], el), ("data",))
    return mean, jax.tree.map(lambda x: x[None], new_e)

fn = jax.jit(shard_map_compat(local, mesh, (P("data"), P("data")), (P(), P("data"))))
mean, new_e = fn(jax.tree.map(jnp.asarray, g), e_bf)
arrs = {}
for k in SHAPES:
    arrs["g_" + k] = g[k]
    arrs["e_" + k] = np.asarray(e_bf[k].astype(jnp.float32))
    arrs["mean_" + k] = np.asarray(mean[k])
    arrs["newe_" + k] = np.asarray(new_e[k].astype(jnp.float32))
    qs = [jax.jit(quantize_int8)(jnp.asarray(g[k][r]) + e_bf[k][r].astype(jnp.float32))
          for r in range(8)]
    arrs["q_" + k] = np.stack([np.asarray(q) for q, _ in qs])
    arrs["scale_" + k] = np.array([float(s) for _, s in qs], np.float32)
np.savez(os.path.join(out_dir, "psum.npz"), **arrs)

# (b) the 8 steps of test_compressed_dp_train_step
cfg = get_config("qwen2-1.5b").reduced()
tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=40),
                   remat=False, grad_compression=True, dp_axes=("data",))
state = init_train_state(cfg, tcfg, jax.random.PRNGKey(0))
state.pop("err")
flat = {"/".join(p.key for p in path): np.asarray(a) for path, a in
        jax.tree_util.tree_flatten_with_path(state)[0]}
err = init_dp_error_feedback(cfg, state["params"], 8)
shape = ShapeSpec("tiny", 32, 16, "train")
batch0 = {k: jnp.asarray(v) for k, v in make_batch(cfg, shape, 0, DataConfig("copy")).items()}
step = make_dp_train_step(cfg, tcfg, mesh, batch0)
metrics = []
for i in range(8):
    b = {k: jnp.asarray(v) for k, v in make_batch(cfg, shape, i, DataConfig("copy")).items()}
    state, err, m = step(state, err, b)
    metrics.append([float(m[k]) for k in ("loss", "ce", "grad_norm", "lr", "tokens")])
np.savez(os.path.join(out_dir, "train.npz"), metrics=np.array(metrics),
         **{"init/" + k: v for k, v in flat.items()})
print("ok", flush=True)
'''


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so the ranks' steps do not
    oversubscribe the cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return get_config("qwen2-1.5b").reduced()


def _tcfg() -> TrainConfig:
    return TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=40),
                       remat=False, grad_compression=True)


def _ref_state(train: dict, device="cpu") -> dict:
    """The reference's initial train state (``init/`` leaves) as the
    port's."""
    params = {}
    for key, a in train.items():
        if key.startswith("init/"):
            node = params
            *path, leaf = key[len("init/"):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = a
    return convert.train_state_from_numpy(params, device)


def _batch(i: int) -> dict:
    return make_batch(_cfg(), STEP_SHAPE, i, DataConfig("copy"))


def _digest(tree: dict) -> str:
    """The exact bytes of every leaf, hashed (a bit-for-bit check)."""
    h = hashlib.sha256()
    for path, t in T.items(tree):
        h.update("/".join(path).encode())
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def _record(state: dict, errs: list, m: dict) -> dict:
    """One step's record: the state's digest, each rank's error buffer's,
    the metrics."""
    return {"state": _digest(state), "err": [_digest(e) for e in errs],
            "metrics": {k: v.clone() for k, v in m.items()}}


def _single_run(state: dict, n_dp: int, steps: int) -> dict:
    """The single-controller step from ``state`` for ``steps`` steps."""
    cfg, tcfg = _cfg(), _tcfg()
    err = init_dp_error_feedback(cfg, state["params"], n_dp)
    step = make_dp_train_step(cfg, tcfg, n_dp)
    recs = []
    for i in range(steps):
        state, err, m = step(state, err, device_batch(_batch(i), "cpu"))
        recs.append(_record(state, [T.tree_map(lambda e: e[r:r + 1], err)
                                    for r in range(n_dp)], m))
    return {"steps": recs, "state": state, "err": err}


# ---------------------------------------------------------------------------
# the ranks (spawned children)
# ---------------------------------------------------------------------------


def _rank_psum(mesh, out: dict, ref_dir: str) -> None:
    """(a): this rank's seeded gradient and error buffer through
    ``quantize_payload`` and ``gather_mean`` in buckets of PSUM_BUCKET
    bytes."""
    from repro_torch.training import grad_compression as GC
    from repro_torch.training.step import dp_group

    group, n, r = dp_group(mesh)
    ref = np.load(os.path.join(ref_dir, "psum.npz"))
    g = {k: torch.tensor(ref["g_" + k][r]) for k in SHAPES}
    e = {k: torch.tensor(ref["e_" + k][r]).to(torch.bfloat16) for k in SHAPES}
    payload, new_e = GC.quantize_payload(g, e)
    GC.BUCKET_BYTES = PSUM_BUCKET
    mean = GC.gather_mean(payload, group)
    q = {p[0]: payload.q[lo:lo + g[p[0]].numel()].view(g[p[0]].shape)
         for p, lo in zip(payload.paths, payload.offsets)}
    scales = {p[0]: payload.scales[i] for i, p in enumerate(payload.paths)}
    out["psum"] = {"rank": r, "q": q, "scale": scales, "new_e": new_e,
                   "mean": mean}


def _rank_steps(mesh, out: dict, tag: str, ref_dir: str, dp_axes: tuple,
                steps: int, placed: bool) -> None:
    """The ranked step from the reference's initial state: each step's
    record (:func:`_record`, this rank's error buffer), the whole error
    buffers after the last, and rank 0's state."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.training.step import (dp_group,
                                           init_placed_dp_error_feedback)

    cfg, tcfg = _cfg(), _tcfg()
    state = _ref_state(dict(np.load(os.path.join(ref_dir, "train.npz"))))
    step = make_dp_train_step(cfg, tcfg, mesh, dp_axes)
    err = init_placed_dp_error_feedback(cfg, state["params"], mesh, dp_axes)
    recs = []
    for i in range(steps):
        batch = device_batch(_batch(i), "cpu")
        if placed:
            batch = SH.place(batch, SH.batch_specs(batch, dp_axes), mesh)
        state, err, m = step(state, err, batch)
        recs.append(_record(state, [T.tree_map(lambda e: e.to_local(),
                                               err)], m))
    rec = {"steps": recs, "dp_rank": dp_group(mesh, dp_axes)[2],
           "placed": all(TP.is_dtensor(b) for b in batch.values()),
           "err_whole": T.tree_map(TP.whole, err)}   # every rank gathers
    if mesh.rank == 0:
        rec["state"] = state
    out[tag] = rec


def _rank(rank: int, world: int, shape: tuple, tmp: str, ref_dir: str,
          group: str):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    from repro_torch.training import elastic as EL

    dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{group}",
                            rank=rank, world_size=world)
    try:
        mesh = EL.fit_mesh(model_parallel=shape[1], device="cpu")
        out = {}
        if group == "8":
            _rank_steps(mesh, out, "steps", ref_dir, ("data",), STEPS,
                        placed=True)
            _rank_psum(mesh, out, ref_dir)
        else:
            from repro_torch.training import grad_compression as GC

            GC.BUCKET_BYTES = SMALL_BUCKET
            for case, (axes, _, placed) in GRID_CASES.items():
                _rank_steps(mesh, out, case, ref_dir, axes, GRID_STEPS,
                            placed=placed)
        torch.save(out, os.path.join(tmp, f"{group}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_dp")
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", REFERENCE, str(out)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    loaded = {name: dict(np.load(out / f"{name}.npz"))
              for name in ("psum", "train")}
    loaded["dir"] = str(out)
    return loaded


@pytest.fixture(scope="module")
def single(reference):
    """The single-controller step's 8 steps from the reference's initial
    state."""
    state = _ref_state(reference["train"])
    return _single_run(state, 8, STEPS)


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """The two groups' records by rank, and the single controller's runs
    of the 2 x 2 cases (made while the groups run).  The ranks fork from
    one server process that has imported torch and the port once."""
    mp.get_context("forkserver").set_forkserver_preload(
        ["torch", "torch.distributed.tensor", "repro_torch.launch.train",
         __name__])
    tmp = str(tmp_path_factory.mktemp("ranked_dp"))
    groups = {"8": (8, 1), "2x2": (2, 2)}
    started = {g: mp.start_processes(
        _rank, args=(sh[0] * sh[1], sh, tmp, reference["dir"], g),
        nprocs=sh[0] * sh[1], join=False, start_method="forkserver")
        for g, sh in groups.items()}
    state = _ref_state(reference["train"])
    grid = {case: _single_run(state, n_dp, GRID_STEPS)
            for case, (_, n_dp, _) in GRID_CASES.items()}
    for ctx in started.values():
        while not ctx.join():
            pass
    res = {g: [torch.load(os.path.join(tmp, f"{g}_rank{r}.pt"),
                          weights_only=False) for r in range(sh[0] * sh[1])]
           for g, sh in groups.items()}
    res["grid_single"] = grid
    return res


def _same_as_single(recs: list, want: dict, tag: str) -> None:
    """Every rank's record of ``tag`` against the single controller's run:
    each step's state and metrics bit for bit, each rank's error buffer
    bit for bit with the single controller's slice of its DP rank; rank
    0's final state leaf for leaf."""
    for rec in recs:
        got = rec[tag]
        r = got["dp_rank"]
        assert len(got["steps"]) == len(want["steps"])
        for i, (a, b) in enumerate(zip(got["steps"], want["steps"])):
            assert a["state"] == b["state"], (tag, r, i)
            assert a["err"] == [b["err"][r]], (tag, r, i)
            assert a["metrics"].keys() == b["metrics"].keys()
            for k, v in b["metrics"].items():
                assert a["metrics"][k].dtype == v.dtype, (tag, k)
                assert torch.equal(a["metrics"][k], v), (tag, r, i, k)
    for (pa, a), (pb, b) in zip(T.items(recs[0][tag]["state"]),
                                T.items(want["state"])):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def test_compressed_psum_matches_reference_bit_for_bit(reference):
    """On identical per-rank gradients and bf16 error buffers: each rank's
    q and scale, the new error and the ranks' mean, bit for bit."""
    ref = reference["psum"]
    g = {k: torch.tensor(ref["g_" + k]) for k in SHAPES}
    e = {k: torch.tensor(ref["e_" + k]).to(torch.bfloat16) for k in SHAPES}
    mean, new_e = compressed_psum(g, e)
    for k in SHAPES:
        for r in range(8):
            q, scale = quantize_int8(g[k][r] + e[k][r].float())
            assert np.array_equal(q.numpy(), ref["q_" + k][r]), (k, r)
            assert float(scale) == float(ref["scale_" + k][r]), (k, r)
        assert new_e[k].dtype == torch.bfloat16
        assert np.array_equal(new_e[k].float().numpy(), ref["newe_" + k]), k
        assert np.array_equal(mean[k].numpy(), ref["mean_" + k]), k


def test_dp_train_step_matches_reference(reference, single):
    """The 8 steps of ``test_compressed_dp_train_step`` from the
    reference's initial state: loss and ce within 1e-4, the grad norm
    within 1e-3 relative, the learning rate and the token count equal;
    the loss falls."""
    assert all(e.shape[0] == 8 for e in T.leaves(single["err"]))
    got = np.array([[float(rec["metrics"][k]) for k in METRICS]
                    for rec in single["steps"]])
    _against_reference(got, reference["train"]["metrics"])


def _against_reference(got: np.ndarray, want: np.ndarray) -> None:
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=1e-4)
    # the norm of the int8-decoded mean: an element within float noise of a
    # rounding boundary moves by a whole step (scale / 8 in the mean)
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-3)
    assert np.array_equal(got[:, 3:], want[:, 3:])
    assert got[-1, 0] < got[0, 0]


def test_ranked_compressed_sum_matches_reference_bit_for_bit(reference,
                                                             ranks):
    """(a) Over the 8-rank group, each rank quantizing its own seeded
    gradient and error buffer and the int8 payload gathered in buckets
    that split every leaf: each rank's q, scale and new error, and the
    mean on every rank, bit for bit with the reference's ``shard_map``
    ``compressed_psum``."""
    ref = reference["psum"]
    assert sorted(rec["psum"]["rank"] for rec in ranks["8"]) == list(range(8))
    for rec in ranks["8"]:
        got, r = rec["psum"], rec["psum"]["rank"]
        for k in SHAPES:
            assert got["q"][k].dtype == torch.int8
            assert np.array_equal(got["q"][k].numpy(), ref["q_" + k][r]), k
            assert got["scale"][k].dtype == torch.float32
            assert float(got["scale"][k]) == float(ref["scale_" + k][r]), k
            assert got["new_e"][k].dtype == torch.bfloat16
            assert np.array_equal(got["new_e"][k].float().numpy(),
                                  ref["newe_" + k][r]), (k, r)
            assert np.array_equal(got["mean"][k].numpy(), ref["mean_" + k])


def test_ranked_dp_step_matches_reference(reference, ranks):
    """(b) The ranked step over the 8-rank group, the reference's 8 steps
    from its initial state: the reference's tolerances, on every rank."""
    for rec in ranks["8"]:
        got = np.array([[float(s["metrics"][k]) for k in METRICS]
                        for s in rec["steps"]["steps"]])
        _against_reference(got, reference["train"]["metrics"])


def test_ranked_dp_step_equals_the_single_controller(single, ranks):
    """(b) Over the 8-rank group, after every step: the state (parameters,
    m, v, the step count) and the metrics bit for bit with the single
    controller's, each rank's error buffer with its slice of the single
    controller's, and the placed buffers gathered whole equal to them."""
    recs = ranks["8"]
    assert all(rec["steps"]["placed"] for rec in recs)
    assert sorted(rec["steps"]["dp_rank"] for rec in recs) == list(range(8))
    _same_as_single(recs, single, "steps")
    for rec in recs:
        for (pa, a), (pb, b) in zip(T.items(rec["steps"]["err_whole"]),
                                    T.items(single["err"])):
            assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_ranked_dp_step_on_2x2_equals_the_single_controller(ranks, case):
    """(c) A 2 x 2 ("data", "model") group, 2 steps, every leaf split in
    buckets: over "data" (n_dp 2; the batch placed as DTensors split over
    "data", the model ranks of a data row computing the same), and over
    both axes flattened, data major (n_dp 4; the whole batch on every
    rank), bit for bit with the single controller at that n_dp; the
    error buffers (DTensors split over the DP axes) gathered whole equal
    to the single controller's."""
    recs = ranks["2x2"]
    axes, n_dp, placed = GRID_CASES[case]
    assert all(rec[case]["placed"] == placed for rec in recs)
    want_ranks = [r // 2 for r in range(4)] if n_dp == 2 else list(range(4))
    assert [rec[case]["dp_rank"] for rec in recs] == want_ranks
    want = ranks["grid_single"][case]
    _same_as_single(recs, want, case)
    for rec in recs:
        for (pa, a), (pb, b) in zip(T.items(rec[case]["err_whole"]),
                                    T.items(want["err"])):
            assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa


@pytest.mark.parametrize("group", ["8", "2x2"])
def test_ranked_replicas_stay_equal(ranks, group):
    """Every rank applies the same mean to the same replica: after every
    step the ranks' states are the same bytes."""
    recs = ranks[group]
    for tag in (["steps"] if group == "8" else list(GRID_CASES)):
        for i in range(len(recs[0][tag]["steps"])):
            assert len({rec[tag]["steps"][i]["state"] for rec in recs}) == 1, \
                (tag, i)


def test_placed_state_refuses_compression():
    """``init_placed_train_state`` has no compressed step: it refuses
    ``grad_compression`` and names the ranked ``make_dp_train_step``."""
    with pytest.raises(NotImplementedError,
                       match=r"make_dp_train_step\(cfg, tcfg, mesh\)") as e:
        init_placed_train_state(_cfg(), _tcfg(), mesh=None, specs={})
    assert "16d" not in str(e.value)
