"""The port's single-controller data-parallel step with the int8-compressed
gradient sum against the reference's ``shard_map`` step on 8 devices.

The reference needs its 8-device mesh, so one subprocess (8 forced host
devices, the ``enable_x64`` shim set in its own code) runs (a) its
``compressed_psum`` under ``shard_map`` on seeded per-rank gradients and
error buffers, with each rank's ``quantize_int8`` of its corrected
gradient, and (b) the 8 steps of ``tests/test_dist.py``'s
``test_compressed_dp_train_step`` (reduced qwen2, batch 16 of 32 tokens,
AdamW with error feedback), and writes them as ``.npz``.  The port stacks
the 8 ranks along a leading axis on the CPU and must give the same
``q``, scale, new error and mean bit for bit, and the same loss
trajectory within 1e-4 from the same initial state."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch.train import device_batch
from repro_torch.training import tree as T
from repro_torch.training.grad_compression import (compressed_psum,
                                                   quantize_int8)
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.step import (TrainConfig, init_dp_error_feedback,
                                       make_dp_train_step)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
SHAPES = {"w": (16, 24), "b": (24,), "s": (3, 5, 7)}

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


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_dp")
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", REFERENCE, str(out)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return {name: dict(np.load(out / f"{name}.npz"))
            for name in ("psum", "train")}


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


def test_dp_train_step_matches_reference(reference):
    """The 8 steps of ``test_compressed_dp_train_step`` from the
    reference's initial state: loss and ce within 1e-4, the grad norm
    within 1e-3 relative, the learning rate and the token count equal;
    the loss falls."""
    ref = reference["train"]
    params = {}
    for key, a in ref.items():
        if key.startswith("init/"):
            node = params
            *path, leaf = key[len("init/"):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = a
    state = convert.train_state_from_numpy(params, "cpu")
    cfg = get_config("qwen2-1.5b").reduced()
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=40),
                       remat=False, grad_compression=True)
    err = init_dp_error_feedback(cfg, state["params"], 8)
    assert all(e.shape[0] == 8 for e in T.leaves(err))
    shape = ShapeSpec("tiny", 32, 16, "train")
    step = make_dp_train_step(cfg, tcfg, 8)
    got = []
    for i in range(8):
        b = device_batch(make_batch(cfg, shape, i, DataConfig("copy")), "cpu")
        state, err, m = step(state, err, b)
        got.append([float(m[k]) for k in ("loss", "ce", "grad_norm", "lr",
                                          "tokens")])
    got, want = np.array(got), ref["metrics"]
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=1e-4)
    # the norm of the int8-decoded mean: an element within float noise of a
    # rounding boundary moves by a whole step (scale / 8 in the mean)
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-3)
    assert np.array_equal(got[:, 3:], want[:, 3:])
    assert got[-1, 0] < got[0, 0]
