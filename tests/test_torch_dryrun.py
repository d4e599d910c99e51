"""The dry-run (``repro_torch.launch.dryrun``) on the CPU.

* ``pick_microbatches`` is the reference's arithmetic for every config,
  shape and DP width.
* Per-device argument bytes on a 2x4 mesh against the reference's
  ``memory_analysis().argument_size_in_bytes``: one subprocess (8 forced
  host devices, the ``enable_x64`` shim in its own code) lowers reduced
  qwen2's train step in ``tests/test_dist.py``'s 2x4 configuration (remat,
  two microbatches, B 8 of 64 tokens, ZeRO), its prefill and its decode
  step with the reference's shardings.
* Production cells on ``meta`` (records, skips, the CLI's incremental
  cache and the roofline over it); a cell built on the CPU runs and
  ``FlopCounterMode`` over it counts what the prediction says, which is
  the card cell's gate; the ``meta`` repairs (``device.on_cpu``, the
  optimizer's step count).  The sharded launcher that replaced
  ``launch/train.py``'s refusal of step 16c is held in
  ``tests/test_torch_train_sharded.py``."""

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

import json
import os
import subprocess

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.device import on_cpu
from repro_torch.launch import dryrun as DR
from repro_torch.launch import op_stats as OS
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import MeshLayout
from repro_torch.training import optimizer as OPT
from repro_torch.training import tree as T
from repro_torch.training.step import TrainConfig, abstract_train_state

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
MESH_2X4 = MeshLayout(("data", "model"), (2, 4))

REFERENCE = r'''
import json
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.distributed import sharding as SH
from repro.launch.input_specs import batch_specs_for, input_specs
from repro.models import model as MODEL
from repro.training.optimizer import OptConfig
from repro.training.step import TrainConfig, abstract_train_state, make_train_step

at = getattr(jax.sharding, "AxisType", None)
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(at.Auto,) * 2)
cfg = get_config("qwen2-1.5b").reduced()
named = lambda specs: SH.to_named(specs, mesh)
out = {}

tcfg = TrainConfig(opt=OptConfig(), remat=True, microbatches=2)
state = abstract_train_state(cfg, tcfg)
batch = batch_specs_for(cfg, ShapeSpec("tiny", 64, 8, "train"), with_labels=True)
ssp = SH.state_specs(state, mesh, dp_axes=("data",))
step = jax.jit(make_train_step(cfg, tcfg),
               in_shardings=(named(ssp), named(SH.batch_specs(batch, ("data",)))),
               out_shardings=(named(ssp), None))
out["train"] = step.lower(state, batch).compile().memory_analysis().argument_size_in_bytes

params = MODEL.abstract_params(cfg)
psp = SH.param_specs(params, mesh)
pb = batch_specs_for(cfg, ShapeSpec("p", 64, 8, "prefill"), with_labels=False)
fn = jax.jit(lambda p, b: MODEL.prefill(p, cfg, b, cache_len=64),
             in_shardings=(named(psp), named(SH.batch_specs(pb, ("data",)))))
out["prefill"] = fn.lower(params, pb).compile().memory_analysis().argument_size_in_bytes

spec = input_specs(cfg, ShapeSpec("d", 64, 8, "decode"))
csp = SH.cache_specs(spec["cache"], mesh, dp_axes=("data",))
fn = jax.jit(lambda p, t, c: MODEL.decode_step(p, cfg, t, c),
             in_shardings=(named(psp), NamedSharding(mesh, P(("data",))), named(csp)))
out["decode"] = fn.lower(params, spec["tokens"], spec["cache"]).compile(
    ).memory_analysis().argument_size_in_bytes
print(json.dumps(out))
'''


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module; importing it sets ``XLA_FLAGS`` for
    its own 512-device runs, which is put back for later subprocesses."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pick_microbatches_matches_reference(jdryrun, arch):
    from repro.configs import get_config as j_get_config

    for shape in SHAPES.values():
        for n_dp in (1, 2, 16, 32):
            assert DR.pick_microbatches(get_config(arch), shape, n_dp) == (
                jdryrun.pick_microbatches(j_get_config(arch), shape, n_dp))


@pytest.fixture(scope="module")
def reference_argument_bytes(tmp_path_factory):
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", REFERENCE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind,shape_name,kw", [
    ("train", "train@B8xT64", {"microbatches": 2}),
    ("prefill", "prefill@B8xT64", {}),
    ("decode", "decode@B8xT64", {})])
def test_argument_bytes_match_reference_memory_analysis(
        reference_argument_bytes, kind, shape_name, kw):
    cell = DR.build_cell(get_config("qwen2-1.5b").reduced(), shape_name,
                         MESH_2X4, **kw)
    assert DR.argument_bytes(cell) == reference_argument_bytes[kind]


def test_production_cells_on_meta():
    rec = DR.run_cell("qwen2-1.5b", "decode_32k", "single")
    assert rec["status"] == "ok"
    assert (rec["mesh"], rec["axis_names"], rec["n_devices"]) == (
        [16, 16], ["data", "model"], 256)
    assert rec["memory"]["temp_bytes"] is None
    layers = rec["cost"]["layers"]
    assert list(layers) == ["dense/global"]
    assert layers["dense/global"]["count"] == 28
    assert rec["analytic"]["flops_per_device"] == rec["cost"]["flops"] / 256
    assert rec["analytic"]["bytes_per_device"] == (
        rec["memory"]["argument_bytes"] + rec["memory"]["output_bytes"])
    assert set(rec["collectives"]) >= {"all-reduce", "wire_bytes"}
    skipped = DR.run_cell("qwen2-1.5b", "long_500k", "multi")
    assert skipped["status"] == "skipped" and "500k" in skipped["reason"]
    train = DR.run_cell("mamba2-370m", "train_4k", "multi")
    assert (train["microbatches"], train["fsdp_params"]) == (
        DR.pick_microbatches(get_config("mamba2-370m"), SHAPES["train_4k"],
                             32), False)
    assert train["collectives"]["reduce-scatter"]["count"] > 0


def test_cli_caches_cells_and_roofline_reads_them(tmp_path, capsys):
    out = tmp_path / "r.json"
    argv = ["--arch", "gemma3-1b", "--shape", "decode_32k", "--out", str(out)]
    DR.main(argv)
    first = capsys.readouterr().out
    assert first.count("[ok]") == 2 and "total: 2 ok" in first
    DR.main(argv)
    assert capsys.readouterr().out.count("[cached]") == 2
    rows, skips = RL.load(str(out), "baseline")
    assert [r["mesh"] for r in rows] == ["multi", "single"] and not skips
    assert all(r["bound"] == "memory" for r in rows)


def test_card_cell_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rec = DR.run_cell("qwen2-1.5b", "decode@B32xT8192", "card", measure=False)
    assert rec["status"] == "ok" and rec["n_devices"] == 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DR.run_cell("qwen2-1.5b", "decode@B32xT8192", "card")


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m"])
def test_cell_built_on_the_cpu_counts_its_prediction(arch):
    """The card cells' gate at the reduced size on the CPU: the step built
    from the seed runs, finite, and ``FlopCounterMode`` over it equals the
    prediction from ``meta``; the arguments occupy the predicted bytes."""
    cfg = get_config(arch).reduced()
    for shape_name in ("train@B4xT64", "prefill@B1xT64", "decode@B4xT64"):
        cell = DR.build_cell(cfg, shape_name, DR.MESHES["card"], device="cpu")
        predicted = OS.step_flops(cfg, cell.shape, cell.tcfg)["flops"]
        with FlopCounterMode(display=False) as fc:
            out = cell.fn(*cell.args)
        result = out[1]["loss"] if cell.shape.kind == "train" else out[0]
        assert bool(torch.isfinite(result).all())
        assert fc.get_total_flops() == predicted, shape_name
        held = sum(t.numel() * t.element_size() for a in cell.args
                   for _, t in T.items(DR._tree(a)))
        assert held == DR.argument_bytes(DR.build_cell(
            cfg, shape_name, DR.MESHES["card"]))


def test_meta_runs_the_plain_versions_and_the_optimizer():
    """A kernel wrapper takes its plain version on ``meta`` as on the CPU
    (a CUDA tensor still never falls back); a train state on ``meta``
    steps as the first step."""
    meta = torch.empty(3, device="meta")
    assert on_cpu(meta, meta)
    with pytest.raises(ValueError, match="mixed devices"):
        on_cpu(meta, torch.zeros(3))
    state = abstract_train_state(get_config("qwen2-1.5b").reduced(),
                                 TrainConfig())
    step, step_t, lr = OPT._step_scalars(state["opt"], OPT.OptConfig())
    assert step == 1 and step_t.is_meta
    assert lr == OPT.schedule(OPT.OptConfig(), 1)
