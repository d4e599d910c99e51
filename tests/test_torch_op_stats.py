"""The dry-run's counts (``repro_torch.launch.op_stats``) against the
reference's HLO analysis, on one device with the reduced configs.

* The port's step on ``meta`` tensors under ``FlopCounterMode`` against
  ``hlo_stats.analyze_hlo(...)["flops_per_device"]`` of the reference's
  jitted step: prefill (B 4, T 64) and decode (B 4, cache 64) equal
  exactly for all ten configs (train: ``test_torch_train_flops.py``).
* One layer of each kind times its count, plus the rest once, equals the
  whole step's count exactly (every config and kind, two microbatches
  too).
* The collective ring model on a hand-worked 2x4 placement."""

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

import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.launch import input_specs as JISPEC
from repro.launch.hlo_stats import analyze_hlo
from repro.models import model as JMODEL
from repro.training import step as JSTEP
from repro.training.optimizer import OptConfig as JOptConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import sharding as SH
from repro_torch.launch import op_stats as OS
from repro_torch.launch.mesh import MeshLayout
from repro_torch.training.step import TrainConfig

SHAPES = {"train": (8, 64), "prefill": (4, 64), "decode": (4, 64)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shape(kind) -> ShapeSpec:
    B, T = SHAPES[kind]
    return ShapeSpec(kind, T, B, kind)


def reference_flops(arch: str, kind: str) -> float:
    """``analyze_hlo``'s FLOPs of the reference's jitted step."""
    cfg = j_get_config(arch).reduced()
    B, T = SHAPES[kind]
    shape = JShapeSpec(kind, T, B, kind)
    if kind == "train":
        tcfg = JSTEP.TrainConfig(opt=JOptConfig(), microbatches=1, remat=True)
        lowered = jax.jit(JSTEP.make_train_step(cfg, tcfg)).lower(
            JSTEP.abstract_train_state(cfg, tcfg),
            JISPEC.batch_specs_for(cfg, shape, with_labels=True))
    elif kind == "prefill":
        lowered = jax.jit(lambda p, b: JMODEL.prefill(p, cfg, b, cache_len=T)
                          ).lower(JMODEL.abstract_params(cfg),
                                  JISPEC.batch_specs_for(cfg, shape,
                                                         with_labels=False))
    else:
        spec = JISPEC.input_specs(cfg, shape)
        lowered = jax.jit(lambda p, t, c: JMODEL.decode_step(p, cfg, t, c)
                          ).lower(JMODEL.abstract_params(cfg), spec["tokens"],
                                  spec["cache"])
    return analyze_hlo(lowered.compile().as_text())["flops_per_device"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serving_flops_equal_reference_hlo(arch, kind):
    got = OS.step_flops(get_config(arch).reduced(), _shape(kind),
                        TrainConfig(remat=True))["flops"]
    assert got == reference_flops(arch, kind)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_layer_times_count_equals_whole_step(arch):
    cfg = get_config(arch).reduced()
    cases = [(_shape(k), TrainConfig(remat=True)) for k in SHAPES]
    cases.append((_shape("train"), TrainConfig(remat=True, microbatches=2)))
    if cfg.family != "encdec":
        cases.append((_shape("train"), TrainConfig(remat=False)))
    for shape, tcfg in cases:
        counted = OS.step_flops(cfg, shape, tcfg)
        with torch.no_grad():
            whole = OS.whole_step_flops(cfg, shape, tcfg)
        assert counted["flops"] == whole, (shape.kind, tcfg)
        assert counted["rest"] > 0
        assert sum(v["count"] for v in counted["layers"].values()) == (
            cfg.n_layers + (cfg.n_encoder_layers if shape.kind != "decode"
                            else 0) - (cfg.n_layers // 2
                                       if cfg.moe_layer_step == 2 else 0))


def test_layer_census_of_the_mixed_configs():
    census = {arch: OS.layer_census(get_config(arch)) for arch in ARCH_IDS}
    assert census["gemma3-1b"] == {("dense", False): 22, ("dense", True): 4}
    assert census["hymba-1.5b"] == {("hybrid", True): 3, ("hybrid", False): 29}
    assert census["deepseek-moe-16b"] == {("dense", True): 1, ("moe", True): 27}
    assert census["llama4-maverick-400b-a17b"] == {("pair", True): 24}
    assert census["whisper-small"] == {("enc", False): 12, ("dec", False): 12}
    assert OS.cut_config(get_config("deepseek-moe-16b")).n_layers == 2
    assert OS.cut_config(get_config("llama4-maverick-400b-a17b")).n_layers == 2


def test_collective_model_by_hand():
    """A 2x4 (data, model) mesh, bf16 activations, 8 sequences of 16
    positions, remat, one microbatch.  Gradients (float32): embed (16, 8)
    rows on model, 128 B a device, ZeRO on data: reduce-scatter + all-
    gather; the two row-sharded wo leaves, 128 and 192 B, likewise;
    final_norm (5,) replicated and indivisible by 2: an all-reduce of 20
    B.  Activations: each wo's (4, 16, 8) bf16 output, 1,024 B, all-
    reduced over model in the forward, the recompute and the backward of
    both layers: 12 all-reduces."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                              dtype="bfloat16")
    mesh = MeshLayout(("data", "model"), (2, 4))
    f32 = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    params = {"embed": f32(16, 8), "final_norm": f32(5),
              "g0": {"attn": {"wo": f32(2, 8, 8)}, "mlp": {"wo": f32(2, 12, 8)}}}
    p_specs = SH.param_specs(params, mesh)
    m_specs = SH.zero_extend(p_specs, params, mesh, ("data",))
    got = OS.collective_stats(cfg, ShapeSpec("t", 16, 8, "train"), mesh,
                              ("data",), p_specs, params, m_specs=m_specs,
                              remat=True, n_pos=16)
    assert got["reduce-scatter"] == {"count": 3, "bytes": 448}
    assert got["all-gather"] == {"count": 3, "bytes": 448}
    assert got["all-reduce"] == {"count": 13, "bytes": 20 + 12 * 1024}
    assert got["wire_bytes_by_axes"] == {"data": 448 + 448 + 2 * 20,
                                         "model": 2 * 12 * 1024}
    assert got["wire_bytes"] == 936 + 24_576
