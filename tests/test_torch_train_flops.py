"""The port's train-step FLOPs (``repro_torch.launch.op_stats``) against
the reference's HLO analysis, on one device with the reduced configs (B 8,
T 64, remat, one microbatch): ``FlopCounterMode`` over the port's step on
``meta`` tensors against ``hlo_stats.analyze_hlo(...)["flops_per_device"]``
of the reference's jitted step, equal exactly for six configs and
different by ROADMAP F19's exact amounts for mamba2, hymba, internvl2 and
whisper (prefill and decode: ``test_torch_op_stats.py``)."""

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

import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.launch import input_specs as JISPEC
from repro.launch.hlo_stats import analyze_hlo
from repro.training import step as JSTEP
from repro.training.optimizer import OptConfig as JOptConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import op_stats as OS
from repro_torch.training.step import TrainConfig

SHAPES = {"train": (8, 64)}
# ROADMAP F19: port - reference train FLOPs at the reduced size (remat,
# one microbatch), exact; the other six configs count equal
F19_TRAIN_DELTA = {"mamba2-370m": 25_165_824, "hymba-1.5b": -18_612_224,
                   "internvl2-26b": -4_194_304, "whisper-small": -54_525_952}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shape(kind) -> ShapeSpec:
    B, T = SHAPES[kind]
    return ShapeSpec(kind, T, B, kind)


def reference_train_flops(arch: str) -> float:
    """``analyze_hlo``'s FLOPs of the reference's jitted train step."""
    cfg = j_get_config(arch).reduced()
    B, T = SHAPES["train"]
    tcfg = JSTEP.TrainConfig(opt=JOptConfig(), microbatches=1, remat=True)
    lowered = jax.jit(JSTEP.make_train_step(cfg, tcfg)).lower(
        JSTEP.abstract_train_state(cfg, tcfg),
        JISPEC.batch_specs_for(cfg, JShapeSpec("train", T, B, "train"),
                               with_labels=True))
    return analyze_hlo(lowered.compile().as_text())["flops_per_device"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_flops_equal_reference_hlo_up_to_f19(arch):
    """F19: the port's checkpointed CE chunk recomputes its logits, which
    XLA folds into the forward at one chunk; the reference's flash block
    steps and SSD chunk step are under ``jax.checkpoint``, so its
    backward recomputes their products, which the port's autograd keeps.
    The six configs whose two amounts cancel at this size count equal."""
    got = OS.step_flops(get_config(arch).reduced(), _shape("train"),
                        TrainConfig(remat=True))["flops"]
    assert got - reference_train_flops(arch) == F19_TRAIN_DELTA.get(arch, 0)
