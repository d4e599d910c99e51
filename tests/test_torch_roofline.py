"""The dry-run's inputs and roofline arithmetic (``repro_torch.launch.
input_specs``, ``launch.roofline``) against the reference's.

``param_counts`` (total, and active with the routed experts scaled by
top_k / n_experts) and ``model_flops`` are equal exactly for the ten
configs at the four assigned shapes; ``input_specs`` gives the same
shapes, the reference's int32 tokens as the port's ``TOKEN_DTYPE``; the
roofline row of a hand-made record and its markdown line."""

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

import functools
import json

import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import input_specs as JISPEC
from repro.launch import roofline as JRL
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import input_specs as ISPEC
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import IB_BW, NVLINK_BW
from repro_torch.telemetry.profiler import HBM_BYTES_PER_S, PEAK_BF16_FLOPS
from repro_torch.training import tree as T

# the reference's dtypes, as the port carries them
DTYPES = {jnp.dtype("int32"): torch.int32, jnp.dtype("float32"): torch.float32,
          jnp.dtype("bfloat16"): torch.bfloat16}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_reference(arch):
    assert RL.param_counts(arch) == JRL.param_counts(arch)


# both packages' counts, each computed once (model_flops reads them for
# every shape; the counts themselves are held equal above)
_J_COUNTS = functools.lru_cache(maxsize=None)(JRL.param_counts)
_COUNTS = functools.lru_cache(maxsize=None)(RL.param_counts)


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_reference(monkeypatch, arch, shape_name):
    monkeypatch.setattr(JRL, "param_counts", _J_COUNTS)
    monkeypatch.setattr(RL, "param_counts", _COUNTS)
    assert RL.model_flops(arch, shape_name) == JRL.model_flops(arch, shape_name)


def test_active_parameters_of_the_moe_configs():
    """The routed experts count top_k / n_experts (the issue's numbers)."""
    assert RL.param_counts("llama4-maverick-400b-a17b") == (
        400_713_815_040.0, 17_186_657_280.0)
    assert RL.param_counts("deepseek-moe-16b") == (16_375_728_128.0,
                                                   2_828_650_496.0)
    assert RL.param_counts("qwen2-1.5b") == (1_543_910_912.0,) * 2


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch, shape_name):
    want = ISPEC.input_specs(get_config(arch), SHAPES[shape_name])
    ref = JISPEC.input_specs(j_get_config(arch), SHAPES[shape_name])
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    ref_leaves = {tuple(str(p.key) for p in path): (tuple(l.shape),
                                                     DTYPES[l.dtype])
                  for path, l in flat}
    got = {path: (tuple(t.shape), t.dtype) for path, t in T.items(want)}
    assert got == ref_leaves
    assert all(t.device.type == "meta" for _, t in T.items(want))


def test_parse_shape():
    assert ISPEC.parse_shape("decode_32k") is SHAPES["decode_32k"]
    s = ISPEC.parse_shape("train@B8xT2048")
    assert (s.kind, s.global_batch, s.seq_len) == ("train", 8, 2048)
    with pytest.raises(KeyError):
        ISPEC.parse_shape("train@8x2048")


def _record(**over):
    rec = {"status": "ok", "mesh": [2, 4], "axis_names": ["data", "model"],
           "n_devices": 8, "count_s": 0.5,
           "memory": {"argument_bytes": 2**31, "output_bytes": 0,
                      "temp_bytes": None},
           "analytic": {"flops_per_device": 989e12 * 0.5,
                        "bytes_per_device": 3.35e12 * 0.25,
                        "wire_bytes_by_axes": {"data": 450e9 * 0.125,
                                               "model": 450e9 * 0.125}}}
    rec.update(over)
    return rec


def test_analyze_cell_by_hand():
    """A 2x4 mesh in one node: 0.5 s of compute, 0.25 s of memory, 0.25 s
    of collectives on NVLink; qwen2-1.5b at decode_32k does 2 x N x 128
    model FLOPs."""
    assert (PEAK_BF16_FLOPS, HBM_BYTES_PER_S, NVLINK_BW, IB_BW) == (
        989e12, 3.35e12, 450e9, 50e9)
    row = RL.analyze_cell("t/qwen2-1.5b/decode_32k/m", _record())
    mf = 2.0 * 1_543_910_912 * 128
    assert row["bound"] == "compute"
    assert row["t_compute_s"] == pytest.approx(0.5)
    assert row["t_memory_s"] == pytest.approx(0.25)
    assert row["t_collective_s"] == pytest.approx(0.25)
    assert row["model_flops"] == mf
    assert row["roofline_fraction"] == pytest.approx(
        mf / (8 * 989e12) / 0.5)
    assert row["arg_gib"] == 2.0 and row["temp_gib"] is None
    measured = RL.analyze_cell("t/qwen2-1.5b/decode_32k/card", _record(
        measured={"step_ms": 2.0}))
    assert measured["measured_fraction"] == pytest.approx(
        mf / (8 * 989e12) / 2e-3)


def test_load_and_fmt_md(tmp_path):
    path = tmp_path / "r.json"
    path.write_text(json.dumps({
        "t/qwen2-1.5b/decode_32k/single": _record(),
        "t/qwen2-1.5b/long_500k/single": {"status": "skipped", "reason": "why"},
        "u/qwen2-1.5b/decode_32k/single": _record()}))
    rows, skips = RL.load(str(path), "t")
    assert [r["key"] for r in rows] == ["t/qwen2-1.5b/decode_32k/single"]
    assert skips == [("t/qwen2-1.5b/long_500k/single", "why")]
    md = RL.fmt_md(rows, skips)
    assert "| qwen2-1.5b | decode_32k | single |" in md
    assert "**compute**" in md and "`t/qwen2-1.5b/long_500k/single`: why" in md
