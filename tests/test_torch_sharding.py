"""The placement rules (``repro_torch.distributed.sharding``) and the mesh
layouts (``launch.mesh``) against the reference's, leaf by leaf.

For all ten configs at full width, on duck meshes of 2x4, 16x16 and
2x16x16 (the reference's rules read only ``mesh.shape`` and
``mesh.axis_names``, so no devices are forced): ``param_specs``,
``state_specs`` (ZeRO on and off, ``fsdp_params``, the adafactor ``"f"``
branch), ``zero_extend``, ``batch_specs``, ``cache_specs`` (``auto`` and
``heads`` at ``decode_32k`` and ``long_500k``) as tuples, and
``sharded_bytes_per_device`` to the byte; ``to_placements`` on
hand-worked specs."""

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
from types import SimpleNamespace

import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as j_get_config
from repro.distributed import sharding as JSH
from repro.launch import input_specs as JISPEC
from repro.launch import mesh as JMESH
from repro.models import model as JMODEL
from repro.training import step as JSTEP
from repro.training.optimizer import OptConfig as JOptConfig
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch import input_specs as ISPEC
from repro_torch.launch import mesh as MESH
from repro_torch.models import model as TM
from repro_torch.training import tree as T
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.step import TrainConfig, abstract_train_state

LAYOUTS = {"2x4": (("data", "model"), (2, 4)),
           "16x16": (("data", "model"), (16, 16)),
           "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _meshes(name):
    """(the reference's duck mesh, the port's layout)."""
    axes, sizes = LAYOUTS[name]
    return (SimpleNamespace(shape=dict(zip(axes, sizes)), axis_names=axes),
            MESH.MeshLayout(axes, sizes))


def _dp(name):
    return MESH.dp_axes(_meshes(name)[1])


def _jflat(tree) -> dict:
    """A reference tree (PartitionSpec or ShapeDtypeStruct leaves) as
    {path: leaf}, specs as tuples."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(str(p.key) for p in path):
            tuple(leaf) if isinstance(leaf, JP) else leaf
            for path, leaf in flat}


def _flat(tree) -> dict:
    return {path: tuple(spec) for path, spec in T.items(tree)}


@functools.lru_cache(maxsize=None)
def _params(arch):
    return (JMODEL.abstract_params(j_get_config(arch)),
            TM.abstract_params(get_config(arch)))


@functools.lru_cache(maxsize=None)
def _states(arch, opt="adamw"):
    jstate = JSTEP.abstract_train_state(
        j_get_config(arch), JSTEP.TrainConfig(opt=JOptConfig(name=opt)))
    state = abstract_train_state(get_config(arch),
                                 TrainConfig(opt=OptConfig(name=opt)))
    return jstate, state


@functools.lru_cache(maxsize=None)
def _caches(arch, shape_name):
    jc = JISPEC.input_specs(j_get_config(arch), SHAPES[shape_name])["cache"]
    c = ISPEC.input_specs(get_config(arch), SHAPES[shape_name])["cache"]
    return jc, c


def test_production_layouts_match_reference_shapes():
    for multi, (axes, sizes) in ((False, LAYOUTS["16x16"]),
                                 (True, LAYOUTS["2x16x16"])):
        got = MESH.make_production_mesh(multi_pod=multi)
        assert (got.axis_names, got.sizes) == (axes, sizes)
        assert MESH.dp_axes(got) == JMESH.dp_axes(
            SimpleNamespace(axis_names=axes))


def test_host_mesh_over_given_devices_and_refusal_without_card():
    devs = [torch.device("cpu")] * 8
    m = MESH.make_host_mesh(2, 4, devices=devs)
    assert m.shape == {"data": 2, "model": 4}
    assert MESH.make_host_mesh(devices=devs).shape == {"data": 8, "model": 1}
    with pytest.raises(ValueError):
        MESH.make_host_mesh(4, 4, devices=devs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MESH.make_host_mesh()


def test_h100_constants_replace_the_tpu_ones():
    from repro_torch.telemetry.profiler import HBM_BYTES_PER_S, PEAK_BF16_FLOPS

    assert PEAK_BF16_FLOPS == 989e12 and HBM_BYTES_PER_S == 3.35e12
    assert (MESH.NVLINK_BW, MESH.IB_BW) == (450e9, 50e9)
    # a group inside one 8-card node rides NVLink, a wider one InfiniBand
    assert MESH.group_bandwidth(_meshes("2x4")[1], ("data",)) == MESH.NVLINK_BW
    assert MESH.group_bandwidth(_meshes("2x4")[1], ("model",)) == MESH.NVLINK_BW
    assert MESH.group_bandwidth(_meshes("16x16")[1], ("model",)) == MESH.IB_BW
    assert MESH.group_bandwidth(_meshes("2x16x16")[1],
                                ("pod", "data")) == MESH.IB_BW


@pytest.mark.parametrize("mesh", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_and_bytes_match_reference(arch, mesh):
    jm, m = _meshes(mesh)
    jparams, params = _params(arch)
    jspecs, specs = JSH.param_specs(jparams, jm), SH.param_specs(params, m)
    assert _flat(specs) == _jflat(jspecs)
    assert (SH.sharded_bytes_per_device(params, specs, m)
            == JSH.sharded_bytes_per_device(jparams, jspecs, jm))
    # zero_extend over the DP axes, as the serving path's second axis
    jz = JSH.zero_extend(jspecs, jparams, jm, _dp(mesh))
    z = SH.zero_extend(specs, params, m, _dp(mesh))
    assert _flat(z) == _jflat(jz)
    assert (SH.sharded_bytes_per_device(params, z, m)
            == JSH.sharded_bytes_per_device(jparams, jz, jm))


@pytest.mark.parametrize("zero,fsdp", [(True, False), (False, False),
                                       (True, True)])
@pytest.mark.parametrize("mesh", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_specs_and_bytes_match_reference(arch, mesh, zero, fsdp):
    jm, m = _meshes(mesh)
    jstate, state = _states(arch)
    jspecs = JSH.state_specs(jstate, jm, dp_axes=_dp(mesh), zero=zero,
                             fsdp_params=fsdp)
    specs = SH.state_specs(state, m, dp_axes=_dp(mesh), zero=zero,
                           fsdp_params=fsdp)
    assert _flat(specs) == _jflat(jspecs)
    assert (SH.sharded_bytes_per_device(state, specs, m)
            == JSH.sharded_bytes_per_device(jstate, jspecs, jm))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_adafactor_state_specs_match_reference(arch):
    """The factored ``"f"`` state is replicated, leaf for leaf."""
    jm, m = _meshes("16x16")
    jstate, state = _states(arch, "adafactor")
    jspecs = JSH.state_specs(jstate, jm, dp_axes=("data",))
    specs = SH.state_specs(state, m, dp_axes=("data",))
    assert _flat(specs) == _jflat(jspecs)
    assert (SH.sharded_bytes_per_device(state, specs, m)
            == JSH.sharded_bytes_per_device(jstate, jspecs, jm))


@pytest.mark.parametrize("mesh", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_match_reference(arch, mesh):
    jm, m = _meshes(mesh)
    for shape_name in ("train_4k", "prefill_32k"):
        shape = SHAPES[shape_name]
        jb = JISPEC.input_specs(j_get_config(arch), shape)["batch"]
        b = ISPEC.input_specs(get_config(arch), shape)["batch"]
        jspecs, specs = JSH.batch_specs(jb, _dp(mesh)), SH.batch_specs(b, _dp(mesh))
        assert _flat(specs) == _jflat(jspecs)
        assert (SH.sharded_bytes_per_device(b, specs, m)
                == JSH.sharded_bytes_per_device(jb, jspecs, jm))


@pytest.mark.parametrize("policy", ["auto", "heads"])
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_and_bytes_match_reference(arch, mesh, shape_name, policy):
    jm, m = _meshes(mesh)
    jc, c = _caches(arch, shape_name)
    jspecs = JSH.cache_specs(jc, jm, dp_axes=_dp(mesh), seq_policy=policy)
    specs = SH.cache_specs(c, m, dp_axes=_dp(mesh), seq_policy=policy)
    assert _flat(specs) == _jflat(jspecs)
    assert (SH.sharded_bytes_per_device(c, specs, m)
            == JSH.sharded_bytes_per_device(jc, jspecs, jm))


def test_to_placements_one_per_mesh_axis():
    m = _meshes("2x16x16")[1]
    assert SH.to_placements(SH.P(("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert SH.to_placements(SH.P(None, None), m) == (
        Replicate(), Replicate(), Replicate())
    assert SH.to_placements(SH.P(), m) == (Replicate(),) * 3
    assert SH.to_placements(SH.P(None, ("data", "model")), m) == (
        Replicate(), Shard(1), Shard(1))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        SH.to_placements(SH.P(("model", "data")), m)
