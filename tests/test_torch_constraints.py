"""The activation layout pins (``repro_torch.distributed.constraints``)
against the reference's.

The reference's policy is run on a duck mesh with
``jax.lax.with_sharding_constraint`` and its ``NamedSharding`` replaced by
recorders (its file is not edited), so the spec it would pin each tensor
to is captured; the port's policy must name the same spec, or refuse
the same tensors (an unpinned kind, another rank, a dim the mesh does
not divide), for every kind, shape and option.  The models call
``constrain`` at the reference's sites: a recording policy sees the same
(kind, shape) pairs in both packages' prefill and loss.  A plain tensor
passes through a policy unchanged; a ``DTensor`` is redistributed."""

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

import itertools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.distributed import constraints as JC
from repro.models import model as JMODEL
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.distributed import constraints as C
from repro_torch.distributed.sharding import P
from repro_torch.launch.mesh import MeshLayout
from repro_torch.models import model as TM

KINDS = ("hidden", "ffn", "logits", "moe_expert", "tokens2d", "attn_q",
         "attn_kv", "attn_out", "unpinned")
SHAPES = [(8, 64, 32), (6, 64, 32), (8, 60, 32), (8, 64, 30), (16, 8),
          (12, 8), (8, 64, 4, 16), (8, 60, 4, 16), (8, 64)]
LAYOUTS = [(("data", "model"), (2, 4)), (("data", "model"), (16, 16)),
           (("pod", "data", "model"), (2, 4, 2))]
OPTIONS = list(itertools.product((False, True), (False, True)))


def _reference_spec(monkeypatch, mesh, dp, opts, shape, kind):
    """The spec the reference's policy hands ``with_sharding_constraint``
    for a ``shape`` tensor of ``kind``, or None where it returns x."""
    seen = []
    monkeypatch.setattr(JC, "NamedSharding", lambda m, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(s) or x)
    policy = JC.make_mesh_policy(mesh, dp, seq_residual=opts[0],
                                 seq_attn=opts[1])
    x = jax.ShapeDtypeStruct(shape, jnp.float32)
    policy(x, kind)
    return tuple(seen[0]) if seen else None


@pytest.mark.parametrize("seq_residual,seq_attn", OPTIONS)
@pytest.mark.parametrize("layout", range(len(LAYOUTS)))
def test_policy_specs_match_reference(monkeypatch, layout, seq_residual,
                                      seq_attn):
    axes, sizes = LAYOUTS[layout]
    jmesh = SimpleNamespace(shape=dict(zip(axes, sizes)), axis_names=axes)
    mesh = MeshLayout(axes, sizes)
    dp = tuple(a for a in axes if a != "model")
    policy = C.make_mesh_policy(mesh, dp, seq_residual=seq_residual,
                                seq_attn=seq_attn)
    pinned = 0
    for kind in KINDS:
        for shape in SHAPES:
            want = _reference_spec(monkeypatch, jmesh, dp,
                                   (seq_residual, seq_attn), shape, kind)
            got = policy.spec(shape, kind)
            assert (None if got is None else tuple(got)) == want, (kind, shape)
            pinned += want is not None
    assert pinned > 0


def test_constrain_is_identity_without_a_policy_and_on_a_plain_tensor():
    x = torch.ones(8, 64, 32)
    assert C.constrain(x, "hidden") is x
    mesh = MeshLayout(("data", "model"), (2, 4))
    policy = C.make_mesh_policy(mesh, ("data",))
    assert policy.spec(tuple(x.shape), "hidden") == P(("data",), None, None)
    with C.activation_policy(policy):
        assert C.constrain(x, "hidden") is x
    assert C._POLICY.get() is None


def test_policy_redistributes_a_dtensor(tmp_path):
    """One rank on a 1x1 ("data", "model") device mesh of the CPU (a gloo
    group through a file store): the pinned DTensor comes back on the
    kind's placements, its values unchanged."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        dm = DeviceMesh("cpu", [[0]], mesh_dim_names=("data", "model"))
        x = torch.arange(8 * 4 * 6, dtype=torch.float32).reshape(8, 4, 6)
        dx = DTensor.from_local(x, dm, [Replicate(), Replicate()])
        policy = C.make_mesh_policy(MeshLayout(("data", "model"), (1, 1)),
                                    ("data",))
        with C.activation_policy(policy):
            out = C.constrain(dx, "logits")
            same = C.constrain(dx, "unpinned")
        assert isinstance(out, DTensor)
        assert tuple(out.placements) == (Shard(0), Shard(2))
        assert torch.equal(out.full_tensor(), x)
        assert same is dx
    finally:
        dist.destroy_process_group()


class _Recorder:
    def __init__(self):
        self.seen = set()

    def __call__(self, x, kind):
        self.seen.add((kind, tuple(int(d) for d in x.shape)))
        return x


def _record(run, policy_cm, recorder):
    with policy_cm(recorder):
        run()
    return recorder.seen


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "minicpm3-4b",
                                  "deepseek-moe-16b"])
def test_model_call_sites_match_reference(arch):
    """Prefill and the loss of the reduced config (f32) pin the same
    (kind, shape) pairs in both packages; the port's outputs are those of
    a run with no policy."""
    jcfg = j_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jparams = JMODEL.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    b = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}

    def port():
        TM.prefill(params, cfg, {"tokens": b["tokens"]}, cache_len=32)
        TM.loss_fn(params, cfg, b)

    def ref():
        JMODEL.prefill(jparams, jcfg, {"tokens": jb["tokens"]}, cache_len=32)
        JMODEL.loss_fn(jparams, jcfg, jb)

    got = _record(port, C.activation_policy, _Recorder())
    want = _record(ref, JC.activation_policy, _Recorder())
    assert got == want
    assert {k for k, _ in got} >= {"hidden", "logits", "attn_q", "attn_out"}
    plain = TM.loss_fn(params, cfg, b)[0]
    with C.activation_policy(_Recorder()):
        pinned = TM.loss_fn(params, cfg, b)[0]
    assert torch.equal(plain, pinned)
