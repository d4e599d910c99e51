"""K6's plain version (what the wrapper runs on a CPU tensor, and what
``chip_smoke.py`` holds the CUDA kernel to on the card) against the
reference's ``decode_attn_ref`` and its Pallas kernel run in interpret
mode, at the shapes of ``tests/test_kernels.py``; and the wrapper's
routing: CPU tensors take the plain version and count no launch."""

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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.ops import decode_attn as j_decode_attn
from repro.kernels.decode_attn.ref import decode_attn_ref as j_decode_attn_ref
from repro_torch.kernels.decode_attn import kernel as TKer
from repro_torch.kernels.decode_attn import ops as TOps
from repro_torch.kernels.decode_attn.ref import decode_attn_ref

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _inputs(seed, B, S, Hq, Hkv, D, dtype, lengths=None):
    """The same draws for both packages (rounded to bf16 the same way)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    if lengths is None:
        lengths = rng.integers(1, S + 1, B)
    lengths = np.asarray(lengths, np.int32)
    j = [jnp.asarray(a, _JDT[dtype]) for a in (q, k, v)] + [jnp.asarray(lengths)]
    t = [torch.tensor(a).to(_TDT[dtype]) for a in (q, k, v)] + [
        torch.tensor(lengths)]
    return j, t


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [
    (1, 128, 4, 4, 32), (2, 512, 8, 2, 64), (3, 300, 4, 1, 128),
    (2, 1024, 16, 8, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_ref_and_pallas(B, S, Hq, Hkv, D, dtype):
    j, t = _inputs(B * S + D, B, S, Hq, Hkv, D, dtype)
    got = TOps.decode_attn(*t)
    assert got.dtype == _TDT[dtype] and got.shape == (B, Hq, D)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(j_decode_attn_ref(*j)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _np(got), _np(j_decode_attn(*j, use_pallas=True, interpret=True)),
        atol=tol, rtol=tol)


def test_window():
    j, t = _inputs(1, 2, 512, 8, 2, 64, "float32", lengths=[500, 321])
    got = TOps.decode_attn(*t, window=128)
    np.testing.assert_allclose(_np(got), _np(j_decode_attn_ref(*j, window=128)),
                               atol=1e-4)
    np.testing.assert_allclose(
        _np(got), _np(j_decode_attn(*j, window=128, use_pallas=True,
                                    interpret=True)), atol=1e-4)
    # the window changes the answer against full attention
    assert float(np.abs(_np(TOps.decode_attn(*t)) - _np(got)).max()) > 1e-3


def test_window_past_the_cache_is_uniform_like_reference():
    """A free slot's length keeps growing; once ``length - window`` passes
    the last row no position is valid, and the reference's all--1e30
    scores give a uniform softmax over the S rows."""
    j, t = _inputs(2, 2, 64, 4, 1, 64, "float32", lengths=[100, 500])
    got = TOps.decode_attn(*t, window=32)
    np.testing.assert_allclose(_np(got), _np(j_decode_attn_ref(*j, window=32)),
                               atol=1e-5)
    mean_v = t[2].float().mean(dim=1).repeat_interleave(4, dim=1)
    np.testing.assert_allclose(_np(got), mean_v.numpy(), atol=1e-5)


def test_length_one():
    """A single valid position: the output is that row of v, no NaN."""
    j, t = _inputs(3, 2, 128, 4, 2, 32, "float32", lengths=[1, 1])
    got = TOps.decode_attn(*t)
    assert torch.isfinite(got).all()
    expect = t[2][:, 0].repeat_interleave(2, dim=1)
    np.testing.assert_allclose(_np(got), expect.numpy(), atol=1e-5)
    np.testing.assert_allclose(
        _np(got), _np(j_decode_attn(*j, use_pallas=True, interpret=True)),
        atol=1e-5)


def test_length_past_cache_attends_to_all_rows_f8():
    """F8: the reference's Pallas wrapper zero-pads S to a block multiple
    and its kernel then counts the zero rows as valid when length > S;
    ``decode_attn_ref`` and ``_decode_attend`` (what the model runs) never
    attend past S.  The port follows them."""
    j, t = _inputs(4, 2, 300, 4, 1, 128, "float32", lengths=[305, 400])
    got = TOps.decode_attn(*t)
    np.testing.assert_allclose(_np(got), _np(j_decode_attn_ref(*j)), atol=1e-4)
    full = TOps.decode_attn(*t[:3], torch.tensor([300, 300], dtype=torch.int32))
    np.testing.assert_allclose(_np(got), _np(full), atol=1e-6)
    padded = _np(j_decode_attn(*j, use_pallas=True, interpret=True))
    assert float(np.abs(_np(got) - padded).max()) > 1e-2


def test_cpu_tensors_take_plain_version_and_count_nothing():
    _, t = _inputs(5, 2, 64, 12, 2, 128, "bfloat16")
    before = TKer.launches["decode_attn"]
    got = TOps.decode_attn(*t)
    assert TKer.launches["decode_attn"] == before
    assert torch.equal(got, decode_attn_ref(*t))


def test_kernel_refuses_cpu_tensors():
    """The kernel entry never quietly runs the plain version."""
    _, t = _inputs(6, 1, 64, 4, 1, 64, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        TKer.decode_attn(*t)
