"""The port's demos (``python -m repro_torch.examples.<name>``) against the
reference's (``examples/<name>.py``) on the CPU: every printed line of the
four store demos but the wall-clock ones, the serving demo's lines and
every request's tokens from the reference's weights (carried across by
``convert``), the training demo's rates bit for bit and its losses and
gradient norms within the model path's tolerance from the reference's
initial state, all against the fixture
(``tests/data/bench_rows_reference.json``); the quickstart's lines against
a fresh reference run; the CLIs."""

import bench_reference as BR  # sets the jax shim before `repro` imports

import importlib

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.examples._common import timer_free

STORE_DEMOS = ("quickstart", "failover_demo", "balance_demo", "trace_demo")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads buy nothing here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def demo(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


@pytest.fixture(scope="module")
def fixture():
    return BR.read_fixture()["examples"]


@pytest.mark.parametrize("name", STORE_DEMOS)
def test_store_demo_lines_match_the_reference(name, fixture):
    got = demo(name).run("cpu", echo=False)
    assert timer_free(got["lines"]) == fixture[name]["lines"]


def test_fixture_matches_a_fresh_reference_quickstart(fixture):
    lines, _ = BR.run_demo("quickstart")
    assert timer_free(lines) == fixture["quickstart"]["lines"]


def test_serving_demo_matches_the_reference_from_its_weights(fixture):
    """From the reference's init (carried across): the same rebalance and
    failover lines, the same request count and tokens, every request's
    tokens."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen2-1.5b").reduced()
    params = convert.params_from_numpy(cfg, BR.serving_params(), "cpu")
    got = demo("serve_kvcache").run("cpu", params=params, echo=False)
    want = fixture["serve_kvcache"]
    assert timer_free(got["lines"]) == want["lines"]
    assert got["out_tokens"] == want["out_tokens"]


def test_serving_demo_on_its_own_weights_keeps_the_reference_schedule(fixture):
    """The port's seeded init is not the reference's; what does not
    depend on the weights (no request stops early: moves, failovers,
    counts, steps) is the reference's all the same (what the card is
    held to)."""
    got = demo("serve_kvcache").run("cpu", echo=False)
    lines = timer_free(got["lines"])
    assert lines[:-1] == fixture["serve_kvcache"]["lines"][:-1]
    assert lines[-1].startswith("sample output: [")


def test_training_demo_follows_the_reference(tmp_path, fixture):
    """``--preset tiny --steps 20`` from the reference's initial state: the
    parameter count, every step's rate bit for bit (the schedule's host
    scalars, ROADMAP F18), losses within 1e-4 and gradient norms within
    1e-3 of the reference's (float model path); the checkpoint at step 20
    resumes with nothing left to run."""
    want = fixture["train_lm"]
    state = convert.train_state_from_numpy(BR.train_initial_state(), "cpu")
    TL = demo("train_lm")
    got = TL.run("cpu", steps=want["steps"], preset=want["preset"],
                 ckpt_dir=str(tmp_path), ckpt_every=10, state=state,
                 echo=False)
    assert got["n_params"] == want["n_params"] and got["start"] == 0
    h, w = got["history"], want["history"]
    assert len(h) == len(w) == want["steps"]
    assert [np.float32(x["lr"]) for x in h] == [np.float32(x["lr"]) for x in w]
    np.testing.assert_allclose([x["loss"] for x in h],
                               [x["loss"] for x in w], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose([x["grad_norm"] for x in h],
                               [x["grad_norm"] for x in w], rtol=1e-3)
    again = TL.run("cpu", steps=want["steps"], preset=want["preset"],
                   ckpt_dir=str(tmp_path), echo=False)
    assert again["start"] == want["steps"] and again["history"] == []
    assert again["lines"][1] == f"resumed from step {want['steps']}"


def test_clis_run_on_the_cpu_and_default_to_the_card(capsys):
    """Each demo's ``main`` takes ``--device``; without it the demo runs on
    the card, and where there is none it raises rather than fall back."""
    assert demo("quickstart").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "after failing node 3 — all still found: True" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            demo("quickstart").run()
