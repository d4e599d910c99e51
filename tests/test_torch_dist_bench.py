"""The port's scale-out bench (``repro_torch.benchmarks.dist_bench``)
against the reference's (``benchmarks/dist_bench.py``) on the CPU: the
four ``--quick`` rows column for column against the fixture
(``tests/data/bench_rows_reference.json``; the reference's rows need 8
forced XLA host devices in a subprocess, so they come from the fixture
alone), the parity gate, the ratio and syncs gates on real and broken
rows against the reference's ``check``, and the CLI's JSON and exit
code."""

import bench_reference as BR  # sets the jax shim before `repro` imports

import json

import pytest
import torch

from repro_torch.benchmarks import compare
from repro_torch.benchmarks import dist_bench as TDB


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads buy nothing here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_run():
    return TDB.run(True, device="cpu")


def test_quick_rows_match_the_reference_fixture(port_run):
    rows, problems = port_run
    assert problems == []
    want = BR.read_fixture()["dist"]["quick"]["rows"]
    got = compare.comparable(rows)
    assert [r["variant"] for r in got] == [
        "single_host", "single_host_fused", "dist_epoch", "dist_fused"]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == w[k], (w["variant"], k)
    assert all(set(r["stage_s"]) for r in rows)


def test_constants_match_the_reference():
    JDB = BR.PR.load_reference("dist_bench")
    assert (TDB.SCENARIO, TDB.POLICY, TDB.RATIO_GATE) == (
        JDB.SCENARIO, JDB.POLICY, JDB.RATIO_GATE)


def test_gates_pass_and_fail_like_the_reference(port_run, capsys):
    """``check`` (ratio and syncs) on rows whose epochs/s pass, and on rows
    that break each gate: the reference's findings."""
    JDB = BR.PR.load_reference("dist_bench")
    rows = [dict(r) for r in port_run[0]]
    by = {r["variant"]: r for r in rows}
    by["single_host"]["steady_eps"] = 1.5 * by["dist_fused"]["steady_eps"]
    assert TDB.check(rows) == JDB.check(rows) == []
    by["single_host"]["steady_eps"] = 3.0 * by["dist_fused"]["steady_eps"]
    by["dist_fused"]["host_syncs_per_epoch"] = (
        by["dist_epoch"]["host_syncs_per_epoch"] + 1)
    got = TDB.check(rows)
    assert got == JDB.check(rows) and len(got) == 2
    assert got[0].startswith("ratio: single-host is 3.00x")
    assert TDB.ratios(rows)[0] == pytest.approx(3.0)
    capsys.readouterr()


def test_cli_json_history_and_exit_code(tmp_path, monkeypatch, capsys):
    """The CLI's exit code is its gates' verdict (the ratio gate is a
    wall-clock one: on the CPU it may go either way); the JSON holds the
    four rows and the device."""
    monkeypatch.chdir(tmp_path)
    rc = TDB.main(["--quick", "--device", "cpu",
                   "--json", "BENCH_torch_dist.json"])
    out = capsys.readouterr().out
    doc = json.loads((tmp_path / "BENCH_torch_dist.json").read_text())
    assert doc["meta"] == {"device": "cpu"} and len(doc["rows"]) == 4
    problems = TDB.check(doc["rows"])
    assert rc == (1 if problems else 0)
    assert ("ACCEPTANCE FAILED" in out) == bool(problems)
    hist = (tmp_path / "BENCH_torch_HISTORY.jsonl").read_text().splitlines()
    assert json.loads(hist[0])["bench"] == "dist"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "BENCH_torch_HISTORY.jsonl", "BENCH_torch_dist.json"]
    assert TDB.main(["--quick", "--device", "cpu", "--no-check"]) == 0
