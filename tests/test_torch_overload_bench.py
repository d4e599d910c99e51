"""The port's overload-survival bench
(``repro_torch.benchmarks.overload_bench``) against the reference's
(``benchmarks/overload_bench.py``) on the CPU: the ``--quick`` matrix and
trace rows column for column against the fixture
(``tests/data/bench_rows_reference.json``, the reference's rows with the
clock's columns left out), the fixture's cheapest row against a fresh
reference run, the survival gate on real and broken rows, and the CLI."""

import bench_reference as BR  # sets the jax shim before `repro` imports

import json

import pytest
import torch

from repro_torch.benchmarks import compare
from repro_torch.benchmarks import overload_bench as TOB


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads buy nothing here and compete
    with the reference's compiles and the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_rows(tmp_path_factory):
    """The port's --quick matrix and trace rows (all rows, full columns)."""
    out = tmp_path_factory.mktemp("overload")
    rows = TOB.run_matrix(list(TOB.SCENARIOS), True, verbose=False,
                          device="cpu")
    trace_rows, problems = TOB.run_trace(True, str(out), device="cpu")
    assert problems == []
    return rows + trace_rows


def test_quick_rows_match_the_reference_fixture(port_rows):
    want = BR.read_fixture()["overload"]["quick"]
    got = compare.comparable(port_rows)
    assert [(r["scenario"], r["arm"]) for r in got] == [
        (r["scenario"], r["arm"]) for r in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == w[k], (w["scenario"], w["arm"], k)


def test_fixture_matches_a_fresh_reference_row(monkeypatch):
    """The cheapest row (cascade_failure, plain arm), regenerated."""
    JOB = BR.PR.load_reference("overload_bench")
    monkeypatch.setattr(JOB, "ARMS", (("plain", "full_adaptive"),))
    fresh = BR.overload_rows(True, scenarios=["cascade_failure"],
                             trace=False)
    want = BR.read_fixture()["overload"]["quick"]
    assert fresh == [r for r in want if not r.get("trace")
                     and (r["scenario"], r["arm"]) == ("cascade_failure",
                                                       "plain")]


def test_constants_and_configs_match_the_reference():
    JOB = BR.PR.load_reference("overload_bench")
    assert TOB.SCENARIOS == JOB.SCENARIOS and TOB.ARMS == JOB.ARMS
    assert TOB.P999_BOUND == JOB.P999_BOUND
    assert TOB.BACKLOG_FRAC == JOB.BACKLOG_FRAC
    assert TOB.ATTRIB_Q == JOB.ATTRIB_Q
    assert (TOB.TRACE_SCENARIO, TOB.TRACE_ARM) == (JOB.TRACE_SCENARIO,
                                                   JOB.TRACE_ARM)
    for quick in (True, False):
        assert (BR.PR.as_json(TOB.scenario_config(quick))
                == BR.PR.as_json(JOB.scenario_config(quick)))
        assert (BR.PR.as_json(TOB.overload_config(quick))
                == BR.PR.as_json(JOB.overload_config(quick)))
        c, jc = TOB.cluster_config(quick), JOB.cluster_config(quick)
        for f in ("num_nodes", "num_ranges", "replication", "standby_nodes",
                  "report_every"):
            assert getattr(c, f) == getattr(jc, f), f


def test_survival_gate_passes_and_fails_like_the_reference(port_rows):
    """``check_survival`` on the real rows (empty), and on broken ones the
    reference's findings ("compiled" in its wording is "built" in the
    port's)."""
    JOB = BR.PR.load_reference("overload_bench")
    rows = [dict(r) for r in port_rows]
    assert TOB.check_survival(rows, quick=True) == []
    assert JOB.check_survival(rows, quick=True) == []
    by = {(r.get("scenario"), r.get("arm"), bool(r.get("trace"))): r
          for r in rows}
    ctrl = by[("cascade_failure", "controlled", False)]
    ctrl.update(lost=3, autoscale_events=[], conservation_gap=2, traces=2)
    plain = by[("retry_storm", "plain", False)]
    plain.update(lost=0, retry_backlog=0, max_p999=1.0)
    for quick in (True, False):
        got = sorted(TOB.check_survival(rows, quick=quick))
        want = sorted(p.replace("compiled", "built")
                      for p in JOB.check_survival(rows, quick=quick))
        assert got == want and len(got) == 5


def test_cli_writes_port_artifacts_only(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.benchmarks.overload_bench --quick --trace``
    on one scenario, run where the reference writes its own artifacts:
    the JSON, the history line and the two trace artifacts under the
    port's names, no reference file, exit 0 with the gate passed."""
    monkeypatch.chdir(tmp_path)
    assert TOB.main(["--quick", "--scenarios", "cascade_failure", "--trace",
                     "--device", "cpu", "--json",
                     "BENCH_torch_overload.json"]) == 0
    assert "survival gate: controlled arm lost 0" in capsys.readouterr().out
    doc = json.loads((tmp_path / "BENCH_torch_overload.json").read_text())
    assert set(doc) == {"quick", "meta", "rows"}
    assert doc["meta"] == {"device": "cpu"} and doc["quick"]
    assert [r.get("arm") for r in doc["rows"]] == ["plain", "controlled",
                                                   "controlled"]
    hist = (tmp_path / "BENCH_torch_HISTORY.jsonl").read_text().splitlines()
    assert len(hist) == 1 and json.loads(hist[0])["bench"] == "overload"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ATTRIB_torch_retry_storm.json", "BENCH_torch_HISTORY.jsonl",
        "BENCH_torch_overload.json", "TRACE_torch_overload.json"]
    attrib = json.loads((tmp_path / "ATTRIB_torch_retry_storm.json")
                        .read_text())
    assert attrib["spans"] > 0 and "share" in attrib["attribution"]


def test_cli_fails_its_gate_like_the_reference(tmp_path, monkeypatch, capsys):
    """A tail bound no run meets fails the gate: exit 1, the finding
    printed, nothing written without ``--json``."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(TOB, "P999_BOUND", {True: 0.0, False: 0.0})
    assert TOB.main(["--quick", "--scenarios", "cascade_failure",
                     "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "SURVIVAL GATE FAILED" in out
    assert "cascade_failure/controlled did not survive" in out
    assert list(tmp_path.iterdir()) == []
