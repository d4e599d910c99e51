"""The port's metrics-plane bench (``repro_torch.benchmarks.metrics_bench``)
against the reference's (``benchmarks/metrics_bench.py``) on the CPU: the
``--quick`` parity and breach rows column for column against the fixture
(``tests/data/bench_rows_reference.json``), the fixture's breach row
against a fresh reference run, the gates on real and broken runs, and the
CLI's artifacts under the port's names."""

import bench_reference as BR  # sets the jax shim before `repro` imports

import json

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import compare
from repro_torch.benchmarks import metrics_bench as TMB


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads buy nothing here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("metrics")
    rows_p, prob_p = TMB.run_parity(True, device="cpu")
    rows_b, prob_b = TMB.run_breach(True, str(out), device="cpu")
    return rows_p + rows_b, prob_p, prob_b, out


def test_quick_rows_match_the_reference_fixture(port_run):
    rows, prob_p, prob_b, _ = port_run
    assert prob_p == [] and prob_b == []
    want = BR.read_fixture()["metrics"]["quick"]["rows"]
    got = compare.comparable(rows)
    assert [r["bench"] for r in got] == ["metrics_parity", "metrics_breach"]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == w[k], (w["bench"], k)
    assert got[1]["fire_epochs"] == got[1]["ref_fire_epochs"] != []


def test_fixture_matches_a_fresh_reference_breach_row():
    JMB = BR.PR.load_reference("metrics_bench")
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        rows, problems = JMB.run_breach(True, d)
    assert problems == []
    want = BR.read_fixture()["metrics"]["quick"]["rows"][1]
    assert compare.comparable(rows) == [want]


def test_configs_match_the_reference():
    JMB = BR.PR.load_reference("metrics_bench")
    for quick in (True, False):
        assert (BR.PR.as_json(TMB.scenario_config(quick))
                == BR.PR.as_json(JMB.scenario_config(quick)))
        assert (BR.PR.as_json(TMB.slo_spec(quick))
                == BR.PR.as_json(JMB.slo_spec(quick)))


def test_artifacts_take_the_port_names(port_run):
    """The incident report, the view, the dashboard and the flight dump in
    the out dir; the incident complete; the view's OpenMetrics rows."""
    rows, _, _, out = port_run
    names = sorted(p.name for p in out.iterdir())
    assert names == ["DASH_torch_metrics.txt",
                     "INCIDENT_torch_metrics_smoke.json",
                     "INCIDENT_torch_metrics_smoke.md",
                     "METRICS_torch_view.json",
                     "flight_retry_storm_full_adaptive_0.json"]
    doc = json.loads((out / "INCIDENT_torch_metrics_smoke.json").read_text())
    assert doc["alerts"]["fires"] == rows[1]["alert_fires"] >= 1
    assert "fire" in (out / "DASH_torch_metrics.txt").read_text()


def test_breach_gate_fails_on_a_wrong_oracle(tmp_path, monkeypatch):
    """Alerts that disagree with the numpy oracle fail the alert gate, as
    the reference's: the finding, and ``alert_epoch_ok`` false in the
    bench JSON."""
    from repro_torch.telemetry import slo as SLOM

    real = SLOM.reference_alerts

    def shifted(values, spec):
        got = real(values, spec)
        return dict(got, fire_epochs=[e + 1 for e in got["fire_epochs"]])

    monkeypatch.setattr(SLOM, "reference_alerts", shifted)
    rows, problems = TMB.run_breach(True, str(tmp_path), device="cpu")
    assert len(problems) == 1 and problems[0].startswith(
        "breach: alert firing epochs")
    doc = TMB.gate_doc(True, rows, [], problems)
    assert (doc["parity_ok"], doc["alert_epoch_ok"],
            doc["incident_complete"]) == (True, False, True)


def test_parity_gate_fails_when_the_ring_perturbs_the_stream(monkeypatch):
    """A ring that changed the stream it observes fails the parity gate."""
    from repro_torch.cluster import metrics as CM

    real = CM.EpochMetrics.to_row
    calls = {"n": 0}

    def noisy(self):
        calls["n"] += 1
        row = real(self)
        if calls["n"] == 1:           # the first row of the metrics-off run
            row = dict(row, p99=row["p99"] + 1.0)
        return row

    monkeypatch.setattr(CM.EpochMetrics, "to_row", noisy)
    _, problems = TMB.run_parity(True, device="cpu")
    assert problems == ["parity: metrics-on EpochMetrics rows differ from "
                        "metrics-off (the ring perturbed the stream it "
                        "observes)"]


def test_cli_writes_port_artifacts_only(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert TMB.main(["--quick", "--device", "cpu",
                     "--json", "BENCH_torch_metrics.json"]) == 0
    assert "metrics gates: OK" in capsys.readouterr().out
    doc = json.loads((tmp_path / "BENCH_torch_metrics.json").read_text())
    assert (doc["parity_ok"], doc["alert_epoch_ok"],
            doc["incident_complete"]) == (True, True, True)
    assert doc["meta"] == {"device": "cpu"} and len(doc["rows"]) == 2
    hist = [json.loads(x) for x in
            (tmp_path / "BENCH_torch_HISTORY.jsonl").read_text().splitlines()]
    assert len(hist) == 1 and hist[0]["bench"] == "metrics"
    assert hist[0]["parity_ok"] is True
    names = {p.name for p in tmp_path.iterdir()}
    assert not names & {"INCIDENT_metrics_smoke.json", "METRICS_view.json",
                        "DASH_metrics.txt", "BENCH_metrics.json",
                        "BENCH_HISTORY.jsonl"}
    assert "INCIDENT_torch_metrics_smoke.json" in names
    np.testing.assert_equal(doc["rows"][1]["fire_epochs"],
                            doc["rows"][1]["ref_fire_epochs"])
