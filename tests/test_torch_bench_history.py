"""The port's bench ledger (``repro_torch.benchmarks.history``) against
the reference's (``benchmarks/history.py``): the same headline and
configuration hash of every committed bench document, an append that
never raises, the port's own ledger name, and the CLI."""

import bench_reference as BR  # sets the jax shim before `repro` imports

import json

import pytest

from repro_torch.benchmarks import history as TH

DOCS = ("BENCH_overload.json", "BENCH_metrics.json", "BENCH_dist.json",
        "BENCH_balance.json", "BENCH_replication.json")


@pytest.mark.parametrize("name", DOCS)
def test_headline_and_config_hash_match_the_reference(name):
    JH = BR.PR.load_reference("history")
    doc = json.loads((BR.ROOT / name).read_text())
    bench = TH.bench_name(name)
    assert TH.headline(bench, doc) == JH.headline(bench, doc)
    assert TH.config_hash(doc) == JH.config_hash(doc)


def test_ledger_names_are_the_ports():
    assert TH.HISTORY == "BENCH_torch_HISTORY.jsonl"
    assert TH.HISTORY != BR.PR.load_reference("history").HISTORY
    assert TH.bench_name("out/BENCH_torch_dist.json") == "dist"
    assert TH.bench_name("BENCH_overload.json") == "overload"


def test_append_never_raises(tmp_path):
    """A ledger it cannot write and a document it cannot read both give
    None, as the reference's do; a good append writes one line."""
    JH = BR.PR.load_reference("history")
    bad = str(tmp_path / "missing" / "h.jsonl")
    assert TH.append("x", {"rows": []}, history_path=bad) is None
    assert JH.append("x", {"rows": []}, history_path=bad) is None
    assert TH.append("x", None, history_path=str(tmp_path / "h.jsonl")) is None
    rec = TH.append("dist", {"quick": True, "rows": [{"lost": 2}]},
                    history_path=str(tmp_path / "h.jsonl"), cwd=str(tmp_path))
    assert rec["sha"] == "unknown" and rec["loss"] == 2
    assert TH.load(str(tmp_path / "h.jsonl")) == [rec]


def test_cli_seed_append_show(tmp_path, monkeypatch, capsys):
    """``--seed`` takes the port's ``BENCH_torch_*.json`` only; ``--show``
    prints the reference's table for the same records."""
    JH = BR.PR.load_reference("history")
    monkeypatch.chdir(tmp_path)
    doc = {"quick": True, "rows": [{"mean_throughput": 0.5, "max_p99": 9.0}]}
    (tmp_path / "BENCH_torch_a.json").write_text(json.dumps(doc))
    (tmp_path / "BENCH_b.json").write_text(json.dumps(doc))
    assert TH.main(["--seed"]) == 0
    assert "BENCH_torch_a.json: ok" in capsys.readouterr().out
    assert TH.main(["--append", "BENCH_b.json", "--bench", "b"]) == 0
    recs = TH.load()
    assert [r["bench"] for r in recs] == ["a", "b"]
    assert recs[0]["steady_eps"] == 0.5 and recs[0]["p99"] == 9.0
    capsys.readouterr()
    assert TH.main(["--show"]) == 0
    assert capsys.readouterr().out == JH.fmt(recs) + "\n"
    assert not (tmp_path / "BENCH_HISTORY.jsonl").exists()
