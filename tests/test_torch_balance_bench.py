"""The port's load-balancing gate matrix
(``repro_torch.benchmarks.balance_bench``) against the reference's
(``benchmarks/balance_bench.py``) on the CPU: the ``--quick`` row of
``shifting_hotspot`` x ``full_adaptive`` column for column, the gates'
findings on real and broken rows, and the committed fixture's balance
rows (``tests/data/paper_rows_reference.json``, what the card is held
to) against a fresh reference run.  The reference runs once, in a module
fixture the checks share (~15 s, most of it jit)."""

import paper_reference as PR  # sets the jax shim before `repro` imports

import pytest
import torch

from repro_torch.benchmarks import balance_bench as TBB

# every column of the reference's row is compared but wall_s, the run's
# own clock (PR.BALANCE_WALL), and host_syncs: a profile counter of each
# package's own device-to-host round trips, which the two drivers make at
# different points (28 in the reference's quick run, 16 in the port's),
# not a result of the run
NOT_COMPARED = ("host_syncs",)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are small: torch's intra-op threads buy
    nothing on them and compete with the reference's compiles and the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def reference():
    """The reference's --quick rows of shifting_hotspot x {frozen,
    full_adaptive}, wall_s left out."""
    return PR.reference_balance_rows()


@pytest.fixture(scope="module")
def port_row():
    rows = TBB.run_matrix(["shifting_hotspot"], ["full_adaptive"], True,
                          verbose=False, device="cpu")
    assert len(rows) == 1
    return PR.as_json(PR.strip_wall(rows))[0]


def test_fixture_balance_rows_equal_a_fresh_reference_run(reference):
    got = PR.read_fixture()["balance_quick"]
    assert got["rows"] == reference
    assert [r["policy"] for r in reference] == list(PR.BALANCE_POLICIES)


def test_quick_row_matches_reference_column_for_column(reference, port_row):
    want = reference[1]
    assert want["policy"] == "full_adaptive"
    assert port_row.keys() == want.keys()
    for k in want.keys() - set(NOT_COMPARED):
        assert port_row[k] == want[k], k


def test_constants_and_configs_match_reference():
    JBB = PR.load_reference("balance_bench")
    assert TBB.DEFAULT_POLICIES == JBB.DEFAULT_POLICIES
    assert TBB.DEFAULT_SCENARIOS == JBB.DEFAULT_SCENARIOS
    assert TBB.DEFAULT_PERIOD == JBB.DEFAULT_PERIOD
    for quick in (True, False):
        s, js = TBB.scenario_config(quick), JBB.scenario_config(quick)
        assert PR.as_json(s) == PR.as_json(js)
        c, jc = (TBB.cluster_config(quick, "lognormal", "auto"),
                 JBB.cluster_config(quick, "lognormal", "auto"))
        for f in ("num_nodes", "num_ranges", "replication", "r_max",
                  "n_clients", "report_every", "imbalance_threshold",
                  "max_moves_per_round"):
            assert getattr(c, f) == getattr(jc, f), f
        assert c.service_model.kind == jc.service_model.kind == "lognormal"
        for name in TBB.DEFAULT_SCENARIOS + ("ycsb_a", "stationary"):
            assert (TBB.scenario_kwargs(name, s)
                    == JBB.scenario_kwargs(name, js))


def test_gates_pass_and_fail_like_the_reference(reference, port_row):
    """``check_acceptance`` on the real rows (empty), and on broken rows
    the reference's findings ("traced" in the reference's wording is
    "built" in the port's), at the quick and the full splitting gate."""
    JBB = PR.load_reference("balance_bench")
    rows = [reference[0], port_row]
    for quick in (True, False):
        assert TBB.check_acceptance(rows, quick=quick) == []
        assert JBB.check_acceptance(rows, quick=quick) == []
    frozen, adaptive = (dict(r) for r in rows)
    adaptive["mean_imbalance"] = frozen["mean_imbalance"]   # not below
    adaptive["mean_p99"] = frozen["mean_p99"] + 1.0
    adaptive["traces"] = 2
    migrate = dict(frozen, scenario="multi_hotspot", policy="migrate",
                   mean_imbalance=2.0, total_migration_entries=100)
    split = dict(frozen, scenario="multi_hotspot", policy="split_hot",
                 mean_imbalance=2.0, total_migration_entries=101,
                 growth_events=1, traces=2)
    bad = [frozen, adaptive, migrate, split]
    for quick in (True, False):
        got = TBB.check_acceptance(bad, quick=quick)
        want = [p.replace("traced", "built")
                for p in JBB.check_acceptance(bad, quick=quick)]
        assert got == want
        assert len(got) == (4 if quick else 5)


def test_cli_writes_rows_and_passes_its_gates(tmp_path, capsys):
    """``python -m repro_torch.benchmarks.balance_bench --quick`` on the
    fixture's pair: the reference's JSON layout plus the device in
    ``meta``, ``steady_eps`` measured, the gates passed (exit 0)."""
    import json

    out = tmp_path / "balance.json"
    assert TBB.main(["--quick", "--scenarios", PR.BALANCE_SCENARIO,
                     "--policies", ",".join(PR.BALANCE_POLICIES),
                     "--device", "cpu", "--json", str(out)]) == 0
    assert "acceptance: full_adaptive < frozen" in capsys.readouterr().out
    got = json.loads(out.read_text())
    assert set(got) == {"quick", "service", "meta", "rows"}
    assert got["quick"] and got["service"] == "fixed"
    assert got["meta"] == {"device": "cpu"}
    assert [r["policy"] for r in got["rows"]] == list(PR.BALANCE_POLICIES)
    assert all(r["steady_eps"] > 0 for r in got["rows"])


# ---------------------------------------------------------------------------
# the extras: --profile, --trace, --dist, --replication
# ---------------------------------------------------------------------------

import bench_reference as BR  # noqa: E402

from repro_torch.benchmarks import compare  # noqa: E402


@pytest.fixture(scope="module")
def port_extras(tmp_path_factory):
    """The port's --quick extras: rows (full columns) and findings."""
    out = tmp_path_factory.mktemp("balance")
    from repro_torch.replication import bench as RB

    profile, prob_profile = TBB.run_profile(True, device="cpu")
    trace, prob_trace = TBB.run_trace(True, str(out / TBB.TRACE_ARTIFACT),
                                      device="cpu")
    dist = TBB.run_dist_parity(True, device="cpu")
    repl = RB.run_replication_matrix(True, verbose=False, device="cpu")
    filt = RB.run_filter_arm(True, verbose=False, device="cpu")
    return {"profile": profile, "trace": trace, "dist": dist,
            "replication": repl + filt,
            "problems": {"profile": prob_profile, "trace": prob_trace,
                         "dist": TBB.check_dist(dist),
                         "replication": RB.check_replication(repl)
                         + RB.check_filter_arm(filt)}}


@pytest.mark.parametrize("part", ["profile", "trace", "dist", "replication"])
def test_quick_extra_rows_match_the_reference_fixture(part, port_extras):
    want = BR.read_fixture()["balance_extras"]["quick"][part]
    got = compare.comparable(port_extras[part])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == w[k], (part, w.get("scenario"), w.get("policy"), k)


def test_fixture_matches_a_fresh_reference_trace_row():
    """The cheapest extra (the telemetry parity pair), regenerated."""
    fresh = BR.balance_extras(True, parts=("trace",))["trace"]
    assert fresh == BR.read_fixture()["balance_extras"]["quick"]["trace"]


def test_extras_findings_match_the_reference(port_extras):
    """The trace and dist gates pass; the replication gates find what the
    reference's find at --quick (its own two findings there); the
    profile's host-sync gate passes (its ratio gate is a wall clock's)."""
    p = port_extras["problems"]
    assert p["trace"] == [] and p["dist"] == []
    assert p["replication"] == (
        BR.read_fixture()["balance_extras"]["quick"]["replication_problems"])
    assert not [x for x in p["profile"] if "host syncs" in x]
    grow = [r for r in port_extras["dist"] if r.get("bench") == "dist_growth"]
    assert len(grow) == 1 and grow[0]["growth_events"] >= 1
    assert [r["traces"] for r in port_extras["dist"]] == [
        1 + r["growth_events"] for r in port_extras["dist"]]
    ratios = TBB.profile_ratios(port_extras["profile"])
    assert set(ratios) == set(TBB.PROFILE_POLICIES)


def test_extras_gates_fail_on_broken_rows(port_extras):
    """``check_dist``: a rebuilt step and a pool that never grew; the
    profile rows' host-sync finding, as the reference words them."""
    rows = [dict(r) for r in port_extras["dist"]]
    rows[0]["traces"] = 2
    grow = next(r for r in rows if r.get("bench") == "dist_growth")
    grow.update(growth_events=0, traces=1)
    assert TBB.check_dist(rows) == [
        f"dist {rows[0]['scenario']}/{rows[0]['policy']}: traces 2 != "
        "1 + growth_events (1)",
        "keyspace_growth --dist never grew the pool under capacity pressure"]


def test_constants_of_the_extras_match_the_reference():
    JBB = PR.load_reference("balance_bench")
    for name in ("DIST_SCENARIO", "DIST_POLICIES", "PROFILE_SCENARIO",
                 "PROFILE_POLICIES", "PROFILE_RATIO_GATE",
                 "PROFILE_RATIO_GATE_QUICK", "TRACE_SCENARIO",
                 "TRACE_POLICY"):
        assert getattr(TBB, name) == getattr(JBB, name), name


def test_cli_extras_json_and_exit_code(tmp_path, monkeypatch, capsys):
    """``--quick --profile --trace --dist --replication`` on the fixture's
    pair: the JSON holds every extra's rows, the trace under the port's
    name; exit 1, as the reference's at --quick, whose replication gates
    find what they find here."""
    import json

    monkeypatch.chdir(tmp_path)
    rc = TBB.main(["--quick", "--scenarios", PR.BALANCE_SCENARIO,
                   "--policies", ",".join(PR.BALANCE_POLICIES),
                   "--profile", "--trace", "--dist", "--replication",
                   "--per-epoch", "--device", "cpu",
                   "--json", "BENCH_torch_balance.json"])
    out = capsys.readouterr().out
    assert rc == 1 and "ACCEPTANCE FAILED" in out and "replication" in out
    doc = json.loads((tmp_path / "BENCH_torch_balance.json").read_text())
    rows = doc["rows"]
    assert [r["fused"] for r in rows[:2]] == [False, False]
    assert sum(1 for r in rows if r.get("profile")) == 4
    assert sum(1 for r in rows if r.get("trace")) == 1
    assert sum(1 for r in rows if r.get("backend") == "dist") == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "BENCH_torch_HISTORY.jsonl", "BENCH_torch_balance.json",
        "TRACE_torch_balance.json"]
