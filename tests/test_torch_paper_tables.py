"""The port's paper evaluation against the reference on the CPU, bit for
bit: fig 13a, fig 13b/c, tables 1-2, the §5.1 migration effect and the §6
pod crossing (``repro_torch.benchmarks.paper_tables``), the CLI's rows
(``repro_torch.benchmarks.run``) and the DES engine bench
(``repro_torch.benchmarks.coordination_bench``); and the committed
fixture of the reference's rows (``tests/data/paper_rows_reference.json``,
the only reference the card sees) against a fresh reference run.  The
reference runs once, in a module fixture the checks share."""

import json

import paper_reference as PR  # sets the jax shim before `repro` imports

import numpy as np
import pytest
import torch

from repro_torch import core as TC
from repro_torch.benchmarks import coordination_bench as TCB
from repro_torch.benchmarks import paper_tables as TPT
from repro_torch.benchmarks import run as TRUN

N_SMALL = 2048
PARTS = ("fig13a", "fig13bc", "tables12", "load_balance", "hierarchy")



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
    """The reference at 2,048 ops: its CLI's simulated rows and every
    figure's own output."""
    return PR.reference_paper(N_SMALL)


@pytest.fixture(scope="module")
def port():
    return {"rows": PR.as_json(TRUN.simulated_rows(N_SMALL, device="cpu")),
            "raw": PR.raw_results(TPT, N_SMALL, device="cpu")}


@pytest.fixture(scope="module")
def fixture():
    return PR.read_fixture()


def test_fixture_equals_a_fresh_reference_run(reference, fixture):
    """The committed rows at 2,048 ops are what the reference gives now
    (the 8,192-op rows come from the same code at another size)."""
    got = fixture["paper"][str(N_SMALL)]
    assert got["rows"] == reference["rows"]
    assert got["raw"] == reference["raw"]
    assert len(got["rows"]) == 71
    assert {fixture["paper"][k]["made_at"] for k in fixture["paper"]} == {
        fixture["balance_quick"]["made_at"]}


@pytest.mark.parametrize("part", PARTS)
def test_paper_results_match_reference(reference, port, part):
    """Each figure's and table's output (throughputs, every BenchResult
    field, the migration and pod-crossing dicts) equals the reference's."""
    assert port["raw"][part] == reference["raw"][part]


def test_cli_simulated_rows_match_reference(reference, port):
    assert port["rows"] == reference["rows"]
    assert [r[0] for r in port["rows"]][-2:] == ["load_balance/zipf1.2",
                                                 "hierarchy/2pods"]


def test_rows_at_8192_equal_the_fixture(fixture):
    """The committed size: the port's rows and raw outputs equal the
    fixture's, as phase ``paper`` of ``chip_smoke.py`` requires of the
    card."""
    f = fixture["paper"]["8192"]
    assert PR.as_json(TRUN.simulated_rows(8192, device="cpu")) == f["rows"]
    assert PR.raw_results(TPT, 8192, device="cpu") == f["raw"]


def test_build_scenarios_with_store_ops_matches_reference():
    """``run_store_ops=True`` routes the load phase and applies both
    phases to a store before the plans; the plans and the result equal
    the reference's."""
    from repro_torch.data.ycsb import WorkloadConfig

    JPT = PR.load_reference("paper_tables")
    # one small tables-1-2 workload: the reference's store compiles for
    # ~10 s whatever the size
    wl = [("zipf-1.2", WorkloadConfig(
        distribution="zipf", zipf_theta=1.2, n_ops=256, n_records=256,
        read_ratio=0.45, update_ratio=0.45, scan_ratio=0.10))]
    scen, plans = TPT.build_scenarios(wl, run_store_ops=True, device="cpu")
    jscen, jplans = JPT.build_scenarios(wl, run_store_ops=True)
    assert [(s[0], s[1]) for s in scen] == [(s[0], s[1]) for s in jscen]
    for (_, _, op, _), (_, _, jop, _) in zip(scen, jscen):
        assert np.array_equal(op, jop)
    for p, jp in zip(plans, jplans):
        for f in ("nodes", "service", "reply_links"):
            assert np.array_equal(getattr(p, f).numpy(),
                                  np.asarray(getattr(jp, f)))
    got = TPT.run_workload(wl[0][1], TC.SERVER_DRIVEN, run_store_ops=True,
                           device="cpu")
    want = JPT.run_workload(wl[0][1], TC.SERVER_DRIVEN, run_store_ops=True)
    assert PR.as_json(got) == PR.as_json(want)


def test_reference_engine_equals_vectorized():
    """The heapq oracle scenario by scenario gives the fused engine's
    latencies and makespans."""
    _, plans = TPT.build_scenarios(TPT.tables12_workloads(512), device="cpu")
    lv, mv = TPT.simulate_scenarios(plans)
    lr, mr = TPT.simulate_scenarios(plans, engine="reference")
    assert mv == mr
    for a, b in zip(lv, lr):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        TPT.simulate_scenarios(plans, engine="fast")


def test_cli_json_matches_reference_cli(reference, tmp_path, capsys):
    """``python -m repro_torch.benchmarks.run --quick --json``: the
    reference's rows in its order and layout.  The simulated rows equal
    the reference CLI's; the engine rows carry the reference's names and
    makespans (their times are this run's); the kernel rows are one note
    line, where the reference prints them."""
    out = tmp_path / "bench.json"
    assert TRUN.main(["--quick", "--device", "cpu", "--json", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    payload = json.loads(out.read_text())
    assert set(payload) == {"meta", "engine_wall_clock", "rows"}
    assert payload["meta"]["device"] == "cpu"
    assert payload["meta"]["n_ops"] == N_SMALL and payload["meta"]["quick"]
    assert payload["meta"]["backends"] == ["native", "reference"]
    rows = [[r["name"], r["us_per_call"], r["derived"]]
            for r in payload["rows"]]
    assert rows[:71] == reference["rows"]
    JCB = PR.load_reference("coordination_bench")
    jdes, _ = JCB.bench_engine(N_SMALL, include_reference=False,
                               include_1m=False)
    assert [r[0] for r in rows[71:]] == [r[0] for r in jdes]
    for got, want in zip(rows[71:73], jdes[:2]):     # closed / open loop
        assert got[2] == want[2]                      # "makespan=..."
    assert rows[73][2].split(";")[0] == jdes[2][2].split(";")[0] == "scenarios=57"
    note = lines.index(TRUN.KERNEL_ROWS_NOTE)
    assert lines[note - 1].startswith("hierarchy/2pods,")
    assert lines[note + 1].startswith("des/closed_loop/")


def test_bench_engine_is_bitexact_at_small_size():
    rows, wall = TCB.bench_engine(N_SMALL, include_1m=False, device="cpu")
    assert wall["backend"] == "native"
    assert [r[0] for r in rows] == [f"des/closed_loop/B{N_SMALL}",
                                    f"des/open_loop/B{N_SMALL}",
                                    f"des/fused_sweep/S57/B{N_SMALL}"]
    assert all("bitexact=True" in r[2] for r in rows[:2])
    assert "speedup_vs_reference=" in rows[2][2]
    assert {f"sweep57_B{N_SMALL}_reference_s",
            f"closed_B{N_SMALL}_reference_s"} <= set(wall)


@pytest.mark.parametrize("name", ["PodTable", "derive_pod_table", "route_pod",
                                  "DistConfig", "make_dist_apply"])
def test_core_reexports_like_the_reference(name):
    """``repro_torch.core`` re-exports the hierarchy and dist-store names
    the reference's ``repro.core`` does."""
    from repro import core as JC
    from repro_torch.core import dist_store, hierarchy

    home = hierarchy if hasattr(hierarchy, name) else dist_store
    assert getattr(TC, name) is getattr(home, name)
    assert name in TC.__all__ and name in JC.__all__


def test_paper_entries_need_a_card_without_device():
    """``device=None`` means the card; without one the entries raise
    rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPT.hierarchy_stats(64)
