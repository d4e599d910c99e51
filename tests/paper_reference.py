"""The reference's paper rows: the yardstick the port's evaluation is held
to, on the CPU here and (through the committed fixture) on the card.

The reference benches (``benchmarks/paper_tables.py``, ``run.py``,
``coordination_bench.py``, ``balance_bench.py`` at the repo root) are
loaded from their files and registered in ``sys.modules`` under their
own names before they run: ``BenchResult`` is a dataclass, and
``dataclasses`` looks its module up there.

Regenerate ``tests/data/paper_rows_reference.json`` (the reference's
simulated rows at 8,192 and 2,048 ops a workload, raw and as the CLI's
CSV rows, and the ``--quick`` gate-matrix rows of ``shifting_hotspot`` x
{``frozen``, ``full_adaptive``}, each with the ``src/repro`` commit it was
made at) with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/paper_reference.py

``tests/test_torch_paper_tables.py`` and ``test_torch_balance_bench.py``
regenerate the 2,048-op and the balance rows and require the fixture to
equal them, so it cannot go stale unseen.
"""

import dataclasses
import importlib.util
import json
import pathlib
import subprocess
import sys

import jax
import jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
    for _m in sorted(m for m in sys.modules if m.startswith("repro.")):
        if _m.rpartition(".")[0] not in sys.modules:
            del sys.modules[_m]

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "paper_rows_reference.json"
FIXTURE_OPS = (8192, 2048)
BALANCE_SCENARIO = "shifting_hotspot"
BALANCE_POLICIES = ("frozen", "full_adaptive")
# run-to-run columns, left out of the fixture and of every comparison
BALANCE_WALL = ("wall_s",)


def load_reference(name: str):
    """``benchmarks/<name>.py`` as the module ``benchmarks.<name>``."""
    full = f"benchmarks.{name}"
    if full in sys.modules:
        return sys.modules[full]
    spec = importlib.util.spec_from_file_location(
        full, ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[full]
        raise
    return mod


def as_json(x):
    """``x`` as it reads back from JSON (tuples as lists, dataclasses as
    dicts): the form the fixture holds."""
    if dataclasses.is_dataclass(x):
        x = dataclasses.asdict(x)
    return json.loads(json.dumps(x, default=lambda o: dataclasses.asdict(o)))


def raw_results(PT, n_ops: int, **kw) -> dict:
    """Every figure's and table's own output from a paper_tables module
    (the reference's or the port's; ``kw`` passes the port's device)."""
    return as_json({
        "fig13a": PT.fig13a_throughput_vs_skew(n_ops, **kw),
        "fig13bc": PT.fig13bc_throughput_vs_write_ratio(n_ops, **kw),
        "tables12": PT.tables12_latency(n_ops, **kw),
        "load_balance": PT.load_balance_effect(n_ops, **kw),
        "hierarchy": PT.hierarchy_stats(n_ops, **kw),
    })


def reference_rows(n_ops: int) -> list:
    """The reference CLI's simulated rows (all but its kernel and ``des/*``
    rows) at ``n_ops``, as ``[name, us_per_call, derived]``."""
    RUN = load_reference("run")
    load_reference("paper_tables")
    start = len(RUN._ROWS)
    RUN.table_fig13a(n_ops, "vectorized")
    RUN.table_fig13bc(n_ops, "vectorized")
    RUN.tables_1_2(n_ops, "vectorized")
    RUN.table_load_balance(n_ops)
    RUN.table_hierarchy(n_ops)
    return as_json(RUN._ROWS[start:])


def reference_paper(n_ops: int) -> dict:
    return {"rows": reference_rows(n_ops),
            "raw": raw_results(load_reference("paper_tables"), n_ops)}


def strip_wall(rows: list) -> list:
    return [{k: v for k, v in r.items() if k not in BALANCE_WALL}
            for r in rows]


def reference_balance_rows() -> list:
    """The reference's ``--quick`` gate-matrix rows of the fixture's pair."""
    BB = load_reference("balance_bench")
    return as_json(strip_wall(BB.run_matrix(
        [BALANCE_SCENARIO], list(BALANCE_POLICIES), True, verbose=False)))


def src_repro_commit() -> str:
    return subprocess.run(
        ["git", "rev-list", "-1", "HEAD", "--", "src/repro", "benchmarks"],
        cwd=ROOT, capture_output=True, text=True, check=True).stdout.strip()


def read_fixture() -> dict:
    return json.loads(FIXTURE.read_text())


def main() -> int:
    made_at = src_repro_commit()
    out = {
        "about": "the reference's rows (src/repro on the CPU); see "
                 "tests/paper_reference.py",
        "paper": {str(n): {"made_at": made_at, "n_ops": n,
                           **reference_paper(n)} for n in FIXTURE_OPS},
        "balance_quick": {"made_at": made_at, "scenario": BALANCE_SCENARIO,
                          "policies": list(BALANCE_POLICIES),
                          "rows": reference_balance_rows()},
    }
    FIXTURE.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {FIXTURE}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
