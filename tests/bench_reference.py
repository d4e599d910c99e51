"""The reference's rows of the repo-root benches and demos: the yardstick
the port's benches (``repro_torch.benchmarks.{overload,metrics,dist,
balance}_bench``) and demos (``repro_torch.examples``) are held to, on the
CPU here and, through the committed fixture, on the card.

The fixture ``tests/data/bench_rows_reference.json`` holds, at the
``--quick`` and the default sizes: the overload bench's matrix and trace
rows, the metrics bench's parity and breach rows, the dist bench's four
rows (the reference runs them in a subprocess on 8 forced XLA host
devices), the balance bench's ``--profile``, ``--trace``, ``--dist`` and
``--replication`` rows; and the six demos' printed lines (with the
reference's own weights, the serving demo's tokens and the training
demo's per-step loss, rate and gradient norm).  Columns that a run's
clock or its host syncs decide (``RUN_COLUMNS``) are left out, and an
artifact's path keeps its file name only.  Regenerate it (~10 minutes)
with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/bench_reference.py

The tests regenerate the cheapest row of each bench from the reference
and require the fixture to equal it, so it cannot go stale unseen.
"""

import contextlib
import io
import json
import os
import runpy
import subprocess
import sys
import tempfile

import paper_reference as PR  # sets the jax shim before `repro` imports

from repro_torch.benchmarks.compare import RUN_COLUMNS, comparable
from repro_torch.examples._common import timer_free

ROOT = PR.ROOT
FIXTURE = ROOT / "tests" / "data" / "bench_rows_reference.json"
SIZES = {"quick": True, "default": False}
DEMOS = ("quickstart", "failover_demo", "balance_demo", "trace_demo",
         "serve_kvcache")
# the training demo's fixture run (its CI size; chip_smoke.py runs it so)
TRAIN_PRESET, TRAIN_STEPS = "tiny", 20


# ---------------------------------------------------------------------------
# the benches
# ---------------------------------------------------------------------------


def overload_rows(quick: bool, scenarios=None, trace: bool = True) -> list:
    OB = PR.load_reference("overload_bench")
    rows = OB.run_matrix(list(scenarios or OB.SCENARIOS), quick,
                         verbose=False)
    if trace:
        with tempfile.TemporaryDirectory() as d, contextlib.chdir(d), \
                contextlib.redirect_stdout(io.StringIO()):
            trace_rows, problems = OB.run_trace(quick)
        assert not problems, problems
        rows += trace_rows
    return comparable(rows)


def metrics_rows(quick: bool) -> dict:
    MB = PR.load_reference("metrics_bench")
    rows, problems = MB.run_parity(quick)
    with tempfile.TemporaryDirectory() as d:
        rows_b, prob_b = MB.run_breach(quick, d)
    assert not problems + prob_b, problems + prob_b
    rows += rows_b
    return {"rows": comparable(rows)}


def _mesh_subprocess(code: str) -> dict:
    """Run ``code`` (which prints one JSON line last) in a subprocess on 8
    forced XLA host devices, the shim set, the reference benches loaded."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               + os.environ.get("XLA_FLAGS", ""),
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "tests"), str(ROOT / "src"), str(ROOT)]))
    # jax 0.9's make_mesh defaults to explicit axes, under which the
    # reference's sharded scatters do not trace; its benches were written
    # for the automatic axes that tests/test_torch_dist_driver.py names
    head = ("import sys, json, io, contextlib\n"
            "import paper_reference as PR\n"
            "import jax\n"
            "_make_mesh = jax.make_mesh\n"
            "def _auto_mesh(shape, names, **kw):\n"
            "    kw.setdefault('axis_types', (jax.sharding.AxisType.Auto,)"
            " * len(shape))\n"
            "    return _make_mesh(shape, names, **kw)\n"
            "jax.make_mesh = _auto_mesh\n")
    res = subprocess.run([sys.executable, "-c", head + code], env=env,
                         capture_output=True, text=True, cwd=str(ROOT),
                         timeout=3000)
    if res.returncode != 0:
        raise RuntimeError(f"reference mesh run failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def dist_rows(quick: bool) -> dict:
    """The dist bench's four rows and its parity findings (the worker)."""
    got = _mesh_subprocess(
        "PR.load_reference('balance_bench')\n"
        "DB = PR.load_reference('dist_bench')\n"
        f"DB.worker({quick})\n")
    assert not got["problems"], got["problems"]
    return {"rows": comparable(got["rows"])}


def balance_dist_rows(quick: bool) -> list:
    got = _mesh_subprocess(
        "BB = PR.load_reference('balance_bench')\n"
        f"BB.dist_worker({quick})\n")
    return comparable(got["rows"])


def balance_extras(quick: bool, parts=("profile", "trace", "dist",
                                       "replication")) -> dict:
    BB = PR.load_reference("balance_bench")
    out = {}
    if "profile" in parts:
        with contextlib.redirect_stdout(io.StringIO()):
            rows, _ = BB.run_profile(quick)  # its ratio gate is a clock's
        out["profile"] = comparable(rows)
    if "trace" in parts:
        with tempfile.TemporaryDirectory() as d, \
                contextlib.redirect_stdout(io.StringIO()):
            rows, problems = BB.run_trace(quick, f"{d}/TRACE_balance.json")
        assert not problems, problems
        out["trace"] = comparable(rows)
    if "dist" in parts:
        out["dist"] = balance_dist_rows(quick)
    if "replication" in parts:
        from repro.replication import bench as RB

        with contextlib.redirect_stdout(io.StringIO()):
            repl = RB.run_replication_matrix(quick)
            filt = RB.run_filter_arm(quick)
        out["replication"] = comparable(repl + filt)
        out["replication_problems"] = (RB.check_replication(repl)
                                       + RB.check_filter_arm(filt))
    return out


# ---------------------------------------------------------------------------
# the demos
# ---------------------------------------------------------------------------


def run_demo(name: str) -> tuple[list[str], dict]:
    """The reference demo's printed lines (and its module globals)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        g = runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                           run_name="demo")
    return buf.getvalue().rstrip("\n").split("\n"), g


def serving_params():
    """The serving demo's weights: the reference's init at PRNGKey(0), as
    numpy leaves."""
    import jax

    from repro import models as M
    from repro.configs import get_config

    cfg = get_config("qwen2-1.5b").reduced()
    return jax.tree.map(lambda a: jax.device_get(a),
                        M.init_params(cfg, jax.random.PRNGKey(0)))


def demo_rows(name: str) -> dict:
    lines, g = run_demo(name)
    row = {"lines": timer_free(lines)}
    if name == "serve_kvcache":
        row["out_tokens"] = [list(map(int, g["done"][r].out_tokens))
                             for r in g["rids"]]
    return row


def train_history(steps: int = TRAIN_STEPS,
                  preset: str = TRAIN_PRESET) -> dict:
    """``examples/train_lm.py``'s loop from a fresh start: its parameter
    count, then each step's loss, rate and gradient norm."""
    import jax
    import jax.numpy as jnp

    from repro.data.pipeline import DataConfig, make_batch
    from repro.training.step import init_train_state, make_train_step

    g = runpy.run_path(str(ROOT / "examples" / "train_lm.py"),
                       run_name="demo")
    cfg, shape, tcfg = _train_configs(g, preset, steps)
    state = init_train_state(cfg, tcfg, jax.random.PRNGKey(0))
    n_params = sum(x.size for x in jax.tree.leaves(state["params"]))
    step_fn = jax.jit(make_train_step(cfg, tcfg))
    hist = []
    for i in range(steps):
        batch = {k: jnp.asarray(v) for k, v in
                 make_batch(cfg, shape, i, DataConfig(task="copy")).items()}
        state, m = step_fn(state, batch)
        hist.append({"loss": float(m["loss"]), "lr": float(m["lr"]),
                     "grad_norm": float(m["grad_norm"])})
    return {"preset": preset, "steps": steps, "n_params": int(n_params),
            "history": hist}


def _train_configs(g: dict, preset: str, steps: int):
    """The demo's configs, built as its ``main`` builds them."""
    import dataclasses

    p = g["PRESETS"][preset]
    cfg = dataclasses.replace(
        g["get_config"]("qwen2-1.5b"),
        n_layers=p["n_layers"], d_model=p["d_model"], n_heads=p["n_heads"],
        n_kv_heads=p["n_kv_heads"], head_dim=p["head_dim"], d_ff=p["d_ff"],
        vocab_size=p["vocab_size"], dtype="float32", param_dtype="float32",
    )
    shape = g["ShapeSpec"]("train", p["seq"], p["batch"], "train")
    tcfg = g["TrainConfig"](
        opt=g["OptConfig"](lr=3e-4, warmup_steps=max(10, steps // 20),
                           total_steps=steps),
        microbatches=p["micro"], remat=True,
    )
    return cfg, shape, tcfg


def train_initial_state(steps: int = TRAIN_STEPS, preset: str = TRAIN_PRESET):
    """The training demo's initial state (reference init, numpy leaves)."""
    import jax

    from repro.training.step import init_train_state

    g = runpy.run_path(str(ROOT / "examples" / "train_lm.py"),
                       run_name="demo")
    cfg, _, tcfg = _train_configs(g, preset, steps)
    return jax.tree.map(jax.device_get,
                        init_train_state(cfg, tcfg, jax.random.PRNGKey(0)))


def read_fixture() -> dict:
    return json.loads(FIXTURE.read_text())


def main() -> int:
    made_at = PR.src_repro_commit()
    out = {"about": "the reference's bench rows and demo output (src/repro "
                    "on the CPU); see tests/bench_reference.py",
           "made_at": made_at, "left_out": list(RUN_COLUMNS)}
    for size, quick in SIZES.items():
        print(f"[{size}] overload", flush=True)
        out.setdefault("overload", {})[size] = overload_rows(quick)
        print(f"[{size}] metrics", flush=True)
        out.setdefault("metrics", {})[size] = metrics_rows(quick)
        print(f"[{size}] dist", flush=True)
        out.setdefault("dist", {})[size] = dist_rows(quick)
        print(f"[{size}] balance extras", flush=True)
        out.setdefault("balance_extras", {})[size] = balance_extras(quick)
    print("demos", flush=True)
    out["examples"] = {name: demo_rows(name) for name in DEMOS}
    out["examples"]["train_lm"] = train_history()
    FIXTURE.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {FIXTURE}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
