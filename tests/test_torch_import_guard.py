"""The port stands alone: ``repro_torch`` imports neither ``jax`` nor any
module of the JAX reference package ``repro`` or of the reference's
benches (the repo-root ``benchmarks``)."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
MODULES = sorted(p.relative_to(SRC).as_posix() for p in PORT.rglob("*.py"))

_BLOCKED = ("jax", "jaxlib", "repro", "benchmarks")


def _imported_names(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_no_jax_and_no_reference(module):
    bad = [n for n in _imported_names(SRC / module)
           if n.split(".")[0] in _BLOCKED]
    assert bad == [], f"{module} imports {bad}"


@pytest.mark.parametrize("script", ["chip_smoke.py", "tests/test_torch_cuda.py"])
def test_gpu_side_scripts_import_no_jax(script):
    """What runs on the GPU machine (which has no JAX) imports only the
    port: the smoke run and the CUDA-marked tests."""
    bad = [n for n in _imported_names(ROOT / script)
           if n.split(".")[0] in _BLOCKED]
    assert bad == [], f"{script} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['benchmarks'] = None\n"
        "import repro_torch, repro_torch.core, repro_torch.cluster\n"
        "import repro_torch.convert, repro_torch.prng\n"
        "import repro_torch.kernels.range_match\n"
        "import repro_torch.coordination_tier, repro_torch.core.hierarchy\n"
        "import repro_torch.coordination_tier.bench\n"
        "import repro_torch.configs, repro_torch.models\n"
        "import repro_torch.kernels.decode_attn, repro_torch.serving.engine\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.kernels.ssd_chunk, repro_torch.models.ssm\n"
        "import repro_torch.models.hybrid, repro_torch.overload\n"
        "import repro_torch.telemetry, repro_torch.telemetry.dashboard\n"
        "import repro_torch.telemetry.profiler\n"
        "import repro_torch.core.dist_store\n"
        "import repro_torch.models.moe, repro_torch.models.encdec\n"
        "import repro_torch.training, repro_torch.training.grad_compression\n"
        "import repro_torch.data.pipeline, repro_torch.launch.train\n"
        "import repro_torch.benchmarks.run, repro_torch.benchmarks.balance_bench\n"
        "import repro_torch.benchmarks.coordination_bench\n"
        "import repro_torch.benchmarks.overload_bench\n"
        "import repro_torch.benchmarks.metrics_bench\n"
        "import repro_torch.benchmarks.dist_bench\n"
        "import repro_torch.benchmarks.history\n"
        "import repro_torch.benchmarks.compare\n"
        "import repro_torch.examples.quickstart\n"
        "import repro_torch.examples.failover_demo\n"
        "import repro_torch.examples.balance_demo\n"
        "import repro_torch.examples.trace_demo\n"
        "import repro_torch.examples.serve_kvcache\n"
        "import repro_torch.examples.train_lm\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_port_modules_found():
    # the scan above must see the whole package, kernels and C core included
    assert "repro_torch/cluster/epoch.py" in MODULES
    assert "repro_torch/kernels/range_match/kernel.py" in MODULES
    assert "repro_torch/models/moe.py" in MODULES
    assert "repro_torch/models/encdec.py" in MODULES
    assert "repro_torch/coordination_tier/state.py" in MODULES
    assert "repro_torch/core/dist_store.py" in MODULES
    assert "repro_torch/core/hierarchy.py" in MODULES
    for mod in ("optimizer", "grad_compression", "step", "checkpoint",
                "elastic", "tree"):
        assert f"repro_torch/training/{mod}.py" in MODULES
    assert "repro_torch/data/pipeline.py" in MODULES
    assert "repro_torch/launch/train.py" in MODULES
    for mod in ("paper_tables", "coordination_bench", "run", "balance_bench"):
        assert f"repro_torch/benchmarks/{mod}.py" in MODULES
    for mod in ("trace", "attribution", "export", "profiler", "flight",
                "recorder", "metrics", "slo", "incident", "dashboard"):
        assert f"repro_torch/telemetry/{mod}.py" in MODULES
    for mod in ("configs/qwen2_1_5b.py", "models/transformer.py",
                "kernels/decode_attn/kernel.py", "serving/engine.py",
                "launch/serve.py", "kernels/ssd_chunk/kernel.py",
                "kernels/ssd_chunk/ops.py", "kernels/ssd_chunk/ref.py",
                "models/ssm.py", "models/hybrid.py", "overload/state.py"):
        assert f"repro_torch/{mod}" in MODULES
    assert (PORT / "kernels/range_match/csrc/range_match.cu").exists()
    assert (PORT / "kernels/decode_attn/csrc/decode_attn.cu").exists()
    assert (PORT / "kernels/ssd_chunk/csrc/ssd_chunk.cu").exists()
    assert (PORT / "core/des_core.c").exists()
