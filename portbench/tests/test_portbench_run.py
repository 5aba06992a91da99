"""Each entry through the whole run at the tiny size on the CPU (the port's
plain versions in place of its kernels), and the command's refusals."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import spec
from portbench.tests import tiny

ROOT = spec.ROOT


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_entry_runs_tiny(cell, trace):
    out = tiny.run(cell, trace=trace)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    names = set(out["metrics"])
    bench = tiny.bench()
    kind = "per_layer" if trace else "end_to_end"
    listed = {m["name"] for m in spec.cell_metrics(bench, cell, kind)}
    assert names <= listed
    if trace:
        # on the CPU no kernel runs: only the readers of the window find something
        assert out["device"]["window_s"] > 0 and "breakdown" in out
        assert all(m in {"mfu.caption", "mfu.train"} for m in names)
    else:
        assert names == listed
        assert out["metrics"]["setup_s"]["value"] > 0


def _cli(cwd, env_extra=None):
    env = {**os.environ, "PYTHONPATH": str(cwd), **(env_extra or {})}
    return subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "mistral7b-caption-greedy-int8", "--seed", "2147483901", "--seconds",
                           "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=300)


def test_command_refuses_without_a_card():
    res = _cli(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA device" in res.stderr


def test_command_fails_with_the_benchmark_alone(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files
    has no program to run: no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _cli(tmp_path, {"PYTHONPATH": str(tmp_path), "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and res.stdout == ""


FORBIDDEN = {"jax", "jaxlib", "flax", "vlm_bridge_tpu"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_no_file_imports_jax_or_the_jax_package():
    files = [p for p in (ROOT / "portbench").rglob("*.py")]
    for p in files:
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & FORBIDDEN, (p, tops & FORBIDDEN)


def test_reference_imports_plain_torch_only():
    for p in (ROOT / "portbench" / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(p)}
        assert tops <= {"__future__", "math", "statistics", "typing", "torch", "portbench"}, p
        assert all(m.startswith("portbench.reference") or not m.startswith("portbench")
                   for m in _imports(p)), p


def test_a_run_loads_no_jax():
    """After a tiny run of each entry, no module with a forbidden top-level
    name is loaded, and the reference loads nothing of the port."""
    code = (
        "import sys, json\n"
        "import portbench.reference.check, portbench.reference.model\n"
        "ref_only = sorted({m.split('.')[0] for m in sys.modules})\n"
        "from portbench.tests import tiny\n"
        "from portbench import run\n"
        "tiny.run('tiny-caption', seconds=4.0)\n"
        "tiny.run('tiny-train', seconds=0.5)\n"
        "print(json.dumps({'forbidden': run.forbidden_modules(), 'ref_only': ref_only}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert "vlm_bridge_tpu_torch" not in got["ref_only"]
    assert not set(got["ref_only"]) & FORBIDDEN
