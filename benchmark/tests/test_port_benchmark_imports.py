"""Nothing the benchmark runs loads JAX, the JAX package or the scripts that
drive it, and its reference loads nothing of the program."""

import ast
import json
import pathlib
import subprocess
import sys

from benchmark.harness import cli

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
PROGRAM = "monst3r_slam_torch"


def imported_top_names(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_under_benchmark_imports_jax_or_the_jax_package():
    for path in sorted(BENCH.rglob("*.py")):
        bad = imported_top_names(path) & set(cli.FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        names = imported_top_names(path)
        assert PROGRAM not in names, f"{path.relative_to(ROOT)} imports the program"
        assert names <= {"__future__", "contextlib", "math", "numpy", "torch", "benchmark"}, names


def test_the_check_compares_whole_top_level_names(monkeypatch):
    # the port's name begins with the JAX package's: only whole names count
    assert "monst3r_slam_tpu".startswith("monst3r_slam_t")
    monkeypatch.setitem(sys.modules, "monst3r_slam_tpux", sys)
    monkeypatch.setitem(sys.modules, "jaxx.y", sys)
    assert cli.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert cli.forbidden_modules() == ["jax"]


def test_every_module_a_run_loads_is_free_of_jax():
    """Import everything a run of each cell and each metric reader loads, in
    a fresh interpreter, and read the top-level names it then holds."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    kinds = sorted({json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())["kind"]
                    for w in manifest["workloads"]})
    metrics = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    code = f"""
import importlib, importlib.util, json, sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark.harness import cli, common, trace
from benchmark.reference import ate, matcher, model, train, tracker
import benchmark.control
for kind in {kinds!r}:
    importlib.import_module("benchmark.harness." + kind)
import monst3r_slam_torch.app.pipeline, monst3r_slam_torch.app.config
import monst3r_slam_torch.train.step, monst3r_slam_torch.ops.build
import monst3r_slam_torch.native.build, monst3r_slam_torch.slam.retrieval
for name in {metrics!r}:
    spec = importlib.util.spec_from_file_location("m", cli.BENCH / "metrics" / (name + ".py"))
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PROGRAM in top
    assert not top & set(cli.FORBIDDEN), top & set(cli.FORBIDDEN)
