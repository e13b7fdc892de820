"""The port stands alone: `monst3r_slam_torch`, its entry points
`main_torch.py`, `main_monster_torch.py`, `main_easier_torch.py` and
`train_torch.py`, its scripts `scripts/*_torch.py`, and
`chip_smoke.py` import neither JAX nor anything of the JAX package, not even its numpy-only modules or its native solver (the port
keeps its own copies of those, C++ source included); and its shell drivers
`scripts/*_torch.sh` run none of the JAX package's entry points."""

import ast
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "monst3r_slam_torch"

_IMPORT_ALL = """
import importlib, pathlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import monst3r_slam_torch
names = [m.name for m in pkgutil.walk_packages(monst3r_slam_torch.__path__, "monst3r_slam_torch.")]
for name in names:
    importlib.import_module(name)
assert {"monst3r_slam_torch.dynamic." + m
        for m in ("easi3r", "inference", "mask", "raft", "refine", "sam2", "sam2_video")} \
    | {"monst3r_slam_torch.viz." + m for m in ("debug", "headless", "live")} \
    | {"monst3r_slam_torch.train." + m for m in ("checkpoint", "loss", "step")} \
    | {"monst3r_slam_torch.utils." + m for m in ("flops", "timing")} \
    | {"monst3r_slam_torch.parallel." + m for m in ("inference", "mesh")} <= set(names), names
import chip_smoke
import importlib.util
for path in sorted(pathlib.Path("scripts").glob("*_torch.py")):
    spec = importlib.util.spec_from_file_location("script_" + path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
import main_easier_torch
import main_monster_torch
import main_torch
import train_torch
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m.startswith("monst3r_slam_tpu") or m.split(".")[0] in ("jax", "jaxlib")))
print(len(names), bad)
"""


def test_port_imports_without_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(maxsplit=1)
    assert int(n_modules) >= 50  # every subpackage and module was walked
    assert bad.strip() == "[]"


def test_port_sources_name_neither_jax_nor_the_jax_package():
    for path in sorted(PORT.rglob("*")):
        if path.suffix in (".py", ".cu", ".cuh", ".h", ".cpp"):
            text = path.read_text()
            assert not re.search(r"\bjax\b|monst3r_slam_tpu", text), path
    assert (PORT / "native" / "solver.cpp").is_file()  # read above
    scripts = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "scripts").glob("*_torch.py"))
    assert {"scripts/eval_ate_torch.py", "scripts/demo_pair_torch.py"} <= set(scripts)
    for script in ["main_torch.py", "main_monster_torch.py", "main_easier_torch.py",
                   "train_torch.py"] + scripts:
        assert not re.search(r"\bjax\b|monst3r_slam_tpu", (ROOT / script).read_text()), script
    # chip_smoke.py names the TPU kernels it replaces by path, but imports
    # nothing of theirs.
    for script in ["chip_smoke.py", "main_torch.py", "main_monster_torch.py",
                   "main_easier_torch.py", "train_torch.py"] + scripts:
        tree = ast.parse((ROOT / script).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            assert not any(m.split(".")[0] in ("jax", "jaxlib", "monst3r_slam_tpu")
                           for m in mods), script


def test_port_shell_drivers_call_only_the_port():
    """No `scripts/*_torch.sh` command runs main.py, main_monster_slam.py,
    main_easier_slam.py or scripts/eval_ate.py; each runs a port entry."""
    drivers = sorted((ROOT / "scripts").glob("*_torch.sh"))
    assert {p.name for p in drivers} >= {
        "run_real_torch.sh", "run_main_monster_slam_torch.sh", "eval_tum_torch.sh",
        "eval_tum2_torch.sh", "eval_bonn_torch.sh", "eval_euroc_torch.sh", "eval_eth3d_torch.sh",
        "eval_7_scenes_torch.sh", "eval_tum_metrics_torch.sh", "eval_tum2_metrics_torch.sh",
        "eval_bonn_metrics_torch.sh"}
    jax_entry = re.compile(r"(?<![\w/])(scripts/)?(main|main_monster_slam|main_easier_slam|"
                           r"eval_ate)\.py\b")
    port_entry = re.compile(r"\b(main_torch|main_monster_torch|eval_ate_torch)\.py\b")
    for path in drivers:
        code = [ln for ln in path.read_text().splitlines() if not ln.lstrip().startswith("#")]
        assert not any(jax_entry.search(ln) for ln in code), path
        assert any(port_entry.search(ln) for ln in code), path
