"""The port stands alone: `monst3r_slam_torch`, its entry points
`main_torch.py`, `main_monster_torch.py`, `main_easier_torch.py` and
`train_torch.py`, and
`chip_smoke.py` import neither JAX nor anything of the JAX package, not even its numpy-only modules or its native solver (the port
keeps its own copies of those, C++ source included)."""

import ast
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "monst3r_slam_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
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
    for script in ("main_torch.py", "main_monster_torch.py", "main_easier_torch.py",
                   "train_torch.py"):
        assert not re.search(r"\bjax\b|monst3r_slam_tpu", (ROOT / script).read_text()), script
    # chip_smoke.py names the TPU kernels it replaces by path, but imports
    # nothing of theirs.
    for script in ("chip_smoke.py", "main_torch.py", "main_monster_torch.py",
                   "main_easier_torch.py", "train_torch.py"):
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
