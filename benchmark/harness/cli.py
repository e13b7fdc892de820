"""One run of one cell: set-up, warm-up, the measured window, the check of
what the window produced, and the contract's last line.

Everything a cell needs is found by name from `BENCHMARK.json`: the cell's
configuration file (`configs`), its traffic file `benchmark/traffic/
<traffic>.json` (whose `kind` names the module of this package that
generates and serves it), its limits `benchmark/limits/<cell>.json`, and a
reader `benchmark/metrics/<metric>.py` for each metric it reports. A later
cell or metric is a new file and a new entry; no file here changes.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
# Top-level modules that no run may load: JAX, its libraries, the JAX
# package and the scripts that drive it.
FORBIDDEN = ("jax", "jaxlib", "flax", "monst3r_slam_tpu", "bench", "chip_smoke")


class Cell:
    """A run's inputs and its set-up clock."""

    def __init__(self, manifest: dict, workload: str, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float, overrides: dict | None = None,
                 control: dict | None = None):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
        self.entry = cells[workload]
        self.name, self.seed, self.seconds, self.trace = workload, int(seed), float(seconds), trace
        self.device, self.t_start = device, t_start
        conf = {c["name"]: c for c in manifest["configs"]}[self.entry["config"]]
        self.config = json.loads((ROOT / conf["file"]).read_text())
        self.traffic = json.loads((BENCH / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
        for key, extra in (overrides or {}).items():
            getattr(self, key).update(extra)
        # The control or a planted fault in the program's place (benchmark/
        # control.py); None in every run of the benchmark itself.
        self.control = control or {}
        self.setup_parts: dict = {}
        self._last = t_start

    def phase(self, name: str) -> None:
        """Close the set-up phase `name` (seconds since the previous one)."""
        now = time.perf_counter()
        self.setup_parts[name] = now - self._last
        self._last = now

    def setup_done(self) -> float:
        return time.perf_counter() - self.t_start


def metrics_for(manifest: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics (trace 0) or per-layer metrics (trace 1)."""
    e2e = manifest["end_to_end"]
    reported = {m["name"] for m in e2e if workload in m.get("workloads", [workload])}
    if not trace:
        return [m for m in e2e if m["name"] in reported]
    return [m for m in manifest["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def read_metric(name: str, run: dict):
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict | None = None, t_start: float | None = None,
             control: dict | None = None) -> dict:
    """Everything but the look for a chip: the result object the contract's
    last line is made of, with its `checks` last."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = Cell(manifest, workload, seed, seconds, trace, device, t_start, overrides, control)
    kind = importlib.import_module(f"benchmark.harness.{cell.traffic['kind']}")
    run = kind.run(cell)
    checks = {}
    for name, value in run["checks"].items():
        limit = cell.limits[name]
        checks[name] = {"value": value, "limit": limit}
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in metrics_for(manifest, workload, trace):
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_row = dict(platform="gpu" if device == "cuda" else device, kind=run["device_kind"],
                      count=cell.entry["chips"], memory_peak_bytes=run["memory_peak_bytes"])
    out = dict(correct=correct, attempted=run["attempted"], failed=run["failed"],
               metrics=metrics, device=device_row)
    if trace and run.get("trace") is not None:
        tr = run["trace"]
        device_row.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    out["setup_parts"] = cell.setup_parts
    out["checks"] = checks
    return out


def main(argv=None, t_start: float | None = None) -> int:
    p = argparse.ArgumentParser(description="One run of one cell of BENCHMARK.json.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in manifest["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                   t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: no part of it may import JAX or the JAX package",
              file=sys.stderr)
        return 3
    emit(out)
    return 0


def emit(out: dict) -> None:
    """The set-up's parts on an earlier line; each compared number beside
    its limit as the last lines of standard error; the result object, with
    its `checks` last, as the last line of standard output."""
    print(f"setup parts (s): {json.dumps(out.pop('setup_parts'))}", flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
