#!/usr/bin/env python3
"""What the port's recorder (`monst3r_slam_torch/utils/timing.py`) costs on
the card: one run of one benchmark cell with the recorder on or off.

    python3 scripts/timing_cost_torch.py --workload <cell> --seed <n> --seconds 51 --timing on|off

Runs the cell's set-up, warm-up, measured window and check through the
benchmark's own runner (`benchmark/harness/<kind>.py`, as `benchmark/run.py
--trace 0` runs it) with `timing.enabled` set first, and prints one JSON
line: the card and its power limit, the window's seconds and its frames or
steps, ms a frame or a step, and with the recorder on, the records it took
a frame or a step, the host's cost of each kind of record (a loop of
10,000 spans that log their ms to a list, spans with CUDA events, and
counts, on this host and card), the recorder's cost a frame or a step
computed from both, and for training the medians of the window's
`forward`, `backward` and `optimizer` device ms against its ms a step.
Compare on and off within one call, on one card, in turns (off, on, on,
off), on the same seed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def unit_costs_us(n: int = 10_000) -> dict:
    """Host us of one record of each kind, from a loop of `n` (the records
    are dropped after)."""
    import torch

    from monst3r_slam_torch.utils import timing

    log: list = []
    out = {}
    for kind, make in (("span", lambda: timing.span("cost", log=log)),
                       ("device_span", lambda: timing.span("cost", device=True))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            with make():
                pass
        out[kind] = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for _ in range(n):
        timing.count("cost")
    out["count"] = (time.perf_counter() - t0) / n * 1e6
    timing.spans()  # reads the device spans left
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--timing", choices=("on", "off"), required=True)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import importlib

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from benchmark.harness import cli
    from monst3r_slam_torch.utils import timing

    timing.enabled = args.timing == "on"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cli.Cell(manifest, args.workload, args.seed, args.seconds, False, "cuda", t_start)
    run = importlib.import_module(f"benchmark.harness.{cell.traffic['kind']}").run(cell)
    per = "frames" if "frames" in run else "steps"
    n = run[per]
    row = dict(card=card, workload=args.workload, seed=args.seed, timing=args.timing,
               window_s=run["window_s"], **{per: n}, ms_each=1e3 * run["window_s"] / n,
               setup_s=run["setup_s"], setup_parts=cell.setup_parts)
    if timing.enabled:
        rows = timing.spans()
        top = [s for s in rows if s.name == ("frame" if per == "frames" else "train_step")]
        k = max(len(top), 1)
        device = sum(1 for s in rows if s.device_ms is not None)
        records = dict(span=len(rows) - device, device_span=device, count=len(timing.counts()))
        row["records_each"] = {kind: v / k for kind, v in records.items()}
        costs = unit_costs_us()
        row["unit_costs_us"] = costs
        cost_ms = sum(v / k * costs[kind] for kind, v in records.items()) / 1e3
        row["recorder_ms_each"] = cost_ms
        row["recorder_share_pct"] = 100.0 * cost_ms / row["ms_each"]
        if per == "steps":
            sids = {s.sid for s in top[-n:]}
            phases = {name: float(np.median([s.device_ms for s in rows if s.name == name
                                             and s.parent in sids and s.device_ms is not None]))
                      for name in ("forward", "backward", "optimizer")}
            row["phase_device_ms"] = phases
            row["phases_over_step"] = sum(phases.values()) / row["ms_each"]
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
