#!/usr/bin/env python3
"""Readings that set the limits of `benchmark/limits/<cell>.json`.

    python3 benchmark/control.py --workload <cell> --as <what> --seconds <s> --seeds <n> ...

Runs the cell once per seed in this one process (set-up, a window of
`--seconds`, the check) and prints one JSON line per seed with every
compared number. `--as program` reads the program itself (the lower
readings); `--as control` puts the plain reference in the program's place
one precision step below the configuration's (SLAM: the decode in fp8, the
matcher with bf16 rays and fp8 descriptors, the pose solve in bf16;
training: the steps with fp8 operands), which has to fail; `--as half_batch` and `--as unchanged` plant
those faults in the training cell's checked steps (half of each batch left
out, the mean taken over the rest; an optimizer step that returns the
state as it was). The benchmark's own runs never do any of this.
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark.harness import cli  # noqa: E402

CONTROLS = {
    "slam_oracle": {"decode": "fp8", "matcher": ("bf16", "fp8"), "tracker": "bfloat16"},
    "train_pairs": {"precision": "fp8"},
}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--as", dest="what", choices=("program", "control", "half_batch", "unchanged"),
                   required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    import torch

    manifest = json.loads((cli.ROOT / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in manifest["workloads"]}[args.workload]
    kind = json.loads((cli.BENCH / "traffic" / f"{entry['traffic']}.json").read_text())["kind"]
    control = {"program": None, "control": CONTROLS[kind],
               "half_batch": {"fault": "half_batch"}, "unchanged": {"fault": "unchanged"}}[args.what]
    for seed in args.seeds:
        torch.cuda.reset_peak_memory_stats()
        out = cli.run_cell(args.workload, seed, args.seconds, False, "cuda", control=control)
        print(json.dumps(dict(workload=args.workload, what=args.what, seed=seed,
                              correct=out["correct"], metrics=out["metrics"],
                              checks={k: c["value"] for k, c in out["checks"].items()})),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
