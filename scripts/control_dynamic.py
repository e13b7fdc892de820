#!/usr/bin/env python3
"""Readings that set the limits of `benchmark/limits/monst3r512-dynamic-oracle.json`.

    python3 scripts/control_dynamic.py --as <what> --seconds <s> --seeds <n> ...

Runs the dynamic cell once per seed in this one process (set-up, a window
of `--seconds`, the check) through `benchmark/harness/cli.run_cell` and
prints one JSON line per seed with every compared number. `--as program`
reads the program itself (the lower readings); `--as control` puts the
plain reference in the program's place one precision step below the
configuration's (both decodes in fp8; RAFT, the ego-motion flow and SAM2
with bf16 operands; the matcher with bf16 rays and fp8 descriptors, the
pose solve in bf16), which has to fail; `--as unmasked` plants the fault
of a mask that never reaches C, D and Q. The benchmark's own runs never do
any of this.
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark.harness import cli  # noqa: E402

WORKLOAD = "monst3r512-dynamic-oracle"
CONTROL = {"decode": "fp8", "raft": "bf16", "mask": "bf16", "sam2": "bf16",
           "matcher": ("bf16", "fp8"), "tracker": "bfloat16"}
WHAT = {"program": None, "control": CONTROL, "unmasked": {"fault": "unmasked"}}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--as", dest="what", choices=sorted(WHAT), required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    import torch

    for seed in args.seeds:
        torch.cuda.reset_peak_memory_stats()
        out = cli.run_cell(WORKLOAD, seed, args.seconds, False, "cuda", control=WHAT[args.what])
        print(json.dumps(dict(workload=WORKLOAD, what=args.what, seed=seed,
                              correct=out["correct"], metrics=out["metrics"],
                              checks={k: c["value"] for k, c in out["checks"].items()})),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
