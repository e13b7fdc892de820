#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (`monst3r_slam_torch`): one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the CUDA devices the cell
asks for. It makes the cell's weights and traffic from the seed, warms up,
measures for `--seconds`, checks what the window produced against the plain
reference in `benchmark/reference/`, and prints the result as one JSON
object on the last line of standard output (the compared numbers and their
limits also as the last lines of standard error). With `--trace 1` it
reports the cell's per-layer metrics and the device's busy time instead of
its end-to-end metrics.
"""

import pathlib
import sys
import time

T_START = time.perf_counter()
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark.harness import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(t_start=T_START))
