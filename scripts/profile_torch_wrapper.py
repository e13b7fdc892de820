#!/usr/bin/env python3
"""What kernel A's wrapper pays for choosing the card it launches on.

`attention.fused_attention` enters `build.on_card(dev)` around each launch:
one query of the current card, and a context only when another card is
current. This times the wrapper on one bf16 (1, 16, 768, 64) call (the
encoder's shape at 384x512) with that helper and with it replaced by one
that returns no context and asks nothing, in alternating rounds within one
process: the host's enqueue time per call (`--calls` calls back to back,
then one synchronize) and `chip_smoke.time_ms` (CUDA events, the larger of
the host's and the device's time per call), plus the query alone.

    python3 scripts/profile_torch_wrapper.py [--rounds 8] [--calls 2000] [--seed 0]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from monst3r_slam_torch.ops import attention, build

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    q, k, v = (torch.randn(1, 16, 768, 64, generator=g, device="cuda").bfloat16()
               for _ in range(3))
    fn = lambda: attention.fused_attention(q, k, v)  # noqa: E731
    real = build.on_card
    variants = {"on_card": real, "no_query": lambda dev: contextlib.nullcontext()}

    def enqueue_us() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.calls):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / args.calls * 1e6

    for _ in range(3):
        fn()
    res = {name: dict(enqueue_us=[], ms=[]) for name in variants}
    try:
        for r in range(args.rounds):
            order = list(variants) if r % 2 == 0 else list(reversed(variants))
            for name in order:
                build.on_card = variants[name]
                res[name]["enqueue_us"].append(enqueue_us())
                res[name]["ms"].append(chip_smoke.time_ms(fn, 200, 3))
    finally:
        build.on_card = real
    t0 = time.perf_counter()
    for _ in range(args.calls):
        torch._C._cuda_getDevice()
    query_us = (time.perf_counter() - t0) / args.calls * 1e6
    summary = {name: dict(r, enqueue_us_median=statistics.median(r["enqueue_us"]),
                          ms_median=statistics.median(r["ms"])) for name, r in res.items()}
    diffs = [a - b for a, b in zip(res["on_card"]["enqueue_us"], res["no_query"]["enqueue_us"])]
    out = dict(card=chip_smoke.phase_card(), shape=[1, 16, 768, 64], dtype="bfloat16",
               rounds=args.rounds, calls=args.calls, query_us=query_us, variants=summary,
               enqueue_us_diff_per_round=diffs, enqueue_us_diff_median=statistics.median(diffs))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
