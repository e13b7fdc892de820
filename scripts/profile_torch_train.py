#!/usr/bin/env python3
"""Where a training step spends its time on the card.

Runs `train/step.py`'s step at MAST3R_512 full width (random f32 weights
from `--seed`, the synthetic pair of `train_torch.py`) at `--batch` and
`--size`, split into its three parts, the forward (`loss_fn`), the backward
and the AdamW update: for each, the host's time with the device
synchronized after it, and, from torch.profiler over `--iters` steps, its
device time, its launches and its device time by kernel group; then the
top kernels of the whole step by device time.

    python3 scripts/profile_torch_train.py [--batch 4] [--size 224 224] [--iters 3] [--seed 0]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, nargs=2, default=[224, 224])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import train_torch
    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.train.step import backward, loss_fn
    from scripts.profile_torch_easi3r import device_us
    from scripts.profile_torch_slice import group_of

    cfg = MAST3R_512
    state = chip_smoke.train_state(cfg, args.seed, "cuda")
    opt = state.opt_state
    batch = train_torch.synthetic_batch(args.seed, args.batch, *args.size, "cuda")
    losses = []

    def forward():
        opt.zero_grad(set_to_none=True)
        losses.append(loss_fn(state.params, cfg, batch))

    parts = {"forward": forward, "backward": lambda: backward(losses[-1], opt),
             "adamw": opt.step}
    print(f"card: {chip_smoke.phase_card()}; MAST3R_512 batch {args.batch} "
          f"{args.size[0]}x{args.size[1]}", flush=True)
    for _ in range(2):  # warm-up steps
        for fn in parts.values():
            fn()
    torch.cuda.synchronize()
    host = {name: 0.0 for name in parts}
    for _ in range(args.iters):
        for name, fn in parts.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host[name] += (time.perf_counter() - t0) * 1e3 / args.iters
    step_rows = []
    for name, fn in parts.items():
        rows = []
        for _ in range(args.iters):
            for other_name, other in parts.items():
                if other_name != name:
                    other()
                    continue
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                rows += [(e.key, device_us(e), e.count) for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0]
        step_rows += rows
        total = sum(us for _, us, _ in rows) / 1e3 / args.iters
        n_launch = sum(n for _, _, n in rows) / args.iters
        groups = {}
        for key, us, _ in rows:
            g = group_of(key)
            groups[g] = groups.get(g, 0.0) + us / 1e3 / args.iters
        print(f"{name}: host {host[name]:.1f} ms synchronized; device {total:.2f} ms in "
              f"{n_launch:.0f} launches; by group (ms): " + ", ".join(
                  f"{g} {t:.2f}" for g, t in sorted(groups.items(), key=lambda kv: -kv[1])),
              flush=True)
    by_key = {}
    for key, us, n in step_rows:
        t, c = by_key.get(key, (0.0, 0))
        by_key[key] = (t + us, c + n)
    for key, (us, n) in sorted(by_key.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"    {us / 1e3 / args.iters:8.3f} ms  {n // args.iters:5d}x  {key[:110]}",
              flush=True)
    print(f"losses {[round(x.item(), 4) for x in losses]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
