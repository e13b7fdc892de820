#!/usr/bin/env python3
"""Where the Easi3R pair decode spends its device time on the card.

Runs `easi3r_double_inference_pair` at MONST3R_512 full depth on one 384x512
pair (random bf16 weights from `--seed`, as `chip_smoke.py`'s `easi3r`
phase), beside the plain decoder pass (`croco.decode_pair`, the same
weights and features) that the MASt3R and MonST3R decodes run, and profiles
`--iters` calls of each with torch.profiler (CUDA activity): device ms per
call by kernel group and the top kernels by device time.

    python3 scripts/profile_torch_easi3r.py [--iters 3] [--seed 0]
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def device_us(ev) -> float:
    """An event's own device time in microseconds (the attribute's name
    differs between torch versions)."""
    t = getattr(ev, "self_device_time_total", None)
    return ev.self_cuda_time_total if t is None else t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from monst3r_slam_torch.dynamic import easi3r
    from monst3r_slam_torch.models import croco, mast3r
    from monst3r_slam_torch.models.config import MONST3R_512
    from monst3r_slam_torch.models.convert import cast_params_for_inference
    from monst3r_slam_torch.models.init import init_params
    from scripts.profile_torch_slice import group_of

    cfg = MONST3R_512
    params = cast_params_for_inference(
        init_params(torch.Generator(device="cuda").manual_seed(args.seed), cfg))
    h, w = chip_smoke.H, chip_smoke.W
    img = chip_smoke.synthetic_frame(args.seed, h, w)
    x = torch.from_numpy(np.stack([img, np.roll(img, 8, axis=1)])).to("cuda")
    feat, pos = mast3r.encode(params, cfg, x)
    pair = (feat[:1], pos[:1], feat[1:], pos[1:])
    calls = {
        "double inference": lambda: easi3r.easi3r_double_inference_pair(params, cfg, *pair,
                                                                         (h, w)),
        "pass 1 (statistics)": lambda: easi3r._decode_pair_attn(params, cfg, *pair),
        "plain decoder pass": lambda: croco.decode_pair(params, cfg, *pair),
    }
    print(f"card: {chip_smoke.phase_card()}", flush=True)
    for name, fn in calls.items():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                fn()
            torch.cuda.synchronize()
        rows = [(e, device_us(e)) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0]
        total = sum(us for _, us in rows) / 1e3 / args.iters
        groups = {}
        for e, us in rows:
            g = group_of(e.key)
            groups[g] = groups.get(g, 0.0) + us / 1e3 / args.iters
        n_launch = sum(e.count for e, _ in rows) / args.iters
        print(f"{name}: {total:.2f} ms of device time per call in {n_launch:.0f} launches; by "
              f"group (ms): " + ", ".join(f"{g} {t:.2f}" for g, t in sorted(
                  groups.items(), key=lambda kv: -kv[1])), flush=True)
        for e, us in sorted(rows, key=lambda r: -r[1])[:8]:
            print(f"    {us / 1e3 / args.iters:8.3f} ms  {e.count // args.iters:5d}x  "
                  f"{e.key[:110]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
