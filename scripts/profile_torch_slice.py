#!/usr/bin/env python3
"""Where the PyTorch port's main path spends its time on the card.

Builds the slice that `chip_smoke.py` drives (the synchronous SLAMSystem at
MAST3R_512 full width, random tied bf16 weights, 384x512 frames), tracks a
few warm-up frames, then profiles `--frames` steady frames, the middle one
a keyframe event, with torch.profiler (CUDA activity). Prints the per-frame
wall time, the device-busy share (kernel time over wall time), device time
per kernel group (the two ported kernels, GEMMs, convolutions, the rest)
per frame, the Gauss-Newton iterations per frame, the top kernels, and the
host stage times SLAMSystem.prof keeps.
The full kernel table goes to logs/profile_torch_slice.txt.

    python3 scripts/profile_torch_slice.py [--frames 6] [--seed 0]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("attention kernel (A)", ("attn_fwd",)),
    ("tile_match kernel (B)", ("tile_match_kernel",)),
    ("convolution", ("conv", "cudnn", "implicit", "winograd", "dgrad", "fprop")),
    ("GEMM", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "cublas", "matmul")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from monst3r_slam_torch.app.pipeline import SLAMSystem
    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.models.convert import cast_params_for_inference
    from monst3r_slam_torch.models.init import init_params

    card = chip_smoke.phase_card()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = init_params(gen, MAST3R_512)
    params["dec_blocks2"], params["head2"] = params["dec_blocks"], params["head1"]
    params = cast_params_for_inference(params)
    hw = (chip_smoke.H, chip_smoke.W)
    slam = SLAMSystem(params=params, model_cfg=MAST3R_512, cfg=chip_smoke.slice_config(),
                      img_size=hw, kf_capacity=16, device="cuda", dtype=torch.bfloat16)
    img = chip_smoke.synthetic_frame(args.seed, *hw)
    warm = 3
    for i in range(warm):
        slam.process_frame(i, i / 30.0, img, force_kf=False)
    torch.cuda.synchronize()
    slam.prof.clear()

    unprofiled = []  # the same frames without the profiler's overhead
    for i in range(warm, warm + args.frames):
        t0 = time.perf_counter()
        slam.process_frame(i, i / 30.0, img, force_kf=False)
        torch.cuda.synchronize()
        unprofiled.append((time.perf_counter() - t0) * 1e3)
    warm += args.frames
    host_unprofiled = {k: np.median(v) for k, v in slam.prof.items()}
    slam.prof.clear()

    kf_at = warm + args.frames // 2
    wall = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(warm, warm + args.frames):
            t0 = time.perf_counter()
            slam.process_frame(i, i / 30.0, img, force_kf=i == kf_at)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
    modes = slam.mode.name
    total_wall = sum(wall)

    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = ev.self_cuda_time_total
        if dev > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev / 1e3, ev.count, ev.key))
    if not rows:  # some builds attribute kernel time to the CPU-side ops only
        for ev in prof.key_averages():
            dev = getattr(ev, "self_device_time_total", None) or ev.self_cuda_time_total
            if dev > 0:
                rows.append((dev / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    groups: dict = {}
    for ms, count, name in rows:
        g = groups.setdefault(group_of(name), [0.0, 0])
        g[0] += ms
        g[1] += count

    n = args.frames
    print(f"card: {card}")
    print(f"frames {n} (keyframe event at frame {kf_at}), final mode {modes}; wall ms per "
          f"frame {[round(t, 2) for t in wall]}; mean {total_wall / n:.2f} ms")
    print(f"without the profiler, {n} tracking frames: wall ms "
          f"{[round(t, 2) for t in unprofiled]}; median {np.median(unprofiled):.2f} ms")
    print(f"device busy {busy:.2f} ms of {total_wall:.2f} ms wall = {busy / total_wall:.3f}")
    for g, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g:24s} {ms / n:9.3f} ms/frame  {count / n:8.1f} launches/frame  "
              f"{ms / busy:.3f} of device time")
    solves = sum(ev.count for ev in prof.key_averages() if ev.key == "aten::linalg_cholesky_ex")
    print(f"Gauss-Newton iterations (one Cholesky solve each, tracker and backend): "
          f"{solves / n:.2f} per frame")
    print("top kernels (ms over the window, launches):")
    for ms, count, name in rows[:12]:
        print(f"  {ms:9.3f} {count:6d}  {name[:110]}")
    print("most launched kernels (launches per frame, ms over the window):")
    for ms, count, name in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {count / n:8.1f} {ms:9.3f}  {name[:100]}")
    print("host stages (median ms; without / with the profiler):")
    for k, v in slam.prof.items():
        print(f"  {k:18s} {host_unprofiled.get(k, float('nan')):9.2f} {np.median(v):9.2f}  "
              f"(n={len(v)})")

    out = ROOT / "logs"
    out.mkdir(exist_ok=True)
    try:
        table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=60)
    except (AttributeError, KeyError, ValueError):
        table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60)
    (out / "profile_torch_slice.txt").write_text(f"card: {card}\n{table}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
