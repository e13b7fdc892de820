#!/usr/bin/env python3
"""Where the PyTorch port's main path spends its time on the card.

Builds the slice that `chip_smoke.py` drives (the synchronous SLAMSystem at
MAST3R_512 full width, random tied bf16 weights, 384x512 frames), tracks a
few warm-up frames, then profiles `--frames` steady frames, the middle one
a keyframe event, with torch.profiler (CPU and CUDA activity) through the
port's exporter, `utils/timing.profile_trace`: the trace, with the
program's own spans (`frame`, `encode`, `decode`, `match_track`, `wait`,
`kf_event`, ...) on rows of their own above the host's calls and the
kernels, on the trace's time base, goes to logs/profile_torch_slice[_async]
[_dynamic]/trace.json (open it in Perfetto or chrome://tracing). Prints the
per-frame wall time, the device-busy share (kernel time over wall time),
device time per kernel group (the two ported kernels, GEMMs, convolutions,
the rest) per frame, the Gauss-Newton iterations per frame, the top
kernels, the host stage times SLAMSystem.prof keeps and the recorder's
table of spans and counters (`timing.summary`), then the clock check: each
launch of kernels A and B, by the program span around its launch call on
the launching thread (the stage that enqueues it: `encode` or `decode` for
A, `match_track` for B, the backend's spans for the keyframe's edges), and
the share inside its stage, which is at least 99% when program spans and
the trace share one clock. Then the script's own seconds by stage. The full
kernel table goes to logs/profile_torch_slice.txt (`_async.txt`). The
trace is read once, as the profiler's raw events
(`chip_smoke.trace_totals`).

With `--dynamic`, the frames run through the dynamic pipeline of
`main_monster_torch.py`: MAST3R_512 + MONST3R_512 (both tied, bf16), RAFT
with random weights at 20 iterations, config/intrinsics.yaml's calibration
scaled to the frame, masking refined by the native refiner and the temporal
propagator; host stages then include the MonST3R and MASt3R decodes, the
flow program and the mask refinement.

With `--async`, the same frames run as `main.py` runs them by default: the
backend on its worker thread with the f64 host solve, tracking decisions two
frames late, and a retrieval database (bootstrapped on the first keyframe,
its gate opened for random weights). The keyframe event is then queued for
the worker, and the window ends when the worker has finished. It also prints
the worker's stall on the main thread, the keyframe event's time on both
threads, the host solve's time per Gauss-Newton iteration and the retrieval
query's time. Both modes also time `--frames` frames back to back with no
synchronization in between ("pipelined"), the steady rate a user sees.

    python3 scripts/profile_torch_slice.py [--frames 6] [--seed 0] [--async] [--dynamic]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import threading
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


KERNELS = (("A", "attn_fwd"), ("B", "tile_match"))
# The spans a kernel's launch belongs in: the stages of the tracked frame
# that enqueue it, or the backend's work on a keyframe's edges.
STAGES = {"A": ("encode", "decode"), "B": ("match_track",)}
BACKEND = ("backend_stall", "backend_job")


def launch_spans(trace_json, aliases=None) -> dict:
    """{kernel: {span: launches}}: for each launch of kernels A and B in a
    trace that `timing.profile_trace` wrote, the innermost program span on
    the launching thread around its launch call (the CUDA API call with
    the kernel's correlation id). `aliases` maps other ids the trace may
    give a thread (its `threading.get_ident()`) to its native id. A
    call on a thread the trace names by neither is matched by time against
    the spans of the recorder's threads that the trace does not name, and
    counted under the span's name with " (by time)"."""
    from monst3r_slam_torch.utils import timing

    events = json.loads(pathlib.Path(trace_json).read_text())["traceEvents"]
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    rows: dict = {}
    for e in events:
        if e.get("cat") == "program_span":
            rows.setdefault(e["tid"] - timing.SPAN_ROW, []).append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
    aliases = aliases or {}
    named = {aliases.get(e.get("tid"), e.get("tid")) for e in events
             if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver")}
    unnamed = [r for tid, rs in rows.items() if tid not in named for r in rs]
    out: dict = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        k = next((k for k, key in KERNELS if key in e["name"]), None)
        if k is None:
            continue
        call = calls.get(e.get("args", {}).get("correlation"))
        where = "no launch call"
        if call is not None:
            t0, t1 = call["ts"], call["ts"] + call.get("dur", 0)
            tid = aliases.get(call["tid"], call["tid"])
            mine = rows.get(tid)
            inside = [r for r in (unnamed if mine is None else mine) if r[0] <= t0 and t1 <= r[1]]
            where = min(inside, key=lambda r: r[1] - r[0])[2] if inside else "outside every span"
            if inside and mine is None:
                where += " (by time)"
        out.setdefault(k, {})
        out[k][where] = out[k].get(where, 0) + 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--async", dest="async_", action="store_true",
                    help="the backend worker, the host solve and retrieval (main.py's default)")
    ap.add_argument("--dynamic", action="store_true",
                    help="the dynamic pipeline (MonST3R + MASt3R, RAFT, masking)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from monst3r_slam_torch.app.pipeline import SLAMSystem
    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.slam import retrieval
    from monst3r_slam_torch.utils import timing

    stage_s, t_stage = {}, time.perf_counter()

    def stage(name):
        nonlocal t_stage
        now = time.perf_counter()
        stage_s[name] = round(now - t_stage, 1)
        t_stage = now

    card = chip_smoke.phase_card()
    params = chip_smoke.tied_params(MAST3R_512, args.seed)
    hw = (chip_smoke.H, chip_smoke.W)
    cfg = chip_smoke.slice_config()
    extra, uimg = {}, None
    img = chip_smoke.synthetic_frame(args.seed, *hw)
    if args.dynamic:
        import yaml

        import main_monster_torch
        from monst3r_slam_torch.dynamic.inference import DualParams
        from monst3r_slam_torch.models.config import MONST3R_512

        with open(ROOT / "config" / "intrinsics.yaml") as f:
            intr = yaml.safe_load(f)
        s = hw[1] / intr["width"]
        K = torch.tensor([[intr["fx"] * s, 0, intr["cx"] * s], [0, intr["fy"] * s, intr["cy"] * s],
                          [0, 0, 1]], device="cuda")
        cfg.update(use_calib=True, use_dynamic_mask=True, refine_dynamic_mask_with_sam2=True,
                   dynamic_mask_threshold=chip_smoke.DYN_THRESHOLD)
        monst3r = chip_smoke.tied_params(MONST3R_512, args.seed + 1, img)
        extra = dict(K=K, dual=DualParams(monst3r, MONST3R_512, params, MAST3R_512))
        main_monster_torch.install_flow("random", args.seed + 2, "cuda")
        uimg = np.uint8(np.round((img * 0.5 + 0.5) * 255))
    if args.async_:
        cfg["single_thread"] = False
        cfg["local_opt"]["solver"] = "auto"
        cfg["retrieval"].update(bootstrap_frames=1, n_words=64, min_thresh=0.0)
        extra = dict(retrieval_params=retrieval.init_retrieval_params(
            torch.Generator().manual_seed(1), MAST3R_512.enc_dim, device="cuda"),
            retrieval_db=retrieval.ASMKDatabase.from_config(cfg))
    slam = SLAMSystem(params=params, model_cfg=MAST3R_512, cfg=cfg, img_size=hw,
                      kf_capacity=16, device="cuda", dtype=torch.bfloat16, **extra)
    stage("set-up")
    warm = 3
    for i in range(warm):
        slam.process_frame(i, i / 30.0, img, uimg=uimg, force_kf=False)
    torch.cuda.synchronize()
    slam.prof.clear()
    stage("warm-up frames")

    unprofiled = []  # the same frames without the profiler's overhead
    for i in range(warm, warm + args.frames):
        t0 = time.perf_counter()
        slam.process_frame(i, i / 30.0, img, uimg=uimg, force_kf=False)
        torch.cuda.synchronize()
        unprofiled.append((time.perf_counter() - t0) * 1e3)
    warm += args.frames
    host_unprofiled = {k: np.median(v) for k, v in slam.prof.items() if v}
    t0 = time.perf_counter()
    for i in range(warm, warm + args.frames):
        slam.process_frame(i, i / 30.0, img, uimg=uimg, force_kf=False)
    slam.finalize()
    torch.cuda.synchronize()
    pipelined = (time.perf_counter() - t0) * 1e3 / args.frames
    warm += args.frames
    slam.prof.clear()
    stall0 = slam.backend_stall_s
    stage("unprofiled and pipelined frames")

    kf_at = warm + args.frames // 2
    wall = []
    tag = ("profile_torch_slice" + ("_async" if args.async_ else "")
           + ("_dynamic" if args.dynamic else ""))
    out = ROOT / "logs"
    timing.reset()
    with timing.profile_trace(out / tag) as prof:
        for i in range(warm, warm + args.frames):
            t0 = time.perf_counter()
            slam.process_frame(i, i / 30.0, img, uimg=uimg, force_kf=i == kf_at)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        slam.finalize()  # the deferred decisions and the worker's solve
        torch.cuda.synchronize()
        drain = (time.perf_counter() - t0) * 1e3
    modes = slam.mode.name
    total_wall = sum(wall) + drain
    stage("profiled frames")

    rows, host_ops = chip_smoke.trace_totals(prof)
    stage("trace read")
    busy = sum(r[0] for r in rows)
    groups: dict = {}
    for ms, count, name in rows:
        g = groups.setdefault(group_of(name), [0.0, 0])
        g[0] += ms
        g[1] += count

    n = args.frames
    mode = ("async: backend worker, f64 host solve, retrieval, decisions "
            f"{slam.defer_depth} frames late" if args.async_ else "synchronous")
    if args.dynamic:
        mode += (", dynamic: MonST3R + MASt3R, RAFT 20 iterations, mask threshold "
                 f"{slam.dyn_threshold}, mask share {slam.prof.get('mask_share')}")
    print(f"card: {card}")
    print(f"mode: {mode}")
    print(f"frames {n} (keyframe event at frame {kf_at}), final mode {modes}; wall ms per "
          f"frame {[round(t, 2) for t in wall]} + {drain:.2f} ms to drain; mean "
          f"{total_wall / n:.2f} ms")
    print(f"without the profiler, {n} tracking frames: wall ms "
          f"{[round(t, 2) for t in unprofiled]}; median {np.median(unprofiled):.2f} ms; "
          f"pipelined (no sync between frames) {pipelined:.2f} ms per frame")
    print(f"device busy {busy:.2f} ms of {total_wall:.2f} ms wall = {busy / total_wall:.3f}")
    for g, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g:24s} {ms / n:9.3f} ms/frame  {count / n:8.1f} launches/frame  "
              f"{ms / busy:.3f} of device time")
    solves = host_ops.get("aten::linalg_cholesky_ex", 0)
    print(f"Gauss-Newton iterations (one Cholesky solve each, tracker and backend): "
          f"{solves / n:.2f} per frame")
    print("top kernels (ms over the window, launches):")
    for ms, count, name in rows[:12]:
        print(f"  {ms:9.3f} {count:6d}  {name[:110]}")
    print("most launched kernels (launches per frame, ms over the window):")
    for ms, count, name in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {count / n:8.1f} {ms:9.3f}  {name[:100]}")
    p = slam.prof
    iters = sum(p.get("backend_solve_iters", []))
    print(f"keyframe event: main thread {p.get('kf_event')} ms, worker job "
          f"{p.get('backend_job')} ms; global solve {p.get('backend_solve')} ms in "
          f"{p.get('backend_solve_iters')} iterations = "
          f"{sum(p.get('backend_solve', [])) / max(iters, 1):.3f} ms per iteration "
          f"({'f64 host' if slam.host_solve else 'f32 device'}); retrieval queries "
          f"{p.get('retrieval')} ms; backend stall on the main thread "
          f"{(slam.backend_stall_s - stall0) * 1e3:.2f} ms (with the profiler)")
    print("host stages (median ms; without / with the profiler):")
    for k, v in slam.prof.items():
        if v:
            print(f"  {k:18s} {host_unprofiled.get(k, float('nan')):9.2f} {np.median(v):9.2f}  "
                  f"(n={len(v)})")
    print("the recorder's spans and counters over the profiled frames (utils/timing):")
    print(timing.summary())

    aliases = {}
    for t in threading.enumerate():
        for ident in (t.ident & 0xFFFFFFFF, (t.ident & 0xFFFFFFFF) - (1 << 32), t.ident):
            aliases[ident] = t.native_id
    found = launch_spans(out / tag / "trace.json", aliases)
    for k, where in sorted(found.items()):
        n_all = sum(where.values())
        inside = sum(v for s, v in where.items()
                     if s.removesuffix(" (by time)") in STAGES[k] + BACKEND)
        print(f"clock check, kernel {k}: {n_all} launches by the span around the launch call "
              f"{dict(sorted(where.items()))}; inside their stage's span "
              f"{inside}/{n_all} = {inside / max(n_all, 1):.4f}"
              f" ({'ok' if inside >= 0.99 * n_all and n_all else 'FAILS: under 99%'})")
    stage("clock check")

    table = "\n".join(f"{ms:12.3f} {count:8d}  {name}" for ms, count, name in rows[:60])
    (out / f"{tag}.txt").write_text(f"card: {card}\ndevice ms over the window, launches, kernel\n"
                                    f"{table}\n")
    stage("report")
    print(f"script seconds by stage: {stage_s}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
