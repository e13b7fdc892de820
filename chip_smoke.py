#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`monst3r_slam_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed 0] [--frames 8]

It imports the port only (never JAX or the JAX package) and runs, each
phase printing one line:

  1. the card's name and power limit (nvidia-smi), then the build of every
     kernel from `monst3r_slam_torch/csrc/` with nvcc, one process per
     source, with each kernel's registers and spills, and a check in the
     SASS that every phase instantiation of kernel B keeps its bulk-copy
     staging and that its full instantiation runs on the tensor cores, and
     that kernel A's f32 route keeps its asynchronous copies (LDGSTS) and
     spills nothing to local memory (no LDL or STL), its FFMA kernel and
     its tensor-core kernel, whose SASS must hold its mma (HMMA);
  2. kernel A (attention) against its plain version at the encoder
     (1, 16, 768, 64) and decoder (1, 12, 768, 64) shapes, on both routes:
     the bf16 tensor-core kernel (the main path's) and the f32
     register-tiled kernel on the FP32 pipe (also at the training shapes
     `F32_TRAIN_SHAPES`, with the split it takes), with the kernel's, the
     plain version's and scaled_dot_product_attention's times (`time_ms`:
     calls back to back, what a host-bound caller sees), the kernel's and
     SDPA's device times (`device_ms`), and the kernels SDPA's call runs
     (torch.profiler's names);
  3. kernel B (tile matcher) against its plain version on one 384x512 pair
     from `--seed`, placed by the matcher's own tile and corner pipeline,
     under `matching_pallas.rounding_check` (the descriptor step sums on the
     tensor cores), with the share of queries exactly equal; then the phase
     split of kernel B on the same input (the counterpart of the TPU
     profiler `scripts/profile_pallas_phases.py`): each of the four
     instantiations (stage, ray, stencil, full) against its plain version,
     then the four timed (`ms` and `device_ms`), with the phase counter
     zeroed just before and read just after;
  4. kernel A at every head width the reference's kernel takes (`phase_heads`;
     alone with `--only-heads`): widths 8, 12, 16, 24, 32, 48, 64, 80, 96 and
     128 (the bf16 route is instantiated at 16, 32, 64 and 128, the f32
     route at 16, 32 and 64 and on the tensor cores above; every multiple
     of 8 in bf16 and of 4 in f32 is read in place, and the wrapper
     zero-pads the others) in both dtypes at (1, 16, 768, d), (2, 8, 196,
     d) and a ragged (1, 4, 100, 300), through the dispatch with its plain
     version made to fail, each within `error_bound` of
     `attention.reference` with a launch counted at its route and width and
     no padding copy where it reads the head in place, timed with the
     padding's own cost, SDPA's, the bound and, for f32 above 64, the FP32
     pipe's bound (and, printed only, the time of the FFMA kernel it
     replaced, from PERF.md); one call per route on heads whose buffers
     hold NaN past d (the output must be finite and right);
     kernel B at fd 20 (padded to 24) under
     `rounding_check` and timed beside fd 24; then the TINY config's entry
     points with their default device, the card: `train_torch.py --tiny
     --synthetic --steps 3` and `demo_pair_torch.py` in-process (finite
     losses, kernel A through its autograd Function at widths 16 and 12; the
     demo's X, C, D and Q in f32 within 1e-3 of their scale of the CPU
     path), and unchanged in subprocesses `scripts/run_real_torch.sh
     --synthetic --max-frames 3` (trajectory and ATE line),
     `demo_pair_torch.py` in bf16, and `main_monster_torch.py` and
     `main_easier_torch.py` on TINY checkpoints (exports checked);
  5. the shapes the reference's kernels take beyond the main path's
     (`phase_wide`; alone with `--only-wide`): kernel B through its banded
     variant at 384x512 with the default `PallasTileConfig()` (crop 64), at
     crop 48 with fd 48, 64, 96 and 119, at tile 32 (1,024 queries a tile)
     and at crop 50, and through `tile_match` on a 384x510 image and on one
     that starts one element past 16-byte alignment (each copied to a row
     pitch), each with flags and ray matches equal to the plain version's
     and under `rounding_check`, timed; kernel A in both dtypes at
     (1,4,768,256), (1,4,768,192), (1,6,768,160), the 256-column slices'
     (1,1,768,1024),
     (1,2,768,512), (1,1,768,768), (1,2,768,384), (1,3,768,320) and
     (2,1,196,2048) (bf16: the wide variant; f32: the tensor-core kernel,
     its slices sharing S or not as its plan takes), and batch x heads
     65,600 at 8 tokens; MAST3R_512
     re-headed through `config_from_arch_string` to 4, 2 and 1 encoder and
     decoder heads (256 / 192, 512 / 384 and 1,024 / 768 wide) decoding a
     pair in f32 and bf16 against the decode with the plain attention; the
     oracle SLAM path for 16 frames at `TiledConfig(crop=64)` and
     `TiledConfig(tile=32, crop=64)`, every kernel B call banded and held to
     its plain version, against a run with the plain version in its place;
     and for 8 frames at the one-head model, kernel A counted at widths
     1,024 and 768;
  6. the model and the matcher on the card against the port's plain CPU
     path on a small pair (MAST3R_512 widths, cut depth, f32);
  7. the main path: the port's synchronous SLAMSystem at MAST3R_512 full
     width with random bf16 weights from `--seed`, on `--frames` 384x512
     frames, one of them forced to be a keyframe so that a keyframe event
     decodes and matches the new graph edge and runs the global
     Gauss-Newton. The launch counters are zeroed just before and read just
     after; every attention launch must take the bf16 tensor-core route;
  8. the main path as `main.py` runs it by default, through the port's
     entry point `main_torch.py` with config/base.yaml: the backend on its
     worker thread with the f64 host solve, tracking decisions two frames
     late, retrieval on a k-means-bootstrapped codebook, relocalization and
     the export (`phase_main`): once as the CLI in a subprocess, unchanged,
     and once through its loop `main_torch.run` with the tied weights on
     repeated frames with one frame of noise, which must track, solve a
     keyframe event on the worker, lose the noise frame and relocalize.
     Frames and the CLI's outputs go under build/smoke_main/ and logs/;
  9. RAFT on the card against the port's CPU path on a small pair (full
     widths, 3 iterations, f32), and `raft_flow` timed at 384x512 and 20
     iterations (`phase_raft_reference`);
 10. the dynamic pipeline as `main_monster_slam.py` runs it, through the
     port's entry point `main_monster_torch.py` (`phase_dynamic`): the CLI
     unchanged in a subprocess on config/dynamic_mask_test.yaml with the
     calibration and random RAFT; `main_monster_torch.run` in-process at
     MAST3R_512 + MONST3R_512 full width with RAFT at 20 iterations on
     config/base.yaml (masking refined by the native refiner and the
     temporal propagator), which must track frames with a non-empty mask,
     decode keyframe edges with both decoders and launch both kernels; a
     stage split of its frames with the device synchronized at every stage,
     which must launch kernel A 120 times and kernel B once per tracked
     frame; and the device busy share of `scripts/profile_torch_slice.py
     --dynamic`. Frames go under build/smoke_dynamic/;
 11. SAM2 mask refinement on the dynamic path (`phase_sam2`): Hiera-B+
     (SAM2_BASE_PLUS, 1024x1024) and the video predictor (VIDEO_BASE_PLUS)
     on the card against the port's CPU path, `sam2_encode` and a video
     step timed; `main_monster_torch.py` unchanged in a subprocess with
     `--sam2-checkpoint random`, once with the image refiner and once with
     the video predictor; and `main_monster_torch.run` in-process at the
     dynamic phase's full width with the SAM2_BASE_PLUS image refiner
     (random weights), which must be called on every masked frame while
     both kernels launch, and its host-refinement stage beside the native
     refiner's;
 12. the Easi3R pipeline as `main_easier_slam.py` runs it, through the port's
     `main_easier_torch.py` (`phase_easi3r`): the double inference at
     MONST3R_512 full depth on the card against the CPU path in f32 (token
     masks equal) and the bf16 masks' difference, pass 1, the double
     inference and a plain decoder pass timed (device time from
     torch.profiler) beside the FLOP-counted bound; `main_easier_torch.run`
     on the dynamic phase's frames and weights, which must track with the
     attention masks applied and decode keyframe edges, then 3 frames
     synchronized one by one with 120 kernel A and 1 kernel B launches each;
     and the CLI unchanged in a subprocess with `--no-viz`;
 13. the live viewer (`phase_viewer`): `main_torch.run` on the main phase's
     tied setup with a started `LiveViewer`, its `/state.bin` and
     `/frame.bin` fetched over 127.0.0.1 during the run and checked, runs
     with and without it in turns, `_surfel_snapshot` on the card against
     the CPU, a run ended by a POSTed terminate, and `main_torch.py`
     without `--no-viz` in a subprocess;
 14. the rest of SLAMSystem (`phase_rest`: the LM matcher, the fusion
     modes, symmetric and fused-head decode, state files, chunked tracking;
     alone with `--only-rest`);
 15. the SLAM path's device mesh (`phase_mesh`; alone with `--only-mesh`)
     at MAST3R_512, 384x512, on the slice's tied weights and frame: with one
     card a (4, 2) mesh whose entries all name cuda:0 (the dp shards run
     one after the other), with several `make_mesh()` over the cards too
     (else it prints that the multi-card mesh was not run). The sharded
     edge decode at E = 3 and 8 equal to its shards decoded alone, its D
     and Q equal to one decode of the batch, and with cuDNN off (whose
     convolution algorithms vary with the batch size) every output equal
     to that decode's; the synchronous and the worker SLAMSystem on 10
     frames with a forced keyframe event, with the mesh (`solver: auto`,
     which the mesh makes the device solve) and without it, in the order
     off, on, on, off: decisions equal, poses within 1e-3, kernels A and B
     counted on the first run with the mesh, the keyframe event timed in
     each run;
     the sharded Gauss-Newton against the unsharded one on the end state,
     its edges spread over the shards (1e-4); and the dual decode on the
     first two mesh devices against `monst3r_asymmetric_inference` (equal);
 16. the oracle scene through the full-width SLAM path (`phase_oracle`;
     alone with `--only-oracle`): MAST3R_512 random bf16 weights, 384x512,
     config/base.yaml as shipped (worker), 96 frames of `utils/oracle.py`'s
     ground-truth trajectory (0.12 a frame) through `process_frame`, no
     keyframe forced, each decode run for real and its X/D replaced by
     the oracle's (bench.py:640-720's recipe): once as shipped, timed and
     counted, which must make >= 2 keyframe events (a keyframe that only
     repeats the previous one's decision, made before it took effect at
     `defer_tracking_sync: 2`, is not counted) and >= 1 graph edge; then
     with kernel B's plain version and with kernel B, every call of it
     held to its plain version under `rounding_check` (every query must
     pass), the worker waited for after each frame: the two must agree
     (keyframes and edges equal, poses within 1e-2, equal if no query was
     inexact); every run tracks every frame with finite poses and a
     Sim(3)-aligned ATE under 3.3% of the trajectory's extent; then
     `scripts/demo_pair_torch.py` unchanged in a subprocess on oracle
     frames 0 and 1 (its files, time and launch counts);
 17. the training path (`phase_train`; alone with `--only-train`): the
     backend workers of earlier phases stopped; `train_torch.py` unchanged
     in a subprocess at MAST3R_512 (8 steps, batch 4, 224x224, with
     `--save` and `--ckpt-dir`), and beside its file writes, which use
     the card only to copy the weights out: kernel A's autograd
     Function (kernel A forward; backward kernels in bf16, the plain
     backward in f32) on both routes at every (B, heads, N, 64) of the
     timed steps below, encoder and decoder, at (1,16,768,64) and at the
     benchmark's (12, 16|12, 768, 64), against the f32 plain autograd, the
     backward kernels' calls counted at their launch site and the
     backward's device time beside its bound, the plain backward's and
     SDPA's; steps
     timed in-process at 224x224 batch 4 and 384x512 batch
     2 (back to back, synchronized, device time from torch.profiler,
     launches, peak memory, MFU against 989 TFLOP/s; the host's launch cost
     here and in a fresh process beside them), the launch counters zeroed
     just before and read just after (96 kernel A launches and 96 calls
     of the backward kernels a step, asserted; the kernels line's
     `attention_backward` entry); one step at batch 1 on the card against the CPU path; and
     a resumed run against an uninterrupted one under deterministic
     algorithms, in a subprocess, which must match bit for bit; and the
     sharded step (`phase_train_mesh`; alone with `--only-train-mesh`) on a
     (2, 2) grid of cuda:0 (with several cards also on `make_mesh()` over
     them): MAST3R_512 from one seed, 224x224, batch 4, 3 sharded steps
     against 3 one-device ones from the same weights and batches, in f32
     (losses, gathered weights) and in bf16 (losses), kernel A launched 96
     dp tp times a step (and the backward kernels as often in bf16, never
     in f32) at (2, 8, 196, 64) and (2, 6, 196, 64), each shape
     held to its plain version, two planted faults the f32 check must
     reject, the bf16 sharded step timed beside the one-device one, and the
     edge decode on the stepped split weights equal to the decode on their
     replicas. The CLI must print `make_mesh()`'s mesh.

Random weights carry no geometry: two views of one scene, even one shifted
by a pixel, decode to pointmaps that do not match, and every frame would be
lost to relocalization. So the two decoder streams and the two heads share
one random draw and every frame is the same synthetic image: each pair then
decodes to equal pointmaps, and the confidence gates, calibrated for trained
weights, are opened. Matching then finds a share of the pixels, and
tracking, the keyframe event and the global solve run as they do on a real
sequence. The dynamic phase also moves MonST3R's random pointmap in front
of the camera (`front_depth`), which the calibrated tracker and the
ego-motion flow need, and raises the mask threshold (`DYN_THRESHOLD`).

Then a line with each phase's wall seconds, one JSON line with the kernel
table (each kernel's launches on every
path, `sam2`, `easi3r`, `viewer`, `mesh`, `oracle`, `train_mesh`, `heads`
and `wide` included; kernel A's checked head widths, its 256-wide bf16
instantiation, its bf16 wide variant, its f32 tensor-core kernel, kernel
B's banded variant and its pitched calls as rows of their own) and,
last, the
`{"ok": true, ...}` line. Exits non-zero without that line when there is no CUDA device, when the port is
not importable, or when any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# float32 FMA on the FP32 pipe (outside the tensor cores), HBM3 bandwidth.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12  # an f32 product in 3xTF32 is 3 TF32 operations on the tensor cores
PEAK_BYTES = 3.35e12
SM_CLOCK_HZ = 1.98e9  # H100 SXM boost clock: cycles per second of a spin kernel, at most

H, W = 384, 512


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _events_ms(fn, iters: int) -> float:
    """CUDA events around `iters` calls enqueued back to back, per call."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call, from CUDA events around `iters` calls enqueued
    back to back from an idle device: the larger of the device time and the
    host's cost per call (the Python wrapper, the launch), which is what a
    host-bound caller sees. Every `ms` this script reports."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _events_ms(fn, iters)


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call: the calls are enqueued while the device
    sleeps on a spin kernel 1.5x as long as the host takes to enqueue them,
    so that the host's cost per call does not stretch the window."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(1.5 * host_s * iters * SM_CLOCK_HZ, SM_CLOCK_HZ)))
    return _events_ms(fn, iters)


def profiled_ms(fn, iters: int = 3, warmup: int = 2) -> tuple:
    """(device ms, launches) per call: the kernels' own device time summed
    by torch.profiler over `iters` calls. For a call that launches more
    kernels than the device's queue holds (~1,000), where `device_ms`'s spin
    kernel cannot keep the host ahead and its window holds the host's
    enqueue time too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = trace_totals(prof)[0]
    return sum(r[0] for r in rows) / iters, sum(r[1] for r in rows) / iters


def trace_totals(prof) -> tuple:
    """From a finished torch.profiler session's raw events, read once: the
    device events' (ms, count, name) rows with time, most time first, and
    the count of each host event by name. Not `key_averages()`, which first
    builds a tree of Python objects over every event: over the 10^4-10^5
    events of a frame or a training step that took seconds to tens of
    seconds of host time a call."""
    import torch

    device, host = {}, {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            row = device.setdefault(name, [0, 0])
            row[0] += ev.duration_ns()
            row[1] += 1
        else:
            host[name] = host.get(name, 0) + 1
    rows = sorted(((ns / 1e6, n, name) for name, (ns, n) in device.items() if ns > 0),
                  reverse=True)
    return rows, host


def bound_ms(n_bytes: float, op_times_s: float) -> tuple:
    """(least time in ms, what bounds it) from bytes moved and the summed
    operation time at the peak rates."""
    t_bytes = n_bytes / PEAK_BYTES
    if op_times_s >= t_bytes:
        return op_times_s * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


COPY_OPS = ("UBLKCP", "UTMALDG")  # SASS of cp.async.bulk and of a TMA tensor load


def kernel_instructions(lib: str, fd: int = 24, kernel: str = "tile_match_kernel") -> dict:
    """{phase: (bulk copies, tensor-core mma)} in the SASS of kernel B's
    phase instantiations for `fd` channels (`kernel`: the whole-crop kernel
    or `tile_match_banded`): a cut phase whose staging the compiler dropped
    would show no copy, and a full instantiation off the tensor cores no
    HMMA."""
    from monst3r_slam_torch.ops import build
    from monst3r_slam_torch.ops.matching_pallas import PHASES

    tool = pathlib.Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", lib], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, cur = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            cur = next((ph for i, ph in enumerate(PHASES)
                        if f"{kernel}ILi{fd}ELi{i}E" in ln), None)
            if cur is not None:
                counts[cur] = [0, 0]
        elif cur is not None:
            counts[cur][0] += any(op in ln for op in COPY_OPS)
            counts[cur][1] += "HMMA" in ln
    return {ph: tuple(c) for ph, c in counts.items()}


F32_COPY_OP = "LDGSTS"  # SASS of cp.async: the f32 route's staging
LOCAL_OPS = ("LDL", "STL")  # SASS of a spill to local memory


def f32_route_instructions(lib: str) -> dict:
    """{kernel: {op: count}} in the SASS of kernel A's f32 kernels
    (`attn_fwd_f32`, the FFMA one, and `attn_fwd_tf32`, the tensor-core
    one), read in one pass: their asynchronous copies, their tensor-core
    mma (HMMA) and spills to local memory."""
    import re

    from monst3r_slam_torch.ops import build

    tool = pathlib.Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", lib], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    ops = re.compile(rf"\b({'|'.join((F32_COPY_OP, 'HMMA', *LOCAL_OPS))})\b")
    counts = {k: dict.fromkeys((F32_COPY_OP, "HMMA", *LOCAL_OPS), 0)
              for k in ("attn_fwd_f32", "attn_fwd_tf32")}
    inside = None
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = next((k for k in counts if k in ln), None)
        elif inside:
            for op in set(ops.findall(ln)):
                counts[inside][op] += 1
    return counts


def ptxas_usage(log: str) -> dict:
    """{kernel instantiation: (registers, spill bytes stored + loaded)} from
    nvcc's `-Xptxas=-v` output; the instantiations named short, as
    `attn_fwd_bf16_tc<256>`, `tile_match_banded<24,3>` or
    `attn_fwd_bf16_wide`."""
    import re

    usage, entry, spill = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(attn_fwd_[a-z0-9_]+?|attn_bwd_[a-z]+|"
                      r"tile_match_[a-z]+)"
                      r"(?:I((?:L[ib]\d+E)+)E|E)", ln)
        if m:
            entry = m.group(1) + (f"<{','.join(re.findall(r'L[ib](\d+)E', m.group(2)))}>"
                                  if m.group(2) else "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            usage[entry] = (int(m.group(1)), spill)
            entry, spill = None, 0
    return usage


def phase_build() -> None:
    from monst3r_slam_torch.ops import build
    from monst3r_slam_torch.ops.matching_pallas import PHASES

    t0 = time.perf_counter()
    logs = build.build(force=True)
    secs = time.perf_counter() - t0
    usage = {name: ptxas_usage(log) for name, log in logs.items()}
    spills = {entry: u for entries in usage.values() for entry, u in entries.items() if u[1]}
    print(f"build: {sorted(logs)} in {secs:.1f} s (one nvcc per source, in parallel); ptxas "
          "registers (spill bytes stored + loaded) | "
          + " | ".join(f"{name}: " + ", ".join(f"{entry} {r} ({sp})" for entry, (r, sp)
                                                in entries.items())
                       for name, entries in usage.items()), flush=True)
    if spills:
        fail(f"kernels spill to local memory: {spills}")
    for kernel in ("tile_match_kernel", "tile_match_banded"):
        ins = kernel_instructions(str(build.lib_path("tile_match")), kernel=kernel)
        if (sorted(ins) != sorted(PHASES) or not all(cp > 0 for cp, _ in ins.values())
                or ins["full"][1] == 0):
            fail(f"{kernel}'s phase instantiations lost their bulk-copy staging "
                 f"({'/'.join(COPY_OPS)} in SASS) or its full instantiation its tensor-core mma "
                 f"(HMMA): {ins}")
        print(f"{kernel} phase instantiations (fd 24) keep their bulk-copy staging "
              f"({'/'.join(COPY_OPS)}) and the full one runs on the tensor cores (HMMA), per "
              "phase copies/HMMA: "
              + ", ".join(f"{ph} {cp}/{mma}" for ph, (cp, mma) in ins.items()), flush=True)
    counts = f32_route_instructions(str(build.lib_path("attention")))
    f32, tc = counts["attn_fwd_f32"], counts["attn_fwd_tf32"]
    if f32[F32_COPY_OP] == 0 or any(f32[op] for op in LOCAL_OPS):
        fail(f"kernel A's f32 route lost its asynchronous copies ({F32_COPY_OP}) or spills to "
             f"local memory ({'/'.join(LOCAL_OPS)}): {f32}")
    if tc[F32_COPY_OP] == 0 or tc["HMMA"] == 0 or any(tc[op] for op in LOCAL_OPS):
        fail(f"kernel A's f32 tensor-core kernel lost its asynchronous copies ({F32_COPY_OP}) or "
             f"its tensor-core mma (HMMA), or spills to local memory ({'/'.join(LOCAL_OPS)}): {tc}")
    print(f"attention f32 route keeps its asynchronous copies and spills nothing, SASS counts: "
          f"FFMA kernel {f32}, tensor-core kernel {tc}", flush=True)


# Kernel A's f32 route at the training path's shapes (MAST3R_512 at 224x224
# batch 4, encoder and decoder heads, and the sharded step's halves) and at a
# batch of two 384x512 decoder pairs, beside the encoder and decoder shapes.
F32_TRAIN_SHAPES = ((2, 8, 196, 64), (2, 6, 196, 64), (4, 16, 196, 64), (2, 12, 768, 64))


def sdpa_kernels(q, k, v) -> str:
    """The backend scaled_dot_product_attention selects for these inputs
    (`torch._fused_sdp_choice`) and the device kernels one call runs, by
    torch.profiler's names: the yardstick's own kernel. Late in a long
    process the profiler has recorded no kernel of such a short call; the
    backend is named all the same."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend
    from torch.profiler import ProfilerActivity, profile

    backend = SDPBackend(torch._fused_sdp_choice(q, k, v)).name
    F.scaled_dot_product_attention(q, k, v)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v)
        torch.cuda.synchronize()
    kernels = " + ".join(ev.key for ev in prof.key_averages()
                         if ev.device_type == torch.autograd.DeviceType.CUDA)
    return f"{backend}: {kernels or 'kernels not recorded'}"


def f32_split(shape) -> int:
    """The split (cluster size) kernel A's f32 route takes at (B, H, N, d)."""
    import ctypes

    import torch

    from monst3r_slam_torch.ops import attention, build

    lib = build.load("attention", attention._SIGNATURES)
    lib.attn_f32_split.argtypes = [ctypes.c_longlong] * 3 + [ctypes.c_int]
    lib.attn_f32_split.restype = ctypes.c_int
    return lib.attn_f32_split(shape[0] * shape[1], shape[2], shape[2],
                              attention.padded_width(shape[3], torch.float32))


def f32_share(shape) -> int:
    """1 where kernel A's f32 route shares S among the column slices of a
    query block at (B, H, N, d) (wide heads), else 0."""
    import ctypes

    import torch

    from monst3r_slam_torch.ops import attention, build

    lib = build.load("attention", attention._SIGNATURES)
    lib.attn_f32_share.argtypes = [ctypes.c_longlong] * 3 + [ctypes.c_int]
    lib.attn_f32_share.restype = ctypes.c_int
    return lib.attn_f32_share(shape[0] * shape[1], shape[2], shape[2],
                              attention.padded_width(shape[3], torch.float32))


def phase_attention(seed: int) -> dict:
    """Kernel A on both routes against the plain version computed in f32
    from the same inputs, within `attention.error_bound` (bf16 tensor-core
    route: from its two bf16 roundings, of the probabilities and of the
    output; f32 route: 2e-5), at the encoder and decoder shapes, and the f32
    route also at `F32_TRAIN_SHAPES`; each row with the kernel SDPA's call
    runs on the same inputs."""
    import torch
    import torch.nn.functional as F

    from monst3r_slam_torch.ops import attention

    rng = np.random.default_rng(seed)
    rows = {}
    cases = [("bf16_tc", torch.bfloat16, PEAK_BF16, name, (1, heads, 768, 64))
             for name, heads in (("encoder", 16), ("decoder", 12))]
    cases += [("f32", torch.float32, PEAK_F32, name, (1, heads, 768, 64))
              for name, heads in (("encoder", 16), ("decoder", 12))]
    cases += [("f32", torch.float32, PEAK_F32, f"train {shape}", shape) for shape in F32_TRAIN_SHAPES]
    for route, dtype, peak, name, shape in cases:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda").to(dtype)
                   for _ in range(3))
        before = attention.fused_attention.route_launches[route]
        out = attention.fused_attention(q, k, v)
        torch.cuda.synchronize()
        if attention.fused_attention.route_launches[route] != before + 1:
            fail(f"attention {name} {dtype} did not take the {route} route")
        ref = attention.sdpa_plain(q.float(), k.float(), v.float())
        err = float((out.float() - ref).abs().max())
        tol = attention.error_bound(q, k, v, ref)
        if not (np.isfinite(err) and err <= tol):
            fail(f"attention {route} {name}: max abs err {err} > {tol}")
        ms = time_ms(lambda: attention.fused_attention(q, k, v))
        plain = time_ms(lambda: attention.sdpa_plain(q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        dev = device_ms(lambda: attention.fused_attention(q, k, v))
        lib_dev = device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        n_bytes = 4 * q.numel() * q.element_size()  # q, k, v read, o written
        b, h, n, d = shape
        flops = 4.0 * b * h * n * n * d  # QK^T and PV
        b_ms, b_by = bound_ms(n_bytes, flops / peak)
        row = dict(shape=list(shape), dtype=str(dtype).split(".")[-1], max_abs_err=err, tol=tol,
                   ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                   device_ms=dev, library_device_ms=lib_dev, library_kernel=sdpa_kernels(q, k, v))
        if route == "f32":
            row["split"] = f32_split(shape)
        rows[route, name] = row
        label = name if name.startswith("train") else f"{name} {tuple(shape)}"
        print(f"attention {route} {label} {row['dtype']}"
              + (f" split {row['split']}" if route == "f32" else "")
              + f": err {err:.3e} <= {tol:.3e}; ms: kernel {ms:.4f}, plain {plain:.4f}, "
              f"sdpa {lib:.4f}, bound {b_ms:.5f} ({b_by}); device ms: kernel {dev:.4f}, "
              f"sdpa {lib_dev:.4f} ({row['library_kernel']})", flush=True)
    return rows


def synthetic_pointmap_pair(seed: int, fd: int = 24, shift: int = 2):
    """A smooth pointmap over a pinhole ray grid and random unit descriptors;
    the query view is the target shifted by `shift` px along x."""
    rng = np.random.default_rng(seed)
    u = np.linspace(-0.8, 0.8, W, dtype=np.float32)
    v = np.linspace(-0.6, 0.6, H, dtype=np.float32)
    uu, vv = np.meshgrid(u, v)
    z = 2.0 + 0.5 * np.sin(2 * uu) * np.cos(3 * vv)
    X = np.stack([uu * z, vv * z, z], axis=-1)[None].astype(np.float32)
    D = rng.standard_normal((1, H, W, fd)).astype(np.float32)
    D /= np.linalg.norm(D, axis=-1, keepdims=True)
    return X, np.roll(X, -shift, axis=2), D, np.roll(D, -shift, axis=2)


def window_positions(ti, window: int) -> int:
    """Descriptor positions kernel B scores for this input: the +-window box
    around each query's ray match, clipped to its crop."""
    import torch

    from monst3r_slam_torch.ops.matching_pallas import quantize_corners
    from monst3r_slam_torch.ops.matching_tiled import _extract_crops

    h, w, _ = ti.rays_img.shape
    corners = quantize_corners(ti.corners, h, w, ti.crop).long()
    total = 0
    for c, q in zip(corners.split(64), ti.q_rays.split(64)):
        best = torch.argmax(q @ _extract_crops(ti.rays_img, c, ti.crop).transpose(1, 2), dim=-1)
        pu, pv = best % ti.crop, torch.div(best, ti.crop, rounding_mode="floor")
        su = torch.clamp(pu + window, max=ti.crop - 1) - torch.clamp(pu - window, min=0) + 1
        sv = torch.clamp(pv + window, max=ti.crop - 1) - torch.clamp(pv - window, min=0) + 1
        total += int((su * sv).sum())
    return total


def tile_match_inputs(seed: int, fd: int = 24, crop: int = 48, tile: int = 16):
    """Kernel B's arguments on the 384x512 pair from `seed` with `fd`
    descriptor channels, placed by the matcher's own tile and corner
    pipeline at `crop` and `tile` (`TiledConfig`'s defaults: the main
    path's), with what bounds the call."""
    import torch

    from monst3r_slam_torch.ops import matching, matching_tiled
    from monst3r_slam_torch.ops.matching_pallas import quantize_corners

    X11, X21, D11, D21 = (torch.from_numpy(a).to("cuda")
                          for a in synthetic_pointmap_pair(seed, fd))
    mcfg = matching.MatchingConfig()
    ti = matching_tiled.tile_inputs(X11, X21, D21, None,
                                    matching_tiled.TiledConfig(tile=tile, crop=crop))
    window = mcfg.radius * mcfg.dilation_max
    args = (
        ti.rays_img.contiguous(), D11[0].to(torch.bfloat16).contiguous(),
        ti.q_rays.contiguous(), ti.q_desc.to(torch.bfloat16).contiguous(),
        quantize_corners(ti.corners, H, W, ti.crop),
        ti.crop, window, mcfg.convergence_thresh,
    )
    T, tsz = ti.q_rays.shape[:2]
    out_bytes = 3 * T * tsz * 4  # u, v, conv as int32
    image_bytes = sum(a.numel() * a.element_size() for a in (args[0], args[1], args[4]))
    ray_flops = 5.0 * T * tsz * ti.crop**2  # 3 mul + 2 add per target ray
    desc_flops = 2.0 * args[1].shape[-1] * window_positions(ti, window)
    bounds = {  # phase: (bytes it must move, operation time at the peak rates)
        "stage": (image_bytes + out_bytes, 0.0),
        "ray": (image_bytes + args[2].numel() * 4 + out_bytes, ray_flops / PEAK_F32),
    }
    bounds["stencil"] = bounds["ray"]  # a handful of operations per query
    bounds["full"] = (bounds["ray"][0] + args[3].numel() * 2,
                      ray_flops / PEAK_F32 + desc_flops / PEAK_BF16)
    return args, ti, bounds


def check_full(args, got, what: str) -> float:
    """Kernel B's full output against its plain version under
    `matching_pallas.rounding_check`: every query must pass and at least
    99.9% be exactly equal. Returns the exact share."""
    from monst3r_slam_torch.ops.matching_pallas import rounding_check

    passes, exact = rounding_check(*args, got)
    share = float(exact.float().mean())
    if not bool(passes.all()):
        fail(f"{what}: {int((~passes).sum())} queries fail the rounding check")
    if not share >= 0.999:
        fail(f"{what}: exactly equal on {share} < 0.999 of the queries")
    return share


def phase_tile_match(seed: int) -> dict:
    """Kernel B against its plain version on the same inputs: the ray match
    and the convergence flags are the same arithmetic in the same order, the
    descriptor step sums on the tensor cores; every query must pass
    `rounding_check` and at least 99.9% be exactly equal."""
    import torch

    from monst3r_slam_torch.ops.matching_pallas import tile_match_kernel, tile_match_plain

    args, ti, bounds = tile_match_inputs(seed)
    pitched = tile_match_kernel.pitched_launches
    u, v, conv = tile_match_kernel(*args)
    torch.cuda.synchronize()
    if tile_match_kernel.pitched_launches != pitched:
        fail("tile_match: the 384x512 main path copied its images to a pitch")
    agree = check_full(args, (u, v, conv), "tile_match")
    u0, v0, _ = tile_match_plain(*args)
    T, tsz = u.shape
    ms = time_ms(lambda: tile_match_kernel(*args))
    dev = device_ms(lambda: tile_match_kernel(*args))
    plain = time_ms(lambda: tile_match_plain(*args), iters=5)
    b_ms, b_by = bound_ms(*bounds["full"])
    err = float(torch.maximum((u - u0).abs().max(), (v - v0).abs().max()))
    row = dict(shape=[T, tsz, ti.crop], max_abs_err=err, agree=agree, ms=ms, device_ms=dev,
               plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by,
               converged=float(conv.float().mean()))
    print(f"tile_match {T} tiles x {tsz} queries, crop {ti.crop}: every query passes the "
          f"rounding check, exactly equal {agree:.6f}, max |du|,|dv| {err}, converged "
          f"{row['converged']:.3f}; ms: kernel {ms:.4f}, device {dev:.4f}, plain {plain:.4f}, "
          f"bound {b_ms:.5f} ({b_by})", flush=True)
    return row


def phase_tile_match_phases(seed: int) -> dict:
    """Kernel B's phase split on the input of `phase_tile_match`, at the main
    path's crop of 48 (the whole-crop kernel; at the TPU profiler's crop of
    64 the banded variant runs, whose cuts `tests/test_torch_cuda.py`
    holds). Stage, ray and stencil must equal their
    plain versions (the same arithmetic in the same order), full pass the
    rounding check; then the four are timed, which is the phase profiler's
    own path: its launch counter is zeroed just before and read just after.
    A phase's time less the previous one's is that step's time."""
    import torch

    from monst3r_slam_torch.ops.matching_pallas import (
        PHASES, tile_match_phase_kernel, tile_match_plain,
    )

    args, ti, bounds = tile_match_inputs(seed)
    phases, err = {}, 0.0
    for ph in PHASES:
        got = tile_match_phase_kernel(*args, phase=ph)
        torch.cuda.synchronize()
        ref = tile_match_plain(*args, phase=ph)
        if ph == "full":
            check_full(args, got, "tile_match phase full")
        elif not all(torch.equal(a, r) for a, r in zip(got, ref)):
            fail(f"tile_match phase {ph}: the kernel differs from its plain version")
        err = max(err, float(torch.maximum((got[0] - ref[0]).abs().max(),
                                           (got[1] - ref[1]).abs().max())))
        phases[ph] = dict(plain_ms=time_ms(lambda: tile_match_plain(*args, phase=ph),
                                           iters=3, warmup=1))
    tile_match_phase_kernel.launches = 0
    for ph in PHASES:
        phases[ph]["ms"] = time_ms(lambda: tile_match_phase_kernel(*args, phase=ph))
        phases[ph]["device_ms"] = device_ms(lambda: tile_match_phase_kernel(*args, phase=ph))
    launches = tile_match_phase_kernel.launches
    prev, prev_dev = 0.0, 0.0
    for ph in PHASES:
        row = phases[ph]
        row["delta_ms"], row["delta_device_ms"] = row["ms"] - prev, row["device_ms"] - prev_dev
        prev, prev_dev = row["ms"], row["device_ms"]
        row["bound_ms"], row["bound_by"] = bound_ms(*bounds[ph])
        held = "passes the rounding check" if ph == "full" else "equal to its plain version"
        print(f"tile_match phase {ph:8s} {row['ms']:.4f} ms (+{row['delta_ms']:.4f} ms over the "
              f"previous phase), device {row['device_ms']:.4f} ms (+{row['delta_device_ms']:.4f}), "
              f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']}); {held}", flush=True)
    T, tsz = ti.q_rays.shape[:2]
    return dict(shape=[T, tsz, ti.crop], launches=launches, max_abs_err=err, phases=phases)


def phase_reference(seed: int) -> None:
    """The model and the matcher on the card, kernels included, against the
    same code's plain path on the CPU (which the CPU tests hold to the JAX
    package): MAST3R_512 widths with 2 encoder and 4 decoder blocks, f32 on
    both sides, one 64x80 pair. Outputs within 1e-3 of their scale (f32
    summation order through 6 blocks and the DPT head); match indices and
    valid flags equal on 99% of the pixels (near-ties of the ray argmax)."""
    import dataclasses

    import torch

    from monst3r_slam_torch.models import mast3r
    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.models.init import init_params
    from monst3r_slam_torch.ops import matching_tiled

    cfg = dataclasses.replace(MAST3R_512, enc_depth=2, dec_depth=4)
    h, w = 64, 80
    params = init_params(torch.Generator().manual_seed(seed), cfg)
    params["dec_blocks2"], params["head2"] = params["dec_blocks"], params["head1"]
    imgs = np.stack([synthetic_frame(seed, h, w), synthetic_frame(seed + 1, h, w)])

    def run(device):
        ps = _to_device(params, device)
        f, p = mast3r.encode(ps, cfg, torch.from_numpy(imgs).to(device), torch.float32)
        out = mast3r.decode(ps, cfg, f[:1], p[:1], f[1:], p[1:], (h, w), torch.float32)
        idx, valid = matching_tiled.match(out.X1, out.X2, out.D1, out.D2, use_kernel=True)
        return out, idx, valid

    (ref, ref_idx, ref_valid), (got, idx, valid) = run("cpu"), run("cuda")
    worst = 0.0
    for name in ref._fields:
        a, b = getattr(ref, name), getattr(got, name).cpu()
        err = float((a - b).abs().max() / a.abs().max())
        if not (np.isfinite(err) and err <= 1e-3):
            fail(f"reference: {name} on the card differs from the CPU path by {err} of its scale")
        worst = max(worst, err)
    agree_idx = float((idx.cpu() == ref_idx).float().mean())
    agree_valid = float((valid.cpu() == ref_valid).float().mean())
    if not (agree_idx >= 0.99 and agree_valid >= 0.99):
        fail(f"reference: matches agree on {agree_idx} (idx) / {agree_valid} (valid) < 0.99")
    print(f"reference (MAST3R_512 widths, 2+4 blocks, 64x80, f32): card vs CPU path outputs "
          f"within {worst:.2e} of scale; matches agree {agree_idx:.4f} idx, "
          f"{agree_valid:.4f} valid", flush=True)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)


def synthetic_frame(seed: int, h: int, w: int) -> np.ndarray:
    """One normalized (h, w, 3) frame: a smooth random pattern in [-1, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for _ in range(12):
        f = rng.uniform(0.01, 0.08, 2)
        ph = rng.uniform(0, 2 * np.pi, 3)
        img += np.sin(f[0] * xx[..., None] + f[1] * yy[..., None] + ph)
    img = (img - img.min()) / (img.max() - img.min())
    return ((img - 0.5) / 0.5).astype(np.float32)


def slice_config() -> dict:
    from monst3r_slam_torch.app.config import load_config

    cfg = load_config("config/base.yaml", set_global=False)
    cfg["single_thread"] = True
    cfg["use_calib"] = False
    cfg["parallel"] = {"mesh": "off"}
    cfg["local_opt"]["solver"] = "device"
    # The descriptor-confidence gates are calibrated for trained weights;
    # random weights put the median confidence near 1, under the 1.5 gate.
    cfg["tracking"]["Q_conf"] = 0.0
    cfg["local_opt"]["Q_conf"] = 0.0
    return cfg


def run_slice(params, model_cfg, img_size, n_frames: int, seed: int, device: str,
              dtype, force_kf_at: int, kf_capacity: int = 16) -> dict:
    """Drive the port's synchronous SLAMSystem over `n_frames` copies of one
    synthetic frame, with the keyframe decision pinned host-side: frame
    `force_kf_at` becomes a keyframe, no other tracked frame does. Returns
    what it did (modes, keyframes, poses, per-frame wall ms)."""
    import torch

    from monst3r_slam_torch.app.pipeline import SLAMSystem

    slam = SLAMSystem(params=params, model_cfg=model_cfg, cfg=slice_config(),
                      img_size=img_size, kf_capacity=kf_capacity, device=device, dtype=dtype)
    modes, wall_ms = [], []
    img = synthetic_frame(seed, *img_size)
    for i in range(n_frames):
        t0 = time.perf_counter()
        slam.process_frame(i, i / 30.0, img, force_kf=i == force_kf_at)
        if device == "cuda":
            torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        modes.append(slam.mode.name)
    slam.finalize()
    kf_poses, kf_ids = slam.keyframe_trajectory()
    _, poses = slam.full_trajectory()
    return dict(slam=slam, modes=modes, wall_ms=wall_ms, kf_ids=kf_ids.tolist(),
                kf_poses=kf_poses, poses=poses)


def phase_slice(seed: int, n_frames: int) -> dict:
    import torch

    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.ops.attention import fused_attention
    from monst3r_slam_torch.ops.matching_pallas import tile_match_kernel

    params = tied_params(MAST3R_512, seed)
    torch.cuda.synchronize()
    counters = (fused_attention, tile_match_kernel)
    for fn in counters:
        fn.launches = 0
    for route in fused_attention.route_launches:
        fused_attention.route_launches[route] = 0
    t0 = time.perf_counter()
    res = run_slice(params, MAST3R_512, (H, W), n_frames, seed, "cuda", torch.bfloat16,
                    force_kf_at=n_frames // 2)
    secs = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    routes = dict(fused_attention.route_launches)
    slam = res["slam"]
    print(f"slice MAST3R_512 {H}x{W}, {n_frames} frames in {secs:.2f} s: per-frame ms "
          f"{[round(t, 1) for t in res['wall_ms']]}; modes {res['modes']}; keyframes "
          f"{res['kf_ids']}; edges {slam.graph.n_edges // 2}, global solves "
          f"{slam.graph.n_solves}; launches {launches}, attention by route {routes}", flush=True)
    n_tracked = sum(m == "TRACKING" for m in res["modes"][1:])
    hw = H * W
    X0 = slam.mem.X_canon[0]
    if n_tracked < 1:
        fail(f"no frame was resolved in TRACKING: {res['modes']}")
    if slam.graph.n_solves < 1:
        fail("no global solve ran")
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path never launched: {launches}")
    if routes["bf16_tc"] != launches["fused_attention"] or routes["f32"] != 0:
        fail(f"an attention launch of the main path left the bf16 tensor-core route: {routes}")
    if not (np.isfinite(res["poses"]).all() and np.isfinite(res["kf_poses"]).all()):
        fail("non-finite pose")
    if tuple(X0.shape) != (hw, 3) or not bool(torch.isfinite(X0).all()):
        fail(f"keyframe pointmap {tuple(X0.shape)} is not finite of shape ({hw}, 3)")
    return launches


ROOT = pathlib.Path(__file__).resolve().parent
MAIN_DIR = ROOT / "build" / "smoke_main"  # frames and logs of the main phase


def synthetic_rgb(seed: int) -> np.ndarray:
    """`synthetic_frame` as a uint8 480x640 RGB camera image."""
    return np.uint8(np.round((synthetic_frame(seed, 480, 640) * 0.5 + 0.5) * 255))


def write_frames(folder: pathlib.Path, frames) -> None:
    """One PNG per frame, named in order: a folder the port's RGB reader reads."""
    import cv2

    folder.mkdir(parents=True, exist_ok=True)
    for old in folder.glob("*.png"):
        old.unlink()
    for i, img in enumerate(frames):
        cv2.imwrite(str(folder / f"{i:04d}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


def check_export(out: pathlib.Path, seq: str, n_frames: int) -> int:
    """main_torch's export in `out` is well-formed: TUM keyframe and full
    trajectories with finite poses and unit quaternions, a binary PLY whose
    body holds its vertex count, one PNG per keyframe. Returns the keyframes."""
    kf = np.atleast_2d(np.loadtxt(out / f"{seq}.txt"))
    full = np.atleast_2d(np.loadtxt(out / f"{seq}_full.txt"))
    if full.shape != (n_frames, 8) or kf.shape[1:] != (8,) or not 1 <= len(kf) <= n_frames:
        fail(f"export {out}: trajectories of shape {kf.shape} / {full.shape}")
    if not (np.isfinite(kf).all() and np.isfinite(full).all()):
        fail(f"export {out}: non-finite pose")
    if not np.allclose(np.linalg.norm(full[:, 4:8], axis=1), 1.0, atol=1e-4):
        fail(f"export {out}: quaternions are not unit")
    header, body = (out / f"{seq}.ply").read_bytes().split(b"end_header\n", 1)
    n_vert = int(header.split(b"element vertex ")[1].split(b"\n")[0])
    if not header.startswith(b"ply\nformat binary_little_endian 1.0\n") or len(body) != 15 * n_vert:
        fail(f"export {out}: malformed PLY ({n_vert} vertices, {len(body)} bytes)")
    pngs = list((out / "keyframes").glob("*.png"))
    if len(pngs) != len(kf):
        fail(f"export {out}: {len(pngs)} keyframe images for {len(kf)} keyframes")
    return len(kf)


def main_tracked_config() -> dict:
    """config/base.yaml as shipped (async backend, tracking decisions two
    frames late, `solver: auto`, bootstrapped retrieval), with the overrides
    that let random tied weights track and relocalize; each is printed."""
    from monst3r_slam_torch.app.config import load_config

    cfg = load_config("config/base.yaml", set_global=False)
    overrides = (
        # the descriptor-confidence gates, calibrated for trained weights
        # (as slice_config opens them)
        ("tracking", "Q_conf", 0.0), ("local_opt", "Q_conf", 0.0),
        # every tracked frame becomes a keyframe: keyframe events, graph
        # edges and global solves on the worker on a repeated frame
        ("tracking", "match_frac_thresh", 1.0),
        # a codebook after two keyframes, sized for their features; random
        # weights score even a repeated frame far below the trained gate
        ("retrieval", "bootstrap_frames", 2), ("retrieval", "n_words", 64),
        ("retrieval", "min_thresh", 0.0),
        # the relocalization edge's gate at tracking's own (random weights
        # match a repeated frame on fewer pixels than trained ones)
        ("reloc", "min_match_frac", 0.05),
    )
    for sec, key, val in overrides:
        print(f"main tracked run: {sec}.{key} = {val} (config/base.yaml: {cfg[sec].get(key)})",
              flush=True)
        cfg[sec][key] = val
    return cfg


def run_main_tracked(params, seed: int, n: int, noise_at: int):
    """`main_torch.run` at MAST3R_512 on the card, on `n` copies of one
    synthetic 480x640 frame with noise at `noise_at`, written as PNGs, with
    `main_tracked_config`. Returns (slam, per-frame host ms, seconds)."""
    import shutil

    import torch

    import main_torch
    from monst3r_slam_torch.models.config import MAST3R_512

    rng = np.random.default_rng(seed)
    frames = [synthetic_rgb(seed)] * n
    frames[noise_at] = rng.integers(0, 256, frames[0].shape, dtype=np.uint8)
    tracked_dir = MAIN_DIR / "tracked"
    write_frames(tracked_dir, frames)
    shutil.rmtree(ROOT / "logs" / "smoke_tracked", ignore_errors=True)
    args = main_torch.parse_args(["--dataset", str(tracked_dir), "--no-viz",
                                  "--save-as", "smoke_tracked"])
    cfg = main_tracked_config()
    t0 = time.perf_counter()
    slam, frame_ms = main_torch.run(args, cfg, params, MAST3R_512, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check_export(ROOT / "logs" / "smoke_tracked", "tracked", n)
    return slam, frame_ms, secs


def phase_main(seed: int) -> dict:
    """The port's entry point, `main_torch.py`, on config/base.yaml at
    MAST3R_512 full width: async backend with the f64 host solve, retrieval
    and relocalization, export. Two runs:
      * the CLI, unchanged, in a subprocess on 8 frames of a panning camera
        with random weights from its `--seed` (every frame is lost to
        relocalization, which finds nothing: see the module notes); it must
        exit 0 and write a well-formed export;
      * `main_torch.run`, the CLI's loop, in this process with the smoke's
        tied weights on 12 copies of one frame with noise in the middle: it
        must track, solve a keyframe event on the worker with the f64 host
        solve, lose the noise frame and relocalize against a retrieved
        keyframe, through both kernels on the bf16 tensor-core route, with
        finite poses. Launch counters zeroed just before, read just after."""
    import shutil

    import torch

    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.ops.attention import fused_attention
    from monst3r_slam_torch.ops.matching_pallas import tile_match_kernel

    shutil.rmtree(ROOT / "logs" / "smoke_cli", ignore_errors=True)
    n_cli = 8
    cli_dir = MAIN_DIR / "cli"
    write_frames(cli_dir, [np.roll(synthetic_rgb(seed), 4 * i, axis=1) for i in range(n_cli)])
    cmd = [sys.executable, "main_torch.py", "--dataset", str(cli_dir), "--no-viz",
           "--max-frames", str(n_cli), "--save-as", "smoke_cli"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=420)
    cli_s = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"main_torch.py exited {out.returncode}:\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    for want in ("backend: worker thread, global solve f64 host, tracking decisions 2 frames late",
                 "saved results to"):
        if want not in out.stdout:
            fail(f"main_torch.py did not print {want!r}:\n{out.stdout[-2000:]}")
    n_kf_cli = check_export(ROOT / "logs" / "smoke_cli", "cli", n_cli)
    done = [ln for ln in out.stdout.splitlines() if ln.startswith("done:")]
    print(f"main CLI: {' '.join(cmd[1:])} with config/base.yaml as shipped: exit 0 in "
          f"{cli_s:.1f} s; {done[0] if done else ''}; export well-formed ({n_kf_cli} keyframes, "
          f"{n_cli} frames)", flush=True)

    params = tied_params(MAST3R_512, seed)
    torch.cuda.synchronize()
    counters = (fused_attention, tile_match_kernel)
    for fn in counters:
        fn.launches = 0
    for route in fused_attention.route_launches:
        fused_attention.route_launches[route] = 0
    n, noise_at = 12, 6
    slam, frame_ms, secs = run_main_tracked(params, seed, n, noise_at)
    launches = {fn.__name__: fn.launches for fn in counters}
    routes = dict(fused_attention.route_launches)

    p = slam.prof
    n_tracked = len(p.get("kf_event", []))  # every frame resolved in TRACKING is a keyframe here
    solve_ms, iters = p.get("backend_solve", []), p.get("backend_solve_iters", [])
    per_iter = sum(solve_ms) / max(sum(iters), 1)
    _, poses = slam.full_trajectory()
    kf_poses, kf_ids = slam.keyframe_trajectory()
    row = dict(frames=n, seconds=secs, frame_ms=frame_ms, n_tracked=n_tracked,
               keyframes=kf_ids.tolist(), edges=slam.graph.edge_list(),
               async_solves=slam.n_async_solves, shed_solves=slam.n_shed_solves,
               host_solve=slam.host_solve, reloc_attempts=slam.n_reloc_attempts,
               relocs=slam.n_relocs, backend_stall_s=slam.backend_stall_s,
               kf_event_ms=p.get("kf_event", []), backend_job_ms=p.get("backend_job", []),
               solve_ms=solve_ms, solve_iters=iters, host_solve_ms_per_iter=per_iter,
               retrieval_ms=p.get("retrieval", []), launches=launches, routes=routes)
    print(f"main tracked run, MAST3R_512 {H}x{W} from 480x640 PNGs, {n} frames (noise at "
          f"{noise_at}) in {secs:.2f} s = {1e3 * secs / n:.1f} ms/frame; per-frame host ms "
          f"{[round(t, 1) for t in frame_ms]}; resolved in TRACKING {n_tracked}; keyframes "
          f"{row['keyframes']}; edges {row['edges']}; worker solves {slam.n_async_solves} (f64 "
          f"host: {slam.host_solve}), shed {slam.n_shed_solves}; relocalizations "
          f"{slam.n_relocs}/{slam.n_reloc_attempts}; backend_stall_s {slam.backend_stall_s:.3f}",
          flush=True)
    print(f"main tracked run times (ms): kf_event on the main thread "
          f"{[round(t, 2) for t in row['kf_event_ms']]}; backend job on the worker "
          f"{[round(t, 1) for t in row['backend_job_ms']]}; global solves "
          f"{[round(t, 1) for t in solve_ms]} in {iters} GN steps = {per_iter:.2f} ms per step; "
          f"retrieval queries {[round(t, 2) for t in row['retrieval_ms']]}; launches "
          f"{launches}, attention by route {routes}", flush=True)
    if n_tracked < 1:
        fail("main tracked run: no frame was resolved in TRACKING")
    # every solve here is a host solve; a failed first factorization applies no step
    if not (slam.host_solve and slam.n_async_solves >= 1 and iters and min(iters) >= 1):
        fail(f"main tracked run: no keyframe event was solved on the worker by the f64 host "
             f"solve (host_solve {slam.host_solve}, worker solves {slam.n_async_solves}, "
             f"steps per solve {iters})")
    if slam.n_relocs < 1:
        fail(f"main tracked run: no relocalization ({slam.n_reloc_attempts} attempts)")
    if min(launches.values()) < 1:
        fail(f"main tracked run: a kernel of the main path never launched: {launches}")
    if routes["f32"] != 0 or routes["bf16_tc"] < 1:
        fail(f"main tracked run: an attention launch left the bf16 tensor-core route: {routes}")
    if not (np.isfinite(poses).all() and np.isfinite(kf_poses).all()):
        fail("main tracked run: non-finite pose")
    return row


DYN_DIR = ROOT / "build" / "smoke_dynamic"  # frames of the dynamic phase
# dynamic_mask_threshold of the tracked run: random RAFT flow is a smooth
# random field, and at base.yaml's 0.35 the refined mask covers 98.7% of the
# frame (81% raw), at 0.8 84% (4% raw), so frames keep pixels to track on.
DYN_THRESHOLD = 0.8
SQUARE = 32  # side of the moving square, px of the 480x640 frame; moves 4 px a frame


def tied_params(cfg, seed: int, depth_img=None) -> dict:
    """Random bf16 weights of `cfg` from `seed` on the card, both decoder
    streams and both heads one draw (see the module notes); with
    `depth_img`, a pointmap in front of the camera (`front_depth`)."""
    import torch

    from monst3r_slam_torch.models.convert import cast_params_for_inference
    from monst3r_slam_torch.models.init import init_params

    params = init_params(torch.Generator(device="cuda").manual_seed(seed), cfg)
    params["dec_blocks2"], params["head2"] = params["dec_blocks"], params["head1"]
    if depth_img is not None:
        front_depth(params, cfg, depth_img)
    return cast_params_for_inference(params)


def front_depth(params, cfg, img: np.ndarray) -> float:
    """Scale the pointmap rows of the head's last convolution so that its
    raw output has a standard deviation of 0.1 on the normalized image
    `img`, and add 1 to the z bias; returns the scale. Random weights
    otherwise saturate the 'exp' depth mode (|X| near 1e17) with half of the
    points behind the camera, where the calibrated tracker has no residual
    and the ego-motion flow divides by the clamped depth; after it, depths
    lie near 1.7, a camera in front of a wall."""
    import torch

    from monst3r_slam_torch.models import croco
    from monst3r_slam_torch.models.dpt import dpt_forward

    x = torch.from_numpy(img)[None].to("cuda")
    feat, pos = croco.encode_image(params, cfg, x, torch.float32)
    dec, _ = croco.decode_pair(params, cfg, feat, pos, feat, pos, torch.float32)
    fmap = dpt_forward(params["head1"]["dpt"], cfg, dec, img.shape[0] // cfg.patch_size,
                       img.shape[1] // cfg.patch_size)
    scale = 0.1 / float(fmap[..., :3].float().std())
    conv3 = params["head1"]["dpt"]["head"]["conv3"]
    conv3["w"][:3] *= scale
    conv3["b"][2] += 1.0
    return scale


def dynamic_frames(seed: int, n: int) -> list:
    """`n` copies of `synthetic_rgb(seed)` with a red square moving right."""
    frames = []
    for i in range(n):
        img = synthetic_rgb(seed).copy()
        x0 = 200 + 4 * i
        img[220 : 220 + SQUARE, x0 : x0 + SQUARE] = (230, 30, 30)
        frames.append(img)
    return frames


def dynamic_config() -> dict:
    """config/base.yaml as shipped (worker, f64 host solve, decisions two
    frames late, masking refined by the native refiner and the temporal
    propagator), with the overrides that let random tied weights track,
    each printed."""
    from monst3r_slam_torch.app.config import load_config

    cfg = load_config("config/base.yaml", set_global=False)
    overrides = (
        # the descriptor-confidence gates, calibrated for trained weights
        ("tracking", "Q_conf", 0.0), ("local_opt", "Q_conf", 0.0),
        # see DYN_THRESHOLD
        (None, "dynamic_mask_threshold", DYN_THRESHOLD),
    )
    for sec, key, val in overrides:
        d = cfg if sec is None else cfg[sec]
        name = key if sec is None else f"{sec}.{key}"
        print(f"dynamic tracked run: {name} = {val} (config/base.yaml: {d.get(key)})", flush=True)
        d[key] = val
    return cfg


def phase_raft_reference(seed: int) -> dict:
    """RAFT on the card against the same code's CPU path (which the CPU
    tests hold to the JAX package) on one 64x80 pair at RAFT's full widths,
    3 iterations, f32 on both sides (TF32 off): the flow within 1e-4 of its
    scale, and the fused uint8 error map within one step (1/255). Then
    `raft_flow` timed on the card at the main path's 384x512 and 20
    iterations: calls back to back (`time_ms`) and the device alone
    (`device_ms`)."""
    import torch

    from monst3r_slam_torch.core import lie
    from monst3r_slam_torch.dynamic import raft

    cfg = raft.RAFTConfig(iters=3)
    params = raft.init_raft_params(torch.Generator().manual_seed(seed + 2), cfg)
    u0 = np.uint8(np.round((synthetic_frame(seed, 64, 80) * 0.5 + 0.5) * 255))
    u1 = np.roll(u0, 2, axis=1)
    T_j = lie.sim3_retr(lie.sim3_identity(), torch.tensor([0.02, 0, 0, 0, 0.01, 0, 0]))
    K = np.asarray([[80.0, 0, 40], [0, 80.0, 32], [0, 0, 1]], np.float32)
    depth = np.full((64, 80), 2.0, np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to_device(params, dev)
        flow = raft.raft_flow(p, torch.from_numpy(u0).float().to(dev),
                              torch.from_numpy(u1).float().to(dev), cfg).cpu()
        err = raft.make_fused_flow_error_program(p, cfg)(u0, u1, lie.sim3_identity(), T_j, depth, K)
        out[dev] = (flow, err)
    scale = float(out["cpu"][0].abs().max())
    flow_err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    map_err = float(np.abs(out["cuda"][1] - out["cpu"][1]).max())
    ok = flow_err <= 1e-4 * scale and map_err <= 1 / 255 + 1e-6
    print(f"raft reference (full widths, 3 iterations, 64x80, f32): card vs CPU path flow max "
          f"|d| {flow_err:.3e} px of scale {scale:.3f} (tol 1e-4 of scale), fused u8 error map "
          f"max |d| {map_err:.5f} (tol 1/255)", flush=True)
    if not ok:
        fail("raft reference: the card's RAFT differs from the CPU path beyond the tolerance")
    p = _to_device(params, "cuda")
    a, b = (torch.from_numpy(synthetic_frame(seed + i, H, W) * 127.5 + 127.5).to("cuda")
            for i in (0, 1))
    full = raft.RAFTConfig()
    ms = time_ms(lambda: raft.raft_flow(p, a, b, full), iters=3, warmup=1)
    dev = device_ms(lambda: raft.raft_flow(p, a, b, full), iters=3, warmup=1)
    print(f"raft_flow {H}x{W}, {full.iters} iterations, f32: {ms:.2f} ms back to back, device "
          f"{dev:.2f} ms", flush=True)
    return dict(flow_max_abs_err=flow_err, flow_scale=scale, map_max_abs_err=map_err,
                raft_ms=ms, raft_device_ms=dev)


def dynamic_stage_split(slam, n: int) -> dict:
    """`n` more frames through `slam`, each the last keyframe's image again,
    with no keyframe event, the launch counters zeroed just before and read
    just after: per-frame wall ms, the median device ms of each frame's
    `encode`, `decode` and `match_track` spans (the port's recorder,
    utils/timing: CUDA events at each span's ends, nothing synchronized
    between stages) and the host ms of the decode's parts (`prof`), and
    the launches per tracked frame."""
    import torch

    from monst3r_slam_torch.ops.attention import fused_attention
    from monst3r_slam_torch.ops.matching_pallas import tile_match_kernel
    from monst3r_slam_torch.utils import timing

    slam.finalize()
    slam.prof.clear()
    uimg = slam.kf_uimgs[slam.n_kf - 1]
    img = torch.from_numpy((uimg.astype(np.float32) / 255.0 - 0.5) / 0.5).to("cuda")
    counters = (fused_attention, tile_match_kernel)
    for fn in counters:
        fn.launches = 0
    for route in fused_attention.route_launches:
        fused_attention.route_launches[route] = 0
    wall = []
    for i in range(n):
        t0 = time.perf_counter()
        slam.process_frame(1000 + i, 0.0, img, uimg=uimg, force_kf=False)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    slam.finalize()
    launches = {fn.__name__: fn.launches for fn in counters}
    routes = dict(fused_attention.route_launches)
    fids = range(1000, 1000 + n)
    rows = [s for s in timing.spans() if s.rid in fids and s.device_ms is not None]
    stages = {}
    for k in ("encode", "decode", "match_track"):
        dev = [s.device_ms for s in rows if s.name == k]
        if dev:
            stages[f"{k} (device)"] = float(np.median(dev))
    stages.update({k: float(np.median(v)) for k, v in slam.prof.items()
                   if k in ("decode_monst3r", "flow_program", "decode_mast3r", "mask_refine",
                            "resolve_prev", "mask_share") and v})
    return dict(wall_ms=wall, stages=stages, launches=launches, routes=routes,
                n_masked=len(slam.prof.get("mask_share", [])))


def phase_dynamic(seed: int, card: str) -> dict:
    """The dynamic pipeline through its entry point, `main_monster_torch.py`,
    at MAST3R_512 + MONST3R_512 full width and depth with RAFT at full width
    and 20 iterations. Three runs:
      * the CLI, unchanged, in a subprocess on 8 PNG frames of a panning
        camera with config/dynamic_mask_test.yaml (masking, no refinement,
        every fourth frame), the calibration and `--raft-checkpoint random`
        (random untied weights: a plumbing and export check);
      * `main_monster_torch.run` in this process with tied weights on
        `n` copies of one frame with a moving square, config/base.yaml
        (masking, then the native refiner and the temporal propagator) and
        the calibration: frames must track with a non-empty mask applied, a
        keyframe event must decode its edges with both decoders, and both
        kernels must launch, kernel A only on the bf16 tensor-core route.
        Counters zeroed just before, read just after;
      * a stage split on the same system (`dynamic_stage_split`): exactly
        120 kernel A launches (24 encoder + 2 x 48 decoder) and one kernel B
        launch per tracked frame."""
    import shutil

    import torch

    import main_monster_torch
    from monst3r_slam_torch.dynamic import mask as dyn_mask
    from monst3r_slam_torch.dynamic.inference import DualParams
    from monst3r_slam_torch.models.config import MAST3R_512, MONST3R_512
    from monst3r_slam_torch.ops.attention import fused_attention
    from monst3r_slam_torch.ops.matching_pallas import tile_match_kernel

    shutil.rmtree(ROOT / "logs" / "smoke_dynamic_cli", ignore_errors=True)
    n_cli = 8
    cli_dir = DYN_DIR / "cli"
    write_frames(cli_dir, [np.roll(f, 4 * i, axis=1) for i, f in enumerate(dynamic_frames(seed, n_cli))])
    cmd = [sys.executable, "main_monster_torch.py", "--dataset", str(cli_dir),
           "--config", "config/dynamic_mask_test.yaml", "--calib", "config/intrinsics.yaml",
           "--raft-checkpoint", "random", "--no-viz", "--max-frames", str(n_cli),
           "--save-as", "smoke_dynamic_cli"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=420)
    cli_s = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"main_monster_torch.py exited {out.returncode}:\n{out.stdout[-2000:]}\n"
             f"{out.stderr[-4000:]}")
    for want in ("RAFT flow estimator installed (random init", "saved results to"):
        if want not in out.stdout:
            fail(f"main_monster_torch.py did not print {want!r}:\n{out.stdout[-2000:]}")
    n_sub = len(range(0, n_cli, 4))  # dynamic_mask_test.yaml keeps every fourth frame
    n_kf_cli = check_export(ROOT / "logs" / "smoke_dynamic_cli", "cli", n_sub)
    done = [ln for ln in out.stdout.splitlines() if ln.startswith("done:")]
    print(f"dynamic CLI: {' '.join(cmd[1:])}: exit 0 in {cli_s:.1f} s; "
          f"{done[0] if done else ''}; export well-formed ({n_kf_cli} keyframes, {n_sub} frames)",
          flush=True)

    print("dynamic tracked run: MonST3R's last head convolution set for a pointmap in front "
          "of the camera (front_depth)", flush=True)
    dual = DualParams(tied_params(MONST3R_512, seed + 1, synthetic_frame(seed, H, W)), MONST3R_512,
                      tied_params(MAST3R_512, seed), MAST3R_512)
    n = 8
    frames = dynamic_frames(seed, n)
    tracked_dir = DYN_DIR / "tracked"
    write_frames(tracked_dir, frames)
    shutil.rmtree(ROOT / "logs" / "smoke_dynamic", ignore_errors=True)
    args = main_monster_torch.parse_args([
        "--dataset", str(tracked_dir), "--calib", "config/intrinsics.yaml", "--no-viz",
        "--raft-checkpoint", "random", "--seed", str(seed), "--save-as", "smoke_dynamic"])
    cfg = dynamic_config()
    main_monster_torch.install_flow(args.raft_checkpoint, seed + 2, "cuda")
    torch.cuda.synchronize()
    counters = (fused_attention, tile_match_kernel)
    for fn in counters:
        fn.launches = 0
    for route in fused_attention.route_launches:
        fused_attention.route_launches[route] = 0
    t0 = time.perf_counter()
    try:
        slam, frame_ms = main_monster_torch.run(args, cfg, dual)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        routes = dict(fused_attention.route_launches)
        check_export(ROOT / "logs" / "smoke_dynamic", "tracked", n)
        p = slam.prof
        shares = p.get("mask_share", [])
        kf_events = len(p.get("kf_event", []))
        row = dict(frames=n, seconds=secs, frame_ms=frame_ms, mask_share=shares,
                   mask_refine_ms=list(p.get("mask_refine", [])),
                   keyframes=slam.keyframe_trajectory()[1].tolist(),
                   edges=slam.graph.edge_list(), kf_events=kf_events,
                   async_solves=slam.n_async_solves, relocs=slam.n_relocs,
                   reloc_attempts=slam.n_reloc_attempts, launches=launches, routes=routes,
                   threshold=slam.dyn_threshold)
        print(f"dynamic tracked run, MAST3R_512 + MONST3R_512 {H}x{W} from 480x640 PNGs, RAFT "
              f"20 iterations: MonST3R depth median {float(slam.mem.X_canon[0, :, 2].median()):.3f}, "
              f"min {float(slam.mem.X_canon[0, :, 2].min()):.3f}; "
              f"{n} frames in {secs:.2f} s = {1e3 * secs / n:.1f} ms/frame; "
              f"per-frame host ms {[round(t, 1) for t in frame_ms]}; mask pixel share per "
              f"tracked frame {[round(s, 4) for s in shares]}; keyframes {row['keyframes']}; "
              f"edges {row['edges']}; keyframe events {kf_events}, worker solves "
              f"{slam.n_async_solves}; relocalizations {slam.n_relocs}/{slam.n_reloc_attempts}; "
              f"launches {launches}, attention by route {routes}", flush=True)
        split = dynamic_stage_split(slam, 4)
    finally:
        dyn_mask.set_flow_estimator(None)
        dyn_mask.set_flow_error_program(None)
    row["split"] = split
    print(f"dynamic stage split ({card}), 4 tracked frames, device ms of the recorder's stage "
          f"spans and host ms of the decode's parts: wall ms "
          f"{[round(t, 1) for t in split['wall_ms']]}; stage medians (ms) "
          + ", ".join(f"{k} {v:.2f}" for k, v in split["stages"].items())
          + f"; launches {split['launches']}, attention by route {split['routes']}", flush=True)
    n_masked = sum(s > 0 for s in shares)
    if n_masked < 4:
        fail(f"dynamic tracked run: {n_masked} frames tracked with a non-empty mask (< 4): "
             f"{shares}")
    if kf_events < 1 or not any(i != j for i, j in row["edges"]):
        fail(f"dynamic tracked run: no keyframe event decoded an edge ({kf_events} events, "
             f"edges {row['edges']})")
    if min(launches.values()) < 1:
        fail(f"dynamic tracked run: a kernel of the path never launched: {launches}")
    if routes["f32"] != 0 or routes["bf16_tc"] < 120 * n_masked:
        fail(f"dynamic tracked run: attention left the bf16 tensor-core route: {routes}")
    k = len(split["wall_ms"])
    if split["n_masked"] != k or split["launches"] != {"fused_attention": 120 * k,
                                                        "tile_match_kernel": k}:
        fail(f"dynamic stage split: {split['n_masked']} of {k} frames masked, launches "
             f"{split['launches']} (want 120 and 1 per tracked frame)")
    if split["routes"]["bf16_tc"] != 120 * k:
        fail(f"dynamic stage split: attention left the bf16 tensor-core route: {split['routes']}")
    if not np.isfinite(slam.full_trajectory()[1]).all():
        fail("dynamic tracked run: non-finite pose")

    prof = subprocess.run([sys.executable, "scripts/profile_torch_slice.py", "--dynamic",
                           "--frames", "3"], cwd=ROOT, capture_output=True, text=True, timeout=420)
    busy = [ln for ln in prof.stdout.splitlines() if ln.startswith("device busy")]
    if prof.returncode != 0 or not busy:
        fail(f"profile_torch_slice.py --dynamic failed:\n{prof.stdout[-2000:]}\n"
             f"{prof.stderr[-3000:]}")
    print(f"dynamic profile ({card}): {busy[0]}", flush=True)
    row["profile_busy"] = busy[0]
    return row, dual


SAM2_DIR = ROOT / "build" / "smoke_sam2"  # the video predictor's config


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def sam2_reference(seed: int) -> dict:
    """SAM2 at SAM2_BASE_PLUS (Hiera-B+, 1024x1024) and VIDEO_BASE_PLUS on the
    card against the same code's CPU path (which the CPU tests hold to the
    JAX package) on the same random weights (from `--seed + 3` and `+ 4`, the
    CLI's seeds) and inputs, f32 on both sides (TF32 off): `sam2_encode`'s
    three outputs within 1e-3 of their scale, `sam2_decode_select` on 8
    prompt rows (3 points, 5 padding: the refiner's batch) with at most
    0.1% of the mask pixels differing (logits near 0) and the IoUs within
    1e-3 of their scale, and the video predictor's two frames (a
    conditioning frame, then a memory-conditioned one) with logits within
    1e-3 of their scale and at most 0.1% of their signs differing. Then
    `sam2_encode` and one memory-conditioned video step (encoder, memory
    attention over the bank, decoder and memory encoder) timed on the card;
    their bounds from the operations the CPU run counted
    (torch.utils.flop_counter) at the f32 peak. Returns the card's weights
    and the timings."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from monst3r_slam_torch.dynamic import sam2, sam2_video

    cfg, vcfg = sam2.SAM2_BASE_PLUS, sam2_video.VIDEO_BASE_PLUS
    S = cfg.img_size
    params = sam2.init_sam2_params(torch.Generator().manual_seed(seed + 3), cfg)
    vparams = sam2_video.init_video_params(torch.Generator().manual_seed(seed + 4), cfg, vcfg)
    img = synthetic_frame(seed, S, S) * 0.5 + 0.5
    frames = [img, np.roll(img, 16, axis=1)]
    pts = np.zeros((8, 1, 2), np.float32)
    lbs = -np.ones((8, 1), np.int64)
    pts[:3, 0] = [(0.5, 0.5), (0.25, 0.6), (0.8, 0.3)]
    lbs[:3] = 1

    def run(p, vp, count=False):
        device = sam2._device_of(p)
        x = torch.from_numpy(img)[None].to(device)
        fc_enc, fc_step = FlopCounterMode(display=False), FlopCounterMode(display=False)
        with fc_enc if count else contextlib.nullcontext():
            emb = sam2.sam2_encode(p, cfg, x)
        sel, iou = sam2.sam2_decode_select(p, cfg, *emb, torch.from_numpy(pts).to(device),
                                           torch.from_numpy(lbs).to(device))
        pred = sam2_video.Sam2VideoPredictor(p, vp, cfg, vcfg)
        state = pred.init_state(frames)
        pred.add_new_points(state, 0, 1, np.asarray([[[S / 2, S / 2]]], np.float32),
                            np.ones((1, 1), np.int64))
        steps = pred.propagate_in_video(state)
        logits = [next(steps)[2]]
        with fc_step if count else contextlib.nullcontext():
            logits.append(next(steps)[2])
        out = dict(emb=[t.cpu() for t in emb], sel=sel.cpu(), iou=iou.cpu(),
                   logits=[t.cpu() for t in logits], pred=pred, state=state)
        if count:
            out.update(enc_flops=fc_enc.get_total_flops(), step_flops=fc_step.get_total_flops())
        return out

    t0 = time.perf_counter()
    ref = run(params, vparams, count=True)
    cpu_s = time.perf_counter() - t0
    pc, vpc = _to_device(params, "cuda"), _to_device(vparams, "cuda")
    got = run(pc, vpc)
    torch.cuda.synchronize()

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    enc_err = max(rel(a, b) for a, b in zip(got["emb"], ref["emb"]))
    sel_diff = float((got["sel"] != ref["sel"]).float().mean())
    iou_err = rel(got["iou"], ref["iou"])
    vid_err = max(rel(a, b) for a, b in zip(got["logits"], ref["logits"]))
    vid_sign = max(float(((a > 0) != (b > 0)).float().mean())
                   for a, b in zip(got["logits"], ref["logits"]))
    print(f"sam2 reference (SAM2_BASE_PLUS {S}x{S}, VIDEO_BASE_PLUS, full depth: stages "
          f"{cfg.stages}, {vcfg.mem_layers} memory-attention layers; f32): card vs CPU path "
          f"sam2_encode within {enc_err:.3e} of scale; decode_select masks differ on "
          f"{sel_diff:.2e} of the pixels, IoU within {iou_err:.3e}; video frames (conditioning, "
          f"memory-conditioned) logits within {vid_err:.3e}, signs differ on {vid_sign:.2e}; "
          f"the CPU side took {cpu_s:.1f} s", flush=True)
    if not (enc_err <= 1e-3 and sel_diff <= 1e-3 and iou_err <= 1e-3 and vid_err <= 1e-3
            and vid_sign <= 1e-3):
        fail("sam2 reference: the card's SAM2 differs from the CPU path beyond the tolerance")

    pred, state = got["pred"], got["state"]
    x, x2 = state["images"]
    empty_pts = torch.zeros((1, 1, 2), device=x.device)
    empty_lbs = -torch.ones((1, 1), dtype=torch.int64, device=x.device)

    def video_step():  # an unprompted frame conditioned on the bank of frames 0 and 1
        feats = sam2.encode_features(pc, cfg, x2)
        return sam2_video._condition_and_decode(
            pc, vpc, cfg, vcfg, *feats, *pred._bank_views(state, 2, 0), empty_pts, empty_lbs,
            is_cond=False, multimask=False)

    img_bytes = x.numel() * 4
    enc_bytes = _tree_bytes(pc) + img_bytes + sum(t.numel() * 4 for t in got["emb"])
    step_bytes = (_tree_bytes(pc) + _tree_bytes(vpc) + img_bytes
                  + 2 * state["mem_feat"].numel() * 4 + state["obj_ptrs"].numel() * 4)
    row = dict(cpu_s=cpu_s, enc_max_rel_err=enc_err, select_pixels_differ=sel_diff,
               iou_max_rel_err=iou_err, video_max_rel_err=vid_err, video_signs_differ=vid_sign,
               enc_flops=ref["enc_flops"], step_flops=ref["step_flops"])
    for name, fn, n_bytes, flops in (("encode", lambda: sam2.sam2_encode(pc, cfg, x), enc_bytes,
                                      ref["enc_flops"]),
                                     ("video_step", video_step, step_bytes, ref["step_flops"])):
        ms = time_ms(fn, iters=5, warmup=2)
        dev = device_ms(fn, iters=5, warmup=2)
        b_ms, b_by = bound_ms(n_bytes, flops / PEAK_F32)
        row[name] = dict(ms=ms, device_ms=dev, bound_ms=b_ms, bound_by=b_by, flops=flops)
        print(f"sam2 {name} (SAM2_BASE_PLUS {S}x{S}, f32): {ms:.2f} ms back to back, device "
              f"{dev:.2f} ms; {flops / 1e12:.4f} TFLOP (counted on the CPU run), bound "
              f"{b_ms:.3f} ms ({b_by}, f32 at {PEAK_F32 / 1e12:.0f} TFLOP/s)", flush=True)
    row["weights"] = (pc, vpc)
    return row


def phase_sam2(seed: int, card: str, dyn: dict, dual) -> dict:
    """SAM2 mask refinement on the dynamic path, as `main_monster_slam.py`
    runs it with a SAM2 checkpoint. Three parts:
      * `sam2_reference`: Hiera-B+ and the video predictor at full width on
        the card against the CPU path, and their times;
      * the CLI, unchanged, in a subprocess twice on the dynamic phase's 8
        PNG frames with the calibration, random RAFT and `--sam2-checkpoint
        random` (SAM2_TEST): on config/base.yaml (the image refiner), and on
        a config under build/ that inherits it and sets
        `sam2_video_predictor: true`; each must exit 0, say which refiner it
        installed and write a well-formed export;
      * `main_monster_torch.run` in this process with the dynamic phase's
        tied weights and frames and the SAM2_BASE_PLUS image refiner
        (random weights) installed: frames must track with a non-empty
        mask, the refiner be called on every masked frame, and both kernels
        launch (counters zeroed just before, read just after). Its
        host-refinement stage stands beside the native refiner's in the
        dynamic phase's run. The random refiner's masks cover most of the
        frame, so tracking is lost after a few frames: no stage split runs
        here, since its frames would not reach the masked decode."""
    import shutil

    import torch

    import main_monster_torch
    from monst3r_slam_torch.dynamic import mask as dyn_mask
    from monst3r_slam_torch.dynamic import sam2
    from monst3r_slam_torch.ops.attention import fused_attention
    from monst3r_slam_torch.ops.matching_pallas import tile_match_kernel, tile_match_phase_kernel

    row = sam2_reference(seed)
    pc, _ = row.pop("weights")

    SAM2_DIR.mkdir(parents=True, exist_ok=True)
    video_cfg = SAM2_DIR / "video.yaml"
    video_cfg.write_text("inherit: config/base.yaml\nsam2_video_predictor: true\n")
    n_cli = 8
    for name, extra, want in (
            ("image", [], "SAM2 refiner installed (random init"),
            ("video", ["--config", str(video_cfg)], "SAM2 VIDEO-predictor refiner installed "
                                                     "(random init")):
        save_as = f"smoke_sam2_{name}_cli"
        shutil.rmtree(ROOT / "logs" / save_as, ignore_errors=True)
        cmd = [sys.executable, "main_monster_torch.py", "--dataset", str(DYN_DIR / "cli"),
               "--calib", "config/intrinsics.yaml", "--raft-checkpoint", "random",
               "--sam2-checkpoint", "random", "--no-viz", "--max-frames", str(n_cli),
               "--save-as", save_as, *extra]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=420)
        cli_s = time.perf_counter() - t0
        if out.returncode != 0:
            fail(f"main_monster_torch.py ({name} refiner) exited {out.returncode}:\n"
                 f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
        for line in (want, "saved results to"):
            if line not in out.stdout:
                fail(f"main_monster_torch.py ({name} refiner) did not print {line!r}:\n"
                     f"{out.stdout[-2000:]}")
        n_kf_cli = check_export(ROOT / "logs" / save_as, "cli", n_cli)
        done = [ln for ln in out.stdout.splitlines() if ln.startswith("done:")]
        row[f"cli_{name}_s"] = cli_s
        print(f"sam2 CLI ({name} refiner): {' '.join(cmd[1:])}: exit 0 in {cli_s:.1f} s; "
              f"{done[0] if done else ''}; export well-formed ({n_kf_cli} keyframes)", flush=True)

    refiner = sam2.Sam2Refiner(pc, sam2.SAM2_BASE_PLUS)
    n = len(dyn["frame_ms"])
    shutil.rmtree(ROOT / "logs" / "smoke_sam2", ignore_errors=True)
    args = main_monster_torch.parse_args([
        "--dataset", str(DYN_DIR / "tracked"), "--calib", "config/intrinsics.yaml", "--no-viz",
        "--raft-checkpoint", "random", "--seed", str(seed), "--save-as", "smoke_sam2"])
    cfg = dynamic_config()
    main_monster_torch.install_flow(args.raft_checkpoint, seed + 2, "cuda")
    dyn_mask.set_mask_refiner(refiner)
    torch.cuda.synchronize()
    counters = (fused_attention, tile_match_kernel, tile_match_phase_kernel)
    for fn in counters:
        fn.launches = 0
    for route in fused_attention.route_launches:
        fused_attention.route_launches[route] = 0
    t0 = time.perf_counter()
    try:
        slam, frame_ms = main_monster_torch.run(args, cfg, dual)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        routes = dict(fused_attention.route_launches)
        check_export(ROOT / "logs" / "smoke_sam2", "tracked", n)
        shares = slam.prof.get("mask_share", [])
        kf_events = len(slam.prof.get("kf_event", []))
        print(f"sam2 tracked run, MAST3R_512 + MONST3R_512 {H}x{W}, RAFT 20 iterations, "
              f"SAM2_BASE_PLUS image refiner (random weights) under the temporal propagator: "
              f"{n} frames in {secs:.2f} s; per-frame host ms {[round(t, 1) for t in frame_ms]}; "
              f"mask pixel share per tracked frame {[round(v, 4) for v in shares]}; refiner "
              f"calls {refiner.calls}, components replaced {refiner.replaced}, rejected (IoU under "
              f"{refiner.iou_floor}) {refiner.rejected}; keyframes "
              f"{slam.keyframe_trajectory()[1].tolist()}, keyframe events {kf_events}; "
              f"relocalizations {slam.n_relocs}/{slam.n_reloc_attempts}; launches {launches}, "
              f"attention by route {routes}", flush=True)
    finally:
        dyn_mask.set_flow_estimator(None)
        dyn_mask.set_flow_error_program(None)
        dyn_mask.set_mask_refiner(None)
    # the host refinement as the pipeline runs it (no synchronization between
    # stages): the refiner's read-back waits for the queued MASt3R decode
    refine_ms = slam.prof.get("mask_refine", [float("nan")])
    refine = float(np.median(refine_ms))
    native = float(np.median(dyn["mask_refine_ms"]))
    print(f"sam2 host refinement ({card}): median {refine:.2f} ms per masked frame "
          f"{[round(t, 1) for t in refine_ms]} with the SAM2_BASE_PLUS refiner, "
          f"against {native:.2f} ms {[round(t, 1) for t in dyn['mask_refine_ms']]} with the "
          f"native refiner in the dynamic phase's tracked run (same frames and weights; "
          f"{dyn['split']['stages'].get('mask_refine', float('nan')):.2f} ms in its "
          f"stage split)", flush=True)
    row.update(frames=n, seconds=secs, frame_ms=frame_ms, mask_share=shares,
               refiner_calls=refiner.calls, replaced=refiner.replaced, rejected=refiner.rejected,
               kf_events=kf_events, launches=launches, routes=routes,
               refine_ms=list(refine_ms), refine_median_ms=refine,
               native_refine_median_ms=native)
    n_masked = sum(v > 0 for v in shares)
    if n_masked < 2 or kf_events < 1:
        fail(f"sam2 tracked run: {n_masked} frames tracked with a non-empty mask (< 2) and "
             f"{kf_events} keyframe events: {shares}")
    if refiner.calls != len(shares):
        fail(f"sam2 tracked run: the SAM2 refiner ran {refiner.calls} times for {len(shares)} "
             "masked frames")
    if min(launches["fused_attention"], launches["tile_match_kernel"]) < 1:
        fail(f"sam2 tracked run: a kernel of the path never launched: {launches}")
    if routes["f32"] != 0:
        fail(f"sam2 tracked run: attention left the bf16 tensor-core route: {routes}")
    if not np.isfinite(slam.full_trajectory()[1]).all():
        fail("sam2 tracked run: non-finite pose")
    return row


EASI_DIR = ROOT / "build" / "smoke_easi3r"  # the easi3r phase's logs


def easi3r_reference(seed: int) -> dict:
    """`easi3r_double_inference_pair` at MONST3R_512 full depth on one 384x512
    pair (a frame and the same frame shifted by 8 px with a square moved),
    random weights from `--seed + 1` (the CLI's), on the card against the
    port's CPU path (which the CPU tests hold to the JAX package) on the
    same encoder features: in f32 on both sides (TF32 off, kernel A's f32
    route on the card) X and C within 1e-3 of their scale and the token
    masks equal, with the smallest distance of a token's received attention
    from its threshold printed; then the card's bf16 run (the pipeline's)
    against its f32 run, the share of tokens whose mask differs reported.
    The operations of the double inference are counted on the CPU run
    (torch.utils.flop_counter, which does not see kernel A's launches on
    the card). Returns the row and the card's weights and features."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from monst3r_slam_torch.dynamic import easi3r
    from monst3r_slam_torch.models import mast3r
    from monst3r_slam_torch.models.config import MONST3R_512
    from monst3r_slam_torch.models.convert import cast_params_for_inference
    from monst3r_slam_torch.models.init import init_params

    cfg = MONST3R_512
    params = init_params(torch.Generator(device="cuda").manual_seed(seed + 1), cfg)
    img = synthetic_frame(seed, H, W)
    img2 = np.roll(img, 8, axis=1).copy()
    img2[150:200, 250:300] = img[100:150, 100:150]
    x = torch.from_numpy(np.stack([img, img2])).to("cuda")
    feat, pos = mast3r.encode(params, cfg, x, torch.float32)
    args = (feat[:1], pos[:1], feat[1:], pos[1:])
    got = easi3r.easi3r_double_inference_pair(params, cfg, *args, (H, W), dtype=torch.float32)
    _, _, a1, a2 = easi3r._decode_pair_attn(params, cfg, *args, dtype=torch.float32)
    torch.cuda.synchronize()
    pc = _to_device(params, "cpu")
    cargs = _to_device(args, "cpu")
    fc = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with fc:
        ref = easi3r.easi3r_double_inference_pair(pc, cfg, *cargs, (H, W), dtype=torch.float32)
    cpu_s = time.perf_counter() - t0
    flops = fc.get_total_flops()
    _, _, c1, c2 = easi3r._decode_pair_attn(pc, cfg, *cargs, dtype=torch.float32)
    errs = {n: float((getattr(got, n).cpu() - getattr(ref, n)).abs().max()
                     / getattr(ref, n).abs().max()) for n in ("X1", "C1", "X2", "C2")}
    masks_equal = all(torch.equal(getattr(got, n).cpu(), getattr(ref, n))
                      for n in ("dyn_mask1", "dyn_mask2"))
    margin = float("inf")
    for a in (c1, c2):
        med = easi3r._median(a)
        thr = med - 2.0 * torch.clamp(easi3r._median((a - med).abs()), min=1e-6)
        margin = min(margin, float((a - thr).abs().min()))
    attn_err = max(float((a.cpu() - c).abs().max()) for a, c in ((a1, c1), (a2, c2)))
    share = [float(getattr(ref, n).float().mean()) for n in ("dyn_mask1", "dyn_mask2")]
    pb = cast_params_for_inference(params)
    bf = easi3r.easi3r_double_inference_pair(pb, cfg, *args, (H, W))
    bf_diff = [float((getattr(bf, n) != getattr(got, n)).float().mean())
               for n in ("dyn_mask1", "dyn_mask2")]
    print(f"easi3r reference (MONST3R_512 full depth, {H}x{W}, f32): card vs CPU path X1/C1/X2/C2 "
          f"within {', '.join(f'{v:.3e}' for v in errs.values())} of scale (tol 1e-3); received "
          f"attention within {attn_err:.3e}; token masks equal: {masks_equal} (dynamic share "
          f"{share[0]:.4f} / {share[1]:.4f}; nearest token {margin:.3e} from its threshold); "
          f"bf16 on the card: masks differ from f32 on {bf_diff[0]:.4f} / {bf_diff[1]:.4f} of "
          f"the pixels; the CPU side took {cpu_s:.1f} s, {flops / 1e12:.4f} TFLOP counted",
          flush=True)
    if not (max(errs.values()) <= 1e-3 and masks_equal):
        fail("easi3r reference: the card's double inference differs from the CPU path beyond "
             "the tolerance")
    row = dict(max_rel_err=errs, attn_max_abs_err=attn_err, masks_equal=masks_equal,
               mask_share=share, threshold_margin=margin, bf16_mask_differs=bf_diff,
               cpu_s=cpu_s, flops=flops)
    return row, pb, args


def phase_easi3r(seed: int, card: str, dual) -> dict:
    """The Easi3R pipeline as `main_easier_slam.py` runs it, through the
    port's `main_easier_torch.py`, at MAST3R_512 + MONST3R_512 full width
    and depth:
      * `easi3r_reference`: the double inference on the card against the
        CPU path, and its bf16 masks;
      * pass 1 (the attention statistics), the whole double inference and,
        beside them, a plain decoder pass (`croco.decode_pair`, what each
        MASt3R or MonST3R decode runs) timed in bf16 back to back
        (`time_ms`) and as device time (`profiled_ms`: each call launches
        thousands of kernels), beside the bound of the operations counted
        on the CPU run at 989 TFLOP/s bf16 and of the weights' bytes;
      * `main_easier_torch.run` in this process on the dynamic phase's 8
        frames (a moving square) with its tied weights and `front_depth`
        (the MonST3R draw as the Easi3R model) and the calibration: frames
        must track with the attention masks applied, a keyframe event must
        decode its edges, kernels A and B must launch (counters zeroed just
        before, read just after), A only on the bf16 tensor-core route;
        then 3 more tracked frames synchronized one by one, each launching
        kernel A 120 times (24 encoder + 24 + 24 in the two Easi3R passes'
        self-attention + 48 in the MASt3R decode) and B once;
      * the CLI, unchanged, in a subprocess with random weights on the
        dynamic phase's 8 PNGs with `--no-viz`: exit 0 and a well-formed
        export."""
    import shutil
    import statistics

    import torch

    import main_easier_torch
    from monst3r_slam_torch.app import pipeline
    from monst3r_slam_torch.dynamic import easi3r
    from monst3r_slam_torch.dynamic.inference import EasiParams
    from monst3r_slam_torch.models import croco
    from monst3r_slam_torch.models.config import MAST3R_512, MONST3R_512
    from monst3r_slam_torch.ops.attention import fused_attention
    from monst3r_slam_torch.ops.matching_pallas import tile_match_kernel

    row, pb, args = easi3r_reference(seed)
    cfg = MONST3R_512
    n_bytes = _tree_bytes(pb) + sum(t.numel() * t.element_size() for t in args)
    b_ms, b_by = bound_ms(n_bytes, row["flops"] / PEAK_BF16)
    for name, fn in (("pass1", lambda: easi3r._decode_pair_attn(pb, cfg, *args)),
                     ("double", lambda: easi3r.easi3r_double_inference_pair(pb, cfg, *args,
                                                                            (H, W))),
                     ("plain_decoder", lambda: croco.decode_pair(pb, cfg, *args))):
        dev, n_launch = profiled_ms(fn)
        row[name] = dict(ms=time_ms(fn, iters=5, warmup=2), device_ms=dev, launches=n_launch)
    row.update(bound_ms=b_ms, bound_by=b_by)
    print(f"easi3r timing (MONST3R_512, {H}x{W}, bf16; {card}): "
          + "; ".join(f"{name} {row[name]['ms']:.2f} ms back to back, device "
                      f"{row[name]['device_ms']:.2f} ms in {row[name]['launches']:.0f} launches"
                      for name in ("pass1", "double", "plain_decoder"))
          + f"; the double inference's bound {b_ms:.3f} ms ({b_by}; {row['flops'] / 1e12:.4f} "
          f"TFLOP at {PEAK_BF16 / 1e12:.0f} TFLOP/s bf16, {n_bytes / 1e6:.1f} MB)", flush=True)
    del pb, args

    ep = EasiParams(dual.monst3r, MONST3R_512, dual.mast3r, MAST3R_512, k_mad=2.0)
    n = 8
    shutil.rmtree(ROOT / "logs" / "smoke_easi3r", ignore_errors=True)
    run_args = main_easier_torch.parse_args([
        "--dataset", str(DYN_DIR / "tracked"), "--calib", "config/intrinsics.yaml", "--no-viz",
        "--seed", str(seed), "--save-as", "smoke_easi3r"])
    tcfg = dynamic_config()
    share_t = []
    infer = pipeline.easi3r_asymmetric_inference

    def recording(*a, **k):  # the masked share of C1, read after the run
        out = infer(*a, **k)
        share_t.append((out.C1 == 0).float().mean())
        return out

    pipeline.easi3r_asymmetric_inference = recording
    torch.cuda.synchronize()
    counters = (fused_attention, tile_match_kernel)
    for fn in counters:
        fn.launches = 0
    for route in fused_attention.route_launches:
        fused_attention.route_launches[route] = 0
    t0 = time.perf_counter()
    try:
        slam, frame_ms = main_easier_torch.run(run_args, tcfg, ep)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        routes = dict(fused_attention.route_launches)
        check_export(ROOT / "logs" / "smoke_easi3r", "tracked", n)
        shares = [float(v) for v in share_t]
        kf_events = len(slam.prof.get("kf_event", []))
        n_tracked = sum(1 for v in slam.prof.get("track_dispatch", []))
        # 3 more frames, each the last keyframe's image, synchronized one by one
        slam.finalize()
        uimg = slam.kf_uimgs[slam.n_kf - 1]
        img = torch.from_numpy((uimg.astype(np.float32) / 255.0 - 0.5) / 0.5).to("cuda")
        for fn in counters:
            fn.launches = 0
        sync_ms = []
        for i in range(3):
            t1 = time.perf_counter()
            slam.process_frame(1000 + i, 0.0, img, uimg=uimg, force_kf=False)
            torch.cuda.synchronize()
            sync_ms.append((time.perf_counter() - t1) * 1e3)
        slam.finalize()
        split_launches = {fn.__name__: fn.launches for fn in counters}
        split_modes = slam.mode.name
    finally:
        pipeline.easi3r_asymmetric_inference = infer
    med = statistics.median(frame_ms[1:])
    row.update(frames=n, seconds=secs, frame_ms=frame_ms, frame_median_ms=med,
               sync_frame_ms=sync_ms, mask_share=shares, kf_events=kf_events,
               n_tracked=n_tracked, keyframes=slam.keyframe_trajectory()[1].tolist(),
               edges=slam.graph.edge_list(), relocs=slam.n_relocs, launches=launches,
               routes=routes, split_launches=split_launches)
    print(f"easi3r tracked run ({card}), MAST3R_512 + MONST3R_512 {H}x{W} from 480x640 PNGs: "
          f"{n} frames in {secs:.2f} s; per-frame host ms (pipelined) "
          f"{[round(t, 1) for t in frame_ms]}, median after the first {med:.1f}; tracked "
          f"frames dispatched {n_tracked}; Easi3R mask share of C1 per decode "
          f"{[round(v, 4) for v in shares]}; keyframes {row['keyframes']}; edges {row['edges']}; "
          f"keyframe events {kf_events}; relocalizations {slam.n_relocs}/"
          f"{slam.n_reloc_attempts}; launches {launches}, attention by route {routes}; then 3 "
          f"frames synchronized one by one: {[round(t, 1) for t in sync_ms]} ms, launches "
          f"{split_launches}, mode {split_modes}", flush=True)
    if n_tracked < 4 or kf_events < 1 or not any(i != j for i, j in row["edges"]):
        fail(f"easi3r tracked run: {n_tracked} frames tracked, {kf_events} keyframe events, "
             f"edges {row['edges']}")
    if not any(v > 0 for v in shares):
        fail(f"easi3r tracked run: no decode masked a pixel: {shares}")
    if min(launches.values()) < 1 or routes["f32"] != 0:
        fail(f"easi3r tracked run: a kernel never launched or attention left the bf16 "
             f"tensor-core route: {launches}, {routes}")
    if split_modes != "TRACKING" or split_launches != {"fused_attention": 360,
                                                       "tile_match_kernel": 3}:
        fail(f"easi3r synchronized frames: mode {split_modes}, launches {split_launches} "
             "(want 120 and 1 per tracked frame)")
    if not np.isfinite(slam.full_trajectory()[1]).all():
        fail("easi3r tracked run: non-finite pose")

    shutil.rmtree(ROOT / "logs" / "smoke_easi3r_cli", ignore_errors=True)
    n_cli = 8
    cmd = [sys.executable, "main_easier_torch.py", "--dataset", str(DYN_DIR / "cli"), "--no-viz",
           "--max-frames", str(n_cli), "--save-as", "smoke_easi3r_cli"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=420)
    cli_s = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"main_easier_torch.py exited {out.returncode}:\n{out.stdout[-2000:]}\n"
             f"{out.stderr[-4000:]}")
    if "saved results to" not in out.stdout or "live viewer" in out.stdout:
        fail(f"main_easier_torch.py did not export headless:\n{out.stdout[-2000:]}")
    n_kf_cli = check_export(ROOT / "logs" / "smoke_easi3r_cli", "cli", n_cli)
    done = [ln for ln in out.stdout.splitlines() if ln.startswith("done:")]
    row["cli_s"] = cli_s
    print(f"easi3r CLI: {' '.join(cmd[1:])}: exit 0 in {cli_s:.1f} s; {done[0] if done else ''}; "
          f"export well-formed ({n_kf_cli} keyframes, {n_cli} frames)", flush=True)
    return row


def decode_state(blob: bytes) -> dict:
    """A `/state.bin` snapshot (layout in monst3r_slam_torch/viz/live.py) as
    arrays; fails unless the blob is exactly as long as its header says."""
    import struct

    seq, n_p, n_t, n_k, n_s, surf, gh, gw = struct.unpack_from("<8I", blob)
    out = dict(seq=seq, n_points=n_p, n_traj=n_t, n_kf=n_k, n_seg=n_s, surfel=surf, grid=(gh, gw))
    off = 32
    out["pts"] = np.frombuffer(blob, "<f4", n_p * 3, off).reshape(-1, 3)
    off += n_p * 15
    off += (4 - off % 4) % 4
    for name, k in (("traj", n_t * 3), ("kf", n_k * 3), ("segs", n_s * 6)):
        out[name] = np.frombuffer(blob, "<f4", k, off)
        off += 4 * k
    if surf:
        out["nrm"] = np.frombuffer(blob, "<f4", n_p * 3, off)
        out["rad"] = np.frombuffer(blob, "<f4", n_p, off + 12 * n_p)
        off += 16 * n_p
    if off != len(blob):
        fail(f"viewer: /state.bin is {len(blob)} bytes, its header says {off}")
    return out


def phase_viewer(seed: int, card: str) -> dict:
    """The live viewer, the default mode of the three CLIs, on the `main`
    phase's tied setup (MAST3R_512, 12 frames with noise at frame 6,
    `main_tracked_config`), through `main_torch.run` with a `LiveViewer`
    started here (the phase fails if it binds no port):
      * four runs to the end in turns, without the viewer, with it, with it,
        without it, for the frame medians with and without it. In the first
        run with it, a thread fetches `/state.bin` and `/frame.bin` over
        127.0.0.1 once the first snapshot is up: the header decodes,
        n_points > 0, every value finite but the NaN holes (whole points
        under the display threshold), the frame's size right. Pushes and
        their ms (`prof["viewer_push"]`: the surfel program per keyframe,
        the read-back, the blob). Counters zeroed just before, read just
        after the first run with the viewer;
      * `_surfel_snapshot` on the card against the CPU on that run's keyframe
        memory: points, radii and confidences within 1e-5 of their scale,
        normals within 1e-3 on all but 0.1% (a normal turns far where its
        tangents are nearly parallel);
      * a run where a thread POSTs {"terminate": true} to `/control` once
        the first snapshot is up: it must stop before its last frame and
        still export;
      * `main_torch.py`, unchanged, in a subprocess without `--no-viz` on 4
        of the `main` phase's CLI frames: exit 0, the viewer's line printed."""
    import json
    import shutil
    import statistics
    import struct
    import threading
    import urllib.request

    import torch

    import main_torch
    from monst3r_slam_torch.app.pipeline import _surfel_snapshot
    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.ops.attention import fused_attention
    from monst3r_slam_torch.ops.matching_pallas import tile_match_kernel
    from monst3r_slam_torch.viz.live import LiveViewer

    params = tied_params(MAST3R_512, seed)
    n = 12
    tracked_dir = MAIN_DIR / "tracked"  # written by the main phase
    counters = (fused_attention, tile_match_kernel)

    def tracked_run(save_as: str, viewer=None):
        shutil.rmtree(ROOT / "logs" / save_as, ignore_errors=True)
        args = main_torch.parse_args(["--dataset", str(tracked_dir), "--save-as", save_as]
                                     + ([] if viewer else ["--no-viz"]))
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        for route in fused_attention.route_launches:
            fused_attention.route_launches[route] = 0
        t0 = time.perf_counter()
        slam, frame_ms = main_torch.run(args, main_tracked_config(), params, MAST3R_512,
                                        viewer=viewer)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        return slam, frame_ms, secs, launches, dict(fused_attention.route_launches)

    def viewer_run(save_as: str, on_snapshot):
        viewer = LiveViewer()
        port = viewer.start()
        if port is None:
            fail("viewer: LiveViewer.start() bound no port in 8089-8104")
        got = {}

        def client():
            url = f"http://127.0.0.1:{port}"
            deadline = time.time() + 300
            while time.time() < deadline:
                blob = urllib.request.urlopen(url + "/state.bin", timeout=10).read()
                if len(blob) > 32 and decode_state(blob)["n_points"] > 0:
                    got["state"] = blob
                    got["frame"] = urllib.request.urlopen(url + "/frame.bin", timeout=10).read()
                    got["page"] = urllib.request.urlopen(url + "/", timeout=10).read()
                    on_snapshot(url, got)
                    return
                time.sleep(0.05)

        th = threading.Thread(target=client, daemon=True)
        th.start()
        try:
            out = tracked_run(save_as, viewer)
            th.join(timeout=60)
        finally:
            viewer.stop()
        if "state" not in got:
            fail("viewer: no snapshot with points was served during the run")
        return out + (viewer, got)

    def noop(url, got):
        pass

    off1 = tracked_run("smoke_viewer_off")
    slam, frame_ms, secs, launches, routes, viewer, got = viewer_run("smoke_viewer", noop)
    on2 = viewer_run("smoke_viewer_2", noop)
    off2 = tracked_run("smoke_viewer_off")
    check_export(ROOT / "logs" / "smoke_viewer", "tracked", n)
    st = decode_state(got["state"])
    holes = np.isnan(st["pts"]).any(1)
    finite = (np.isfinite(st["pts"][~holes]).all() and not np.isfinite(st["pts"][holes]).any()
              and all(np.isfinite(st[k]).all() for k in ("traj", "kf", "segs")))
    if st["surfel"]:
        finite = finite and np.isfinite(st["nrm"]).all() and np.isfinite(st["rad"]).all()
    fw, fh = struct.unpack_from("<2I", got["frame"])
    header = {k: st[k] for k in ("seq", "n_points", "n_traj", "n_kf", "n_seg", "surfel", "grid")}
    if not (st["n_points"] > 0 and finite and st["surfel"] == 1
            and st["n_points"] == st["n_kf"] * st["grid"][0] * st["grid"][1]
            and len(got["frame"]) == 8 + 3 * fw * fh and (fw, fh) == (256, 192)
            and b"state.bin" in got["page"]):
        fail(f"viewer: malformed snapshot: {header}, finite but the holes {finite}, "
             f"frame {fw}x{fh}")
    push_ms = slam.prof.get("viewer_push", []) + on2[0].prof.get("viewer_push", [])
    pushes = viewer._seq + on2[5]._seq
    medians = [statistics.median(r[1][1:]) for r in (off1, (slam, frame_ms), on2, off2)]
    row = dict(frames=n, seconds=secs, frame_ms=frame_ms, frame_medians_ms=medians,
               frame_ms_by_run=[off1[1], frame_ms, on2[1], off2[1]], pushes=pushes,
               push_ms=push_ms,
               snapshot=dict(seq=st["seq"], n_points=st["n_points"], holes=int(holes.sum()),
                             n_traj=st["n_traj"], n_kf=st["n_kf"], grid=st["grid"]),
               launches=launches, routes=routes)
    print(f"viewer runs ({card}), MAST3R_512 {H}x{W}, the main phase's tied setup, {n} frames "
          f"each: {pushes} pushes in the two runs with the viewer at "
          f"{[round(t, 2) for t in push_ms]} ms; frame medians after the first frame, without / "
          f"with / with / without the viewer: {' / '.join(f'{m:.1f}' for m in medians)} ms; "
          f"snapshot served: seq {st['seq']}, {st['n_points']} "
          f"points ({int(holes.sum())} NaN holes), {st['n_traj']} trajectory points, "
          f"{st['n_kf']} keyframes, grid {st['grid']}, frame {fw}x{fh}; launches {launches}, "
          f"attention by route {routes}", flush=True)
    if min(launches.values()) < 1 or routes["f32"] != 0 or viewer._seq < 2:
        fail(f"viewer run: launches {launches}, routes {routes}, pushes {viewer._seq}")
    if len(push_ms) != pushes:
        fail(f"viewer runs: {len(push_ms)} timed pushes for {pushes} snapshots")

    mem, (h, w) = slam.mem, slam.img_size
    worst, off_share = 0.0, 0.0
    for i in range(slam.n_kf):
        ins = (mem.X_canon[i], mem.C[i], mem.N[i], mem.T_WC[i])
        a = _surfel_snapshot(*ins, h=h, w=w, stride=2)
        b = _surfel_snapshot(*(t.cpu() for t in ins), h=h, w=w, stride=2)
        for k, (x, y) in enumerate(zip(a, b)):
            x = x.cpu()
            if k == 1:  # normals
                off_share = max(off_share, float(((x - y).abs() > 1e-3).any(-1).float().mean()))
            else:
                worst = max(worst, float((x - y).abs().max() / y.abs().max()))
    print(f"viewer surfel program: card vs CPU on {slam.n_kf} keyframes (stride 2): points, "
          f"radii, confidences within {worst:.3e} of scale (tol 1e-5); normals off by more "
          f"than 1e-3 on {off_share:.2e} of the points (tol 1e-3)", flush=True)
    if not (worst <= 1e-5 and off_share <= 1e-3):
        fail("viewer: the card's surfel program differs from the CPU")
    row.update(surfel_max_rel_err=worst, surfel_normals_off=off_share)

    def terminate(url, got):
        req = urllib.request.Request(url + "/control", data=json.dumps({"terminate": True})
                                     .encode(), method="POST")
        got["status"] = urllib.request.urlopen(req, timeout=10).status

    slam2, frame_ms2, _, _, _, _, got2 = viewer_run("smoke_viewer_terminate", terminate)
    n_done = len(slam2.frame_ids)
    print(f"viewer terminate run: POST /control {got2.get('status')} after the first snapshot; "
          f"{len(frame_ms2)} of {n} frames run, terminate_requested {slam2.terminate_requested}",
          flush=True)
    if not (slam2.terminate_requested and got2.get("status") == 200 and n_done < n):
        fail(f"viewer: terminate did not end the run early ({n_done} of {n} frames)")
    check_export(ROOT / "logs" / "smoke_viewer_terminate", "tracked", n_done)
    row["terminate_frames"] = n_done

    shutil.rmtree(ROOT / "logs" / "smoke_viewer_cli", ignore_errors=True)
    cmd = [sys.executable, "main_torch.py", "--dataset", str(MAIN_DIR / "cli"), "--max-frames",
           "4", "--save-as", "smoke_viewer_cli"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=420)
    cli_s = time.perf_counter() - t0
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("live viewer: http://127.0.0.1:")]
    if out.returncode != 0 or not line:
        fail(f"main_torch.py without --no-viz: exit {out.returncode}, viewer line {line}:\n"
             f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    check_export(ROOT / "logs" / "smoke_viewer_cli", "cli", 4)
    row["cli_s"] = cli_s
    print(f"viewer CLI: {' '.join(cmd[1:])}: exit 0 in {cli_s:.1f} s; printed {line[0]!r}",
          flush=True)
    return row


# ---------------------------------------------------------------------------
# The rest of SLAMSystem: the LM matcher, the fusion modes, the symmetric and
# fused-head decodes, SLAM-state files and chunked tracking
# ---------------------------------------------------------------------------

REST_DIR = ROOT / "build" / "smoke_rest"  # the state phase's files
FUSION_MODES = ("first", "recent", "best_score", "indep_conf", "weighted_pointmap",
                "weighted_spherical")


def _counters():
    from monst3r_slam_torch.ops.attention import fused_attention
    from monst3r_slam_torch.ops.matching_pallas import tile_match_kernel, tile_match_phase_kernel

    return fused_attention, tile_match_kernel, tile_match_phase_kernel


def zero_counts() -> None:
    """Every launch counter to 0, after the work queued before."""
    import torch

    from monst3r_slam_torch.ops.attention import attention_backward

    torch.cuda.synchronize()
    attn = _counters()[0]
    for fn in _counters() + (attention_backward,):
        fn.launches = 0
    for fn in _counters()[1:]:
        fn.variant_launches.update(whole=0, banded=0)
    _counters()[1].pitched_launches = 0
    for route in attn.route_launches:
        attn.route_launches[route] = 0
    attn.width_launches.clear()


def read_counts() -> dict:
    """Launches of kernel A, kernel B (whole and phase-split) and calls of
    the attention backward kernels (`attention_backward`, three launches
    each)."""
    from monst3r_slam_torch.ops.attention import attention_backward

    return {fn.__name__: fn.launches for fn in _counters() + (attention_backward,)}


def rest_config(**tracking) -> dict:
    """`slice_config` (synchronous, the confidence gates open) with the
    `tracking` keys given: the new phases' configuration."""
    cfg = slice_config()
    cfg["tracking"].update(tracking)
    return cfg


def lm_inputs(seed: int):
    """A 384x512 pair for the LM matcher: a smooth pointmap and the same
    surface sampled 1.3 px right and 0.4 px down, with unit descriptors
    (fd 24) drawn from `seed` and shifted one pixel; (1, h, w, c) CPU tensors."""
    import torch

    def surface(dx, dy):
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        u, v = (xx + dx - W / 2) / 400.0, (yy + dy - H / 2) / 400.0
        z = 2.0 + 0.3 * np.sin(3 * u) * np.cos(4 * v)
        return np.stack([u * z, v * z, z], axis=-1)[None].astype(np.float32)

    D = np.random.default_rng(seed).standard_normal((1, H, W, 24)).astype(np.float32)
    D /= np.linalg.norm(D, axis=-1, keepdims=True)
    return [torch.from_numpy(a) for a in (surface(0, 0), surface(1.3, 0.4), D,
                                         np.roll(D, 1, axis=2))]


def track_frames(slam, frames, first: int = 0, force_kf_at=()) -> dict:
    """`process_frame` on each frame, the device synchronized after each:
    per-frame wall ms, the mode after each and its decision flags."""
    import torch

    wall, modes, flags = [], [], []
    for i, img in enumerate(frames, first):
        t0 = time.perf_counter()
        slam.process_frame(i, i / 30.0, img, force_kf=True if i in force_kf_at else None)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        modes.append(slam.mode.name)
        flags.append(None if slam.last_summary is None
                     else [int(x > 0.5) for x in slam.last_summary[8:11]])
    return dict(wall_ms=wall, modes=modes, flags=flags)


def phase_lm(seed: int, card: str, params) -> dict:
    """The LM matcher (`matching.mode: lm`): `matching.match` on the card
    against its CPU run on one 384x512 pair (`lm_inputs`), indices and
    `valid` equal on at least 99.9% of the pixels, the match timed; then the
    synchronous SLAMSystem at MAST3R_512 full width tracking 6 copies of one
    frame with the LM matcher (frame 3 a keyframe: its graph edge is
    matched by LM too), kernel A counted and kernel B never launched."""
    import torch

    from monst3r_slam_torch.app.pipeline import SLAMSystem
    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.ops import matching

    args = lm_inputs(seed)
    t0 = time.perf_counter()
    ref = matching.match(*args)
    cpu_s = time.perf_counter() - t0
    dev = [a.cuda() for a in args]
    got = matching.match(*dev)
    idx_eq = float((got[0].cpu() == ref[0]).float().mean())
    valid_eq = float((got[1].cpu() == ref[1]).float().mean())
    diff = (got[0].cpu() != ref[0])[0]
    off = 0
    if bool(diff.any()):
        a, b = got[0].cpu()[0][diff], ref[0][0][diff]
        off = int(torch.maximum((a % W - b % W).abs(), (a // W - b // W).abs()).max())
    ms = time_ms(lambda: matching.match(*dev), iters=5, warmup=1)
    print(f"lm match ({card}) {H}x{W}, fd 24, 10 LM steps, radius 3, dilations 5..1: "
          f"{ms:.3f} ms back to back; card against CPU: indices equal on {idx_eq:.6f}, "
          f"valid on {valid_eq:.6f} of the pixels (the rest at most {off} px apart); "
          f"valid share {float(ref[1].float().mean()):.4f}; CPU run {cpu_s:.1f} s", flush=True)
    if idx_eq < 0.999 or valid_eq < 0.999:
        fail(f"the LM matcher on the card differs from the CPU on more than 0.1% of the pixels "
             f"(indices {idx_eq}, valid {valid_eq})")

    img = synthetic_frame(seed, H, W)
    zero_counts()
    cfg = rest_config(match_frac_thresh=0.0)
    cfg["matching"]["mode"] = "lm"
    slam = SLAMSystem(params=params, model_cfg=MAST3R_512, cfg=cfg, img_size=(H, W),
                      kf_capacity=16, device="cuda")
    run = track_frames(slam, [img] * 6, force_kf_at=(3,))
    launches = read_counts()
    print(f"lm tracked run ({card}), MAST3R_512 {H}x{W}, 6 frames: per-frame ms "
          f"{[round(t, 1) for t in run['wall_ms']]}; modes {run['modes']}; keyframes "
          f"{slam.keyframe_trajectory()[1].tolist()}; global solves {slam.graph.n_solves}; "
          f"launches {launches}", flush=True)
    if slam.match_mode != "lm" or run["modes"][1:] != ["TRACKING"] * 5:
        fail(f"the LM path did not track every frame: {run['modes']}")
    if slam.graph.n_solves < 1 or not np.isfinite(slam.full_trajectory()[1]).all():
        fail("the LM path ran no global solve or gave a non-finite pose")
    if launches["fused_attention"] < 72 * 5 or launches["tile_match_kernel"] != 0:
        fail(f"the LM path's launches are off: {launches} (kernel A at least 72 a tracked "
             "frame, kernel B never)")
    return dict(match_ms=ms, idx_equal=idx_eq, valid_equal=valid_eq, max_px_off=off,
                cpu_s=cpu_s, wall_ms=run["wall_ms"], launches=launches,
                tol="indices and valid equal on >= 99.9% of the pixels")


def phase_fusion(seed: int, card: str) -> dict:
    """Each filtering mode of `fuse_pointmap` on the card against the CPU on
    384x512 keyframe pointmaps, first (N_old 0) and later (N_old 3)
    observations, `best_score` under both scores: N equal and the median
    score equal; X and C within 1e-6 of their scale, the mean score within
    1e-6 of itself. `weighted_spherical` runs on the card's own atan2,
    arccos, sin and cos, whose results may differ from the CPU's by an ulp;
    arccos(c) near the poles turns that ulp into 1/sqrt(1 - c^2) of them, so
    its X is held to 5e-5 of its scale."""
    import torch

    from monst3r_slam_torch.slam.frame import fuse_pointmap

    rng = np.random.default_rng(seed)
    hw = H * W
    cpu = [torch.from_numpy(a) for a in (
        rng.standard_normal((hw, 3)).astype(np.float32) + np.float32([0, 0, 3]),
        rng.uniform(0.5, 3.0, (hw, 1)).astype(np.float32),
        rng.standard_normal((hw, 3)).astype(np.float32) + np.float32([0, 0, 3]),
        rng.uniform(0.5, 3.0, (hw, 1)).astype(np.float32))]
    dev = [t.cuda() for t in cpu]
    worst = {}
    for mode in FUSION_MODES:
        for n_old in (0, 3):
            for fscore in (("median", "mean") if mode == "best_score" else ("median",)):
                args = (torch.tensor(n_old, dtype=torch.int32), torch.tensor(1.0))
                r = fuse_pointmap(cpu[0], cpu[1], args[0], cpu[2], cpu[3], mode, args[1], fscore)
                g = fuse_pointmap(dev[0], dev[1], args[0].cuda(), dev[2], dev[3], mode,
                                  args[1].cuda(), fscore)
                g = [t.cpu() for t in g]
                scale = float(r[0].abs().max())
                ex, ec = float((g[0] - r[0]).abs().max()), float((g[1] - r[1]).abs().max())
                es = abs(float(g[3]) - float(r[3]))
                tol = (5e-5 if mode == "weighted_spherical" else 1e-6) * scale
                stol = 0.0 if fscore == "median" else 1e-6 * abs(float(r[3]))
                if ex > tol or ec > 1e-6 * float(r[1].abs().max()) or es > stol or \
                        int(g[2]) != int(r[2]):
                    fail(f"fusion {mode} (N_old {n_old}, {fscore}) on the card differs from "
                         f"the CPU: X {ex} (tol {tol}), C {ec}, score {es}, N {int(g[2])} / "
                         f"{int(r[2])}")
                worst[mode] = max(worst.get(mode, 0.0), ex / scale)
    print(f"fusion modes ({card}), {hw} points, card against CPU, largest X error over its "
          f"scale: { {m: f'{e:.3g}' for m, e in worst.items()} }", flush=True)
    return dict(max_rel_err=worst)


def phase_decode_sym(seed: int, card: str, params) -> dict:
    """`inference_sym` and `decode(fused_heads=True)` at MAST3R_512 full
    width on the card against the separate bf16 decodes of each order: each
    output within twice the separate decode's own bf16 distance from its
    f32 run (the bound of tests/test_torch_models_sym.py); then both heads
    timed, fused (one vmapped pass) and unfused (one after the other)."""
    import torch

    from monst3r_slam_torch.models import croco, heads, mast3r as model_api
    from monst3r_slam_torch.models.config import MAST3R_512 as cfg

    imgs = [torch.from_numpy(synthetic_frame(seed + k, H, W))[None].cuda() for k in (0, 1)]
    (fi, pi), (fj, pj) = (model_api.encode(params, cfg, im) for im in imgs)
    sep = [model_api.decode(params, cfg, fi, pi, fj, pj, (H, W)),
           model_api.decode(params, cfg, fj, pj, fi, pi, (H, W))]
    f32 = [model_api.decode(params, cfg, fi, pi, fj, pj, (H, W), torch.float32),
           model_api.decode(params, cfg, fj, pj, fi, pi, (H, W), torch.float32)]
    sym = model_api.inference_sym(params, cfg, fi, pi, fj, pj, (H, W))
    fused = model_api.decode(params, cfg, fi, pi, fj, pj, (H, W), fused_heads=True)
    errs = {}
    for what, outs, refs in (("sym", sym, sep), ("fused", [fused], sep[:1])):
        for k, (o, s, f) in enumerate(zip(outs, refs, f32)):
            for name in o._fields:
                own = float((getattr(s, name).float() - getattr(f, name).float()).abs().max())
                err = float((getattr(o, name).float() - getattr(s, name).float()).abs().max())
                errs[f"{what}{k}.{name}"] = (err, own)
                if not err <= 2.0 * own:
                    fail(f"{what} {name} (order {k}) on the card is {err} from the separate "
                         f"decode, over twice its own bf16 distance {own}")
    dec1, dec2 = croco.decode_pair(params, cfg, fi, pi, fj, pj)
    n_h, n_w = H // cfg.patch_size, W // cfg.patch_size

    def unfused():
        return (heads.head_forward(params["head1"], cfg, dec1, n_h, n_w),
                heads.head_forward(params["head2"], cfg, dec2, n_h, n_w))

    def fused_heads():
        return model_api._fused_heads(params, cfg, dec1, dec2, n_h, n_w)

    t = {}
    for name, fn in (("unfused", unfused), ("fused", fused_heads)):
        dev_ms, n_launch = profiled_ms(fn)
        t[name] = dict(ms=time_ms(fn, iters=10, warmup=2), device_ms=dev_ms, launches=n_launch)
    worst = max(errs.items(), key=lambda kv: kv[1][0] / kv[1][1])
    print(f"decode_sym ({card}) MAST3R_512 {H}x{W} bf16: inference_sym and fused heads within "
          f"twice the separate decode's bf16 distance (worst {worst[0]}: {worst[1][0]:.4g} of "
          f"{worst[1][1]:.4g}); both heads unfused {t['unfused']['ms']:.3f} ms back to back, "
          f"device {t['unfused']['device_ms']:.3f} ms in {t['unfused']['launches']:.0f} launches; "
          f"fused {t['fused']['ms']:.3f} ms, device {t['fused']['device_ms']:.3f} ms in "
          f"{t['fused']['launches']:.0f} launches", flush=True)
    return dict(heads=t, worst=dict(name=worst[0], err=worst[1][0], own=worst[1][1]))


def phase_state(seed: int, card: str, params) -> dict:
    """SLAM-state files at MAST3R_512 full width: 6 tracked frames,
    `save_state`, a fresh SLAMSystem, `load_state`, 4 more frames, against an
    uninterrupted run of the 10 (frames 3 and 7 made keyframes, one on each
    side of the file): the same modes, decision flags and keyframes. The
    resumed system starts the matcher cold (the file holds no warm start),
    so its poses are held to 1e-6 against an uninterrupted run whose warm
    start is dropped after frame 5, and their distance from the plain
    uninterrupted run's is reported."""
    import shutil

    from monst3r_slam_torch.app.pipeline import SLAMSystem
    from monst3r_slam_torch.models.config import MAST3R_512

    img = synthetic_frame(seed, H, W)
    force = (3, 7)

    def make():
        return SLAMSystem(params=params, model_cfg=MAST3R_512,
                          cfg=rest_config(match_frac_thresh=0.0), img_size=(H, W),
                          kf_capacity=16, device="cuda")

    whole = make()
    w = track_frames(whole, [img] * 10, force_kf_at=force)
    cold = make()
    track_frames(cold, [img] * 6, force_kf_at=force)
    cold.idx_f2k = None  # what load_state leaves
    track_frames(cold, [img] * 4, first=6, force_kf_at=force)
    first = make()
    a = track_frames(first, [img] * 6, force_kf_at=force)
    shutil.rmtree(REST_DIR, ignore_errors=True)
    REST_DIR.mkdir(parents=True)
    path = REST_DIR / "state.npz"
    t0 = time.perf_counter()
    first.save_state(path)
    save_s = time.perf_counter() - t0
    rest = make()
    t0 = time.perf_counter()
    rest.load_state(path)
    load_s = time.perf_counter() - t0
    b = track_frames(rest, [img] * 4, first=6, force_kf_at=force)
    kf_w, kf_r = whole.keyframe_trajectory()[1].tolist(), rest.keyframe_trajectory()[1].tolist()
    dpose = float(np.abs(rest.full_trajectory()[1] - cold.full_trajectory()[1]).max())
    dwarm = float(np.abs(rest.full_trajectory()[1] - whole.full_trajectory()[1]).max())
    print(f"state ({card}) MAST3R_512 {H}x{W}: file {path.stat().st_size / 1e6:.1f} MB, saved "
          f"in {save_s:.2f} s, loaded in {load_s:.2f} s; modes {a['modes']} + {b['modes']} "
          f"against {w['modes']}; keyframes {kf_r} against {kf_w}; poses within {dpose:.3g} of "
          f"the run with the warm start dropped, {dwarm:.3g} of the uninterrupted run",
          flush=True)
    if a["modes"] + b["modes"] != w["modes"] or a["flags"] + b["flags"] != w["flags"]:
        fail("the resumed run decided otherwise than the uninterrupted one")
    if kf_r != kf_w or len(kf_w) != 3 or rest.graph.n_solves < 1:
        fail(f"the resumed run's keyframes {kf_r} are not the uninterrupted run's {kf_w}")
    if not dpose <= 1e-6:
        fail(f"the resumed run's poses are {dpose} from the uninterrupted run's with the "
             "warm start dropped")
    return dict(max_pose_diff=dpose, max_pose_diff_warm=dwarm,
                file_mb=path.stat().st_size / 1e6, save_s=save_s, load_s=load_s)


def phase_chunked(seed: int, card: str, params) -> dict:
    """`process_chunk` (chunk 4) over 12 uint8 copies of one frame at
    MAST3R_512 full width, against the per-frame path with
    `defer_tracking_sync: 0` on the host-normalized frames: once with the
    keyframe gate shut (event-free chunks, timed) and once with every frame
    a keyframe (events inside each chunk: the done flag, re-dispatch from
    k0). Each chunk's dispatch runs under `torch.cuda.set_sync_debug_mode
    ("error")`, so a host synchronization inside it fails the phase. The
    same modes and keyframes, poses within 1e-5; the launch counters are
    zeroed before each chunked run and read after."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from monst3r_slam_torch.app import chunked
    from monst3r_slam_torch.app.pipeline import SLAMSystem
    from monst3r_slam_torch.models.config import MAST3R_512

    u8 = np.uint8(np.round((synthetic_frame(seed, H, W) * 0.5 + 0.5) * 255))
    host = (u8.astype(np.float32) / 255.0 - 0.5) / 0.5
    n, chunk = 12, 4
    track = chunked.chunk_track
    dispatch_ms = []

    def strict(*a, **k):  # each chunk's dispatch: no host synchronization allowed
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            return track(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            dispatch_ms.append((time.perf_counter() - t0) * 1e3)

    def make(thresh):
        return SLAMSystem(params=params, model_cfg=MAST3R_512,
                          cfg=rest_config(match_frac_thresh=thresh), img_size=(H, W),
                          kf_capacity=16, device="cuda")

    def run_chunked(slam, first=0, count=n):
        wall = []
        for c0 in range(first, first + count, chunk):
            ids = list(range(c0, c0 + chunk))
            t0 = time.perf_counter()
            slam.process_chunk(ids, [i / 30.0 for i in ids],
                               torch.from_numpy(np.stack([u8] * chunk)).cuda())
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3 / chunk)
        return wall

    def kernel_launches(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(r[1] for r in trace_totals(prof)[0])

    chunked.chunk_track = strict
    try:
        out = {}
        for name, thresh in (("event_free", 0.0), ("every_frame_a_keyframe", 1.0)):
            ref = make(thresh)
            ref_run = track_frames(ref, [host] * n)
            got = make(thresh)
            zero_counts()
            n_dispatch = len(dispatch_ms)
            wall = run_chunked(got)
            launches = read_counts()
            dispatches = len(dispatch_ms) - n_dispatch
            ref.finalize()
            got.finalize()
            kf_r, kf_g = ref.keyframe_trajectory()[1].tolist(), got.keyframe_trajectory()[1].tolist()
            dpose = float(np.abs(got.full_trajectory()[1] - ref.full_trajectory()[1]).max())
            row = dict(perframe_ms=ref_run["wall_ms"], chunked_ms_per_frame=wall,
                       dispatches=dispatches, dispatch_ms=dispatch_ms[n_dispatch:],
                       launches=launches, keyframes=kf_g,
                       max_pose_diff=dpose, reads=len(got.prof["chunk_sync"]))
            if name == "event_free":  # launches per frame, per-frame and chunked, 4 frames each
                row["launches_per_frame"] = dict(
                    perframe=kernel_launches(lambda: track_frames(ref, [host] * 4, first=n)) / 4,
                    chunked=kernel_launches(lambda: run_chunked(got, first=n, count=4)) / 4)
            out[name] = row
            print(f"chunked {name} ({card}) MAST3R_512 {H}x{W}, {n} frames in chunks of "
                  f"{chunk}: per-frame path ms {[round(t, 1) for t in ref_run['wall_ms']]}; "
                  f"chunked ms a frame {[round(t, 1) for t in wall]}; {dispatches} dispatches "
                  f"(enqueued in {[round(t, 1) for t in row['dispatch_ms']]} ms), "
                  f"{row['reads']} host reads; keyframes {kf_g} (per-frame {kf_r}); poses "
                  f"within {dpose:.3g}; launches {launches}"
                  + (f"; kernel launches a frame {row['launches_per_frame']}"
                     if "launches_per_frame" in row else ""), flush=True)
            if got.frame_ids[:n] != ref.frame_ids[:n] or kf_g != kf_r or got.mode != ref.mode:
                fail(f"chunked {name}: decisions differ from the per-frame path "
                     f"(keyframes {kf_g} against {kf_r})")
            if not dpose <= 1e-5:
                fail(f"chunked {name}: poses {dpose} from the per-frame path's")
            if min(launches["fused_attention"], launches["tile_match_kernel"]) < 1:
                fail(f"chunked {name}: a kernel of the path never launched: {launches}")
            if name == "event_free" and (len(kf_g) != 1 or row["reads"] != n // chunk):
                fail(f"chunked event_free: {len(kf_g)} keyframes, {row['reads']} host reads")
            if name != "event_free" and len(kf_g) != n:
                fail(f"chunked {name}: {len(kf_g)} keyframes, not one a frame")
    finally:
        chunked.chunk_track = track
    return out


def phase_rest(seed: int, card: str) -> dict:
    """The phases of the rest of SLAMSystem, on one tied MAST3R_512 draw."""
    from monst3r_slam_torch.models.config import MAST3R_512

    t0 = time.perf_counter()
    params = tied_params(MAST3R_512, seed)
    out = dict(lm=phase_lm(seed, card, params), fusion=phase_fusion(seed, card),
               decode_sym=phase_decode_sym(seed, card, params),
               state=phase_state(seed, card, params),
               chunked=phase_chunked(seed, card, params))
    out["seconds"] = time.perf_counter() - t0
    print(f"rest of SLAMSystem phases: {out['seconds']:.1f} s", flush=True)
    return out


MESH_FRAMES, MESH_KF_AT = 10, 5  # the mesh phase's run: one forced keyframe event


def mesh_config(single_thread: bool, solver: str) -> dict:
    """`slice_config` with every tracking decision resolved at once, in
    synchronous or worker mode, with the `solver` given."""
    cfg = slice_config()
    cfg.update(single_thread=single_thread, defer_tracking_sync=0)
    cfg["local_opt"]["solver"] = solver
    return cfg


def mesh_slam_run(params, mesh, single_thread: bool, seed: int) -> dict:
    """The synchronous (or worker) SLAMSystem at MAST3R_512 on MESH_FRAMES
    copies of the slice's frame, the keyframe forced at MESH_KF_AT and no
    other, the device synchronized (and the worker waited for) after each
    frame; with `mesh`, `solver: auto` (which the mesh makes the device
    solve), else `solver: device`. The launch counters are zeroed just
    before and read just after."""
    import torch

    from monst3r_slam_torch.app.pipeline import SLAMSystem
    from monst3r_slam_torch.models.config import MAST3R_512

    slam = SLAMSystem(params=params, model_cfg=MAST3R_512,
                      cfg=mesh_config(single_thread, "auto" if mesh is not None else "device"),
                      img_size=(H, W), kf_capacity=16, device="cuda", mesh=mesh)
    if slam.host_solve or (mesh is not None and slam._mesh_params is None):
        fail(f"mesh run: host solve {slam.host_solve}, replicas {slam._mesh_params is not None}")
    img = synthetic_frame(seed, H, W)
    zero_counts()
    wall, modes = [], []
    for i in range(MESH_FRAMES):
        t0 = time.perf_counter()
        slam.process_frame(i, i / 30.0, img, force_kf=i == MESH_KF_AT)
        if not single_thread:
            slam._backend_jobs.join()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        modes.append(slam.mode.name)
    slam.finalize()
    launches = read_counts()
    if slam._worker is not None:  # stop the worker: the system is dropped after the phase
        slam._backend_jobs.put(None)
        slam._worker.join()
        slam._worker = None
    return dict(slam=slam, wall_ms=wall, modes=modes, launches=launches,
                kf_ids=slam.keyframe_trajectory()[1].tolist(),
                poses=slam.full_trajectory()[1], solves=slam.graph.n_solves,
                backend_job_ms=slam.prof.get("backend_job", []))


def mesh_decode_check(mesh, params, E: int, seed: int) -> dict:
    """`sharded_edge_decode` of E pairs of distinct 384x512 frames (pair e:
    frame e and frame e+1) in bf16, held bit for bit to each shard's rows
    (zero pad rows included) decoded alone on its device at the shard's
    batch size, and its D and Q bit for bit to one decode of the whole
    batch. That one decode's X and C may differ from the shards': cuDNN
    picks a convolution algorithm per batch size, which rounds otherwise.
    So the decoder tokens are compared across the two batch sizes, and
    with cuDNN off every output of the sharded decode must equal the one
    decode's. Both decodes timed with cuDNN on, as the pipeline runs."""
    import torch

    from monst3r_slam_torch.models import croco
    from monst3r_slam_torch.models import mast3r as model_api
    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.ops.build import on_card
    from monst3r_slam_torch.parallel.inference import place_replicated, sharded_edge_decode

    cfg = MAST3R_512
    imgs = torch.from_numpy(np.stack([synthetic_frame(seed + e, H, W) for e in range(E)]))
    feat, pos = model_api.encode(params, cfg, imgs.to("cuda"))
    args = (feat, pos, feat.roll(-1, 0), pos.roll(-1, 0))
    replicas = place_replicated(params, mesh)
    sharded = lambda: sharded_edge_decode(mesh, replicas, cfg, *args, (H, W))  # noqa: E731
    whole = lambda: model_api.decode(params, cfg, *args, (H, W))  # noqa: E731
    out, ref = sharded(), whole()
    devs = mesh.shard_devices("dp")
    rows = -(-E // len(devs))
    padded = [torch.cat([a, a.new_zeros((rows * len(devs) - E,) + tuple(a.shape[1:]))])
              for a in args]
    blocks = [[a[d * rows:(d + 1) * rows].to(dev) for a in padded] for d, dev in enumerate(devs)]
    alone = []
    for dev, blk in zip(devs, blocks):
        with on_card(dev):
            alone.append(model_api.decode(replicas[dev], cfg, *blk, (H, W)))
    diff = {}
    for name, r, s, *shards in zip(ref._fields, ref, out, *alone):
        want = torch.cat([t.to(mesh.home) for t in shards])[:E]
        if s.shape != r.shape or s.device != r.device or s.stride() != r.stride():
            fail(f"sharded decode E={E}: {name} {tuple(s.shape)} {s.stride()} on {s.device}, "
                 f"not {tuple(r.shape)} {r.stride()} on {r.device}")
        if not torch.equal(s, want):
            fail(f"sharded decode E={E} on {mesh}: {name} differs from its shards decoded alone "
                 f"by {float((s.float() - want.float()).abs().max()):.4g}")
        diff[name] = float((s.float() - r.float()).abs().max())
        if name[0] in "DQ" and diff[name] != 0.0:
            fail(f"sharded decode E={E} on {mesh}: {name} {diff[name]:.4g} from the unsharded "
                 "decode, not equal")
    full = croco.decode_pair(params, cfg, *args)
    split = [croco.decode_pair(params, cfg, *(a.to(mesh.home) for a in blk)) for blk in blocks]
    tokens_equal = all(
        torch.equal(f, torch.cat([sp[v][k] for sp in split])[:E])
        for v in range(2) for k, f in enumerate(full[v]))
    cudnn_was = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        out_off, ref_off = sharded(), whole()
    finally:
        torch.backends.cudnn.enabled = cudnn_was
    for name, s, r in zip(ref._fields, out_off, ref_off):
        if not torch.equal(s, r):
            fail(f"sharded decode E={E} on {mesh}, cuDNN off: {name} "
                 f"{float((s.float() - r.float()).abs().max()):.4g} from the unsharded decode, "
                 "not equal")
    ms = time_ms(sharded, 3, 1)
    plain = time_ms(whole, 3, 1)
    return dict(E=E, rows_per_shard=rows, equal_to_shards_alone=True, max_abs_diff=diff,
                tokens_equal_across_batch=tokens_equal, equal_with_cudnn_off=True, ms=ms,
                unsharded_ms=plain)


def mesh_gn_check(mesh, slam, seed: int) -> dict:
    """`gauss_newton_sharded` against `gauss_newton` on the keyframe state
    at the end of a run: its edges spread over the dp shards (edge k at
    slot k E / n of E = 2 dp slots, the rest masked padding, so that the
    shards' systems are summed), every pose but the pinned one moved off
    the solution by a seeded 0.01 step so that the solve iterates; both
    timed (synchronized), poses within 1e-4."""
    import torch

    from monst3r_slam_torch.core import lie
    from monst3r_slam_torch.slam import backend
    from monst3r_slam_torch.slam.factor_graph import _next_pow2

    g, mem, n, cfg = slam.graph, slam.mem, slam.n_kf, slam.backend_cfg
    P = min(_next_pow2(n, cfg.pose_pad_lo), mem.capacity)
    ne, E = g.n_edges, 2 * mesh.shape["dp"]
    slot = torch.arange(ne) * E // ne
    src = torch.zeros(E, dtype=torch.long)  # each slot's edge; padding repeats edge 0
    src[slot] = torch.arange(ne)
    dev = mem.T_WC.device
    step = torch.from_numpy(np.random.default_rng(seed).normal(0, 0.01, (P, 7))).float().to(dev)
    step[: cfg.pin] = 0
    args = (lie.sim3_retr(mem.T_WC[:P], step), mem.X_canon[:P],
            mem.C[:P] / torch.clamp(mem.N[:P, None, None].float(), min=1.0),
            torch.from_numpy(g.ii[:ne])[src].to(dev), torch.from_numpy(g.jj[:ne])[src].to(dev),
            g.idx[src.to(dev)], g.valid_match[src.to(dev)], g.Q[src.to(dev)],
            torch.zeros(E, dtype=torch.bool, device=dev).index_fill_(0, slot.to(dev), True))
    out = {}
    for name, solve in (("sharded", lambda: backend.gauss_newton_sharded(mesh, *args, cfg, P)),
                        ("unsharded", lambda: backend.gauss_newton(*args, cfg, P))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T, iters = solve()
        torch.cuda.synchronize()
        out[name] = (T, iters, (time.perf_counter() - t0) * 1e3)
    diff = float((out["sharded"][0] - out["unsharded"][0]).abs().max())
    moved = float((out["unsharded"][0] - args[0]).abs().max())
    if not diff <= 1e-4:
        fail(f"sharded GN on {mesh}: poses {diff} from the unsharded solve's")
    return dict(max_pose_diff=diff, moved=moved, keyframes=n, edges=ne, edge_slots=E,
                iters=[out[k][1] for k in ("sharded", "unsharded")],
                ms=out["sharded"][2], unsharded_ms=out["unsharded"][2])


def phase_mesh(seed: int, card: str) -> dict:
    """The SLAM path's device mesh (`parallel/`, `gauss_newton_sharded`,
    `SLAMSystem(mesh=...)`) at MAST3R_512, 384x512, on the slice phase's
    tied weights and frame. With one card the mesh is (4, 2) entries of
    cuda:0: the dp shards of a four-way split run one after the other on
    it. With several, `make_mesh()` over the distinct cards runs too.
    Checks: the sharded edge decode at E = 3 and 8 against its shards
    decoded alone (equal) and one decode (D, Q equal; all equal with cuDNN
    off); the synchronous and
    the worker SLAMSystem with the mesh against the same without it, run
    in the order off, on, on, off (decisions equal, poses within 1e-3, the
    two runs with the mesh launch alike), kernels A and B launched and
    counted in the first run with the mesh; the sharded GN against the
    unsharded one on the end state, its edges spread over the shards
    (1e-4); the dual decode on two mesh devices against
    `monst3r_asymmetric_inference` (equal)."""
    import torch

    from monst3r_slam_torch.dynamic.inference import DualParams, monst3r_asymmetric_inference
    from monst3r_slam_torch.models import mast3r as model_api
    from monst3r_slam_torch.models.config import MAST3R_512, MONST3R_512
    from monst3r_slam_torch.parallel.inference import (
        dual_decode_two_device, dual_device_pair, place_dual,
    )
    from monst3r_slam_torch.parallel.mesh import make_mesh

    t_start = time.perf_counter()
    params = tied_params(MAST3R_512, seed)
    meshes = {"one_card": make_mesh(devices=[torch.device("cuda")] * 8)}
    if torch.cuda.device_count() > 1:
        meshes["cards"] = make_mesh()
    else:
        print(f"mesh ({card}): the multi-card mesh was not run (1 card)", flush=True)
    out = dict(decode={}, gn={}, runs={}, launches={name: 0 for name in read_counts()})
    for mname, mesh in meshes.items():
        out["decode"][mname] = [mesh_decode_check(mesh, params, E, seed) for E in (3, 8)]
        runs = {}
        for mode, single in (("sync", True), ("async", False)):
            offs, ons = [mesh_slam_run(params, None, single, seed)], []
            ons += [mesh_slam_run(params, mesh, single, seed) for _ in range(2)]
            offs.append(mesh_slam_run(params, None, single, seed))
            on, off = ons[0], offs[0]
            for k, v in on["launches"].items():
                out["launches"][k] += v
            dpose = max(float(np.abs(r["poses"] - off["poses"]).max()) for r in ons + offs)
            runs[mode] = dict(
                modes=on["modes"], keyframes=on["kf_ids"], max_pose_diff=dpose,
                launches=on["launches"], launches_off=off["launches"],
                wall_ms=on["wall_ms"], wall_ms_off=off["wall_ms"],
                kf_event_ms=[r["wall_ms"][MESH_KF_AT] for r in ons],
                kf_event_ms_off=[r["wall_ms"][MESH_KF_AT] for r in offs],
                backend_job_ms=[r["backend_job_ms"] for r in ons],
                backend_job_ms_off=[r["backend_job_ms"] for r in offs])
            print(f"mesh {mname} {mesh.shape} {mode} ({card}) MAST3R_512 {H}x{W}, "
                  f"{MESH_FRAMES} frames: modes {on['modes']}; keyframes {on['kf_ids']} "
                  f"(no mesh {off['kf_ids']}); poses within {dpose:.3g} of the run without "
                  f"the mesh; keyframe event ms in run order off, on, on, off: "
                  f"{runs[mode]['kf_event_ms_off'][0]:.1f}, {runs[mode]['kf_event_ms'][0]:.1f}, "
                  f"{runs[mode]['kf_event_ms'][1]:.1f}, {runs[mode]['kf_event_ms_off'][1]:.1f}; "
                  f"launches {on['launches']} (no mesh {off['launches']}); worker jobs ms "
                  f"{runs[mode]['backend_job_ms']} (no mesh {runs[mode]['backend_job_ms_off']})",
                  flush=True)
            if ons[1]["launches"] != on["launches"] or offs[1]["launches"] != off["launches"]:
                fail(f"mesh {mname} {mode}: a repeated run launched otherwise: "
                     f"{ons[1]['launches']}, {offs[1]['launches']}")
            for r in ons + offs[1:]:
                if (r["modes"] != off["modes"] or r["kf_ids"] != off["kf_ids"]
                        or r["slam"].graph.edge_list() != off["slam"].graph.edge_list()):
                    fail(f"mesh {mname} {mode}: decisions differ from the run without the mesh")
            if not dpose <= 1e-3 or on["solves"] < 1 or on["modes"][1:].count("TRACKING") < 1:
                fail(f"mesh {mname} {mode}: poses {dpose} apart, {on['solves']} solves, "
                     f"modes {on['modes']}")
            if min(on["launches"]["fused_attention"], on["launches"]["tile_match_kernel"]) < 1:
                fail(f"mesh {mname} {mode}: a kernel of the path never launched")
            if mode == "sync":
                out["gn"][mname] = mesh_gn_check(mesh, on["slam"], seed)
            del ons, offs, on, off
        out["runs"][mname] = runs
        print(f"mesh {mname} checks ({card}): sharded decode {out['decode'][mname]} "
              f"(equal to its shards decoded alone, and with cuDNN off to one decode of the "
              f"batch; max difference from that decode with cuDNN on); sharded GN "
              f"{out['gn'][mname]}",
              flush=True)
    # the dual decode on the first two mesh devices (one card: cuda:0 twice)
    mon = tied_params(MONST3R_512, seed + 1)
    dual = DualParams(mon, MONST3R_512, params, MAST3R_512)
    img = torch.from_numpy(np.stack([synthetic_frame(seed, H, W), synthetic_frame(seed + 1, H, W)]))
    feat, pos = model_api.encode(mon, MONST3R_512, img.to("cuda"))
    pair = (feat[:1], pos[:1], feat[1:], pos[1:], (H, W))
    ref = monst3r_asymmetric_inference(dual, *pair)
    out["dual"] = {}
    for mname, mesh in meshes.items():
        dev_a, dev_b = dual_device_pair(mesh)
        placed = place_dual(dual, dev_a, dev_b)
        got = dual_decode_two_device(placed, dev_a, dev_b, *pair)
        # the one-device decode's calls, on one card or two of one kind: equal bits
        rel = max(float((s.float() - r.float()).abs().max() / r.float().abs().max())
                  for s, r in zip(got, ref) if r is not None)
        if any(s is not None and s.device != dev_a for s in got) or rel:
            fail(f"dual decode on ({dev_a}, {dev_b}): {rel:.3g} of scale from the one-device "
                 "decode, or an output off dev_a")
        ms = time_ms(lambda: dual_decode_two_device(placed, dev_a, dev_b, *pair), 3, 1)
        out["dual"][mname] = dict(devices=[str(dev_a), str(dev_b)], max_rel_diff=rel, ms=ms)
    plain = time_ms(lambda: monst3r_asymmetric_inference(dual, *pair), 3, 1)
    out["dual_plain_ms"] = plain
    out["seconds"] = time.perf_counter() - t_start
    print(f"mesh dual decode ({card}) MONST3R_512 + MAST3R_512 {H}x{W}: {out['dual']} "
          f"(one device: {plain:.2f} ms); phase {out['seconds']:.1f} s; mesh-path launches "
          f"{out['launches']}", flush=True)
    return out


# ---------------------------------------------------------------------------
# The oracle scene through the full-width SLAM path (`phase_oracle`)
# ---------------------------------------------------------------------------

ORACLE_DIR = ROOT / "build" / "smoke_oracle"  # the demo pair's frames and outputs
# At bench.py:734's step of 0.12 a frame the shipped keyframe gate makes a
# keyframe event every ~26-31 frames (frames 30, 56 and 87 in the CPU
# rehearsal at TINY width), so 96 frames make three events and let
# retrieval propose a keyframe older than the previous one.
ORACLE_FRAMES = 96
ORACLE_STEP = 0.12
ORACLE_ATE_SHARE = 0.033  # tests/test_ate_regression.py:204-212: 0.02 over ~0.6 units
ORACLE_KF_EVENTS = 2  # organic keyframe events the run must make (`keyframe_events`)
# Kernel B sums the descriptor window on the tensor cores, so on the oracle's
# smooth descriptors a few queries take another window maximum within the
# rounding allowance of its plain version (`matching_pallas.rounding_check`,
# which the phase applies to every kernel B call of a run). Those moves carry
# into the poses: on an H100, 60 of 20.4M queries over the 96 frames moved
# them by at most 6.6e-5 up to the last keyframe event (frame 88) and by
# 5.7e-3 over the 7 frames after it, where the worker's timing alone moves
# the same kernel run by 1.8e-2. So the kernel and plain runs are held to
# equal keyframes and edges and poses within 1e-2, and must be equal if
# every query was exact.
ORACLE_POSE_TOL = 1e-2


def oracle_slam_class(rff, focal: float):
    """bench.py:640-720's OracleBenchSLAM recipe as a subclass of the port's
    SLAMSystem: the real decode runs (kernel A on the card), then its X and
    D are replaced by `utils/oracle.render_pair` of the two frames'
    ground-truth poses (`self.gt[frame_id]`, the RFF arrays `rff` and
    fx = fy = `focal` pixels) and C and Q by 2.0, so tracking, keyframing,
    retrieval and the worker's global GN follow a known trajectory at the
    model's full cost. The current frame's id is pinned in `make_frame`,
    keyframe slots map to frame ids in `_append_keyframe` (`self.kf_fids`),
    and the edge decode's pair rows are recorded per thread by
    `_edge_pair_slots` (the worker decodes edges while the main thread
    tracks). tests/test_torch_oracle.py drives the same class on the CPU."""
    import threading

    import torch

    from monst3r_slam_torch.app.pipeline import SLAMSystem
    from monst3r_slam_torch.models.mast3r import PairOutput
    from monst3r_slam_torch.utils import oracle

    class OracleSLAM(SLAMSystem):
        def __post_init__(self):
            super().__post_init__()
            self.gt, self._cur_fid, self.kf_fids = {}, None, []
            self._edge_tls = threading.local()

        def make_frame(self, frame_id, img_np):
            self._cur_fid = int(frame_id)
            return super().make_frame(frame_id, img_np)

        def _append_keyframe(self, frame):
            idx = super()._append_keyframe(frame)
            self.kf_fids[idx:idx + 1] = [int(frame.frame_id)]
            return idx

        def _edge_pair_slots(self, kf_i_list, kf_j_list, use_cache):
            slots = super()._edge_pair_slots(kf_i_list, kf_j_list, use_cache)
            self._edge_tls.slots = slots
            return slots

        def _decode_pair(self, feat_i, pos_i, feat_j, pos_j):
            # Eager PyTorch runs this decode whether or not its outputs are
            # read, so bench.py's 1e-6 tanh(real) mix, which only kept XLA
            # from removing the decode from its one jitted program, is left
            # out: the outputs are exactly the oracle's.
            out = super()._decode_pair(feat_i, pos_i, feat_j, pos_j)
            slots = getattr(self._edge_tls, "slots", None)
            self._edge_tls.slots = None
            if slots is not None:
                fi, fj = ([self.kf_fids[s] for s in side] for side in slots)
            elif feat_j is feat_i:  # _mono_init: the frame against itself
                fi, fj = [self._cur_fid], [self._cur_fid]
            else:
                fi, fj = [self._cur_fid], [self.kf_fids[self.n_kf - 1]]
            Ti, Tj = (torch.from_numpy(np.stack([self.gt[f] for f in ids])).to(self.device)
                      for ids in (fi, fj))
            h, w = self.img_size
            X1, D1, X2, D2 = oracle.render_pair(Ti, Tj, rff, h, w, focal, focal)
            two = torch.full_like(out.C1, 2.0)
            return PairOutput(X1.reshape(out.X1.shape), two, D1.reshape(out.D1.shape), two,
                              X2.reshape(out.X2.shape), two, D2.reshape(out.D2.shape), two)

    return OracleSLAM


def oracle_frames(n: int):
    """The oracle's ground-truth poses (`gt_trajectory(n, step=0.12)`) and
    its renderings at 384x512 as uint8 RGB (host) and their ImgNorm images
    (card), all rendered in one batch on the card."""
    import torch

    from monst3r_slam_torch.utils import oracle

    gt = oracle.gt_trajectory(n, step=ORACLE_STEP)
    img = oracle.render_image(torch.from_numpy(np.stack(gt)).cuda(), H, W, 0.6 * W, 0.6 * W)
    u8 = torch.round((img + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)
    return gt, u8.cpu().numpy(), u8.float() / 127.5 - 1.0


@contextlib.contextmanager
def plain_tile_match():
    """Within the block the tiled matcher's `kernel` mode calls kernel B's
    plain version (`tile_match_plain`) on the card's tensors in place of
    the kernel: the same semantics, launched as plain PyTorch."""
    from monst3r_slam_torch.ops import matching_pallas, matching_tiled

    def plain(rays_img, desc_img, q_rays, q_desc, corners, tcfg, conv_thresh=1e-6):
        h, w, _ = rays_img.shape
        corners = matching_pallas.quantize_corners(corners, h, w, tcfg.crop)
        return matching_pallas.tile_match_plain(rays_img, desc_img, q_rays, q_desc, corners,
                                                tcfg.crop, tcfg.window, conv_thresh)

    kernel = matching_tiled.tile_match
    matching_tiled.tile_match = plain
    try:
        yield
    finally:
        matching_tiled.tile_match = kernel


@contextlib.contextmanager
def checked_tile_match(slam, record: list):
    """Within the block every kernel B call of the tiled matcher is also held
    against its plain version on the same inputs under
    `matching_pallas.rounding_check`; `record` gets, per call, (frame id,
    queries, queries not exactly equal, queries failing the check). The
    kernel's own outputs go on unchanged."""
    import torch

    from monst3r_slam_torch.ops import matching_pallas, matching_tiled

    kernel = matching_tiled.tile_match

    def checked(rays_img, desc_img, q_rays, q_desc, corners, tcfg, conv_thresh=1e-6):
        got = kernel(rays_img, desc_img, q_rays, q_desc, corners, tcfg=tcfg,
                     conv_thresh=conv_thresh)
        h, w, _ = rays_img.shape
        passes, exact = matching_pallas.rounding_check(
            rays_img.float(), desc_img.to(torch.bfloat16), q_rays.float(),
            q_desc.to(torch.bfloat16), matching_pallas.quantize_corners(corners, h, w, tcfg.crop),
            tcfg.crop, tcfg.window, conv_thresh, got)
        record.append((slam._cur_fid, exact.numel(), int((~exact).sum()), int((~passes).sum())))
        return got

    matching_tiled.tile_match = checked
    try:
        yield
    finally:
        matching_tiled.tile_match = kernel


def oracle_slam_run(params, frames, matcher: str, join_worker: bool, tcfg=None,
                    model_cfg=None) -> dict:
    """The oracle SLAMSystem on config/base.yaml as shipped (the backend on
    its worker, retrieval on a k-means-bootstrapped codebook, the matcher's
    `kernel` mode; `matcher` "kernel" as shipped, "plain" through kernel B's
    plain version, "checked" with every kernel B call held to its plain
    version by `checked_tile_match`), MAST3R_512 at 384x512, every frame
    through `process_frame` with no keyframe forced. With `join_worker` the worker's jobs are waited for
    after each frame, outside the timed call, so two runs apply the same
    solves at the same frames. `tcfg` replaces the matcher's tiling
    (`SLAMSystem.match_tcfg`); `model_cfg` (MAST3R_512 by default) is the
    architecture of `params`. The launch counters are zeroed just before
    and read just after."""
    import torch

    from monst3r_slam_torch.app.config import load_config
    from monst3r_slam_torch.app.evaluate import ate_rmse
    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.slam import retrieval
    from monst3r_slam_torch.utils import oracle

    gt, u8, norm = frames
    model_cfg = MAST3R_512 if model_cfg is None else model_cfg
    cfg = load_config("config/base.yaml", set_global=False)
    cfg["single_thread"] = False
    rff = oracle.make_rff(model_cfg.desc_dim, scale=12.0,  # make_rff: 384x512 needs ~12
                          generator=torch.Generator(device="cuda").manual_seed(42))
    slam = oracle_slam_class(rff, 0.6 * W)(
        params=params, model_cfg=model_cfg, cfg=cfg, img_size=(H, W), device="cuda",
        retrieval_params=retrieval.init_retrieval_params(
            torch.Generator().manual_seed(1), model_cfg.enc_dim, device="cuda"),
        retrieval_db=retrieval.ASMKDatabase.from_config(cfg))
    if slam._worker is None or slam.match_mode != "kernel":
        fail(f"oracle run: worker {slam._worker is not None}, matcher {slam.match_mode}")
    if tcfg is not None:
        slam.match_tcfg = tcfg
    checks = []
    zero_counts()
    t0 = time.perf_counter()
    wall, modes = [], []
    with (plain_tile_match() if matcher == "plain" else checked_tile_match(slam, checks)
          if matcher == "checked" else contextlib.nullcontext()):
        for i, T in enumerate(gt):
            slam.gt[i] = T
            tf = time.perf_counter()
            slam.process_frame(i, i / 30.0, norm[i], uimg=u8[i])
            wall.append((time.perf_counter() - tf) * 1e3)
            if join_worker:
                slam._backend_jobs.join()
            modes.append(slam.mode.name)
        slam.finalize()
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    routes = dict(_counters()[0].route_launches)
    widths = dict(_counters()[0].width_launches)
    variants = dict(_counters()[1].variant_launches)
    pitched = _counters()[1].pitched_launches
    slam._backend_jobs.put(None)  # stop the worker: the system is dropped after the phase
    slam._worker.join()
    slam._worker = None
    _, poses = slam.full_trajectory()
    gt_xyz = np.stack([T[:3] for T in gt]).astype(np.float64)
    t = np.arange(len(gt), dtype=np.float64)
    ok = bool(np.isfinite(poses).all()) and len(poses) == len(gt)
    rmse = ate_rmse(t, poses[:, :3].astype(np.float64), t, gt_xyz)[0] if ok else float("nan")
    return dict(mode=matcher, join_worker=join_worker, defer=slam.defer_depth, checks=checks, wall_ms=wall, modes=modes, seconds=secs,
                poses=poses, finite=ok, kf_fids=list(slam.kf_fids),
                edges=slam.graph.edge_list(), n_edges=slam.graph.n_edges,
                solves=slam.graph.n_solves, retrieval_queries=len(slam.prof.get("retrieval", [])),
                backend_job_ms=slam.prof.get("backend_job", []), stall_s=slam.backend_stall_s,
                ate=rmse, extent=float(np.linalg.norm(np.ptp(gt_xyz, axis=0))),
                launches=launches, routes=routes, widths=widths, variants=variants,
                pitched=pitched)


def oracle_demo_pair(seed: int, u8) -> dict:
    """`scripts/demo_pair_torch.py` unchanged in a subprocess on the card on
    oracle frames 0 and 1 written as PNGs (384x512, MAST3R_512 random
    weights from `seed`): its files' keys and shapes, its time and the
    launch counts it prints."""
    import cv2

    ORACLE_DIR.mkdir(parents=True, exist_ok=True)
    paths = [ORACLE_DIR / f"frame{i}.png" for i in (0, 1)]
    for p, img in zip(paths, u8[:2]):
        cv2.imwrite(str(p), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    out_dir = ORACLE_DIR / "demo"
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "scripts/demo_pair_torch.py", "--img1", str(paths[0]),
                          "--img2", str(paths[1]), "--out", str(out_dir), "--seed", str(seed)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"demo_pair_torch.py failed:\n{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    lines = res.stdout.splitlines()
    frac = [ln for ln in lines if "match fraction" in ln]
    counts = [ln for ln in lines if ln.startswith("kernel launches")]
    m = np.load(out_dir / "matches.npz")
    want = {"idx_1_to_2": (1, H * W), "valid": (1, H * W, 1), "conf1": (1, H, W),
            "conf2": (1, H, W)}
    got = {k: tuple(m[k].shape) for k in m.files}
    if got != want or not (frac and counts):
        fail(f"demo pair: files {got} (want {want}); stdout {lines}")
    ply = (out_dir / "pair.ply").read_bytes()
    if f"element vertex {2 * H * W}\n".encode() not in ply[:300] \
            or len(ply) != ply.index(b"end_header\n") + 11 + 2 * H * W * 15:
        fail("demo pair: pair.ply does not hold both 384x512 pointmaps")
    a, b = (int(x) for x in counts[0].replace(",", " ").split()[3::2])
    if a < 1 or b < 1:
        fail(f"demo pair: a kernel never launched: {counts[0]}")
    return dict(seconds=secs, match_line=frac[0], launches=dict(fused_attention=a,
                                                                  tile_match_kernel=b))


def keyframe_events(kf_fids, defer: int):
    """The organic keyframes (all but frame 0's) that are new events: a
    keyframe decided fewer than `defer` frames after the previous one is
    that decision's repeat. At `defer_tracking_sync: d` a new keyframe takes
    effect d - 1 frames late, so the frames between are still tracked
    against the old keyframe and each is made a keyframe too, as in the
    reference (tests/test_torch_oracle.py holds both packages to it)."""
    return [f for prev, f in zip(kf_fids, kf_fids[1:]) if f - prev >= max(defer, 1)]


def phase_oracle(seed: int, card: str) -> dict:
    """The oracle scene (`utils/oracle.py`) through the full-width SLAM
    path: MAST3R_512 random bf16 weights from `seed`, 384x512, config/
    base.yaml as shipped (worker), ORACLE_FRAMES frames of the ground-truth
    trajectory at 0.12 a frame through `process_frame`, no keyframe forced;
    bench.py:640-720's recipe (`oracle_slam_class`). Three runs: kernel B
    as shipped, timed and counted (the `oracle` path's launches); then,
    each with the worker waited for after every frame, kernel B's plain
    version (`plain_tile_match`) and kernel B with every call held to its
    plain version under `rounding_check` (`checked_tile_match`). Fails
    unless the first run has
    >= ORACLE_KF_EVENTS keyframe events (`keyframe_events`) and >= 1 graph
    edge, every run's poses are finite and its mode never leaves TRACKING,
    each run's Sim(3)-aligned ATE is under 3.3% of the ground truth's
    extent, every query of the checked run passes `rounding_check`, and
    the checked and plain runs make the same keyframes and edges with
    poses within ORACLE_POSE_TOL, equal if every query was exact. Then `demo_pair_torch.py` on oracle frames 0 and 1."""
    import torch

    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.models.convert import cast_params_for_inference
    from monst3r_slam_torch.models.init import init_params

    t_start = time.perf_counter()
    params = cast_params_for_inference(
        init_params(torch.Generator(device="cuda").manual_seed(seed), MAST3R_512))
    frames = oracle_frames(ORACLE_FRAMES)
    runs = [oracle_slam_run(params, frames, "kernel", join_worker=False),
            oracle_slam_run(params, frames, "plain", join_worker=True),
            oracle_slam_run(params, frames, "checked", join_worker=True)]
    for r in runs:
        wall = np.asarray(r["wall_ms"][1:])
        job = np.asarray(r["backend_job_ms"] or [np.nan])
        far = [e for e in r["edges"] if abs(e[0] - e[1]) > 1]
        print(f"oracle SLAM ({card}) MAST3R_512 {H}x{W}, {ORACLE_FRAMES} frames, matcher "
              f"{r['mode']}{', worker waited for' if r['join_worker'] else ''}: ATE "
              f"{r['ate']:.6f} over extent {r['extent']:.4f} ({r['ate'] / r['extent']:.4%}); "
              f"keyframes {r['kf_fids']} (events {keyframe_events(r['kf_fids'], r['defer'])} at "
              f"defer {r['defer']}), edges {r['edges']} ({len(far)} between keyframe slots "
              f"not adjacent: {far}), solves {r['solves']}, retrieval queries "
              f"{r['retrieval_queries']}; frame ms median {np.median(wall):.1f} "
              f"(range {wall.min():.1f}-{wall.max():.1f}); worker job ms median "
              f"{np.median(job):.1f} (range {job.min():.1f}-{job.max():.1f}, {len(r['backend_job_ms'])}"
              f" jobs), stall {r['stall_s']:.3f} s; run {r['seconds']:.1f} s; launches "
              f"{r['launches']}, attention by route {r['routes']}", flush=True)
        if not r["finite"] or any(m != "TRACKING" for m in r["modes"]):
            fail(f"oracle run {r['mode']}: finite poses {r['finite']}, modes {r['modes']}")
        if not r["ate"] < ORACLE_ATE_SHARE * r["extent"]:
            fail(f"oracle run {r['mode']}: ATE {r['ate']} not under {ORACLE_ATE_SHARE:.1%} of "
                 f"the extent {r['extent']}")
    first = runs[0]
    events = keyframe_events(first["kf_fids"], first["defer"])
    if len(events) < ORACLE_KF_EVENTS or first["n_edges"] < 1:
        fail(f"oracle run: keyframes {first['kf_fids']}, events {events} (want "
             f">= {ORACLE_KF_EVENTS}), edges {first['n_edges']}")
    if min(first["launches"][k] for k in ("fused_attention", "tile_match_kernel")) < 1 \
            or first["routes"]["f32"] != 0:
        fail(f"oracle run: kernel launches {first['launches']}, routes {first['routes']}")
    if runs[1]["launches"]["tile_match_kernel"] != 0:
        fail(f"oracle plain run launched kernel B: {runs[1]['launches']}")
    b, a = runs[1], runs[2]
    checks = np.asarray(a["checks"], dtype=np.int64).reshape(-1, 4)
    n_calls, n_queries = len(checks), int(checks[:, 1].sum())
    n_inexact, n_failing = int(checks[:, 2].sum()), int(checks[:, 3].sum())
    inexact_fids = sorted({int(f) for f in checks[checks[:, 2] > 0, 0]})
    frame_gap = np.abs(a["poses"] - b["poses"]).max(axis=1)
    gap = float(frame_gap.max())
    diverge = np.flatnonzero(frame_gap > 0)
    print(f"oracle kernel B held to its plain version on the path (rounding_check): {n_calls} "
          f"calls, {n_queries} queries, {n_inexact} not exactly equal, {n_failing} failing; "
          f"frames with an inexact query {inexact_fids}", flush=True)
    worker_gap = np.abs(first["poses"] - a["poses"]).max(axis=1)
    above = {t: (int(np.argmax(frame_gap > t)) if (frame_gap > t).any() else None)
             for t in (1e-6, 1e-5, 1e-4, 1e-3)}
    print(f"oracle kernel vs plain (worker waited for): keyframes {a['kf_fids']} / "
          f"{b['kf_fids']}, edges equal {a['edges'] == b['edges']}, largest pose difference "
          f"{gap:.3e}, first frame whose poses differ "
          f"{int(diverge[0]) if len(diverge) else None}, first frame above 1e-6/1e-5/1e-4/1e-3 "
          f"{list(above.values())}, at the keyframes "
          f"{[f'{frame_gap[f]:.2e}' for f in a['kf_fids']]}, every 8th frame "
          f"{[f'{g:.2e}' for g in frame_gap[::8]]}; the kernel run as shipped against it "
          f"waited for: largest {worker_gap.max():.3e}, every 8th frame "
          f"{[f'{g:.2e}' for g in worker_gap[::8]]}", flush=True)
    if n_calls < 1 or n_failing:
        fail(f"oracle: kernel B fails the rounding check on {n_failing} of {n_queries} "
             f"queries over {n_calls} calls")
    if len(diverge) and not n_inexact:
        fail(f"oracle: poses differ from frame {int(diverge[0])} with every query exact")
    if a["kf_fids"] != b["kf_fids"] or a["edges"] != b["edges"] or not gap <= ORACLE_POSE_TOL:
        fail("oracle: the kernel run and the plain run disagree")
    demo = oracle_demo_pair(seed, frames[1])
    print(f"oracle demo pair ({card}): demo_pair_torch.py on frames 0 and 1 in "
          f"{demo['seconds']:.1f} s; {demo['match_line']}; launches {demo['launches']}",
          flush=True)
    out = dict(runs=[{k: v for k, v in r.items() if k not in ("poses", "checks")} for r in runs],
               kernel_vs_plain_gap=gap,
               rounding=dict(calls=n_calls, queries=n_queries, inexact=n_inexact,
                             failing=n_failing, inexact_frames=inexact_fids,
                             first_pose_difference=int(diverge[0]) if len(diverge) else None),
               demo=demo, launches=first["launches"], seconds=time.perf_counter() - t_start)
    print(f"oracle phase {out['seconds']:.1f} s", flush=True)
    return out


TRAIN_DIR = ROOT / "build" / "smoke_train"  # the train phase's checkpoints and weights
# The training CLI's encoder and decoder blocks (MAST3R_512's width, the
# resume check's depth): at full depth its 8.3 GB training state and 2.6 GB
# `--save` deflate took minutes of one core and the disk beside the checks.
TRAIN_CLI_DEPTH = 2
TRAIN_SHAPES = ((4, 224, 224), (2, 384, 512))  # (batch, H, W): the CLI's default, SLAM frames
TRAIN_CHECK_SIZE = 112  # the card-vs-CPU step: 49 tokens, a ragged tile, CPU-affordable


def train_attention_shapes(cfg) -> list:
    """The (B, heads, N, 64) of every kernel A call on the training path at
    TRAIN_SHAPES (encoder and decoder heads; 196 tokens a ragged last tile),
    then one pair at 384x512 and the benchmark's training cell (batch 12
    at 384x512, encoder and decoder heads)."""
    shapes = [(b, heads, (h // cfg.patch_size) * (w // cfg.patch_size), d)
              for b, h, w in TRAIN_SHAPES
              for heads, d in ((cfg.enc_heads, cfg.head_dim), (cfg.dec_heads, cfg.dec_head_dim))]
    return shapes + [(1, cfg.enc_heads, 768, cfg.head_dim), (12, cfg.enc_heads, 768, cfg.head_dim),
                     (12, cfg.dec_heads, 768, cfg.dec_head_dim)]


def backward_kernel_row(train_run: dict) -> dict:
    """The backward kernels' entry of the `kernels` line, from the train
    phase's own runs: `attention_backward`'s calls (three launches each) in
    the timed one-device steps and the sharded steps, each count zeroed
    just before its run (`zero_counts`) and held there against the calls a
    step wants (96 at MAST3R_512, one a kernel A call; none in f32); and
    `train_gradient_check`'s rows at the benchmark's training shapes."""
    from monst3r_slam_torch.models.config import MAST3R_512 as cfg

    calls = dict(train=train_run["launches"]["attention_backward"],
                 train_mesh=train_run["mesh"]["launches"]["attention_backward"])
    keys = [f"bf16_tc {(12, heads, 768, d)}"
            for heads, d in ((cfg.enc_heads, cfg.head_dim), (cfg.dec_heads, cfg.dec_head_dim))]
    bench = {key: train_run["gradient"][key] for key in keys}
    enc = next(iter(bench.values()))
    return dict(name="attention_backward", route="cuda",
                source="monst3r_slam_torch/csrc/attention_bwd.cu", replaces=None,
                why="no TPU kernel: the reference's Pallas kernel has no backward; written for "
                    "the plain backward's (B, H, N, N) tensors in device memory",
                kernel="attn_bwd_prep, attn_bwd_dkdv, attn_bwd_dq (mma.sync bf16, f32 "
                       "accumulators, cp.async two-stage ring)",
                launches=3 * sum(calls.values()),
                launches_by_path={path: 3 * n for path, n in calls.items()},
                calls_by_path=calls,
                calls_per_step=dict(want=2 * cfg.enc_depth + 4 * cfg.dec_depth,
                                    train=[r["launches_per_step"]["attention_backward"]
                                           for r in train_run["steps"]]),
                shape=[12, cfg.enc_heads, 768, cfg.head_dim],
                grad_bound_ratio=enc["grad_bound_ratio"], device_ms=enc["bwd_device_ms"],
                plain_device_ms=enc["bwd_plain_device_ms"],
                library_device_ms=enc["bwd_library_device_ms"], bound_ms=enc["bwd_bound_ms"],
                bound_by=f"five bf16 products at {PEAK_BF16 / 1e12:.0f} TFLOP/s", rows=bench)


def train_gradient_check(seed: int) -> dict:
    """Kernel A's autograd Function (`attention.KernelAttention`) on both
    routes at each shape of `train_attention_shapes(MAST3R_512)`: the forward
    within `attention.error_bound` of the f32 plain version and dq, dk, dv
    within `attention.backward_error_bound` of the f32 plain autograd; one
    kernel A launch forward, none backward; in bf16 (width 64, which the
    backward kernels take) one call of the backward kernels (one launch
    of each, counted by `attention_backward.launches`), in f32 none.
    Times of a forward and backward (`ms`, back to back) beside the plain
    version's and SDPA's; and the backward alone on the device
    (`device_ms`): the Function's (`sdpa_backward`: the kernels in bf16),
    `sdpa_backward_plain`'s and SDPA's, beside the bound of its five
    products at the bf16 peak."""
    import torch
    import torch.nn.functional as F

    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.ops import attention

    rng = np.random.default_rng(seed)
    fa = attention.fused_attention
    rows = {}
    for route, dtype in (("bf16_tc", torch.bfloat16), ("f32", torch.float32)):
        for shape in train_attention_shapes(MAST3R_512):
            q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                             .to("cuda", dtype) for _ in range(4))
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            n0 = fa.route_launches[route]
            out = attention.sdpa(*leaves)
            n1 = fa.route_launches[route]
            c0 = attention.attention_backward.launches
            out.backward(dout)
            torch.cuda.synchronize()
            bwd = attention.attention_backward.launches - c0
            n2 = fa.route_launches[route]
            backward_fn = type(out.grad_fn).__name__
            want = int(attention.backward_route(dtype, shape[-1], q.device) == "kernel")
            if backward_fn != "KernelAttentionBackward" or (n1 - n0, n2 - n1) != (1, 0):
                fail(f"attention gradient {route} {shape}: grad_fn {backward_fn}, "
                     f"{n1 - n0} forward and {n2 - n1} backward launches (want 1 and 0)")
            if bwd != want:
                fail(f"attention gradient {route} {shape}: {bwd} calls of the backward kernels "
                     f"(want {want})")
            ref = [t.float().clone().requires_grad_() for t in (q, k, v)]
            ref_out = attention.sdpa_plain(*ref)
            ref_out.backward(dout.float())
            out, ref_out = out.detach(), ref_out.detach()
            fwd_err = float((out.float() - ref_out).abs().max())
            fwd_tol = attention.error_bound(q, k, v, ref_out)
            bounds = attention.backward_error_bound(q, k, v, dout)
            grad_err = {n: float((t.grad.float() - r.grad).abs().max())
                        for n, t, r in zip("qkv", leaves, ref)}
            ratio = max(float(((t.grad.float() - r.grad).abs() / b).max())
                        for t, r, b in zip(leaves, ref, bounds))
            if not (fwd_err <= fwd_tol and ratio <= 1.0):
                fail(f"attention gradient {route} {shape}: forward err {fwd_err:.3e} (tol "
                     f"{fwd_tol:.3e}), gradients at {ratio:.3f} of their bound {grad_err}")

            def fwd_bwd(fn):
                ls = [t.detach().requires_grad_() for t in (q, k, v)]
                fn(*ls).backward(dout)

            ls = [t.detach().requires_grad_() for t in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(*ls)
            ms = time_ms(lambda: fwd_bwd(attention.sdpa), iters=10)
            plain = time_ms(lambda: fwd_bwd(attention.sdpa_plain), iters=10)
            lib = time_ms(lambda: fwd_bwd(F.scaled_dot_product_attention), iters=10)
            dev = device_ms(lambda: attention.sdpa_backward(q, k, v, dout), iters=10)
            plain_dev = device_ms(lambda: attention.sdpa_backward_plain(q, k, v, dout), iters=10)
            lib_dev = device_ms(lambda: torch.autograd.grad(lib_out, ls, dout, retain_graph=True),
                                iters=10)
            del ls, lib_out
            b, h, n, d = shape
            b_ms = 10.0 * b * h * n * n * d / PEAK_BF16 * 1e3  # five products
            rows[route, shape] = dict(fwd_err=fwd_err, fwd_tol=fwd_tol, grad_err=grad_err,
                                      grad_bound_ratio=ratio, backward_calls=bwd, ms=ms,
                                      plain_ms=plain, library_ms=lib, bwd_device_ms=dev,
                                      bwd_plain_device_ms=plain_dev,
                                      bwd_library_device_ms=lib_dev, bwd_bound_ms=b_ms)
            print(f"attention gradient {route} {shape}: forward err {fwd_err:.3e} <= "
                  f"{fwd_tol:.3e}; dq/dk/dv err {grad_err['q']:.3e}/{grad_err['k']:.3e}/"
                  f"{grad_err['v']:.3e}, at most {ratio:.3f} of the bound; 1 kernel A launch "
                  f"forward, 0 backward, {bwd} call of the backward kernels; forward+backward ms: Function "
                  f"{ms:.4f}, plain {plain:.4f}, sdpa {lib:.4f}; backward device ms: Function "
                  f"{dev:.4f}, plain {plain_dev:.4f}, sdpa {lib_dev:.4f}, bound {b_ms:.4f} "
                  f"(five products at {PEAK_BF16 / 1e12:.0f} TFLOP/s)", flush=True)
    return {f"{route} {tuple(shape)}": r for (route, shape), r in rows.items()}


def launch_us(n: int = 5000) -> float:
    """The host's time per launch of a one-element add, in microseconds,
    over `n` launches back to back (the device finishes each long before
    the next is enqueued): what a host-bound step pays per kernel."""
    import torch

    x = torch.zeros(1, device="cuda")
    for _ in range(100):
        x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / n


def launch_us_around_profiler() -> tuple:
    """(before, after): `launch_us` in this process before and after one
    torch.profiler session of a few launches."""
    import torch

    before = launch_us()
    x = torch.zeros(1, device="cuda")
    profiled_ms(lambda: x.add_(1), iters=1, warmup=0)
    return before, launch_us()


def train_host_state() -> dict:
    """What the process brings to the timed steps from earlier work: the
    host's launch cost here, and in a fresh process before and after one
    profiler session; the threads alive, the objects the garbage collector
    tracks, and the load on the host."""
    import gc
    import os
    import threading

    fresh = subprocess.run([sys.executable, "-c", "import chip_smoke; "
                            "print(*chip_smoke.launch_us_around_profiler())"], cwd=ROOT,
                           capture_output=True, text=True, timeout=120)
    if fresh.returncode != 0:
        fail(f"the fresh launch-cost probe exited {fresh.returncode}:\n{fresh.stderr[-2000:]}")
    before, after = (float(x) for x in fresh.stdout.split()[-2:])
    row = dict(launch_us=launch_us(), fresh_launch_us=before, fresh_after_profiler_us=after,
               threads=sorted(t.name for t in threading.enumerate()),
               gc_objects=len(gc.get_objects()), loadavg=os.getloadavg())
    print(f"train host state: {row['launch_us']:.2f} us a launch here; in a fresh process "
          f"{before:.2f} us, {after:.2f} us after one profiler session; threads "
          f"{row['threads']}; {row['gc_objects']} objects tracked by gc; load "
          f"{row['loadavg']}", flush=True)
    return row


def train_state(cfg, seed: int, device):
    """A training state of random weights drawn on the CPU from `seed`."""
    import torch

    from monst3r_slam_torch.models.init import init_params
    from monst3r_slam_torch.train.step import init_train_state, make_optimizer

    params = _to_device(init_params(torch.Generator().manual_seed(seed), cfg), device)
    return init_train_state(params, make_optimizer())


def train_step_flops(cfg, b: int, h: int, w: int) -> float:
    """Forward and backward (3x the forward) of `b` pairs: 2 encodes + 1 decode each."""
    from monst3r_slam_torch.utils.flops import decode_flops, encode_flops

    return 3.0 * b * (2 * encode_flops(cfg, h, w) + decode_flops(cfg, h, w))


def train_timing(state, cfg, b: int, h: int, w: int, card: str, held: int):
    """Steps of `train_step` at (b, h, w): 2 to warm up, one whose launches
    are counted alone, 5 back to back (synchronized at the end) and 3
    synchronized one by one. Peak memory is counted above `held`, the bytes
    the process held on the card before the training state was made. The
    device time comes later (`train_device_time`): a torch.profiler session
    can leave later launches in the process slower on the host (see
    `train_host_state`). Returns (state, row)."""
    import torch

    import train_torch
    from monst3r_slam_torch.train.step import named_leaves, train_step
    from monst3r_slam_torch.utils.flops import mfu

    batches = [train_torch.synthetic_batch(i, b, h, w, "cuda") for i in range(4)]
    losses = []
    for i in range(2):  # warm-up
        state, loss = train_step(state, cfg, batches[i])
        losses.append(loss)
    torch.cuda.synchronize()
    before = read_counts()
    state, loss = train_step(state, cfg, batches[2])
    torch.cuda.synchronize()
    per_step = {name: n - before[name] for name, n in read_counts().items()}
    losses.append(loss)
    torch.cuda.reset_peak_memory_stats()
    n = 5
    t0 = time.perf_counter()
    for i in range(n):
        state, loss = train_step(state, cfg, batches[i % 4])
        losses.append(loss)
    torch.cuda.synchronize()
    b2b_ms = (time.perf_counter() - t0) * 1e3 / n
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    sync_ms = []
    for i in range(3):
        t0 = time.perf_counter()
        state, loss = train_step(state, cfg, batches[i])
        torch.cuda.synchronize()
        sync_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    losses = [float(x) for x in losses]
    flops = train_step_flops(cfg, b, h, w)
    n_params = sum(t.numel() for _, t in named_leaves(state.params))
    batch_bytes = sum(t.numel() * t.element_size() for t in batches[0].values())
    # weights and both AdamW moments read and written once, f32; the batch read
    b_ms, b_by = bound_ms(6 * 4 * n_params + batch_bytes, flops / PEAK_BF16)
    row = dict(batch=b, size=[h, w], launches_per_step=per_step, step_ms=b2b_ms,
               sync_step_ms=sync_ms, peak_gb=peak_gb, tflop=flops / 1e12, bound_ms=b_ms,
               bound_by=b_by, mfu=mfu(flops, b2b_ms / 1e3), losses=losses, steps=len(losses))
    print(f"train step ({card}) MAST3R_512 batch {b} {h}x{w}: {b2b_ms:.1f} ms back to back, "
          f"synchronized {[round(t, 1) for t in sync_ms]} ms; kernel A "
          f"{per_step['fused_attention']} launches a step; peak {peak_gb:.2f} GB; "
          f"{flops / 1e12:.3f} TFLOP, bound {b_ms:.3f} ms ({b_by}); MFU {row['mfu']['mfu_pct']}% "
          f"back to back (989 TFLOP/s); losses {[round(x, 4) for x in losses]}", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"train step at batch {b} {h}x{w}: a loss is not finite: {losses}")
    want = 2 * cfg.enc_depth + 4 * cfg.dec_depth
    if (per_step["fused_attention"] != want or per_step["attention_backward"] != want
            or per_step["tile_match_kernel"] != 0):
        fail(f"a train step launched {per_step} (want {want} kernel A and {want} backward "
             "kernel calls, no kernel B)")
    return state, row


def train_device_time(state, cfg, row: dict, card: str):
    """One step at the row's shape under torch.profiler: the device time of
    a step, its launches and the MFU of that time, added to `row`."""
    import train_torch
    from monst3r_slam_torch.train.step import train_step
    from monst3r_slam_torch.utils.flops import mfu

    b, (h, w) = row["batch"], row["size"]
    batch = train_torch.synthetic_batch(3, b, h, w, "cuda")
    losses = []

    def one():
        nonlocal state
        state, loss = train_step(state, cfg, batch)
        losses.append(loss)

    dev_ms, dev_launches = profiled_ms(one, iters=1, warmup=0)
    row.update(device_ms=dev_ms, device_launches=dev_launches,
               device_mfu=mfu(row["tflop"] * 1e12, dev_ms / 1e3), steps=row["steps"] + 1)
    row["losses"].append(float(losses[0]))
    print(f"train step device time ({card}) MAST3R_512 batch {b} {h}x{w}: {dev_ms:.2f} ms in "
          f"{dev_launches:.0f} launches; MFU {row['device_mfu']['mfu_pct']}% of device time "
          f"(989 TFLOP/s); loss {row['losses'][-1]:.4f}", flush=True)
    if not np.isfinite(row["losses"][-1]):
        fail(f"the profiled train step at batch {b} {h}x{w} gave a loss that is not finite")
    return state


def train_leaf_grads(params, cfg, batch, device: str, dtype) -> tuple:
    """(loss, [(path, f32 gradient on the CPU)]) of one `loss_fn` on a copy of
    `params` on `device` in `dtype`; zeros where the loss does not reach."""
    import torch

    from monst3r_slam_torch.train.step import loss_fn, named_leaves

    p = torch.utils._pytree.tree_map(lambda t: t.to(device, copy=True), params)
    leaves = named_leaves(p)
    for _, t in leaves:
        t.requires_grad_()
    loss = loss_fn(p, cfg, {k: t.to(device) for k, t in batch.items()}, dtype=dtype)
    loss.backward()
    return loss.item(), [(n, torch.zeros_like(t, device="cpu") if t.grad is None
                          else t.grad.float().cpu()) for n, t in leaves]


def train_cpu_grads(seed: int, cfg, size: int) -> dict:
    """The CPU half of `train_card_vs_cpu`: one step's loss and gradients at
    batch 1 on the CPU in f32 and in bf16, on weights and a pair from
    `seed`."""
    import torch

    import train_torch
    from monst3r_slam_torch.models.init import init_params

    params = init_params(torch.Generator().manual_seed(seed), cfg)
    batch = train_torch.synthetic_batch(seed, 1, size, size)
    t0 = time.perf_counter()
    l32, g32 = train_leaf_grads(params, cfg, batch, "cpu", torch.float32)
    l16, g16 = train_leaf_grads(params, cfg, batch, "cpu", torch.bfloat16)
    return dict(params=params, batch=batch, size=size, l32=l32, g32=g32, l16=l16, g16=g16,
                cpu_s=time.perf_counter() - t0)


def train_card_vs_cpu(cpu: dict, cfg) -> dict:
    """The same step at batch 1 on the card (bf16) against the CPU path's
    (`train_cpu_grads`): the loss and each leaf's gradient within twice the
    CPU path's bf16-vs-f32 distance (both bf16 runs round at the same
    places; the card's kernel A and cuBLAS sum in another order, a rounding
    difference of the size the bf16 run already carries). The worst leaf is
    printed with its f32 gradient's norm beside the bf16-vs-f32 distance it
    is measured in."""
    import torch

    l32, g32, l16, g16, size = (cpu[k] for k in ("l32", "g32", "l16", "g16", "size"))
    lc, gc = train_leaf_grads(cpu["params"], cfg, cpu["batch"], "cuda", torch.bfloat16)
    own, err = abs(l16 - l32), abs(lc - l16)
    worst, worst_name, worst_norms = 0.0, "", (0.0, 0.0)
    for (name, a), (_, b), (_, c) in zip(g32, g16, gc):
        d_own, d = float((b - a).norm()), float((c - b).norm())
        r = d / d_own if d_own > 0 else (0.0 if d == 0 else np.inf)
        if r > worst:
            worst, worst_name, worst_norms = r, name, (float(a.norm()), d_own)
    row = dict(size=size, loss_card=lc, loss_cpu_bf16=l16, loss_cpu_f32=l32,
               loss_ratio=err / own if own > 0 else np.inf, worst_grad_ratio=worst,
               worst_grad_leaf=worst_name, worst_grad_f32_norm=worst_norms[0],
               worst_grad_bf16_dist=worst_norms[1], cpu_s=cpu["cpu_s"])
    print(f"train card vs CPU (MAST3R_512, batch 1, {size}x{size}): loss {lc:.6f} against "
          f"{l16:.6f} (CPU bf16) and {l32:.6f} (CPU f32): {row['loss_ratio']:.3f} of the CPU "
          f"path's bf16-vs-f32 distance; per-leaf gradient distance at most {worst:.3f} of it "
          f"({worst_name}: f32 gradient norm {worst_norms[0]:.4g}, bf16-vs-f32 distance "
          f"{worst_norms[1]:.4g}); CPU runs {cpu['cpu_s']:.1f} s", flush=True)
    if not (row["loss_ratio"] <= 2.0 and worst <= 2.0):
        fail(f"the card's training step is further from the CPU path's bf16 step than twice "
             f"the CPU path's own bf16 distance: {row}")
    return row


def train_resume_check(seed: int) -> dict:
    """2 steps, `save`, `restore_latest` into a state from another seed, 2
    more, against 4 uninterrupted steps: losses and weights compared bit for
    bit, at MAST3R_512 width cut to 2 encoder and 2 decoder blocks, batch 2,
    224x224. Run with `torch.use_deterministic_algorithms(True)` in a
    process whose cuBLAS workspace is fixed (`CUBLAS_WORKSPACE_CONFIG`)."""
    import dataclasses
    import shutil

    import torch

    import train_torch
    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.train import checkpoint
    from monst3r_slam_torch.train.step import named_leaves, train_step

    torch.use_deterministic_algorithms(True)
    cfg = dataclasses.replace(MAST3R_512, enc_depth=2, dec_depth=2)
    batches = [train_torch.synthetic_batch(i, 2, 224, 224, "cuda") for i in range(4)]
    ref, ref_losses = train_state(cfg, seed, "cuda"), []
    for i in range(4):
        ref, loss = train_step(ref, cfg, batches[i])
        ref_losses.append(float(loss))
    ref_w = [t.detach().cpu() for _, t in named_leaves(ref.params)]
    del ref
    state = train_state(cfg, seed, "cuda")
    for i in range(2):
        state, _ = train_step(state, cfg, batches[i])
    ckdir = TRAIN_DIR / "resume"
    shutil.rmtree(ckdir, ignore_errors=True)
    mngr = checkpoint.make_manager(ckdir)
    checkpoint.save(mngr, state)
    del state
    resumed = checkpoint.restore_latest(mngr, train_state(cfg, seed + 1, "cuda"))
    losses = []
    for i in range(2, 4):
        resumed, loss = train_step(resumed, cfg, batches[i])
        losses.append(float(loss))
    diffs = {n: float((t.detach().cpu() - r).abs().max())
             for (n, t), r in zip(named_leaves(resumed.params), ref_w)}
    shutil.rmtree(ckdir, ignore_errors=True)
    differ = {n: d for n, d in diffs.items() if d != 0}
    return dict(bit_exact=losses == ref_losses[2:] and not differ, losses=losses,
                ref_losses=ref_losses[2:], leaves_differ=len(differ), leaves=len(diffs),
                max_weight_diff=max(diffs.values()),
                worst=sorted(differ.items(), key=lambda kv: -kv[1])[:5])


TRAIN_MESH_SHAPE = (4, 224, 224)  # (batch, H, W): the CLI's default
TRAIN_MESH_STEPS = 3
TRAIN_MESH_LR = 1e-4  # make_optimizer's default
# f32, TF32 off. From one state the sharded step differs from the
# one-device step only in the order of its f32 sums (the row-parallel
# partials, the batch split over dp, the rows' loss terms): the first
# step's loss within 2^-13 relative, and each leaf's first gradient within
# 2^-6 of its norm (a ReLU or clamp whose input sits at its kink can move
# a few elements by more than rounding). AdamW then steps each weight by
# lr g/(|g| + eps) on the first step, so where rounding decides a
# gradient's sign the runs part by 2 lr, and later steps start from other
# weights: later losses part further, within 2^-8, while in every leaf at
# least 90% of the weights stay within 2^-4 lr a step. The largest weight
# difference is read (`max_lr`) but bounded only to be finite: two AdamW
# runs from one state part by at most (2 + 2^-6) lr a step whatever their
# gradients (|m|/sqrt(v) <= 1.0004 at these betas, by Cauchy-Schwarz), so
# no finite bound on it could reject a wrong gradient. On the H100 at full
# width the first gradients were 1.8e-3 of their norm apart at most, the
# later losses 2.4e-5-2.3e-4, and at least 95.0% of every leaf agreed (the
# DPT's refinement convolutions the lowest); `planted_fault`'s defects,
# which these bounds must reject, are read beside them.
TRAIN_MESH_LOSS_RTOL = (2.0**-13, 2.0**-8)  # the first step, the later ones
TRAIN_MESH_GRAD_RTOL = 2.0**-6
TRAIN_MESH_AGREE_LR = 2.0**-4
TRAIN_MESH_AGREE_SHARE = 0.90
# the defects `planted_fault` plants, and those the card's run plants
TRAIN_MESH_FAULTS = ("dp_row_gradient", "qkv_shards_swapped", "bias_twice", "dp_row_loss")
TRAIN_MESH_CARD_FAULTS = ("dp_row_gradient", "qkv_shards_swapped")


def train_mesh_grids() -> list:
    """The meshes the sharded step runs on: a (2, 2) grid of cuda:0, and
    `make_mesh()` over every card when several are visible."""
    import torch

    from monst3r_slam_torch.parallel.mesh import make_mesh

    grids = [make_mesh(devices=[torch.device("cuda", 0)] * 4)]
    if torch.cuda.device_count() > 1:
        grids.append(make_mesh())
    return grids


@contextlib.contextmanager
def recorded_attention_shapes(shapes: dict):
    """Every attention of the model's blocks inside (`blocks.sdpa`, kernel A
    on the card) adds its q's shape (B, H, N, d) to `shapes`; the first call at each
    shape also holds its output against the plain version from the same q,
    k and v (`attention.reference`; a shard's heads, with the strides of its
    qkv chunk), within `attention.error_bound`: `shapes` maps each shape to
    (max abs err, tol). The plain version launches no kernel."""
    import torch

    from monst3r_slam_torch.models import blocks
    from monst3r_slam_torch.ops import attention

    sdpa = blocks.sdpa

    def recording(q, k, v):
        out = sdpa(q, k, v)
        shape = tuple(q.shape)
        if shape not in shapes:
            with torch.no_grad():
                ref = attention.reference(q, k, v)
                err = float((out.double() - ref).abs().max())
                tol = attention.error_bound(q, k, v, ref)
            shapes[shape] = (err, tol)
            if not (np.isfinite(err) and err <= tol):
                fail(f"kernel A at {shape} ({q.dtype}, strides {q.stride()}): "
                     f"max abs err {err} > {tol}")
        return out

    blocks.sdpa = recording
    try:
        yield
    finally:
        blocks.sdpa = sdpa


@contextlib.contextmanager
def planted_fault(fault: str):
    """One of `TRAIN_MESH_FAULTS` planted in the sharded step while inside,
    for `train_mesh_step_check` to reject: `dp_row_gradient`, the last dp
    row reaches the weights through detached copies (its loss counts, its
    gradient is lost: no gradient sum over dp); `qkv_shards_swapped`, each
    qkv's shard outputs in reverse order (shard t attends with the other
    shard's heads; on a grid that repeats one device); `bias_twice`, each
    row-parallel linear adds its bias twice; `dp_row_loss`, the last dp
    row's loss numerators and denominators left out of the sums."""
    import dataclasses

    import torch

    from monst3r_slam_torch.models import blocks
    from monst3r_slam_torch.parallel.mesh import Sharded
    from monst3r_slam_torch.train import step

    row_params, sum_home, tp_linear = step.row_params, step.sum_home, blocks._tp_linear

    def detach(w):
        if isinstance(w, Sharded):
            return dataclasses.replace(w, parts=[t.detach() for t in w.parts])
        return w.detach()

    def faulty_rows(params, mesh, d):
        p = row_params(params, mesh, d)
        return torch.utils._pytree.tree_map(detach, p) if d == mesh.shape["dp"] - 1 else p

    def faulty_linear(p, x):
        y, w, b = tp_linear(p, x), p["w"], p.get("b")
        if fault == "qkv_shards_swapped" and w.groups == 3:
            return y[::-1]
        if fault == "bias_twice" and w.dim == 1 and b is not None:
            return y + b.to(y.dtype)
        return y

    if fault == "dp_row_gradient":
        step.row_params = faulty_rows
    elif fault == "dp_row_loss":
        step.sum_home = lambda parts: sum_home(parts[:-1])
    elif fault in ("qkv_shards_swapped", "bias_twice"):
        blocks._tp_linear = faulty_linear
    else:
        raise ValueError(f"no planted fault {fault!r}")
    try:
        yield
    finally:
        step.row_params, step.sum_home, blocks._tp_linear = row_params, sum_home, tp_linear


def _whole_grads(params) -> list:
    """[(path, the gradient the last step left)] of a (sharded) tree, a split
    weight's parts' gradients joined."""
    from monst3r_slam_torch.parallel.mesh import Sharded
    from monst3r_slam_torch.train.step import named_leaves

    return [(n, w.whole([p.grad for p in w.parts]) if isinstance(w, Sharded) else w.grad)
            for n, w in named_leaves(params)]


def train_mesh_step_check(one_params, sharded, mesh, step: int, losses: tuple) -> dict:
    """The sharded run against the one-device run after step `step` (1-based)
    of each, their `losses` (one-device, sharded) given: the loss's
    relative difference; after the first step each leaf's gradient
    difference over its norm; every step the largest weight difference
    beyond 4 eps of the weight in units of lr, and the smallest share of a
    leaf's weights within TRAIN_MESH_AGREE_LR lr a step. `failed` names
    the bounds stated above TRAIN_MESH_LOSS_RTOL that the step breaks
    (`loss`, `grad`, `finite`, `share`); `ok` when none."""
    import torch

    from monst3r_slam_torch.parallel.mesh import gather_params
    from monst3r_slam_torch.train.step import named_leaves

    eps, lr = 2.0**-23, TRAIN_MESH_LR
    row = dict(step=step, loss_rel=abs(losses[1] - losses[0]) / abs(losses[0]))
    with torch.no_grad():
        if step == 1:
            got = dict(_whole_grads(sharded))
            row["grad_rel"], row["grad_leaf"] = max(
                (float((got[n] - g).norm() / g.norm()) if g.norm() > 0
                 else float((got[n] != 0).any()) * np.inf, n) for n, g in _whole_grads(one_params))
            del got
        worst_lr, worst_share, worst_leaf = 0.0, 1.0, ""
        got = dict(named_leaves(gather_params(sharded, mesh)))
        for name, want in named_leaves(one_params):
            d = (got.pop(name) - want).abs() - 4 * eps * want.abs()
            worst_lr = max(worst_lr, float(d.max()) / lr)
            share = float((d <= TRAIN_MESH_AGREE_LR * step * lr).float().mean())
            if share < worst_share:
                worst_share, worst_leaf = share, name
    row.update(max_lr=worst_lr, min_agree_share=worst_share, min_agree_leaf=worst_leaf)
    row["failed"] = [bound for bound, held in (
        ("loss", row["loss_rel"] <= TRAIN_MESH_LOSS_RTOL[step > 1]),
        ("grad", row.get("grad_rel", 0.0) <= TRAIN_MESH_GRAD_RTOL),
        ("finite", np.isfinite(worst_lr)),
        ("share", worst_share >= TRAIN_MESH_AGREE_SHARE)) if not held]
    row["ok"] = not row["failed"]
    return row


def train_mesh_compare(seed: int, mesh, dtype, fault: str | None = None) -> dict:
    """`TRAIN_MESH_STEPS` steps of `train_step` on `mesh` (`shard_params`
    weights, `batch_sharding` batches) against as many one-device steps from
    the same MAST3R_512 weights (drawn on the card from `seed`) and batches,
    in `dtype`, with `fault` (`planted_fault`) planted in the sharded steps
    where given (then up to the first step the check rejects): each step's
    losses, and in f32 each step held by `train_mesh_step_check`; the
    kernels' launches in the sharded steps
    alone (the counters zeroed just before each and read just after), and
    kernel A's on its dtype's route; the shapes kernel A ran at, each held
    against the plain version (`recorded_attention_shapes`). Returns the
    row and both states."""
    import torch

    import train_torch
    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.models.init import init_params
    from monst3r_slam_torch.parallel.mesh import batch_sharding, shard_params
    from monst3r_slam_torch.train.step import init_train_state, make_optimizer, train_step

    b, h, w = TRAIN_MESH_SHAPE
    params = init_params(torch.Generator(device="cuda").manual_seed(seed), MAST3R_512)
    mesh_state = init_train_state(shard_params(params, mesh), make_optimizer(TRAIN_MESH_LR))
    one = init_train_state(params, make_optimizer(TRAIN_MESH_LR))
    route = "bf16_tc" if dtype == torch.bfloat16 else "f32"
    row = dict(dtype=str(dtype).split(".")[-1], mesh=dict(mesh.shape), fault=fault, losses=[],
               one_losses=[], checks=[], launches={}, route_launches=0, attention={})
    attn = _counters()[0]
    for i in range(TRAIN_MESH_STEPS):
        batch = train_torch.synthetic_batch(i, b, h, w, "cuda")
        one, loss = train_step(one, MAST3R_512, batch, dtype=dtype)
        row["one_losses"].append(float(loss))
        placed = {k: batch_sharding(mesh, t) for k, t in batch.items()}
        with planted_fault(fault) if fault else contextlib.nullcontext():
            zero_counts()
            with recorded_attention_shapes(row["attention"]):
                mesh_state, loss = train_step(mesh_state, MAST3R_512, placed, dtype=dtype,
                                              mesh=mesh)
            torch.cuda.synchronize()
        for name, n in read_counts().items():
            row["launches"][name] = row["launches"].get(name, 0) + n
        row["route_launches"] += attn.route_launches[route]
        row["losses"].append(float(loss))
        if dtype == torch.float32:
            row["checks"].append(train_mesh_step_check(
                one.params, mesh_state.params, mesh, i + 1, (row["one_losses"][-1], float(loss))))
            if fault and not row["checks"][-1]["ok"]:
                break  # the fault is caught: later steps would only repeat the verdict
    row["shapes"] = sorted(row["attention"])
    return row, one, mesh_state


def train_mesh_timing(state, mesh, card: str, held: int) -> dict:
    """Steps of the bf16 `train_step` at TRAIN_MESH_SHAPE on `mesh`: 3 back
    to back (synchronized at the end), 2 synchronized one by one, peak
    memory over them above `held` (the bytes the process held before the
    training state was made, as `train_timing` counts it), then one under
    torch.profiler (device time and launches). The kernels' launches in
    these steps are counted alone (`launches`)."""
    import torch

    import train_torch
    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.parallel.mesh import batch_sharding
    from monst3r_slam_torch.train.step import train_step

    b, h, w = TRAIN_MESH_SHAPE
    batch = {k: batch_sharding(mesh, t)
             for k, t in train_torch.synthetic_batch(3, b, h, w, "cuda").items()}
    losses = []

    def one():
        nonlocal state
        state, loss = train_step(state, MAST3R_512, batch, mesh=mesh)
        losses.append(loss)

    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(3):
        one()
    torch.cuda.synchronize()
    b2b_ms = (time.perf_counter() - t0) * 1e3 / 3
    sync_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        sync_ms.append((time.perf_counter() - t0) * 1e3)
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    dev_ms, dev_launches = profiled_ms(one, iters=1, warmup=0)
    launches = read_counts()
    losses = [float(x) for x in losses]
    row = dict(mesh=dict(mesh.shape), step_ms=b2b_ms, sync_step_ms=sync_ms, peak_gb=peak_gb,
               device_ms=dev_ms, device_launches=dev_launches, losses=losses, steps=len(losses),
               launches=launches)
    print(f"train_mesh step ({card}) {row['mesh']}: {b2b_ms:.1f} ms back to back, synchronized "
          f"{[round(t, 1) for t in sync_ms]} ms; device {dev_ms:.2f} ms in {dev_launches:.0f} "
          f"launches; peak {peak_gb:.2f} GB above what the process held before the state; "
          f"kernel launches in its {len(losses)} steps {launches}", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"a timed train_mesh step gave a loss that is not finite: {losses}")
    return row


def train_mesh_decode_check(state, mesh) -> dict:
    """`sharded_edge_decode` on the stepped split weights against the same
    decode on their gathered replicas: one edge batch of 3 pairs (an odd
    count: the pad row is added and stripped) of 224x224 features, equal
    bit for bit."""
    import torch

    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.models.rope import patch_positions
    from monst3r_slam_torch.parallel.inference import place_replicated, sharded_edge_decode
    from monst3r_slam_torch.parallel.mesh import gather_params

    _, h, w = TRAIN_MESH_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(7)
    n_h, n_w = h // MAST3R_512.patch_size, w // MAST3R_512.patch_size
    feat1, feat2 = (0.1 * torch.randn((3, n_h * n_w, MAST3R_512.enc_dim), generator=gen,
                                      device="cuda") for _ in range(2))
    pos = patch_positions(n_h, n_w, 3, device="cuda")
    args = (feat1, pos, feat2, pos, (h, w))
    t0 = time.perf_counter()
    out = sharded_edge_decode(mesh, state.params, MAST3R_512, *args)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    ref = sharded_edge_decode(mesh, place_replicated(gather_params(state.params, mesh), mesh),
                              MAST3R_512, *args)
    equal = all((a is None and r is None) or torch.equal(a, r) for a, r in zip(out, ref))
    finite = all(a is None or bool(torch.isfinite(a).all()) for a in out)
    return dict(equal=equal, finite=finite, rows=out.X1.shape[0], ms=decode_ms)


def phase_train_mesh(seed: int, card: str, one_device: dict | None = None) -> dict:
    """Training's dp x tp mesh at MAST3R_512 full width, 224x224, batch 4
    (`parallel/mesh.py`, the tensor-parallel forward of `models/blocks.py`,
    `train_step(mesh=)`), on each of `train_mesh_grids()`: 3 sharded f32
    steps (TF32 off) against 3 one-device steps from the same weights and
    batches (`train_mesh_step_check`: losses, first gradients, gathered
    weights after each step), then 3 bf16 ones (each loss within
    twice the one-device bf16 step's distance from the f32 step's), kernel
    A launched 96 dp tp times a sharded step on the route of its dtype, at
    (B/dp, H/tp, N, 64), each shape held against the plain version; on the
    grid of one card, each of `TRAIN_MESH_CARD_FAULTS` planted in up to 3
    f32 steps, which the check must reject (the run stops at the first
    step it rejects); the bf16 sharded step timed
    (`train_mesh_timing`) beside `one_device`, the `train` phase's row of
    the one-device step at TRAIN_MESH_SHAPE (none with `--only-train-mesh`);
    and the edge decode on the stepped split weights
    (`train_mesh_decode_check`). Returns the rows and the kernels' launches
    in the sharded steps alone (the compared and the timed ones, no fault's
    and no decode's)."""
    import torch

    from monst3r_slam_torch.models.config import MAST3R_512 as cfg

    t_phase = time.perf_counter()
    rows, launches = [], dict.fromkeys(read_counts(), 0)
    for g, mesh in enumerate(train_mesh_grids()):
        dp, tp = mesh.shape["dp"], mesh.shape["tp"]
        want = (2 * cfg.enc_depth + 4 * cfg.dec_depth) * dp * tp
        f32, one, sharded = train_mesh_compare(seed, mesh, torch.float32)
        del one, sharded
        faults = []
        for fault in TRAIN_MESH_CARD_FAULTS if g == 0 else ():
            row, one, sharded = train_mesh_compare(seed, mesh, torch.float32, fault)
            del one, sharded
            faults.append(dict(fault=fault, losses=row["losses"], one_losses=row["one_losses"],
                               checks=row["checks"]))
            print(f"train_mesh {dict(mesh.shape)} ({card}), {fault} planted: bounds failed "
                  f"{[c['failed'] for c in row['checks']]}; checks {row['checks']}", flush=True)
            if all(c["ok"] for c in row["checks"]):
                fail(f"the sharded-step check passed {TRAIN_MESH_STEPS} steps with {fault} "
                     "planted")
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        bf16, one, sharded = train_mesh_compare(seed, mesh, torch.bfloat16)
        del one
        own = [abs(a - b) for a, b in zip(bf16["one_losses"], f32["one_losses"])]
        ratio = [abs(a - b) / o if o > 0 else np.inf
                 for a, b, o in zip(bf16["losses"], bf16["one_losses"], own)]
        print(f"train_mesh {dict(mesh.shape)} ({card}) MAST3R_512 batch {TRAIN_MESH_SHAPE[0]} "
              f"{TRAIN_MESH_SHAPE[1]}x{TRAIN_MESH_SHAPE[2]}, {TRAIN_MESH_STEPS} steps: f32 "
              f"losses {f32['losses']} against {f32['one_losses']}; checks {f32['checks']}; "
              f"bf16 losses {bf16['losses']} against {bf16['one_losses']} "
              f"({[round(r, 3) for r in ratio]} of "
              f"the one-device bf16-vs-f32 distance); kernel A {f32['route_launches']} (f32) and "
              f"{bf16['route_launches']} (bf16) launches on the dtype's route, at "
              f"{bf16['shapes']}; against the plain version (max abs err, tol): f32 "
              f"{f32['attention']}, bf16 {bf16['attention']}", flush=True)
        if not all(np.isfinite(f32["losses"] + bf16["losses"])):
            fail("a sharded train step gave a loss that is not finite")
        if not all(c["ok"] for c in f32["checks"]):
            fail(f"the sharded f32 step on {dict(mesh.shape)} strays from the one-device step")
        if max(ratio) > 2.0:
            fail(f"the sharded bf16 step on {dict(mesh.shape)} strays from the one-device step "
                 f"by more than twice its own bf16 distance: {ratio}")
        for row, route in ((f32, "f32"), (bf16, "bf16_tc")):
            n = row["launches"]["fused_attention"]
            if not n == row["route_launches"] == want * TRAIN_MESH_STEPS:
                fail(f"{TRAIN_MESH_STEPS} sharded {route} steps on {dict(mesh.shape)} launched "
                     f"kernel A {n} times ({row['route_launches']} on its route), not {want} a "
                     "step")
            # the backward kernels take the bf16 steps' every call, none of the f32 steps'
            n_bwd = row["launches"]["attention_backward"]
            if n_bwd != (want if route == "bf16_tc" else 0) * TRAIN_MESH_STEPS:
                fail(f"{TRAIN_MESH_STEPS} sharded {route} steps on {dict(mesh.shape)} called the "
                     f"backward kernels {n_bwd} times")
        b = TRAIN_MESH_SHAPE[0] // dp
        n = (TRAIN_MESH_SHAPE[1] // cfg.patch_size) * (TRAIN_MESH_SHAPE[2] // cfg.patch_size)
        if not f32["shapes"] == bf16["shapes"] == sorted({(b, cfg.enc_heads // tp, n, cfg.head_dim),
                                                          (b, cfg.dec_heads // tp, n,
                                                           cfg.dec_head_dim)}):
            fail(f"kernel A ran the sharded step at {f32['shapes']} / {bf16['shapes']}")
        timing = train_mesh_timing(sharded, mesh, card, held)
        if (timing["launches"]["fused_attention"] != want * timing["steps"]
                or timing["launches"]["attention_backward"] != want * timing["steps"]):
            fail(f"{timing['steps']} timed sharded steps launched {timing['launches']}, not "
                 f"{want} kernel A and {want} backward kernel calls a step")
        for counts in (f32["launches"], bf16["launches"], timing["launches"]):
            for name, k in counts.items():
                launches[name] += k
        decode = train_mesh_decode_check(sharded, mesh)
        print(f"train_mesh decode on the stepped split weights ({card}): {decode}", flush=True)
        if not (decode["equal"] and decode["finite"] and decode["rows"] == 3):
            fail(f"the edge decode on split weights is not the decode on their replicas: {decode}")
        del sharded
        torch.cuda.empty_cache()
        rows.append(dict(f32=f32, bf16=bf16, bf16_ratio=ratio, faults=faults, timing=timing,
                         decode=decode))
    if one_device is not None:
        print(f"train_mesh: the one-device step at {TRAIN_MESH_SHAPE} (the train phase's row): "
              f"{one_device['step_ms']:.1f} ms back to back, synchronized "
              f"{[round(t, 1) for t in one_device['sync_step_ms']]} ms; device "
              f"{one_device['device_ms']:.2f} ms in {one_device['device_launches']:.0f} launches; "
              f"peak {one_device['peak_gb']:.2f} GB", flush=True)
    for row in rows:
        for v in (row["f32"], row["bf16"]):
            v["attention"] = [[list(s), err, tol] for s, (err, tol) in v["attention"].items()]
    secs = time.perf_counter() - t_phase
    print(f"train_mesh: {secs:.1f} s; kernel launches in the sharded steps {launches}",
          flush=True)
    return dict(rows=rows, launches=launches, seconds=secs)


def stop_backend_workers() -> int:
    """End the backend worker of every asynchronous SLAMSystem the earlier
    phases left running (each waits for jobs and holds its system, keyframe
    memory and weights on the card until the process ends), then release
    what they held. Returns how many were running."""
    import gc

    import torch

    from monst3r_slam_torch.app.pipeline import SLAMSystem

    n = 0
    for obj in gc.get_objects():
        if isinstance(obj, SLAMSystem) and obj._worker is not None:
            obj._backend_jobs.put(None)
            obj._worker.join()
            obj._worker = None
            n += 1
    gc.collect()
    torch.cuda.empty_cache()
    return n


def phase_train(seed: int, card: str) -> dict:
    """The training path (`train_torch.py`, `monst3r_slam_torch/train/`) at
    MAST3R_512 full width. The CLI runs unchanged in a subprocess, from a
    checkpoint at MAST3R_512's width cut to `TRAIN_CLI_DEPTH` encoder and
    decoder blocks (its `--checkpoint`, whose stored constructor string
    gives it the config), so that its files (the training state and the
    `--save` file's deflate on one core) take a minute, not several, beside
    the checks; the in-process steps run at full depth. First the backend
    workers the earlier phases left running are stopped. The resume check
    under deterministic algorithms (in a subprocess) and the CPU half of
    the card-vs-CPU step run beside the CLI's steps; beside its writes run,
    in turn: the host's launch cost here and in a fresh process (a
    torch.profiler session can slow later launches in its process); kernel
    A's gradient; steps timed in-process at both shapes, then one step each
    under the profiler, the launch counters zeroed just before and read
    just after; the card half of the card-vs-CPU step; and the sharded step
    on the dp x tp mesh (`phase_train_mesh`); and, in a thread once the CLI
    exits, its `--save` file inflated. The CLI must print the mesh that
    `make_mesh()` builds over the visible cards ((1, 1) on one card)."""
    import dataclasses
    import os
    import shutil
    import threading

    import torch

    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.models.convert import save_checkpoint
    from monst3r_slam_torch.models.init import init_params
    from monst3r_slam_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    before = torch.cuda.memory_allocated()
    workers = stop_backend_workers()
    print(f"train: the earlier phases left {workers} backend workers running; stopping them "
          f"took the card's allocated memory from {before / 1e9:.2f} to "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    TRAIN_DIR.mkdir(parents=True)
    # The resume check in a process of its own, from the start: it measures
    # nothing, so it shares the card with the CLI and the CPU half of the
    # card-vs-CPU step rather than adding its ~45 s after the checks.
    code = ("import json, chip_smoke; "
            f"print('RESUME ' + json.dumps(chip_smoke.train_resume_check({seed})))")
    with open(TRAIN_DIR / "resume.out", "w") as so, open(TRAIN_DIR / "resume.err", "w") as se:
        resumer = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=so, stderr=se,
                                   env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    save, ckdir, start = TRAIN_DIR / "params.npz", TRAIN_DIR / "ckpt", TRAIN_DIR / "start.pth"
    cmd = [sys.executable, "train_torch.py", "--synthetic", "--checkpoint", str(start),
           "--steps", "8", "--batch", "4", "--save", str(save), "--ckpt-dir", str(ckdir)]
    proc, saved = None, {}

    def read_save():  # the CLI's exit, then its --save file inflated, beside the card checks
        saved["rc"] = proc.wait(timeout=900)
        if saved["rc"] == 0:
            with np.load(save) as f:
                saved["n_arrays"] = len(f.files)
                saved["finite"] = all(np.isfinite(f[name]).all() for name in f.files)

    try:
        cli_cfg = dataclasses.replace(MAST3R_512, enc_depth=TRAIN_CLI_DEPTH,
                                      dec_depth=TRAIN_CLI_DEPTH)
        save_checkpoint(str(start), init_params(torch.Generator(device="cuda").manual_seed(seed),
                                                cli_cfg), cli_cfg)
        with open(TRAIN_DIR / "cli.out", "w") as so, open(TRAIN_DIR / "cli.err", "w") as se:
            proc = subprocess.Popen(cmd, cwd=ROOT, stdout=so, stderr=se, text=True)
        t_cli = time.time()
        reader = threading.Thread(target=read_save, daemon=True)
        reader.start()
        cpu = train_cpu_grads(seed, MAST3R_512, TRAIN_CHECK_SIZE)
        while proc.poll() is None and not any(ckdir.glob("step_8*")):
            if time.perf_counter() - t_phase > 300:
                fail("train_torch.py wrote no checkpoint within 300 s")
            time.sleep(0.2)
        cli_steps_s = time.perf_counter() - t_phase

        host = train_host_state()
        grad = train_gradient_check(seed)
        held = torch.cuda.memory_allocated()  # what the earlier phases left on the card
        t0 = time.perf_counter()
        state = train_state(MAST3R_512, seed, "cuda")
        init_s = time.perf_counter() - t0
        zero_counts()
        rows = []
        for b, h, w in TRAIN_SHAPES:
            state, row = train_timing(state, MAST3R_512, b, h, w, card, held)
            rows.append(row)
        for row in rows:
            state = train_device_time(state, MAST3R_512, row, card)
        launches = read_counts()
        n_steps = sum(r["steps"] for r in rows)
        if not launches["fused_attention"] == launches["attention_backward"] == n_steps * 96:
            fail(f"the timed training steps launched {launches} over {n_steps} steps "
                 "(want 96 kernel A and 96 backward kernel calls a step)")
        del state
        torch.cuda.empty_cache()
        timed_s = time.perf_counter() - t0

        check = train_card_vs_cpu(cpu, MAST3R_512)
        del cpu
        mesh_run = phase_train_mesh(seed, card, rows[0])
        resumer.wait(timeout=300)
        resume_out = (TRAIN_DIR / "resume.out").read_text()
        resume_err = (TRAIN_DIR / "resume.err").read_text()
        checks_s = time.perf_counter() - t_phase
        reader.join(timeout=900)
        rc = saved.get("rc")
    finally:
        for child in (proc, resumer):
            if child is not None and child.poll() is None:
                child.kill()
    cli_s = (save.stat().st_mtime if save.is_file() else time.time()) - t_cli
    cli_out = (TRAIN_DIR / "cli.out").read_text()
    if rc != 0:
        fail(f"train_torch.py exited {rc}:\n{cli_out[-2000:]}\n"
             f"{(TRAIN_DIR / 'cli.err').read_text()[-4000:]}")
    cli_losses = [float(ln.split("loss ")[1].split()[0]) for ln in cli_out.splitlines()
                  if ln.startswith("step ")]
    n_arrays, saved_finite = saved.get("n_arrays", 0), saved.get("finite", False)
    ckpts = sorted(p.name for p in ckdir.iterdir())
    ck_gb = sum(p.stat().st_size for p in ckdir.iterdir()) / 1e9
    print(f"train CLI: {' '.join(cmd[1:])}: exit 0 in {cli_s:.1f} s ({cli_steps_s:.1f} s to "
          f"its checkpoint); printed losses {cli_losses}; {save.name} "
          f"{save.stat().st_size / 1e9:.2f} GB, {n_arrays} arrays, finite {saved_finite}; "
          f"checkpoints {ckpts} ({ck_gb:.2f} GB)", flush=True)
    if (cli_out.splitlines()[0] != f"mesh: {dict(make_mesh().shape)}" or not cli_losses
            or not all(np.isfinite(cli_losses)) or not saved_finite or ckpts != ["step_8.pt"]):
        fail(f"train_torch.py's run is not well-formed:\n{cli_out[-2000:]}")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    if resumer.returncode != 0:
        fail(f"the resume check exited {resumer.returncode}:\n{resume_err[-4000:]}")
    resume = json.loads(resume_out.split("RESUME ", 1)[1])
    print(f"train resume on the card (MAST3R_512 width, 2+2 blocks, batch 2, 224x224, "
          f"deterministic algorithms): bit-exact {resume['bit_exact']}; losses "
          f"{resume['losses']} against {resume['ref_losses']}; {resume['leaves_differ']} of "
          f"{resume['leaves']} leaves differ, at most {resume['max_weight_diff']:.3g} "
          f"{resume['worst']}", flush=True)
    if not resume["bit_exact"]:
        fail("a resumed training run on the card did not continue bit for bit")
    secs = time.perf_counter() - t_phase
    print(f"train phase: {secs:.1f} s (the CLI {cli_s:.1f} s, {cli_steps_s:.1f} s of it to its "
          f"checkpoint; the checks beside it done at {checks_s:.1f} s, state init "
          f"{init_s:.1f} s, timed steps {timed_s:.1f} s); the earlier phases held "
          f"{held / 1e9:.2f} GB of the card", flush=True)
    return dict(host=host, gradient=grad, cli_s=cli_s, cli_steps_s=cli_steps_s,
                cli_losses=cli_losses, steps=rows, launches=launches, card_vs_cpu=check,
                resume=resume, mesh=mesh_run, held_gb=held / 1e9, stopped_workers=workers,
                checks_s=checks_s, seconds=secs)

HEADS_DIR = ROOT / "build" / "smoke_heads"  # checkpoints, frames and outputs of the heads phase
# Kernel A's head widths in the heads phase: below, at and between its
# instantiations (16, 32, 64, 128).
HEAD_WIDTHS = (8, 12, 16, 24, 32, 48, 64, 80, 96, 128)
# (B, H, Nq, Nk): the encoder's 768 tokens at 16 heads and a 224x224 batch
# of two at 8 heads (both timed), and one ragged count (checked only).
HEAD_SHAPES = ((1, 16, 768, 768), (2, 8, 196, 196), (1, 4, 100, 300))


# Kernel A's f32 route above head width 64 before it ran on the tensor
# cores: the FFMA kernels' device ms (`attn_fwd_f32<128|256>`, widths
# between padded, and `attn_fwd_f32_wide`) at the (B, H, N, d) this script
# times, from PERF.md's kernel table (NVIDIA H100 80GB HBM3, 700.00 W),
# printed beside the tensor-core kernel's and never measured here (that
# kernel is gone), so in no row of the kernels line.
FFMA_DEVICE_MS = {(1, 16, 768, 128): 0.1865, (1, 4, 768, 256): 0.2190,
                       (1, 6, 768, 160): 0.3143, (1, 1, 768, 1024): 0.7202,
                       (1, 2, 768, 512): 0.3981, (1, 1, 768, 768): 0.3704,
                       (1, 2, 768, 384): 0.3276, (1, 3, 768, 320): 0.3797,
                       (2, 1, 196, 2048): 0.4057}


def heads_attention(seed: int, widths=HEAD_WIDTHS, shapes=HEAD_SHAPES,
                    phase: str = "heads") -> list:
    """Kernel A at every width of `widths` in both dtypes and every
    (B, H, Nq, Nk) of `shapes`, through the dispatch `attention.sdpa` (whose
    plain version is made to fail for the call): one launch counted at the
    route (`attention.route`) and at the true width; no padding copy at a
    width read in place (`attention.reads_in_place`), whose output is the
    view of a (B, Nq, H, d) buffer of the true width, one elsewhere; the
    output against `attention.reference` (the plain version in f32, in f64
    for the f32 tensor-core route) within `attention.error_bound`; at the
    square shapes the kernel's time (`time_ms`, padding included) and
    device time, the padding's own time (0 where none is made), the plain
    version's and SDPA's times (and what SDPA runs, `sdpa_kernels`) beside
    the bound (4 B H Nq Nk d operations at the route's peak, 3 x as many at
    the TF32 peak on the f32 tensor-core route, whose row also gives the
    FP32 pipe's bound; q, k, v read and o written once)."""
    import torch
    import torch.nn.functional as F

    from monst3r_slam_torch.ops import attention

    fa, plain = attention.fused_attention, attention.sdpa_plain

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA call reached the plain version")

    rng = np.random.default_rng(seed)
    rows = []
    for d in widths:
        for dtype in (torch.bfloat16, torch.float32):
            route, width = attention.route(dtype, d), attention.padded_width(d, dtype)
            in_place, read = attention.reads_in_place(d, dtype), attention.read_width(d, dtype)
            peak = {"bf16_tc": PEAK_BF16, "f32": PEAK_F32, "f32_tc": PEAK_TF32 / 3}[route]
            for b, h, nq, nk in shapes:
                q, k, v = (torch.from_numpy(rng.standard_normal((b, h, n, d), dtype=np.float32))
                           .to("cuda", dtype) for n in (nq, nk, nk))
                before = (fa.launches, fa.route_launches[route], fa.width_launches.get(d, 0),
                          attention.pad_heads.copies)
                attention.sdpa_plain = refuse
                try:
                    out = attention.sdpa(q, k, v)
                finally:
                    attention.sdpa_plain = plain
                torch.cuda.synchronize()
                after = (fa.launches, fa.route_launches[route], fa.width_launches.get(d, 0),
                         attention.pad_heads.copies)
                if [a - c for a, c in zip(after, before)] != [1, 1, 1, int(not in_place)]:
                    fail(f"{phase}: width {d} {route} at {(b, h, nq, nk)} counted {before} -> "
                         f"{after} (launches, on the route, at the width, padding copies; read "
                         f"in place: {in_place})")
                if out.shape != q.shape or out.dtype != dtype:
                    fail(f"{phase}: width {d} {route} gave {tuple(out.shape)} {out.dtype}")
                buf = out.transpose(1, 2)
                if in_place and not (buf.is_contiguous()
                                     and buf.untyped_storage().nbytes() == buf.nbytes):
                    fail(f"{phase}: width {d} {route}: the output is no (B, N, H, d) buffer "
                         f"of the true width: strides {out.stride()}")
                ref = attention.reference(q, k, v)
                err = float((out.double() - ref).abs().max())
                tol = attention.error_bound(q, k, v, ref)
                if not (np.isfinite(err) and err <= tol):
                    fail(f"{phase}: width {d} {route} at {(b, h, nq, nk)}: max abs err {err} > {tol}")
                row = dict(width=d, instantiation=width, in_place=in_place, read_width=read,
                           slices=attention.column_slices(d, dtype),
                           route=route, shape=[b, h, nq, nk], max_abs_err=err, tol=tol)
                if nq == nk:
                    n_bytes = (2 * nq + 2 * nk) * b * h * d * q.element_size()
                    b_ms, b_by = bound_ms(n_bytes, 4.0 * b * h * nq * nk * d / peak)
                    row.update(
                        ms=time_ms(lambda: fa(q, k, v)), device_ms=device_ms(lambda: fa(q, k, v)),
                        pad_ms=(0.0 if in_place
                                else time_ms(lambda: attention.pad_heads(q, k, v, read))),
                        plain_ms=time_ms(lambda: plain(q, k, v)),
                        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                        library_device_ms=device_ms(
                            lambda: F.scaled_dot_product_attention(q, k, v)),
                        library_kernel=sdpa_kernels(q, k, v), bound_ms=b_ms, bound_by=b_by)
                    if route != "bf16_tc":
                        row["split"] = f32_split((b, h, nq, d))
                        row["share"] = f32_share((b, h, nq, d))
                    if route == "f32_tc":
                        row["ffma_bound_ms"] = bound_ms(n_bytes, 4.0 * b * h * nq * nk * d
                                                        / PEAK_F32)[0]
                rows.append(row)
                print(f"{phase} attention d {d} (on {width}, "
                      + ("in place" if in_place else f"padded to {read}")
                      + (f" in {row['slices']} slices" if row["slices"] > 1 else "")
                      + f") {route} {(b, h, nq, nk)}"
                      + (f" split {row['split']}" if "split" in row else "")
                      + (" (slices share S)" if row.get("share") else "")
                      + f": err {err:.3e} <= {tol:.3e}"
                      + (f"; ms: kernel {row['ms']:.4f} (device {row['device_ms']:.4f}, "
                         f"padding {row['pad_ms']:.4f}), plain {row['plain_ms']:.4f}, sdpa "
                         f"{row['library_ms']:.4f} (device {row['library_device_ms']:.4f}; "
                         f"{row['library_kernel']}), bound {row['bound_ms']:.5f} "
                         f"({row['bound_by']})" if "ms" in row else "")
                      + (f"; FFMA bound {row['ffma_bound_ms']:.5f}; the FFMA kernel's device "
                         f"ms before it (PERF.md, not measured here) "
                         f"{FFMA_DEVICE_MS.get((b, h, nq, d))}"
                         if "ffma_bound_ms" in row else ""),
                      flush=True)
    return rows


# One NaN-guard call per route of kernel A: (dtype, head width d, the width
# of the buffers q, k and v are the first d columns of): bf16 on D = 256
# (an atom partly past d, one wholly past it), the bf16 wide variant (its
# last chunk and slice past d), the FFMA kernel on D = 16 and the f32
# tensor-core kernel's 3xTF32 chunks past d.
NAN_GUARD = (("bfloat16", 160, 256), ("bfloat16", 264, 320), ("float32", 12, 16),
             ("float32", 260, 320))


def heads_nan_guard(seed: int) -> list:
    """Kernel A on q, k and v that are the first d columns of buffers whose
    other columns, inside the instantiation's width, hold NaN (`NAN_GUARD`,
    (1, 4, 768, 768)), through `attention.sdpa`: no padding copy, one
    launch, the output finite and within `attention.error_bound` of
    `attention.reference`, so no column past d is read."""
    import torch

    from monst3r_slam_torch.ops import attention

    rng = np.random.default_rng(seed)
    rows = []
    for name, d, wide in NAN_GUARD:
        dtype = getattr(torch, name)
        bufs = [torch.full((1, 4, 768, wide), float("nan"), device="cuda", dtype=dtype)
                for _ in range(3)]
        for t in bufs:
            t[..., :d] = torch.from_numpy(rng.standard_normal((1, 4, 768, d), dtype=np.float32))
        q, k, v = (t[..., :d] for t in bufs)
        before = (attention.pad_heads.copies, attention.fused_attention.launches)
        out = attention.sdpa(q, k, v)
        torch.cuda.synchronize()
        after = (attention.pad_heads.copies, attention.fused_attention.launches)
        ref = attention.reference(q, k, v)
        err = float((out.double() - ref).abs().max())
        tol = attention.error_bound(q, k, v, ref)
        row = dict(dtype=name, width=d, buffer_width=wide, route=attention.route(dtype, d),
                   finite=bool(torch.isfinite(out).all()), max_abs_err=err, tol=tol)
        rows.append(row)
        print(f"heads NaN guard {name} d {d} ({row['route']}, NaN in columns {d}-{wide - 1} of "
              f"the buffers): finite {row['finite']}, err {err:.3e} <= {tol:.3e}", flush=True)
        if after != (before[0], before[1] + 1) or not row["finite"] or not err <= tol:
            fail(f"heads: kernel A read past the head at {name} d {d}: copies and launches "
                 f"{before} -> {after}, finite {row['finite']}, err {err} (tol {tol})")
    return rows


def heads_tile_match(seed: int) -> dict:
    """Kernel B at fd 20, which its wrapper zero-pads to 24, on the 384x512
    pair of `phase_tile_match` drawn with 20 channels: held to the plain
    version under `rounding_check` (every query passes, >= 99.9% exactly
    equal), timed beside the same call at fd 24 and the padding alone."""
    import torch

    from monst3r_slam_torch.ops import matching_pallas
    from monst3r_slam_torch.ops.matching_pallas import pad_descriptors, tile_match_kernel

    args, ti, bounds = tile_match_inputs(seed, fd=20)
    before = tile_match_kernel.launches
    got = tile_match_kernel(*args)
    torch.cuda.synchronize()
    if tile_match_kernel.launches != before + 1:
        fail("heads: kernel B at fd 20 was not counted")
    agree = check_full(args, got, "tile_match fd 20")
    args24 = tile_match_inputs(seed)[0]
    b_ms, b_by = bound_ms(*bounds["full"])
    row = dict(fd=20, runs_at=24, agree=agree, bound_ms=b_ms, bound_by=b_by,
               ms=time_ms(lambda: tile_match_kernel(*args)),
               device_ms=device_ms(lambda: tile_match_kernel(*args)),
               pad_ms=time_ms(lambda: pad_descriptors(args[1], args[3])),
               fd24_ms=time_ms(lambda: tile_match_kernel(*args24)),
               fd24_device_ms=device_ms(lambda: tile_match_kernel(*args24)),
               plain_ms=time_ms(lambda: matching_pallas.tile_match_plain(*args), iters=3))
    print(f"heads tile_match fd 20 (runs at 24): every query passes the rounding check, exactly "
          f"equal {agree:.6f}; ms: kernel {row['ms']:.4f} (device {row['device_ms']:.4f}, padding "
          f"{row['pad_ms']:.4f}), fd 24 {row['fd24_ms']:.4f} (device {row['fd24_device_ms']:.4f}), "
          f"plain {row['plain_ms']:.4f}, bound {b_ms:.5f} ({b_by})", flush=True)
    return row


def heads_train() -> dict:
    """`train_torch.py --tiny --synthetic --steps 3` in-process with its
    default device: every loss finite, kernel A launched through
    `attention.KernelAttention` (whose forward is wrapped to count its
    calls by head width) at TINY's widths 16 and 12, one launch per call."""
    import train_torch
    from monst3r_slam_torch.ops import attention
    from monst3r_slam_torch.train import step as train_step_mod

    losses, calls = [], {}
    step_fn, forward = train_step_mod.train_step, attention.KernelAttention.forward

    def recording_step(*args, **kwargs):
        state, loss = step_fn(*args, **kwargs)
        losses.append(float(loss))
        return state, loss

    def counting_forward(ctx, q, k, v):
        calls[q.shape[-1]] = calls.get(q.shape[-1], 0) + 1
        return forward(ctx, q, k, v)

    save = HEADS_DIR / "tiny_trained.npz"
    save.unlink(missing_ok=True)
    zero_counts()
    train_step_mod.train_step = recording_step
    attention.KernelAttention.forward = staticmethod(counting_forward)
    t0 = time.perf_counter()
    try:
        train_torch.main(["--tiny", "--synthetic", "--steps", "3", "--save", str(save)])
    finally:
        train_step_mod.train_step = step_fn
        attention.KernelAttention.forward = staticmethod(forward)
    secs = time.perf_counter() - t0
    counts, widths = read_counts(), dict(attention.fused_attention.width_launches)
    if not (len(losses) == 3 and np.isfinite(losses).all()):
        fail(f"heads: train_torch.py --tiny losses {losses}")
    if not (calls.get(16) and calls.get(12) and calls == widths
            and counts["fused_attention"] == sum(calls.values()) and save.is_file()):
        fail(f"heads: train_torch.py --tiny: KernelAttention calls by width {calls}, kernel A "
             f"launches by width {widths}, {counts}, saved {save.is_file()}")
    print(f"heads train_torch.py --tiny --synthetic --steps 3 (cuda, in-process): losses "
          f"{losses} in {secs:.1f} s; KernelAttention calls by width {calls}, kernel A launches "
          f"{counts['fused_attention']} by width {widths}", flush=True)
    return dict(losses=losses, seconds=secs, kernel_attention_calls=calls, launches=counts,
                width_launches=widths)


def heads_demo(paths, ckpt) -> dict:
    """`scripts/demo_pair_torch.py` on the TINY checkpoint in-process with
    the model in f32, once on the card (its default) and once with
    `--device cpu`: the decoder's outputs (X, C, D, Q of both views) on the
    card within 1e-3 of their scale of the CPU path's (`phase_reference`'s
    bound), and the card run's kernel launches."""
    import functools
    import runpy

    import torch

    from monst3r_slam_torch.models import mast3r

    encode, decode = mast3r.encode, mast3r.decode
    outs, counts = {}, {}

    def run(device):
        def recording(*args, **kwargs):
            out = decode(*args, **kwargs, dtype=torch.float32)
            outs[device] = out
            return out

        argv = ["scripts/demo_pair_torch.py", "--img1", str(paths[0]), "--img2", str(paths[1]),
                "--checkpoint", str(ckpt), "--out", str(HEADS_DIR / f"demo_f32_{device}")]
        if device == "cpu":
            argv += ["--device", "cpu"]
        old_argv = sys.argv
        mast3r.encode = functools.partial(encode, dtype=torch.float32)
        mast3r.decode = recording
        sys.argv = argv
        zero_counts()
        try:
            runpy.run_path(str(ROOT / argv[0]), run_name="__main__")
        finally:
            sys.argv = old_argv
            mast3r.encode, mast3r.decode = encode, decode
        counts[device] = read_counts()

    run("cuda")
    run("cpu")
    worst = {}
    for name in outs["cpu"]._fields:
        a, b = getattr(outs["cpu"], name), getattr(outs["cuda"], name).cpu()
        worst[name] = float((a - b).abs().max() / a.abs().max())
        if not (np.isfinite(worst[name]) and worst[name] <= 1e-3):
            fail(f"heads: demo_pair_torch.py {name} on the card differs from the CPU path by "
                 f"{worst[name]} of its scale")
    launches = counts["cuda"]
    if not (launches["fused_attention"] and launches["tile_match_kernel"]):
        fail(f"heads: demo_pair_torch.py on the card launched {launches}")
    print(f"heads demo_pair_torch.py on TINY (f32, in-process): card vs CPU outputs within "
          f"{max(worst.values()):.2e} of scale ({', '.join(f'{k} {v:.1e}' for k, v in worst.items())}); "
          f"card launches {launches}", flush=True)
    return dict(rel_err=worst, launches=launches)


def phase_heads(seed: int) -> dict:
    """Kernel A at every head width the reference's kernel takes (1-128),
    one call per route on heads flanked by NaN columns (`heads_nan_guard`)
    and kernel B at a padded descriptor width, then the entry points that
    run the TINY config (heads 16 and 12 wide) with their default device,
    the card: `train_torch.py --tiny --synthetic --steps 3` and
    `demo_pair_torch.py` in-process (f32, against the CPU), and unchanged
    in subprocesses started together after the timings, `scripts/
    run_real_torch.sh --synthetic --max-frames 3` (a trajectory and the ATE
    line), `demo_pair_torch.py` in bf16, and `main_monster_torch.py` and
    `main_easier_torch.py` as README.md runs them on TINY checkpoints (4
    frames, their exports checked)."""
    import dataclasses
    import shutil

    import cv2
    import torch

    from monst3r_slam_torch.models.config import TINY
    from monst3r_slam_torch.models.convert import save_checkpoint
    from monst3r_slam_torch.models.init import init_params

    t0 = time.perf_counter()
    attn_rows = heads_attention(seed)
    nan_guard = heads_nan_guard(seed)
    tm_row = heads_tile_match(seed)

    HEADS_DIR.mkdir(parents=True, exist_ok=True)
    ckpt, monst3r_ckpt = HEADS_DIR / "tiny.pth", HEADS_DIR / "tiny_monst3r.pth"
    save_checkpoint(str(ckpt), init_params(torch.Generator().manual_seed(seed), TINY), TINY)
    tiny_monst3r = dataclasses.replace(TINY, desc_dim=None, two_confs=False)  # DUSt3R layout
    save_checkpoint(str(monst3r_ckpt),
                    init_params(torch.Generator().manual_seed(seed + 1), tiny_monst3r),
                    tiny_monst3r)
    n_frames = 4
    frames_dir = HEADS_DIR / "frames"
    write_frames(frames_dir, dynamic_frames(seed, n_frames))
    pair = [HEADS_DIR / "pair0.png", HEADS_DIR / "pair1.png"]
    for i, p in enumerate(pair):
        cv2.imwrite(str(p), cv2.cvtColor(np.roll(synthetic_rgb(seed), 4 * i, axis=1),
                                         cv2.COLOR_RGB2BGR))
    for name in ("smoke_heads_monster", "smoke_heads_easier", "real_drill_torch"):
        shutil.rmtree(ROOT / "logs" / name, ignore_errors=True)
    shutil.rmtree(ROOT / "build" / "run_real_torch_synth", ignore_errors=True)
    py = sys.executable
    cmds = {
        "run_real_torch.sh": ["bash", "scripts/run_real_torch.sh", "--synthetic", "--max-frames",
                              "3"],
        "demo_pair_torch.py": [py, "scripts/demo_pair_torch.py", "--img1", str(pair[0]), "--img2",
                               str(pair[1]), "--checkpoint", str(ckpt), "--out",
                               str(HEADS_DIR / "demo")],
        "main_monster_torch.py": [py, "main_monster_torch.py", "--dataset", str(frames_dir),
                                  "--checkpoint", str(ckpt), "--monst3r-checkpoint",
                                  str(monst3r_ckpt), "--calib", "config/intrinsics.yaml",
                                  "--raft-checkpoint", "random", "--no-viz", "--max-frames",
                                  str(n_frames), "--save-as", "smoke_heads_monster"],
        "main_easier_torch.py": [py, "main_easier_torch.py", "--dataset", str(frames_dir),
                                 "--checkpoint", str(ckpt), "--easi3r-checkpoint",
                                 str(monst3r_ckpt), "--no-viz", "--max-frames", str(n_frames),
                                 "--save-as", "smoke_heads_easier"],
    }
    t_cli = time.perf_counter()
    logs = {name: HEADS_DIR / f"{name}.log" for name in cmds}
    procs = {}
    try:
        for name, cmd in cmds.items():
            with open(logs[name], "w") as log:
                procs[name] = subprocess.Popen(cmd, cwd=ROOT, stdout=log,
                                               stderr=subprocess.STDOUT)
        train = heads_train()
        demo = heads_demo(pair, ckpt)
        for proc in procs.values():
            proc.wait(timeout=600)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    cli_s = time.perf_counter() - t_cli
    results = {name: (logs[name].read_text(),) for name in cmds}
    for name, (out,) in results.items():
        if procs[name].returncode != 0:
            fail(f"heads: {name} exited {procs[name].returncode}:\n{out[-5000:]}")
    real_out = results["run_real_torch.sh"][0]
    ate = [ln for ln in real_out.splitlines() if ln.startswith("ate_rmse")]
    if "SYNTHETIC smoke: stitching OK" not in real_out or not ate or "(3 matched poses)" not in ate[0]:
        fail(f"heads: run_real_torch.sh --synthetic printed no ATE line:\n{real_out[-2000:]}")
    check_export(ROOT / "logs" / "real_drill_torch", "rgbd_dataset_freiburg1_synth", 3)
    demo_out = results["demo_pair_torch.py"][0]
    counts = [ln for ln in demo_out.splitlines() if ln.startswith("kernel launches")]
    m = np.load(HEADS_DIR / "demo" / "matches.npz")
    if not counts or m["idx_1_to_2"].shape != (1, H * W) or not (HEADS_DIR / "demo" / "pair.ply").is_file():
        fail(f"heads: demo_pair_torch.py wrote {m.files}:\n{demo_out[-2000:]}")
    n_kf = {}
    for name, save_as in (("main_monster_torch.py", "smoke_heads_monster"),
                          ("main_easier_torch.py", "smoke_heads_easier")):
        if "saved results to" not in results[name][0]:
            fail(f"heads: {name} did not export:\n{results[name][0][-2000:]}")
        n_kf[name] = check_export(ROOT / "logs" / save_as, frames_dir.name, n_frames)
    for name, (out,) in results.items():
        tail = [ln for ln in out.splitlines() if ln.startswith(("done:", "ate_rmse", "kernel launches"))]
        print(f"heads {name} (default device, subprocess): exit 0; {'; '.join(tail)}", flush=True)
    secs = time.perf_counter() - t0
    print(f"heads phase: {secs:.1f} s (the subprocesses {cli_s:.1f} s, beside the in-process "
          f"train and demo)", flush=True)
    return dict(attention=attn_rows, nan_guard=nan_guard, tile_match=tm_row, train=train,
                demo=demo,
                launches={name: train["launches"][name] + demo["launches"][name]
                          for name in train["launches"]},
                ate_line=ate[0], keyframes=n_kf, cli_s=cli_s, seconds=secs)


# Kernel B's shapes in the wide phase, each on the 384x512 pair of
# `phase_tile_match` and through the banded variant: (label, crop, fd,
# tile). The first is `PallasTileConfig()`'s own crop, called through
# `matching_pallas.tile_match` with that default; tile 32 at crop 64 is the
# reference's crop sweep (scripts/profile_crop.py:49, :90).
WIDE_TILE_SHAPES = (("crop 64 (PallasTileConfig())", 64, 24, 16), ("crop 48 fd 48", 48, 48, 16),
                    ("crop 48 fd 64", 48, 64, 16), ("crop 48 fd 96", 48, 96, 16),
                    ("crop 48 fd 119", 48, 119, 16), ("tile 32 crop 64", 64, 24, 32),
                    ("crop 50", 50, 24, 16))
# Kernel A above head width 128: (B, H, Nq, Nk) per width, 160 and the
# 4-head decoder's 192 (on the 256-wide instantiations, read in place);
# above 256 in slices of O's columns
# (bf16: the wide variant; f32: the tensor-core kernel) at MAST3R_512's 768
# tokens and the re-headed models' widths (1,024 and 768 at one encoder and
# one decoder head, 512 and 384 at two), at 320 (a slice and a quarter in
# bf16, two of 160 in f32) and at 2,048 (8 slices) at a 224x224 image's 196
# tokens; and the main path's width at batch x heads 65,600, past the
# 65,535 of a grid's y dimension.
WIDE_HEAD_SHAPES = ((256, (1, 4, 768, 768)), (192, (1, 4, 768, 768)), (160, (1, 6, 768, 768)),
                    (1024, (1, 1, 768, 768)), (512, (1, 2, 768, 768)), (768, (1, 1, 768, 768)),
                    (384, (1, 2, 768, 768)), (320, (1, 3, 768, 768)), (2048, (2, 1, 196, 196)),
                    (64, (2, 32800, 8, 8)))
# The matcher's other tilings (`SLAMSystem.match_tcfg`) on the oracle scene.
WIDE_TILINGS = (("crop 64", dict(crop=64)), ("tile 32 crop 64", dict(tile=32, crop=64)))
WIDE_FRAMES = 16
# MAST3R_512 re-headed as a checkpoint's stored constructor string would
# give it, at 4, 2 and 1 encoder and decoder heads: heads 256 / 192, 512 /
# 384 and 1,024 / 768 wide; the oracle SLAM path also at 1 head for
# WIDE_HEAD_FRAMES frames.
WIDE_HEADS = (4, 2, 1)
WIDE_HEAD_FRAMES = 8
# Kernel B on images it reads through a pitched copy: 384x510 (a width that
# is no multiple of 4) and 384x512 starting one element past alignment.
WIDE_PITCHED = (("384x510", 510, 0), ("384x512 at an offset start", 512, 1))


def wide_arch(heads: int) -> str:
    """MAST3R_512's constructor string with `heads` encoder and decoder
    heads."""
    return (f"AsymmetricMASt3R(enc_embed_dim=1024, enc_depth=24, enc_num_heads={heads}, "
            f"dec_embed_dim=768, dec_depth=12, dec_num_heads={heads}, "
            "output_mode='pts3d+desc24', head_type='catmlp+dpt', depth_mode=('exp', -inf, inf), "
            "conf_mode=('exp', 1, inf), desc_conf_mode=('exp', 0, inf), two_confs=True)")


def wide_tile_match(seed: int, card: str) -> list:
    """Kernel B at `WIDE_TILE_SHAPES` on the 384x512 pair, each call through
    the banded variant (counted per variant): the flags and the ray matches
    (the stencil cut) equal to the plain version's, the full output under
    `rounding_check` (every query passes, >= 99.9% exactly equal); back to
    back and device ms, the plain version's ms and the bound."""
    import torch

    from monst3r_slam_torch.ops import matching_pallas as mp

    kern = mp.tile_match_kernel
    rows = []
    for label, crop, fd, tile in WIDE_TILE_SHAPES:
        args, ti, bounds = tile_match_inputs(seed, fd, crop=crop, tile=tile)
        T, tsz = ti.q_rays.shape[:2]
        if label.startswith("crop 64 ("):
            default = mp.PallasTileConfig()
            if (default.crop, default.window) != (crop, args[6]):
                fail(f"wide: PallasTileConfig() is {default}, not crop {crop}, window {args[6]}")

            def call():
                return mp.tile_match(args[0], args[1], args[2], args[3], ti.corners)
        else:
            def call():
                return kern(*args)
        before = dict(kern.variant_launches)
        got = call()
        torch.cuda.synchronize()
        if kern.variant_launches != dict(before, banded=before["banded"] + 1):
            fail(f"wide tile_match {label}: variant launches {before} -> {kern.variant_launches}")
        agree = check_full(args, got, f"wide tile_match {label}")
        ray = mp.tile_match_phase_kernel(*args, phase="stencil")
        torch.cuda.synchronize()
        ray0 = mp.tile_match_plain(*args, phase="stencil")
        if not (all(torch.equal(a, b) for a, b in zip(ray, ray0)) and torch.equal(got[2], ray0[2])):
            fail(f"wide tile_match {label}: the ray matches or flags differ from the plain version")
        u0, v0, _ = mp.tile_match_plain(*args)
        b_ms, b_by = bound_ms(*bounds["full"])
        row = dict(label=label, crop=crop, fd=fd, runs_at=mp.padded_fd(fd), tiles=T, queries=tsz,
                   bands=list(mp.variant(T, tsz, H, W, mp.padded_fd(fd), crop)[1:]),
                   agree=agree, max_abs_err=float(torch.maximum((got[0] - u0).abs().max(),
                                                                (got[1] - v0).abs().max())),
                   ms=time_ms(call), device_ms=device_ms(call),
                   plain_ms=time_ms(lambda: mp.tile_match_plain(*args), iters=2, warmup=1),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None, card=card)
        rows.append(row)
        print(f"wide tile_match {label} ({card}): fd {fd} (runs at {row['runs_at']}), {T} tiles x "
              f"{tsz} queries, banded variant ({row['bands'][0]} / {row['bands'][1]} rows a "
              f"ray / descriptor band); flags and ray matches equal, every query passes the "
              f"rounding check, exactly equal {agree:.6f}; ms: kernel {row['ms']:.4f}, device "
              f"{row['device_ms']:.4f}, plain {row['plain_ms']:.4f}, bound {b_ms:.5f} ({b_by})",
              flush=True)
    return rows


def wide_pitched_tile_match(seed: int, card: str) -> dict:
    """Kernel B through `matching_pallas.tile_match` (the default
    `PallasTileConfig` but crop 48, the main path's) on the images of
    `phase_tile_match`'s pair at `WIDE_PITCHED`: cut to 384x510, and copied
    to start one element past 16-byte alignment. Each call copies its images
    into a pitched buffer (`pitched_launches` counted) and runs the
    whole-crop kernel; the flags and the ray matches (the stencil cut) equal
    the plain version's on the same images and the full output passes
    `rounding_check` (every query, >= 99.9% exactly equal); back to back and
    device ms (the copy included), the plain version's ms and the bound. The
    counters are zeroed just before the two calls and read just after."""
    import torch

    from monst3r_slam_torch.ops import matching_pallas as mp

    args, ti, bounds = tile_match_inputs(seed)
    crop, window, thresh = args[5:]
    tcfg = mp.PallasTileConfig(crop=crop, window=window)
    calls = []
    for label, w, offset in WIDE_PITCHED:
        images = []
        for t in args[:2]:
            t = t[:, :w].contiguous()
            buf = torch.empty(t.numel() + offset, device=t.device, dtype=t.dtype)
            buf[offset:] = t.flatten()
            images.append(buf[offset:].view(t.shape))
        calls.append((label, w, images))
    kern = mp.tile_match_kernel
    zero_counts()
    outs = [mp.tile_match(*images, args[2], args[3], ti.corners, tcfg, thresh)
            for _, _, images in calls]
    torch.cuda.synchronize()
    launches = read_counts()
    if not (launches["tile_match_kernel"] == kern.pitched_launches == len(calls)
            and kern.variant_launches["whole"] == len(calls)):
        fail(f"wide pitched tile_match: launches {launches}, pitched {kern.pitched_launches}, "
             f"variants {kern.variant_launches}")
    rows = []
    for (label, w, images), got in zip(calls, outs):
        kargs = (*images, args[2], args[3], mp.quantize_corners(ti.corners, H, w, crop), crop,
                 window, thresh)
        agree = check_full(kargs, got, f"wide tile_match {label}")
        ray = mp.tile_match_phase_kernel(*kargs, phase="stencil")
        torch.cuda.synchronize()
        ray0 = mp.tile_match_plain(*kargs, phase="stencil")
        if not (all(torch.equal(a, b) for a, b in zip(ray, ray0)) and torch.equal(got[2], ray0[2])):
            fail(f"wide tile_match {label}: the ray matches or flags differ from the plain version")
        u0, v0, _ = mp.tile_match_plain(*kargs)

        def call(images=images, w=w):
            return mp.tile_match(*images, args[2], args[3], ti.corners, tcfg, thresh)

        n_bytes = bounds["full"][0] + sum(t.numel() * t.element_size() for t in images) - sum(
            t.numel() * t.element_size() for t in args[:2])
        b_ms, b_by = bound_ms(n_bytes, bounds["full"][1])
        row = dict(label=label, width=w, offset_elements=int(images[0].storage_offset()),
                   shape=[*got[0].shape, crop], agree=agree,
                   max_abs_err=float(torch.maximum((got[0] - u0).abs().max(),
                                                   (got[1] - v0).abs().max())),
                   ms=time_ms(call), device_ms=device_ms(call),
                   plain_ms=time_ms(lambda: mp.tile_match_plain(*kargs), iters=2, warmup=1),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None, card=card)
        rows.append(row)
        print(f"wide tile_match {label} ({card}): through a pitched copy, the whole-crop "
              f"kernel; flags and ray matches equal, every query passes the rounding check, "
              f"exactly equal {agree:.6f}; ms (copy included): kernel {row['ms']:.4f}, device "
              f"{row['device_ms']:.4f}, plain {row['plain_ms']:.4f}, bound {b_ms:.5f} ({b_by})",
              flush=True)
    return dict(rows=rows, launches=launches)


def wide_decode(seed: int, card: str, heads: int) -> dict:
    """One two-view decode of MAST3R_512 re-headed through
    `config_from_arch_string(wide_arch(heads))` (`heads` encoder and decoder
    heads, 1024 / heads and 768 / heads wide) with random weights from
    `seed` on a 384x512 pair, against the same decode
    with `attention.sdpa_plain` in kernel A's place: in f32 every output
    within 1e-3 of its scale (`phase_reference`'s bound; only the attention
    differs); in bf16 (weights cast as the CLIs cast them) each kernel A
    call's output within `attention.error_bound` of the plain version on its
    own inputs (`recorded_attention_shapes`), and each output no farther
    from the f32 plain decode than twice the bf16 plain decode is. Kernel
    A's launches counted by width; no head padded (every width here is read
    in place)."""
    import dataclasses

    import torch

    from monst3r_slam_torch.models import mast3r
    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.models.convert import (
        cast_params_for_inference, config_from_arch_string,
    )
    from monst3r_slam_torch.models.init import init_params
    from monst3r_slam_torch.ops import attention

    arch = wide_arch(heads)
    cfg = config_from_arch_string(arch)
    if cfg != dataclasses.replace(MAST3R_512, enc_heads=heads, dec_heads=heads):
        fail(f"wide: {arch} parsed to {cfg}")
    want = {cfg.enc_dim // heads, cfg.dec_dim // heads}
    params = init_params(torch.Generator(device="cuda").manual_seed(seed), cfg)
    imgs = torch.from_numpy(np.stack([synthetic_frame(seed, H, W),
                                      synthetic_frame(seed + 1, H, W)])).cuda()
    fa = attention.fused_attention

    def decode(ps, dtype):
        with torch.no_grad():
            f, p = mast3r.encode(ps, cfg, imgs, dtype)
            out = mast3r.decode(ps, cfg, f[:1], p[:1], f[1:], p[1:], (H, W), dtype)
        torch.cuda.synchronize()
        return {name: getattr(out, name).float() for name in out._fields}

    def plain_decode(ps, dtype):
        attention.fused_attention = lambda q, k, v: attention.sdpa_plain(q, k, v)
        try:
            return decode(ps, dtype)
        finally:
            attention.fused_attention = fa

    def rel(a, b):
        return {n: float((a[n] - b[n]).abs().max() / b[n].abs().max()) for n in b}

    runs, ref32 = {}, None
    for dtype, ps in ((torch.float32, params), (torch.bfloat16, cast_params_for_inference(params))):
        name = str(dtype).split(".")[-1]
        shapes = {}
        zero_counts()
        copies = attention.pad_heads.copies
        t0 = time.perf_counter()
        with recorded_attention_shapes(shapes):
            got = decode(ps, dtype)
        secs = time.perf_counter() - t0
        launches, widths = read_counts(), dict(fa.width_launches)
        routes = dict(fa.route_launches)
        copies = attention.pad_heads.copies - copies
        if copies and all(attention.reads_in_place(w, dtype) for w in want):
            fail(f"wide decode {name}: heads {sorted(want)} wide, which kernel A reads in "
                 f"place, were padded {copies} times")
        ref = plain_decode(ps, dtype)
        if not all(bool(torch.isfinite(t).all()) for t in got.values()):
            fail(f"wide decode {name}: non-finite outputs")
        paths = {attention.route(dtype, w) for w in want}
        if not (set(widths) == want and sum(widths.values()) == launches["fused_attention"]
                == sum(routes[r] for r in paths)):
            fail(f"wide decode {name}: kernel A launches {launches} by width {widths}, routes {routes}")
        row = dict(launches=launches, width_launches=widths, seconds=secs, pad_copies=copies,
                   calls={str(list(k)): list(v) for k, v in shapes.items()})
        if dtype == torch.float32:
            ref32 = ref
            row["rel_to_plain"] = rel(got, ref)
            if not all(np.isfinite(e) and e <= 1e-3 for e in row["rel_to_plain"].values()):
                fail(f"wide decode f32: kernel vs plain {row['rel_to_plain']} of scale > 1e-3")
        else:
            row["rel_to_f32"], row["plain_rel_to_f32"] = rel(got, ref32), rel(ref, ref32)
            row["rel_to_plain"] = rel(got, ref)
            worse = {n: (e, row["plain_rel_to_f32"][n]) for n, e in row["rel_to_f32"].items()
                     if not (np.isfinite(e) and e <= 2 * row["plain_rel_to_f32"][n])}
            if worse:
                fail(f"wide decode bf16: farther from the f32 decode than twice the plain bf16 "
                     f"decode (kernel, plain): {worse}")
        runs[name] = row
        print(f"wide decode ({card}) MAST3R_512 re-headed ({cfg.enc_heads} encoder heads "
              f"{cfg.enc_dim // cfg.enc_heads} wide, {cfg.dec_heads} decoder heads "
              f"{cfg.dec_dim // cfg.dec_heads} wide), {H}x{W} pair, {name}: kernel A launches by "
              f"width {widths}, each call shape within error_bound ({len(shapes)} shapes); "
              f"outputs vs the plain-attention decode, largest share of scale "
              f"{max(row['rel_to_plain'].values()):.2e}"
              + (f"; vs the f32 decode {max(row['rel_to_f32'].values()):.2e} (plain bf16: "
                 f"{max(row['plain_rel_to_f32'].values()):.2e})" if "rel_to_f32" in row else "")
              + f"; kernel run {secs:.2f} s", flush=True)
    return runs


def wide_slam(seed: int, card: str) -> list:
    """The oracle scene (`phase_oracle`'s recipe, MAST3R_512 random bf16
    weights, config/base.yaml, the worker waited for after each frame) for
    WIDE_FRAMES frames with the matcher's tiling set to each of
    `WIDE_TILINGS`: once with every kernel B call held to its plain version
    under `rounding_check` (`checked_tile_match`) and once with the plain
    version in its place (`plain_tile_match`). Every kernel B call must take
    the banded variant and pass; both runs track every frame within
    ORACLE_ATE_SHARE of the extent, with the same keyframes and edges and
    poses within ORACLE_POSE_TOL (equal if every query was exact)."""
    import torch

    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.models.convert import cast_params_for_inference
    from monst3r_slam_torch.models.init import init_params
    from monst3r_slam_torch.ops.matching_tiled import TiledConfig

    params = cast_params_for_inference(
        init_params(torch.Generator(device="cuda").manual_seed(seed), MAST3R_512))
    frames = oracle_frames(WIDE_FRAMES)
    rows = []
    for label, kw in WIDE_TILINGS:
        tcfg = TiledConfig(**kw)
        plain = oracle_slam_run(params, frames, "plain", join_worker=True, tcfg=tcfg)
        checked = oracle_slam_run(params, frames, "checked", join_worker=True, tcfg=tcfg)
        checks = np.asarray(checked["checks"], dtype=np.int64).reshape(-1, 4)
        n_calls, n_inexact, n_failing = len(checks), int(checks[:, 2].sum()), int(checks[:, 3].sum())
        n_kernel = checked["launches"]["tile_match_kernel"]
        for r in (plain, checked):
            if not r["finite"] or any(m != "TRACKING" for m in r["modes"]) \
                    or not r["ate"] < ORACLE_ATE_SHARE * r["extent"]:
                fail(f"wide SLAM {label} {r['mode']}: finite {r['finite']}, modes {r['modes']}, "
                     f"ATE {r['ate']} over extent {r['extent']}")
        if not (n_kernel >= 1 and n_calls == n_kernel and checked["variants"]["whole"] == 0
                and checked["variants"]["banded"] == n_kernel
                and plain["launches"]["tile_match_kernel"] == 0):
            fail(f"wide SLAM {label}: {n_calls} checked calls, kernel B launches "
                 f"{checked['launches']} by variant {checked['variants']}; plain run "
                 f"{plain['launches']}")
        gap_by_frame = np.abs(checked["poses"] - plain["poses"]).max(axis=1)
        gap = float(gap_by_frame.max())
        if n_failing or checked["kf_fids"] != plain["kf_fids"] \
                or checked["edges"] != plain["edges"] or not gap <= ORACLE_POSE_TOL \
                or (gap > 0 and not n_inexact):
            fail(f"wide SLAM {label}: {n_failing} queries fail the rounding check, {n_inexact} "
                 f"inexact; keyframes {checked['kf_fids']} / {plain['kf_fids']}, edges "
                 f"{checked['edges']} / {plain['edges']}, largest pose difference {gap}")
        row = dict(label=label, tcfg=kw, frames=WIDE_FRAMES, ate=checked["ate"],
                   plain_ate=plain["ate"], extent=checked["extent"], kf_fids=checked["kf_fids"],
                   edges=checked["edges"], pose_gap=gap, launches=checked["launches"],
                   variants=checked["variants"], routes=checked["routes"],
                   rounding=dict(calls=n_calls, queries=int(checks[:, 1].sum()),
                                 inexact=n_inexact, failing=n_failing),
                   frame_ms_median=float(np.median(checked["wall_ms"][1:])),
                   plain_frame_ms_median=float(np.median(plain["wall_ms"][1:])))
        rows.append(row)
        print(f"wide SLAM ({card}) oracle scene, MAST3R_512 {H}x{W}, {WIDE_FRAMES} frames, "
              f"TiledConfig({', '.join(f'{k}={v}' for k, v in kw.items())}): ATE "
              f"{row['ate']:.6f} over extent {row['extent']:.4f} ({row['ate'] / row['extent']:.4%}; "
              f"plain {row['plain_ate'] / row['extent']:.4%}); keyframes {row['kf_fids']}, edges "
              f"{row['edges']}, equal to the plain run's; largest pose difference {gap:.3e}; kernel "
              f"B {n_calls} calls, all banded, {row['rounding']['queries']} queries, {n_inexact} "
              f"inexact, 0 failing; launches {row['launches']}; frame ms median "
              f"{row['frame_ms_median']:.1f} (plain {row['plain_frame_ms_median']:.1f}, both with "
              f"the worker waited for)", flush=True)
    return rows


def wide_slam_heads(seed: int, card: str) -> dict:
    """The oracle scene (`phase_oracle`'s recipe, config/base.yaml, the
    matcher as shipped, the worker waited for after each frame) for
    WIDE_HEAD_FRAMES frames at MAST3R_512 re-headed to one encoder and one
    decoder head (`wide_arch(1)`: heads 1,024 and 768 wide) with random bf16
    weights from `seed`: every frame must track within ORACLE_ATE_SHARE of
    the extent, and kernel A launch at both widths (counted by width) and
    kernel B on the 384x512 images without a pitched copy."""
    import torch

    from monst3r_slam_torch.models.convert import (
        cast_params_for_inference, config_from_arch_string,
    )
    from monst3r_slam_torch.models.init import init_params

    cfg = config_from_arch_string(wide_arch(1))
    params = cast_params_for_inference(
        init_params(torch.Generator(device="cuda").manual_seed(seed), cfg))
    r = oracle_slam_run(params, oracle_frames(WIDE_HEAD_FRAMES), "kernel", join_worker=True,
                        model_cfg=cfg)
    widths = {cfg.enc_dim, cfg.dec_dim}
    if not r["finite"] or any(m != "TRACKING" for m in r["modes"]) \
            or not r["ate"] < ORACLE_ATE_SHARE * r["extent"]:
        fail(f"wide SLAM at one head: finite {r['finite']}, modes {r['modes']}, ATE {r['ate']} "
             f"over extent {r['extent']}")
    if not (set(r["widths"]) == widths and all(n > 0 for n in r["widths"].values())
            and sum(r["widths"].values()) == r["launches"]["fused_attention"]
            and r["routes"]["bf16_tc"] == r["launches"]["fused_attention"]
            and r["launches"]["tile_match_kernel"] >= 1 and r["pitched"] == 0):
        fail(f"wide SLAM at one head: launches {r['launches']} by width {r['widths']}, routes "
             f"{r['routes']}, pitched kernel B calls {r['pitched']}")
    row = dict(frames=WIDE_HEAD_FRAMES, ate=r["ate"], extent=r["extent"], kf_fids=r["kf_fids"],
               edges=r["edges"], launches=r["launches"], width_launches=r["widths"],
               frame_ms_median=float(np.median(r["wall_ms"][1:])), seconds=r["seconds"])
    print(f"wide SLAM ({card}) oracle scene, MAST3R_512 at one encoder and one decoder head, "
          f"{H}x{W}, {WIDE_HEAD_FRAMES} frames: every frame tracked, ATE {row['ate']:.6f} over "
          f"extent {row['extent']:.4f} ({row['ate'] / row['extent']:.4%}); kernel A launches by "
          f"width {row['width_launches']}; launches {row['launches']}; frame ms median "
          f"{row['frame_ms_median']:.1f} (worker waited for)", flush=True)
    return row


def phase_wide(seed: int, card: str) -> dict:
    """The shapes the reference's kernels take beyond the main path's
    (`--only-wide`): kernel B through its banded variant at
    `WIDE_TILE_SHAPES` (`wide_tile_match`) and through pitched copies at
    `WIDE_PITCHED` (`wide_pitched_tile_match`); kernel A at
    `WIDE_HEAD_SHAPES` in both dtypes (`heads_attention`): heads 256, 192
    and 160 wide, the widths in slices up to 2,048 and batch x heads 65,600;
    the MAST3R_512 decode re-headed to `WIDE_HEADS` (`wide_decode`); the
    oracle SLAM path at the matcher's crop-64 and tile-32 tilings
    (`wide_slam`) and at one head (`wide_slam_heads`). The path's launches
    are the pitched calls', the decodes' and the SLAM runs'."""
    t0 = time.perf_counter()
    tile_rows = wide_tile_match(seed, card)
    pitched = wide_pitched_tile_match(seed, card)
    attn_rows = [row for d, shape in WIDE_HEAD_SHAPES
                 for row in heads_attention(seed, widths=(d,), shapes=(shape,), phase="wide")]
    decode = {heads: wide_decode(seed, card, heads) for heads in WIDE_HEADS}
    slam = wide_slam(seed, card)
    slam_heads = wide_slam_heads(seed, card)
    runs = [r for by_dtype in decode.values() for r in by_dtype.values()] + slam + [slam_heads]
    launches = {name: pitched["launches"][name] + sum(r["launches"][name] for r in runs)
                for name in pitched["launches"]}
    secs = time.perf_counter() - t0
    print(f"wide phase: {secs:.1f} s; launches {launches}", flush=True)
    return dict(tile_match=tile_rows, pitched=pitched, attention=attn_rows, decode=decode,
                slam=slam, slam_heads=slam_heads, launches=launches, seconds=secs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--only-rest", action="store_true",
                    help="build the kernels and run only the phases of the rest of SLAMSystem "
                         "(lm, fusion, decode_sym, state, chunked); prints no result line")
    ap.add_argument("--only-train", action="store_true",
                    help="build the kernels and run only the train phase; prints no result line")
    ap.add_argument("--only-train-mesh", action="store_true",
                    help="build the kernels and run only the train phase's sharded step "
                         "(train_mesh); prints no result line")
    ap.add_argument("--only-mesh", action="store_true",
                    help="build the kernels and run only the mesh phase; prints no result line")
    ap.add_argument("--only-oracle", action="store_true",
                    help="build the kernels and run only the oracle phase; prints no result "
                         "line")
    ap.add_argument("--only-heads", action="store_true",
                    help="build the kernels and run only the heads phase (kernel A at every "
                         "head width, the TINY entry points on the card); prints no result line")
    ap.add_argument("--only-wide", action="store_true",
                    help="build the kernels and run only the wide phase (kernel B's banded "
                         "variant and its pitched calls at 384x510 and an offset start, kernel A "
                         "at heads 160-2,048 wide and batch x heads 65,600, the decodes "
                         "re-headed to 4, 2 and 1 heads, the SLAM path at crop 64, tile 32 and "
                         "one head); prints no result line")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run only on the card")
    try:
        import monst3r_slam_torch  # noqa: F401  (sets TF32 off)
    except ImportError as e:
        fail(f"the port is not importable from here ({e}): run from the repository root")

    t_smoke = time.perf_counter()
    card = phase_card()
    print(f"card: {card}", flush=True)
    phase_build()
    if args.only_rest:
        rest = phase_rest(args.seed, card)
        print(json.dumps({"rest_run": rest}), flush=True)
        print(f"card: {card}; only the rest of SLAMSystem's phases ran", flush=True)
        return 0
    if args.only_heads:
        heads_run = phase_heads(args.seed)
        print(json.dumps({"heads_run": heads_run}), flush=True)
        print(f"card: {card}; only the heads phase ran", flush=True)
        return 0
    if args.only_wide:
        wide_run = phase_wide(args.seed, card)
        print(json.dumps({"wide_run": wide_run}), flush=True)
        print(f"card: {card}; only the wide phase ran", flush=True)
        return 0
    if args.only_mesh:
        mesh_run = phase_mesh(args.seed, card)
        print(json.dumps({"mesh_run": mesh_run}), flush=True)
        print(f"card: {card}; only the mesh phase ran", flush=True)
        return 0
    if args.only_oracle:
        oracle_run = phase_oracle(args.seed, card)
        print(json.dumps({"oracle_run": oracle_run}), flush=True)
        print(f"card: {card}; only the oracle phase ran", flush=True)
        return 0
    if args.only_train_mesh:
        mesh_run = phase_train_mesh(args.seed, card)
        print(json.dumps({"train_mesh_run": mesh_run}), flush=True)
        print(f"card: {card}; only the train phase's sharded step ran", flush=True)
        return 0
    if args.only_train:
        train_run = phase_train(args.seed, card)
        print(json.dumps({"train_run": train_run}), flush=True)
        print(json.dumps({"kernels": [backward_kernel_row(train_run)]}), flush=True)
        print(f"card: {card}; only the train phase ran", flush=True)
        return 0
    phase_s = {"build": round(time.perf_counter() - t_smoke, 1)}  # wall seconds per phase

    def timed(name, phase, *phase_args):
        t0 = time.perf_counter()
        out = phase(*phase_args)
        phase_s[name] = round(time.perf_counter() - t0, 1)
        return out

    attn = timed("attention", phase_attention, args.seed)
    tm = timed("tile_match", phase_tile_match, args.seed)
    tmp = timed("tile_match_phases", phase_tile_match_phases, args.seed)
    heads_run = timed("heads", phase_heads, args.seed)
    wide_run = timed("wide", phase_wide, args.seed, card)
    timed("reference", phase_reference, args.seed)
    launches = timed("slice", phase_slice, args.seed, args.frames)
    main_run = timed("main", phase_main, args.seed)
    raft_ref = timed("raft_reference", phase_raft_reference, args.seed)
    dyn, dual = timed("dynamic", phase_dynamic, args.seed, card)
    sam2_run = timed("sam2", phase_sam2, args.seed, card, dyn, dual)
    easi3r_run = timed("easi3r", phase_easi3r, args.seed, card, dual)
    viewer_run = timed("viewer", phase_viewer, args.seed, card)
    rest = timed("rest", phase_rest, args.seed, card)
    mesh_run = timed("mesh", phase_mesh, args.seed, card)
    oracle_run = timed("oracle", phase_oracle, args.seed, card)
    train_run = timed("train", phase_train, args.seed, card)
    by_path = {name: dict(slice=launches[name], main=main_run["launches"][name],
                          dynamic=dyn["launches"][name] + dyn["split"]["launches"][name],
                          sam2=sam2_run["launches"][name],
                          easi3r=easi3r_run["launches"][name]
                          + easi3r_run["split_launches"][name],
                          viewer=viewer_run["launches"][name],
                          lm=rest["lm"]["launches"][name],
                          chunked=sum(r["launches"][name] for r in rest["chunked"].values()),
                          mesh=mesh_run["launches"][name], oracle=oracle_run["launches"][name],
                          train=train_run["launches"][name],
                          train_mesh=train_run["mesh"]["launches"][name],
                          heads=heads_run["launches"][name], wide=wide_run["launches"][name])
               for name in launches}
    total = {name: sum(paths.values()) for name, paths in by_path.items()}

    enc = attn["bf16_tc", "encoder"]
    full = tmp["phases"]["full"]
    wide256 = next(r for r in wide_run["attention"] if r["width"] == 256 and r["route"] == "bf16_tc")
    wide1024 = next(r for r in wide_run["attention"]
                    if r["width"] == 1024 and r["route"] == "bf16_tc")
    tc256 = next(r for r in wide_run["attention"] if r["width"] == 256 and r["route"] == "f32_tc")
    tc_rows = [r for r in heads_run["attention"] + wide_run["attention"] if r["route"] == "f32_tc"]
    banded64 = wide_run["tile_match"][0]
    pitched510 = wide_run["pitched"]["rows"][0]
    # Kernel A's launches on the wide path by width: the decodes' (per
    # heads and dtype) and the one-head SLAM run's (bf16).
    wide_widths = {f"decode {heads} heads {name}": r["width_launches"]
                   for heads, by_dtype in wide_run["decode"].items()
                   for name, r in by_dtype.items()}
    wide_widths["slam 1 head bfloat16"] = wide_run["slam_heads"]["width_launches"]

    def wide_launches(lo, hi, dtype):
        return {path: sum(n for d, n in widths.items() if lo < d <= hi)
                for path, widths in wide_widths.items() if path.endswith(dtype)}
    kernels = [
        dict(name="attention", route="cuda", source="monst3r_slam_torch/csrc/attention.cu",
             replaces="monst3r_slam_tpu/ops/attention.py:43",
             launches=total["fused_attention"], launches_by_path=by_path["fused_attention"],
             max_abs_err=enc["max_abs_err"],
             ms=enc["ms"], plain_ms=enc["plain_ms"], bound_ms=enc["bound_ms"],
             bound_by=enc["bound_by"], library_ms=enc["library_ms"], shape=enc["shape"],
             tol=enc["tol"], device_ms=enc["device_ms"],
             library_device_ms=enc["library_device_ms"],
             kernel="attn_fwd_bf16_tc (wgmma, TMA)",
             decoder_shape=attn["bf16_tc", "decoder"],
             f32_route=dict(
                 kernel="attn_fwd_f32 (register-tiled FP32 FFMA, cp.async three-stage K/V ring, "
                        "key tiles split over a cluster, merged through distributed shared memory)",
                 encoder=attn["f32", "encoder"], decoder=attn["f32", "decoder"],
                 train_shapes=[attn["f32", f"train {shape}"] for shape in F32_TRAIN_SHAPES],
                 launches_by_path=dict(train_mesh=sum(row["f32"]["route_launches"]
                                                      for row in train_run["mesh"]["rows"]))),
             backward="bf16 heads up to 64 columns: attn_bwd_prep, attn_bwd_dkdv, attn_bwd_dq "
                      "(csrc/attention_bwd.cu; the reference has no backward kernel); f32 and "
                      "other widths: plain PyTorch, attention.sdpa_backward_plain",
             gradient=train_run["gradient"],
             widths=dict(
                 checked=list(HEAD_WIDTHS) + [d for d, _ in WIDE_HEAD_SHAPES],
                 instantiations=[16, 32, 64, 128, 256], wide_variant="every width above 256",
                 read_in_place="bf16 multiples of 8, f32 multiples of 4 (attention."
                               "reads_in_place); other widths zero-padded to the next one",
                 nan_guard=heads_run["nan_guard"],
                 rows=heads_run["attention"] + wide_run["attention"],
                 launches_by_width=dict(train=heads_run["train"]["width_launches"],
                                        wide=wide_widths))),
        backward_kernel_row(train_run),
        dict(name="tile_match", route="cuda", source="monst3r_slam_torch/csrc/tile_match.cu",
             replaces="monst3r_slam_tpu/ops/matching_pallas.py:213",
             launches=total["tile_match_kernel"], launches_by_path=by_path["tile_match_kernel"],
             max_abs_err=tm["max_abs_err"],
             ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=tm["bound_ms"],
             bound_by=tm["bound_by"], library_ms=None, shape=tm["shape"],
             device_ms=tm["device_ms"], agree=tm["agree"],
             kernel="tile_match_kernel<24, full> (mma.sync, cp.async.bulk, persistent)",
             padded_fd20=heads_run["tile_match"]),
        dict(name="tile_match_phases", route="cuda", source="monst3r_slam_torch/csrc/tile_match.cu",
             replaces="scripts/profile_pallas_phases.py:107",
             launches=tmp["launches"], max_abs_err=tmp["max_abs_err"],
             launches_by_path=dict(phase_profiler=tmp["launches"],
                                   sam2=sam2_run["launches"]["tile_match_phase_kernel"],
                                   lm=rest["lm"]["launches"]["tile_match_phase_kernel"],
                                   chunked=sum(r["launches"]["tile_match_phase_kernel"]
                                               for r in rest["chunked"].values()),
                                   mesh=mesh_run["launches"]["tile_match_phase_kernel"],
                                   oracle=oracle_run["launches"]["tile_match_phase_kernel"]),
             ms=full["ms"], plain_ms=full["plain_ms"], bound_ms=full["bound_ms"],
             bound_by=full["bound_by"], library_ms=None, shape=tmp["shape"],
             device_ms=full["device_ms"], phases=tmp["phases"]),
        dict(name="attention_d256", route="cuda", source="monst3r_slam_torch/csrc/attention.cu",
             replaces="monst3r_slam_tpu/ops/attention.py:43",
             launches=sum(wide_launches(128, 256, "bfloat16").values()),
             launches_by_path=dict(wide=wide_launches(128, 256, "bfloat16")),
             kernel="attn_fwd_bf16_tc<256> (one stage a warpgroup); bf16 widths 136-248 "
                    "that are multiples of 8 read in place (TMA boxes zero past d, atoms wholly "
                    "past d skipped), others zero-padded to the next multiple of 8",
             **{k: wide256[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms", "shape", "tol", "device_ms",
                                        "library_device_ms")},
             rows=wide_run["attention"]),
        dict(name="tile_match_banded", route="cuda", source="monst3r_slam_torch/csrc/tile_match.cu",
             replaces="monst3r_slam_tpu/ops/matching_pallas.py:213",
             launches=sum(r["variants"]["banded"] for r in wide_run["slam"]),
             launches_by_path=dict(wide={r["label"]: r["variants"]["banded"]
                                         for r in wide_run["slam"]}),
             kernel="tile_match_banded<FD, PHASE> (crop rows in bands through two bulk-copy "
                    "rings, groups of 256 queries), FD 16-128",
             **{k: banded64[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "device_ms", "agree")},
             shape=[banded64["tiles"], banded64["queries"], banded64["crop"]],
             rows=wide_run["tile_match"]),
        dict(name="attention_wide", route="cuda", source="monst3r_slam_torch/csrc/attention.cu",
             replaces="monst3r_slam_tpu/ops/attention.py:43",
             launches=sum(wide_launches(256, float("inf"), "bfloat16").values()),
             launches_by_path=dict(wide=wide_launches(256, float("inf"), "bfloat16")),
             kernel="attn_fwd_bf16_wide (wgmma, TMA: QK^T over 64-column chunks of d, O in "
                    "256-column slices, one a CTA); bf16 widths above 256 that are multiples "
                    "of 8 read in place (the last chunk's TMA boxes zero past d), others "
                    "zero-padded to the next multiple of 8",
             **{k: wide1024[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "shape", "tol", "device_ms",
                                         "library_device_ms", "library_kernel")},
             rows=[r for r in wide_run["attention"] if r["route"] == "bf16_tc"
                   and (r["width"] > 256 or r["shape"][0] * r["shape"][1] > 65535)]),
        dict(name="attention_f32_tc", route="cuda", source="monst3r_slam_torch/csrc/attention.cu",
             replaces="monst3r_slam_tpu/ops/attention.py:43",
             launches=sum(wide_launches(64, float("inf"), "float32").values()),
             launches_by_path=dict(wide=wide_launches(64, float("inf"), "float32")),
             kernel="attn_fwd_tf32<D, QRES> (f32 heads above 64 columns: mma.sync m16n8k8 "
                    "in 3xTF32, operands split in registers, P kept in registers, Q resident "
                    "up to 256 columns, a cp.async ring of K chunks and V steps, O in slices "
                    "of up to 256 columns that share S through distributed shared memory "
                    "where the plan takes it, key tiles split over a cluster); read in place "
                    "at every multiple of 4",
             **{k: tc256[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms", "shape", "tol", "device_ms",
                                      "library_device_ms", "library_kernel", "ffma_bound_ms",
                                      "split", "share")},
             max_abs_err_all=max(r["max_abs_err"] for r in tc_rows), rows=tc_rows),
        dict(name="tile_match_pitched", route="cuda",
             source="monst3r_slam_torch/csrc/tile_match.cu",
             replaces="monst3r_slam_tpu/ops/matching_pallas.py:213",
             launches=wide_run["pitched"]["launches"]["tile_match_kernel"],
             launches_by_path=dict(wide=wide_run["pitched"]["launches"]["tile_match_kernel"]),
             kernel="tile_match_kernel<24, full> on images copied to a row pitch "
                    "(matching_pallas.pad_pitch)",
             **{k: pitched510[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms", "device_ms", "agree",
                                           "shape")},
             rows=wide_run["pitched"]["rows"]),
    ]
    print(json.dumps({"main_tracked_run": main_run}), flush=True)
    print(json.dumps({"dynamic_run": dyn, "raft_reference": raft_ref}), flush=True)
    print(json.dumps({"sam2_run": sam2_run}), flush=True)
    print(json.dumps({"easi3r_run": easi3r_run, "viewer_run": viewer_run}), flush=True)
    print(json.dumps({"rest_run": rest}), flush=True)
    print(json.dumps({"mesh_run": mesh_run}), flush=True)
    print(json.dumps({"oracle_run": oracle_run}), flush=True)
    print(json.dumps({"train_run": train_run}), flush=True)
    print(json.dumps({"heads_run": {k: v for k, v in heads_run.items() if k != "attention"}}),
          flush=True)
    print(json.dumps({"wide_run": {k: v for k, v in wide_run.items()
                                   if k not in ("attention", "tile_match", "pitched")}}),
          flush=True)
    phase_s["total"] = round(time.perf_counter() - t_smoke, 1)
    print(f"smoke wall seconds by phase: {phase_s}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
