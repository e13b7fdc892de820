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
     staging and that its full instantiation runs on the tensor cores;
  2. kernel A (attention) against its plain version at the encoder
     (1, 16, 768, 64) and decoder (1, 12, 768, 64) shapes, on both routes:
     the bf16 tensor-core kernel (the main path's) and the f32 CUDA-core
     kernel, with the kernel's, the plain version's and
     scaled_dot_product_attention's times (`time_ms`: calls back to back,
     what a host-bound caller sees), and the kernel's and SDPA's device
     times (`device_ms`);
  3. kernel B (tile matcher) against its plain version on one 384x512 pair
     from `--seed`, placed by the matcher's own tile and corner pipeline,
     under `matching_pallas.rounding_check` (the descriptor step sums on the
     tensor cores), with the share of queries exactly equal; then the phase
     split of kernel B on the same input (the counterpart of the TPU
     profiler `scripts/profile_pallas_phases.py`): each of the four
     instantiations (stage, ray, stencil, full) against its plain version,
     then the four timed (`ms` and `device_ms`), with the phase counter
     zeroed just before and read just after;
  4. the model and the matcher on the card against the port's plain CPU
     path on a small pair (MAST3R_512 widths, cut depth, f32);
  5. the main path: the port's synchronous SLAMSystem at MAST3R_512 full
     width with random bf16 weights from `--seed`, on `--frames` 384x512
     frames, one of them forced to be a keyframe so that a keyframe event
     decodes and matches the new graph edge and runs the global
     Gauss-Newton. The launch counters are zeroed just before and read just
     after; every attention launch must take the bf16 tensor-core route;
  6. the main path as `main.py` runs it by default, through the port's
     entry point `main_torch.py` with config/base.yaml: the backend on its
     worker thread with the f64 host solve, tracking decisions two frames
     late, retrieval on a k-means-bootstrapped codebook, relocalization and
     the export (`phase_main`): once as the CLI in a subprocess, unchanged,
     and once through its loop `main_torch.run` with the tied weights on
     repeated frames with one frame of noise, which must track, solve a
     keyframe event on the worker, lose the noise frame and relocalize.
     Frames and the CLI's outputs go under build/smoke_main/ and logs/;
  7. RAFT on the card against the port's CPU path on a small pair (full
     widths, 3 iterations, f32), and `raft_flow` timed at 384x512 and 20
     iterations (`phase_raft_reference`);
  8. the dynamic pipeline as `main_monster_slam.py` runs it, through the
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
  9. SAM2 mask refinement on the dynamic path (`phase_sam2`): Hiera-B+
     (SAM2_BASE_PLUS, 1024x1024) and the video predictor (VIDEO_BASE_PLUS)
     on the card against the port's CPU path, `sam2_encode` and a video
     step timed; `main_monster_torch.py` unchanged in a subprocess with
     `--sam2-checkpoint random`, once with the image refiner and once with
     the video predictor; and `main_monster_torch.run` in-process at the
     dynamic phase's full width with the SAM2_BASE_PLUS image refiner
     (random weights), which must be called on every masked frame while
     both kernels launch, and its host-refinement stage beside the native
     refiner's.

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

Then one JSON line with the kernel table (each kernel's launches on every
path, `sam2` included) and, last, the `{"ok": true, ...}` line. Exits
non-zero without that line when there is no CUDA device, when the port is
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
# float32 on the CUDA cores, HBM3 bandwidth.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
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


def kernel_instructions(lib: str, fd: int = 24) -> dict:
    """{phase: (bulk copies, tensor-core mma)} in the SASS of kernel B's
    phase instantiations for `fd` channels: a cut phase whose staging the
    compiler dropped would show no copy, and a full instantiation off the
    tensor cores no HMMA."""
    from monst3r_slam_torch.ops import build
    from monst3r_slam_torch.ops.matching_pallas import PHASES

    tool = pathlib.Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", lib], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, cur = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            cur = next((ph for i, ph in enumerate(PHASES)
                        if f"tile_match_kernelILi{fd}ELi{i}E" in ln), None)
            if cur is not None:
                counts[cur] = [0, 0]
        elif cur is not None:
            counts[cur][0] += any(op in ln for op in COPY_OPS)
            counts[cur][1] += "HMMA" in ln
    return {ph: tuple(c) for ph, c in counts.items()}


def phase_build() -> None:
    from monst3r_slam_torch.ops import build
    from monst3r_slam_torch.ops.matching_pallas import PHASES

    t0 = time.perf_counter()
    logs = build.build(force=True)
    secs = time.perf_counter() - t0
    usage = []
    for name, log in logs.items():
        regs = [ln.split("info    :")[-1].strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
        usage.append(f"{name}: " + "; ".join(regs))
    print(f"build: {sorted(logs)} in {secs:.1f} s (one nvcc per source, in parallel) | "
          + " | ".join(usage), flush=True)
    ins = kernel_instructions(str(build.lib_path("tile_match")))
    if (sorted(ins) != sorted(PHASES) or not all(cp > 0 for cp, _ in ins.values())
            or ins["full"][1] == 0):
        fail(f"kernel B's phase instantiations lost their bulk-copy staging ({'/'.join(COPY_OPS)} "
             f"in SASS) or its full instantiation its tensor-core mma (HMMA): {ins}")
    print(f"tile_match phase instantiations keep their bulk-copy staging ({'/'.join(COPY_OPS)}) "
          "and the full one runs on the tensor cores (HMMA), per phase copies/HMMA: "
          + ", ".join(f"{ph} {cp}/{mma}" for ph, (cp, mma) in ins.items()), flush=True)


def phase_attention(seed: int) -> dict:
    """Kernel A on both routes against the plain version computed in f32
    from the same inputs, within `attention.error_bound` (bf16 tensor-core
    route: from its two bf16 roundings, of the probabilities and of the
    output; f32 CUDA-core route: 2e-5)."""
    import torch
    import torch.nn.functional as F

    from monst3r_slam_torch.ops import attention

    rng = np.random.default_rng(seed)
    rows = {}
    for route, dtype, peak in (("bf16_tc", torch.bfloat16, PEAK_BF16),
                               ("f32", torch.float32, PEAK_F32)):
        for name, heads in (("encoder", 16), ("decoder", 12)):
            q, k, v = (
                torch.from_numpy(rng.standard_normal((1, heads, 768, 64), dtype=np.float32))
                .to("cuda").to(dtype)
                for _ in range(3)
            )
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
            flops = 4.0 * heads * 768 * 768 * 64  # QK^T and PV
            b_ms, b_by = bound_ms(n_bytes, flops / peak)
            rows[route, name] = dict(
                shape=[1, heads, 768, 64], dtype=str(dtype).split(".")[-1], max_abs_err=err,
                tol=tol, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                device_ms=dev, library_device_ms=lib_dev)
            print(f"attention {route} {name} (1,{heads},768,64) {rows[route, name]['dtype']}: "
                  f"err {err:.3e} <= {tol:.3e}; ms: kernel {ms:.4f}, plain {plain:.4f}, "
                  f"sdpa {lib:.4f}, bound {b_ms:.5f} ({b_by}); device ms: kernel {dev:.4f}, "
                  f"sdpa {lib_dev:.4f}", flush=True)
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


def tile_match_inputs(seed: int):
    """Kernel B's arguments on the 384x512 pair from `seed`, placed by the
    matcher's own tile and corner pipeline, with what bounds the call."""
    import torch

    from monst3r_slam_torch.ops import matching, matching_tiled
    from monst3r_slam_torch.ops.matching_pallas import quantize_corners

    X11, X21, D11, D21 = (torch.from_numpy(a).to("cuda")
                          for a in synthetic_pointmap_pair(seed))
    mcfg = matching.MatchingConfig()
    ti = matching_tiled.tile_inputs(X11, X21, D21, None, matching_tiled.TiledConfig())
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
    u, v, conv = tile_match_kernel(*args)
    torch.cuda.synchronize()
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
    path's crop of 48 (at the TPU profiler's crop of 64 the crops' slots do
    not fit a block's shared memory). Stage, ray and stencil must equal their
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
    with `sync_stages` (the device synchronized at every stage boundary) and
    no keyframe event, the launch counters zeroed just before and read just
    after: per-frame wall ms by stage, and the launches per tracked frame."""
    import torch

    from monst3r_slam_torch.ops.attention import fused_attention
    from monst3r_slam_torch.ops.matching_pallas import tile_match_kernel

    slam.finalize()
    slam.sync_stages = True
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
    stages = {k: float(np.median(v)) for k, v in slam.prof.items()
              if k in ("encode_dispatch", "decode_monst3r", "flow_program", "decode_mast3r",
                       "mask_refine", "track_dispatch", "resolve_prev", "mask_share")}
    slam.sync_stages = False
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
    print(f"dynamic stage split ({card}), 4 tracked frames with the device synchronized at "
          f"each stage: wall ms {[round(t, 1) for t in split['wall_ms']]}; stage medians (ms) "
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
          f"synchronized split)", flush=True)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run only on the card")
    try:
        import monst3r_slam_torch  # noqa: F401  (sets TF32 off)
    except ImportError as e:
        fail(f"the port is not importable from here ({e}): run from the repository root")

    card = phase_card()
    print(f"card: {card}", flush=True)
    phase_build()
    attn = phase_attention(args.seed)
    tm = phase_tile_match(args.seed)
    tmp = phase_tile_match_phases(args.seed)
    phase_reference(args.seed)
    launches = phase_slice(args.seed, args.frames)
    main_run = phase_main(args.seed)
    raft_ref = phase_raft_reference(args.seed)
    dyn, dual = phase_dynamic(args.seed, card)
    sam2_run = phase_sam2(args.seed, card, dyn, dual)
    by_path = {name: dict(slice=launches[name], main=main_run["launches"][name],
                          dynamic=dyn["launches"][name] + dyn["split"]["launches"][name],
                          sam2=sam2_run["launches"][name])
               for name in launches}
    total = {name: sum(paths.values()) for name, paths in by_path.items()}

    enc = attn["bf16_tc", "encoder"]
    full = tmp["phases"]["full"]
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
             f32_route=dict(kernel="attn_fwd_f32 (CUDA cores)", encoder=attn["f32", "encoder"],
                            decoder=attn["f32", "decoder"])),
        dict(name="tile_match", route="cuda", source="monst3r_slam_torch/csrc/tile_match.cu",
             replaces="monst3r_slam_tpu/ops/matching_pallas.py:213",
             launches=total["tile_match_kernel"], launches_by_path=by_path["tile_match_kernel"],
             max_abs_err=tm["max_abs_err"],
             ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=tm["bound_ms"],
             bound_by=tm["bound_by"], library_ms=None, shape=tm["shape"],
             device_ms=tm["device_ms"], agree=tm["agree"],
             kernel="tile_match_kernel<24, full> (mma.sync, cp.async.bulk, persistent)"),
        dict(name="tile_match_phases", route="cuda", source="monst3r_slam_torch/csrc/tile_match.cu",
             replaces="scripts/profile_pallas_phases.py:107",
             launches=tmp["launches"], max_abs_err=tmp["max_abs_err"],
             launches_by_path=dict(phase_profiler=tmp["launches"],
                                   sam2=sam2_run["launches"]["tile_match_phase_kernel"]),
             ms=full["ms"], plain_ms=full["plain_ms"], bound_ms=full["bound_ms"],
             bound_by=full["bound_by"], library_ms=None, shape=tmp["shape"],
             device_ms=full["device_ms"], phases=tmp["phases"]),
    ]
    print(json.dumps({"main_tracked_run": main_run}), flush=True)
    print(json.dumps({"dynamic_run": dyn, "raft_reference": raft_ref}), flush=True)
    print(json.dumps({"sam2_run": sam2_run}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
