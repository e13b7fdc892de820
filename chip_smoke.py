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
     after; every attention launch must take the bf16 tensor-core route.

Random weights carry no geometry: two views of one scene, even one shifted
by a pixel, decode to pointmaps that do not match, and every frame would be
lost to relocalization. So the two decoder streams and the two heads share
one random draw and every frame is the same synthetic image: each pair then
decodes to equal pointmaps, and the confidence gates, calibrated for trained
weights, are opened. Matching then finds a share of the pixels, and
tracking, the keyframe event and the global solve run as they do on a real
sequence.

Then one JSON line with the kernel table and, last, the `{"ok": true, ...}`
line. Exits non-zero without that line when there is no CUDA device, when
the port is not importable, or when any phase fails.
"""

from __future__ import annotations

import argparse
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
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
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
    from monst3r_slam_torch.models.convert import cast_params_for_inference
    from monst3r_slam_torch.models.init import init_params
    from monst3r_slam_torch.ops.attention import fused_attention
    from monst3r_slam_torch.ops.matching_pallas import tile_match_kernel

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(gen, MAST3R_512)
    # One random draw for both decoder streams and both heads, so that a
    # pair of equal views decodes to equal pointmaps (see the module notes).
    params["dec_blocks2"], params["head2"] = params["dec_blocks"], params["head1"]
    params = cast_params_for_inference(params)
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

    enc = attn["bf16_tc", "encoder"]
    full = tmp["phases"]["full"]
    kernels = [
        dict(name="attention", route="cuda", source="monst3r_slam_torch/csrc/attention.cu",
             replaces="monst3r_slam_tpu/ops/attention.py:43",
             launches=launches["fused_attention"], max_abs_err=enc["max_abs_err"],
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
             launches=launches["tile_match_kernel"], max_abs_err=tm["max_abs_err"],
             ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=tm["bound_ms"],
             bound_by=tm["bound_by"], library_ms=None, shape=tm["shape"],
             device_ms=tm["device_ms"], agree=tm["agree"],
             kernel="tile_match_kernel<24, full> (mma.sync, cp.async.bulk, persistent)"),
        dict(name="tile_match_phases", route="cuda", source="monst3r_slam_torch/csrc/tile_match.cu",
             replaces="scripts/profile_pallas_phases.py:107",
             launches=tmp["launches"], max_abs_err=tmp["max_abs_err"],
             ms=full["ms"], plain_ms=full["plain_ms"], bound_ms=full["bound_ms"],
             bound_by=full["bound_by"], library_ms=None, shape=tmp["shape"],
             device_ms=full["device_ms"], phases=tmp["phases"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
