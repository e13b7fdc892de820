#!/usr/bin/env python3
"""Kernel A's f32 route on the card: its time at every split, and the FP32
pipe's ceiling for the FMA patterns it issues.

The route splits each 128-query block's key tiles among the CTAs of a
cluster and picks that split per call (`f32_split` in
`monst3r_slam_torch/csrc/attention.cu`). This builds the kernel library once
per split 1-8 with the split fixed (`-DF32_SPLIT=g`) and, at the encoder and
decoder shapes and at `chip_smoke.F32_TRAIN_SHAPES`, prints each build's
device time (`chip_smoke.device_ms`) beside the split the shipped library
chooses and its time, so the choice can be checked against the measured best,
and how many clusters of each size the card holds at once (what the choice
reads).

It also times two FMA-only kernels over the whole card, 16 warps an SM: 16
independent FMA chains a thread (one fresh register operand an FMA), and the
8x8 outer product from registers that the route's P V product issues (two
fresh operands an FMA), in TFLOP/s against the 67 TFLOP/s peak.

    python3 scripts/profile_f32_attention.py [--seed 0]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "profile_f32"
SPLITS = range(1, 9)

FMA_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void chains(float* out, int iters, float a, float b) {
  float acc[16];
  for (int i = 0; i < 16; ++i) acc[i] = threadIdx.x * 1e-3f + i;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = fmaf(acc[i], a, b);
  float s = 0.f;
  for (int i = 0; i < 16; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void outer8x8(float* out, int iters, const float* __restrict__ in) {
  float p[8], w[8], acc[64];
  for (int i = 0; i < 8; ++i) { p[i] = in[i]; w[i] = in[8 + i]; }
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int x = 0; x < 8; ++x)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[8 * x + c] = fmaf(p[x], w[c], acc[8 * x + c]);
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] *= 0.999f;
  }
  float s = 0.f;
  for (int i = 0; i < 64; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int which, int blocks, int iters, float* out, const float* in, cudaStream_t st) {
  if (which == 0) chains<<<blocks, 256, 0, st>>>(out, iters, 0.999f, 1e-3f);
  else outer8x8<<<blocks, 256, 0, st>>>(out, iters, in);
  return (int)cudaGetLastError();
}
"""


def build_split_libraries() -> dict:
    from monst3r_slam_torch.ops import build

    OUT.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "attention.cu"
    procs = {g: subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, f"-DF32_SPLIT={g}", "-o",
                                  str(OUT / f"libattention_split{g}.so"), str(src)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for g in SPLITS}
    libs = {}
    for g, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"split {g} build failed:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"libattention_split{g}.so"))
        lib.attn_forward.argtypes = [ctypes.c_char_p]
        lib.attn_forward.restype = ctypes.c_int
        libs[g] = lib
    return libs


def launch(lib, q, k, v):
    """`attention.fused_attention`'s launch through another build of the library."""
    import torch

    from monst3r_slam_torch.ops import attention

    b, h, nq, d = q.shape
    out = torch.empty_strided((b, h, nq, d), (nq * h * d, d, h * d, 1), dtype=q.dtype,
                              device=q.device)
    args = attention._PACK(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *q.stride(),
                           *k.stride(), *v.stride(), *out.stride(), b, h, nq, k.shape[2], d, 0,
                           torch.cuda.current_stream().cuda_stream)
    err = lib.attn_forward(args)
    if err != 0:
        raise RuntimeError(f"attention launch failed: error {err}")
    return out


def fma_ceilings() -> dict:
    import torch

    from monst3r_slam_torch.ops import build

    so = OUT / "libfma.so"
    src = OUT / "fma.cu"
    src.write_text(FMA_SOURCE)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    lib.run.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 2 * sms, 4096
    out = torch.empty(blocks * 256, device="cuda")
    inp = torch.rand(16, device="cuda")
    rows = {}
    for which, name, fmas in ((0, "independent chains", 16), (1, "8x8 outer product", 64)):
        def call():
            if lib.run(which, blocks, iters, out.data_ptr(), inp.data_ptr(),
                       torch.cuda.current_stream().cuda_stream) != 0:
                raise RuntimeError("FMA kernel launch failed")
        call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            call()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 5
        rows[name] = 2.0 * fmas * iters * blocks * 256 / ms / 1e9
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the kernels run only on the card", file=sys.stderr)
        return 1
    import chip_smoke

    card = chip_smoke.phase_card()
    print(f"card: {card}", flush=True)
    from monst3r_slam_torch.ops import attention, build

    libs = build_split_libraries()
    shipped_lib = build.load("attention", attention._SIGNATURES)
    shipped_lib.attn_f32_clusters.argtypes = [ctypes.c_int]
    shipped_lib.attn_f32_clusters.restype = ctypes.c_int
    result_clusters = {g: shipped_lib.attn_f32_clusters(g) for g in SPLITS}
    print("clusters the card holds at once, by split: " + ", ".join(
        f"{g}: {n}" for g, n in result_clusters.items()), flush=True)
    rng = np.random.default_rng(args.seed)
    shapes = [(1, 16, 768, 64), (1, 12, 768, 64), *chip_smoke.F32_TRAIN_SHAPES]
    result = dict(card=card, clusters=result_clusters, shapes=[])
    for shape in shapes:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda")
                   for _ in range(3))
        ref = attention.sdpa_plain(q, k, v)
        by_split = {}
        for g, lib in libs.items():
            err = float((launch(lib, q, k, v) - ref).abs().max())
            if not err <= attention.error_bound(q, k, v, ref):
                raise RuntimeError(f"split {g} at {shape}: max abs err {err}")
            by_split[g] = chip_smoke.device_ms(lambda: launch(lib, q, k, v), iters=50)
        chosen = chip_smoke.f32_split(shape)
        shipped = chip_smoke.device_ms(lambda: attention.fused_attention(q, k, v), iters=50)
        best = min(by_split, key=by_split.get)
        result["shapes"].append(dict(shape=list(shape), device_ms=by_split, chosen=chosen,
                                     shipped_ms=shipped, best=best))
        print(f"f32 route {shape}: device ms by split "
              + ", ".join(f"{g}: {t:.4f}" for g, t in by_split.items())
              + f"; chosen {chosen} ({shipped:.4f} ms), best {best}", flush=True)
    result["fma_tflops"] = fma_ceilings()
    print("FP32 pipe, 16 warps an SM: " + ", ".join(
        f"{name} {t:.1f} TFLOP/s" for name, t in result["fma_tflops"].items()), flush=True)
    print(json.dumps(result), flush=True)
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
