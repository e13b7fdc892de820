#!/usr/bin/env python3
"""Kernel A's f32 route on the card: its time at every split, and the
ceilings of the units it runs on.

Both f32 kernels (the FFMA one up to head width 64, the 3xTF32 tensor-core
one above) split each query block's key tiles among the CTAs of a cluster
and pick that split per call (`split_for` in
`monst3r_slam_torch/csrc/attention.cu`). This builds the kernel library once
per split 1-8 with the split fixed (`-DF32_SPLIT=g`) and, at the encoder and
decoder shapes and at `chip_smoke.F32_TRAIN_SHAPES`, prints each build's
device time (`chip_smoke.device_ms`) beside the split the shipped library
chooses and its time (also at the 4 and 6 heads of 768 tokens that
`chip_smoke.py`'s wide phase times at widths 256 and 160), so the choice
can be checked against the measured best, and how many clusters of each
size the card holds at once (what the choice reads). With `--width D` it
times the route at head width D (padded as the wrapper pads it) in place of
64. With `--table` it times the f32 shapes above width 64 of PERF.md's
kernel table instead (`TABLE_SHAPES`) and fits the tensor-core kernel's
split cost to them: the constants (a, c) of `f32_split` that lose the least
time against each shape's best split.

It also times kernels over the whole card, 16 warps an SM: for the FP32
pipe, 16 independent FMA chains a thread (one fresh register operand an
FMA) and the 8x8 outer product from registers that the FFMA route's P V
product issues (two fresh operands an FMA), in TFLOP/s against the 67
TFLOP/s peak; for the tensor cores, mma.sync m16n8k8 in TF32 as the
tensor-core route issues it, 8 independent accumulators a warp each taking
3xTF32's three mma a product, with its operands split once (the ceiling of
the mma alone) and with one operand split again per product from a value
that changes (the route's split in registers beside the mma), in TF32
TFLOP/s against the 495 TFLOP/s peak and in f32 TFLOP/s (a third of it).

    python3 scripts/profile_f32_attention.py [--seed 0] [--width 64 | --table]
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
CLUSTER_SIZES = range(1, 17)  # the split's, times the slices that share S

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
__device__ __forceinline__ unsigned tf32_rna(unsigned b) { return (b + 0x1000u) & 0xffffe000u; }
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
               "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 8 accumulators a warp, three mma a product (lo hi + hi lo + hi hi); with
// `resplit`, one B operand is split again per product from a value that
// changes, as the route splits each fragment it loads.
template <bool resplit>
__global__ void mma3x(float* out, int iters, const float* __restrict__ in) {
  unsigned ah[4], al[4], bh[8][2], bl[8][2];
  float acc[8][4], bf[8][2];
  for (int e = 0; e < 4; ++e) {
    ah[e] = tf32_rna(__float_as_uint(in[e]));
    al[e] = tf32_rna(__float_as_uint(in[e] - __uint_as_float(ah[e])));
  }
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 2; ++e) {
      bf[j][e] = in[4 + 2 * j + e] + threadIdx.x * 1e-3f;
      bh[j][e] = tf32_rna(__float_as_uint(bf[j][e]));
      bl[j][e] = tf32_rna(__float_as_uint(bf[j][e] - __uint_as_float(bh[j][e])));
    }
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (resplit) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bf[j][e] *= 0.999f;
          bh[j][e] = tf32_rna(__float_as_uint(bf[j][e]));
          bl[j][e] = tf32_rna(__float_as_uint(bf[j][e] - __uint_as_float(bh[j][e])));
        }
      }
      mma(acc[j], al, bh[j][0], bh[j][1]);
      mma(acc[j], ah, bl[j][0], bl[j][1]);
      mma(acc[j], ah, bh[j][0], bh[j][1]);
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) s += acc[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int which, int blocks, int iters, float* out, const float* in, cudaStream_t st) {
  if (which == 0) chains<<<blocks, 256, 0, st>>>(out, iters, 0.999f, 1e-3f);
  else if (which == 1) outer8x8<<<blocks, 256, 0, st>>>(out, iters, in);
  else if (which == 2) mma3x<false><<<blocks, 256, 0, st>>>(out, iters, in);
  else mma3x<true><<<blocks, 256, 0, st>>>(out, iters, in);
  return (int)cudaGetLastError();
}
"""

# The f32 shapes above head width 64 in PERF.md's kernel table: the heads
# phase's (1,16,768,128), the wide phase's 256 and 160 wide heads and the
# six shapes above 256.
TABLE_SHAPES = ((1, 16, 768, 128), (1, 4, 768, 256), (1, 6, 768, 160), (1, 3, 768, 320),
                (1, 2, 768, 384), (1, 2, 768, 512), (1, 1, 768, 1024), (2, 1, 196, 2048),
                (1, 1, 768, 768))
# `f32_split`'s constants for the tensor-core kernel are searched over these
# (tenths of a key tile).
FIT_A = range(0, 41)
FIT_C = range(0, 61, 2)


def build_split_libraries() -> dict:
    """{split: library} built with the split fixed at 1-8."""
    from monst3r_slam_torch.ops import build

    OUT.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "attention.cu"
    procs = {}
    for g in SPLITS:
        so = OUT / f"libattention_split{g}.so"
        procs[g] = (subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, f"-DF32_SPLIT={g}", "-o",
                                      str(so), str(src)], stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"split {key} build failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.attn_forward.argtypes = [ctypes.c_char_p]
        lib.attn_forward.restype = ctypes.c_int
        libs[key] = lib
    return libs


def launch(lib, q, k, v, d_true):
    """`attention.fused_attention`'s launch through another build of the
    library, on heads already padded to an instantiation (`d_true` the
    width before padding); returns the padded output."""
    import torch

    from monst3r_slam_torch.ops import attention

    b, h, nq, d = q.shape
    out = torch.empty_strided((b, h, nq, d), (nq * h * d, d, h * d, 1), dtype=q.dtype,
                              device=q.device)
    args = attention._PACK(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *q.stride(),
                           *k.stride(), *v.stride(), *out.stride(), b, h, nq, k.shape[2], d,
                           d_true, 0, torch.cuda.current_stream().cuda_stream)
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
    inp = torch.rand(20, device="cuda")
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


def mma_ceilings() -> dict:
    """{name: (TF32 TFLOP/s, f32 TFLOP/s)} of the 3xTF32 mma chains over the
    whole card (the kernels of `fma_ceilings`' library)."""
    import torch

    lib = ctypes.CDLL(str(OUT / "libfma.so"))
    lib.run.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    lib.run.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 2 * sms, 2048
    out = torch.empty(blocks * 256, device="cuda")
    inp = torch.rand(20, device="cuda")
    rows = {}
    for which, name in ((2, "3xTF32 mma, operands split once"),
                        (3, "3xTF32 mma, one operand split per product")):
        def call():
            if lib.run(which, blocks, iters, out.data_ptr(), inp.data_ptr(),
                       torch.cuda.current_stream().cuda_stream) != 0:
                raise RuntimeError("mma kernel launch failed")
        call()
        torch.cuda.synchronize()
        ms = chip_smoke_events(call, 5)
        tf32 = 24.0 * 2048 * iters * blocks * (256 // 32) / ms / 1e9
        rows[name] = (tf32, tf32 / 3)
    return rows


def chip_smoke_events(fn, n: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def split_model(clusters: dict, sms: int, blocks: int, ntiles: int, a: int, c: int,
                per: int = 1) -> tuple:
    """`f32_split` of attention.cu in Python: (the split with the least
    estimated time for `blocks` clusters of `per` x split CTAs over `ntiles`
    key tiles, its cost)."""
    best, best_cost = 1, None
    for g in range(1, min(8, 16 // per, ntiles) + 1):
        cap = clusters[g * per]
        if cap <= 0:
            continue
        tiles, cost, left = -(-ntiles // g), 0, blocks
        while left > 0:
            per_sm = -(-(min(left, cap) * g * per) // sms)
            cost += tiles * (10 * per_sm + a) + c
            left -= cap
        if best_cost is None or cost < best_cost:
            best, best_cost = g, cost
    return best, best_cost


def plan_model(r: dict, clusters: dict, sms: int, a: int, c: int) -> tuple:
    """`plan_for` of attention.cu in Python: (split, share) at row `r`'s
    shape (the wide slices share S)."""
    b, h, n, d = r["shape"]
    qblocks, ntiles, slices = -(-n // r["rows"]), -(-n // r["tile"]), r["slices"]
    share = r["rows"] == 64 and d > 256 and 1 < slices <= 16
    per = slices if share else 1
    g, _ = split_model(clusters, sms, qblocks * b * h * (slices // per), ntiles, a, c, per)
    return g, int(share)


def fit_split(rows: list, clusters: dict, sms: int) -> dict:
    """The (a, c) of `FIT_A` x `FIT_C` whose plans lose the least time
    against the measured best split, summed over `rows` (each with its
    shape, key tile, query rows a block, slices and device ms by split)."""
    best = None
    for a in FIT_A:
        for c in FIT_C:
            lost = 0.0
            for r in rows:
                split, _ = plan_model(r, clusters[r["width"]], sms, a, c)
                lost += r["device_ms"][split] - min(r["device_ms"].values())
            if best is None or lost < best[0]:
                best = (lost, a, c)
    return dict(a=best[1], c=best[2], lost_ms=best[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=int, default=64,
                    help="head width of the shapes timed (any; default 64)")
    ap.add_argument("--table", action="store_true",
                    help="time the f32 shapes above width 64 of PERF.md's table and fit the "
                         "tensor-core kernel's split cost to them")
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
    shipped_lib.attn_f32_clusters.argtypes = [ctypes.c_int, ctypes.c_int]
    shipped_lib.attn_f32_clusters.restype = ctypes.c_int
    rng = np.random.default_rng(args.seed)
    if args.table:
        shapes = list(TABLE_SHAPES)
    else:
        shapes = [(*s[:3], args.width) for s in ((1, 16, 768), (1, 12, 768), (1, 4, 768),
                                                 (1, 6, 768), *chip_smoke.F32_TRAIN_SHAPES)]
    widths = sorted({attention.padded_width(s[3], torch.float32) for s in shapes})
    # Each kernel's cluster counts, read at a width it runs.
    result_clusters = {w: {g: shipped_lib.attn_f32_clusters(g, w) for g in CLUSTER_SIZES}
                       for w in widths}
    for w, counts in result_clusters.items():
        print(f"clusters the card holds at once at width {w}, by split: " + ", ".join(
            f"{g}: {n}" for g, n in counts.items()), flush=True)
    result = dict(card=card, width=None if args.table else args.width, clusters=result_clusters,
                  shapes=[])
    for shape in shapes:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda")
                   for _ in range(3))
        ref = attention.reference(q, k, v)
        d = shape[3]
        qp, kp, vp = attention.pad_heads(q, k, v, attention.padded_width(d, torch.float32))
        by_split = {}
        for g, lib in libs.items():
            got = launch(lib, qp, kp, vp, d)[..., :d]
            err = float((got.double() - ref).abs().max())
            if not err <= attention.error_bound(q, k, v, ref):
                raise RuntimeError(f"split {g} at {shape}: max abs err {err}")
            by_split[g] = chip_smoke.device_ms(lambda: launch(lib, qp, kp, vp, d), iters=50)
        chosen = (chip_smoke.f32_split(shape), chip_smoke.f32_share(shape))
        shipped = chip_smoke.device_ms(lambda: launch(shipped_lib, qp, kp, vp, d), iters=50)
        best = min(by_split, key=by_split.get)
        tc = attention.route(torch.float32, d) == "f32_tc"
        result["shapes"].append(dict(
            shape=list(shape), width=qp.shape[-1], device_ms=by_split, chosen=list(chosen),
            shipped_ms=shipped, best=best, slices=attention.column_slices(d, torch.float32),
            rows=64 if tc else 128, tile=32 if tc else 16))
        print(f"f32 route {shape}: device ms by split "
              + ", ".join(f"{g}: {t:.4f}" for g, t in by_split.items())
              + f"; chosen split {chosen[0]} share {chosen[1]} ({shipped:.4f} ms), best {best}",
              flush=True)
    tc_rows = [r for r in result["shapes"] if r["rows"] == 64]
    if tc_rows:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        result["tc_split_fit"] = fit_split(tc_rows, result_clusters, sms)
        print(f"tensor-core kernel's split cost fitted to these shapes: {result['tc_split_fit']}",
              flush=True)
    result["fma_tflops"] = fma_ceilings()
    print("FP32 pipe, 16 warps an SM: " + ", ".join(
        f"{name} {t:.1f} TFLOP/s" for name, t in result["fma_tflops"].items()), flush=True)
    result["mma_tflops"] = mma_ceilings()
    print("tensor cores, mma.sync m16n8k8 TF32, 16 warps an SM: " + ", ".join(
        f"{name} {t:.1f} TF32 TFLOP/s ({f:.1f} f32)" for name, (t, f) in
        result["mma_tflops"].items()), flush=True)
    print(json.dumps(result), flush=True)
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
