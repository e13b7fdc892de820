// Kernel A: fused softmax attention forward, O = softmax(Q K^T d^-1/2) V.
//
// Both routes are templates on the head width D, instantiated at 16, 32, 64,
// 128 and 256; the wrapper zero-pads any other width from 1 to 256 to the
// next of them (zero columns of q and k leave Q K^T as it is, zero columns
// of v give zero columns of O, sliced off) and passes the true width, whose
// d^-1/2 scales the logits. Wider heads take the wide variant of each route
// (see "Wide heads" below), at any multiple of 64, to which the wrapper pads
// them. The notes below give the shapes and counts at D = 64, the main
// path's width.
//
// Replaces the JAX package's Pallas kernel in `ops/attention.py`
// (`fused_attention`, body `_attn_kernel`): f32 logits and an f32 softmax,
// probabilities rounded to v's type before the PV product, output in the
// input's type. The Pallas body holds one (batch, head)'s whole 768x768 f32
// logit matrix in VMEM; a Hopper SM has 227 KB, so both routes here are
// flash-style forwards instead: each CTA owns a tile of query rows, K/V
// stream through shared memory in key tiles, an online softmax keeps an f32
// running max and sum per row, the logit matrix never in device memory.
//
// Bound on this card: at the MASt3R encoder shape (1 x 16 heads x 768 tokens
// x d=64, bf16) one call does 4*16*768*768*64 = ~2.4 GFLOP and moves ~6.3 MB,
// so it is bound by operations: 2.44 us at the 989 TFLOP/s bf16 tensor-core
// peak (1.9 us for the bytes at 3.35 TB/s).
//
// bf16 route (every call of the model on the card): tensor cores.
//   - S = Q K^T is a chain of D/16 wgmma m64n64k16 (bf16 x bf16 -> f32); Q
//     and the K tile come from shared memory, both K-major.
//   - O += P V takes P from registers, rounded to bf16 (the reference's
//     rounding point), and the V tile from shared memory (B transposed,
//     MN-major): the S accumulator's register layout is the A fragment's.
//     It is one wgmma m64nDk16 per 16 keys, at D = 128 two m64n64k16, one
//     per 64-column half.
//   - A CTA owns 64 query rows, the m64 of one wgmma. At 768 tokens the grid
//     is 12 x 16 = 192 CTAs (encoder) or 12 x 12 = 144 (decoder); a CTA holds
//     ~73 KB of shared memory, so two fit on an SM and the grid runs in one
//     wave on the 132 SMs. So small a grid leaves the SM's units mostly idle
//     while one CTA walks its chain of key tiles: two warpgroups share the
//     CTA's query rows and take every other key tile, each with its own ring
//     and softmax state, and merge at the end, which halves the chain.
//   - TMA loads Q once and K/V through a 2-stage ring per warpgroup, completing on
//     mbarriers, with the swizzle of one row of D bf16 values: 128 bytes at
//     D = 64, 64 at 32, 32 at 16; at 128 (256) a row is two (four) 128-byte
//     atoms, each tile two (four) 64-column boxes. The wgmma descriptors
//     name the same swizzle. At D = 128 a CTA holds ~145 KB, so one fits an
//     SM. At D = 256 a 64-row tile is 32 KB and two stages per warpgroup
//     would need 288 KB, so each warpgroup has one stage (~161 KB; the
//     other warpgroup's tile computes while a load is in flight), and the
//     128 O accumulators a thread (S's 32 beside them) fit the 255
//     registers one CTA an SM allows. The tensor
//     maps are encoded on the host with cuTensorMapEncodeTiled, reached
//     through cudaGetDriverEntryPoint, so the library needs no -lcuda, and
//     cached on what the encoding reads, so a call whose buffers recur
//     (the model's, frame after frame) does not encode them again.
//   - The softmax works in log2 units: each probability is one FFMA (scale
//     by d^-1/2 log2(e), minus the running max) and one MUFU ex2, the unit
//     whose rate bounds this kernel's CUDA-core half as the tensor cores
//     bound the other; the O accumulator is rescaled when a row's max moves
//     and divided by the sum once at the end.
//   - Keys at or past nk are masked to -inf (TMA fills rows past the end with
//     zeros); query rows past nq are not stored.
//   - Each operand comes with its own (batch, head, row) strides, the last
//     dimension contiguous, so a transposed view of the projection's output
//     is read in place; O is written through strides as well.
// The earlier design of this kernel did its products as f32 FMAs on the CUDA
// cores, 61x slower than this bound; the tensor-core route moves both
// products onto wgmma and the loads onto TMA. What is left is the softmax
// (the MUFU ex2 rate and the FP32 pipe, about as busy as the tensor cores at
// d = 64), the prologue before the first product, and the SMs that hold two
// CTAs, which set the time of the wave.
//
// f32 route (f32 models on the card: training in f32, the f32 checks against
// the CPU path): f32 logits, f32 probabilities, f32 output, on the FP32 pipe.
// It exists so that an f32 model on the card stays within 1e-3 of the CPU
// path; TF32 tensor cores would not, and 3xTF32 on wgmma would need V
// transposed every tile and twice the staged bytes. So it is bound by f32
// operations: at (1, 16, 768, 64) 2.42 GFLOP at 67 TFLOP/s is 36.1 us (the
// 12.6 MB it moves take 3.8 us at 3.35 TB/s); at (1, 12, 768, 64) 27.0 us.
// The FP32 pipe issues one FFMA per lane per cycle, so every other
// instruction a warp issues is time the pipe stands idle. The design:
//   - Register tiles. A warp owns 32 query rows; per 16-key tile each lane
//     holds a 4x4 block of S and, all along, an 8x(D/8) block of O. At
//     D = 128 that block would be 128 registers, so a warp owns 16 rows
//     there (a 2x4 block of S, a 4x16 block of O, 64-row CTAs), and at
//     D = 256 8 rows (a 1x4 block of S, a 2x32 block of O, 32-row CTAs of
//     ~132 KB, one an SM). S = Q K^T
//     reads Q and K as 16-byte loads along d (8 loads for 64 FFMA), O += P V
//     reads P and V as 16-byte loads along the rows and columns (4 loads for
//     64 FFMA): one shared load per 10.7 FFMA over the tile. The staged rows
//     are padded to D + 4 floats, and Q's rows are staged in the order the S
//     loads read them, so that no load has a bank conflict; P goes through a
//     key-major slice of shared memory per warp. At D = 16 a lane's two
//     columns of O take 8-byte V loads.
//   - Asynchronous staging. Each thread copies its 16-byte share of Q once
//     and of every tile's 16 K and 16 V rows with cp.async (LDGSTS), one
//     copy group per tile, into a three-stage ring: tile i + 2 is in flight
//     while tile i computes, and one barrier a tile both publishes the tile
//     that landed and frees the stage of the one before. Rows past the end
//     copy the last row and are masked, so any row stride that is a multiple
//     of 4 floats is read in place.
//   - Filling the SMs. A CTA of four warps owns 128 query rows (96 blocks at
//     the encoder shape, 72 at the decoder's) and holds 69 KB of shared
//     memory and at most 168 registers a thread, so an SM holds three (12
//     warps). Alone, 96 or 72 CTAs would leave most SMs with one CTA and the
//     rest idle; so the key tiles of a block are split among the `split`
//     CTAs of a cluster (1-8), which merge their partial (O, max, sum)
//     through distributed shared memory. The split is chosen per call from
//     the clusters the card holds at once (cudaOccupancyMaxActiveClusters;
//     on the H100 396, 198, 124, 92, 69, 62, 47 and 45 for splits 1-8) by a
//     cost fitted to measured times (`f32_split`): 6 at the encoder shape
//     (576 CTAs of 8 tiles in two waves) and 3 at the decoder's (216 CTAs of
//     16 tiles, two or one per SM). Each width's instantiation reads its own
//     cluster counts.
//   - The softmax: a row's 16 keys of a tile lie on the 4 lanes that share
//     it, so its max takes two shuffles; each lane keeps its share of the
//     sum, reduced once at the end. The max is taken on the raw scores and
//     each probability is one FFMA (scale d^-1/2 log2(e), minus the max) and
//     one ex2.approx; O is rescaled once a tile and divided by the sum once.
// The earlier design (a warp's 8 queries over all 32 lanes, scalar K and V
// loads, synchronous staging, 64-query CTAs) issued one shared load per 4
// FFMA, computed with nothing in flight, left 72 SMs with one CTA and
// reduced every query's max and sum over the whole warp. What bounds this
// one on the H100 is the FFMA issue rate itself: an 8x8 outer product from
// registers alone reaches 47 of the 67 TFLOP/s (two fresh register operands
// an FFMA), and the shared loads, the softmax and the merge take the rest.
//
// Wide heads (d > 256, a multiple of 64; `attn_fwd_bf16_wide`,
// `attn_fwd_f32_wide`). D = 256's layout does not stretch: at d = 512 a
// 64-row bf16 tile is 64 KB, so Q, K and V stages pass the 227 KB of shared
// memory, and O's accumulators alone would take 256 registers a thread. So
// each CTA owns one column slice of O, 256 columns wide (the last one
// narrower where d is no multiple of 256), in D = 256's accumulator layout
// (the bf16 route's 128 accumulators a thread, the f32 route's 8-row warps),
// and recomputes S = Q K^T for its slice over the whole of d, 64 columns at
// a time: per key tile, Q's and K's next 64-column chunks are staged (TMA
// boxes on the bf16 route, cp.async on the f32 route) through a ring while
// the chunk before is multiplied, then the softmax, then the V tile's slice
// columns into the O accumulators. The grid is (query tile, slice, batch x
// head), folded into x. The recompute does the S work once per slice and
// reads Q and K again per slice and per key tile (from L2); sharing one
// CTA's P with its slice's peers through distributed shared memory would
// spare both, at a cluster barrier a tile. The f32 route keeps its cluster
// split over key tiles (split chosen as for D = 256).
//
// Every route folds batch x heads into the grid's x with the query tiles
// (and the slices), so b h has no limit of its own (the y dimension would
// stop at 65,535).
//
// Launches on the caller's stream and returns the launch's cudaGetLastError().

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace {

// The widest instantiation; wider heads take the wide variants, in slices
// of W_SLICE columns of O and chunks of W_CHUNK columns of d.
constexpr int MAX_D = 256;
constexpr int W_SLICE = 256;
constexpr int W_CHUNK = 64;

// Function attributes hold per device: a process that launches on several
// cards sets them on each card at its first launch there.
constexpr int MAX_DEVICES = 64;

cudaError_t current_device(int* dev) {
  cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess && (*dev < 0 || *dev >= MAX_DEVICES)) err = cudaErrorInvalidDevice;
  return err;
}

struct Strides {  // in elements
  long long b, h, r;
};

// ----------------------------------------------------------- bf16 route (TC)

constexpr int BM = 64;          // query rows per CTA: wgmma m64
constexpr int BN = 64;          // keys per tile: n of S = Q K^T, k-extent of P V
constexpr int NWG = 2;          // warpgroups per CTA, each over every other key tile
constexpr int NTHREAD = 128 * NWG;

// A tile of 64 rows of D bf16 values in shared memory, as TMA writes it and
// wgmma reads it: in the swizzle of one row (32, 64 or 128 bytes at D = 16,
// 32, 64), and at D = 128 (256) as two (four) 64-column atoms of 64 rows
// each, one after the other, each in the 128-byte swizzle.
template <int D>
struct Tc {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256,
                "an instantiated head width");
  static constexpr int SW = D < 64 ? 2 * D : 128;  // swizzle span, bytes
  static constexpr int ATOM = SW / 2;              // columns of one atom
  static constexpr int NATOM = D / ATOM;
  static constexpr int ATOM_ELEMS = 64 * ATOM;
  static constexpr int TILE_ELEMS = 64 * D;
  static constexpr int TILE_BYTES = TILE_ELEMS * 2;
  static constexpr int STAGES = D > 128 ? 1 : 2;   // K/V ring of each warpgroup
  static constexpr int NBAR = 1 + NWG * STAGES;    // Q, then one per (warpgroup, stage)
  static constexpr int SMEM = (1 + 2 * NWG * STAGES) * TILE_BYTES + 8 * NBAR + 1024;  // + align slack
  static constexpr int ACC = D / 2;                // O accumulators per thread
  static constexpr int MERGE_FLOATS = ACC + 4;     // per thread: accumulators, 2 maxima, 2 partial sums
  // Warpgroup 1 hands its state over through its own ring, or, where that
  // is too small (one stage at D = 256), through the staging from Q on,
  // once both warpgroups are done with it.
  static constexpr bool MERGE_IN_RING = MERGE_FLOATS * 128 * 4 <= 2 * STAGES * TILE_BYTES;
  static_assert(MERGE_FLOATS * 128 * 4 <= (1 + 2 * NWG * STAGES) * TILE_BYTES, "merge fits");
  static_assert(SMEM <= 232448, "a CTA fits an SM's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a (batch, head, row, d) tensor, columns [col, col + box) of 64
// rows, into shared memory in the map's swizzle; completes its bytes on `bar`.
__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map, uint64_t* bar,
                                             int col, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head), "r"(batch),
      "r"(smem_u32(bar))
      : "memory");
}

// A whole 64-row tile: one box per atom.
template <int D>
__device__ __forceinline__ void tma_load_tile(__nv_bfloat16* dst, const CUtensorMap* map,
                                              uint64_t* bar, int row, int head, int batch) {
#pragma unroll
  for (int a = 0; a < Tc<D>::NATOM; ++a)
    tma_load_box(dst + a * Tc<D>::ATOM_ELEMS, map, bar, a * Tc<D>::ATOM, row, head, batch);
}

// wgmma shared-memory matrix descriptor for one atom of a tile (64 rows of
// SW bytes in the SW-byte swizzle): start address, leading offset 16 B
// (unused: the operand's width is one swizzle atom), stride offset 8 SW bytes
// between groups of 8 rows, layout type 1/2/3 for the 128/64/32-byte
// swizzle. The atom base is aligned to its swizzle's 8-row pattern, so
// advancing the start by 32 B steps 16 columns (K-major) and by 16 SW bytes
// 16 rows (MN-major).
template <int SW>
__device__ __forceinline__ uint64_t sw_desc(const void* p) {
  constexpr uint64_t layout = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(8 * SW >> 4) << 32) | (layout << 62);
}

// Barrier among the 128 threads of one warpgroup (ids 1 and 2; 0 is
// __syncthreads). Constant ids, so the CTA reserves three barriers, not all 16.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;" ::: "memory");
}

// 2^x in one MUFU operation (ex2.approx, ~2 ulp; -inf gives 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundary.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define WG_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_D32                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_ACC8(d)                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
      "+f"(d[7])
#define WG_ACC16(d)                                                                       \
  WG_ACC8(d), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])
#define WG_ACC32(d)                                                                      \
  WG_ACC16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),          \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),      \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (+)= A B, m64n64k16, A and B both from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64nNk16, A from registers (four bf16x2 per thread), B from
// shared memory MN-major (transposed); d holds N/2 accumulators.
template <int N>
__device__ __forceinline__ void wgmma_rs_bt(float* d, const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " WG_D8
        ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : WG_ACC8(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_D16
        ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : WG_ACC16(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    static_assert(N == 64, "m64n16, m64n32 or m64n64");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Register layout of a wgmma m64nN f32 accumulator: thread t of the
// warpgroup holds rows r0 = 16 (t/32) + (t%32)/4 and r1 = r0 + 8; element
// d[4i + e] (e = 0, 1) is (r0, 8i + 2 (t%4) + e) and d[4i + 2 + e] is
// (r1, 8i + 2 (t%4) + e). The bf16 A fragment of an m64k16 product has the
// same layout over its 16 columns, so P is passed to the PV product without
// leaving registers. At D = 128 the two halves' accumulators lie one after
// the other, so acc[4i + ...] is column 8i + ... at every width.

// One key tile's online softmax in log2 units on S (sc, the 64 keys from
// key k0 on), with the ACC accumulators of O rescaled, and P rounded to bf16
// as the A fragments of the PV product's four k16 steps. The max is taken on
// the raw scores (the scale is positive) and each probability is one FFMA
// and one MUFU op. Keys at or past nk count as -inf; only a ragged last tile
// has any.
template <int ACC>
__device__ __forceinline__ void tc_softmax(float (&sc)[32], float* acc, float& m0, float& m1,
                                           float& l0, float& l1, int k0, int nk, int col0,
                                           float scale_log2, uint32_t (&pa)[4][4]) {
  if (k0 + BN > nk) {
    const int kbase = k0 + col0;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (kbase + 8 * n + e >= nk) {
          sc[4 * n + e] = -INFINITY;
          sc[4 * n + 2 + e] = -INFINITY;
        }
      }
    }
  }
  float mx0 = sc[0], mx1 = sc[2];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
  // Finite: every tile holds a valid key (its first), and the max only grows.
  mx0 = fmaxf(m0, quad_max(mx0) * scale_log2);
  mx1 = fmaxf(m1, quad_max(mx1) * scale_log2);
  const float c0 = fast_exp2(m0 - mx0), c1 = fast_exp2(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[4 * n + e] = fast_exp2(fmaf(sc[4 * n + e], scale_log2, -mx0));
      sc[4 * n + 2 + e] = fast_exp2(fmaf(sc[4 * n + 2 + e], scale_log2, -mx1));
      rs0 += sc[4 * n + e];
      rs1 += sc[4 * n + 2 + e];
    }
  }
  l0 = l0 * c0 + rs0;
  l1 = l1 * c1 + rs1;
#pragma unroll
  for (int n = 0; n < ACC / 4; ++n) {
    acc[4 * n] *= c0;
    acc[4 * n + 1] *= c0;
    acc[4 * n + 2] *= c1;
    acc[4 * n + 3] *= c1;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    pa[c][0] = pack_bf16x2(sc[8 * c + 0], sc[8 * c + 1]);  // r0, keys 16c + col0
    pa[c][1] = pack_bf16x2(sc[8 * c + 2], sc[8 * c + 3]);  // r1
    pa[c][2] = pack_bf16x2(sc[8 * c + 4], sc[8 * c + 5]);  // r0, keys 16c + 8 + col0
    pa[c][3] = pack_bf16x2(sc[8 * c + 6], sc[8 * c + 7]);  // r1
  }
}

// Warpgroup 1 hands (acc, m, l) to warpgroup 0 through `merge` (ACC + 4
// floats a thread, in shared memory neither reads any more; same thread
// index, same rows and columns), and warpgroup 0 merges them into its own.
// Every thread of the CTA calls it; warpgroup 1 is done after it.
template <int ACC>
__device__ __forceinline__ void tc_merge(float* acc, float& m0, float& m1, float& l0, float& l1,
                                         float* merge, int wg, int wtid) {
  if (wg == 1) {
#pragma unroll
    for (int e = 0; e < ACC; ++e) merge[e * 128 + wtid] = acc[e];
    merge[ACC * 128 + wtid] = m0;
    merge[(ACC + 1) * 128 + wtid] = m1;
    merge[(ACC + 2) * 128 + wtid] = l0;
    merge[(ACC + 3) * 128 + wtid] = l1;
  }
  __syncthreads();
  if (wg == 1) return;
  const float om0 = merge[ACC * 128 + wtid], om1 = merge[(ACC + 1) * 128 + wtid];
  const float n0 = fmaxf(m0, om0), n1 = fmaxf(m1, om1);  // finite: tile 0 is warpgroup 0's
  const float a0 = fast_exp2(m0 - n0), a1 = fast_exp2(m1 - n1);
  const float b0 = fast_exp2(om0 - n0), b1 = fast_exp2(om1 - n1);  // 0 for a warpgroup with no tile
  l0 = l0 * a0 + merge[(ACC + 2) * 128 + wtid] * b0;
  l1 = l1 * a1 + merge[(ACC + 3) * 128 + wtid] * b1;
#pragma unroll
  for (int n = 0; n < ACC / 4; ++n) {
    acc[4 * n] = acc[4 * n] * a0 + merge[(4 * n) * 128 + wtid] * b0;
    acc[4 * n + 1] = acc[4 * n + 1] * a0 + merge[(4 * n + 1) * 128 + wtid] * b0;
    acc[4 * n + 2] = acc[4 * n + 2] * a1 + merge[(4 * n + 2) * 128 + wtid] * b1;
    acc[4 * n + 3] = acc[4 * n + 3] * a1 + merge[(4 * n + 3) * 128 + wtid] * b1;
  }
}

// The problem is small (12 key tiles per 64 queries at 768 tokens, one or
// two CTAs per SM), so a CTA's serial chain of tiles leaves the SM's units
// idle between its steps. Two warpgroups therefore share the CTA's 64 query
// rows and split its key tiles (warpgroup g takes tiles g, g + 2, ...), each
// with its own K/V ring, running max, sum and accumulator; at the end
// warpgroup 1 hands its state to warpgroup 0 through shared memory, which
// merges the two and stores O.
template <int D>
__global__ void __launch_bounds__(NTHREAD, D <= 64 ? 2 : 1)
attn_fwd_bf16_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                 Strides so, int heads, int nq, int nk, float scale_log2) {
  using T = Tc<D>;
  constexpr int TILE_ELEMS = T::TILE_ELEMS, TILE_BYTES = T::TILE_BYTES, ACC = T::ACC;
  constexpr int STAGES = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(base);
  // Warpgroup g's ring: K tiles at ring(g), V tiles at ring(g) + STAGES tiles.
  auto ring = [&](int g) { return sQ + (1 + 2 * STAGES * g) * TILE_ELEMS; };
  uint64_t* bar = reinterpret_cast<uint64_t*>(sQ + (1 + 2 * NWG * STAGES) * TILE_ELEMS);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;
  const int qtiles = (nq + BM - 1) / BM;
  const int bh = blockIdx.x / qtiles;  // x = (batch x head, query tile)
  const int b = bh / heads, h = bh % heads;
  const int q0 = (blockIdx.x - bh * qtiles) * BM;
  const int ntiles = (nk + BN - 1) / BN;
  const int mine = (ntiles - wg + NWG - 1) / NWG;  // tiles of this warpgroup
  __nv_bfloat16* sK = ring(wg);
  __nv_bfloat16* sV = sK + STAGES * TILE_ELEMS;
  uint64_t* kv_bar = bar + 1 + STAGES * wg;

  if (tid == 0) {
    for (int i = 0; i < T::NBAR; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(&bar[0], TILE_BYTES);
    tma_load_tile<D>(sQ, &tq, &bar[0], q0, h, b);
    for (int g = 0; g < NWG; ++g) {
      for (int s = 0; s < STAGES; ++s) {
        const int j = NWG * s + g;
        if (j >= ntiles) break;
        __nv_bfloat16* kg = ring(g);
        mbar_expect_tx(&bar[1 + STAGES * g + s], 2 * TILE_BYTES);
        tma_load_tile<D>(kg + s * TILE_ELEMS, &tk, &bar[1 + STAGES * g + s], j * BN, h, b);
        tma_load_tile<D>(kg + (STAGES + s) * TILE_ELEMS, &tv, &bar[1 + STAGES * g + s], j * BN,
                         h, b);
      }
    }
  }
  __syncthreads();

  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0, r1 (log2 units)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the running sums
  const uint64_t dq = sw_desc<T::SW>(sQ);
  const int col0 = 2 * (lane & 3);
  mbar_wait(&bar[0], 0);

  for (int i = 0; i < mine; ++i) {
    const int j = NWG * i + wg;  // global key tile
    const int s = i % STAGES;
    mbar_wait(&kv_bar[s], (i / STAGES) & 1);
    const __nv_bfloat16* kt = sK + s * TILE_ELEMS;
    const __nv_bfloat16* vt = sV + s * TILE_ELEMS;

    // S = Q K^T over d: D/16 k16 steps of 32 bytes along the rows, atom by
    // atom.
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    const uint64_t dk = sw_desc<T::SW>(kt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // Step kk's columns: atom 16 kk / ATOM, 32 bytes a step inside it (in
      // the descriptor's 16-byte units).
      const int at = (16 * kk / T::ATOM * T::ATOM_ELEMS + 16 * kk % T::ATOM) * 2 / 16;
      wgmma_ss(sc, dq + at, dk + at, kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(sc);

    uint32_t pa[4][4];
    tc_softmax<ACC>(sc, acc, m0, m1, l0, l1, j * BN, nk, col0, scale_log2, pa);

    // O += P V: V's rows are keys, its columns contiguous (MN-major B), one
    // product per atom of columns.
    const uint64_t dv = sw_desc<T::SW>(vt);
    fence_regs<ACC>(acc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int a = 0; a < T::NATOM; ++a)
        wgmma_rs_bt<T::ATOM>(acc + a * T::ATOM / 2, pa[c],
                             dv + (a * T::ATOM_ELEMS + 16 * c * T::ATOM) * 2 / 16);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<ACC>(acc);

    warpgroup_sync(wg);  // all four warps are done with stage s
    if (wtid == 0 && i + STAGES < mine) {
      const int jn = j + NWG * STAGES;
      mbar_expect_tx(&kv_bar[s], 2 * TILE_BYTES);
      tma_load_tile<D>(sK + s * TILE_ELEMS, &tk, &kv_bar[s], jn * BN, h, b);
      tma_load_tile<D>(sV + s * TILE_ELEMS, &tv, &kv_bar[s], jn * BN, h, b);
    }
  }

  // Warpgroup 1's state goes through its own ring, which it no longer reads
  // (at D = 256, once both are done, through the staging from Q on).
  if constexpr (!T::MERGE_IN_RING) __syncthreads();
  tc_merge<ACC>(acc, m0, m1, l0, l1, reinterpret_cast<float*>(T::MERGE_IN_RING ? ring(1) : sQ),
                wg, wtid);
  if (wg == 1) return;

  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
  const int r0 = q0 + 16 * warp + (lane >> 2), r1 = r0 + 8;
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + col0;
    if (r0 < nq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * so.r + col) =
          __floats2bfloat162_rn(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
    if (r1 < nq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * so.r + col) =
          __floats2bfloat162_rn(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A (batch, head, row, d) bf16 tensor with the given element strides, read
// in boxes of 64 rows by one atom (min(d, 64) columns) in the swizzle of
// `Tc<d>`; rows past `rows` read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, const Strides& st, int d, int rows, int heads,
              int batch) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int atom = d < 64 ? d : 64;
  const CUtensorMapSwizzle swizzle = atom == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : atom == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.r * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)atom, (cuuint32_t)BN, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor maps already encoded, direct-mapped on everything the encoding
// reads (address, width, extents, strides), so an entry is valid for any
// tensor with that key: the caching allocator hands the same buffers to the
// same calls frame after frame, and a hit skips the encode on the host.
struct MapEntry {
  CUtensorMap map;
  long long key[8];
  bool valid;
};
constexpr int MAP_CACHE = 1024;
MapEntry map_cache[MAP_CACHE];
std::mutex map_cache_lock;  // ctypes drops the GIL: callers may be concurrent

bool cached_map(CUtensorMap* map, const void* ptr, const Strides& st, int d, int rows, int heads,
                int batch) {
  const long long key[8] = {(long long)(uintptr_t)ptr, d, rows, heads, batch, st.b, st.h, st.r};
  uint64_t hash = 1469598103934665603ull;  // FNV-1a over the key's words
  for (long long w : key) hash = (hash ^ (uint64_t)w) * 1099511628211ull;
  std::lock_guard<std::mutex> guard(map_cache_lock);
  MapEntry& e = map_cache[(hash >> 32) % MAP_CACHE];
  if (!e.valid || memcmp(e.key, key, sizeof key) != 0) {
    e.valid = make_map(&e.map, ptr, st, d, rows, heads, batch);
    if (!e.valid) return false;
    memcpy(e.key, key, sizeof key);
  }
  *map = e.map;
  return true;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, const Strides* st,
                int batch, int heads, int nq, int nk, float scale_log2, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!cached_map(&tq, q, st[0], D, nq, heads, batch) ||
      !cached_map(&tk, k, st[1], D, nk, heads, batch) ||
      !cached_map(&tv, v, st[2], D, nk, heads, batch))
    return 1001;
  static bool configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(attn_fwd_bf16_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tc<D>::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const long long grid = (long long)((nq + BM - 1) / BM) * batch * heads;
  if (grid > INT_MAX) return 1000;
  attn_fwd_bf16_tc<D><<<(unsigned)grid, NTHREAD, Tc<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st[3], heads, nq, nk, scale_log2);
  return (int)cudaGetLastError();
}

// Wide heads on the bf16 route (see the note at the top): a CTA owns 64
// query rows and one slice of O, up to W_SLICE columns from column c0; its
// two warpgroups split the key tiles as in `attn_fwd_bf16_tc`. Warpgroup g's
// stream of steps t = 0, 1, ...: key tile NWG (t / chunks) + g, d-chunk
// t % chunks, whose Q and K boxes (64 rows x 64 columns each, in the
// 128-byte swizzle) land in stage t % W_STAGES of its ring; its V tile's
// slice (up to four 64-column boxes) lands in one V stage of its own.
constexpr int W_STAGES = 3;
struct TcWide {
  static constexpr int CHUNK_ELEMS = 64 * W_CHUNK;        // one 64 x 64 box
  static constexpr int CHUNK_BYTES = CHUNK_ELEMS * 2;
  static constexpr int NATOM = W_SLICE / W_CHUNK;         // V boxes of a whole slice
  static constexpr int STAGE_ELEMS = 2 * CHUNK_ELEMS;     // Q's chunk, then K's
  static constexpr int WG_ELEMS = W_STAGES * STAGE_ELEMS + NATOM * CHUNK_ELEMS;  // + V
  static constexpr int NBAR = NWG * (W_STAGES + 1);       // per warpgroup: stages, then V
  static constexpr int SMEM = NWG * WG_ELEMS * 2 + 8 * NBAR + 1024;  // + align slack
  static constexpr int ACC = W_SLICE / 2;
  static_assert((ACC + 4) * 128 * 4 <= WG_ELEMS * 2, "the merge fits a warpgroup's ring");
  static_assert(SMEM <= 232448, "a CTA fits an SM's shared memory");
};

__global__ void __launch_bounds__(NTHREAD, 1)
attn_fwd_bf16_wide(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                   Strides so, int heads, int nq, int nk, int chunks, int slices,
                   float scale_log2) {
  using W = TcWide;
  constexpr int CHUNK_ELEMS = W::CHUNK_ELEMS, STAGE_ELEMS = W::STAGE_ELEMS, ACC = W::ACC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  auto region = [&](int g) { return reinterpret_cast<__nv_bfloat16*>(base) + g * W::WG_ELEMS; };
  uint64_t* bars = reinterpret_cast<uint64_t*>(region(NWG));

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;
  const int qtiles = (nq + BM - 1) / BM;
  int x = blockIdx.x;  // x = ((batch x head, slice), query tile)
  const int q0 = x % qtiles * BM;
  x /= qtiles;
  const int c0 = x % slices * W_SLICE;
  const int bh = x / slices;
  const int b = bh / heads, h = bh % heads;
  const int natoms = min(W::NATOM, chunks - c0 / W_CHUNK);  // this slice's 64-column boxes
  const int ntiles = (nk + BN - 1) / BN;
  const int mine = (ntiles - wg + NWG - 1) / NWG;

  // Warpgroup g's step t into its stage t % W_STAGES; its tile i's V slice.
  // One thread issues each.
  const CUtensorMap *mq = &tq, *mk = &tk, *mv = &tv;
  auto load_step = [&](int g, int t) {
    __nv_bfloat16* st = region(g) + t % W_STAGES * STAGE_ELEMS;
    uint64_t* bar = bars + (W_STAGES + 1) * g + t % W_STAGES;
    const int j = NWG * (t / chunks) + g, col = t % chunks * W_CHUNK;
    mbar_expect_tx(bar, 2 * W::CHUNK_BYTES);
    tma_load_box(st, mq, bar, col, q0, h, b);
    tma_load_box(st + CHUNK_ELEMS, mk, bar, col, j * BN, h, b);
  };
  auto load_v = [&](int g, int i) {
    __nv_bfloat16* sv = region(g) + W_STAGES * STAGE_ELEMS;
    uint64_t* bar = bars + (W_STAGES + 1) * g + W_STAGES;
    mbar_expect_tx(bar, natoms * W::CHUNK_BYTES);
    for (int a = 0; a < natoms; ++a)
      tma_load_box(sv + a * CHUNK_ELEMS, mv, bar, c0 + a * W_CHUNK, (NWG * i + g) * BN, h, b);
  };

  if (tid == 0) {
    for (int i = 0; i < W::NBAR; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int g = 0; g < NWG; ++g) {
      const int steps_g = (ntiles - g + NWG - 1) / NWG * chunks;
      for (int t = 0; t < W_STAGES && t < steps_g; ++t) load_step(g, t);
      if (steps_g > 0) load_v(g, 0);
    }
  }
  __syncthreads();

  const __nv_bfloat16* ring = region(wg);
  uint64_t* cbar = bars + (W_STAGES + 1) * wg;
  const int steps = mine * chunks;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;
  const int col0 = 2 * (lane & 3);

  for (int i = 0; i < mine; ++i) {
    // S = Q K^T over d, chunk by chunk: four k16 steps of 32 bytes in each
    // chunk's one atom. A chunk's products run while the next chunk's wait
    // is served; once the products of step t - 1 are done, its stage takes
    // step t - 1 + W_STAGES.
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const int t = i * chunks + c;
      mbar_wait(&cbar[t % W_STAGES], (t / W_STAGES) & 1);
      const __nv_bfloat16* st = ring + t % W_STAGES * STAGE_ELEMS;
      const uint64_t dq = sw_desc<128>(st), dk = sw_desc<128>(st + CHUNK_ELEMS);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, dq + 2 * kk, dk + 2 * kk, 1);
      wgmma_commit();
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      if (t > 0) {
        warpgroup_sync(wg);  // every warp is done with step t - 1's stage
        if (wtid == 0 && t - 1 + W_STAGES < steps) load_step(wg, t - 1 + W_STAGES);
      }
    }
    wgmma_wait_all();
    fence_regs<32>(sc);

    uint32_t pa[4][4];
    tc_softmax<ACC>(sc, acc, m0, m1, l0, l1, (NWG * i + wg) * BN, nk, col0, scale_log2, pa);

    // O += P V over the slice's boxes (a narrower last slice skips the rest).
    mbar_wait(&cbar[W_STAGES], i & 1);
    const uint64_t dv = sw_desc<128>(ring + W_STAGES * STAGE_ELEMS);
    fence_regs<ACC>(acc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int a = 0; a < W::NATOM; ++a)
        if (a < natoms)
          wgmma_rs_bt<W_CHUNK>(acc + a * W_CHUNK / 2, pa[c],
                               dv + (a * CHUNK_ELEMS + 16 * c * W_CHUNK) * 2 / 16);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<ACC>(acc);
    warpgroup_sync(wg);  // every warp is done with the V stage
    if (wtid == 0 && i + 1 < mine) load_v(wg, i + 1);
  }

  tc_merge<ACC>(acc, m0, m1, l0, l1, reinterpret_cast<float*>(region(1)), wg, wtid);
  if (wg == 1) return;

  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
  const int r0 = q0 + 16 * warp + (lane >> 2), r1 = r0 + 8;
  __nv_bfloat16* ob = o + b * so.b + h * so.h + c0;
#pragma unroll
  for (int n = 0; n < ACC / 4; ++n) {
    if (n / 8 >= natoms) continue;
    const int col = 8 * n + col0;
    if (r0 < nq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * so.r + col) =
          __floats2bfloat162_rn(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
    if (r1 < nq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * so.r + col) =
          __floats2bfloat162_rn(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
  }
}

int launch_bf16_wide(const void* q, const void* k, const void* v, void* o, const Strides* st,
                     int batch, int heads, int nq, int nk, int d, float scale_log2,
                     cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!cached_map(&tq, q, st[0], d, nq, heads, batch) ||
      !cached_map(&tk, k, st[1], d, nk, heads, batch) ||
      !cached_map(&tv, v, st[2], d, nk, heads, batch))
    return 1001;
  static bool configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(attn_fwd_bf16_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TcWide::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const int chunks = d / W_CHUNK, slices = (d + W_SLICE - 1) / W_SLICE;
  const long long grid = (long long)((nq + BM - 1) / BM) * slices * batch * heads;
  if (grid > INT_MAX) return 1000;
  attn_fwd_bf16_wide<<<(unsigned)grid, NTHREAD, TcWide::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st[3], heads, nq, nk, chunks, slices,
      scale_log2);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ f32 route
//
// Register-tiled f32 attention on the FP32 pipe (see the note at the top).
// A CTA of four warps owns BQ query rows, WROWS per warp, and one share of
// the key tiles; the `split` CTAs of a cluster take the shares of one block
// and merge their partial (O, max, sum) through distributed shared memory at
// the end.
//
// Lane layouts of a warp (lane = 4 rg + kg = 8 RG + cg), with SR = WROWS / 8
// S rows and OR = WROWS / 4 O rows a lane (4 and 8; 2 and 4 at D = 128; 1
// and 2 at D = 256):
//   S = Q K^T, WROWS rows x 16 keys: rows SR rg + i (i < SR), keys kg + 4 t
//   (t < 4).
//   O, WROWS rows x D columns: rows OR RG + x (x < OR), columns 32 j + 4 cg + c
//   (j < D / 32, c < 4); at D = 16, columns 2 cg + c (c < 2).
// O row OR RG + SR h + i is S row SR (2 RG + h) + i, held by lane
// 8 RG + 4 h + (cg & 3): one shuffle per row hands a rescale to the O lanes.
// Q row SR rg + i of warp w is staged at row WROWS w + 8 i + rg, so the eight
// rows of one S load sit in eight different bank groups.

constexpr int F_WARPS = 4;
constexpr int F_THREADS = 32 * F_WARPS;
constexpr int F_BK = 16;                          // keys per staged tile
constexpr int F_STAGES = 3;                       // K/V ring depth
constexpr int F_MAX_SPLIT = 8;                    // portable cluster size

template <int D>
struct F32 {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256,
                "an instantiated head width");
  static constexpr int WROWS = D > 128 ? 8 : D > 64 ? 16 : 32;  // query rows per warp
  static constexpr int SR = WROWS / 8;            // S rows per lane
  static constexpr int OR = WROWS / 4;            // O rows per lane
  static constexpr int OC = D / 8;                // O columns per lane
  static constexpr int BQ = F_WARPS * WROWS;      // query rows per CTA
  static constexpr int LD = D + 4;                // staged row stride (floats): 68 at D = 64
  static constexpr int Q_FLOATS = BQ * LD;
  static constexpr int TILE_FLOATS = 2 * F_BK * LD;  // a tile's 16 K rows, then its 16 V rows
  static constexpr int P_FLOATS = F_BK * WROWS;      // a warp's P, key-major
  static constexpr int SMEM = 4 * (Q_FLOATS + F_STAGES * TILE_FLOATS + F_WARPS * P_FLOATS);
  // The merge reuses the staging: partial O over Q's rows, max and sum over
  // the ring, each row's weights over P.
  static_assert(2 * BQ <= F_STAGES * TILE_FLOATS, "max and sum fit the ring");
  static_assert(BQ + F_MAX_SPLIT <= F_WARPS * P_FLOATS, "weights fit P");
};

// Column of element e (< OC) of a lane's O columns for column group cg.
template <int D>
__device__ __forceinline__ int o_col(int cg, int e) {
  return D == 16 ? 2 * cg + e : 32 * (e / 4) + 4 * cg + e % 4;
}

// 16 bytes from global to shared memory, asynchronously (cp.async, through
// L2 only): completes at the thread's next cp.async.wait_group that covers it.
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// Wait until at most `n` of this thread's committed copy groups are pending.
template <int n>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// This thread's share of tile `tile`'s K and V rows into `dst` (16 K rows,
// then 16 V rows, each D/4 chunks of 16 bytes). Rows past nk copy row
// nk - 1, so the tile holds finite values; their keys are masked.
template <int D>
__device__ __forceinline__ void stage_kv(float* dst, const float* kb, const float* vb,
                                         long long kr, long long vr, int tile, int nk, int tid) {
#pragma unroll
  for (int e = tid; e < 2 * F_BK * (D / 4); e += F_THREADS) {
    const int row = e / (D / 4), c4 = e % (D / 4);
    const int key = min(tile * F_BK + row % F_BK, nk - 1);
    copy16(dst + row * F32<D>::LD + 4 * c4,
           (row < F_BK ? kb + key * kr : vb + key * vr) + 4 * c4);
  }
}

__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(x) : "r"(addr) : "memory");
  return x;
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}

// Every thread of the cluster arrives; with `release`, its shared-memory
// writes are visible to the cluster after the wait.
template <bool release>
__device__ __forceinline__ void cluster_sync() {
  if (release)
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  else
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// One key tile of the f32 route after S = Q K^T (sc: this lane's SR rows x
// 4 keys of the 16 from tile `tile` on): the online softmax in log2 units
// over the 4 lanes that share a row, P through the warp's key-major slice
// Pw, O rescaled and += P V from the staged V rows Vt (row stride
// F32<D>::LD). Keys at or past nk count as -inf; only a ragged last tile has
// any, and every tile holds a valid key (its first), so the max is finite.
template <int D>
__device__ __forceinline__ void f32_tile(float (&sc)[F32<D>::SR][4], float (&m)[F32<D>::SR],
                                         float (&l)[F32<D>::SR],
                                         float (&acc)[F32<D>::OR][F32<D>::OC], float* Pw,
                                         const float* Vt, int tile, int nk, float scale_log2,
                                         int lane) {
  using F = F32<D>;
  constexpr int WROWS = F::WROWS, SR = F::SR, OR = F::OR, OC = F::OC, LD = F::LD;
  const int rg = lane >> 2, kg = lane & 3, RG = lane >> 3, cg = lane & 7;
  const int key0 = tile * F_BK + kg;
  if ((tile + 1) * F_BK > nk) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (key0 + 4 * t >= nk)
#pragma unroll
        for (int i = 0; i < SR; ++i) sc[i][t] = -INFINITY;
  }
  float corr[SR];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    float mx = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[i], mx * scale_log2);
    corr[i] = fast_exp2(m[i] - mn);
    m[i] = mn;
    float rs = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      sc[i][t] = fast_exp2(fmaf(sc[i][t], scale_log2, -mn));
      rs += sc[i][t];
    }
    l[i] = fmaf(l[i], corr[i], rs);
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    float* dst = Pw + (kg + 4 * t) * WROWS + SR * rg;
    if constexpr (SR == 4)
      *reinterpret_cast<float4*>(dst) = make_float4(sc[0][t], sc[1][t], sc[2][t], sc[3][t]);
    else if constexpr (SR == 2)
      *reinterpret_cast<float2*>(dst) = make_float2(sc[0][t], sc[1][t]);
    else
      *dst = sc[0][t];
  }
  float oc[OR];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    oc[i] = __shfl_sync(0xffffffffu, corr[i], lane & ~4);
    oc[SR + i] = __shfl_sync(0xffffffffu, corr[i], lane | 4);
  }
  __syncwarp();  // P is in shared memory

  // O += P V: per key, OR / 4 loads of P and OC / 4 of V (16 bytes each)
  // feed OR OC FMAs.
#pragma unroll
  for (int x = 0; x < OR; ++x)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[x][c] *= oc[x];
#pragma unroll
  for (int j = 0; j < F_BK; ++j) {
    float p[OR], w[OC];
    if constexpr (OR == 2) {
      const float2 pv = *reinterpret_cast<const float2*>(Pw + j * WROWS + OR * RG);
      p[0] = pv.x;
      p[1] = pv.y;
    } else {
#pragma unroll
      for (int x4 = 0; x4 < OR / 4; ++x4) {
        const float4 pv = *reinterpret_cast<const float4*>(Pw + j * WROWS + OR * RG + 4 * x4);
        p[4 * x4] = pv.x;
        p[4 * x4 + 1] = pv.y;
        p[4 * x4 + 2] = pv.z;
        p[4 * x4 + 3] = pv.w;
      }
    }
    if constexpr (D == 16) {
      const float2 vv = *reinterpret_cast<const float2*>(Vt + j * LD + 2 * cg);
      w[0] = vv.x;
      w[1] = vv.y;
    } else {
#pragma unroll
      for (int c4 = 0; c4 < OC / 4; ++c4) {
        const float4 vv = *reinterpret_cast<const float4*>(Vt + j * LD + 32 * c4 + 4 * cg);
        w[4 * c4] = vv.x;
        w[4 * c4 + 1] = vv.y;
        w[4 * c4 + 2] = vv.z;
        w[4 * c4 + 3] = vv.w;
      }
    }
#pragma unroll
    for (int x = 0; x < OR; ++x)
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[x][c] = fmaf(p[x], w[c], acc[x][c]);
  }
}

// The split's merge, once every warp is done with the last tile and no
// copy is in flight: this CTA's partials (O unnormalized into part_o, BQ
// rows of F32<D>::LD floats; each row's max and sum into part_m and part_l)
// in its own shared memory; then it finalizes rows [lo, hi) of the block
// from the split's partials through distributed shared memory,
// O = sum_g w_g O_g / sum_g w_g l_g with w_g = 2^(m_g - max_g m_g) (weights
// in wts), and writes their first `cols` columns at ob (the block's first
// row and column; row stride ro). `rows`: the block's rows before nq.
template <int D>
__device__ __forceinline__ void f32_merge(float (&acc)[F32<D>::OR][F32<D>::OC],
                                          float (&m)[F32<D>::SR], float (&l)[F32<D>::SR],
                                          float* part_o, float* part_m, float* part_l, float* wts,
                                          int rank, int split, int rows, float* ob, long long ro,
                                          int cols) {
  using F = F32<D>;
  constexpr int WROWS = F::WROWS, SR = F::SR, OR = F::OR, OC = F::OC, BQ = F::BQ, LD = F::LD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 2, kg = lane & 3, RG = lane >> 3, cg = lane & 7;
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  __syncthreads();
#pragma unroll
  for (int x = 0; x < OR; ++x) {
    float* row = part_o + (warp * WROWS + OR * RG + x) * LD;
    if constexpr (D == 16) {
      *reinterpret_cast<float2*>(row + o_col<D>(cg, 0)) = make_float2(acc[x][0], acc[x][1]);
    } else {
#pragma unroll
      for (int c4 = 0; c4 < OC / 4; ++c4)
        *reinterpret_cast<float4*>(row + o_col<D>(cg, 4 * c4)) =
            make_float4(acc[x][4 * c4], acc[x][4 * c4 + 1], acc[x][4 * c4 + 2], acc[x][4 * c4 + 3]);
    }
  }
  if (kg == 0) {
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      part_m[warp * WROWS + SR * rg + i] = m[i];
      part_l[warp * WROWS + SR * rg + i] = l[i];
    }
  }
  cluster_sync<true>();  // every CTA's partials are written

  const int lo = rank * BQ / split;
  const int hi = min((rank + 1) * BQ / split, rows);
  const uint32_t m_at = smem_u32(part_m), l_at = smem_u32(part_l), o_at = smem_u32(part_o);
  for (int r = lo + tid; r < hi; r += F_THREADS) {
    float mx = -INFINITY;
    for (int g = 0; g < split; ++g) mx = fmaxf(mx, ld_cluster(cluster_addr(m_at + 4 * r, g)));
    float sum = 0.f;
    for (int g = 0; g < split; ++g) {
      const float wg = fast_exp2(ld_cluster(cluster_addr(m_at + 4 * r, g)) - mx);
      sum = fmaf(wg, ld_cluster(cluster_addr(l_at + 4 * r, g)), sum);
      wts[(r - lo) * split + g] = wg;
    }
    const float inv = 1.f / sum;  // >= 1: the largest max's partial sum holds 2^0
    for (int g = 0; g < split; ++g) wts[(r - lo) * split + g] *= inv;
  }
  __syncthreads();
  for (int e = tid; e < (hi - lo) * (cols / 4); e += F_THREADS) {
    const int r = lo + e / (cols / 4), c4 = e % (cols / 4);
    float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 0; g < split; ++g) {
      const float wg = wts[(r - lo) * split + g];
      const float4 pv = ld_cluster4(cluster_addr(o_at + 4 * (r * LD + 4 * c4), g));
      out.x = fmaf(wg, pv.x, out.x);
      out.y = fmaf(wg, pv.y, out.y);
      out.z = fmaf(wg, pv.z, out.z);
      out.w = fmaf(wg, pv.w, out.w);
    }
    *reinterpret_cast<float4*>(ob + r * ro + 4 * c4) = out;
  }
  cluster_sync<false>();  // no CTA leaves while a peer still reads its shared memory
}

template <int D>
__global__ void __launch_bounds__(F_THREADS, 3)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, Strides sq, Strides sk,
             Strides sv, Strides so, int heads, int nq, int nk, int split, float scale_log2) {
  using F = F32<D>;
  constexpr int WROWS = F::WROWS, SR = F::SR, OR = F::OR, OC = F::OC, BQ = F::BQ, LD = F::LD;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;
  float* ring = Qs + F::Q_FLOATS;
  float* Ps = ring + F_STAGES * F::TILE_FLOATS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int blocks = (nq + BQ - 1) / BQ;
  const int cl = blockIdx.x / split;  // the cluster is (split, 1, 1): its CTAs are consecutive
  const int rank = blockIdx.x - cl * split;
  const int bh = cl / blocks;  // x = ((batch x head, query block), rank)
  const int q0 = (cl - bh * blocks) * BQ;
  const int b = bh / heads, h = bh % heads;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int ntiles = (nk + F_BK - 1) / F_BK;
  const int t0 = rank * ntiles / split;  // this CTA's tiles: [t0, t0 + mine), never empty
  const int mine = (rank + 1) * ntiles / split - t0;

  // Q once and the first F_STAGES - 1 tiles, one copy group each (Q with
  // the first): row r of the block to its staged row (rows past nq copy row
  // nq - 1 and are never stored).
#pragma unroll 4
  for (int e = tid; e < BQ * (D / 4); e += F_THREADS) {
    const int r = e / (D / 4), c4 = e % (D / 4), rho = r % WROWS;
    const int at = r - rho + 8 * (rho & (SR - 1)) + (rho >> (SR == 4 ? 2 : SR == 2 ? 1 : 0));
    copy16(Qs + at * LD + 4 * c4, qb + min(q0 + r, nq - 1) * sq.r + 4 * c4);
  }
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < mine) stage_kv<D>(ring + s * F::TILE_FLOATS, kb, vb, sk.r, sv.r, t0 + s, nk, tid);
    copy_commit();
  }

  const int rg = lane >> 2, kg = lane & 3;
  const float* Qw = Qs + (warp * WROWS + rg) * LD;
  float* Pw = Ps + warp * F::P_FLOATS;
  float acc[OR][OC];
#pragma unroll
  for (int x = 0; x < OR; ++x)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[x][c] = 0.f;
  float m[SR], l[SR];  // per S row: running max (log2 units), this lane's share of the sum
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int it = 0; it < mine; ++it) {
    // Tile it has landed; every warp is done with tile it - 1, whose stage
    // takes tile it + F_STAGES - 1 while this one computes.
    copy_wait<F_STAGES - 2>();
    __syncthreads();
    if (it + F_STAGES - 1 < mine)
      stage_kv<D>(ring + (it + F_STAGES - 1) % F_STAGES * F::TILE_FLOATS, kb, vb, sk.r, sv.r,
                  t0 + it + F_STAGES - 1, nk, tid);
    copy_commit();
    const float* Kt = ring + it % F_STAGES * F::TILE_FLOATS;
    const float* Vt = Kt + F_BK * LD;

    // S = Q K^T: per 4 columns of d, SR + 4 loads of 16 bytes feed 16 SR FMAs.
    float sc[SR][4];
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) sc[i][t] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D / 4; ++c) {
      float4 qv[SR], kv[4];
#pragma unroll
      for (int i = 0; i < SR; ++i) qv[i] = *reinterpret_cast<const float4*>(Qw + 8 * i * LD + 4 * c);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        kv[t] = *reinterpret_cast<const float4*>(Kt + (kg + 4 * t) * LD + 4 * c);
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          sc[i][t] = fmaf(qv[i].x, kv[t].x, sc[i][t]);
          sc[i][t] = fmaf(qv[i].y, kv[t].y, sc[i][t]);
          sc[i][t] = fmaf(qv[i].z, kv[t].z, sc[i][t]);
          sc[i][t] = fmaf(qv[i].w, kv[t].w, sc[i][t]);
        }
    }

    f32_tile<D>(sc, m, l, acc, Pw, Vt, t0 + it, nk, scale_log2, lane);
  }

  // The partials go over Q's staging, their maxima and sums over the ring.
  f32_merge<D>(acc, m, l, Qs, ring, ring + BQ, Ps, rank, split, nq - q0,
               o + b * so.b + h * so.h + q0 * so.r, so.r, D);
}

// Wide heads on the f32 route (see the note at the top): a CTA of four
// 8-row warps owns 32 query rows, one share of the key tiles (the cluster
// split of `attn_fwd_f32`) and one slice of O, up to W_SLICE columns from
// column c0, in the layout of `attn_fwd_f32<256>`. Per key tile it takes
// chunks + 1 steps through one ring of FW_STAGES stages: a chunk step
// stages the block's Q rows and the tile's K rows over 64 columns of d
// (rows of 64 + 4 floats), the last step the tile's V rows over the slice's
// columns (rows of 256 + 4 floats).
constexpr int FW_STAGES = 4;
struct F32Wide {
  using F = F32<W_SLICE>;
  static constexpr int CL = W_CHUNK + 4;                   // staged chunk row (floats)
  static constexpr int CHUNK_FLOATS = (F::BQ + F_BK) * CL;  // Q's rows, then K's
  static constexpr int V_FLOATS = F_BK * F::LD;
  static constexpr int STAGE_FLOATS = CHUNK_FLOATS > V_FLOATS ? CHUNK_FLOATS : V_FLOATS;
  static constexpr int SMEM = 4 * (FW_STAGES * STAGE_FLOATS + F_WARPS * F::P_FLOATS);
  static_assert(F::BQ * F::LD + 2 * F::BQ <= FW_STAGES * STAGE_FLOATS, "the partials fit the ring");
  static_assert(F::BQ + F_MAX_SPLIT <= F_WARPS * F::P_FLOATS, "weights fit P");
};

// Registers for two CTAs an SM (up to 255 a thread): at three (168) the
// loop state beside the O accumulators spills.
__global__ void __launch_bounds__(F_THREADS, 2)
attn_fwd_f32_wide(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, Strides sq, Strides sk,
                  Strides sv, Strides so, int heads, int nq, int nk, int chunks, int slices,
                  int split, float scale_log2) {
  using F = F32<W_SLICE>;
  using W = F32Wide;
  constexpr int WROWS = F::WROWS, OR = F::OR, OC = F::OC, BQ = F::BQ, CL = W::CL;
  static_assert(F::SR == 1, "one S row a lane");
  extern __shared__ __align__(16) float fsm[];
  float* ring = fsm;
  float* Ps = ring + FW_STAGES * W::STAGE_FLOATS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int blocks = (nq + BQ - 1) / BQ;
  const int cl = blockIdx.x / split;  // the cluster is (split, 1, 1): its CTAs are consecutive
  const int rank = blockIdx.x - cl * split;
  int x = cl;  // x = (((batch x head, slice), query block), rank)
  const int q0 = x % blocks * BQ;
  x /= blocks;
  const int c0 = x % slices * W_SLICE;
  const int bh = x / slices;
  const int b = bh / heads, h = bh % heads;
  const int cols = min(W_SLICE, chunks * W_CHUNK - c0);  // this slice's columns
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h + c0;
  const int ntiles = (nk + F_BK - 1) / F_BK;
  const int t0 = rank * ntiles / split;
  const int mine = (rank + 1) * ntiles / split - t0;
  const int per = chunks + 1;  // steps a tile: its d-chunks of Q K^T, then its V slice
  const int steps = mine * per;

  // Step n into stage n % FW_STAGES, every thread its 16-byte copies; rows
  // past nq or nk copy the last row (finite; masked or never stored).
  auto stage = [&](int n) {
    float* dst = ring + n % FW_STAGES * W::STAGE_FLOATS;
    const int tile = t0 + n / per, c = n % per;
    if (c < chunks) {
      for (int e = tid; e < (BQ + F_BK) * (W_CHUNK / 4); e += F_THREADS) {
        const int row = e / (W_CHUNK / 4), c4 = e % (W_CHUNK / 4);
        const float* src = row < BQ ? qb + min(q0 + row, nq - 1) * sq.r
                                    : kb + min(tile * F_BK + row - BQ, nk - 1) * sk.r;
        copy16(dst + row * CL + 4 * c4, src + c * W_CHUNK + 4 * c4);
      }
    } else {
      for (int e = tid; e < F_BK * (cols / 4); e += F_THREADS) {
        const int row = e / (cols / 4), c4 = e % (cols / 4);
        copy16(dst + row * F::LD + 4 * c4, vb + min(tile * F_BK + row, nk - 1) * sv.r + 4 * c4);
      }
    }
  };
  for (int s = 0; s < FW_STAGES - 1; ++s) {
    if (s < steps) stage(s);
    copy_commit();
  }

  const int rg = lane >> 2, kg = lane & 3;
  float* Pw = Ps + warp * F::P_FLOATS;
  // Between a tile's chunk steps this lane's 4 scores wait in its own 4
  // slots of P (row rg, keys kg + 4t: where its probabilities go), not in
  // registers, which the O accumulators fill.
  float* Sw = Pw + kg * WROWS + rg;
  float acc[OR][OC];
#pragma unroll
  for (int i = 0; i < OR; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  float m[1] = {-INFINITY}, l[1] = {0.f};
  for (int n = 0; n < steps; ++n) {
    copy_wait<FW_STAGES - 2>();
    __syncthreads();  // step n has landed; every warp is done with step n - 1's stage
    if (n + FW_STAGES - 1 < steps) stage(n + FW_STAGES - 1);
    copy_commit();
    const float* st = ring + n % FW_STAGES * W::STAGE_FLOATS;
    const int c = n % per;
    if (c == chunks) {
      float sc[1][4];
#pragma unroll
      for (int t = 0; t < 4; ++t) sc[0][t] = Sw[4 * t * WROWS];
      f32_tile<W_SLICE>(sc, m, l, acc, Pw, st, t0 + n / per, nk, scale_log2, lane);
      continue;
    }
    // S += Q K^T over this chunk: per 4 columns, 5 loads of 16 bytes feed 16
    // FMAs. Each chunk is summed from zero and added to S, so no FMA chain
    // is longer than 64 terms plus the chunks.
    const float* Qw = st + (warp * WROWS + rg) * CL;
    const float* Kt = st + BQ * CL;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int cc = 0; cc < W_CHUNK / 4; ++cc) {
      const float4 qv = *reinterpret_cast<const float4*>(Qw + 4 * cc);
      float4 kv[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        kv[t] = *reinterpret_cast<const float4*>(Kt + (kg + 4 * t) * CL + 4 * cc);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        part[t] = fmaf(qv.x, kv[t].x, part[t]);
        part[t] = fmaf(qv.y, kv[t].y, part[t]);
        part[t] = fmaf(qv.z, kv[t].z, part[t]);
        part[t] = fmaf(qv.w, kv[t].w, part[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) Sw[4 * t * WROWS] = c == 0 ? part[t] : Sw[4 * t * WROWS] + part[t];
  }

  // The partials and their maxima and sums go over the ring.
  f32_merge<W_SLICE>(acc, m, l, ring, ring + BQ * F::LD, ring + BQ * F::LD + BQ, Ps, rank, split,
                     nq - q0, o + b * so.b + h * so.h + q0 * so.r + c0, so.r, cols);
}

// Per card and width: the SM count and the most clusters of each size that
// can be resident at once (cudaOccupancyMaxActiveClusters), read at the
// first launch.
struct F32Card {
  bool ready;
  int sms;
  int clusters[F_MAX_SPLIT + 1];
};
std::mutex f32_cards_lock;

// `cards[dev]` for the f32 kernel `kernel` with `smem` bytes of shared memory.
template <typename Kernel>
cudaError_t f32_card_of(Kernel kernel, int smem, F32Card* cards, int dev, const F32Card** out) {
  std::lock_guard<std::mutex> guard(f32_cards_lock);
  F32Card& c = cards[dev];
  if (!c.ready) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    for (int g = 1; g <= F_MAX_SPLIT && err == cudaSuccess; ++g) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = g;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cfg.gridDim = dim3(g, 1, 1);
      cfg.blockDim = dim3(F_THREADS, 1, 1);
      cfg.dynamicSmemBytes = smem;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&c.clusters[g], kernel, &cfg);
    }
    if (err != cudaSuccess) return err;
    c.ready = true;
  }
  *out = &c;
  return cudaSuccess;
}

template <int D>
cudaError_t f32_card(int dev, const F32Card** out) {
  static F32Card cards[MAX_DEVICES];
  return f32_card_of(attn_fwd_f32<D>, F32<D>::SMEM, cards, dev, out);
}

cudaError_t f32_wide_card(int dev, const F32Card** out) {
  static F32Card cards[MAX_DEVICES];
  return f32_card_of(attn_fwd_f32_wide, F32Wide::SMEM, cards, dev, out);
}

// The card's counts for the f32 route at width d (an instantiation, or a
// wide width).
cudaError_t f32_card_at(long long d, int dev, const F32Card** out) {
  switch (d) {
    case 16: return f32_card<16>(dev, out);
    case 32: return f32_card<32>(dev, out);
    case 64: return f32_card<64>(dev, out);
    case 128: return f32_card<128>(dev, out);
    case 256: return f32_card<256>(dev, out);
    default: return d > MAX_D ? f32_wide_card(dev, out) : cudaErrorInvalidValue;
  }
}

// The split (cluster size) for `blocks` query blocks over `ntiles` key
// tiles: the one with the least estimated time. Clusters run in waves of as
// many as the card holds; a wave takes a CTA's tiles times (the CTAs its
// busiest SM holds + 0.3), plus 3.6 tiles for the prologue and the merge, in
// tenths of a tile (fitted to the H100's times over splits 1-8 at the
// encoder, decoder and training shapes, d = 64).
int f32_split(const F32Card& c, long long blocks, int ntiles) {
  int best = 1;
  long long best_cost = -1;
  for (int g = 1; g <= F_MAX_SPLIT && g <= ntiles; ++g) {
    const long long cap = c.clusters[g];
    if (cap <= 0) continue;
    const long long tiles = (ntiles + g - 1) / g;
    long long cost = 0;
    for (long long left = blocks; left > 0; left -= cap) {
      const long long per_sm = ((left < cap ? left : cap) * g + c.sms - 1) / c.sms;
      cost += tiles * (10 * per_sm + 3) + 36;
    }
    if (best_cost < 0 || cost < best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
}

int f32_rows(long long d) {
  return d > 128 ? F32<256>::BQ : d > 64 ? F32<128>::BQ : F32<64>::BQ;
}

// O's column slices at head width d (one below the wide widths).
long long slices_at(long long d) { return d > MAX_D ? (d + W_SLICE - 1) / W_SLICE : 1; }

// Launches an f32 kernel on `blocks` clusters of `split` CTAs each.
template <typename... KArgs, typename... Args>
int launch_split(void (*kernel)(KArgs...), int smem, long long blocks, int split,
                 cudaStream_t stream, Args... args) {
  if (blocks * split > INT_MAX) return 1000;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(blocks * split), 1, 1);
  cfg.blockDim = dim3(F_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The split for `blocks` clusters over nk keys on `card`.
int split_for(const F32Card& card, long long blocks, int nk) {
#ifdef F32_SPLIT  // a profiling build fixes the split (scripts/profile_f32_attention.py)
  (void)card;
  (void)blocks;
  return min(F32_SPLIT, (nk + F_BK - 1) / F_BK);
#else
  return f32_split(card, blocks, (nk + F_BK - 1) / F_BK);
#endif
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, const Strides* st,
               int batch, int heads, int nq, int nk, float scale_log2, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  const F32Card* card = nullptr;
  err = f32_card<D>(dev, &card);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((nq + F32<D>::BQ - 1) / F32<D>::BQ) * batch * heads;
  const int split = split_for(*card, blocks, nk);
  return launch_split(attn_fwd_f32<D>, F32<D>::SMEM, blocks, split, stream,
                      static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<float*>(o), st[0], st[1], st[2],
                      st[3], heads, nq, nk, split, scale_log2);
}

int launch_f32_wide(const void* q, const void* k, const void* v, void* o, const Strides* st,
                    int batch, int heads, int nq, int nk, int d, float scale_log2,
                    cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  const F32Card* card = nullptr;
  err = f32_wide_card(dev, &card);
  if (err != cudaSuccess) return (int)err;
  const int slices = (int)slices_at(d);
  const long long blocks =
      (long long)((nq + F32<W_SLICE>::BQ - 1) / F32<W_SLICE>::BQ) * slices * batch * heads;
  const int split = split_for(*card, blocks, nk);
  return launch_split(attn_fwd_f32_wide, F32Wide::SMEM, blocks, split, stream,
                      static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<float*>(o), st[0], st[1], st[2],
                      st[3], heads, nq, nk, d / W_CHUNK, slices, split, scale_log2);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, const Strides* st, int batch,
           int heads, int nq, int nk, float scale_log2, long long dtype, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<D>(q, k, v, o, st, batch, heads, nq, nk, scale_log2, stream);
  if (dtype == 1) return launch_bf16<D>(q, k, v, o, st, batch, heads, nq, nk, scale_log2, stream);
  return 1000;
}

}  // namespace

// The arguments of one call, packed by the wrapper into 28 int64 values, so
// that the host pays for one foreign argument instead of thirteen.
struct AttnArgs {
  long long q, k, v, o;        // device pointers
  long long stride[4][4];      // (batch, head, row, dim) element strides of q, k, v, o
  long long batch, heads, nq, nk, d;
  long long d_scale;           // the true head width, whose d^-1/2 scales the logits (<= d)
  long long dtype;             // 0 = float32 (FP32 pipe), 1 = bfloat16 (tensor cores)
  long long stream;            // cudaStream_t
};

// q (B, H, nq, d), k and v (B, H, nk, d), o (B, H, nq, d), each addressed
// through its own strides, d one of 16, 32, 64, 128 and 256 (a narrower head
// zero-padded to it by the caller, which passes its true width as d_scale)
// or any wider multiple of 64 (the wide variants; a wider head zero-padded
// to the next multiple by the caller). Every operand's last dimension must
// be contiguous; in bfloat16, q, k and v must also start 16-byte aligned with
// every other stride a multiple of 8 elements, which a tensor map needs; in
// float32, all four must start 16-byte aligned with every other stride a
// multiple of 4 elements, which the bulk copies and 16-byte stores need (the
// stride of a dimension of size 1 is never read, and is not checked).
// Returns a cudaError_t (0 on success); 1000 for arguments or a layout this
// kernel does not take, 1001 when a TMA descriptor cannot be encoded.
extern "C" int attn_forward(const AttnArgs* a) {
  const long long d = a->d;
  const bool wide = d > MAX_D && d % W_CHUNK == 0;
  if ((!wide && d != 16 && d != 32 && d != 64 && d != 128 && d != MAX_D) || d > INT_MAX ||
      a->d_scale < 1 || a->d_scale > d || a->batch <= 0 || a->heads <= 0 || a->nq <= 0 ||
      a->nk <= 0 || a->batch > INT_MAX || a->heads > INT_MAX || a->nq > INT_MAX ||
      a->nk > INT_MAX)
    return 1000;
  const int batch = (int)a->batch, heads = (int)a->heads, nq = (int)a->nq, nk = (int)a->nk;
  const long long ptr[4] = {a->q, a->k, a->v, a->o};
  Strides st[4];
  for (int i = 0; i < 4; ++i) {
    if (a->stride[i][3] != 1) return 1000;
    const int rows = i == 1 || i == 2 ? nk : nq;
    st[i] = Strides{batch > 1 ? a->stride[i][0] : d, heads > 1 ? a->stride[i][1] : d,
                    rows > 1 ? a->stride[i][2] : d};
    if (a->dtype == 1 && i < 3 && ((ptr[i] & 15) || (st[i].b & 7) || (st[i].h & 7) || (st[i].r & 7)))
      return 1000;
    if (a->dtype == 0 && ((ptr[i] & 15) || (st[i].b & 3) || (st[i].h & 3) || (st[i].r & 3)))
      return 1000;
  }
  const void* q = (const void*)a->q;
  const void* k = (const void*)a->k;
  const void* v = (const void*)a->v;
  void* o = (void*)a->o;
  cudaStream_t s = (cudaStream_t)a->stream;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)a->d_scale);
  if (wide) {
    if (a->dtype == 0)
      return launch_f32_wide(q, k, v, o, st, batch, heads, nq, nk, (int)d, scale_log2, s);
    if (a->dtype == 1)
      return launch_bf16_wide(q, k, v, o, st, batch, heads, nq, nk, (int)d, scale_log2, s);
    return 1000;
  }
  switch (d) {
    case 16: return launch<16>(q, k, v, o, st, batch, heads, nq, nk, scale_log2, a->dtype, s);
    case 32: return launch<32>(q, k, v, o, st, batch, heads, nq, nk, scale_log2, a->dtype, s);
    case 64: return launch<64>(q, k, v, o, st, batch, heads, nq, nk, scale_log2, a->dtype, s);
    case 128: return launch<128>(q, k, v, o, st, batch, heads, nq, nk, scale_log2, a->dtype, s);
    default: return launch<256>(q, k, v, o, st, batch, heads, nq, nk, scale_log2, a->dtype, s);
  }
}

// The split (cluster size) the f32 route takes for batch x heads = bh, these
// token counts and head width d (an instantiation or a wide width) on the
// current card; a negative cudaError_t if the card cannot be queried.
extern "C" int attn_f32_split(long long bh, long long nq, long long nk, int d) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  const F32Card* card = nullptr;
  if (err == cudaSuccess) err = f32_card_at(d, dev, &card);
  if (err != cudaSuccess) return -(int)err;
  const int rows = f32_rows(d);
  return f32_split(*card, (nq + rows - 1) / rows * bh * slices_at(d),
                   (int)((nk + F_BK - 1) / F_BK));
}

// How many clusters of `split` CTAs (1-8) of the f32 route at head width d
// the current card holds at once, which the choice of split reads; a
// negative cudaError_t if the card cannot be queried.
extern "C" int attn_f32_clusters(int split, int d) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  const F32Card* card = nullptr;
  if (err == cudaSuccess) err = f32_card_at(d, dev, &card);
  if (err != cudaSuccess) return -(int)err;
  return split >= 1 && split <= F_MAX_SPLIT ? card->clusters[split] : 0;
}
