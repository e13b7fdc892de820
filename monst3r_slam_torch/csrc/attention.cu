// Kernel A: fused softmax attention forward, O = softmax(Q K^T d^-1/2) V, d = 64.
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
//   - S = Q K^T is a chain of four wgmma m64n64k16 (bf16 x bf16 -> f32); Q and
//     the K tile come from shared memory, both K-major.
//   - O += P V takes P from registers, rounded to bf16 (the reference's
//     rounding point), and the V tile from shared memory (B transposed,
//     MN-major): the S accumulator's register layout is the A fragment's.
//   - A CTA owns 64 query rows, the m64 of one wgmma. At 768 tokens the grid
//     is 12 x 16 = 192 CTAs (encoder) or 12 x 12 = 144 (decoder); a CTA holds
//     ~73 KB of shared memory, so two fit on an SM and the grid runs in one
//     wave on the 132 SMs. So small a grid leaves the SM's units mostly idle
//     while one CTA walks its chain of key tiles: two warpgroups share the
//     CTA's query rows and take every other key tile, each with its own ring
//     and softmax state, and merge at the end, which halves the chain.
//   - TMA loads Q once and K/V through a 2-stage ring per warpgroup, completing on
//     mbarriers, with the 128-byte swizzle (64 bf16 values are exactly one
//     128-byte row); the wgmma descriptors name the same swizzle. The tensor
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
//     holds a 4x4 block of S and, all along, an 8x8 block of O. S = Q K^T
//     reads Q and K as 16-byte loads along d (8 loads for 64 FFMA), O += P V
//     reads P and V as 16-byte loads along the rows and columns (4 loads for
//     64 FFMA): one shared load per 10.7 FFMA over the tile. The staged rows
//     are padded to 68 floats, and Q's rows are staged in the order the S
//     loads read them, so that no load has a bank conflict; P goes through a
//     key-major slice of shared memory per warp.
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
//     16 tiles, two or one per SM).
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
// Launches on the caller's stream and returns the launch's cudaGetLastError().

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace {

constexpr int D = 64;  // head dim

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
constexpr int STAGES = 2;       // K/V ring of each warpgroup
constexpr int TILE_ELEMS = 64 * D;
constexpr int TILE_BYTES = TILE_ELEMS * 2;  // 8 KB: 64 rows of one 128-byte swizzled line
constexpr int NBAR = 1 + NWG * STAGES;      // Q, then one per (warpgroup, stage)
constexpr int SMEM_TC = (1 + 2 * NWG * STAGES) * TILE_BYTES + 8 * NBAR + 1024;  // + align slack
constexpr int MERGE_FLOATS = 36;  // per thread: 32 accumulators, 2 maxima, 2 partial sums
static_assert(MERGE_FLOATS * 128 * 4 <= 2 * STAGES * TILE_BYTES, "merge fits one ring");

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

// One 64-row x 64-column box of a (batch, head, row, d) tensor into shared
// memory, 128-byte swizzled; completes `bytes` on `bar`.
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(head), "r"(batch),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory matrix descriptor for a 64-row tile of 128-byte rows
// in the 128-byte swizzle: start address, leading offset 16 B (unused: the
// operand's 64-element width is one swizzle atom), stride offset 1024 B
// between groups of 8 rows, layout type 1 (128-byte swizzle). The tile base
// is 1024-byte aligned, so advancing the start by 32 B steps 16 columns
// (K-major) and by 2048 B steps 16 rows (MN-major).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
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
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_ACC32(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// d (+)= A B, A and B both from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A from registers (four bf16x2 per thread), B from shared memory
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_bt(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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
// leaving registers.
//
// The problem is small (12 key tiles per 64 queries at 768 tokens, one or
// two CTAs per SM), so a CTA's serial chain of tiles leaves the SM's units
// idle between its steps. Two warpgroups therefore share the CTA's 64 query
// rows and split its key tiles (warpgroup g takes tiles g, g + 2, ...), each
// with its own K/V ring, running max, sum and accumulator; at the end
// warpgroup 1 hands its state to warpgroup 0 through shared memory, which
// merges the two and stores O.
__global__ void __launch_bounds__(NTHREAD, 2)
attn_fwd_bf16_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                 Strides so, int heads, int nq, int nk, float scale_log2) {
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
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * BM;
  const int ntiles = (nk + BN - 1) / BN;
  const int mine = (ntiles - wg + NWG - 1) / NWG;  // tiles of this warpgroup
  __nv_bfloat16* sK = ring(wg);
  __nv_bfloat16* sV = sK + STAGES * TILE_ELEMS;
  uint64_t* kv_bar = bar + 1 + STAGES * wg;

  if (tid == 0) {
    for (int i = 0; i < NBAR; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(&bar[0], TILE_BYTES);
    tma_load_tile(sQ, &tq, &bar[0], q0, h, b);
    for (int g = 0; g < NWG; ++g) {
      for (int s = 0; s < STAGES; ++s) {
        const int j = NWG * s + g;
        if (j >= ntiles) break;
        __nv_bfloat16* kg = ring(g);
        mbar_expect_tx(&bar[1 + STAGES * g + s], 2 * TILE_BYTES);
        tma_load_tile(kg + s * TILE_ELEMS, &tk, &bar[1 + STAGES * g + s], j * BN, h, b);
        tma_load_tile(kg + (STAGES + s) * TILE_ELEMS, &tv, &bar[1 + STAGES * g + s], j * BN, h,
                      b);
      }
    }
  }
  __syncthreads();

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0, r1 (log2 units)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the running sums
  const uint64_t dq = sw128_desc(sQ);
  const int col0 = 2 * (lane & 3);
  mbar_wait(&bar[0], 0);

  for (int i = 0; i < mine; ++i) {
    const int j = NWG * i + wg;  // global key tile
    const int s = i % STAGES;
    mbar_wait(&kv_bar[s], (i / STAGES) & 1);
    const __nv_bfloat16* kt = sK + s * TILE_ELEMS;
    const __nv_bfloat16* vt = sV + s * TILE_ELEMS;

    // S = Q K^T over d = 64: four k16 steps of 32 bytes along the rows.
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    const uint64_t dk = sw128_desc(kt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(sc, dq + 2 * kk, dk + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // Online softmax in log2 units: the max is taken on the raw scores (the
    // scale is positive) and each probability is one FFMA and one MUFU op.
    // Keys at or past nk count as -inf; only a ragged last tile has any.
    if (j * BN + BN > nk) {
      const int kbase = j * BN + col0;
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
    for (int n = 0; n < 8; ++n) {
      acc[4 * n] *= c0;
      acc[4 * n + 1] *= c0;
      acc[4 * n + 2] *= c1;
      acc[4 * n + 3] *= c1;
    }

    // P rounded to bf16, as A fragments of four k16 steps over the tile's keys.
    uint32_t pa[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      pa[c][0] = pack_bf16x2(sc[8 * c + 0], sc[8 * c + 1]);  // r0, keys 16c + col0
      pa[c][1] = pack_bf16x2(sc[8 * c + 2], sc[8 * c + 3]);  // r1
      pa[c][2] = pack_bf16x2(sc[8 * c + 4], sc[8 * c + 5]);  // r0, keys 16c + 8 + col0
      pa[c][3] = pack_bf16x2(sc[8 * c + 6], sc[8 * c + 7]);  // r1
    }

    // O += P V: V's rows are keys, its 64 columns contiguous (MN-major B).
    const uint64_t dv = sw128_desc(vt);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) wgmma_rs_bt(acc, pa[c], dv + c * (16 * 128 / 16));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    warpgroup_sync(wg);  // all four warps are done with stage s
    if (wtid == 0 && i + STAGES < mine) {
      const int jn = j + NWG * STAGES;
      mbar_expect_tx(&kv_bar[s], 2 * TILE_BYTES);
      tma_load_tile(sK + s * TILE_ELEMS, &tk, &kv_bar[s], jn * BN, h, b);
      tma_load_tile(sV + s * TILE_ELEMS, &tv, &kv_bar[s], jn * BN, h, b);
    }
  }

  // Warpgroup 1 hands (acc, m, l) to warpgroup 0 through its own ring, which
  // it no longer reads; same thread index, same rows and columns.
  float* merge = reinterpret_cast<float*>(ring(1));
  if (wg == 1) {
#pragma unroll
    for (int e = 0; e < 32; ++e) merge[e * 128 + wtid] = acc[e];
    merge[32 * 128 + wtid] = m0;
    merge[33 * 128 + wtid] = m1;
    merge[34 * 128 + wtid] = l0;
    merge[35 * 128 + wtid] = l1;
  }
  __syncthreads();
  if (wg == 1) return;
  {
    const float om0 = merge[32 * 128 + wtid], om1 = merge[33 * 128 + wtid];
    const float n0 = fmaxf(m0, om0), n1 = fmaxf(m1, om1);  // finite: tile 0 is warpgroup 0's
    const float a0 = fast_exp2(m0 - n0), a1 = fast_exp2(m1 - n1);
    const float b0 = fast_exp2(om0 - n0), b1 = fast_exp2(om1 - n1);  // 0 for a warpgroup with no tile
    l0 = l0 * a0 + merge[34 * 128 + wtid] * b0;
    l1 = l1 * a1 + merge[35 * 128 + wtid] * b1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[4 * n] = acc[4 * n] * a0 + merge[(4 * n) * 128 + wtid] * b0;
      acc[4 * n + 1] = acc[4 * n + 1] * a0 + merge[(4 * n + 1) * 128 + wtid] * b0;
      acc[4 * n + 2] = acc[4 * n + 2] * a1 + merge[(4 * n + 2) * 128 + wtid] * b1;
      acc[4 * n + 3] = acc[4 * n + 3] * a1 + merge[(4 * n + 3) * 128 + wtid] * b1;
    }
  }

  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
  const int r0 = q0 + 16 * warp + (lane >> 2), r1 = r0 + 8;
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
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

// A (batch, head, row, 64) bf16 tensor with the given element strides, read
// in 64-row boxes with the 128-byte swizzle; rows past `rows` read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, const Strides& st, int rows, int heads,
              int batch) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.r * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)D, (cuuint32_t)BN, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor maps already encoded, direct-mapped on everything the encoding
// reads (address, extents, strides), so an entry is valid for any tensor with
// that key: the caching allocator hands the same buffers to the same calls
// frame after frame, and a hit skips the encode on the host.
struct MapEntry {
  CUtensorMap map;
  long long key[7];
  bool valid;
};
constexpr int MAP_CACHE = 1024;
MapEntry map_cache[MAP_CACHE];
std::mutex map_cache_lock;  // ctypes drops the GIL: callers may be concurrent

bool cached_map(CUtensorMap* map, const void* ptr, const Strides& st, int rows, int heads,
                int batch) {
  const long long key[7] = {(long long)(uintptr_t)ptr, rows, heads, batch, st.b, st.h, st.r};
  uint64_t hash = 1469598103934665603ull;  // FNV-1a over the key's words
  for (long long w : key) hash = (hash ^ (uint64_t)w) * 1099511628211ull;
  std::lock_guard<std::mutex> guard(map_cache_lock);
  MapEntry& e = map_cache[(hash >> 32) % MAP_CACHE];
  if (!e.valid || memcmp(e.key, key, sizeof key) != 0) {
    e.valid = make_map(&e.map, ptr, st, rows, heads, batch);
    if (!e.valid) return false;
    memcpy(e.key, key, sizeof key);
  }
  *map = e.map;
  return true;
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, const Strides* st,
                int batch, int heads, int nq, int nk, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!cached_map(&tq, q, st[0], nq, heads, batch) ||
      !cached_map(&tk, k, st[1], nk, heads, batch) || !cached_map(&tv, v, st[2], nk, heads, batch))
    return 1001;
  static bool configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(attn_fwd_bf16_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_TC);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const dim3 grid((nq + BM - 1) / BM, batch * heads);
  attn_fwd_bf16_tc<<<grid, NTHREAD, SMEM_TC, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st[3], heads, nq, nk,
      1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ f32 route
//
// Register-tiled f32 attention on the FP32 pipe (see the note at the top).
// A CTA of four warps owns 128 query rows, 32 per warp, and one share of the
// key tiles; the `split` CTAs of a cluster take the shares of one 128-row
// block and merge their partial (O, max, sum) through distributed shared
// memory at the end.
//
// Lane layouts of a warp (lane = 4 rg + kg = 8 RG + cg):
//   S = Q K^T, 32 rows x 16 keys: rows 4 rg + i (i < 4), keys kg + 4 t (t < 4).
//   O, 32 rows x 64 columns: rows 8 RG + x (x < 8), columns 4 cg + c and
//   32 + 4 cg + c (c < 4).
// O row 8 RG + 4 h + i is S row 4 (2 RG + h) + i, held by lane
// 8 RG + 4 h + (cg & 3): one shuffle per row hands a rescale to the O lanes.
// Q row 4 rg + i of warp w is staged at row 32 w + 8 i + rg, so the eight rows
// of one S load sit in eight different bank groups.

constexpr int F_WARPS = 4;
constexpr int F_THREADS = 32 * F_WARPS;
constexpr int F_WROWS = 32;                       // query rows per warp
constexpr int F_BQ = F_WARPS * F_WROWS;           // query rows per CTA
constexpr int F_BK = 16;                          // keys per staged tile
constexpr int F_STAGES = 3;                       // K/V ring depth
constexpr int F_LD = D + 4;                       // staged row stride (floats): 68
constexpr int F_MAX_SPLIT = 8;                    // portable cluster size
constexpr int F_Q_FLOATS = F_BQ * F_LD;
constexpr int F_TILE_FLOATS = 2 * F_BK * F_LD;    // a tile's 16 K rows, then its 16 V rows
constexpr int F_P_FLOATS = F_BK * F_WROWS;        // a warp's P, key-major
constexpr int F_SMEM = 4 * (F_Q_FLOATS + F_STAGES * F_TILE_FLOATS + F_WARPS * F_P_FLOATS);
// The merge reuses the staging: partial O over Q's rows, max and sum over the
// ring, each row's weights over P.
static_assert(2 * F_BQ <= F_STAGES * F_TILE_FLOATS, "max and sum fit the ring");
static_assert(F_BQ + F_MAX_SPLIT <= F_WARPS * F_P_FLOATS, "weights fit P");

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
// then 16 V rows, each 16 chunks of 16 bytes: 4 chunks a thread). Rows past
// nk copy row nk - 1, so the tile holds finite values; their keys are masked.
__device__ __forceinline__ void stage_kv(float* dst, const float* kb, const float* vb,
                                         long long kr, long long vr, int tile, int nk, int tid) {
#pragma unroll
  for (int e = tid; e < 2 * F_BK * (D / 4); e += F_THREADS) {
    const int row = e / (D / 4), c4 = e % (D / 4);
    const int key = min(tile * F_BK + row % F_BK, nk - 1);
    copy16(dst + row * F_LD + 4 * c4, (row < F_BK ? kb + key * kr : vb + key * vr) + 4 * c4);
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

__global__ void __launch_bounds__(F_THREADS, 3)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, Strides sq, Strides sk,
             Strides sv, Strides so, int heads, int nq, int nk, int split, float scale_log2) {
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;
  float* ring = Qs + F_Q_FLOATS;
  float* Ps = ring + F_STAGES * F_TILE_FLOATS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = blockIdx.x % split;  // the cluster is (split, 1, 1): its CTAs are consecutive
  const int q0 = blockIdx.x / split * F_BQ;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
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
  for (int e = tid; e < F_BQ * (D / 4); e += F_THREADS) {
    const int r = e / (D / 4), c4 = e % (D / 4), rho = r % F_WROWS;
    const int at = r - rho + 8 * (rho & 3) + (rho >> 2);
    copy16(Qs + at * F_LD + 4 * c4, qb + min(q0 + r, nq - 1) * sq.r + 4 * c4);
  }
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < mine) stage_kv(ring + s * F_TILE_FLOATS, kb, vb, sk.r, sv.r, t0 + s, nk, tid);
    copy_commit();
  }

  const int rg = lane >> 2, kg = lane & 3, RG = lane >> 3, cg = lane & 7;
  const float* Qw = Qs + (warp * F_WROWS + rg) * F_LD;
  float* Pw = Ps + warp * F_P_FLOATS;
  float acc[8][8];
#pragma unroll
  for (int x = 0; x < 8; ++x)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[x][c] = 0.f;
  float m[4], l[4];  // per S row: running max (log2 units), this lane's share of the sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int it = 0; it < mine; ++it) {
    // Tile it has landed; every warp is done with tile it - 1, whose stage
    // takes tile it + F_STAGES - 1 while this one computes.
    copy_wait<F_STAGES - 2>();
    __syncthreads();
    if (it + F_STAGES - 1 < mine)
      stage_kv(ring + (it + F_STAGES - 1) % F_STAGES * F_TILE_FLOATS, kb, vb, sk.r, sv.r,
               t0 + it + F_STAGES - 1, nk, tid);
    copy_commit();
    const float* Kt = ring + it % F_STAGES * F_TILE_FLOATS;
    const float* Vt = Kt + F_BK * F_LD;

    // S = Q K^T: per 4 columns of d, 8 loads of 16 bytes feed 64 FMAs.
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) sc[i][t] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D / 4; ++c) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qw + 8 * i * F_LD + 4 * c);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        kv[t] = *reinterpret_cast<const float4*>(Kt + (kg + 4 * t) * F_LD + 4 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          sc[i][t] = fmaf(qv[i].x, kv[t].x, sc[i][t]);
          sc[i][t] = fmaf(qv[i].y, kv[t].y, sc[i][t]);
          sc[i][t] = fmaf(qv[i].z, kv[t].z, sc[i][t]);
          sc[i][t] = fmaf(qv[i].w, kv[t].w, sc[i][t]);
        }
    }

    // Online softmax in log2 units over the 4 lanes that share a row. Keys at
    // or past nk count as -inf; only a ragged last tile has any, and every
    // tile holds a valid key (its first), so the max is finite.
    const int key0 = (t0 + it) * F_BK + kg;
    if ((t0 + it + 1) * F_BK > nk) {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (key0 + 4 * t >= nk)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[i][t] = -INFINITY;
    }
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
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
    for (int t = 0; t < 4; ++t)
      *reinterpret_cast<float4*>(Pw + (kg + 4 * t) * F_WROWS + 4 * rg) =
          make_float4(sc[0][t], sc[1][t], sc[2][t], sc[3][t]);
    float oc[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      oc[i] = __shfl_sync(0xffffffffu, corr[i], lane & ~4);
      oc[4 + i] = __shfl_sync(0xffffffffu, corr[i], lane | 4);
    }
    __syncwarp();  // P is in shared memory

    // O += P V: per key, 4 loads of 16 bytes feed 64 FMAs.
#pragma unroll
    for (int x = 0; x < 8; ++x)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[x][c] *= oc[x];
#pragma unroll
    for (int j = 0; j < F_BK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(Pw + j * F_WROWS + 8 * RG);
      const float4 pb = *reinterpret_cast<const float4*>(Pw + j * F_WROWS + 8 * RG + 4);
      const float4 va = *reinterpret_cast<const float4*>(Vt + j * F_LD + 4 * cg);
      const float4 vc = *reinterpret_cast<const float4*>(Vt + j * F_LD + 32 + 4 * cg);
      const float p[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      const float w[8] = {va.x, va.y, va.z, va.w, vc.x, vc.y, vc.z, vc.w};
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[x][c] = fmaf(p[x], w[c], acc[x][c]);
    }
  }

  // Partial results into this CTA's staging (free once every warp is done
  // with the last tile; no copy in flight): O unnormalized, each row's max
  // and sum.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  __syncthreads();
  float* part_o = Qs;
  float* part_m = ring;
  float* part_l = ring + F_BQ;
  float* wts = Ps;
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    float* row = part_o + (warp * F_WROWS + 8 * RG + x) * F_LD;
    *reinterpret_cast<float4*>(row + 4 * cg) = make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
    *reinterpret_cast<float4*>(row + 32 + 4 * cg) =
        make_float4(acc[x][4], acc[x][5], acc[x][6], acc[x][7]);
  }
  if (kg == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      part_m[warp * F_WROWS + 4 * rg + i] = m[i];
      part_l[warp * F_WROWS + 4 * rg + i] = l[i];
    }
  }
  cluster_sync<true>();  // every CTA's partials are written

  // This CTA finalizes rows [lo, hi) of the block from the split's partials:
  // O = sum_g w_g O_g / sum_g w_g l_g with w_g = 2^(m_g - max_g m_g).
  const int lo = rank * F_BQ / split;
  const int hi = min((rank + 1) * F_BQ / split, nq - q0);
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
  float* ob = o + b * so.b + h * so.h;
  for (int e = tid; e < (hi - lo) * (D / 4); e += F_THREADS) {
    const int r = lo + e / (D / 4), c4 = e % (D / 4);
    float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 0; g < split; ++g) {
      const float wg = wts[(r - lo) * split + g];
      const float4 pv = ld_cluster4(cluster_addr(o_at + 4 * (r * F_LD + 4 * c4), g));
      out.x = fmaf(wg, pv.x, out.x);
      out.y = fmaf(wg, pv.y, out.y);
      out.z = fmaf(wg, pv.z, out.z);
      out.w = fmaf(wg, pv.w, out.w);
    }
    *reinterpret_cast<float4*>(ob + (q0 + r) * so.r + 4 * c4) = out;
  }
  cluster_sync<false>();  // no CTA leaves while a peer still reads its shared memory
}

// Per card: the SM count and the most clusters of each size that can be
// resident at once (cudaOccupancyMaxActiveClusters), read at the first launch.
struct F32Card {
  bool ready;
  int sms;
  int clusters[F_MAX_SPLIT + 1];
};
F32Card f32_cards[MAX_DEVICES];
std::mutex f32_cards_lock;

cudaError_t f32_card(int dev, const F32Card** out) {
  std::lock_guard<std::mutex> guard(f32_cards_lock);
  F32Card& c = f32_cards[dev];
  if (!c.ready) {
    cudaError_t err = cudaFuncSetAttribute(attn_fwd_f32,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_fwd_f32, cudaFuncAttributePreferredSharedMemoryCarveout,
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
      cfg.dynamicSmemBytes = F_SMEM;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&c.clusters[g], attn_fwd_f32, &cfg);
    }
    if (err != cudaSuccess) return err;
    c.ready = true;
  }
  *out = &c;
  return cudaSuccess;
}

// The split (cluster size) for `blocks` 128-row blocks over `ntiles` key
// tiles: the one with the least estimated time. Clusters run in waves of as
// many as the card holds; a wave takes a CTA's tiles times (the CTAs its
// busiest SM holds + 0.3), plus 3.6 tiles for the prologue and the merge, in
// tenths of a tile (fitted to the H100's times over splits 1-8 at the
// encoder, decoder and training shapes).
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

int launch_f32(const void* q, const void* k, const void* v, void* o, const Strides* st,
               int batch, int heads, int nq, int nk, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  const F32Card* card = nullptr;
  err = f32_card(dev, &card);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (nq + F_BQ - 1) / F_BQ;
#ifdef F32_SPLIT  // a profiling build fixes the split (scripts/profile_f32_attention.py)
  const int split = min(F32_SPLIT, (nk + F_BK - 1) / F_BK);
#else
  const int split = f32_split(*card, (long long)blocks * batch * heads, (nk + F_BK - 1) / F_BK);
#endif
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(blocks * split, batch * heads, 1);
  cfg.blockDim = dim3(F_THREADS, 1, 1);
  cfg.dynamicSmemBytes = F_SMEM;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attn_fwd_f32, static_cast<const float*>(q),
                           static_cast<const float*>(k), static_cast<const float*>(v),
                           static_cast<float*>(o), st[0], st[1], st[2], st[3], heads, nq, nk,
                           split, 1.4426950408889634f / sqrtf((float)D));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The arguments of one call, packed by the wrapper into 27 int64 values, so
// that the host pays for one foreign argument instead of twelve.
struct AttnArgs {
  long long q, k, v, o;        // device pointers
  long long stride[4][4];      // (batch, head, row, dim) element strides of q, k, v, o
  long long batch, heads, nq, nk, d;
  long long dtype;             // 0 = float32 (FP32 pipe), 1 = bfloat16 (tensor cores)
  long long stream;            // cudaStream_t
};

// q (B, H, nq, d), k and v (B, H, nk, d), o (B, H, nq, d), each addressed
// through its own strides. Every operand's last dimension must be
// contiguous; in bfloat16, q, k and v must also start 16-byte aligned with
// every other stride a multiple of 8 elements, which a tensor map needs; in
// float32, all four must start 16-byte aligned with every other stride a
// multiple of 4 elements, which the bulk copies and 16-byte stores need (the
// stride of a dimension of size 1 is never read, and is not checked).
// Returns a cudaError_t (0 on success); 1000 for arguments or a layout this
// kernel does not take, 1001 when a TMA descriptor cannot be encoded.
extern "C" int attn_forward(const AttnArgs* a) {
  const int batch = (int)a->batch, heads = (int)a->heads, nq = (int)a->nq, nk = (int)a->nk;
  if (a->d != D || batch <= 0 || heads <= 0 || nq <= 0 || nk <= 0 || batch * heads > 65535)
    return 1000;
  const long long ptr[4] = {a->q, a->k, a->v, a->o};
  Strides st[4];
  for (int i = 0; i < 4; ++i) {
    if (a->stride[i][3] != 1) return 1000;
    const int rows = i == 1 || i == 2 ? nk : nq;
    st[i] = Strides{batch > 1 ? a->stride[i][0] : D, heads > 1 ? a->stride[i][1] : D,
                    rows > 1 ? a->stride[i][2] : D};
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
  if (a->dtype == 0) return launch_f32(q, k, v, o, st, batch, heads, nq, nk, s);
  if (a->dtype == 1) return launch_bf16(q, k, v, o, st, batch, heads, nq, nk, s);
  return 1000;
}

// The split (cluster size) the f32 route takes for batch x heads = bh and
// these token counts on the current card; a negative cudaError_t if the card
// cannot be queried.
extern "C" int attn_f32_split(long long bh, long long nq, long long nk) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  const F32Card* card = nullptr;
  if (err == cudaSuccess) err = f32_card(dev, &card);
  if (err != cudaSuccess) return -(int)err;
  return f32_split(*card, (nq + F_BQ - 1) / F_BQ * bh, (int)((nk + F_BK - 1) / F_BK));
}

// How many clusters of `split` CTAs (1-8) of the f32 route the current card
// holds at once, which the choice of split reads; a negative cudaError_t if
// the card cannot be queried.
extern "C" int attn_f32_clusters(int split) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  const F32Card* card = nullptr;
  if (err == cudaSuccess) err = f32_card(dev, &card);
  if (err != cudaSuccess) return -(int)err;
  return split >= 1 && split <= F_MAX_SPLIT ? card->clusters[split] : 0;
}
