// Kernel A: fused softmax attention forward, O = softmax(Q K^T d^-1/2) V.
//
// The bf16 route is a template on the head width D, instantiated at 16, 32,
// 64, 128 and 256; a head of width d runs on the narrowest of them that
// holds it, wider bf16 heads on its wide variant (see "Wide heads" below).
// The f32 route runs on the FP32 pipe up to 64 columns (D = 16, 32, 64) and
// on the tensor cores in 3xTF32 above. Every head whose rows a 16-byte copy
// addresses, a width that is a multiple of 8 in bf16 and of 4 in f32, is
// read in place at its own width: the loads zero-fill the columns from d to
// the instantiation's (TMA boxes past the tensor map's extent of d columns,
// cp.async with a source size of 0), so Q K^T is as over d columns and the
// columns of O past d are zeros, never stored; the output is a buffer of d
// columns. Work wholly past d is skipped. The wrapper zero-pads only the
// other widths (`attention.pad_heads`, a copy) to the next such width and
// passes the true width, whose d^-1/2 scales the logits. The notes below
// give the shapes and counts at D = 64, the main path's width.
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
//   - A head narrower than its instantiation (d < D, a multiple of 8) is read
//     in place: the tensor maps' extent is d, so the columns of a box past d
//     land as zeros and multiply as zeros; at D = 256 the 64-column atom
//     wholly past a head of at most 192 columns is neither loaded nor
//     multiplied (an instantiation of three atoms); only O's first d
//     columns are stored.
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
// the CPU path): f32 logits, f32 probabilities, f32 output. It exists so
// that an f32 model on the card stays within 1e-3 of the CPU path; plain
// TF32 tensor cores (10-bit mantissas) would not. Two kernels:
//
// Up to d = 64 (`attn_fwd_f32<D>`, D = 16, 32, 64), products on the FP32
// pipe, so bound by f32 operations: at (1, 16, 768, 64) 2.42 GFLOP at 67
// TFLOP/s is 36.1 us (the 12.6 MB it moves take 3.8 us at 3.35 TB/s); at
// (1, 12, 768, 64) 27.0 us. The FP32 pipe issues one FFMA per lane per
// cycle, so every other instruction a warp issues is time the pipe stands
// idle. The design:
//   - Register tiles. A warp owns 32 query rows; per 16-key tile each lane
//     holds a 4x4 block of S and, all along, an 8x(D/8) block of O. S = Q K^T
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
//     of 4 floats is read in place; the columns from a narrower head's width
//     d (a multiple of 4) to D are zero-filled (a source size of 0), and
//     only O's first d columns are stored.
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
// What bounds it on the H100 is the FFMA issue rate itself: an 8x8 outer
// product from registers alone reaches 47 of the 67 TFLOP/s (two fresh
// register operands an FFMA), and the shared loads, the softmax and the
// merge take the rest. At d = 64 that is ahead of SDPA's f32 kernel.
//
// Above d = 64 (`attn_fwd_tf32<D, QRES>`: D = 128 up to 128 columns, 256
// above; Q resident up to 256 columns), products on the tensor cores in
// 3xTF32. Stretched over wider heads the FFMA layout gave a warp fewer rows
// (16 at 128, 8 at 256) and more shared loads per FMA, and lost to SDPA's
// f32 kernel (PyTorch's CUTLASS kernel, itself 3xTF32 on mma.sync) by
// 1.3-2.5x. 3xTF32 splits each f32 operand into TF32 parts, big = rna(x)
// and small = rna(x - big), and sums small b_big + big b_small + big b_big
// with f32 accumulators (small terms first, as CUTLASS's FastF32 does):
// three mma a product, some 22 of x's 24 significant bits, and on these
// inputs closer to the exact logits than one f32 chain over d columns (so
// the f64 plain version is its reference). Bound: 3 x the f32 operations
// at the 495 TFLOP/s TF32 peak, 14.6 us at (1, 4, 768, 256); the FFMA
// bound there is 36.1 us. The design:
//   - mma.sync m16n8k8, not wgmma: tf32 wgmma reads only K-major operands,
//     and V is MN-major in P V (32-bit types have no transposed load). A
//     warp owns 16 query rows, a CTA of four warps 64, and O's slice stays in
//     registers (D / 2 accumulators a thread).
//   - The split happens in registers as a fragment is loaded (two integer
//     ops and an FADD a part), so the staged bytes stay f32, once. Q and K
//     fragments come from ldmatrix x4 on rows padded by 4 floats; V's from
//     32-bit loads.
//   - P never leaves registers: the S accumulator of 8 keys is the A
//     fragment of P V over those keys with its k index permuted (k = t is
//     key 2t, k = t + 4 is key 2t + 1), and V's fragments read the same
//     permuted rows, which on rows of 4 floats past a multiple of 32 fall on
//     32 distinct banks.
//   - Staging through one cp.async ring, per key tile of 32 keys: K's
//     chunks of d (one step a chunk), then V's 16-key steps. Up to 256
//     columns Q stays in shared memory (staged once, with the first step),
//     K's chunks are 64 columns and V's steps 128 columns (a 256-wide
//     slice in two); above, Q's and K's 32-column chunks are staged
//     together every tile, so shared memory does not grow with d (67-101 KB
//     a CTA: three CTAs an SM at D = 128, two at 256). Columns past d and
//     rows past the end are zero-filled (cp.async with a source size of 0),
//     so any width that is a multiple of 4 is read in place, with no
//     padding copy; k8 blocks of Q K^T past d and n-tiles of P V past the
//     slice's columns are skipped.
//   - Short rounded chains: the tensor cores round an mma's sum toward
//     zero, so every 32 columns' Q K^T products and each V step's P V
//     products are summed from zero and added to S and O in f32 (see "Sums"
//     below).
//   - Filling the SMs: the cluster split over key tiles and the merge of the
//     FFMA kernel, its split chosen by the same cost with constants fitted
//     to this kernel's times (`plan_for`).
//   - O is rescaled only in tiles where a row's max moved.
//
// Wide heads (d > 256). On the bf16 route (`attn_fwd_bf16_wide`, a multiple
// of 8): D = 256's layout does not stretch: at d = 512 a 64-row bf16 tile
// is 64 KB, so Q, K and V stages pass the 227 KB of shared memory, and O's
// accumulators alone would take 256 registers a thread. So each CTA owns
// one column slice of O, 256 columns wide (the last one narrower where d is
// no multiple of 256), in D = 256's accumulator layout (128 accumulators a
// thread), and recomputes S = Q K^T for its slice over the whole of d, 64
// columns at a time: per key tile, Q's and K's next 64-column chunks are
// staged as TMA boxes through a ring while the chunk before is multiplied,
// then the softmax, then the V tile's slice columns into the O
// accumulators. The grid is (query tile, slice, batch x head), folded into
// x. The recompute does the S work once per slice and reads Q and K again
// per slice and per key tile (from L2).
// The f32 route's tensor-core kernel takes wide heads in as few slices as
// 256 columns allow but of one width (320 columns as two of 160, not 256 +
// 64), and its 2-16 slices of a query block, in one cluster with their key
// shares (above 8 CTAs a non-portable cluster), share S instead of each
// recomputing it: each computes S over its share of d's chunks, publishes
// that partial sum in its shared memory, and after a cluster barrier each
// tile sums all of them in slice order through distributed shared memory.
// That cuts a tile's chunk steps by the slices (at d = 512, 16 -> 8); it
// leaves fewer CTAs to split the key tiles, yet beat recomputing at every
// wide shape measured on the H100 (PERF.md), and past 8 slices (d > 2,048)
// a recomputed S, one chain over all of d, drifts past 2e-5. Past 16
// slices (d > 4,096), which no cluster holds, each slice recomputes S, but
// in the sharing order: each slice's share of the chunks summed from zero,
// the shares added in slice order, so no chain is longer than a share.
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
  static constexpr int T_STAGES = D > 128 ? 1 : 2;   // K/V ring of each warpgroup
  static constexpr int NBAR = 1 + NWG * T_STAGES;    // Q, then one per (warpgroup, stage)
  static constexpr int SMEM = (1 + 2 * NWG * T_STAGES) * TILE_BYTES + 8 * NBAR + 1024;  // + align slack
  static constexpr int ACC = D / 2;                // O accumulators per thread
  static constexpr int MERGE_FLOATS = ACC + 4;     // per thread: accumulators, 2 maxima, 2 partial sums
  // Warpgroup 1 hands its state over through its own ring, or, where that
  // is too small (one stage at D = 256), through the staging from Q on,
  // once both warpgroups are done with it.
  static constexpr bool MERGE_IN_RING = MERGE_FLOATS * 128 * 4 <= 2 * T_STAGES * TILE_BYTES;
  static_assert(MERGE_FLOATS * 128 * 4 <= (1 + 2 * NWG * T_STAGES) * TILE_BYTES, "merge fits");
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

// A 64-row tile: one box per atom, the first NA atoms (those with a
// column below the head's width; the others are neither loaded nor read).
template <int D, int NA>
__device__ __forceinline__ void tma_load_tile(__nv_bfloat16* dst, const CUtensorMap* map,
                                              uint64_t* bar, int row, int head, int batch) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
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
//
// NA: the atoms of a row in use, those with a column below the head's width
// d (D / ATOM but at D = 256, where a head of 136-192 columns takes 3 and
// one of 200-256 takes 4). The atoms past them are neither loaded nor
// multiplied and hold no accumulators: a compile-time count, since a wgmma
// behind a run-time condition made ptxas insert waits into the accumulator
// pipeline (its C7519) and slowed the kernel on the H100. Columns inside the
// atoms in use but past d are zeros from the loads (the tensor maps'
// extent is d), multiplied like the others.
template <int D, int NA>
__global__ void __launch_bounds__(NTHREAD, D <= 64 ? 2 : 1)
attn_fwd_bf16_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                 Strides so, int heads, int nq, int nk, int d, float scale_log2) {
  using T = Tc<D>;
  static_assert(NA >= 1 && NA <= T::NATOM, "atoms in use");
  // O's accumulators a thread: those of the atoms in use.
  constexpr int TILE_ELEMS = T::TILE_ELEMS, ACC = NA * T::ATOM / 2;
  constexpr int T_STAGES = T::T_STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(base);
  // Warpgroup g's ring: K tiles at ring(g), V tiles at ring(g) + T_STAGES tiles.
  auto ring = [&](int g) { return sQ + (1 + 2 * T_STAGES * g) * TILE_ELEMS; };
  uint64_t* bar = reinterpret_cast<uint64_t*>(sQ + (1 + 2 * NWG * T_STAGES) * TILE_ELEMS);

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
  __nv_bfloat16* sV = sK + T_STAGES * TILE_ELEMS;
  uint64_t* kv_bar = bar + 1 + T_STAGES * wg;
  // A tile's bytes: its NA boxes, each whole (a box reaching past d lands
  // with zeros there and completes all its bytes).
  constexpr uint32_t tile_bytes = NA * T::ATOM_ELEMS * 2;

  if (tid == 0) {
    for (int i = 0; i < T::NBAR; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(&bar[0], tile_bytes);
    tma_load_tile<D, NA>(sQ, &tq, &bar[0], q0, h, b);
    for (int g = 0; g < NWG; ++g) {
      for (int s = 0; s < T_STAGES; ++s) {
        const int j = NWG * s + g;
        if (j >= ntiles) break;
        __nv_bfloat16* kg = ring(g);
        mbar_expect_tx(&bar[1 + T_STAGES * g + s], 2 * tile_bytes);
        tma_load_tile<D, NA>(kg + s * TILE_ELEMS, &tk, &bar[1 + T_STAGES * g + s], j * BN, h,
                             b);
        tma_load_tile<D, NA>(kg + (T_STAGES + s) * TILE_ELEMS, &tv, &bar[1 + T_STAGES * g + s],
                             j * BN, h, b);
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
    const int s = i % T_STAGES;
    mbar_wait(&kv_bar[s], (i / T_STAGES) & 1);
    const __nv_bfloat16* kt = sK + s * TILE_ELEMS;
    const __nv_bfloat16* vt = sV + s * TILE_ELEMS;

    // S = Q K^T over the atoms in use: k16 steps of 32 bytes along the rows,
    // atom by atom.
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    const uint64_t dk = sw_desc<T::SW>(kt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NA * T::ATOM / 16; ++kk) {
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
    // product per atom of columns in use.
    const uint64_t dv = sw_desc<T::SW>(vt);
    fence_regs<ACC>(acc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int a = 0; a < NA; ++a)
        wgmma_rs_bt<T::ATOM>(acc + a * T::ATOM / 2, pa[c],
                             dv + (a * T::ATOM_ELEMS + 16 * c * T::ATOM) * 2 / 16);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<ACC>(acc);

    warpgroup_sync(wg);  // all four warps are done with stage s
    if (wtid == 0 && i + T_STAGES < mine) {
      const int jn = j + NWG * T_STAGES;
      mbar_expect_tx(&kv_bar[s], 2 * tile_bytes);
      tma_load_tile<D, NA>(sK + s * TILE_ELEMS, &tk, &kv_bar[s], jn * BN, h, b);
      tma_load_tile<D, NA>(sV + s * TILE_ELEMS, &tv, &kv_bar[s], jn * BN, h, b);
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
  for (int n = 0; n < ACC / 4; ++n) {
    const int col = 8 * n + col0;
    if (8 * n >= d) break;  // O's columns past d (d is a multiple of 8)
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
// in boxes of 64 rows by `box` columns (16, 32 or 64: one atom of the
// instantiation) in the swizzle of a `box`-column row; the extents are the
// tensor's own, so the columns of a box past d and the rows past `rows`
// land in shared memory as zeros, and a box still completes its whole
// bytes on its barrier.
bool make_map(CUtensorMap* map, const void* ptr, const Strides& st, int d, int box_cols, int rows,
              int heads, int batch) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const CUtensorMapSwizzle swizzle = box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.r * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)BN, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor maps already encoded, direct-mapped on everything the encoding
// reads (address, width, box, extents, strides), so an entry is valid for
// any tensor with that key (a map of a 48-column head never serves a
// 64-column call at the same address): the caching allocator hands the
// same buffers to the same calls frame after frame, and a hit skips the
// encode on the host.
struct MapEntry {
  CUtensorMap map;
  long long key[9];
  bool valid;
};
constexpr int MAP_CACHE = 1024;
MapEntry map_cache[MAP_CACHE];
std::mutex map_cache_lock;  // ctypes drops the GIL: callers may be concurrent

bool cached_map(CUtensorMap* map, const void* ptr, const Strides& st, int d, int box_cols,
                int rows, int heads, int batch) {
  const long long key[9] = {(long long)(uintptr_t)ptr, d, box_cols, rows, heads, batch,
                            st.b, st.h, st.r};
  uint64_t hash = 1469598103934665603ull;  // FNV-1a over the key's words
  for (long long w : key) hash = (hash ^ (uint64_t)w) * 1099511628211ull;
  std::lock_guard<std::mutex> guard(map_cache_lock);
  MapEntry& e = map_cache[(hash >> 32) % MAP_CACHE];
  if (!e.valid || memcmp(e.key, key, sizeof key) != 0) {
    e.valid = make_map(&e.map, ptr, st, d, box_cols, rows, heads, batch);
    if (!e.valid) return false;
    memcpy(e.key, key, sizeof key);
  }
  *map = e.map;
  return true;
}

// A head of width d (a multiple of 8, at most D, above NA - 1 atoms) on the
// instantiation D with NA atoms in use.
template <int D, int NA = Tc<D>::NATOM>
int launch_bf16(const void* q, const void* k, const void* v, void* o, const Strides* st,
                int batch, int heads, int nq, int nk, int d, float scale_log2,
                cudaStream_t stream) {
  constexpr int box = Tc<D>::ATOM;
  CUtensorMap tq, tk, tv;
  if (!cached_map(&tq, q, st[0], d, box, nq, heads, batch) ||
      !cached_map(&tk, k, st[1], d, box, nk, heads, batch) ||
      !cached_map(&tv, v, st[2], d, box, nk, heads, batch))
    return 1001;
  static bool configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(attn_fwd_bf16_tc<D, NA>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Tc<D>::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const long long grid = (long long)((nq + BM - 1) / BM) * batch * heads;
  if (grid > INT_MAX) return 1000;
  attn_fwd_bf16_tc<D, NA><<<(unsigned)grid, NTHREAD, Tc<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st[3], heads, nq, nk, d, scale_log2);
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
                   Strides so, int heads, int nq, int nk, int d, int chunks, int slices,
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
  // This slice's 64-column boxes of V, the last one reaching past d where d
  // is no multiple of 64 (its columns past d land as zeros: the maps'
  // extent is d, and so are those of Q's and K's last chunk).
  const int natoms = min(W::NATOM, chunks - c0 / W_CHUNK);
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
    if (c0 + 8 * n >= d) continue;  // O's columns past d (d is a multiple of 8)
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
  if (!cached_map(&tq, q, st[0], d, W_CHUNK, nq, heads, batch) ||
      !cached_map(&tk, k, st[1], d, W_CHUNK, nk, heads, batch) ||
      !cached_map(&tv, v, st[2], d, W_CHUNK, nk, heads, batch))
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
  const int chunks = (d + W_CHUNK - 1) / W_CHUNK, slices = (d + W_SLICE - 1) / W_SLICE;
  const long long grid = (long long)((nq + BM - 1) / BM) * slices * batch * heads;
  if (grid > INT_MAX) return 1000;
  attn_fwd_bf16_wide<<<(unsigned)grid, NTHREAD, TcWide::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st[3], heads, nq, nk, d, chunks, slices,
      scale_log2);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------------ f32 route
//
// Register-tiled f32 attention on the FP32 pipe at head widths up to 64 (see
// the note at the top). A CTA of four warps owns BQ = 128 query rows, 32 per
// warp, and one share of the key tiles; the `split` CTAs of a cluster take
// the shares of one block and merge their partial (O, max, sum) through
// distributed shared memory at the end.
//
// Lane layouts of a warp (lane = 4 rg + kg = 8 RG + cg), 4 S rows and 8 O
// rows a lane:
//   S = Q K^T, 32 rows x 16 keys: rows 4 rg + i (i < 4), keys kg + 4 t
//   (t < 4).
//   O, 32 rows x D columns: rows 8 RG + x (x < 8), columns 32 j + 4 cg + c
//   (j < D / 32, c < 4); at D = 16, columns 2 cg + c (c < 2).
// O row 8 RG + 4 h + i is S row 4 (2 RG + h) + i, held by lane
// 8 RG + 4 h + (cg & 3): one shuffle per row hands a rescale to the O lanes.
// Q row 4 rg + i of warp w is staged at row 32 w + 8 i + rg, so the eight
// rows of one S load sit in eight different bank groups.

constexpr int F_WARPS = 4;
constexpr int F_THREADS = 32 * F_WARPS;
constexpr int F_BK = 16;                          // keys per staged tile
constexpr int F_STAGES = 3;                       // K/V ring depth
constexpr int F_MAX_SPLIT = 8;                    // portable cluster size
constexpr int T_MAX_CLUSTER = 16;                 // non-portable (H100): slices sharing S
constexpr int F_MAX_D = 64;                       // the widest FFMA instantiation

template <int D>
struct F32 {
  static_assert(D == 16 || D == 32 || D == 64, "an FFMA head width");
  static constexpr int WROWS = 32;                // query rows per warp
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
// L2 only), or 16 zero bytes where `valid` is false (source size 0: nothing
// is read from src, which need only be a valid address): completes at the
// thread's next cp.async.wait_group that covers it.
__device__ __forceinline__ void copy16_or_zero(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// Wait until at most `n` of this thread's committed copy groups are pending.
template <int n>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// This thread's share of tile `tile`'s K and V rows into `dst` (16 K rows,
// then 16 V rows, each D/4 chunks of 16 bytes; the chunks past the head's
// width d, a multiple of 4, zero-filled). Rows past nk copy row nk - 1, so
// the tile holds finite values; their keys are masked.
template <int D>
__device__ __forceinline__ void stage_kv(float* dst, const float* kb, const float* vb,
                                         long long kr, long long vr, int tile, int nk, int d,
                                         int tid) {
#pragma unroll
  for (int e = tid; e < 2 * F_BK * (D / 4); e += F_THREADS) {
    const int row = e / (D / 4), c4 = e % (D / 4);
    const int key = min(tile * F_BK + row % F_BK, nk - 1);
    const bool in = 4 * c4 < d;
    copy16_or_zero(dst + row * F32<D>::LD + 4 * c4,
                   (row < F_BK ? kb + key * kr : vb + key * vr) + (in ? 4 * c4 : 0), in);
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

// One key tile of the f32 route after S = Q K^T (sc: this lane's 4 rows x
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
  for (int t = 0; t < 4; ++t)
    *reinterpret_cast<float4*>(Pw + (kg + 4 * t) * WROWS + SR * rg) =
        make_float4(sc[0][t], sc[1][t], sc[2][t], sc[3][t]);
  float oc[OR];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    oc[i] = __shfl_sync(0xffffffffu, corr[i], lane & ~4);
    oc[SR + i] = __shfl_sync(0xffffffffu, corr[i], lane | 4);
  }
  __syncwarp();  // P is in shared memory

  // O += P V: per key, 2 loads of P and OC / 4 of V (16 bytes each) feed
  // 8 OC FMAs.
#pragma unroll
  for (int x = 0; x < OR; ++x)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[x][c] *= oc[x];
#pragma unroll
  for (int j = 0; j < F_BK; ++j) {
    float p[OR], w[OC];
#pragma unroll
    for (int x4 = 0; x4 < OR / 4; ++x4) {
      const float4 pv = *reinterpret_cast<const float4*>(Pw + j * WROWS + OR * RG + 4 * x4);
      p[4 * x4] = pv.x;
      p[4 * x4 + 1] = pv.y;
      p[4 * x4 + 2] = pv.z;
      p[4 * x4 + 3] = pv.w;
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

// The split's merge, once every CTA of the cluster has written its partials
// into its own shared memory (O unnormalized into part_o, BQ rows of LD
// floats; each row's max in log2 units and sum into part_m and part_l): it
// finalizes rows [lo, hi) of the block from the split's partials through
// distributed shared memory, O = sum_g w_g O_g / sum_g w_g l_g with
// w_g = 2^(m_g - max_g m_g) (weights in wts, BQ + split floats), and writes
// their first `cols` columns (a multiple of 4) at ob (the block's first row
// and column; row stride ro). `rows`: the block's rows before nq.
// The split's CTAs are the cluster's ranks stride g + offset, g < split
// (stride 1, offset 0 but where the slices of a query block share a
// cluster); `rank` is this CTA's g.
template <int BQ, int LD>
__device__ __forceinline__ void merge_partials(const float* part_o, const float* part_m,
                                               const float* part_l, float* wts, int rank,
                                               int split, int rows, float* ob, long long ro,
                                               int cols, int stride = 1, int offset = 0) {
  const int tid = threadIdx.x;
  cluster_sync<true>();  // every CTA's partials are written
  const int lo = rank * BQ / split;
  const int hi = min((rank + 1) * BQ / split, rows);
  const uint32_t m_at = smem_u32(part_m), l_at = smem_u32(part_l), o_at = smem_u32(part_o);
  for (int r = lo + tid; r < hi; r += F_THREADS) {
    float mx = -INFINITY;
    for (int g = 0; g < split; ++g)
      mx = fmaxf(mx, ld_cluster(cluster_addr(m_at + 4 * r, stride * g + offset)));
    float sum = 0.f;
    for (int g = 0; g < split; ++g) {
      const float wg = fast_exp2(ld_cluster(cluster_addr(m_at + 4 * r, stride * g + offset)) - mx);
      sum = fmaf(wg, ld_cluster(cluster_addr(l_at + 4 * r, stride * g + offset)), sum);
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
      const float4 pv = ld_cluster4(cluster_addr(o_at + 4 * (r * LD + 4 * c4), stride * g + offset));
      out.x = fmaf(wg, pv.x, out.x);
      out.y = fmaf(wg, pv.y, out.y);
      out.z = fmaf(wg, pv.z, out.z);
      out.w = fmaf(wg, pv.w, out.w);
    }
    *reinterpret_cast<float4*>(ob + r * ro + 4 * c4) = out;
  }
  cluster_sync<false>();  // no CTA leaves while a peer still reads its shared memory
}

// The FFMA kernel's partials into shared memory (O over Q's staging, max and
// sum over the ring, weights over P), then `merge_partials`.
template <int D>
__device__ __forceinline__ void f32_merge(float (&acc)[F32<D>::OR][F32<D>::OC],
                                          float (&m)[F32<D>::SR], float (&l)[F32<D>::SR],
                                          float* part_o, float* part_m, float* part_l, float* wts,
                                          int rank, int split, int rows, float* ob, long long ro,
                                          int cols) {
  using F = F32<D>;
  constexpr int WROWS = F::WROWS, SR = F::SR, OR = F::OR, OC = F::OC, LD = F::LD;
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
  merge_partials<F::BQ, LD>(part_o, part_m, part_l, wts, rank, split, rows, ob, ro, cols);
}

template <int D>
__global__ void __launch_bounds__(F_THREADS, 3)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, Strides sq, Strides sk,
             Strides sv, Strides so, int heads, int nq, int nk, int d, int split,
             float scale_log2) {
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
  // nq - 1 and are never stored). The columns from the head's width d (a
  // multiple of 4) to D are zero-filled, so Q K^T is as over d columns and
  // O's columns past d are zeros, never stored.
#pragma unroll 4
  for (int e = tid; e < BQ * (D / 4); e += F_THREADS) {
    const int r = e / (D / 4), c4 = e % (D / 4), rho = r % WROWS;
    const int at = r - rho + 8 * (rho & (SR - 1)) + (rho >> 2);
    const bool in = 4 * c4 < d;
    copy16_or_zero(Qs + at * LD + 4 * c4, qb + min(q0 + r, nq - 1) * sq.r + (in ? 4 * c4 : 0),
                   in);
  }
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < mine) stage_kv<D>(ring + s * F::TILE_FLOATS, kb, vb, sk.r, sv.r, t0 + s, nk, d, tid);
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
                  t0 + it + F_STAGES - 1, nk, d, tid);
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
               o + b * so.b + h * so.h + q0 * so.r, so.r, d);
}

// ------------------------------------- f32 route above width 64: 3xTF32
//
// Flash attention on the tensor cores, mma.sync m16n8k8 in TF32, each
// product in 3xTF32 (see the note at the top). A CTA of four warps owns
// T_BM = 64 query rows, 16 a warp (the m16 of one mma), one column slice of
// O `width` (at most D) columns wide from column c0, and one share of the
// key tiles of T_BN keys (the cluster split of `attn_fwd_f32`). Per key tile
// it takes nch + VSTEPS steps through one ring of T_STAGES stages: a chunk
// step stages the tile's K rows (and, without a resident Q, the block's Q
// rows) over KC columns of d; a V step stages VK of the tile's V rows over
// VW of the slice's columns. With `share` the slices of a query block sum
// S from their shares of d's chunks (see "Wide heads" at the top).
//
// Fragments (lane = 4 g + t): an m16n8 accumulator holds rows g and g + 8,
// columns 2t and 2t + 1. The S accumulator of keys 8j..8j+7 is the A
// fragment of the PV product over those keys with its k index permuted
// (k = t is key 2t, k = t + 4 is key 2t + 1), so P never leaves registers;
// the V fragments read keys 2t and 2t + 1 to match. Q and K fragments come
// from ldmatrix x4 (an 8 x 4-float block a matrix: lane 4 g + t gets
// element (g, t)), V's as 32-bit loads from rows of D + 4 floats, where the
// permuted rows 2t and 2t + 1 fall on 32 distinct banks.
//
// Sums. The tensor cores round each mma's sum toward zero, so a chain of
// mma into one accumulator drifts with its length (on 8x-peaked logits
// 2-10e-5 of O at d = 128-2,000 on the H100, one chain over d). So every
// T_PART columns' products (12 mma an n-tile) are summed from zero and
// added to S in f32, and every V step's (6 mma an n-tile) likewise to O:
// the rounded chains stay 32 columns or 16 keys long.
//
// Tiles of 32 keys, not 64: with D = 256's 128 O accumulators a thread, the
// 16 of S and 16 of its chunk sums fit, 32 of each would not; at D = 128,
// 32-key tiles keep a thread within the 168 registers of three CTAs an SM.

constexpr int T_WARPS = 4;
constexpr int T_THREADS = 32 * T_WARPS;
constexpr int T_BM = 16 * T_WARPS;   // query rows per CTA
constexpr int T_BN = 32;             // keys per tile
constexpr int T_PART = 32;           // columns of d a chunk sum of S takes
constexpr int T_STAGES = 4;          // ring depth

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// D: the slice width (O's accumulators); QRES: Q resident in shared memory
// (heads up to 256 columns), else Q staged with K in every chunk step
// (wider heads, in slices).
template <int D, bool QRES>
struct Tf32 {
  static_assert(D == 128 || D == 256, "a tensor-core slice width");
  static constexpr int KC = QRES ? 64 : 32;           // columns of d a chunk step stages
  static constexpr int LDC = KC + 4;                  // staged chunk row: conflict-free ldmatrix
  static constexpr int LDQ = D + 4;                   // resident Q row (floats)
  static constexpr int K_ROW0 = QRES ? 0 : T_BM;      // K's first row in a chunk stage
  static constexpr int VK = 16;                       // keys a V step stages
  // V's columns a step stages: 128 beside a resident Q (a 256-wide slice
  // in two steps), so that two CTAs fit an SM at D = 256.
  static constexpr int VW = QRES ? 128 : D;
  static constexpr int HALVES = D / VW;
  static constexpr int VSTEPS = T_BN / VK * HALVES;
  static constexpr int LSV = VW + 4;                  // staged V row (floats)
  static constexpr int LDV = D + 4;                   // partial O row in the merge (floats)
  static constexpr int NT = D / 8;                    // n-tiles of O
  static constexpr int Q_FLOATS = QRES ? T_BM * LDQ : 0;
  static constexpr int CHUNK_FLOATS = (K_ROW0 + T_BN) * LDC;  // (Q's rows, then) K's
  static constexpr int V_FLOATS = VK * LSV;
  // The merge puts the partial O (rows of LDV floats), the maxima, the sums
  // and the weights over Q and the ring.
  static constexpr int MERGE_FLOATS = T_BM * LDV + 3 * T_BM + F_MAX_SPLIT;
  static constexpr int STAGE_FLOATS =
      cmax(cmax(CHUNK_FLOATS, V_FLOATS),
           cmax(0, MERGE_FLOATS - Q_FLOATS + 4 * T_STAGES - 1) / (4 * T_STAGES) * 4);
  // Slices sharing S (wide heads): each thread's partial S, twice (tiles
  // alternate), after the ring.
  static constexpr int X_FLOATS = QRES ? 0 : 2 * T_THREADS * 4 * (T_BN / 8);
  static constexpr int SMEM = 4 * (Q_FLOATS + T_STAGES * STAGE_FLOATS + X_FLOATS);
};

// x split into TF32 parts, hi = rna(x) and lo = rna(x - hi), as
// cvt.rna.tf32.f32 rounds (to nearest, ties away from zero: half a TF32 ulp
// added to the magnitude's bits, the 13 low bits cleared); x - hi is exact.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) { return (bits + 0x1000u) & 0xffffe000u; }
__device__ __forceinline__ void tf32_split(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__float_as_uint(__uint_as_float(x) - __uint_as_float(hi)));
}

// c += a b on the tensor cores: a the 16x8 A fragment, (b0, b1) the 8x8 B
// fragment, TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, small terms first: a_lo b_hi + a_hi b_lo + a_hi b_hi.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Two CTAs an SM at D = 256 (128 O accumulators a thread), three at 128.
template <int D, bool QRES>
__global__ void __launch_bounds__(T_THREADS, D == 256 ? 2 : 3)
attn_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Strides sq, Strides sk,
              Strides sv, Strides so, int heads, int nq, int nk, int d, int slices, int width,
              int split, int share, float scale_log2) {
  using T = Tf32<D, QRES>;
  constexpr int BN = T_BN, VK = T::VK, LDV = T::LDV, NT = T::NT, STAGE = T::STAGE_FLOATS;
  constexpr int KC = T::KC, LDC = T::LDC, LDQ = T::LDQ, VW = T::VW, LSV = T::LSV;
  constexpr int SN = BN / 8;  // S n-tiles a tile
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;
  float* ring = fsm + T::Q_FLOATS;
  float* xbuf = ring + T_STAGES * STAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int blocks = (nq + T_BM - 1) / T_BM;
  // The cluster's CTAs are consecutive: the split's (split, 1, 1), or with
  // `share` the split's times the query block's slices, rank = (key share,
  // slice). x = ((batch x head, slice), query block), without the slice
  // with `share`.
  if constexpr (QRES) share = 0;  // a resident Q is one slice's: S is never shared
  const int csize = share ? split * slices : split;
  int x = blockIdx.x / csize;
  const int crank = blockIdx.x - x * csize;
  const int q0 = x % blocks * T_BM;
  x /= blocks;
  int slice = crank % slices, rank = crank / slices;
  if (!share) {
    slice = x % slices;
    x /= slices;
    rank = crank;
  }
  const int c0 = slice * width;
  const int bh = x;
  const int b = bh / heads, h = bh % heads;
  const int cols = min(width, d - c0);   // this slice's columns, a multiple of 4
  const int vcols = (cols + 7) & ~7;     // staged V columns: whole n-tiles, zero past cols
  const int ntc = vcols / 8;             // O n-tiles in use
  // Chunk steps a tile: over all of d, or with `share` over this slice's
  // share of d's chunks, [ch0, ch0 + nch).
  const int chunks = (d + KC - 1) / KC;
  const int ch0 = share ? slice * chunks / slices : 0;
  const int nch = share ? (slice + 1) * chunks / slices - ch0 : chunks;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h + c0;
  const int ntiles = (nk + BN - 1) / BN;
  const int t0 = rank * ntiles / split;  // this CTA's tiles: [t0, t0 + mine), never empty
  const int mine = (rank + 1) * ntiles / split - t0;
  const int per = nch + T::VSTEPS;
  const int steps = mine * per;

  // Step n into stage n % T_STAGES, every thread its 16-byte copies; rows
  // past nq or nk and columns past d are zero-filled.
  auto stage = [&](int n) {
    float* dst = ring + n % T_STAGES * STAGE;
    const int tile = t0 + n / per, c = n % per;
    if (c < nch) {
      // This thread's column of every RSTEP-th row: (Q's rows, then) K's.
      constexpr int C4 = KC / 4, RSTEP = T_THREADS / C4;
      static_assert(T::K_ROW0 % RSTEP == 0 && BN % RSTEP == 0, "whole passes of rows");
      const int row0 = tid / C4, cc = 4 * (tid % C4), col = (ch0 + c) * KC + cc;
#pragma unroll
      for (int i = 0; i < (T::K_ROW0 + BN) / RSTEP; ++i) {
        const int row = row0 + i * RSTEP;
        const bool is_q = i < T::K_ROW0 / RSTEP;
        const int r = is_q ? q0 + row : tile * BN + row - T::K_ROW0;
        const bool valid = r < (is_q ? nq : nk) && col < d;
        const float* src = (is_q ? qb + min(r, nq - 1) * sq.r : kb + min(r, nk - 1) * sk.r)
                           + (valid ? col : 0);
        copy16_or_zero(dst + row * LDC + cc, src, valid);
      }
    } else {
      const int key0 = tile * BN + (c - nch) / T::HALVES * VK;
      const int vc0 = (c - nch) % T::HALVES * VW;  // this step's first column
      const int vw = min(VW, vcols - vc0);         // its staged columns (none: a skipped half)
      for (int e = tid; e < VK * (vw / 4); e += T_THREADS) {
        const int row = e / (vw / 4), col = 4 * (e % (vw / 4));
        const bool valid = key0 + row < nk && vc0 + col < cols;
        copy16_or_zero(dst + row * LSV + col,
                       vb + min(key0 + row, nk - 1) * sv.r + (valid ? vc0 + col : 0), valid);
      }
    }
  };
  if constexpr (QRES) {  // Q's rows once, zero past d, in the first copy group
    for (int e = tid; e < T_BM * (D / 4); e += T_THREADS) {
      const int row = e / (D / 4), col = 4 * (e % (D / 4));
      const bool valid = q0 + row < nq && col < d;
      copy16_or_zero(Qs + row * LDQ + col, qb + min(q0 + row, nq - 1) * sq.r + (valid ? col : 0),
                     valid);
    }
  }
  for (int s = 0; s < T_STAGES - 1; ++s) {
    if (s < steps) stage(s);
    copy_commit();
  }
  // Step n has landed; every warp is done with step n - 1, whose stage takes
  // step n + T_STAGES - 1 while this one computes.
  auto advance = [&](int n) {
    copy_wait<T_STAGES - 2>();
    __syncthreads();
    if (n + T_STAGES - 1 < steps) stage(n + T_STAGES - 1);
    copy_commit();
    return ring + n % T_STAGES * STAGE;
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8; l: this lane's share
  // ldmatrix row addresses within a stage: lane 8 i + r gives row r of
  // matrix i. Q: matrix i is rows 8 (i & 1) and columns 4 (i >> 1) of the
  // warp's k8 block (a0..a3); K: keys 8 (i >> 1) and columns 4 (i & 1) of a
  // pair of n-tiles (b0, b1 of the first, b0, b1 of the second).
  const int mi = lane >> 3, mr = lane & 7;
  const int q_at = (16 * warp + 8 * (mi & 1) + mr) * (QRES ? LDQ : LDC) + 4 * (mi >> 1);
  const int k_at = (T::K_ROW0 + 8 * (mi >> 1) + mr) * LDC + 4 * (mi & 1);
  int n = 0;
  // With `share` every CTA of the cluster takes as many rounds as the key
  // share with the most tiles (each round ends at a cluster barrier); a
  // share with fewer idles through its last.
  const int rounds = share ? (ntiles + split - 1) / split : mine;
  for (int it = 0; it < rounds; ++it) {
    const bool live = it < mine;
    float sc[SN][4];
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;

    // S = Q K^T over the chunks of d: per k8 block one Q fragment, split
    // once, against the tile's n-tiles; k8 blocks past d are skipped. Each
    // T_PART columns' products are summed from zero (sp) and then added to
    // S. Recomputed over several slices' chunks (no sharing), S is summed as
    // shared slices sum it: each slice's share of the chunks from zero
    // (group `grp`, ending at chunk `gend`), the shares added in slice order
    // through this thread's slot of xbuf.
    int grp = 0, gend = chunks / slices;
    for (int c = 0; c < (live ? nch : 0); ++c, ++n) {
      const float* st = advance(n);
      const float* qc = QRES ? Qs + q_at + c * KC : st + q_at;
      const int kmax = min(KC / 8, (d - (ch0 + c) * KC + 7) / 8);
      float sp[SN][4];
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        if (kk >= kmax) break;
        if (kk % (T_PART / 8) == 0) {
#pragma unroll
          for (int j = 0; j < SN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sp[j][e] = 0.f;
        }
        uint32_t a[4], ah[4], al[4];
        ldsm_x4(a, qc + 8 * kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32_split(a[e], ah[e], al[e]);
#pragma unroll
        for (int np = 0; np < SN / 2; ++np) {
          uint32_t kf[4], bh[4], bl[4];
          ldsm_x4(kf, st + k_at + 16 * np * LDC + 8 * kk);
#pragma unroll
          for (int e = 0; e < 4; ++e) tf32_split(kf[e], bh[e], bl[e]);
          mma_3xtf32(sp[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma_3xtf32(sp[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        }
        if (kk % (T_PART / 8) == T_PART / 8 - 1 || kk == kmax - 1) {
#pragma unroll
          for (int j = 0; j < SN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] += sp[j][e];
        }
      }
      if constexpr (!QRES) {
        if (!share && slices > 1 && c + 1 == gend) {
          float* gs = xbuf + tid * 4 * SN;
#pragma unroll
          for (int j = 0; j < SN; ++j) {
            float4& slot = *reinterpret_cast<float4*>(gs + 4 * j);
            if (grp == slices - 1) {  // the last share: S is the sum of all of them
              sc[j][0] += slot.x;
              sc[j][1] += slot.y;
              sc[j][2] += slot.z;
              sc[j][3] += slot.w;
            } else {
              slot = grp ? make_float4(slot.x + sc[j][0], slot.y + sc[j][1], slot.z + sc[j][2],
                                       slot.w + sc[j][3])
                         : make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
#pragma unroll
              for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
            }
          }
          ++grp;
          gend = (grp + 1) * chunks / slices;
        }
      }
    }

    // With `share`, S is the sum of the query block's slices' partial sums
    // over their shares of d: each CTA publishes its partial (its threads'
    // fragments, in one of two buffers by the tile's parity), and after the
    // cluster barrier every slice sums all of them in slice order, its own
    // too, through distributed shared memory, so that all hold the same S.
    // The barrier of the next round orders the reads before the buffer's
    // reuse two rounds on.
    if (share) {
      float* xb = xbuf + (it & 1) * (T_THREADS * 4 * SN) + tid * 4 * SN;
#pragma unroll
      for (int j = 0; j < SN; ++j)
        *reinterpret_cast<float4*>(xb + 4 * j) = make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
      cluster_sync<true>();
      if (live) {
        const uint32_t at = smem_u32(xb);
#pragma unroll
        for (int j = 0; j < SN; ++j) {
          const float4 v0 = ld_cluster4(cluster_addr(at + 16 * j, rank * slices));
          sc[j][0] = v0.x;
          sc[j][1] = v0.y;
          sc[j][2] = v0.z;
          sc[j][3] = v0.w;
        }
        for (int sl = 1; sl < slices; ++sl) {
#pragma unroll
          for (int j = 0; j < SN; ++j) {
            const float4 vs = ld_cluster4(cluster_addr(at + 16 * j, rank * slices + sl));
            sc[j][0] += vs.x;
            sc[j][1] += vs.y;
            sc[j][2] += vs.z;
            sc[j][3] += vs.w;
          }
        }
      }
    }
    if (!live) continue;

    // The online softmax in log2 units on rows g (hh = 0) and g + 8 (hh =
    // 1): a row's keys lie on the 4 lanes of its quad. Keys at or past nk
    // count as -inf; only a ragged last tile has any, and it holds a valid
    // key (its first), so the max is finite.
    const int tile = t0 + it;
    if ((tile + 1) * BN > nk) {
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (tile * BN + 8 * j + 2 * t + (e & 1) >= nk) sc[j][e] = -INFINITY;
    }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < SN; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * hh], sc[j][2 * hh + 1]));
      const float mn = fmaxf(m[hh], quad_max(mx) * scale_log2);
      corr[hh] = fast_exp2(m[hh] - mn);
      m[hh] = mn;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          sc[j][e] = fast_exp2(fmaf(sc[j][e], scale_log2, -mn));
          rs += sc[j][e];
        }
      l[hh] = fmaf(l[hh], corr[hh], rs);
    }
    // O is rescaled only where a row's max moved: once the maxima settle,
    // most tiles skip these D / 2 multiplies a thread.
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
    }

    // O += P V, VK keys a step: P's fragments split in registers once a
    // step, V's fragments from the permuted rows 2t and 2t + 1 of each k8
    // block; each n-tile's products summed from zero and added to O;
    // n-tiles past the slice's columns are skipped.
    uint32_t ph[VK / 8][4], pl[VK / 8][4];
#pragma unroll
    for (int s = 0; s < T::VSTEPS; ++s, ++n) {
      const float* st = advance(n);
      const int kb = s / T::HALVES, hv = s % T::HALVES;  // key block, column half
      if (hv == 0) {
#pragma unroll
        for (int jj = 0; jj < VK / 8; ++jj) {
          const float(&p)[4] = sc[kb * (VK / 8) + jj];
          tf32_split(__float_as_uint(p[0]), ph[jj][0], pl[jj][0]);
          tf32_split(__float_as_uint(p[2]), ph[jj][1], pl[jj][1]);
          tf32_split(__float_as_uint(p[1]), ph[jj][2], pl[jj][2]);
          tf32_split(__float_as_uint(p[3]), ph[jj][3], pl[jj][3]);
        }
      }
      const float* vr = st + 2 * t * LSV + g;
#pragma unroll
      for (int j = hv * (VW / 8); j < (hv + 1) * (VW / 8); ++j) {
        if (j >= ntc) break;
        const int jc = j - hv * (VW / 8);  // the n-tile within the staged columns
        float po[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int jj = 0; jj < VK / 8; ++jj) {
          uint32_t vh0, vl0, vh1, vl1;
          tf32_split(__float_as_uint(vr[8 * jj * LSV + 8 * jc]), vh0, vl0);
          tf32_split(__float_as_uint(vr[(8 * jj + 1) * LSV + 8 * jc]), vh1, vl1);
          mma_3xtf32(po, ph[jj], pl[jj], vh0, vh1, vl0, vl1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += po[e];
      }
    }
  }

  // The partials over Q and the ring: O's rows (LDV floats), then the
  // maxima, the sums and the merge's weights.
  copy_wait<0>();
  __syncthreads();  // every warp is done with Q and the ring
  float* part_o = fsm;
  float* part_m = part_o + T_BM * LDV;
  float* part_l = part_m + T_BM;
  const int row0 = 16 * warp + g;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= ntc) break;
    *reinterpret_cast<float2*>(part_o + row0 * LDV + 8 * j + 2 * t) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(part_o + (row0 + 8) * LDV + 8 * j + 2 * t) =
        make_float2(acc[j][2], acc[j][3]);
  }
  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  if (t == 0) {
    part_m[row0] = m[0];
    part_m[row0 + 8] = m[1];
    part_l[row0] = l0;
    part_l[row0 + 8] = l1;
  }
  merge_partials<T_BM, LDV>(part_o, part_m, part_l, part_l + T_BM, rank, split, nq - q0,
                            o + b * so.b + h * so.h + q0 * so.r + c0, so.r, cols,
                            share ? slices : 1, share ? slice : 0);
}

// Per card and kernel: the SM count and the most clusters of each size that
// can be resident at once (cudaOccupancyMaxActiveClusters), read at the
// first launch.
struct F32Card {
  bool ready;
  int sms;
  int clusters[T_MAX_CLUSTER + 1];  // 0 past the kernel's largest cluster
};
std::mutex f32_cards_lock;

// `cards[dev]` for the f32 kernel `kernel` with `smem` bytes of shared
// memory and clusters of up to `max_cluster` CTAs (above 8 non-portable).
template <typename Kernel>
cudaError_t f32_card_of(Kernel kernel, int smem, F32Card* cards, int dev, const F32Card** out,
                        int max_cluster = F_MAX_SPLIT) {
  std::lock_guard<std::mutex> guard(f32_cards_lock);
  F32Card& c = cards[dev];
  if (!c.ready) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess && max_cluster > F_MAX_SPLIT)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    for (int g = 1; g <= max_cluster && err == cudaSuccess; ++g) {
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

template <int D, bool QRES>
cudaError_t tf32_card(int dev, const F32Card** out) {
  static F32Card cards[MAX_DEVICES];
  return f32_card_of(attn_fwd_tf32<D, QRES>, Tf32<D, QRES>::SMEM, cards, dev, out,
                     QRES ? F_MAX_SPLIT : T_MAX_CLUSTER);
}

// The slice width of the tensor-core kernel at head width d (> 64): 128 up
// to 128 columns, else 256-column slices.
int tf32_width(long long d) { return d <= 128 ? 128 : 256; }

// The card's counts for the f32 route at width d (up to 64 those of the
// FFMA instantiation that runs it; above, the tensor-core kernel's).
cudaError_t f32_card_at(long long d, int dev, const F32Card** out) {
  if (d < 1) return cudaErrorInvalidValue;
  if (d <= 16) return f32_card<16>(dev, out);
  if (d <= 32) return f32_card<32>(dev, out);
  if (d <= F_MAX_D) return f32_card<64>(dev, out);
  if (d > MAX_D) return tf32_card<256, false>(dev, out);
  return tf32_width(d) == 128 ? tf32_card<128, true>(dev, out) : tf32_card<256, true>(dev, out);
}

// The split (the key shares of a query block) for `blocks` clusters over
// `ntiles` key tiles, each cluster `per` x split CTAs (per = 1, or the
// slices that share S): the one with the least estimated time. Clusters run
// in waves of as many as the card holds; a wave takes a CTA's tiles times
// (the CTAs its busiest SM holds + a), plus c tiles for the prologue and the
// merge, in tenths of a tile. The FFMA kernel (16-key tiles): a = 0.3, c =
// 3.6, fitted to the H100's times over splits 1-8 at the encoder, decoder
// and training shapes, d = 64. The tensor-core kernel (32-key tiles): a =
// TC_A, c = TC_C, fitted the same way at the f32 shapes above d = 64 of
// PERF.md's table (scripts/profile_f32_attention.py --table).
constexpr int TC_A = 7, TC_C = 2;
int f32_split(const F32Card& c, long long blocks, int ntiles, int a, int cost0, int per = 1) {
  int best = 1;
  long long best_cost = -1;
  for (int g = 1; g <= F_MAX_SPLIT && g * per <= T_MAX_CLUSTER && g <= ntiles; ++g) {
    const long long cap = c.clusters[g * per];
    if (cap <= 0) continue;
    const long long tiles = (ntiles + g - 1) / g;
    long long cost = 0;
    for (long long left = blocks; left > 0; left -= cap) {
      const long long per_sm = ((left < cap ? left : cap) * g * per + c.sms - 1) / c.sms;
      cost += tiles * (10 * per_sm + a) + cost0;
    }
    if (best_cost < 0 || cost < best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
}

// O's column slices at head width d on the f32 route: one up to 256 columns,
// else as few as 256-column slices allow, of one width (a multiple of 8), so
// that no CTA of a query block takes a short remainder while its peers
// compute S in full.
struct Slicing {
  int count, width;
};
Slicing slicing_at(long long d) {
  if (d <= MAX_D) return {1, (int)d};
  const long long n = (d + W_SLICE - 1) / W_SLICE;
  const int w = (int)(((d + n - 1) / n + 7) / 8 * 8);
  return {(int)((d + w - 1) / w), w};
}

// Launches an f32 kernel on `blocks` clusters of `split` CTAs each (the
// tensor-core kernel's slices sharing S make a cluster of split x slices).
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

// The f32 route's query rows a cluster, key tile and split model at width d.
struct F32Plan {
  int rows, tile, a, cost0;
};
F32Plan f32_plan(long long d) {
  return d <= F_MAX_D ? F32Plan{F32<64>::BQ, F_BK, 3, 36} : F32Plan{T_BM, T_BN, TC_A, TC_C};
}

// The split, and whether the slices of a query block share S, for batch x
// heads = bh over nq and nk tokens at width d on `card`. The 2-16 slices of
// wide heads on the tensor-core kernel share it (one cluster holds them with
// the split, above 8 CTAs a non-portable one): on the H100 that beat each
// slice recomputing S at every split of every wide shape of PERF.md's table,
// and past 8 slices (d > 2,048) a recomputed S, one chain of chunk sums
// over all of d, drifts past error_bound's 2e-5 on 8x-peaked logits (2.3e-5
// at d = 3,000). Past 16 slices (d > 4,096), which no cluster holds, each
// slice recomputes it, summed in the sharing order. Profiling builds fix
// the split (-DF32_SPLIT=g): scripts/profile_f32_attention.py.
struct SplitPlan {
  int split, share;
};
SplitPlan plan_for(const F32Card& card, long long bh, long long nq, long long nk, long long d) {
  const F32Plan p = f32_plan(d);
  const int ntiles = (int)((nk + p.tile - 1) / p.tile);
  const int slices = slicing_at(d).count;
  const long long qblocks = (nq + p.rows - 1) / p.rows;
  const bool share = d > F_MAX_D && slices > 1 && slices <= T_MAX_CLUSTER;
  const int per = share ? slices : 1;
#ifdef F32_SPLIT
  (void)card;
  (void)qblocks;
  return {max(1, min(min(F32_SPLIT, T_MAX_CLUSTER / per), ntiles)), share ? 1 : 0};
#else
  return {f32_split(card, qblocks * bh * (slices / per), ntiles, p.a, p.cost0, per), share ? 1 : 0};
#endif
}

int split_for(const F32Card& card, long long bh, long long nq, long long nk, long long d) {
  return plan_for(card, bh, nq, nk, d).split;
}

// A head of width d (a multiple of 4, at most D) on the FFMA instantiation D.
template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, const Strides* st,
               int batch, int heads, int nq, int nk, int d, float scale_log2,
               cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  const F32Card* card = nullptr;
  err = f32_card<D>(dev, &card);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((nq + F32<D>::BQ - 1) / F32<D>::BQ) * batch * heads;
  const int split = split_for(*card, (long long)batch * heads, nq, nk, d);
  return launch_split(attn_fwd_f32<D>, F32<D>::SMEM, blocks, split, stream,
                      static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<float*>(o), st[0], st[1], st[2],
                      st[3], heads, nq, nk, d, split, scale_log2);
}

template <int D, bool QRES>
int launch_tf32(const void* q, const void* k, const void* v, void* o, const Strides* st,
                int batch, int heads, int nq, int nk, int d, float scale_log2,
                cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  const F32Card* card = nullptr;
  err = tf32_card<D, QRES>(dev, &card);
  if (err != cudaSuccess) return (int)err;
  const Slicing sl = slicing_at(d);
  const SplitPlan plan = plan_for(*card, (long long)batch * heads, nq, nk, d);
  const int split = plan.split, share = plan.share, per = share ? sl.count : 1;
  const long long blocks = (long long)((nq + T_BM - 1) / T_BM) * (sl.count / per) * batch * heads;
  return launch_split(attn_fwd_tf32<D, QRES>, Tf32<D, QRES>::SMEM, blocks, split * per, stream,
                      static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<float*>(o), st[0], st[1], st[2],
                      st[3], heads, nq, nk, d, sl.count, sl.width, split, share, scale_log2);
}

}  // namespace

// The arguments of one call, packed by the wrapper into 28 int64 values, so
// that the host pays for one foreign argument instead of thirteen.
struct AttnArgs {
  long long q, k, v, o;        // device pointers
  long long stride[4][4];      // (batch, head, row, dim) element strides of q, k, v, o
  long long batch, heads, nq, nk, d;
  long long d_scale;           // the true head width, whose d^-1/2 scales the logits (<= d)
  long long dtype;             // 0 = float32, 1 = bfloat16 (tensor cores)
  long long stream;            // cudaStream_t
};

// Whether kernel A reads a head of width d in place in `dtype` (0 =
// float32, 1 = bfloat16): every width whose rows a 16-byte copy addresses,
// a multiple of 8 in bfloat16 (a TMA box's row) and of 4 in float32 (a
// cp.async). The wrapper zero-pads any other width to the next such one.
bool reads_in_place(long long d, long long dtype) {
  return (dtype == 0 || dtype == 1) && d >= 1 && d % (dtype == 1 ? 8 : 4) == 0;
}

// q (B, H, nq, d), k and v (B, H, nk, d), o (B, H, nq, d), each addressed
// through its own strides, d a width `reads_in_place` takes, at which q, k,
// v and o are read and written: no column past d is read or stored. In
// bfloat16 up to 256 columns the narrowest of the instantiations 16, 32,
// 64, 128 and 256 that holds d runs it (TMA boxes of the instantiation's
// width, zero past d), above 256 the wide variant; in float32 up to 64
// columns the narrowest FFMA instantiation (16, 32, 64; cp.async copies past
// d zero-filled), above 64 the tensor-core kernel. d_scale is the true
// width whose d^-1/2 scales the logits: d itself, or, for a head the caller
// zero-padded to d, its own width. Every operand's last dimension must be
// contiguous; in bfloat16, q, k and v must also start 16-byte aligned with
// every other stride a multiple of 8 elements, which a tensor map needs; in
// float32, all four must start 16-byte aligned with every other stride a
// multiple of 4 elements, which the 16-byte copies and stores need (the
// stride of a dimension of size 1 is never read, and is not checked).
// Returns a cudaError_t (0 on success); 1000 for arguments or a layout this
// kernel does not take, 1001 when a TMA descriptor cannot be encoded.
extern "C" int attn_forward(const AttnArgs* a) {
  const long long d = a->d;
  if (!reads_in_place(d, a->dtype) || d > INT_MAX || a->d_scale < 1 || a->d_scale > d ||
      a->batch <= 0 || a->heads <= 0 || a->nq <= 0 || a->nk <= 0 || a->batch > INT_MAX ||
      a->heads > INT_MAX || a->nq > INT_MAX || a->nk > INT_MAX)
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
  const int w = (int)d;
  cudaStream_t s = (cudaStream_t)a->stream;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)a->d_scale);
  if (a->dtype == 0) {
    if (w > MAX_D)
      return launch_tf32<256, false>(q, k, v, o, st, batch, heads, nq, nk, w, scale_log2, s);
    if (w > F_MAX_D && tf32_width(w) == 128)
      return launch_tf32<128, true>(q, k, v, o, st, batch, heads, nq, nk, w, scale_log2, s);
    if (w > F_MAX_D)
      return launch_tf32<256, true>(q, k, v, o, st, batch, heads, nq, nk, w, scale_log2, s);
    if (w <= 16) return launch_f32<16>(q, k, v, o, st, batch, heads, nq, nk, w, scale_log2, s);
    if (w <= 32) return launch_f32<32>(q, k, v, o, st, batch, heads, nq, nk, w, scale_log2, s);
    return launch_f32<64>(q, k, v, o, st, batch, heads, nq, nk, w, scale_log2, s);
  }
  if (w > MAX_D) return launch_bf16_wide(q, k, v, o, st, batch, heads, nq, nk, w, scale_log2, s);
  if (w <= 16) return launch_bf16<16>(q, k, v, o, st, batch, heads, nq, nk, w, scale_log2, s);
  if (w <= 32) return launch_bf16<32>(q, k, v, o, st, batch, heads, nq, nk, w, scale_log2, s);
  if (w <= 64) return launch_bf16<64>(q, k, v, o, st, batch, heads, nq, nk, w, scale_log2, s);
  if (w <= 128) return launch_bf16<128>(q, k, v, o, st, batch, heads, nq, nk, w, scale_log2, s);
  if (w <= 192) return launch_bf16<256, 3>(q, k, v, o, st, batch, heads, nq, nk, w, scale_log2, s);
  return launch_bf16<256>(q, k, v, o, st, batch, heads, nq, nk, w, scale_log2, s);
}

// 1 where kernel A reads a head of width d in place in `dtype` (0 =
// float32, 1 = bfloat16), else 0: the rule `attn_forward` holds its
// arguments to, which `attention.reads_in_place` mirrors.
extern "C" int attn_in_place(long long d, int dtype) { return reads_in_place(d, dtype) ? 1 : 0; }

// The split (cluster size) the f32 route takes for batch x heads = bh, these
// token counts and head width d (a multiple of 4) on the current card; a
// negative cudaError_t if the card cannot be queried.
extern "C" int attn_f32_split(long long bh, long long nq, long long nk, int d) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  const F32Card* card = nullptr;
  if (err == cudaSuccess) err = f32_card_at(d, dev, &card);
  if (err != cudaSuccess) return -(int)err;
  return split_for(*card, bh, nq, nk, d);
}

// 1 where the f32 route's slices share S for batch x heads = bh, these
// token counts and head width d on the current card, else 0; a negative
// cudaError_t if the card cannot be queried.
extern "C" int attn_f32_share(long long bh, long long nq, long long nk, int d) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  const F32Card* card = nullptr;
  if (err == cudaSuccess) err = f32_card_at(d, dev, &card);
  if (err != cudaSuccess) return -(int)err;
  return plan_for(*card, bh, nq, nk, d).share;
}

// How many column slices of O the f32 route computes a head of width d (a
// multiple of 4 above 64) in; their width in *width.
extern "C" int attn_f32_slices(long long d, int* width) {
  const Slicing sl = slicing_at(d);
  *width = sl.width;
  return sl.count;
}

// How many clusters of `split` CTAs (1-8; up to 16 for the tensor-core
// kernel's slices sharing S above 256 columns) of the f32 route at head
// width d the current card holds at once, which the choice of split reads
// (0 for sizes the kernel does not take); a negative cudaError_t if the
// card cannot be queried.
extern "C" int attn_f32_clusters(int split, int d) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  const F32Card* card = nullptr;
  if (err == cudaSuccess) err = f32_card_at(d, dev, &card);
  if (err != cudaSuccess) return -(int)err;
  return split >= 1 && split <= T_MAX_CLUSTER ? card->clusters[split] : 0;
}
