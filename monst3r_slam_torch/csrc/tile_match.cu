// Kernel B: tile matcher, one 16x16 source tile (256 queries) at a time.
//
// Replaces the JAX package's Pallas kernel in `ops/matching_pallas.py`
// (`tile_match_pallas`, body `_kernel`) with its semantics:
//   1. ray association: argmax over the crop x crop target window of the
//      f32 dot of the query's unit ray with each target ray (ties -> lowest
//      flat index, as jnp.argmax);
//   2. convergence: a parabola through the flat neighbours best+-1 (x) and
//      best+-crop (y) of the peak (a neighbour outside [0, crop^2) counts as
//      0), gain = diff^2 / (8 max(2 s0 - tot, 1e-12)) when 2 s0 - tot > 1e-12,
//      clamped >= 0; converged = 2 - 2 peak < conv_thresh;
//   3. descriptor refinement: argmax of the bf16 descriptor dot (f32 sums)
//      within +-window px of the ray match, clipped to the crop, no dilation
//      (ties -> lowest flat index);
//   4. absolute u, v as int32 from the (16-aligned) crop corner.
//
// Bound on this card: at 384x512 (768 tiles) the call reads ~12 MB of inputs
// once, so device memory is not the limit; the ray scan (768 x 256 queries x
// 2304 positions x 5 explicitly rounded f32 operations, ~34 us at the f32
// peak) is, and the descriptor window (~3.4 G bf16 multiply-adds within the
// windows, ~7 us at the bf16 peak) is small next to it on the tensor cores.
//
// Design (the earlier one staged each crop with per-thread 4-byte loads and
// ran the descriptor window as scalar f32 multiply-adds from shared memory,
// one thread per query, which took two thirds of its time):
//   - Persistent grid: min(T, CTAs that fit) CTAs of 512 threads walk the
//     tiles t = blockIdx.x + k gridDim.x, so a tile's crop is copied while
//     the one before it computes.
//   - Staging by bulk copy: warp 0 issues one `cp.async.bulk` per crop row
//     (rows are 16-byte aligned: corners are multiples of 16, the image width
//     and the crop multiples of 4), completing on an mbarrier; no thread
//     spends registers or instructions on the bytes. Shared memory holds a
//     two-slot ring of f32 rays and one descriptor slot; at crop 48 and fd 24
//     that is 168,992 B in all (2 x 27,648 + 110,592 B of crops, 3,104 B of
//     ray-match scratch and barriers: `smem_bytes`), so one CTA runs per SM.
//     `dispatch` refuses a crop whose slots do not fit. Tile t+2's rays are requested when
//     tile t is done and land during tile t+1; tile t+1's descriptors are
//     requested when tile t's descriptor step releases the slot and land
//     during tile t+1's ray scan.
//   - Ray scan and stencil, bit for bit as the plain PyTorch version: every
//     product and sum explicitly rounded (no FMA contraction), in its order,
//     (qx rx + qy ry) + qz rz. Two threads per query scan one half of the
//     crop each, with four independent running maxima over 16-byte loads of
//     four positions, which breaks the compare-and-select chain; the maxima
//     merge with ties to the lowest index, so the argmax is the plain one.
//   - Descriptor window on the tensor cores: warp w takes queries 16w..16w+15
//     (one row of the source tile) as the A operand of mma.sync m16n8k16
//     (+ m16n8k8 for fd 24, + a second k16 for fd 32), loaded once; the
//     crop's descriptors are the B operand, read by ldmatrix straight from
//     the [position][channel] layout the bulk copy lands (a 48-byte position
//     stride makes each 8-row ldmatrix phase conflict-free). n walks 8-column
//     chunks, two a pass, of the rows and columns that some of the warp's 16
//     windows reach. Each thread keeps a running (best score, flat index) for its two
//     queries straight from the accumulator fragment, masked by the query's
//     own window; the four lanes of a quad merge at the end, ties to the
//     lowest index. The score map never leaves registers.
//     Why mma.sync and not wgmma: fd 24 is no multiple of wgmma's k16 and
//     wgmma reads B from a swizzled or padded layout, which would need a
//     second, zero-padded copy of the crop; the product is small (~22 GFLOP
//     even over whole crops, ~0.02 ms at the bf16 peak), and the mask and
//     argmax, not the product, set the step's time.
//   - Rounding: the tensor cores sum the fd exact bf16 products in an order
//     of their own, so a window score may differ from the plain version's
//     sequential f32 sum in its last bits, and the descriptor match may
//     differ where two window scores lie that close. The wrapper module's
//     `rounding_check` states the admissible difference. The ray match and
//     the convergence flag stay bit for bit.
//
// Phase split: the template parameter PHASE cuts the body after each step,
// as the TPU phase profiler `scripts/profile_pallas_phases.py` (`run_variant`,
// body `make_kernel`) cuts the Pallas kernel, so that the difference of two
// instantiations' times is one step's time:
//   PHASE_STAGE   stage the crops only: u = cx, v = cy, conv = 0;
//   PHASE_RAY     plus the ray argmax: u, v = corner + ray match, conv = 0;
//   PHASE_STENCIL plus the convergence test: conv as in the full kernel;
//   PHASE_FULL    the whole kernel (the main path's instantiation).
// Every cut runs the same copy pipeline and waits for every crop: the bulk
// copies and barrier waits are volatile, so the compiler keeps them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_TSZ = 256;           // queries per tile (a 16x16 source tile)
constexpr int NTHREAD = 2 * MAX_TSZ;   // two ray-scan threads per query; 16 warps
constexpr int PHASE_STAGE = 0, PHASE_RAY = 1, PHASE_STENCIL = 2, PHASE_FULL = 3;
constexpr int SMEM_LIMIT = 232448;     // bytes of shared memory one Hopper block may use

// Function attributes hold per device: a process that launches on several
// cards sets them on each card at its first launch there.
constexpr int MAX_DEVICES = 64;

cudaError_t current_device(int* dev) {
  cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess && (*dev < 0 || *dev >= MAX_DEVICES)) err = cudaErrorInvalidDevice;
  return err;
}
// After the crops: the second scan half's partial maxima (score, index), the
// ray matches, and three mbarriers (rays slot 0, rays slot 1, descriptors).
constexpr int SMEM_EXTRA = 3 * MAX_TSZ * 4 + 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

constexpr int smem_bytes(int crop, int fd) {
  return crop * crop * (2 * 3 * 4 + 2 * fd) + SMEM_EXTRA;
}

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

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of `bar` with this parity. A copy that never completes
// traps after 2 s (the launch fails) rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = global_ns();
    else if (global_ns() - t0 > 2000000000ull)
      __trap();
  }
}

// Copy the crop x crop window at (cx, cy) of an image of `px_bytes` bytes per
// pixel into dst, one bulk copy per crop row, completing on bar. Warp-wide.
__device__ __forceinline__ void stage_crop(void* dst, const void* img, int px_bytes, int cx,
                                           int cy, int w, int crop, uint64_t* bar, int lane) {
  const uint32_t row = crop * px_bytes;
  if (lane == 0) mbar_expect_tx(bar, row * crop);
  __syncwarp();
  for (int r = lane; r < crop; r += 32) {
    const char* src = static_cast<const char*>(img) + ((size_t)(cy + r) * w + cx) * px_bytes;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_u32(static_cast<char*>(dst) + (size_t)r * row)), "l"(src), "r"(row),
        "r"(smem_u32(bar))
        : "memory");
  }
}

__device__ __forceinline__ float ray_dot(float qx, float qy, float qz, float rx, float ry,
                                         float rz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(qx, rx), __fmul_rn(qy, ry)), __fmul_rn(qz, rz));
}

__device__ __forceinline__ float gain(float diff, float tot, float s0) {
  const float denom = __fsub_rn(2.0f * s0, tot);
  float g = 0.0f;
  if (denom > 1e-12f) g = __fdiv_rn(__fmul_rn(diff, diff), 8.0f * fmaxf(denom, 1e-12f));
  return fmaxf(g, 0.0f);
}

// (score, index) of the first maximum of the ray dot over positions
// [j0, j1) of the staged rays rs ([m][3] f32); j0, j1 multiples of 4. Four
// running maxima over j = 4i + a each keep their first maximum; merged with
// ties to the lowest index, that is the first maximum of the range.
__device__ __forceinline__ void ray_scan(float qx, float qy, float qz, const float* rs, int j0,
                                         int j1, float& s_best, int& j_best) {
  float sb[4];
  int jb[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    sb[a] = -INFINITY;
    jb[a] = j0 + a;
  }
  const float4* p = reinterpret_cast<const float4*>(rs + 3 * j0);
#pragma unroll 2
  for (int j = j0; j < j1; j += 4, p += 3) {
    const float4 x = p[0], y = p[1], z = p[2];
    const float d[4] = {ray_dot(qx, qy, qz, x.x, x.y, x.z), ray_dot(qx, qy, qz, x.w, y.x, y.y),
                        ray_dot(qx, qy, qz, y.z, y.w, z.x), ray_dot(qx, qy, qz, z.y, z.z, z.w)};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (d[a] > sb[a]) {
        sb[a] = d[a];
        jb[a] = j + a;
      }
    }
  }
  s_best = sb[0];
  j_best = jb[0];
#pragma unroll
  for (int a = 1; a < 4; ++a) {
    if (sb[a] > s_best || (sb[a] == s_best && jb[a] < j_best)) {
      s_best = sb[a];
      j_best = jb[a];
    }
  }
}

__device__ __forceinline__ void ldsm_x1(uint32_t addr, uint32_t& r0) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];"
               : "=r"(r0)
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

// d += A (16x16 bf16, row) B (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t* a, uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A (16x8 bf16, row) B (8x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t* a, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// Scores of this thread's accumulator rows (queries r0, r1) against the 8
// positions j0..j0+7 of the staged descriptors: d[0], d[1] row r0 at
// j0 + 2 (lane % 4) (+1), d[2], d[3] row r1. A fragments in a (FD / 4
// registers). A position past the crop keeps its address inside it; the
// caller masks it.
template <int FD>
__device__ __forceinline__ void chunk_scores(const uint32_t* a, uint32_t ds_base, int j0, int m,
                                             int lane, float (&d)[4]) {
  const uint32_t addr = ds_base + min(j0 + (lane & 7), m - 1) * (FD * 2);
  if constexpr (FD == 16) {
    uint32_t b0, b1;
    ldsm_x2(addr + ((lane >> 3) & 1) * 16, b0, b1);
    mma_k16(d, a, b0, b1);
  } else if constexpr (FD == 24) {
    uint32_t b0, b1, b2;
    ldsm_x2(addr + ((lane >> 3) & 1) * 16, b0, b1);
    ldsm_x1(addr + 32, b2);
    mma_k16(d, a, b0, b1);
    mma_k8(d, a + 4, b2);
  } else {
    uint32_t b0, b1, b2, b3;
    ldsm_x4(addr + (lane >> 3) * 16, b0, b1, b2, b3);
    mma_k16(d, a, b0, b1);
    mma_k16(d, a + 4, b2, b3);
  }
}

// Step 3 for one warp: queries q0..q0+15 of the tile against the staged
// descriptors ds ([m][FD] bf16). match holds the tile's ray matches, qd the
// tile's query descriptors, u_out/v_out its outputs.
template <int FD>
__device__ __forceinline__ void descriptor_window(const __nv_bfloat16* ds, const int* match,
                                                  const __nv_bfloat16* qd, int* u_out,
                                                  int* v_out, int q0, int tsz, int crop,
                                                  int window, int cx, int cy, int lane) {
  const int quad = lane & 3;
  const int m = crop * crop;
  // This thread's two queries (accumulator rows lane/4 and lane/4 + 8) and
  // their windows, clipped to the crop; a padding row past tsz has none.
  int r[2], ulo[2], uhi[2], vlo[2], vhi[2];
  bool ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r[i] = q0 + (lane >> 2) + 8 * i;
    ok[i] = r[i] < tsz;
    const int b = ok[i] ? match[r[i]] : 0;
    const int pu = b % crop, pv = b / crop;
    ulo[i] = ok[i] ? max(pu - window, 0) : crop;
    uhi[i] = ok[i] ? min(pu + window, crop - 1) : -1;
    vlo[i] = ok[i] ? max(pv - window, 0) : crop;
    vhi[i] = ok[i] ? min(pv + window, crop - 1) : -1;
  }
  // The rows and 8-column chunks that some window of the warp reaches.
  const int bv_lo = __reduce_min_sync(FULL_MASK, min(vlo[0], vlo[1]));
  const int bv_hi = __reduce_max_sync(FULL_MASK, max(vhi[0], vhi[1]));
  const int c_lo = __reduce_min_sync(FULL_MASK, min(ulo[0], ulo[1])) >> 3;
  const int c_hi = __reduce_max_sync(FULL_MASK, max(uhi[0], uhi[1])) >> 3;

  // A fragments, once: k16 block kb holds channels 16kb + 2quad (+1) and
  // +8 of rows r0, r1; fd 24's k8 tail channels 16 + 2quad (+1).
  constexpr int KW = FD / 2;  // 32-bit words (bf16 pairs) per query
  const uint32_t* qw = reinterpret_cast<const uint32_t*>(qd);
  uint32_t a[FD / 4];
#pragma unroll
  for (int kb = 0; kb < FD / 16; ++kb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        a[4 * kb + 2 * h + i] = ok[i] ? qw[r[i] * KW + 8 * kb + 4 * h + quad] : 0u;
    }
  }
  if constexpr (FD % 16 != 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) a[FD / 4 - 2 + i] = ok[i] ? qw[r[i] * KW + KW - 4 + quad] : 0u;
  }

  float best[2] = {-INFINITY, -INFINITY};
  int bj[2] = {INT_MAX, INT_MAX};
  const uint32_t ds_base = smem_u32(ds);
  for (int v = bv_lo; v <= bv_hi; ++v) {
    // In-window test of a column u: (unsigned)(u - lo) <= len; a row outside
    // the window gets a lo no column reaches.
    int lo[2];
    uint32_t len[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool row = v >= vlo[i] && v <= vhi[i];
      lo[i] = row ? ulo[i] : (1 << 20);
      len[i] = row ? (uint32_t)(uhi[i] - ulo[i]) : 0u;
    }
    // Two chunks a pass, independent until the updates (the second may lie
    // past c_hi, outside every window: masked).
    for (int c = c_lo; c <= c_hi; c += 2) {
      float d[2][4] = {};
      chunk_scores<FD>(a, ds_base, v * crop + 8 * c, m, lane, d[0]);
      chunk_scores<FD>(a, ds_base, v * crop + 8 * c + 8, m, lane, d[1]);
      // d[h][0], d[h][1]: row r0, columns uc, uc + 1; d[h][2], d[h][3]: row
      // r1. Each thread sees its columns in increasing flat index, so a
      // strict > keeps the first maximum.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int uc = 8 * (c + h) + 2 * quad;
        const int jc = v * crop + uc;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, du = e & 1;
          if ((uint32_t)(uc + du - lo[i]) <= len[i] && d[h][e] > best[i]) {
            best[i] = d[h][e];
            bj[i] = jc + du;
          }
        }
      }
    }
  }
  // Merge the quad's four column sets: the larger score, ties to the lower
  // index.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ob = __shfl_xor_sync(FULL_MASK, best[i], off);
      const int oj = __shfl_xor_sync(FULL_MASK, bj[i], off);
      if (ob > best[i] || (ob == best[i] && oj < bj[i])) {
        best[i] = ob;
        bj[i] = oj;
      }
    }
  }
  if (quad == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!ok[i]) continue;
      // No score above -inf in the window: its first position.
      const int j = bj[i] == INT_MAX ? vlo[i] * crop + ulo[i] : bj[i];
      u_out[r[i]] = cx + j % crop;
      v_out[r[i]] = cy + j / crop;
    }
  }
}

template <int FD, int PHASE>
__global__ void __launch_bounds__(NTHREAD, 1)
tile_match_kernel(const float* __restrict__ rays_img, const __nv_bfloat16* __restrict__ desc_img,
                  const float* __restrict__ q_rays, const __nv_bfloat16* __restrict__ q_desc,
                  const int* __restrict__ corners, int* __restrict__ u_out,
                  int* __restrict__ v_out, int* __restrict__ conv_out, int T, int tsz, int w,
                  int crop, int window, float conv_thresh) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int m = crop * crop;
  float* rs0 = reinterpret_cast<float*>(smem_raw);                   // [m][3]
  float* rs1 = rs0 + 3 * m;                                          // [m][3]
  __nv_bfloat16* ds = reinterpret_cast<__nv_bfloat16*>(rs1 + 3 * m);  // [m][FD]
  float* part_s = reinterpret_cast<float*>(ds + (size_t)m * FD);     // [MAX_TSZ]
  int* part_j = reinterpret_cast<int*>(part_s + MAX_TSZ);            // [MAX_TSZ]
  int* match = part_j + MAX_TSZ;                                     // [MAX_TSZ]
  uint64_t* bar = reinterpret_cast<uint64_t*>(match + MAX_TSZ);      // rays 0, rays 1, desc

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = gridDim.x;
  const int qi = tid % MAX_TSZ, half = tid / MAX_TSZ;  // query, and which half of the crop it scans
  const bool active = qi < tsz;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {  // gridDim.x <= T: every CTA has a first tile
    const int t = blockIdx.x;
    stage_crop(rs0, rays_img, 12, corners[2 * t], corners[2 * t + 1], w, crop, &bar[0], lane);
    stage_crop(ds, desc_img, 2 * FD, corners[2 * t], corners[2 * t + 1], w, crop, &bar[2], lane);
    if (t + G < T)
      stage_crop(rs1, rays_img, 12, corners[2 * (t + G)], corners[2 * (t + G) + 1], w, crop,
                 &bar[1], lane);
  }

  int k = 0;
  for (int t = blockIdx.x; t < T; t += G, ++k) {
    const int s = k & 1;
    float* rs = s ? rs1 : rs0;
    const int cx = corners[2 * t], cy = corners[2 * t + 1];
    const size_t qo = (size_t)t * tsz + qi;
    mbar_wait(&bar[s], (k >> 1) & 1);  // this tile's rays

    if constexpr (PHASE >= PHASE_RAY) {
      // 1. ray association: each half of the crop, then the merge (ties to
      // the first half, whose indices are lower).
      float qx = 0.0f, qy = 0.0f, qz = 0.0f, s0 = -INFINITY;
      int best = 0;
      if (active) {
        qx = q_rays[qo * 3];
        qy = q_rays[qo * 3 + 1];
        qz = q_rays[qo * 3 + 2];
        const int mid = m / 2;  // a multiple of 8: crop is a multiple of 4
        ray_scan(qx, qy, qz, rs, half ? mid : 0, half ? m : mid, s0, best);
        if (half) {
          part_s[qi] = s0;
          part_j[qi] = best;
        }
      }
      __syncthreads();
      if (active && !half) {
        if (part_s[qi] > s0) {
          s0 = part_s[qi];
          best = part_j[qi];
        }
        match[qi] = best;
        int conv = 0;
        if constexpr (PHASE >= PHASE_STENCIL) {
          // 2. five-point stencil on flat neighbours
          auto at = [&](int j) {
            return (j >= 0 && j < m) ? ray_dot(qx, qy, qz, rs[3 * j], rs[3 * j + 1], rs[3 * j + 2])
                                     : 0.0f;
          };
          const float sxp = at(best + 1), sxm = at(best - 1);
          const float syp = at(best + crop), sym = at(best - crop);
          const float gx = gain(__fsub_rn(sxp, sxm), __fadd_rn(sxp, sxm), s0);
          const float gy = gain(__fsub_rn(syp, sym), __fadd_rn(syp, sym), s0);
          const float peak = __fadd_rn(__fadd_rn(s0, gx), gy);
          conv = __fsub_rn(2.0f, 2.0f * peak) < conv_thresh ? 1 : 0;
        }
        conv_out[qo] = conv;
        if constexpr (PHASE < PHASE_FULL) {
          u_out[qo] = cx + best % crop;
          v_out[qo] = cy + best / crop;
        }
      }
    }

    mbar_wait(&bar[2], k & 1);  // this tile's descriptors
    if constexpr (PHASE == PHASE_STAGE) {
      if (active && !half) {
        u_out[qo] = cx;
        v_out[qo] = cy;
        conv_out[qo] = 0;
      }
    }
    if constexpr (PHASE == PHASE_FULL) {
      __syncthreads();  // the ray matches
      // 3-4. descriptor argmax within +-window of the ray match, absolute pixel
      const size_t tq = (size_t)t * tsz;
      if (warp * 16 < tsz)
        descriptor_window<FD>(ds, match, q_desc + tq * FD, u_out + tq, v_out + tq, warp * 16,
                              tsz, crop, window, cx, cy, lane);
    }

    __syncthreads();  // every read of this tile's ray slot and the descriptor slot is done
    if (warp == 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const int t1 = t + G, t2 = t + 2 * G;
      if (t1 < T)
        stage_crop(ds, desc_img, 2 * FD, corners[2 * t1], corners[2 * t1 + 1], w, crop, &bar[2],
                   lane);
      if (t2 < T)
        stage_crop(rs, rays_img, 12, corners[2 * t2], corners[2 * t2 + 1], w, crop, &bar[s],
                   lane);
    }
  }
}

template <int FD, int PHASE>
int launch(const void* rays_img, const void* desc_img, const void* q_rays, const void* q_desc,
           const void* corners, void* u_out, void* v_out, void* conv_out, int T, int tsz, int w,
           int crop, int window, float conv_thresh, cudaStream_t stream) {
  const int smem = smem_bytes(crop, FD);
  static int configured[MAX_DEVICES] = {}, per_sm[MAX_DEVICES] = {}, sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem != configured[dev]) {
    err = cudaFuncSetAttribute(tile_match_kernel<FD, PHASE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[dev], tile_match_kernel<FD, PHASE>, NTHREAD, smem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = smem;
  }
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (per_sm[dev] < 1) return (int)cudaErrorInvalidConfiguration;
  const int slots = sms[dev] * per_sm[dev];
  const int grid = T < slots ? T : slots;  // persistent: CTAs walk the tiles
  tile_match_kernel<FD, PHASE><<<grid, NTHREAD, smem, stream>>>(
      static_cast<const float*>(rays_img), static_cast<const __nv_bfloat16*>(desc_img),
      static_cast<const float*>(q_rays), static_cast<const __nv_bfloat16*>(q_desc),
      static_cast<const int*>(corners), static_cast<int*>(u_out), static_cast<int*>(v_out),
      static_cast<int*>(conv_out), T, tsz, w, crop, window, conv_thresh);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int PHASE>
int dispatch(const void* rays_img, const void* desc_img, const void* q_rays, const void* q_desc,
             const void* corners, void* u_out, void* v_out, void* conv_out, int T, int tsz,
             int h, int w, int fd, int crop, int window, float conv_thresh, void* stream) {
  // The bulk copies move whole crop rows of 16-byte multiples from 16-byte
  // aligned addresses: crop and w multiples of 4, the images 16-byte aligned.
  if (T <= 0 || tsz <= 0 || tsz > MAX_TSZ || crop <= 0 || crop > h || crop > w || crop % 4 ||
      w % 4 || !aligned16(rays_img) || !aligned16(desc_img) || !aligned16(q_desc) ||
      smem_bytes(crop, fd) > SMEM_LIMIT)
    return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fd) {
    case 16:
      return launch<16, PHASE>(rays_img, desc_img, q_rays, q_desc, corners, u_out, v_out,
                               conv_out, T, tsz, w, crop, window, conv_thresh, s);
    case 24:
      return launch<24, PHASE>(rays_img, desc_img, q_rays, q_desc, corners, u_out, v_out,
                               conv_out, T, tsz, w, crop, window, conv_thresh, s);
    case 32:
      return launch<32, PHASE>(rays_img, desc_img, q_rays, q_desc, corners, u_out, v_out,
                               conv_out, T, tsz, w, crop, window, conv_thresh, s);
    default:
      return 1000;
  }
}

}  // namespace

// rays_img (h, w, 3) f32; desc_img (h, w, fd) bf16; q_rays (T, tsz, 3) f32;
// q_desc (T, tsz, fd) bf16; corners (T, 2) int32 (x, y), already clipped and
// 16-aligned; outputs u, v, conv (T, tsz) int32. Returns a cudaError_t
// (0 on success); 1000 for arguments this kernel does not take.
extern "C" int tile_match_forward(const void* rays_img, const void* desc_img, const void* q_rays,
                                  const void* q_desc, const void* corners, void* u_out,
                                  void* v_out, void* conv_out, int T, int tsz, int h, int w,
                                  int fd, int crop, int window, float conv_thresh, void* stream) {
  return dispatch<PHASE_FULL>(rays_img, desc_img, q_rays, q_desc, corners, u_out, v_out,
                              conv_out, T, tsz, h, w, fd, crop, window, conv_thresh, stream);
}

// The same call cut after `phase` (0 stage, 1 ray, 2 stencil, 3 full).
extern "C" int tile_match_phase_forward(const void* rays_img, const void* desc_img,
                                        const void* q_rays, const void* q_desc,
                                        const void* corners, void* u_out, void* v_out,
                                        void* conv_out, int T, int tsz, int h, int w, int fd,
                                        int crop, int window, float conv_thresh, void* stream,
                                        int phase) {
  switch (phase) {
    case PHASE_STAGE:
      return dispatch<PHASE_STAGE>(rays_img, desc_img, q_rays, q_desc, corners, u_out, v_out,
                                   conv_out, T, tsz, h, w, fd, crop, window, conv_thresh, stream);
    case PHASE_RAY:
      return dispatch<PHASE_RAY>(rays_img, desc_img, q_rays, q_desc, corners, u_out, v_out,
                                 conv_out, T, tsz, h, w, fd, crop, window, conv_thresh, stream);
    case PHASE_STENCIL:
      return dispatch<PHASE_STENCIL>(rays_img, desc_img, q_rays, q_desc, corners, u_out, v_out,
                                     conv_out, T, tsz, h, w, fd, crop, window, conv_thresh,
                                     stream);
    case PHASE_FULL:
      return dispatch<PHASE_FULL>(rays_img, desc_img, q_rays, q_desc, corners, u_out, v_out,
                                  conv_out, T, tsz, h, w, fd, crop, window, conv_thresh, stream);
    default:
      return 1000;
  }
}
