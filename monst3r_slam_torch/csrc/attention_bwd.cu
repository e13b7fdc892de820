// Kernel A's backward: dq, dk and dv of softmax attention O = softmax(Q K^T
// d^-1/2) V for bf16 q, k, v and output gradient dO, without an N x N
// tensor in device memory.
//
// Replaces no TPU kernel. The JAX package's Pallas attention kernel has no
// backward (training there differentiates its einsum attention), and the
// port's backward was `attention.sdpa_backward_plain`, plain PyTorch: the
// f32 logits, their scaling, the softmax, the bf16 probabilities, dP, the
// softmax backward and dS each a (B, H, N, N) tensor written to and read
// from device memory, ~64 bytes an element, and its products in f32 on the
// FP32 pipe. On a batch-12 384x512 training step of MonST3R (96 calls of
// (12, 16|12, 768, 64)) that took 334 of the step's 708 kernel ms on an
// H100. These kernels keep every N x N tile in registers: 41 ms.
//
// Bound on this card: the five products of an attention backward (S = Q K^T,
// dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K), 10 B H N^2 d
// operations, at the 989 TFLOP/s bf16 tensor-core peak: 73 us at (12, 16,
// 768, 64), 6.2 ms over the 96 calls of a training step; the bytes (q, k,
// v, dO read, dq, dk, dv written, 2 bytes each) take 39 us at 3.35 TB/s. So
// the kernels are bound by operations, and what the design does about it:
//   - Three kernels, in order on the caller's stream:
//     `attn_bwd_prep`, one CTA per (batch*head, 64 queries), walks the key
//     tiles, recomputes S and dP on the tensor cores and keeps, per row, an
//     online max, the sum of exp and D = sum_k P_k dP_k rescaled with the
//     max; it writes the row's log-sum-exp (base 2, of the scaled logits)
//     and D. D comes from P and dP, as the plain softmax backward takes it,
//     not from the forward's bf16-rounded O, so the forward writes nothing
//     for the backward and stays as it is.
//     `attn_bwd_dkdv`, one CTA per (batch*head, 64 keys), walks the query
//     tiles: P^T = exp2(S^T c - LSE), dV += P^T dO with P rounded to bf16
//     (where the plain backward rounds it), dS^T = P^T (dP^T - D) from P
//     and dP in f32, dK += dS^T Q with dS rounded to bf16 as the product's
//     input (the plain backward rounds dP to bf16 instead and keeps dS in
//     f32; `attention.backward_error_bound` bounds both); dK and dV are
//     accumulated in f32 registers and written once.
//     `attn_bwd_dq`, one CTA per (batch*head, 64 queries), walks the key
//     tiles, recomputes S, dP and dS, and writes dQ = dS K d^-1/2 once.
//     No float atomics: every sum runs in a fixed order, so two runs give
//     the same bits. The nine products are 1.8x the bound's five; the
//     alternative, dQ summed across key blocks, needs atomics or an f32
//     partial per key block in device memory.
//   - Products on mma.sync m16n8k16 (bf16 x bf16 -> f32). A CTA is four
//     warps; each warp owns 16 rows of the CTA's 64 and keeps its A
//     operands (its Q and dO rows, or its K and V rows) in registers for the
//     whole walk. The streamed 64-row tiles come from shared memory through
//     ldmatrix, plain for the operands read as B^T (K for S = Q K^T, V for
//     dP = dO V^T) and transposed for those read as B (dO for dV, Q for dK,
//     K for dQ). The products P^T dO and dS^T Q take P^T and dS^T from the
//     registers of the accumulators that computed them (the m16n8 C layout
//     is the m16n8k16 A layout), so no N x N tile touches shared memory.
//   - Each streamed tile (64 rows of 128 bytes) is copied with cp.async, 16
//     bytes a thread, into a two-stage ring: tile t + 1 lands while tile t
//     computes. A row's eight 16-byte chunks are stored XOR-swizzled by the
//     row's index mod 8, so the eight rows an ldmatrix reads fall in eight
//     bank groups, plain or transposed.
//   - Exponentials in log2 units: one FFMA and one MUFU ex2 a probability.
// Shapes: q, k, v and dO are read through their (batch, head, row) strides,
// the last dimension contiguous, every start 16-byte aligned and every
// other stride a multiple of 8 elements. One instantiation of width D = 64;
// a head of width d < 64, a multiple of 8, is read in place: the chunks
// past d land as zeros, so S and dP are as over d columns, and only the
// first d columns of dq, dk and dv are stored. Rows past nq or nk are
// zero-filled; keys past nk are masked out of S, queries past nq get a
// log-sum-exp of +inf and so a P of 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// One call's arguments, as `attention.py` packs them: 9 pointers, the
// (batch, head, row, dim) strides of q, k, v, dO, dq, dk and dv, the sizes
// and the stream. Outside the anonymous namespace, which would give the C
// entry that takes them internal linkage.
struct BwdArgs {
  long long q, k, v, dout, dq, dk, dv, lse, delta;
  long long stride[7][4];
  long long batch, heads, nq, nk, d, stream;
};

namespace {

constexpr int D = 64;          // instantiated head width
constexpr int BR = 64;         // rows a CTA owns, and rows of a streamed tile
constexpr int NWARP = 4;       // each over 16 of the CTA's rows
constexpr int NTHREAD = 32 * NWARP;
constexpr int TILE = BR * D;   // bf16 elements of one 64-row tile: 8 KB
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {  // in elements
  long long b, h, r;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) of a swizzled tile: 16-byte chunk c / 8 of
// row r stored at chunk (c / 8) ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * D + ((((c >> 3) ^ (r & 7))) << 3) + (c & 7)) * 2u;
}

// 16 bytes from src to shared memory, or 16 zero bytes where `valid` is
// false (source size 0: nothing is read, src need only be a valid address).
__device__ __forceinline__ void copy16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void copy_wait_all() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }

// This thread's share of a 64-row tile from g (row stride rs elements):
// rows at or past `rows` and the chunks past the head's width d zero-filled.
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const __nv_bfloat16* g, long long rs,
                                          int rows, int d, int tid) {
  const uint32_t base = smem_u32(s);
#pragma unroll
  for (int j = 0; j < TILE / 8 / NTHREAD; ++j) {
    const int i = tid + j * NTHREAD, r = i >> 3, c = (i & 7) << 3;
    const bool ok = r < rows && c < d;
    copy16(base + swz(r, c), ok ? g + r * rs + c : g, ok);
  }
}

// 64 f32 values of a row statistic (log-sum-exp or D) from g into s.
__device__ __forceinline__ void load_row_stats(float* s, const float* g, int tid) {
  if (tid < BR / 4) copy16(smem_u32(s + 4 * tid), g + 4 * tid, true);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU operation (ex2.approx, ~2 ulp; -inf gives 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// A fragments of this warp's 16 rows (from row r0) of a tile: a[kk] covers
// columns 16 kk to 16 kk + 15.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const __nv_bfloat16* s, int r0,
                                       int lane) {
  const uint32_t base = smem_u32(s);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], base + swz(r0 + (lane & 15), 16 * kk + (lane >> 4) * 8));
}

// A fragments from an m16n8 accumulator of 16 rows x 64 columns, rounded to
// bf16: the C layout of n-tiles 2 kk and 2 kk + 1 is the A layout of k-step kk.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16x2(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16x2(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// c (16 x 64) = a (16 x 64) B^T, B a tile stored row by row as [n][k]
// (S = Q K^T with the K tile, dP = dO V^T with the V tile).
__device__ __forceinline__ void gemm_abt(float (&c)[8][4], const uint32_t (&a)[4][4],
                                         const __nv_bfloat16* s, int lane) {
  const uint32_t base = smem_u32(s);
#pragma unroll
  for (int j = 0; j < 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, base + swz(16 * jp + (lane & 7) + ((lane >> 4) << 3),
                            16 * kk + ((lane >> 3) & 1) * 8));
      mma(c[2 * jp], a[kk], b[0], b[1]);
      mma(c[2 * jp + 1], a[kk], b[2], b[3]);
    }
}

// c (16 x 64) += a (16 x 64) B, B a tile stored row by row as [k][n]
// (dV += P^T dO, dK += dS^T Q, dQ += dS K).
__device__ __forceinline__ void gemm_ab(float (&c)[8][4], const uint32_t (&a)[4][4],
                                        const __nv_bfloat16* s, int lane) {
  const uint32_t base = smem_u32(s);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldsm_x4_t(b, base + swz(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                              16 * jp + ((lane >> 4) << 3)));
      mma(c[2 * jp], a[kk], b[0], b[1]);
      mma(c[2 * jp + 1], a[kk], b[2], b[3]);
    }
}

// Rows r0 + g and r0 + g + 8 (g = lane / 4) of a 16 x 64 accumulator,
// times `mul`, in bf16 into rows of g (row stride rs), the first d columns
// of rows before `rows`.
__device__ __forceinline__ void store_rows(__nv_bfloat16* g, long long rs, const float (&c)[8][4],
                                           float mul, int r0, int rows, int d, int lane) {
  const int row = r0 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (8 * j >= d) break;
    if (row < rows)
      *reinterpret_cast<uint32_t*>(g + row * rs + 8 * j + col) = pack_bf16x2(c[j][0] * mul, c[j][1] * mul);
    if (row + 8 < rows)
      *reinterpret_cast<uint32_t*>(g + (row + 8) * rs + 8 * j + col) =
          pack_bf16x2(c[j][2] * mul, c[j][3] * mul);
  }
}

// Keys at or past nk (in a tile starting at key k0) masked to -inf in S.
__device__ __forceinline__ void mask_keys(float (&s)[8][4], int k0, int nk, int lane) {
  if (k0 + BR <= nk) return;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (k0 + 8 * j + 2 * (lane & 3) + (e & 1) >= nk) s[j][e] = -INFINITY;
}

struct Block {  // the (batch, head) and 64-row block of a CTA
  int b, h, blk;
};

__device__ __forceinline__ Block block_of(int heads, int nblk) {
  const long long i = blockIdx.x;
  const int bh = (int)(i / nblk);
  return Block{bh / heads, bh % heads, (int)(i % nblk)};
}

__device__ __forceinline__ const __nv_bfloat16* at(const __nv_bfloat16* p, Strides st, Block blk,
                                                   int row) {
  return p + blk.b * st.b + blk.h * st.h + row * st.r;
}

// Per query row: the log-sum-exp of its scaled logits, base 2 (+inf past
// nq), and D = sum_k P_k dP_k.
__global__ void __launch_bounds__(NTHREAD, 3)
attn_bwd_prep(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              float* __restrict__ lse, float* __restrict__ delta, Strides sq, Strides sk,
              Strides sv, Strides sdo, int heads, int nq, int nk, int d, float c) {
  __shared__ __align__(128) __nv_bfloat16 ks[2][TILE], vs[2][TILE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nqb = (nq + BR - 1) / BR, ntile = (nk + BR - 1) / BR;
  const Block blk = block_of(heads, nqb);
  const int q0 = blk.blk * BR;
  // Q and dO go through the second stage, free until tile 1 is loaded.
  load_tile(ks[1], at(q, sq, blk, q0), sq.r, nq - q0, d, tid);
  load_tile(vs[1], at(dout, sdo, blk, q0), sdo.r, nq - q0, d, tid);
  load_tile(ks[0], at(k, sk, blk, 0), sk.r, nk, d, tid);
  load_tile(vs[0], at(v, sv, blk, 0), sv.r, nk, d, tid);
  copy_commit();
  copy_wait_all();
  __syncthreads();
  uint32_t qa[4][4], da[4][4];
  load_a(qa, ks[1], 16 * warp, lane);
  load_a(da, vs[1], 16 * warp, lane);
  __syncthreads();
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  for (int t = 0; t < ntile; ++t) {
    const int cur = t & 1;
    if (t + 1 < ntile) {
      const int k1 = (t + 1) * BR;
      load_tile(ks[cur ^ 1], at(k, sk, blk, k1), sk.r, nk - k1, d, tid);
      load_tile(vs[cur ^ 1], at(v, sv, blk, k1), sv.r, nk - k1, d, tid);
      copy_commit();
    }
    float s[8][4], dp[8][4];
    gemm_abt(s, qa, ks[cur], lane);
    gemm_abt(dp, da, vs[cur], lane);
    mask_keys(s, t * BR, nk, lane);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
      const float m_new = fmaxf(m[half], quad_max(mx) * c);
      const float alpha = fast_exp2(m[half] - m_new);
      float sum = 0.f, dot = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) {
          const float p = fast_exp2(fmaf(s[j][e], c, -m_new));
          sum += p;
          dot = fmaf(p, dp[j][e], dot);
        }
      l[half] = fmaf(l[half], alpha, sum);
      dsum[half] = fmaf(dsum[half], alpha, dot);
      m[half] = m_new;
    }
    copy_wait_all();
    __syncthreads();
  }
  const long long base = ((long long)blockIdx.x / nqb) * nqb * BR;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float lt = quad_sum(l[half]), dt = quad_sum(dsum[half]);
    const int row = q0 + 16 * warp + (lane >> 2) + 8 * half;
    if ((lane & 3) == 0) {
      lse[base + row] = row < nq ? m[half] + log2f(lt) : INFINITY;
      delta[base + row] = row < nq ? dt / lt : 0.f;
    }
  }
}

// dK and dV of 64 keys, over every query tile.
__global__ void __launch_bounds__(NTHREAD, 2)
attn_bwd_dkdv(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Strides sq,
              Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv, int heads, int nq,
              int nk, int d, float c, float scale) {
  __shared__ __align__(128) __nv_bfloat16 qs[2][TILE], dos[2][TILE];
  __shared__ __align__(16) float ls[2][BR], ds[2][BR];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nkb = (nk + BR - 1) / BR, ntile = (nq + BR - 1) / BR;
  const Block blk = block_of(heads, nkb);
  const int k0 = blk.blk * BR;
  const long long stat0 = ((long long)blockIdx.x / nkb) * ntile * BR;
  // K and V go through the second stage, free until tile 1 is loaded.
  load_tile(qs[1], at(k, sk, blk, k0), sk.r, nk - k0, d, tid);
  load_tile(dos[1], at(v, sv, blk, k0), sv.r, nk - k0, d, tid);
  load_tile(qs[0], at(q, sq, blk, 0), sq.r, nq, d, tid);
  load_tile(dos[0], at(dout, sdo, blk, 0), sdo.r, nq, d, tid);
  load_row_stats(ls[0], lse + stat0, tid);
  load_row_stats(ds[0], delta + stat0, tid);
  copy_commit();
  copy_wait_all();
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
  load_a(ka, qs[1], 16 * warp, lane);
  load_a(va, dos[1], 16 * warp, lane);
  __syncthreads();
  float dka[8][4], dva[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const int col = 2 * (lane & 3);
  for (int t = 0; t < ntile; ++t) {
    const int cur = t & 1;
    if (t + 1 < ntile) {
      const int q1 = (t + 1) * BR;
      load_tile(qs[cur ^ 1], at(q, sq, blk, q1), sq.r, nq - q1, d, tid);
      load_tile(dos[cur ^ 1], at(dout, sdo, blk, q1), sdo.r, nq - q1, d, tid);
      load_row_stats(ls[cur ^ 1], lse + stat0 + q1, tid);
      load_row_stats(ds[cur ^ 1], delta + stat0 + q1, tid);
      copy_commit();
    }
    // P^T (keys x queries) = exp2(S^T c - LSE[query]); dV += P^T dO.
    float p[8][4];
    gemm_abt(p, ka, qs[cur], lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lq = *reinterpret_cast<const float2*>(&ls[cur][8 * j + col]);
      p[j][0] = fast_exp2(fmaf(p[j][0], c, -lq.x));
      p[j][1] = fast_exp2(fmaf(p[j][1], c, -lq.y));
      p[j][2] = fast_exp2(fmaf(p[j][2], c, -lq.x));
      p[j][3] = fast_exp2(fmaf(p[j][3], c, -lq.y));
    }
    uint32_t pa[4][4];
    acc_to_a(pa, p);
    gemm_ab(dva, pa, dos[cur], lane);
    // dS^T = P^T (dP^T - D[query]), dP^T = V dO^T; dK += dS^T Q.
    float dp[8][4];
    gemm_abt(dp, va, dos[cur], lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dq = *reinterpret_cast<const float2*>(&ds[cur][8 * j + col]);
      dp[j][0] = p[j][0] * (dp[j][0] - dq.x);
      dp[j][1] = p[j][1] * (dp[j][1] - dq.y);
      dp[j][2] = p[j][2] * (dp[j][2] - dq.x);
      dp[j][3] = p[j][3] * (dp[j][3] - dq.y);
    }
    acc_to_a(pa, dp);
    gemm_ab(dka, pa, qs[cur], lane);
    copy_wait_all();
    __syncthreads();
  }
  store_rows(dk + blk.b * sdk.b + blk.h * sdk.h, sdk.r, dka, scale, k0 + 16 * warp, nk, d, lane);
  store_rows(dv + blk.b * sdv.b + blk.h * sdv.h, sdv.r, dva, 1.f, k0 + 16 * warp, nk, d, lane);
}

// dQ of 64 queries, over every key tile.
__global__ void __launch_bounds__(NTHREAD, 3)
attn_bwd_dq(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo,
            Strides sdq, int heads, int nq, int nk, int d, float c, float scale) {
  __shared__ __align__(128) __nv_bfloat16 ks[2][TILE], vs[2][TILE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nqb = (nq + BR - 1) / BR, ntile = (nk + BR - 1) / BR;
  const Block blk = block_of(heads, nqb);
  const int q0 = blk.blk * BR;
  load_tile(ks[1], at(q, sq, blk, q0), sq.r, nq - q0, d, tid);
  load_tile(vs[1], at(dout, sdo, blk, q0), sdo.r, nq - q0, d, tid);
  load_tile(ks[0], at(k, sk, blk, 0), sk.r, nk, d, tid);
  load_tile(vs[0], at(v, sv, blk, 0), sv.r, nk, d, tid);
  copy_commit();
  const long long row0 = ((long long)blockIdx.x / nqb) * nqb * BR + q0 + 16 * warp + (lane >> 2);
  const float lse_row[2] = {lse[row0], lse[row0 + 8]};
  const float d_row[2] = {delta[row0], delta[row0 + 8]};
  copy_wait_all();
  __syncthreads();
  uint32_t qa[4][4], da[4][4];
  load_a(qa, ks[1], 16 * warp, lane);
  load_a(da, vs[1], 16 * warp, lane);
  __syncthreads();
  float dqa[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;
  for (int t = 0; t < ntile; ++t) {
    const int cur = t & 1;
    if (t + 1 < ntile) {
      const int k1 = (t + 1) * BR;
      load_tile(ks[cur ^ 1], at(k, sk, blk, k1), sk.r, nk - k1, d, tid);
      load_tile(vs[cur ^ 1], at(v, sv, blk, k1), sv.r, nk - k1, d, tid);
      copy_commit();
    }
    float p[8][4], dp[8][4];
    gemm_abt(p, qa, ks[cur], lane);
    mask_keys(p, t * BR, nk, lane);
    gemm_abt(dp, da, vs[cur], lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = fast_exp2(fmaf(p[j][e], c, -lse_row[e >> 1]));
        dp[j][e] = pe * (dp[j][e] - d_row[e >> 1]);
      }
    uint32_t dsa[4][4];
    acc_to_a(dsa, dp);
    gemm_ab(dqa, dsa, ks[cur], lane);
    copy_wait_all();
    __syncthreads();
  }
  store_rows(dq + blk.b * sdq.b + blk.h * sdq.h, sdq.r, dqa, scale, q0 + 16 * warp, nq, d, lane);
}

}  // namespace

// The three kernels on a.stream. 0, a cudaError_t of a refused launch, or
// 1000 for arguments the kernels do not take: bf16 heads of width d, a
// multiple of 8 up to 64, the last dimension contiguous, starts 16-byte
// aligned, every other stride a multiple of 8 elements, lse and delta
// batch*heads*ceil(nq/64)*64 floats each.
extern "C" int attn_backward(const BwdArgs* a) {
  const long long d = a->d;
  if (d < 8 || d > D || (d & 7) || a->batch <= 0 || a->heads <= 0 || a->nq <= 0 || a->nk <= 0 ||
      a->nq > INT32_MAX - BR || a->nk > INT32_MAX - BR || a->heads > INT32_MAX)
    return 1000;
  const long long bh = a->batch * a->heads;
  const long long nqb = (a->nq + BR - 1) / BR, nkb = (a->nk + BR - 1) / BR;
  if (bh > INT32_MAX || bh * nqb > INT32_MAX || bh * nkb > INT32_MAX) return 1000;
  const long long ptr[7] = {a->q, a->k, a->v, a->dout, a->dq, a->dk, a->dv};
  Strides st[7];
  for (int i = 0; i < 7; ++i) {
    if (a->stride[i][3] != 1) return 1000;
    const long long rows = i == 1 || i == 2 || i == 5 || i == 6 ? a->nk : a->nq;
    st[i] = Strides{a->batch > 1 ? a->stride[i][0] : d, a->heads > 1 ? a->stride[i][1] : d,
                    rows > 1 ? a->stride[i][2] : d};
    if ((ptr[i] & 15) || (st[i].b & 7) || (st[i].h & 7) || (st[i].r & 7)) return 1000;
  }
  if ((a->lse & 15) || (a->delta & 15)) return 1000;
  using bf = __nv_bfloat16;
  const bf* q = (const bf*)a->q;
  const bf* k = (const bf*)a->k;
  const bf* v = (const bf*)a->v;
  const bf* dout = (const bf*)a->dout;
  float* lse = (float*)a->lse;
  float* delta = (float*)a->delta;
  const int heads = (int)a->heads, nq = (int)a->nq, nk = (int)a->nk, w = (int)d;
  const float scale = (float)(1.0 / sqrt((double)d));
  const float c = scale * LOG2E;
  cudaStream_t s = (cudaStream_t)a->stream;
  attn_bwd_prep<<<(unsigned)(bh * nqb), NTHREAD, 0, s>>>(q, k, v, dout, lse, delta, st[0], st[1],
                                                         st[2], st[3], heads, nq, nk, w, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv<<<(unsigned)(bh * nkb), NTHREAD, 0, s>>>(q, k, v, dout, lse, delta, (bf*)a->dk,
                                                         (bf*)a->dv, st[0], st[1], st[2], st[3],
                                                         st[5], st[6], heads, nq, nk, w, c, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq<<<(unsigned)(bh * nqb), NTHREAD, 0, s>>>(q, k, v, dout, lse, delta, (bf*)a->dq,
                                                       st[0], st[1], st[2], st[3], st[4], heads,
                                                       nq, nk, w, c, scale);
  return (int)cudaGetLastError();
}
