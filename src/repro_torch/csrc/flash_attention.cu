// Flash attention (online softmax) for Hopper (sm_90a), with GQA and a
// causal mask: q (B,Hq,S,D), k/v (B,Hkv,Sk,D) -> o (B,Hq,S,D).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:58
// (flash_attention, _flash_kernel at :22).  There the grid is
// (B*Hq, S/bq, Sk/bk); the kv axis runs in order on one core and VMEM
// scratch carries the running max m, denominator l and accumulator in f32;
// the kv head h // group is picked in the BlockSpec index map.
//
// Bound on the H100: 4 * S * Sk * D flops per head (about half of it under
// the causal mask) against 2 * (S + Sk) * D elements of q, k, v and o, so at
// the qwen2-0.5b widths (D 64, S 4096) it is the operations: 989 TFLOP/s of
// bf16 tensor cores, or the 67 TFLOP/s of the f32 CUDA cores (TF32 would
// miss the 2e-5 tolerance).  Both kernels below share the frame:
//   * one block per (b * Hq, q tile: 64 rows in f32, 128 in bf16); the
//     sequential kv grid axis is a loop inside the block over 64-key tiles
//     in order, with m, l and the accumulator in f32 registers;
//   * the next k/v tile is copied into shared memory by cp.async while the
//     current one computes (two buffers); head dims are padded with zeros in
//     shared memory to the kernel's tile;
//   * the kv head is h / group in the pointer arithmetic: no repeated copy;
//   * the causal mask is the reference kernel's top-left q_id >= k_id with a
//     -1e30 fill, applied only on tiles that cross the diagonal (or the end
//     of the keys); tiles wholly above it are skipped (in the Pallas kernel
//     they add exactly 0).  Causal q tiles are launched heaviest first
//     (blockIdx.y reversed), so that the last wave holds the short tiles;
//   * l is clamped at 1e-30 before the division, as in the reference.
// bf16: both products on the tensor cores with wgmma (m64n64k16, f32
// accumulators), two consumer warpgroups of 64 q rows a block; k and v
// tiles are copied by cp.async into the 128-byte swizzled layout the
// instruction reads through shared-memory descriptors, q's and P's A
// fragments sit in registers.  P is split into two bf16 terms, hi + lo
// (about 16 bits), and P.V takes both: P rounded to one bf16 (8 bits) moves
// the early causal rows, which average few keys, by up to 2^-9 of the spread
// of v, past the tolerance of one bf16 ulp of the plain version; the second
// term doubles the P.V tensor-core work.  Softmax in base 2 (scale * log2 e
// folded into one FMA before each ex2).  Not yet TMA, warp specialisation or wgmma
// overlapped with the softmax: see ROADMAP B.
// f32: 128 threads per 64 q rows; each thread owns 4 rows x (kv tile / 8)
// keys of the score tile, computed as a register-tiled product from q and k
// in shared memory (32 FMAs per 3 float4 loads at a 64-key tile), the row
// max and sum by shuffles among the 8 threads of a row, P through shared
// memory, and P.V the same way with 4 rows x D/8 columns a thread.
// The kernel's tiles need not equal the caller's block_q / block_k, which
// the wrapper checks as the reference does; online softmax gives the same
// result for any tiling up to rounding.
//
// Exported as a plain C function (built with nvcc, bound with ctypes); it
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "phase_clocks.cuh"

namespace {

constexpr int BQ = 64;         // query rows per block (f32)
constexpr int THREADS = 128;   // four warps (f32)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// Rows [row0, row0 + ROWS) of a (rows, D) matrix into dst[ROWS][LD], columns
// [0, DP), by NT threads: rows at or past `limit` and columns at or past D
// are zeros.  A thread copies one 16-byte column chunk of every (NT / CH)-th
// row.  With `vec` (D a multiple of a chunk, the matrix 16-byte aligned) by
// cp.async, else by plain loads.
template <typename T, int ROWS, int DP, int LD, int NT>
__device__ __forceinline__ void stage(T* dst, const T* src, int row0, int limit,
                                      int D, bool vec) {
  constexpr int E = 16 / sizeof(T);   // elements per 16-byte chunk
  constexpr int CH = DP / E, STEP = NT / CH;
  static_assert(NT % CH == 0 && (ROWS % STEP == 0 || STEP % ROWS == 0),
                "whole rows per pass");
  const int r0 = threadIdx.x / CH, c = (threadIdx.x % CH) * E;
#pragma unroll 1   // unrolled, the f32 kernel at a head dim of 64 spills
  for (int i = 0; i < (ROWS + STEP - 1) / STEP; ++i) {
    const int r = r0 + i * STEP, gr = row0 + r;
    if (STEP > ROWS && r >= ROWS) break;   // more threads than chunks
    const bool in = c < D && gr < limit;
    T* d = dst + r * LD + c;
    const T* s = src + (int64_t)gr * D + c;
    if (vec) {
      cp_async16(d, in ? s : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int u = 0; u < E; ++u) d[u] = (in && c + u < D) ? s[u] : from_f32<T>(0.f);
    }
  }
}

// ------------------------------------------------- bf16 tensor cores ----
// 2^x, flushing results below 2^-126 to zero (they weigh nothing next to
// the row's largest term, 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// P's A fragments for two neighbouring score values x0, x1 (low, high):
// hi = their bf16 rounding, lo = the bf16 rounding of what hi leaves out, so
// that hi + lo carries about 16 bits of each value
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

constexpr int BKV16 = 64;   // keys per kv tile (bf16)

// ------------------------------------------------ bf16 on wgmma (sm_90a) ----
// Two consumer warpgroups of 64 q rows each; both products by
// wgmma.m64nNk16 with f32 accumulators in registers: A (q, then P) from
// registers in mma.m16n8k16's fragment layout, B (k, then v) from shared
// memory through a matrix descriptor.  k and v tiles are written by cp.async
// in the 128-byte swizzled layout wgmma reads: a row of 64 head-dim values
// (128 bytes) per key, its 16-byte chunk c stored at c ^ (key % 8), 8 keys
// (1024 bytes) a swizzle atom; a head dim of 128 is two such 64-wide
// sub-tiles.  k is K-major for S = q k^T (the head dim is the reduction),
// v MN-major for P v (transposed by the instruction).
constexpr int WG_BQ = 128;       // q rows per block: two warpgroups
constexpr int WG_THREADS = 256;
constexpr int SUB = 64 * 64;     // elements of one 64-key x 64-column sub-tile

// A 64-key tile of k or v (rows row0.., zeros past limit and past D) into
// the swizzled layout: DP / 64 sub-tiles of 64 keys x 64 columns.
template <int DP>
__device__ __forceinline__ void stage_sw128(bf16* dst, const bf16* src, int row0,
                                            int limit, int D, bool vec) {
  constexpr int CH = DP / 8;                    // 16-byte chunks a row
  constexpr int STEP = WG_THREADS / CH;
  const int r0 = threadIdx.x / CH, c = threadIdx.x % CH;
  const bool col_in = c * 8 < D;
#pragma unroll
  for (int i = 0; i < 64 / STEP; ++i) {
    const int r = r0 + i * STEP, gr = row0 + r;
    bf16* d = dst + (c / 8) * SUB + r * 64 + ((c % 8) ^ (r % 8)) * 8;
    const bool in = col_in && gr < limit;
    const bf16* s = src + (int64_t)gr * D + c * 8;
    if (vec) {
      cp_async16(d, in ? s : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        d[u] = (in && c * 8 + u < D) ? s[u] : __float2bfloat16(0.f);
    }
  }
}

// Two blocks an SM at a head dim of 64 (128 registers a thread), one at 128.
template <int DP>
__global__ void __launch_bounds__(WG_THREADS, DP <= 64 ? 2 : 1)
attention_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, int Hq,
                       int Hkv, int S, int Sk, int D, float scale_log2, int causal,
                       int vec) {
  constexpr int LDQ = DP + 8;     // q rows, padded for ldmatrix
  constexpr int KT = DP / 16;     // k-steps over the head dim
  constexpr int NH = DP / 64;     // 64-column halves of the output
  constexpr int TILE = SUB * NH;  // elements of one k or v tile
  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  bf16* ks = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));  // [2][TILE]
  bf16* vs = ks + 2 * TILE;                                                  // [2][TILE]
  bf16* qs = vs + 2 * TILE;                                                  // [WG_BQ][LDQ]

  const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int i0 = qt * WG_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wg0 = i0 + (warp / 4) * 64;           // this warpgroup's first row

  const bf16* qp = q + (int64_t)bh * S * D;
  const bf16* kp = k + (int64_t)kvh * Sk * D;
  const bf16* vp = v + (int64_t)kvh * Sk * D;

  PHASE_START();
  const int kend = causal ? min(Sk, i0 + WG_BQ) : Sk;
  const int ntiles = (kend + BKV16 - 1) / BKV16;
  stage<bf16, WG_BQ, DP, LDQ, WG_THREADS>(qs, qp, i0, S, D, vec);
  stage_sw128<DP>(ks, kp, 0, Sk, D, vec);
  stage_sw128<DP>(vs, vp, 0, Sk, D, vec);
  cp_async_commit();

  float acc[NH][32];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[hh][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // rows g and g + 8
  const int row_a = i0 + warp * 16 + g, row_b = row_a + 8;

  PHASE(0);   // prologue: the first copies issued
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    PHASE(1);   // wait for the tile
    if (t + 1 < ntiles) {
      const int nb = (t + 1) & 1;
      stage_sw128<DP>(ks + nb * TILE, kp, (t + 1) * BKV16, Sk, D, vec);
      stage_sw128<DP>(vs + nb * TILE, vp, (t + 1) * BKV16, Sk, D, vec);
      cp_async_commit();
    }
    const bf16* kb = ks + (t & 1) * TILE;
    const bf16* vb = vs + (t & 1) * TILE;
    PHASE(2);   // issue the next tile's copies
    const int j0 = t * BKV16;
    if (causal && j0 > wg0 + 63) continue;        // wholly above this warpgroup

    // S = q k^T: 64 rows x 64 keys a warpgroup; q's A fragments are read
    // from shared memory each tile, which keeps 16 registers free
    unsigned qf[KT][4];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      ldsm_x4(qf[kk], qs + (warp * 16 + lane % 16) * LDQ + kk * 16 + (lane / 16) * 8);
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      wgmma_64x64_rs<0>(s, qf[kk], sw128_desc(kb + (kk / 4) * SUB + (kk % 4) * 16), kk > 0);
    wgmma_commit();
    wgmma_wait();
    PHASE(3);   // S = q k^T

    // m is kept in units of the raw scores; p = 2^(s * c - m * c), c =
    // scale * log2 e, one FMA and one ex2 a score
    const bool mask = (causal && j0 + BKV16 - 1 > wg0) || j0 + BKV16 > Sk;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      if (mask) {
        const int key = j0 + (e / 4) * 8 + 2 * t4 + (e & 1);
        if (key >= Sk || (causal && key > ((e & 2) ? row_b : row_a))) s[e] = NEG_INF;
      }
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    }
    float alpha[2], mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = ex2((m[r] - m_new) * scale_log2);
      m[r] = m_new;
      mc[r] = m_new * scale_log2;
    }
    unsigned ph[8][2], pl[8][2];   // P as hi + lo bf16 terms per 8-key block
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * nt + e] = ex2(fmaf(s[4 * nt + e], scale_log2, -mc[e / 2]));
      split_bf16(s[4 * nt], s[4 * nt + 1], ph[nt][0], pl[nt][0]);
      split_bf16(s[4 * nt + 2], s[4 * nt + 3], ph[nt][1], pl[nt][1]);
      rs[0] += s[4 * nt] + s[4 * nt + 1];
      rs[1] += s[4 * nt + 2] + s[4 * nt + 3];
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[hh][e] *= alpha[(e >> 1) & 1];
    PHASE(4);   // scale, mask, online softmax, P split

    // O += P_lo v + P_hi v, 16 keys a step
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned hi[4] = {ph[2 * kk][0], ph[2 * kk][1], ph[2 * kk + 1][0],
                              ph[2 * kk + 1][1]};
      const unsigned lo[4] = {pl[2 * kk][0], pl[2 * kk][1], pl[2 * kk + 1][0],
                              pl[2 * kk + 1][1]};
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        const uint64_t desc = sw128_desc(vb + hh * SUB + kk * 16 * 64);
        wgmma_64x64_rs<1>(acc[hh], lo, desc, 1);
        wgmma_64x64_rs<1>(acc[hh], hi, desc, 1);
      }
    }
    wgmma_commit();
    wgmma_wait();
    PHASE(5);   // P.V
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv_a = 1.f / fmaxf(l[0], 1e-30f), inv_b = 1.f / fmaxf(l[1], 1e-30f);
  bf16* op = o + (int64_t)bh * S * D;
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int row = (e & 2) ? row_b : row_a;
      const int d = hh * 64 + (e / 4) * 8 + 2 * t4 + (e & 1);
      if (row < S && d < D)
        op[(int64_t)row * D + d] = __float2bfloat16(acc[hh][e] * ((e & 2) ? inv_b : inv_a));
    }
  PHASE(6);   // normalise and store
  PHASE_END();
}

// ------------------------------------------- f32 register-tiled FMAs ----
// DP: head dim padded to 32, 64 or 128; BKV: keys per kv tile (64, or 32 at
// DP 128 to fit two blocks an SM).
template <int DP, int BKV>
__global__ void __launch_bounds__(THREADS)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int Hq,
                     int Hkv, int S, int Sk, int D, float scale, int causal,
                     int vec) {
  constexpr int LD = DP + 4;      // row stride (floats): rows 4 banks apart
  constexpr int LP = BKV + 4;
  constexpr int NJ = BKV / 8;     // keys a thread owns: tx + 8 j
  constexpr int ND = DP / 32;     // float4 column groups a thread owns: tx*4 + 32 jj
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // [BQ][LD]
  float* ks = qs + BQ * LD;                          // [2][BKV][LD]
  float* vs = ks + 2 * BKV * LD;                     // [2][BKV][LD]
  float* ps = vs + 2 * BKV * LD;                     // [BQ][LP]

  const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int i0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = lane / 8, tx = lane % 8;
  const int rl0 = warp * 16 + ty;                    // local rows rl0 + 4 i

  const float* qp = q + (int64_t)bh * S * D;
  const float* kp = k + (int64_t)kvh * Sk * D;
  const float* vp = v + (int64_t)kvh * Sk * D;

  PHASE_START();
  const int kend = causal ? min(Sk, i0 + BQ) : Sk;
  const int ntiles = (kend + BKV - 1) / BKV;
  stage<float, BQ, DP, LD, THREADS>(qs, qp, i0, S, D, vec);
  stage<float, BKV, DP, LD, THREADS>(ks, kp, 0, Sk, D, vec);
  stage<float, BKV, DP, LD, THREADS>(vs, vp, 0, Sk, D, vec);
  cp_async_commit();

  float acc[4][ND][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < ND; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = NEG_INF; l[i] = 0.f; }

  PHASE(0);   // prologue: the first copies issued
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    PHASE(1);   // wait for the tile
    if (t + 1 < ntiles) {
      const int nb = (t + 1) & 1;
      stage<float, BKV, DP, LD, THREADS>(ks + nb * BKV * LD, kp, (t + 1) * BKV, Sk, D, vec);
      stage<float, BKV, DP, LD, THREADS>(vs + nb * BKV * LD, vp, (t + 1) * BKV, Sk, D, vec);
      cp_async_commit();
    }
    const float* kb = ks + (t & 1) * BKV * LD;
    const float* vb = vs + (t & 1) * BKV * LD;

    PHASE(2);   // issue the next tile's copies
    float s[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (rl0 + 4 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kb + (tx + 8 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    PHASE(3);   // S = q k^T
    const int j0 = t * BKV;
    const bool mask = (causal && j0 + BKV - 1 > i0) || j0 + BKV > Sk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i0 + rl0 + 4 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float x = s[i][j] * scale;
        if (mask) {
          const int key = j0 + tx + 8 * j;
          if (key >= Sk || (causal && key > row)) x = NEG_INF;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(rl0 + 4 * i) * LP + tx + 8 * j] = p;
      }
      l[i] = l[i] * alpha + rs;   // this thread's share; the row's 8 add up at the end
#pragma unroll
      for (int jj = 0; jj < ND; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jj][e] *= alpha;
    }
    __syncwarp();   // a warp reads only the P rows its own lanes wrote

    PHASE(4);   // scale, mask, online softmax, P to shared memory
#pragma unroll 2
    for (int kc = 0; kc < BKV; kc += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (rl0 + 4 * i) * LP + kc);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 vv[ND];
#pragma unroll
        for (int jj = 0; jj < ND; ++jj)
          vv[jj] = *reinterpret_cast<const float4*>(vb + (kc + u) * LD + tx * 4 + 32 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int jj = 0; jj < ND; ++jj) {
            acc[i][jj][0] = fmaf(p, vv[jj].x, acc[i][jj][0]);
            acc[i][jj][1] = fmaf(p, vv[jj].y, acc[i][jj][1]);
            acc[i][jj][2] = fmaf(p, vv[jj].z, acc[i][jj][2]);
            acc[i][jj][3] = fmaf(p, vv[jj].w, acc[i][jj][3]);
          }
        }
      }
    }
    PHASE(5);   // P.V
  }

  float* op = o + (int64_t)bh * S * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const float inv = 1.f / fmaxf(li, 1e-30f);
    const int row = i0 + rl0 + 4 * i;
    if (row >= S) continue;
#pragma unroll
    for (int jj = 0; jj < ND; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = tx * 4 + 32 * jj + e;
        if (d < D) op[(int64_t)row * D + d] = acc[i][jj][e] * inv;
      }
  }
  PHASE(6);   // normalise and store
  PHASE_END();
}

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int S, int Sk, int D, float scale, int causal,
                 int vec, cudaStream_t s) {
  const size_t smem = 1024 + sizeof(bf16) * (4 * SUB * (DP / 64) + WG_BQ * (DP + 8));
  const dim3 grid(static_cast<unsigned>(B * Hq), static_cast<unsigned>((S + WG_BQ - 1) / WG_BQ));
  auto kern = attention_wgmma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, WG_THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Hq, Hkv, S, Sk, D,
      scale * LOG2E, causal, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, int BKV>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int Hkv, int S, int Sk, int D, float scale, int causal,
               int vec, cudaStream_t s) {
  constexpr int LD = DP + 4;
  const size_t smem = sizeof(float) * ((BQ + 4 * BKV) * LD + BQ * (BKV + 4));
  const dim3 grid(static_cast<unsigned>(B * Hq), static_cast<unsigned>((S + BQ - 1) / BQ));
  auto kern = attention_f32_kernel<DP, BKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hkv, S, Sk, D,
      scale, causal, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cycles by phase: 0 prologue, 1 waiting for a tile, 2 issuing the next
// tile's copies, 3 S = q k^T, 4 softmax, 5 P.V, 6 normalise and store
PHASE_CLOCKS_EXPORT(flash_attention_phase_cycles)

// q, k, v, o: contiguous, all f32 or all bf16 (bf16 flag); D <= 128; vec:
// the four are 16-byte aligned and D a multiple of a 16-byte chunk.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Hq, int Hkv, int S, int Sk,
                               int D, float scale, int causal, int bf16_in,
                               int vec, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || S < 1 || Sk < 1 || D < 1 ||
      D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)B * Hq > 2147483647LL || (S + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_in) {
    if (D <= 64) return launch_wgmma<64>(q, k, v, o, B, Hq, Hkv, S, Sk, D, scale, causal, vec, s);
    return launch_wgmma<128>(q, k, v, o, B, Hq, Hkv, S, Sk, D, scale, causal, vec, s);
  }
  if (D <= 32) return launch_f32<32, 64>(q, k, v, o, B, Hq, Hkv, S, Sk, D, scale, causal, vec, s);
  if (D <= 64) return launch_f32<64, 64>(q, k, v, o, B, Hq, Hkv, S, Sk, D, scale, causal, vec, s);
  return launch_f32<128, 32>(q, k, v, o, B, Hq, Hkv, S, Sk, D, scale, causal, vec, s);
}
