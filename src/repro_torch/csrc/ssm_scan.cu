// Chunked decay scan for Hopper (sm_90a), Mamba2 ("inclusive") and RWKV6
// ("bonus") modes:
//     h_t = exp(w_t) (.) h_{t-1} + k_t (x) v_t          h in R^{dk x dv}
//     inclusive: o_t = q_t . h_t
//     bonus:     o_t = q_t . h_{t-1} + (q_t . (u (.) k_t)) v_t
// q/k/w (B,H,S,dk), v (B,H,S,dv), u (H,dk) -> o (B,H,S,dv).
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py:110 (ssm_scan;
// _scan_kernel at :50, _window_sums at :32).  There the grid is
// (B*H, S/chunk), the chunk axis runs in order and VMEM scratch carries the
// f32 (dk, dv) state; inside a chunk the (C, C, dk) table of window decays
// is materialised (1 MiB at C = dk = 64).
//
// Bound on the H100: the least work, the step recurrence, is ~5*dk*dv
// flops per step and head against 4*(3*dk + 2*dv) bytes of q, k, w, v and
// o, so the function is bound by bytes (3.35 TB/s): 0.100 ms for rwkv6-7b
// at S 4096.  The chunked form does ~1.5x the recurrence's operations and
// C*(C+1)/2*dk exps a chunk (~5.3e8 for rwkv6-7b, ~0.13 ms at 16 a clock
// per SM), so its own floor is the exps and the f32 operations.
//
// The chunk axis is a recurrence only through the state: a chunk's own
// contribution to the state, Delta_c = (k (.) exp(win[C-1, s]))^T v, and its
// decay e_c = exp(sum_t w_t) do not depend on the state it enters with, and
// the reference's carry is h' = e_c (.) h + Delta_c (ssm_scan.py:100-107).
// So a call runs three kernels, in order on the caller's stream (the state
// passing form of Mamba2's SSD kernels):
//   1. chunk_state, one block per (b*H, chunk): Delta_c and e_c into an f32
//      workspace of B*H*(S/C)*(dk*dv + dk) floats (68 MB for rwkv6-7b, 119
//      MB for zamba2-7b at S 4096, C 64);
//   2. state_pass, one thread per (b*H, state element): walks the chunks in
//      order from h = 0, writes the state entering chunk c in place of
//      Delta_c, then steps h <- e_c h + Delta_c.  The only sequential part:
//      an elementwise pass over the workspace, which it reads and writes once
//      (~40 / 70 us of HBM at 3.35 TB/s for the two configurations);
//   3. chunk_out, one block per (b*H, chunk): o = q exp(W or Wprev) @ h_c +
//      scores @ v (+ (q . (u k)) v in bonus mode).
// The grid grows from B*H blocks (64 / 112 on 132 SMs) to B*H*S/C (4096 /
// 7168), two or more blocks an SM (chunk_out 100.5 KB of shared memory at
// C = dk = dv = 64, chunk_state 50 KB).  The numerics are the reference's:
//   * every window decay sum_{s<i<=t} w_i is a running sum over its own
//     window, added in order of i (as jnp.cumsum(gated, axis=1) forms it),
//     never W_t - W_s; the suffix decays win[C-1, s] likewise; the full-chunk
//     decay is a plain sum of w; bonus mode uses win[t-1, s] (the running sum
//     before w[t] is added) and Wprev as a shift of the inclusive cumsum W;
//   * the upper triangle, whose exponent the reference masks to -1e30 and
//     whose exp is exactly 0, is never formed;
//   * every sum is taken in a fixed order: no atomics, the same bits on
//     every call.
// The score walk pairs key positions s and C-1-s, so every lane walks C-1
// steps below the diagonal; G lanes share one s and split dk, and meet in a
// warp shuffle; each exp is ex2.approx of the exponent times log2(e).  The
// diagonal (q . k, exponent 0; in bonus mode the bonus term) is a dot
// product, a warp a position.  The two chunk products are 4 x 4 register
// tiles over shared memory, on the f32 CUDA cores (TF32 misses the
// reference's 1e-4 / 1e-5 tolerances).  f32 chunks are staged with 16-byte
// cp.async copies (every copy of a chunk in flight at once), bf16 ones
// through registers, in f32.  On one H100 (700 W) a full-width call takes
// 0.72 ms (rwkv6-7b) and 1.26 ms (zamba2-7b), 70% of it in chunk_out, whose
// warps spend most of their cycles in the walk's ~100 instructions a step
// (PERF.md).
//
// Exported as a plain C function (built with nvcc, bound with ctypes); it
// launches on the caller's stream, allocates nothing (the wrapper passes the
// workspace) and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "phase_clocks.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TM = 4, TN = 4;  // register tile of the chunk products
constexpr int STATE_UNROLL = 8;  // chunks whose loads the state pass keeps in flight
constexpr int SPT = 16;          // key positions a thread in the suffix decays

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// exp(x) as 2^(x log2 e) on the SFU
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// Row strides (floats) of the staged operands, whole float4s: [C][dk] rows
// (at least the walk's footprint of G*DPT channels, zeros past dk) and the
// [C][C] scores padded by 4 more, so that the output product's two
// half-warps, four rows apart, read disjoint banks; [.][dv] rows: dv
// rounded up to 4.
__host__ __device__ __forceinline__ int cols_k(int dk, int foot) {
  const int n = (dk + 3) / 4 * 4;              // staged columns, zeros past dk
  return n > foot ? n : foot;
}
__host__ __device__ __forceinline__ int ld_k(int dk, int foot) { return cols_k(dk, foot) + 4; }
__host__ __device__ __forceinline__ int ld_v(int dv) { return (dv + 3) / 4 * 4; }
__host__ __device__ __forceinline__ int ld_c(int C) { return (C + 3) / 4 * 4 + 4; }

// rows x n values of src (row-major, rows n apart) into the first ncols
// columns of dst (row stride ld), in f32, zeros past n.  f32 rows on
// 16-byte bounds go by cp.async (the caller commits and waits); the rest
// through registers.  Each thread steps through its (row, column) units
// with one division, at the start.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, int rows,
                                      int n, int ncols, bool vec) {
  const bool by16 = std::is_same<T, float>::value && vec;
  const int units = by16 ? ncols / 4 : ncols;    // a row
  int r = threadIdx.x / units, c = threadIdx.x - r * units;
  const int rs = THREADS / units, cs = THREADS - rs * units;
  while (r < rows) {
    if (by16) {
      float* d = dst + r * ld + 4 * c;
      if (4 * c < n) cp_async16(d, src + (int64_t)r * n + 4 * c, 16);
      else *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      dst[r * ld + c] = c < n ? to_f32(src[(int64_t)r * n + c]) : 0.f;
    }
    c += cs;
    r += rs;
    if (c >= units) { c -= units; ++r; }
  }
}

// acc[i][j] += sum_kk A(r_i, kk) * B[kk][c_j] with rows r_i = ry + i*nry
// (adjacent lanes on adjacent rows) and columns c_j = 4*cx + j (one 16-byte
// read of B a step); A(r, kk) = A[r*sar + kk*sac]; B's rows are ldb floats
// apart, 16-byte aligned, padded to whole float4s.
__device__ __forceinline__ void tile_mm(float (&acc)[TM][TN], const float* A,
                                        int sar, int sac, const float* B,
                                        int ldb, int K, int ry, int nry,
                                        int cx, int M) {
  int rows[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) rows[i] = min(ry + i * nry, M - 1) * sar;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = A[rows[i] + kk * sac];
    const float4 b = *reinterpret_cast<const float4*>(B + kk * ldb + 4 * cx);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
      acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
      acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
      acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
    }
  }
}

// 1. Per (b*H, chunk): Delta_c = (k (.) exp(win[C-1, s]))^T v and
//    e_c = exp(sum_t w_t), into the workspace.
template <typename T>
__global__ void __launch_bounds__(THREADS)
chunk_state(const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ w, float* __restrict__ delta,
            float* __restrict__ decay, int S, int dk, int dv, int C, int N,
            bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = ld_k(dk, 0), ldv = ld_v(dv), nk = cols_k(dk, 0);
  float* ks = smem;               // [C][ldk]; k_dec after the suffix decays
  float* ws = ks + C * ldk;       // [C][ldk]
  float* vs = ws + C * ldk;       // [C][ldv]
  const int blk = blockIdx.x, tid = threadIdx.x;
  const int bh = blk / N, c = blk - bh * N;
  const int64_t row0 = (int64_t)bh * S + (int64_t)c * C;

  PHASE_START();
  stage(ks, ldk, k + row0 * dk, C, dk, nk, vec);
  stage(ws, ldk, w + row0 * dk, C, dk, nk, vec);
  stage(vs, ldv, v + row0 * dv, C, dv, ldv, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  PHASE(0);

  // the full-chunk decay, a plain sum of w over the chunk in order of t, and
  // the suffix decays win[C-1, s, d] = sum_{s<i<=C-1} w_i, each a running
  // sum over its own window in order of i; k_dec = k exp(win[C-1, s]).  A
  // thread takes one channel d and SPT key positions s = gs + NG*j, and walks
  // i once, adding w[i, d] to every sum whose window holds i, in order of i.
  {
    const int NG = (C + SPT - 1) / SPT;
    for (int item = tid; item < NG * dk; item += THREADS) {
      const int gs = item / dk, d = item - gs * dk;
      float run[SPT], wsum = 0.f;
#pragma unroll
      for (int j = 0; j < SPT; ++j) run[j] = 0.f;
      // i in (s_{kx-1}, s_kx] lies in windows 0..kx-1: the windows that
      // hold i are a prefix, known at compile time in each segment
      int i = 0;
      for (; i <= gs && i < C; ++i) wsum += ws[i * ldk + d];
#pragma unroll
      for (int kx = 1; kx <= SPT; ++kx) {
        const int iend = min(gs + NG * kx, C - 1);
        for (; i <= iend; ++i) {
          const float wv = ws[i * ldk + d];
          wsum += wv;
#pragma unroll
          for (int j = 0; j < kx; ++j) run[j] += wv;
        }
      }
      if (gs == 0) decay[(int64_t)blk * dk + d] = expf(wsum);
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int sj = gs + NG * j;
        if (sj < C) ks[sj * ldk + d] *= expf(run[j]);
      }
    }
  }
  __syncthreads();
  PHASE(1);

  // Delta_c = k_dec^T v, a (dk, dv) product over the chunk's C positions
  const int ncx = ldv / TN, nry = (dk + TM - 1) / TM;
  float* out = delta + (int64_t)blk * dk * dv;
  for (int tile = tid; tile < nry * ncx; tile += THREADS) {
    const int ry = tile / ncx, cx = tile - ry * ncx;
    float a[TM][TN] = {};
    tile_mm(a, ks, 1, ldk, vs, ldv, C, ry, nry, cx, dk);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int d = ry + i * nry;
      if (d >= dk) continue;
      if (dv % 4 == 0) {                  // the workspace is 16-byte aligned
        *reinterpret_cast<float4*>(out + d * dv + 4 * cx) =
            make_float4(a[i][0], a[i][1], a[i][2], a[i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (4 * cx + j < dv) out[d * dv + 4 * cx + j] = a[i][j];
      }
    }
  }
  PHASE(2);
  PHASE_END();
}

// 2. Per (b*H, state element): the chunks in order from h = 0; the state
//    entering chunk c replaces Delta_c, then h <- e_c h + Delta_c.
__global__ void __launch_bounds__(THREADS)
state_pass(float* __restrict__ delta, const float* __restrict__ decay,
           long long n_elems, int dk, int dv, int N) {
  PHASE_START();
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx < n_elems) {
    const int per = dk * dv;
    const long long bh = idx / per;
    const int el = static_cast<int>(idx - bh * per), d = el / dv;
    float* D = delta + bh * N * per + el;
    const float* E = decay + bh * N * dk + d;
    // the next group of chunks is read before this group's states are
    // written, so a group's loads are always in flight
    float h = 0.f, dl[STATE_UNROLL], ev[STATE_UNROLL];
    auto fetch = [&](int c0, float (&dd)[STATE_UNROLL], float (&ee)[STATE_UNROLL]) {
#pragma unroll
      for (int u = 0; u < STATE_UNROLL; ++u) {
        const int c = min(c0 + u, N - 1);
        dd[u] = D[(int64_t)c * per];
        ee[u] = E[(int64_t)c * dk];
      }
    };
    fetch(0, dl, ev);
    for (int c0 = 0; c0 < N; c0 += STATE_UNROLL) {
      float dn[STATE_UNROLL], en[STATE_UNROLL];
      fetch(c0 + STATE_UNROLL, dn, en);
#pragma unroll
      for (int u = 0; u < STATE_UNROLL; ++u) {
        if (c0 + u < N) {
          D[(int64_t)(c0 + u) * per] = h;
          h = fmaf(ev[u], h, dl[u]);
        }
        dl[u] = dn[u];
        ev[u] = en[u];
      }
    }
  }
  PHASE(3);
  PHASE_END();
}

// The off-diagonal scores, s < t: scores[t][s] = sum_d q[t,d] k[s,d]
// exp(win[t, s, d]) (inclusive) or exp(win[t-1, s, d]) (bonus), into
// sc[t][s].  Item p (G lanes) walks s = p over t = p+1..C-1, then
// s = C-1-p over t = C-p..C-1: C-1 steps for every item, so the loop and its
// shuffles are the same for every lane.  A lane holds DPT channels of k[s]
// and of the running sums win[t, s, d] (added in order of t), as DPT/4
// float4 chunks at d = 4g + 4G*h, read from rows zero-padded to G*DPT
// channels.
template <int G, int DPT>
__device__ __forceinline__ void walk_scores(float* sc, const float* qs,
                                            const float* ks, const float* ws,
                                            int C, int ldk, int ldc, bool bonus) {
  constexpr int NV = DPT / 4;
  const int P = (C + 1) / 2;
  const int nitems = (P * G + 31) / 32 * 32;
  for (int item = threadIdx.x; item < nitems; item += THREADS) {
    const int p = item / G, g = item % G;
    const bool live = p < P;
    const int na = C - 1 - p;                   // steps of the first key position
    const bool second = live && C - 1 - p > p;  // a second one (not the middle)
    // the lane's channels: zeros past dk in the staged rows, so no mask
    const float* qg = qs + 4 * g;
    const float* wg = ws + 4 * g;
    float kk[DPT], run[DPT];
    auto key = [&](int s) {
#pragma unroll
      for (int h = 0; h < NV; ++h) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + s * ldk + 4 * g + 4 * G * h);
        kk[4 * h] = kv.x; kk[4 * h + 1] = kv.y; kk[4 * h + 2] = kv.z; kk[4 * h + 3] = kv.w;
      }
#pragma unroll
      for (int jj = 0; jj < DPT; ++jj) run[jj] = 0.f;
    };
    key(min(p, C - 1));
#pragma unroll 2
    for (int j = 0; j < C - 1; ++j) {
      const bool first = j < na;
      const int s = first ? p : C - 1 - p;
      const int t = first ? p + 1 + j : j + 1;
      if (j == na && second) key(s);           // the second key position
      float part[NV];
#pragma unroll
      for (int h = 0; h < NV; ++h) {
        const float4 q4 = *reinterpret_cast<const float4*>(qg + t * ldk + 4 * G * h);
        const float4 w4 = *reinterpret_cast<const float4*>(wg + t * ldk + 4 * G * h);
        const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
        part[h] = 0.f;
        if (bonus) {                            // exponent win[t-1, s]; then add w[t]
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int jj = 4 * h + i;
            part[h] = fmaf(qv[i] * kk[jj], exp_sfu(run[jj]), part[h]);
            run[jj] += wv[i];
          }
        } else {                                // exponent win[t, s]
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int jj = 4 * h + i;
            run[jj] += wv[i];
            part[h] = fmaf(qv[i] * kk[jj], exp_sfu(run[jj]), part[h]);
          }
        }
      }
      float sum = part[0];
#pragma unroll
      for (int h = 1; h < NV; ++h) sum += part[h];
#pragma unroll
      for (int off = G >> 1; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (g == 0 && live && (first || second)) sc[t * ldc + s] = sum;
    }
  }
}

// The diagonal, a warp a position t: inclusive, scores[t][t] = q[t] . k[t]
// (exponent win[t, t] = 0); bonus, whose scores have no diagonal, the bonus
// term bo[t] = sum_d (q[t,d] u[d]) k[t,d].
__device__ __forceinline__ void diagonal(float* sc, float* bo, const float* qs,
                                         const float* ks, const float* us, int C,
                                         int dk, int ldk, int ldc, bool bonus) {
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < C; t += THREADS / 32) {
    float b = 0.f;
    for (int d = lane; d < dk; d += 32) {
      const float qv = bonus ? qs[t * ldk + d] * us[d] : qs[t * ldk + d];
      b = fmaf(qv, ks[t * ldk + d], b);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) b += __shfl_xor_sync(0xffffffffu, b, off);
    if (lane == 0) {
      if (bonus) bo[t] = b;
      else sc[t * ldc + t] = b;
    }
  }
}

// 3. Per (b*H, chunk): o = q exp(W or Wprev) @ h_c + scores @ v
//    (+ (q . (u k)) v in bonus mode).  The walk: G lanes a key position,
//    DPT channels a lane.
template <typename T, int G, int DPT>
__global__ void __launch_bounds__(THREADS, 2)
chunk_out(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ w,
          const T* __restrict__ u, const float* __restrict__ state,
          T* __restrict__ o, int H, int S, int dk, int dv, int C, int N,
          bool bonus, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int nk = cols_k(dk, G * DPT), ldk = ld_k(dk, G * DPT);
  const int ldv = ld_v(dv), ldc = ld_c(C);
  float* hs = smem;               // [dk][ldv]  state entering the chunk
  float* vs = hs + dk * ldv;      // [C][ldv]
  float* qs = vs + C * ldv;       // [C][ldk]   q; q exp(W or Wprev) later
  float* ks = qs + C * ldk;       // [C][ldk]
  float* ws = ks + C * ldk;       // [C][ldk]   w; W or Wprev later
  float* sc = ws + C * ldk;       // [C][ldc]   scores[t][s]
  float* bo = sc + C * ldc;       // [C]        bonus q . (u k)
  float* us = bo + (C + 3) / 4 * 4;  // [nk]    u, zeros past dk
  const int blk = blockIdx.x, tid = threadIdx.x;
  const int bh = blk / N, c = blk - bh * N;
  const int64_t row0 = (int64_t)bh * S + (int64_t)c * C;

  PHASE_START();
  stage(hs, ldv, state + (int64_t)blk * dk * dv, dk, dv, ldv, dv % 4 == 0);
  stage(vs, ldv, v + row0 * dv, C, dv, ldv, vec);
  stage(qs, ldk, q + row0 * dk, C, dk, nk, vec);
  stage(ks, ldk, k + row0 * dk, C, dk, nk, vec);
  stage(ws, ldk, w + row0 * dk, C, dk, nk, vec);
  stage(us, 0, u + (int64_t)(bh % H) * dk, 1, dk, nk, false);
  cp_async_commit();
  for (int e = tid; e < C * ldc; e += THREADS) sc[e] = 0.f;
  cp_async_wait<0>();
  __syncthreads();
  PHASE(4);

  diagonal(sc, bo, qs, ks, us, C, dk, ldk, ldc, bonus);
  walk_scores<G, DPT>(sc, qs, ks, ws, C, ldk, ldc, bonus);
  __syncthreads();
  PHASE(5);

  // per channel: W (inclusive cumsum, in order of t) or Wprev (its shift)
  // in place of w; then every thread: q exp(W or Wprev) in place of q
  for (int d = tid; d < dk; d += THREADS) {
    float W = 0.f;
#pragma unroll 8
    for (int t = 0; t < C; ++t) {
      const float prev = W;
      W += ws[t * ldk + d];
      ws[t * ldk + d] = bonus ? prev : W;
    }
  }
  __syncthreads();
  for (int e = tid; e < C * dk; e += THREADS) {
    const int t = e / dk, d = e - t * dk;
    qs[t * ldk + d] *= expf(ws[t * ldk + d]);
  }
  __syncthreads();
  PHASE(6);

  // o = qW @ h + scores @ v (+ bonus v); a thread's rows are TM consecutive
  // positions, so the scores product stops at the last key they see
  const int ncx = ldv / TN, nry = (C + TM - 1) / TM;
  T* out = o + row0 * dv;
  for (int tile = tid; tile < nry * ncx; tile += THREADS) {
    const int ry = tile / ncx, cx = tile - ry * ncx;
    float a[TM][TN] = {}, b[TM][TN] = {};
    tile_mm(a, qs, ldk, 1, hs, ldv, dk, TM * ry, 1, cx, C);
    tile_mm(b, sc, ldc, 1, vs, ldv, min(C, TM * ry + TM), TM * ry, 1, cx, C);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int t = TM * ry + i;
      if (t >= C) continue;
      float r[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        r[j] = a[i][j] + b[i][j];
        if (bonus) r[j] += bo[t] * vs[t * ldv + 4 * cx + j];
      }
      if constexpr (std::is_same<T, float>::value) {
        if (vec && 4 * cx + 3 < dv) {
          *reinterpret_cast<float4*>(out + t * dv + 4 * cx) =
              make_float4(r[0], r[1], r[2], r[3]);
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (4 * cx + j < dv) store(out + t * dv + 4 * cx + j, r[j]);
    }
  }
  PHASE(7);
  PHASE_END();
}

// Bytes of dynamic shared memory of the two chunk kernels.  Past the card's
// limit (227 KB on Hopper) cudaFuncSetAttribute refuses it and the call
// returns that error.
long long state_smem(int dk, int dv, int C) {
  return 4LL * C * (2LL * ld_k(dk, 0) + ld_v(dv));
}
long long out_smem(int dk, int dv, int C, int foot) {
  return 4LL * ((long long)(dk + C) * ld_v(dv) + 3LL * C * ld_k(dk, foot) +
                (long long)C * ld_c(C) + (C + 3) / 4 * 4 + cols_k(dk, foot));
}

template <typename T, int G, int DPT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* w,
                   const void* u, void* o, float* delta, float* decay, int B,
                   int H, int S, int dk, int dv, int C, bool bonus, bool vec,
                   cudaStream_t s) {
  const int N = S / C;
  const long long blocks = (long long)B * H * N;
  const long long n_elems = (long long)B * H * dk * dv;
  const long long s1 = state_smem(dk, dv, C), s3 = out_smem(dk, dv, C, G * DPT);
  if (blocks > 2147483647LL || s1 > 2147483647LL || s3 > 2147483647LL ||
      (n_elems + THREADS - 1) / THREADS > 2147483647LL)
    return cudaErrorInvalidValue;
  auto k1 = chunk_state<T>;
  auto k3 = chunk_out<T, G, DPT>;
  cudaError_t err =
      cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s3);
  if (err != cudaSuccess) return err;
  // all of the SM's 228 KB as shared memory: two chunk_out blocks an SM
  err = cudaFuncSetAttribute(k1, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k3, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* wt = static_cast<const T*>(w);
  k1<<<static_cast<unsigned>(blocks), THREADS, s1, s>>>(kt, vt, wt, delta, decay, S,
                                                       dk, dv, C, N, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  state_pass<<<static_cast<unsigned>((n_elems + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      delta, decay, n_elems, dk, dv, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k3<<<static_cast<unsigned>(blocks), THREADS, s3, s>>>(
      qt, kt, vt, wt, static_cast<const T*>(u), delta, static_cast<T*>(o), H, S, dk,
      dv, C, N, bonus, vec);
  return cudaGetLastError();
}

}  // namespace

// q, k, w (B*H, S, dk), v (B*H, S, dv), u (H, dk), o (B*H, S, dv): contiguous,
// all f32 or all bf16 (bf16 flag); S % C == 0; dk <= 512.  ws: an f32
// workspace of B*H*(S/C)*(dk*dv + dk) floats (Delta, then e), 16-byte aligned.
extern "C" int ssm_scan(const void* q, const void* k, const void* v,
                        const void* w, const void* u, void* o, void* ws, int B,
                        int H, int S, int dk, int dv, int C, int bonus, int bf16,
                        void* stream) {
  if (B < 1 || H < 1 || S < 1 || dk < 1 || dv < 1 || C < 1 || S % C ||
      dk > 32 * 16 || reinterpret_cast<uintptr_t>(ws) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  float* delta = static_cast<float*>(ws);
  float* decay = delta + (long long)B * H * (S / C) * dk * dv;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(o);
  const bool vec = bits % 16 == 0 && dk % 4 == 0 && dv % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  // the walk's lanes a key position (G) and channels a lane (DPT)
#define REPRO_SCAN_LAUNCH(T, G, DPT)                                               \
  launch<T, G, DPT>(q, k, v, w, u, o, delta, decay, B, H, S, dk, dv, C, bonus != 0, \
                    vec, s)
#define REPRO_SCAN_BY_DK(T)                                                          \
  (dk <= 16 ? REPRO_SCAN_LAUNCH(T, 2, 8) : dk <= 64 ? REPRO_SCAN_LAUNCH(T, 8, 8)     \
   : dk <= 256 ? REPRO_SCAN_LAUNCH(T, 32, 8) : REPRO_SCAN_LAUNCH(T, 32, 16))
  if (bf16)
    err = REPRO_SCAN_BY_DK(__nv_bfloat16);
  else
    err = REPRO_SCAN_BY_DK(float);
#undef REPRO_SCAN_BY_DK
#undef REPRO_SCAN_LAUNCH
  return static_cast<int>(err);
}

PHASE_CLOCKS_EXPORT(ssm_scan_phase_cycles)
