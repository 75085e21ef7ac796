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
// at S 4096 against 0.082 ms of f32 operations.  The chunked form does
// ~1.5x the recurrence's operations (~4*C*dk*dv per chunk with the state
// plus ~5*C*C/2*dk of masked decay terms, an exp each), 0.122 ms at the
// 67 TFLOP/s of the f32 CUDA cores, so its own floor is the operations.
// The chunk axis is a true recurrence, so only B*H blocks can run (64 for
// rwkv6-7b, 112 for zamba2-7b, on 132 SMs).  The design:
//   * one block per b*H; a loop inside the block walks the chunks in order
//     and carries the f32 state in shared memory (16 KB at 64 x 64,
//     double-buffered so the update reads the old state while writing the
//     new one);
//   * the window table is never stored: a thread owns one key position s
//     and a strided set of channels d, and walks t forward from s, adding
//     w[t, d] to a running sum, so each exp(win[t, s, d]) is formed on the
//     fly from a sum taken directly over its own window (as
//     jnp.cumsum(gated, axis=1) forms it), never as W_t - W_s;
//   * the upper triangle, whose exponent the reference masks to -1e30 and
//     whose exp is exactly 0, is never formed; the partial scores over d
//     meet in a warp shuffle, so no atomics and a fixed summation order;
//   * bonus mode uses the shifted window win[t-1, s] (the running sum
//     before w[t] is added) and Wprev as a shift of the inclusive cumsum W,
//     never W - w;
//   * the state update takes each suffix decay from the same running sum
//     (win[-1] after the walk) and the full-chunk decay from a plain sum
//     of w;
//   * the two small products (o and the state update) use 4 x 4 register
//     tiles over shared memory.
// Plain FMAs and expf, no tensor cores in this version.
//
// Exported as a plain C function (built with nvcc, bound with ctypes); it
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int DPT = 16;        // channels d per thread in the score walk
constexpr int TM = 4, TN = 4;  // register tile of the two products

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// acc[i][j] += sum_k A[r_i, k] * B[k, c_j] with r_i = ry + i*nry,
// c_j = cx + j*ncx; A(r, k) = A[r*sar + k*sac], B(k, c) = B[k*sbr + c].
__device__ __forceinline__ void tile_mm(float (&acc)[TM][TN], const float* A,
                                        int sar, int sac, const float* B,
                                        int sbr, int K, int ry, int nry,
                                        int cx, int ncx, int M, int N) {
  for (int kk = 0; kk < K; ++kk) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ry + i * nry;
      a[i] = r < M ? A[r * sar + kk * sac] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = cx + j * ncx;
      b[j] = c < N ? B[kk * sbr + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const T* __restrict__ u, T* __restrict__ o, int H, int S,
                int dk, int dv, int C, int bonus, int G) {
  extern __shared__ float smem[];
  float* qs = smem;               // [C][dk]
  float* ks = qs + C * dk;        // [C][dk]; k_dec after the walk
  float* ws = ks + C * dk;        // [C][dk]
  float* qw = ws + C * dk;        // [C][dk]  q * exp(W or Wprev)
  float* vs = qw + C * dk;        // [C][dv]
  float* sc = vs + C * dv;        // [C][C]   scores[t][s]
  float* h0 = sc + C * C;         // [dk][dv] state before the chunk
  float* h1 = h0 + dk * dv;       // [dk][dv] state after the chunk
  float* ew = h1 + dk * dv;       // [dk]     exp(sum_t w[t])
  float* bo = ew + dk;            // [C]      bonus (q . (u k))
  float* uu = bo + C;             // [dk]

  const int bh = blockIdx.x, tid = threadIdx.x;
  const int64_t base_k = (int64_t)bh * S * dk, base_v = (int64_t)bh * S * dv;
  for (int e = tid; e < dk * dv; e += THREADS) h0[e] = 0.f;
  for (int d = tid; d < dk; d += THREADS) uu[d] = to_f32(u[(int64_t)(bh % H) * dk + d]);

  // product tiles: rows ry + i*nry, columns cx + j*ncx
  const int ncx = (dv + TN - 1) / TN;
  const int nry_o = (C + TM - 1) / TM, nry_h = (dk + TM - 1) / TM;
  const int lane = tid & 31;
  const int nitems = ((C * G + 31) / 32) * 32;   // whole warps

  for (int t0 = 0; t0 < S; t0 += C) {
    // 1. stage the chunk in f32; clear the scores
    for (int e = tid; e < C * dk; e += THREADS) {
      const int64_t g = base_k + (int64_t)t0 * dk + e;
      qs[e] = to_f32(q[g]);
      ks[e] = to_f32(k[g]);
      ws[e] = to_f32(w[g]);
    }
    for (int e = tid; e < C * dv; e += THREADS)
      vs[e] = to_f32(v[base_v + (int64_t)t0 * dv + e]);
    for (int e = tid; e < C * C; e += THREADS) sc[e] = 0.f;
    __syncthreads();
    // 2. bonus term per position, before the walk overwrites k with k_dec
    if (bonus) {
      for (int t = tid; t < C; t += THREADS) {
        float b = 0.f;
        for (int d = 0; d < dk; ++d)
          b = fmaf(qs[t * dk + d] * uu[d], ks[t * dk + d], b);
        bo[t] = b;
      }
      __syncthreads();
    }

    // 2a. scores[t][s] = sum_d q[t,d] k[s,d] exp(win), s <= t (inclusive)
    //     or s < t (bonus); G adjacent lanes share one s and split d.
    for (int item = tid; item < nitems; item += THREADS) {
      const int s = item / G, g = item % G;
      const int s0 = (item - lane) / G;          // lane 0's s: the warp's first
      const bool live = s < C;
      float run[DPT], kk[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = g + j * G;
        kk[j] = (live && d < dk) ? ks[s * dk + d] : 0.f;
        run[j] = 0.f;
      }
      for (int t = s0; t < C; ++t) {
        float part = 0.f;
        if (live && t >= s) {
#pragma unroll
          for (int j = 0; j < DPT; ++j) {
            const int d = g + j * G;
            if (d < dk) {
              const float wt = ws[t * dk + d];
              if (bonus) {              // exponent win[t-1, s]; then add w[t]
                if (t > s) part = fmaf(qs[t * dk + d] * kk[j], expf(run[j]), part);
                if (t > s) run[j] += wt;
              } else {                  // exponent win[t, s]
                if (t > s) run[j] += wt;
                part = fmaf(qs[t * dk + d] * kk[j], expf(run[j]), part);
              }
            }
          }
        }
        for (int off = G >> 1; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (live && g == 0 && (bonus ? t > s : t >= s)) sc[t * C + s] = part;
      }
      // run = win[C-1, s, d] = sum_{s<i<=C-1} w_i: the suffix decay
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = g + j * G;
        if (live && d < dk) ks[s * dk + d] = kk[j] * expf(run[j]);
      }
    }
    // 2b. per channel: q * exp(W or Wprev), and the full-chunk decay
    for (int d = tid; d < dk; d += THREADS) {
      float W = 0.f, wsum = 0.f;
      for (int t = 0; t < C; ++t) {
        const float prev = W;                     // Wprev[t] = W[t-1], a shift
        W += ws[t * dk + d];
        qw[t * dk + d] = qs[t * dk + d] * expf(bonus ? prev : W);
      }
      for (int t = 0; t < C; ++t) wsum += ws[t * dk + d];   // plain sum
      ew[d] = expf(wsum);
    }
    __syncthreads();

    // 3. o = qW @ h0 + scores @ v (+ bonus * v); h1 = ew * h0 + k_dec^T @ v
    for (int tile = tid; tile < nry_o * ncx; tile += THREADS) {
      const int ry = tile / ncx, cx = tile % ncx;
      float a[TM][TN] = {}, b[TM][TN] = {};
      tile_mm(a, qw, dk, 1, h0, dv, dk, ry, nry_o, cx, ncx, C, dv);
      tile_mm(b, sc, C, 1, vs, dv, C, ry, nry_o, cx, ncx, C, dv);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int t = ry + i * nry_o;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int e = cx + j * ncx;
          if (t < C && e < dv) {
            float r = a[i][j] + b[i][j];
            if (bonus) r += bo[t] * vs[t * dv + e];
            store(o + base_v + (int64_t)(t0 + t) * dv + e, r);
          }
        }
      }
    }
    for (int tile = tid; tile < nry_h * ncx; tile += THREADS) {
      const int ry = tile / ncx, cx = tile % ncx;
      float a[TM][TN] = {};
      tile_mm(a, ks, 1, dk, vs, dv, C, ry, nry_h, cx, ncx, dk, dv);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int d = ry + i * nry_h;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int e = cx + j * ncx;
          if (d < dk && e < dv) h1[d * dv + e] = ew[d] * h0[d * dv + e] + a[i][j];
        }
      }
    }
    __syncthreads();
    float* tmp = h0; h0 = h1; h1 = tmp;           // the new state
  }
}

// Bytes of dynamic shared memory one block needs.  Past the card's limit
// (227 KB on Hopper) cudaFuncSetAttribute refuses it and the call returns
// that error.
long long smem_bytes(int dk, int dv, int C) {
  return 4LL * (4LL * C * dk + (long long)C * dv + (long long)C * C +
                2LL * dk * dv + 2LL * dk + C);
}

}  // namespace

// q, k, w (B*H, S, dk), v (B*H, S, dv), u (H, dk), o (B*H, S, dv): contiguous,
// all f32 or all bf16 (bf16 flag); S % C == 0; dk <= 32 * 16.
extern "C" int ssm_scan(const void* q, const void* k, const void* v,
                        const void* w, const void* u, void* o, int B, int H,
                        int S, int dk, int dv, int C, int bonus, int bf16,
                        void* stream) {
  if (B < 1 || H < 1 || S < 1 || dk < 1 || dv < 1 || C < 1 || S % C ||
      dk > 32 * DPT)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(dk, dv, C);
  if (smem > 2147483647LL || (long long)B * H > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  int G = 1;                                       // lanes sharing one s
  while (G * DPT < dk) G *= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(B * H));
  cudaError_t err;
  if (bf16) {
    auto kern = ssm_scan_kernel<__nv_bfloat16>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(u), static_cast<__nv_bfloat16*>(o),
        H, S, dk, dv, C, bonus, G);
  } else {
    auto kern = ssm_scan_kernel<float>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(w),
        static_cast<const float*>(u), static_cast<float*>(o), H, S, dk, dv, C,
        bonus, G);
  }
  return static_cast<int>(cudaGetLastError());
}
