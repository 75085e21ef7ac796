// Flash attention (online softmax) for Hopper (sm_90a), with GQA and a
// causal mask: q (B,Hq,S,D), k/v (B,Hkv,Sk,D) -> o (B,Hq,S,D).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:58
// (flash_attention, _flash_kernel at :22).  There the grid is
// (B*Hq, S/bq, Sk/bk); the kv axis runs in order on one core and VMEM
// scratch carries the running max m, denominator l and accumulator in f32;
// the kv head h // group is picked in the BlockSpec index map.
//
// Bound on the H100: 4 * S * Sk * D flops per head (half of it under the
// causal mask) against S * D * 4 bytes of q and o per head, so at the
// qwen2-0.5b widths (D 64, S 4096) it is the operations: the 67 TFLOP/s of
// the f32 CUDA cores, or 989 TFLOP/s of bf16 tensor cores.  The design:
//   * one block per (b * Hq, 64-row q tile), one thread per query row; the
//     sequential kv grid axis becomes a loop inside the block over 64-key
//     tiles in order, so m, l and the D-wide accumulator stay in f32
//     registers for the whole row;
//   * each k/v tile is staged once in shared memory (widened to f32) and
//     read by all 64 rows as broadcasts; q stays in registers;
//   * the kv head is h / group in the pointer arithmetic: no repeated copy
//     of k or v is made;
//   * the causal mask is the reference kernel's top-left q_id >= k_id with a
//     -1e30 fill; kv tiles wholly above the diagonal are skipped (in the
//     Pallas kernel they add exactly 0: alpha = 1, p = 0);
//   * l is clamped at 1e-30 before the division, as in the reference.
// The kernel's tile (64 x 64) is its own and need not equal the caller's
// block_q / block_k, which the wrapper checks as the reference does; online
// softmax gives the same result for any tiling up to rounding.  Plain FMAs,
// no tensor cores, TMA or wgmma in this version.
//
// Exported as a plain C function (built with nvcc, bound with ctypes); it
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block, one per thread
constexpr int BK = 64;   // keys per kv tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// DP: the head dim rounded up to a multiple of 16; lanes d >= D hold zeros.
template <typename T, int DP>
__global__ void __launch_bounds__(BQ)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int Hq, int Hkv, int S, int Sk, int D, float scale,
                       int causal) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [BK][DP]
  float* vs = ks + BK * DP;                     // [BK][DP]
  float* sc = vs + BK * DP;                     // [BK][BQ] scores, column per row

  const int bh = blockIdx.x;                    // b * Hq + h
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);     // GQA: kv head h // group
  const int i0 = blockIdx.y * BQ, tid = threadIdx.x, i = i0 + tid;
  const bool row = i < S;

  const T* qp = q + ((int64_t)bh * S + (row ? i : 0)) * D;
  const T* kp = k + (int64_t)kvh * Sk * D;
  const T* vp = v + (int64_t)kvh * Sk * D;

  float qr[DP], acc[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    qr[d] = (row && d < D) ? to_f32(qp[d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  // kv tiles wholly above the diagonal add exactly 0: skip them
  const int kend = causal ? min(Sk, i0 + BQ) : Sk;
  for (int j0 = 0; j0 < kend; j0 += BK) {
    const int nk = min(BK, Sk - j0);
    for (int e = tid; e < BK * DP; e += BQ) {
      const int j = e / DP, d = e % DP;
      const bool in = j < nk && d < D;
      ks[e] = in ? to_f32(kp[(int64_t)(j0 + j) * D + d]) : 0.f;
      vs[e] = in ? to_f32(vp[(int64_t)(j0 + j) * D + d]) : 0.f;
    }
    __syncthreads();

    // scores of this row against the tile, and their max
    float mt = NEG_INF;
    for (int j = 0; j < nk; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * DP);
      float s = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DP / 4; ++d4) {
        const float4 kk = kr[d4];
        s = fmaf(qr[4 * d4 + 0], kk.x, s);
        s = fmaf(qr[4 * d4 + 1], kk.y, s);
        s = fmaf(qr[4 * d4 + 2], kk.z, s);
        s = fmaf(qr[4 * d4 + 3], kk.w, s);
      }
      s *= scale;
      if (causal && i < j0 + j) s = NEG_INF;
      sc[j * BQ + tid] = s;
      mt = fmaxf(mt, s);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int d = 0; d < DP; ++d) acc[d] *= alpha;
    for (int j = 0; j < nk; ++j) {
      const float p = expf(sc[j * BQ + tid] - m_new);
      psum += p;
      const float4* vr = reinterpret_cast<const float4*>(vs + j * DP);
#pragma unroll
      for (int d4 = 0; d4 < DP / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();                            // before the next tile lands
  }

  if (!row) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* op = o + ((int64_t)bh * S + i) * D;
#pragma unroll
  for (int d = 0; d < DP; ++d)
    if (d < D) store(op + d, acc[d] * inv);
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int Sk, int D, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * BK * DP + BK * BQ);
  auto kern = flash_attention_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * Hq), static_cast<unsigned>((S + BQ - 1) / BQ));
  kern<<<grid, BQ, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                   static_cast<const T*>(v), static_cast<T*>(o),
                                   Hq, Hkv, S, Sk, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int S, int Sk, int D, float scale, int causal,
             cudaStream_t s) {
  if (D <= 16) return launch<T, 16>(q, k, v, o, B, Hq, Hkv, S, Sk, D, scale, causal, s);
  if (D <= 32) return launch<T, 32>(q, k, v, o, B, Hq, Hkv, S, Sk, D, scale, causal, s);
  if (D <= 64) return launch<T, 64>(q, k, v, o, B, Hq, Hkv, S, Sk, D, scale, causal, s);
  return launch<T, 128>(q, k, v, o, B, Hq, Hkv, S, Sk, D, scale, causal, s);
}

}  // namespace

// q, k, v, o: contiguous, all f32 or all bf16 (bf16 flag); D <= 128.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Hq, int Hkv, int S, int Sk,
                               int D, float scale, int causal, int bf16,
                               void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || S < 1 || Sk < 1 || D < 1 ||
      D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)B * Hq > 2147483647LL || (S + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, Sk, D, scale, causal, s);
  return dispatch<float>(q, k, v, o, B, Hq, Hkv, S, Sk, D, scale, causal, s);
}
