// Banked tiled matmul for Hopper (sm_90a): C[M,N] = A[M,K] @ B[K,N].
//
// Replaces the TPU kernel repro/kernels/banked_matmul.py::banked_matmul.
// There the grid (M/bm, N/bn, K/bk) runs in order on one core and a VMEM
// scratch carries the f32 sum across the sequential K steps.  Here blocks run
// in parallel in no order, so:
//   * each (bm, bn) bank tile of C is split into BM x BN block tiles that
//     never straddle a bank boundary (the bank plan keeps its meaning, and a
//     single bank still fills the SMs);
//   * a loop inside the block walks the K banks in BK-deep steps, staging A
//     and B tiles in shared memory, and each thread keeps a TM x TN f32 tile
//     of C in registers: f32 accumulation whatever the input type;
//   * ragged edges are masked here; the reference zero-pads, no padded copy
//     is made.
// Bound: at the paper's shapes the launch dominates (a product moves at most
// ~100 KB); at 1024^3 f32 the 67 TFLOP/s of the CUDA cores.  Plain FMAs, no
// TF32, tensor cores, TMA or wgmma in this version.
//
// Exported as a plain C function (built with nvcc, bound with ctypes); it
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16;   // block tile of C, K step
constexpr int TM = 4, TN = 4;              // register tile per thread
constexpr int TY = BM / TM, TX = BN / TN;  // 16 x 16 threads
constexpr int THREADS = TY * TX;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
banked_matmul_kernel(const Tin* __restrict__ a, const Tin* __restrict__ b,
                     Tout* __restrict__ c, int M, int N, int K,
                     int64_t sa0, int64_t sa1, int64_t sb0, int64_t sb1,
                     int bm, int bn, int bk, int sub_m, int sub_n) {
  // As is stored k-major and padded by one column so that the transposing
  // store below spreads over the shared-memory banks.
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int bank_m = blockIdx.y / sub_m, bank_n = blockIdx.x / sub_n;
  const int r0 = bank_m * bm + (blockIdx.y % sub_m) * BM;
  const int c0 = bank_n * bn + (blockIdx.x % sub_n) * BN;
  const int r1 = min(min(bank_m * bm + bm, M), r0 + BM);
  const int c1 = min(min(bank_n * bn + bn, N), c0 + BN);
  if (r0 >= r1 || c0 >= c1) return;  // whole block: no barrier is skipped

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < K; kb += bk) {          // the K banks, in order
    const int kend = min(kb + bk, K);
    for (int k0 = kb; k0 < kend; k0 += BK) {    // BK-deep steps of one bank
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, kk = e % BK;
        const int gr = r0 + r, gk = k0 + kk;
        As[kk][r] = (gr < r1 && gk < kend) ? to_f32(a[gr * sa0 + gk * sa1]) : 0.f;
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int kk = e / BN, cc = e % BN;
        const int gk = k0 + kk, gc = c0 + cc;
        Bs[kk][cc] = (gk < kend && gc < c1) ? to_f32(b[gk * sb0 + gc * sb1]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + i * TY];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + j * TX];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + i * TY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int cc = c0 + tx + j * TX;
      if (r < r1 && cc < c1) c[(int64_t)r * N + cc] = from_f32<Tout>(acc[i][j]);
    }
  }
}

template <typename Tin, typename Tout>
void launch(const void* a, const void* b, void* c, int M, int N, int K,
            int64_t sa0, int64_t sa1, int64_t sb0, int64_t sb1,
            int bm, int bn, int bk, int sub_m, int sub_n, dim3 grid,
            cudaStream_t stream) {
  banked_matmul_kernel<Tin, Tout><<<grid, THREADS, 0, stream>>>(
      static_cast<const Tin*>(a), static_cast<const Tin*>(b),
      static_cast<Tout*>(c), M, N, K, sa0, sa1, sb0, sb1, bm, bn, bk,
      sub_m, sub_n);
}

}  // namespace

// a, b: f32 or bf16 (in_bf16) with element strides (sa0, sa1), (sb0, sb1);
// c: contiguous (M, N), f32 or bf16 (out_bf16); (bm, bn, bk): the bank tiles.
extern "C" int banked_matmul(const void* a, const void* b, void* c,
                             int M, int N, int K,
                             int64_t sa0, int64_t sa1, int64_t sb0, int64_t sb1,
                             int bm, int bn, int bk, int in_bf16, int out_bf16,
                             void* stream) {
  if (M < 1 || N < 1 || K < 1 || bm < 1 || bn < 1 || bk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // block tiles per bank tile (a bank tile never exceeds the matrix)
  const int sub_m = ((bm < M ? bm : M) + BM - 1) / BM;
  const int sub_n = ((bn < N ? bn : N) + BN - 1) / BN;
  const long long gy = (long long)((M + bm - 1) / bm) * sub_m;
  const long long gx = (long long)((N + bn - 1) / bn) * sub_n;
  if (gy > 65535 || gx > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, M, N, K, sa0, sa1, sb0, sb1,
                                         bm, bn, bk, sub_m, sub_n, grid, s);
  else if (in_bf16)
    launch<__nv_bfloat16, float>(a, b, c, M, N, K, sa0, sa1, sb0, sb1,
                                 bm, bn, bk, sub_m, sub_n, grid, s);
  else if (out_bf16)
    launch<float, __nv_bfloat16>(a, b, c, M, N, K, sa0, sa1, sb0, sb1,
                                 bm, bn, bk, sub_m, sub_n, grid, s);
  else
    launch<float, float>(a, b, c, M, N, K, sa0, sa1, sb0, sb1,
                         bm, bn, bk, sub_m, sub_n, grid, s);
  return static_cast<int>(cudaGetLastError());
}
