// Banked 2-D convolution for Hopper (sm_90a): valid, unit stride,
// x (Cin,H,W) * w (Cout,Cin,kh,kw) -> out (Cout, H-kh+1, W-kw+1).
//
// Replaces the TPU kernel repro/kernels/banked_conv2d.py:43 (banked_conv2d,
// _conv_kernel at :26).  There the grid is (Cout banks, output-row banks),
// each program keeps the whole input resident in VMEM (:70) and sums the
// kh x kw taps, each an einsum over Cin, in f32.
//
// Bound on the H100: at the paper's CNN layer (3 -> 8 channels, 80 x 60,
// 5 x 5) the conv moves ~0.2 MB and does ~5 MFLOP, well under a microsecond
// of either, so one launch dominates; at larger layers it is the 67 TFLOP/s
// of the f32 CUDA cores (each input value feeds Cout * kh * kw products).
// The design:
//   * the bank tiles keep the reference's meaning (bc = ceil(Cout/banks[0])
//     channels, bh = ceil(H'/banks[1]) rows) and each is cut into
//     TC x TR x TW block tiles that never straddle a bank, so banks (1,1) on
//     the paper's layer still spreads over 76 blocks;
//   * each block stages only its own input window, Cin x (rows + kh - 1) x
//     (cols + kw - 1), and its channels' weights in shared memory: the input
//     is not kept resident;
//   * each thread owns one output pixel for up to TC channels and sums the
//     taps in the Pallas order, (dy, dx) outer and Cin inner, in f32;
//   * ragged edges are masked; no padded copy is made (the reference pads).
// Plain FMAs, no tensor cores or TMA in this version.
//
// Exported as a plain C function (built with nvcc, bound with ctypes); it
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC = 4;              // output channels per block tile
constexpr int TR = 4, TW = 32;     // output rows x columns per block tile
constexpr int THREADS = TR * TW;   // one output pixel per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
banked_conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ out, int Cin, int H, int W, int Cout,
                     int kh, int kw, int bc, int bh, int sub_c, int sub_r) {
  extern __shared__ float smem[];
  const int Ho = H - kh + 1, Wo = W - kw + 1;
  const int bank_c = blockIdx.z / sub_c, bank_r = blockIdx.y / sub_r;
  const int o0 = bank_c * bc + (blockIdx.z % sub_c) * TC;
  const int o1 = min(min(bank_c * bc + bc, Cout), o0 + TC);
  const int r0 = bank_r * bh + (blockIdx.y % sub_r) * TR;
  const int r1 = min(min(bank_r * bh + bh, Ho), r0 + TR);
  const int c0 = blockIdx.x * TW;
  const int c1 = min(c0 + TW, Wo);
  if (o0 >= o1 || r0 >= r1) return;  // whole block: no barrier is skipped

  const int nc = o1 - o0;
  const int wr = TR + kh - 1, wc = TW + kw - 1;   // staged window (padded)
  const int vr = r1 - r0 + kh - 1, vc = c1 - c0 + kw - 1;  // valid part
  float* xs = smem;                               // [Cin][wr][wc]
  float* ws = smem + Cin * wr * wc;               // [nc][Cin][kh][kw]
  const int taps = kh * kw;

  for (int e = threadIdx.x; e < Cin * wr * wc; e += THREADS) {
    const int c = e / (wr * wc), rc = e % (wr * wc), r = rc / wc, cc = rc % wc;
    xs[e] = (r < vr && cc < vc)
                ? to_f32(x[((int64_t)c * H + r0 + r) * W + c0 + cc]) : 0.f;
  }
  for (int e = threadIdx.x; e < nc * Cin * taps; e += THREADS)
    ws[e] = to_f32(w[(int64_t)o0 * Cin * taps + e]);
  __syncthreads();

  const int ty = threadIdx.x / TW, tx = threadIdx.x % TW;
  const int r = r0 + ty, col = c0 + tx;
  if (r >= r1 || col >= c1) return;               // no barrier after this

  float acc[TC];
#pragma unroll
  for (int o = 0; o < TC; ++o) acc[o] = 0.f;
  for (int dy = 0; dy < kh; ++dy) {
    for (int dx = 0; dx < kw; ++dx) {               // one tap: sum over Cin
      float t[TC];
#pragma unroll
      for (int o = 0; o < TC; ++o) t[o] = 0.f;
      for (int c = 0; c < Cin; ++c) {
        const float xv = xs[(c * wr + ty + dy) * wc + tx + dx];
        const float* wp = ws + (c * kh + dy) * kw + dx;
#pragma unroll
        for (int o = 0; o < TC; ++o)
          if (o < nc) t[o] = fmaf(wp[o * Cin * taps], xv, t[o]);
      }
#pragma unroll
      for (int o = 0; o < TC; ++o) acc[o] += t[o];
    }
  }
#pragma unroll
  for (int o = 0; o < TC; ++o)
    if (o < nc) store(out + ((int64_t)(o0 + o) * Ho + r) * Wo + col, acc[o]);
}

// Bytes of dynamic shared memory one block needs.  Past the card's limit
// (227 KB on Hopper) cudaFuncSetAttribute refuses it and the call returns
// that error.
long long smem_bytes(int Cin, int kh, int kw) {
  return 4LL * Cin * ((TR + kh - 1LL) * (TW + kw - 1LL) + (long long)TC * kh * kw);
}

}  // namespace

// x, w: contiguous, f32 or bf16 (bf16 flag); out: contiguous (Cout,H',W') of
// the same dtype; (bc, bh): the bank tiles of output channels and rows.
extern "C" int banked_conv2d(const void* x, const void* w, void* out,
                             int Cin, int H, int W, int Cout, int kh, int kw,
                             int bc, int bh, int bf16, void* stream) {
  const int Ho = H - kh + 1, Wo = W - kw + 1;
  if (Cin < 1 || Cout < 1 || kh < 1 || kw < 1 || Ho < 1 || Wo < 1 ||
      bc < 1 || bh < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(Cin, kh, kw);
  if (smem > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  // block tiles per bank tile (a bank tile never exceeds the output)
  const int sub_c = ((bc < Cout ? bc : Cout) + TC - 1) / TC;
  const int sub_r = ((bh < Ho ? bh : Ho) + TR - 1) / TR;
  const long long gz = (long long)((Cout + bc - 1) / bc) * sub_c;
  const long long gy = (long long)((Ho + bh - 1) / bh) * sub_r;
  const long long gx = (Wo + TW - 1) / TW;
  if (gz > 65535 || gy > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                  static_cast<unsigned>(gz));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    auto k = banked_conv2d_kernel<__nv_bfloat16>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    k<<<grid, THREADS, smem, s>>>(static_cast<const __nv_bfloat16*>(x),
                                  static_cast<const __nv_bfloat16*>(w),
                                  static_cast<__nv_bfloat16*>(out), Cin, H, W,
                                  Cout, kh, kw, bc, bh, sub_c, sub_r);
  } else {
    auto k = banked_conv2d_kernel<float>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    k<<<grid, THREADS, smem, s>>>(static_cast<const float*>(x),
                                  static_cast<const float*>(w),
                                  static_cast<float*>(out), Cin, H, W, Cout,
                                  kh, kw, bc, bh, sub_c, sub_r);
  }
  return static_cast<int>(cudaGetLastError());
}
