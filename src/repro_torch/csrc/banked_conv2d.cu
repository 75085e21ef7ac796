// Banked 2-D convolution for Hopper (sm_90a): valid, unit stride,
// x (Cin,H,W) * w (Cout,Cin,kh,kw) -> out (Cout, H-kh+1, W-kw+1).
//
// Replaces the TPU kernel repro/kernels/banked_conv2d.py:43 (banked_conv2d,
// _conv_kernel at :26).  There the grid is (Cout banks, output-row banks),
// each program keeps the whole input resident in VMEM (:70) and sums the
// kh x kw taps, each an einsum over Cin, in f32, with static offsets.
//
// Bound on the H100: at the paper's CNN layer (3 -> 8 channels, 80 x 60,
// 5 x 5) the conv moves ~0.2 MB and does ~5 MFLOP, well under a microsecond
// of either, so the kernel is latency: one launch, one round trip to device
// memory, and the longest chain of instructions in one warp.  At larger
// layers it is the 67 TFLOP/s of the f32 CUDA cores (each input value feeds
// Cout * kh * kw products).  The design:
//   * the block plan comes from the wrapper (kernels/banked_conv2d.py:plan,
//     tested on the CPU): the bank tiles keep the reference's meaning
//     (bc = ceil(Cout/banks[0]) channels, bh = ceil(H'/banks[1]) rows) and
//     each is cut into blocks of one channel x rows x bw outputs that never
//     straddle a bank; a block has rows * bw / 2 threads, 256 (8 rows x 64
//     columns, the paper's layer: 80 blocks of 8 warps) unless the block's
//     window would not fit in shared memory, when the plan halves it;
//   * each thread computes a strip of ROWS output rows of one column;
//   * the block's input window and its weights are staged in shared memory
//     with every load in flight at once (4-byte cp.async for f32); every
//     lane of a warp reads the same weight, a broadcast;
//   * the taps are compile-time constants for 5x5, 3x3 and 3x2 (one instance
//     with runtime taps serves any other size).  With compile-time taps the
//     channel loop is outside and every tap's partial sum over Cin stays in
//     a register, so one channel's window values (each loaded once and used
//     for every output row it feeds) and weights are all read at once; then
//     the taps are summed in order;
//   * each output sums its taps in the reference's order: per tap over Cin,
//     then tap after tap, (dy, dx) outer; ragged edges are masked, no padded
//     copy is made (the reference pads).
// Plain FMAs, no tensor cores.
//
// Exported as a plain C function (built with nvcc, bound with ctypes); it
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "phase_clocks.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int ROWS = 2;            // output rows a thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// KH = KW = 0: taps at run time (kh, kw).  A block: one output channel,
// rows x bw outputs, rows * bw / ROWS threads.
template <typename T, int KH, int KW>
__global__ void __launch_bounds__(MAX_THREADS)
banked_conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ out, int Cin, int H, int W, int kh, int kw,
                     int bh, int rows, int bw, int sub_r) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (KH > 0) { kh = KH; kw = KW; }
  const int Ho = H - kh + 1, Wo = W - kw + 1;
  const int o = blockIdx.z;
  const int bank_r = blockIdx.y / sub_r;
  const int r0 = bank_r * bh + (blockIdx.y % sub_r) * rows;
  const int r1 = min(min(bank_r * bh + bh, Ho), r0 + rows);
  const int c0 = blockIdx.x * bw;
  const int c1 = min(c0 + bw, Wo);
  if (r0 >= r1) return;              // whole block: no barrier is skipped

  const int taps = kh * kw;
  const int wr = rows + kh - 1, wc = bw + kw - 1;  // staged window
  float* ws = smem;                               // [Cin][kh][kw]
  float* xs = smem + Cin * taps;                  // [Cin][wr][wc]

  PHASE_START();
  // a warp a window row (c, r), its lanes along the columns
  for (int cr = threadIdx.x / 32; cr < Cin * wr; cr += blockDim.x / 32) {
    const int c = cr / wr, r = cr - c * wr;
    const bool row_in = r0 + r < H;
    const int64_t g0 = ((int64_t)c * H + r0 + r) * W + c0;
    for (int cc = threadIdx.x % 32; cc < wc; cc += 32) {
      const bool in = row_in && c0 + cc < W;
      if constexpr (std::is_same<T, float>::value) {
        cp_async4(xs + cr * wc + cc, x + (in ? g0 + cc : 0), in);
      } else {
        xs[cr * wc + cc] = in ? to_f32(x[g0 + cc]) : 0.f;
      }
    }
  }
  cp_async_commit();
  PHASE(0);
  for (int e = threadIdx.x; e < Cin * taps; e += blockDim.x)
    ws[e] = to_f32(w[(int64_t)o * Cin * taps + e]);   // e = (c*kh + dy)*kw + dx
  cp_async_wait<0>();
  __syncthreads();
  PHASE(1);

  const int tx = threadIdx.x % bw, ty = threadIdx.x / bw;
  const int col = c0 + tx, rbase = r0 + ty * ROWS;
  if (col >= c1 || rbase >= r1) {                 // no barrier after this
    PHASE_END();
    return;
  }
  const float* xt = xs + ty * ROWS * wc + tx;     // this strip's window

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  if constexpr (KH > 0) {
    // the channel loop outside, every tap's partial sum over Cin in
    // registers, so that one channel's window values and weights are all
    // read at once; then the taps summed in order
    float t[KH][KW][ROWS];
#pragma unroll
    for (int dy = 0; dy < KH; ++dy)
#pragma unroll
      for (int dx = 0; dx < KW; ++dx)
#pragma unroll
        for (int r = 0; r < ROWS; ++r) t[dy][dx][r] = 0.f;
    for (int c = 0; c < Cin; ++c) {
      float xw[ROWS + KH - 1][KW];
#pragma unroll
      for (int ir = 0; ir < ROWS + KH - 1; ++ir)
#pragma unroll
        for (int dx = 0; dx < KW; ++dx) xw[ir][dx] = xt[(c * wr + ir) * wc + dx];
#pragma unroll
      for (int dy = 0; dy < KH; ++dy)
#pragma unroll
        for (int dx = 0; dx < KW; ++dx) {
          const float wv = ws[(c * KH + dy) * KW + dx];
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            t[dy][dx][r] = fmaf(wv, xw[r + dy][dx], t[dy][dx][r]);
        }
    }
#pragma unroll
    for (int dy = 0; dy < KH; ++dy)
#pragma unroll
      for (int dx = 0; dx < KW; ++dx)
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] += t[dy][dx][r];
  } else {
    for (int dy = 0; dy < kh; ++dy) {
      for (int dx = 0; dx < kw; ++dx) {         // one tap: sum over Cin
        float t[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) t[r] = 0.f;
#pragma unroll 4
        for (int c = 0; c < Cin; ++c) {
          const float wv = ws[(c * kh + dy) * kw + dx];
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            t[r] = fmaf(wv, xt[(c * wr + r + dy) * wc + dx], t[r]);
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] += t[r];
      }
    }
  }
  PHASE(2);
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (rbase + r < r1) store(out + ((int64_t)o * Ho + rbase + r) * Wo + col, acc[r]);
  PHASE(3);
  PHASE_END();
}

// Bytes of dynamic shared memory one block needs (kernels/banked_conv2d.py:
// smem_bytes, whose plan keeps it under the card's limit; past the limit
// cudaFuncSetAttribute refuses it and the call returns that error).
long long smem_bytes(int Cin, int kh, int kw, int rows, int bw) {
  return 4LL * Cin * ((rows + kh - 1LL) * (bw + kw - 1LL) + (long long)kh * kw);
}

template <typename T, int KH, int KW>
cudaError_t launch(const void* x, const void* w, void* out, int Cin, int H, int W,
                   int kh, int kw, int bh, int rows, int bw, int sub_r, dim3 grid,
                   cudaStream_t s) {
  auto k = banked_conv2d_kernel<T, KH, KW>;
  const long long smem = smem_bytes(Cin, kh, kw, rows, bw);
  if (smem > 2147483647LL) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  k<<<grid, rows * bw / ROWS, smem, s>>>(static_cast<const T*>(x),
                                         static_cast<const T*>(w), static_cast<T*>(out),
                                         Cin, H, W, kh, kw, bh, rows, bw, sub_r);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_taps(const void* x, const void* w, void* out, int Cin, int H, int W,
                    int kh, int kw, int bh, int rows, int bw, int sub_r, dim3 grid,
                    cudaStream_t s) {
#define REPRO_CONV_TAPS(KH, KW)                                                    \
  return launch<T, KH, KW>(x, w, out, Cin, H, W, kh, kw, bh, rows, bw, sub_r, grid, s)
  if (kh == 5 && kw == 5) REPRO_CONV_TAPS(5, 5);
  if (kh == 3 && kw == 3) REPRO_CONV_TAPS(3, 3);
  if (kh == 3 && kw == 2) REPRO_CONV_TAPS(3, 2);
  REPRO_CONV_TAPS(0, 0);
#undef REPRO_CONV_TAPS
}

}  // namespace

// x, w: contiguous, f32 or bf16 (bf16 flag); out: contiguous (Cout,H',W') of
// the same dtype; bh: the bank tile's output rows (a block is one channel,
// so no block crosses a channel bank); the block plan (rows x bw outputs,
// sub_r blocks a bank tile's rows, grid gx x gy x Cout) as
// kernels/banked_conv2d.py:plan makes it.
extern "C" int banked_conv2d(const void* x, const void* w, void* out, int Cin,
                             int H, int W, int Cout, int kh, int kw, int bh,
                             int rows, int bw, int sub_r, int gx, int gy, int bf16,
                             void* stream) {
  const int Ho = H - kh + 1, Wo = W - kw + 1;
  if (Cin < 1 || Cout < 1 || kh < 1 || kw < 1 || Ho < 1 || Wo < 1 || bh < 1 ||
      (bw != 32 && bw != 64) || rows < ROWS || rows % ROWS ||
      rows * bw / ROWS > MAX_THREADS || sub_r < 1 || gx < 1 || gy < 1 ||
      gy > 65535 || Cout > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                  static_cast<unsigned>(Cout));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? by_taps<__nv_bfloat16>(x, w, out, Cin, H, W, kh, kw, bh, rows, bw, sub_r,
                                    grid, s)
           : by_taps<float>(x, w, out, Cin, H, W, kh, kw, bh, rows, bw, sub_r, grid, s);
  return static_cast<int>(err);
}

// The card's shared memory a block may opt into, in bytes (the plan's limit).
extern "C" int banked_conv2d_smem_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return bytes;
}

PHASE_CLOCKS_EXPORT(banked_conv2d_phase_cycles)
