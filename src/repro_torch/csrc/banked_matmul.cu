// Banked matmul for Hopper (sm_90a): C[M,N] = A[M,K] @ B[K,N].
//
// Replaces the TPU kernel repro/kernels/banked_matmul.py::banked_matmul.
// There the grid (M/bm, N/bn, K/bk) runs in order on one core and a VMEM
// scratch carries the f32 sum across the sequential K steps.  Here blocks run
// in parallel in no order, so each bank tile of C is cut into block tiles
// that never straddle a bank boundary, and K is summed inside a block (and,
// for long K, across blocks in a second pass).  f32 accumulation whatever
// the input type; ragged edges are masked here (the reference zero-pads).
//
// What bounds it on this card: every product of the paper's designs is
// skinny (M <= 8, N <= 48, K <= 64, and the CNN's 1 x 5472 x 2); it moves at
// most ~65 KB, so its time is latency: the launch, one pass over K, and the
// reduction.  (A 64 x 64 block tile walking K in 16-deep steps, with two
// barriers each and no load in flight across steps, takes 344 dependent
// steps for the CNN's K.)  Large products are bound by the f32 CUDA cores' 67 TFLOP/s or
// the bf16 tensor cores' 989.  Two variants, chosen by the wrapper's plan
// (kernels/banked_matmul.py::plan), which also sizes grid and blocks:
//   * skinny (M <= 16): one block per bank tile of C x sub-tile of at most
//     16 x 32 or 8 x 64 (x split of K).  A warp owns a 4 x 8 micro-tile of
//     C; its lanes take 4 consecutive k each, so a warp reads 128
//     consecutive k of A's rows in one coalesced (vectorised where aligned)
//     load, and B's rows beside them.  The block's warps take interleaved
//     128-wide K slices: the whole of K in one pass, no barrier per step.
//     Partials are reduced in a fixed order: a 31-shuffle reduce-scatter
//     inside the warp (lane l ends with output l of the micro-tile), then a
//     tree over the warps in shared memory.  Where one block would leave a thread more than 32 k values,
//     K is split over blocks (grid z); each writes its partial to a
//     workspace and a second launch sums the splits in index order.  No
//     float atomics: a product gives the same bits on every run.
//   * tiled (M > 16): 128 x 128 block tiles.  f32: 256 threads with an
//     8 x 8 register tile each (four 16-byte shared loads per 64 FMAs), K
//     in 8-deep steps through a 3-stage ring that 4-byte cp.async copies
//     (any strides) fill two steps ahead; plain FMAs, no TF32.  bf16 with
//     16-byte-aligned rows: wgmma on the tensor cores, f32 accumulators (the
//     kernel below the FMA one); other bf16 operands are widened into the
//     FMA kernel.
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------- tiled ----
constexpr int TBM = 128, TBN = 128, TBK = 8;   // block tile of C, K step
constexpr int STAGES = 3;                      // K steps in shared memory
constexpr int THREADS = 256;                   // 16 x 16 threads, 8 x 8 of C each
constexpr int LDT = TBM + 4;                   // tile row stride (floats)

// one element into shared memory as f32 (zero where !in): f32 by a 4-byte
// cp.async, bf16 by a load and a store
__device__ __forceinline__ void copy1(float* dst, const float* src, bool in) {
  cp_async4(dst, src, in);
}
__device__ __forceinline__ void copy1(float* dst, const __nv_bfloat16* src, bool in) {
  *dst = in ? __bfloat162float(*src) : 0.f;
}

// K step [k0, k0 + TBK) of the block's A rows and B columns into As[k][m],
// Bs[k][n].  Each operand is read with any strides; threads run along K
// where that is the operand's contiguous axis, else along M (N), so that
// neighbouring threads read neighbouring addresses.
template <typename Tin>
__device__ __forceinline__ void load_step(float* As, float* Bs, const Tin* a,
                                          const Tin* b, int r0, int r1, int c0,
                                          int c1, int k0, int K, int64_t sa0,
                                          int64_t sa1, int64_t sb0, int64_t sb1) {
  const bool a_kfast = sa1 == 1, b_kfast = sb0 == 1;
#pragma unroll
  for (int i = 0; i < TBM * TBK / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int kk = a_kfast ? e % TBK : e / TBM, r = a_kfast ? e / TBK : e % TBM;
    const int gr = r0 + r, gk = k0 + kk;
    const bool in = gr < r1 && gk < K;
    copy1(As + kk * LDT + r, in ? a + gr * sa0 + gk * sa1 : a, in);
  }
#pragma unroll
  for (int i = 0; i < TBN * TBK / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int kk = b_kfast ? e % TBK : e / TBN, n = b_kfast ? e / TBK : e % TBN;
    const int gk = k0 + kk, gc = c0 + n;
    const bool in = gk < K && gc < c1;
    copy1(Bs + kk * LDT + n, in ? b + gk * sb0 + gc * sb1 : b, in);
  }
}

// Two blocks an SM in f32; bf16's staging loads hold registers of their own
// and would spill under that cap.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS, sizeof(Tin) == 4 ? 2 : 1)
tiled_kernel(const Tin* __restrict__ a, const Tin* __restrict__ b,
             Tout* __restrict__ c, int M, int N, int K,
             int64_t sa0, int64_t sa1, int64_t sb0, int64_t sb1,
             int bm, int bn, int sub_m, int sub_n) {
  __shared__ __align__(16) float As[STAGES][TBK * LDT];
  __shared__ __align__(16) float Bs[STAGES][TBK * LDT];

  const int bank_m = blockIdx.y / sub_m, bank_n = blockIdx.x / sub_n;
  const int r0 = bank_m * bm + (blockIdx.y % sub_m) * TBM;
  const int c0 = bank_n * bn + (blockIdx.x % sub_n) * TBN;
  const int r1 = min(min(bank_m * bm + bm, M), r0 + TBM);
  const int c1 = min(min(bank_n * bn + bn, N), c0 + TBN);
  if (r0 >= r1 || c0 >= c1) return;  // whole block: no barrier is skipped

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (K + TBK - 1) / TBK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk)
      load_step(As[st], Bs[st], a, b, r0, r1, c0, c1, st * TBK, K, sa0, sa1, sb0, sb1);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();   // step kt landed
    __syncthreads();               // ... for every thread; step kt - 1 is done
    const int nxt = kt + STAGES - 1;
    if (nxt < nk)
      load_step(As[nxt % STAGES], Bs[nxt % STAGES], a, b, r0, r1, c0, c1,
                nxt * TBK, K, sa0, sa1, sb0, sb1);
    cp_async_commit();
    const float* as = As[kt % STAGES];
    const float* bs = Bs[kt % STAGES];
#pragma unroll
    for (int kk = 0; kk < TBK; ++kk) {
      // rows ty*4.. and 64 + ty*4.., columns tx*4.. and 64 + tx*4..: four
      // 16-byte loads for 64 FMAs
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * LDT + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * LDT + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * LDT + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * LDT + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + (i / 4) * 64 + ty * 4 + i % 4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cc = c0 + (j / 4) * 64 + tx * 4 + j % 4;
      if (r < r1 && cc < c1) c[(int64_t)r * N + cc] = from_f32<Tout>(acc[i][j]);
    }
  }
}

// --------------------------------------------------- tiled, bf16, wgmma ----
// 128 x 128 block tiles, two warpgroups of 64 rows, K in 64-deep steps
// through a 3-stage ring that cp.async fills two steps ahead, in the
// 128-byte swizzled layout (csrc/hopper.cuh): A K-major [128 rows][64 k];
// B K-major [128 columns][64 k] where it is a transposed view (its K axis
// contiguous), else MN-major as two [64 k][64 columns] halves.  Needs rows
// of A (and of B along its contiguous axis) 16-byte aligned; the plan sends
// other bf16 operands to the FMA kernel above.
constexpr int WBM = 128, WBN = 128, WBK = 64, WSTAGES = 3, WTHREADS = 256;
constexpr int WTILE = WBM * WBK;   // elements of an A (or B) stage

template <typename Tout, bool B_KMAJOR>
__global__ void __launch_bounds__(WTHREADS, 1)
tiled_wgmma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                   Tout* __restrict__ c, int M, int N, int K, int64_t sa0,
                   int64_t sb, int bm, int bn, int sub_m, int sub_n) {
  extern __shared__ unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* Bs = As + WSTAGES * WTILE;

  const int bank_m = blockIdx.y / sub_m, bank_n = blockIdx.x / sub_n;
  const int r0 = bank_m * bm + (blockIdx.y % sub_m) * WBM;
  const int c0 = bank_n * bn + (blockIdx.x % sub_n) * WBN;
  const int r1 = min(min(bank_m * bm + bm, M), r0 + WBM);
  const int c1 = min(min(bank_n * bn + bn, N), c0 + WBN);
  if (r0 >= r1 || c0 >= c1) return;  // whole block: no barrier is skipped

  // one K step into stage st: 1024 16-byte chunks of A and of B, 4 each a
  // thread; chunks past the tile's rows, columns or K are zeros
  auto load = [&](int st, int kt) {
    bf16* as = As + st * WTILE;
    bf16* bs = Bs + st * WTILE;
    const int k0 = kt * WBK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = threadIdx.x + i * WTHREADS;
      const int r = e / 8, ch = e % 8, gk = k0 + ch * 8;
      const int bytes = (r0 + r < r1 && gk < K) ? min(16, (K - gk) * 2) : 0;
      cp_async16(as + r * 64 + ((ch ^ (r & 7)) * 8),
                 bytes ? a + (int64_t)(r0 + r) * sa0 + gk : a, bytes);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = threadIdx.x + i * WTHREADS;
      if (B_KMAJOR) {   // element (k, n) at b[n * sb + k]
        const int n = e / 8, ch = e % 8, gk = k0 + ch * 8;
        const int bytes = (c0 + n < c1 && gk < K) ? min(16, (K - gk) * 2) : 0;
        cp_async16(bs + n * 64 + ((ch ^ (n & 7)) * 8),
                   bytes ? b + (int64_t)(c0 + n) * sb + gk : b, bytes);
      } else {          // element (k, n) at b[k * sb + n]
        const int kk = e / 16, cn = e % 16, ch = cn % 8, gc = c0 + cn * 8;
        const int bytes = (k0 + kk < K && gc < c1) ? min(16, (c1 - gc) * 2) : 0;
        cp_async16(bs + (cn / 8) * (64 * 64) + kk * 64 + ((ch ^ (kk & 7)) * 8),
                   bytes ? b + (int64_t)(k0 + kk) * sb + gc : b, bytes);
      }
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;

  const int nk = (K + WBK - 1) / WBK;
#pragma unroll
  for (int st = 0; st < WSTAGES - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<WSTAGES - 2>();   // step kt landed
    fence_proxy_async();
    __syncthreads();                // ... for every thread; step kt - 1 is done
    const int nxt = kt + WSTAGES - 1;
    if (nxt < nk) load(nxt % WSTAGES, nxt);
    cp_async_commit();
    const bf16* as = As + (kt % WSTAGES) * WTILE + wg * 64 * 64;
    const bf16* bs = Bs + (kt % WSTAGES) * WTILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WBK / 16; ++kk) {
      const uint64_t da = sw128_desc(as + kk * 16);
      const uint64_t db = B_KMAJOR ? sw128_desc(bs + kk * 16)
                                   : sw128_desc(bs + kk * 16 * 64, 64 * 64 * 2);
      wgmma_64x128_ss<B_KMAJOR ? 0 : 1>(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait();
  }

  // acc[4 j + e]: row g (+8 for e >= 2) of the warp's 16, column 8 j + 2 t
  // (+1 for odd e)
  const int row_a = r0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int r = row_a + ((e & 2) ? 8 : 0);
    const int col = c0 + (e / 4) * 8 + 2 * (lane % 4) + (e & 1);
    if (r < r1 && col < c1) c[(int64_t)r * N + col] = from_f32<Tout>(acc[e]);
  }
}

// --------------------------------------------------------------- skinny ----
constexpr int RT = 4, CT = 8;     // a warp's micro-tile: 32 outputs, one per lane
constexpr int KV = 4;             // consecutive k per lane per step
constexpr int WARP_K = 32 * KV;   // k per warp per step
constexpr int MAX_THREADS = 512;  // 16 warps: up to 128 registers a thread
static_assert(RT * CT == 32, "one output of a micro-tile per lane");

// 4 consecutive values of A's row from k on; vectorised where the plan says
// the rows are aligned and k + 3 is inside the range.
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ void unpack4(float4 v, float (&x)[KV]) {
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void unpack4(uint2 v, float (&x)[KV]) {
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  x[0] = __low2float(lo); x[1] = __high2float(lo);
  x[2] = __low2float(hi); x[3] = __high2float(hi);
}

// One step of a warp's reduce-scatter: of its first 2W partial sums a lane
// keeps the half picked by its bit W, adds its partner's (lane ^ W) copy of
// that half, and holds the result in its first W.
template <int W>
__device__ __forceinline__ void reduce_scatter(float* acc, int lane) {
  const bool upper = lane & W;
#pragma unroll
  for (int e = 0; e < W; ++e) {
    const float send = upper ? acc[e] : acc[e + W];
    const float keep = upper ? acc[e + W] : acc[e];
    acc[e] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(MAX_THREADS)
skinny_kernel(const Tin* __restrict__ a, const Tin* __restrict__ b,
              Tout* __restrict__ c, float* __restrict__ part, int M, int N,
              int K, int64_t sa0, int64_t sa1, int64_t sb0, int64_t sb1,
              int bm, int bn, int sub_n, int sc, int og_c, int kw,
              int ksplit, int vec) {
  __shared__ float red[MAX_THREADS];   // [kw][micro-tiles][32]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_og = blockDim.x / 32 / kw;           // micro-tiles per block
  const int og = warp % n_og, wk = warp / n_og;    // micro-tile, K slice

  // the block's tile of C: one bank row (<= 16 rows), an sc-column piece
  const int bank_n = blockIdx.x / sub_n;
  const int r0 = blockIdx.y * bm, r1 = min(r0 + bm, M);
  const int c0 = bank_n * bn + (blockIdx.x % sub_n) * sc;
  const int c1 = min(min(bank_n * bn + bn, N), c0 + sc);
  if (c0 >= c1) return;                            // whole block

  const int wr0 = r0 + (og / og_c) * RT, wc0 = c0 + (og % og_c) * CT;
  const int k_lo = blockIdx.z * ksplit, k_hi = min(K, k_lo + ksplit);

  PHASE_START();
  const Tin* arow[RT];
  bool rin[RT], cin[CT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    rin[i] = wr0 + i < r1;
    arow[i] = a + (rin[i] ? (int64_t)(wr0 + i) * sa0 : 0);
  }
#pragma unroll
  for (int j = 0; j < CT; ++j) cin[j] = wc0 + j < c1;

  float acc[RT * CT];
#pragma unroll
  for (int e = 0; e < RT * CT; ++e) acc[e] = 0.f;

#pragma unroll 2
  for (int kb = k_lo + wk * WARP_K; kb < k_hi; kb += kw * WARP_K) {
    const int k = kb + lane * KV;
    if (k >= k_hi) continue;
    float av[RT][KV], bv[KV][CT];
    const bool whole = k + KV <= k_hi;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      if (vec && whole) {
        if (rin[i])
          unpack4(__ldg(reinterpret_cast<const typename Vec4<Tin>::type*>(arow[i] + k)),
                  av[i]);
        else
#pragma unroll
          for (int u = 0; u < KV; ++u) av[i][u] = 0.f;
      } else {
#pragma unroll
        for (int u = 0; u < KV; ++u)
          av[i][u] = (rin[i] && k + u < k_hi) ? to_f32(arow[i][(k + u) * sa1]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < KV; ++u) {
      const Tin* brow = b + (int64_t)(k + u) * sb0 + (int64_t)wc0 * sb1;
#pragma unroll
      for (int j = 0; j < CT; ++j)
        bv[u][j] = (cin[j] && k + u < k_hi) ? to_f32(brow[j * sb1]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < KV; ++u)
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j)
          acc[i * CT + j] = fmaf(av[i][u], bv[u][j], acc[i * CT + j]);
  }

  PHASE(0);   // loads and FMAs over the thread's share of K

  // reduce-scatter over the warp: lane l ends with output l of the
  // micro-tile, summed in a fixed order
  reduce_scatter<16>(acc, lane);
  reduce_scatter<8>(acc, lane);
  reduce_scatter<4>(acc, lane);
  reduce_scatter<2>(acc, lane);
  reduce_scatter<1>(acc, lane);
  float total = acc[0];
  PHASE(1);

  if (kw > 1) {   // a tree over the K slices, in shared memory
    red[(wk * n_og + og) * 32 + lane] = total;
    __syncthreads();
    int half = 1;
    while (half < kw) half *= 2;
    for (half /= 2; half >= 1; half /= 2) {
      if (wk < half && wk + half < kw)
        red[(wk * n_og + og) * 32 + lane] += red[((wk + half) * n_og + og) * 32 + lane];
      __syncthreads();
    }
    total = red[og * 32 + lane];
  }
  PHASE(2);

  const int r = wr0 + lane / CT, col = wc0 + lane % CT;
  if (wk == 0 && r < r1 && col < c1) {
    if (part != nullptr)
      part[((int64_t)blockIdx.z * M + r) * N + col] = total;
    else
      c[(int64_t)r * N + col] = from_f32<Tout>(total);
  }
  PHASE(3);
  PHASE_END();
}

// the second pass of split-K: each output sums its splits in index order
template <typename Tout>
__global__ void splitk_sum_kernel(const float* __restrict__ part,
                                  Tout* __restrict__ c, int64_t mn, int splits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * mn + i];
  c[i] = from_f32<Tout>(s);
}

// The plan's fields, in the order kernels/banked_matmul.py::Plan.params
// writes them.
enum Param {
  P_M, P_N, P_K, P_SA0, P_SA1, P_SB0, P_SB1, P_BM, P_BN, P_SKINNY,
  P_GX, P_GY, P_GZ, P_THREADS, P_SUB_M, P_SUB_N, P_SC, P_OG_C, P_KW, P_KSPLIT,
  P_VEC, P_IN_BF16, P_OUT_BF16, P_TC, P_COUNT
};

// the tiled bf16 product on the tensor cores (P_TC: 1 with B a transposed
// view, 2 with B row-major)
template <typename Tout>
int launch_wgmma(const bf16* A, const bf16* B, Tout* C, const int64_t* p,
                 dim3 grid, cudaStream_t s) {
  const size_t smem = 1024 + sizeof(bf16) * 2 * WSTAGES * WTILE;
  const bool kmajor = p[P_TC] == 1;
  auto kern = kmajor ? tiled_wgmma_kernel<Tout, true> : tiled_wgmma_kernel<Tout, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, WTHREADS, smem, s>>>(A, B, C, (int)p[P_M], (int)p[P_N], (int)p[P_K],
                                    p[P_SA0], kmajor ? p[P_SB1] : p[P_SB0],
                                    (int)p[P_BM], (int)p[P_BN], (int)p[P_SUB_M],
                                    (int)p[P_SUB_N]);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Tout>
int launch(const void* a, const void* b, void* c, void* ws, const int64_t* p,
           cudaStream_t s) {
  const Tin* A = static_cast<const Tin*>(a);
  const Tin* B = static_cast<const Tin*>(b);
  Tout* C = static_cast<Tout*>(c);
  const dim3 grid(static_cast<unsigned>(p[P_GX]), static_cast<unsigned>(p[P_GY]),
                  static_cast<unsigned>(p[P_GZ]));
  const int M = (int)p[P_M], N = (int)p[P_N], K = (int)p[P_K];
  if constexpr (std::is_same<Tin, bf16>::value)
    if (!p[P_SKINNY] && p[P_TC]) return launch_wgmma<Tout>(A, B, C, p, grid, s);
  if (!p[P_SKINNY]) {
    tiled_kernel<Tin, Tout><<<grid, THREADS, 0, s>>>(
        A, B, C, M, N, K, p[P_SA0], p[P_SA1], p[P_SB0], p[P_SB1], (int)p[P_BM],
        (int)p[P_BN], (int)p[P_SUB_M], (int)p[P_SUB_N]);
    return static_cast<int>(cudaGetLastError());
  }
  const int splits = (int)p[P_GZ];
  float* part = splits > 1 ? static_cast<float*>(ws) : nullptr;
  skinny_kernel<Tin, Tout><<<grid, (unsigned)p[P_THREADS], 0, s>>>(
      A, B, C, part, M, N, K, p[P_SA0], p[P_SA1], p[P_SB0], p[P_SB1],
      (int)p[P_BM], (int)p[P_BN], (int)p[P_SUB_N], (int)p[P_SC],
      (int)p[P_OG_C], (int)p[P_KW], (int)p[P_KSPLIT], (int)p[P_VEC]);
  if (splits > 1) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t mn = (int64_t)M * N;
    splitk_sum_kernel<Tout><<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(
        part, C, mn, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the skinny kernel's cycles by phase: 0 loads and FMAs, 1 the warp's
// reduce-scatter, 2 the tree over K slices, 3 the store
PHASE_CLOCKS_EXPORT(banked_matmul_phase_cycles)

// a, b: f32 or bf16 with element strides; c: contiguous (M, N), f32 or
// bf16; ws: the split-K workspace (splits x M x N f32) or null; p: the
// wrapper's plan, P_COUNT int64 values (enum Param above).
extern "C" int banked_matmul(const void* a, const void* b, void* c, void* ws,
                             const int64_t* p, void* stream) {
  if (p[P_M] < 1 || p[P_N] < 1 || p[P_K] < 1 || p[P_BM] < 1 || p[P_BN] < 1 ||
      p[P_THREADS] < 32 || p[P_THREADS] > MAX_THREADS ||
      (p[P_SKINNY] && p[P_GZ] > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p[P_GY] > 65535 || p[P_GZ] > 65535 || p[P_GX] > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p[P_IN_BF16] && p[P_OUT_BF16])
    return launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, ws, p, s);
  if (p[P_IN_BF16]) return launch<__nv_bfloat16, float>(a, b, c, ws, p, s);
  if (p[P_OUT_BF16]) return launch<float, __nv_bfloat16>(a, b, c, ws, p, s);
  return launch<float, float>(a, b, c, ws, p, s);
}
