// Per-phase cycle counts of a kernel, read with clock64(): compiled in only
// when the library is built with -DPHASE_CLOCKS (scripts/torch_phase_clocks.py
// sets REPRO_TORCH_CUDA_DEFINES=PHASE_CLOCKS for that); otherwise the marks
// are empty and the kernels are the ones the port runs.
//
// In a kernel: PHASE_START() once, PHASE(i) at the end of each phase i (the
// cycles since the previous mark go to phase i), PHASE_END() where the warp
// ends.  Lane 0 of every warp adds its warp's cycles to phase_cycles[i]
// (integer atomics, in the instrumented build only).  The export below copies
// the sums out and zeroes them.
#pragma once
#include <cuda_runtime.h>

constexpr int N_PHASES = 8;

#ifdef PHASE_CLOCKS
__device__ unsigned long long phase_cycles[N_PHASES];
#define PHASE_START()               \
  long long phase_t_ = clock64();   \
  unsigned long long phase_acc_[N_PHASES] = {}
#define PHASE(i)                             \
  do {                                       \
    const long long phase_n_ = clock64();    \
    phase_acc_[i] += phase_n_ - phase_t_;    \
    phase_t_ = phase_n_;                     \
  } while (0)
#define PHASE_END()                                          \
  do {                                                       \
    if (threadIdx.x % 32 == 0)                               \
      for (int phase_i_ = 0; phase_i_ < N_PHASES; ++phase_i_) \
        atomicAdd(&phase_cycles[phase_i_], phase_acc_[phase_i_]); \
  } while (0)
#else
#define PHASE_START() do {} while (0)
#define PHASE(i) do {} while (0)
#define PHASE_END() do {} while (0)
#endif

// extern "C" int fn(unsigned long long* out): the N_PHASES sums since the
// last call into out (host memory), then zero them; cudaErrorNotSupported in
// a build without the marks.
#ifdef PHASE_CLOCKS
#define PHASE_CLOCKS_EXPORT(fn)                                              \
  extern "C" int fn(unsigned long long* out) {                               \
    cudaError_t err = cudaMemcpyFromSymbol(out, phase_cycles,                \
                                           sizeof(unsigned long long) * N_PHASES); \
    if (err != cudaSuccess) return static_cast<int>(err);                    \
    const unsigned long long zero[N_PHASES] = {};                            \
    return static_cast<int>(cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero))); \
  }
#else
#define PHASE_CLOCKS_EXPORT(fn)                     \
  extern "C" int fn(unsigned long long*) {          \
    return static_cast<int>(cudaErrorNotSupported); \
  }
#endif
