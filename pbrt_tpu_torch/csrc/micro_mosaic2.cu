// micro_mosaic2 — per-iteration cost against body size, with and without
// a data-dependent branch, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel scripts/micro/micro_mosaic2.py::kern.
// Same contract: x (8,128) plus the program's index, a table (2048,128);
// n_it iterations, each loading table row c and applying body_reps rounds
// of (x * row + 1, min(x, row * x + 0.5), max(x - row, 0.3 x)) to x;
// `nocond` adds the result to acc every iteration, `cond` only when
// max(row) + max(acc) > -1 (a whole-block reduction deciding a branch).
// Every program stores into the same output block on the TPU, so the last
// program's acc is the answer; each CUDA block stores its own slot of
// `out` (grid, 8, 128) and the wrapper returns the last.
//
// Design: one block of 1024 threads per program, one element each; the
// mode and body_reps are template parameters (the probe's runs: nocond at
// body_reps 12, cond at 1, 4, 12, 36), so each instance has a straight
// body as the probe's Mosaic kernel has. The two maxes share one shuffle
// round and one __syncthreads. min and max propagate NaN, as
// jnp.minimum/maximum and torch.minimum/maximum do, should a chain
// overflow (none does on the probe's inputs).
// Built with --fmad=false; bit-equal with the plain version
// (pbrt_tpu_torch/micro/micro_mosaic2.py::micro_mosaic2_ref).
//
// What bounds it: 8 dependent operations per element and round, plus the
// accumulate: at n_it 1024, body_reps 12 and grid 256, 26 G operations,
// 0.78 ms at the FP32 rate. The table (1 MB) is read once from memory
// and then from cache. Measured on an H100 80GB HBM3 (700 W limit,
// chip_smoke.py phase m1) at n_it 1024: nocond 1.52 ms at body_reps 12;
// cond 4.01, 4.35, 5.28, 7.99 at 1, 4, 12, 36: ~3.9 ms for the two
// maxes and their two barriers, ~0.11 ms for each round of the body.

#include <cuda_runtime.h>

namespace {

constexpr int kElems = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

template <int kReps>
__device__ __forceinline__ float mt_like(float x, float row) {
#pragma unroll
  for (int r = 0; r < kReps; ++r) {
    x = x * row + 1.0f;
    x = min_nan(x, row * x + 0.5f);
    x = max_nan(x - row, x * 0.3f);
  }
  return x;
}

template <bool kCond, int kReps>
__global__ void __launch_bounds__(kElems)
mosaic2_kernel(const float* __restrict__ x, const float* __restrict__ tab,
               int n_it, float* __restrict__ out) {
  __shared__ float red[2][32];
  const int t = threadIdx.x;
  const float xv = x[t] + static_cast<float>(blockIdx.x);
  float acc = xv * 0.0f;
  for (int c = 0; c < n_it; ++c) {
    const float row = tab[c * 128 + (t & 127)];
    if (!kCond) {
      acc = acc + mt_like<kReps>(xv, row);
      continue;
    }
    float mr = row, ma = acc;
    for (int h = 16; h >= 1; h >>= 1) {
      mr = max_nan(mr, __shfl_xor_sync(kFull, mr, h));
      ma = max_nan(ma, __shfl_xor_sync(kFull, ma, h));
    }
    if ((t & 31) == 0) {
      red[0][t >> 5] = mr;
      red[1][t >> 5] = ma;
    }
    __syncthreads();
    mr = red[0][0];
    ma = red[1][0];
    for (int w = 1; w < kElems / 32; ++w) {
      mr = max_nan(mr, red[0][w]);
      ma = max_nan(ma, red[1][w]);
    }
    __syncthreads();
    if (mr + ma > -1.0f) acc = acc + mt_like<kReps>(xv, row);
  }
  out[blockIdx.x * kElems + t] = acc;
}

template <bool kCond, int kReps>
int launch(const float* x, const float* tab, int n_it, int grid, float* out,
           cudaStream_t stream) {
  mosaic2_kernel<kCond, kReps><<<grid, kElems, 0, stream>>>(x, tab, n_it,
                                                            out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MOSAIC2_ENTRY(mode, cond, reps)                                     \
  extern "C" int micro_mosaic2_##mode##_r##reps(                            \
      const float* x, const float* tab, int n_it, int grid, float* out,    \
      cudaStream_t stream) {                                                \
    return launch<cond, reps>(x, tab, n_it, grid, out, stream);             \
  }

MOSAIC2_ENTRY(nocond, false, 12)
MOSAIC2_ENTRY(cond, true, 1)
MOSAIC2_ENTRY(cond, true, 4)
MOSAIC2_ENTRY(cond, true, 12)
MOSAIC2_ENTRY(cond, true, 36)

extern "C" const char* micro_mosaic2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
