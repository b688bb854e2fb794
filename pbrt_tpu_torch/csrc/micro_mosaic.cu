// micro_mosaic — loop overhead and a dense vector body, for Hopper
// (sm_90a).
//
// Replaces the two TPU Pallas kernels of scripts/micro/micro_mosaic.py:
//   loop_kernel (loop_<mode>): 1000 iterations on one (8,128) block of
//     `empty` (acc + 1), `reduce` (a whole-block max, then acc + 1 or
//     0.5) or `cond` (the same max deciding a branch that adds sum(x); it
//     is never taken on the probe's input);
//   dense_kernel (dense): 256 bodies of a fake Moller-Trumbore chain of
//     min, multiply, add, compare and select on (8,128).
// The probe's loops run a float index (fori_loop(0., float(n), ...)), so
// the loops here do too. Every program of the probe computes the same
// block; each CUDA block stores its own slot of `out` (grid, 8, 128) and
// the wrapper returns the last.
//
// Design: one block of 1024 threads per program, one element each. The
// whole-block max is a warp shuffle max, one shared slot per warp, a
// __syncthreads, and every thread folding the 32 slots; it propagates a
// NaN as jnp.max and torch.amax do. sum(x) follows the plain version's
// halving tree (micro/__init__.py::tree_sum): shared-memory stages for
// the strides 512..32, shuffles for 16..1. Built with --fmad=false, so
// each operation rounds once, as in the plain version
// (pbrt_tpu_torch/micro/micro_mosaic.py): the two are bit-equal.
//
// What bounds it: the loop kernel does 1 to 4 operations per element and
// iteration and moves 8 KB, so neither rate binds; its time is the
// loop's latency (a dependent add, and in reduce/cond two barriers per
// iteration). The dense kernel is 47 dependent operations per element
// and body, 12.6 G operations at the probe's size: 0.38 ms at the FP32
// rate, if the SMs' warps hide the chain's latency. Measured on an H100
// 80GB HBM3 (700 W limit, chip_smoke.py phase m1): loop empty 0.158 ms,
// reduce 7.68, cond 7.67 (the two barriers per iteration); dense 0.532.

#include <cuda_runtime.h>

namespace {

constexpr int kElems = 1024;  // one (8,128) block, one element a thread
constexpr unsigned kFull = 0xffffffffu;

enum LoopMode { kEmpty = 0, kReduce = 1, kCond = 2 };

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// Max of v over the block, in every thread. red holds 32 floats.
__device__ float block_max(float v, float* red) {
  for (int h = 16; h >= 1; h >>= 1) {
    v = max_nan(v, __shfl_xor_sync(kFull, v, h));
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < kElems / 32; ++w) m = max_nan(m, red[w]);
  __syncthreads();
  return m;
}

// Sum of v over the block by the halving tree, in every thread. buf holds
// kElems floats.
__device__ float block_tree_sum(float v, float* buf) {
  const int t = threadIdx.x;
  buf[t] = v;
  __syncthreads();
  for (int h = kElems / 2; h >= 32; h >>= 1) {
    if (t < h) buf[t] = buf[t] + buf[t + h];
    __syncthreads();
  }
  if (t < 32) {
    float s = buf[t];
    for (int h = 16; h >= 1; h >>= 1) s = s + __shfl_down_sync(kFull, s, h);
    if (t == 0) buf[0] = s;
  }
  __syncthreads();
  const float s = buf[0];
  __syncthreads();
  return s;
}

template <int kMode>
__global__ void __launch_bounds__(kElems)
loop_kernel(const float* __restrict__ x, float n_it, float* __restrict__ out) {
  __shared__ float red[32];
  __shared__ float buf[kElems];
  const int t = threadIdx.x;
  const float xv = x[t];
  float acc = 0.0f;
  for (float i = 0.0f; i < n_it; i = i + 1.0f) {
    if (kMode == kEmpty) {
      acc = acc + 1.0f;
      continue;
    }
    const float v = xv * (1.0f + i) + acc;
    const bool m = block_max(v, red) > 1e30f;
    if (kMode == kReduce) {
      acc = acc + (m ? 1.0f : 0.5f);
    } else if (m) {  // the same in every thread: the branch is uniform
      acc = acc + block_tree_sum(xv, buf);
    }
  }
  out[blockIdx.x * kElems + t] = acc;
}

__global__ void __launch_bounds__(kElems)
dense_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float n_it, float* __restrict__ out) {
  const int t = threadIdx.x;
  const float av = a[t], bv = b[t];
  float acc = 0.0f;
  for (float i = 0.0f; i < n_it; i = i + 1.0f) {
    float x = av * (i + 1.0f);
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      x = x * bv + av;
      x = min_nan(x * 1.0001f, bv + x);
      const float y = x * x - bv;
      x = (y > 0.0f) ? x : y;
    }
    acc = acc + x;
  }
  out[blockIdx.x * kElems + t] = acc;
}

template <int kMode>
int launch_loop(const float* x, float n_it, int grid, float* out,
                cudaStream_t stream) {
  loop_kernel<kMode><<<grid, kElems, 0, stream>>>(x, n_it, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int micro_mosaic_loop_empty(const float* x, float n_it, int grid, float* out,
                            cudaStream_t stream) {
  return launch_loop<kEmpty>(x, n_it, grid, out, stream);
}

int micro_mosaic_loop_reduce(const float* x, float n_it, int grid,
                             float* out, cudaStream_t stream) {
  return launch_loop<kReduce>(x, n_it, grid, out, stream);
}

int micro_mosaic_loop_cond(const float* x, float n_it, int grid, float* out,
                           cudaStream_t stream) {
  return launch_loop<kCond>(x, n_it, grid, out, stream);
}

int micro_mosaic_dense(const float* a, const float* b, float n_it, int grid,
                       float* out, cudaStream_t stream) {
  dense_kernel<<<grid, kElems, 0, stream>>>(a, b, n_it, out);
  return static_cast<int>(cudaGetLastError());
}

const char* micro_mosaic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
