// micro_dyn — the cost of one dynamic index inside a loop, for Hopper
// (sm_90a).
//
// Replaces the TPU Pallas kernel scripts/micro/micro_dyn.py::kern. Same
// contract: a table (1024,128); n_it iterations, each with the dynamic
// row j = (7 i + program) % 900 and one primitive (the mode); the output
// is the sum of the final acc. acc starts at the program's index, as a
// (1,128) row, or (8,128) for reshape18 and mt35. The modes:
//   staticload   acc + tab[0] * i          dynload    acc + tab[j]
//   dynload8     acc + (tab[j] + ... + tab[j+7])
//   dynstore     scr[j] = acc; acc + 1     (scr: this block's slab of a
//                                          (grid,1024,128) global buffer)
//   smemread     acc + sm[j]               smemwrite  sm[j] = i; acc + 1
//                (sm: 1024 ints of shared memory, the TPU's scalar memory)
//   reshape18    acc + tab[j, 0:8] as a column, broadcast over 128 lanes
//   matmul_small acc + acc @ tab[0:128]    (a (1,128) @ (128,128) product)
//   mt35         11 rounds of the min/max/multiply-add chain with row j
// Every program stores into the same output block on the TPU, so the last
// program's sum is the answer; each CUDA block stores its own slot of
// `out` (grid,) and the wrapper returns the last.
//
// sm is zeroed when a block starts: the probe reads it before any write
// (smemread), so its answer is undefined, and this one is
// 128 * (grid - 1). Neither sm nor scr is ever read back after a store,
// so both are written through volatile pointers: without them nvcc drops
// the stores and dynstore / smemwrite would time an empty loop. Their
// SASS keeps the stores: dynstore has more STG than dynload, smemwrite
// more STS than smemread (cuobjdump -sass; chip_smoke.py phase m1 checks
// it at every run).
//
// Design: one block per program, 128 threads for a (1,128) acc and 1024
// for an (8,128), one element each; the mode is a template parameter.
// matmul_small computes its product in the kernel: each thread takes one
// output column, forms the 128 products from acc (broadcast through
// shared memory) and tab (read from cache), and sums them by the halving
// tree; the final sum follows the same tree (micro/__init__.py::tree_sum).
// min and max propagate NaN; matmul_small's acc overflows to inf and NaN
// at the probe's size. Built with --fmad=false; bit-equal with the plain
// version (pbrt_tpu_torch/micro/micro_dyn.py::micro_dyn_ref).
//
// What bounds it: a loop-carried chain of one load and one add per
// iteration (mt35: 33 dependent operations; matmul_small: a product of
// 32 K operations). The table is 512 KB, read from cache after the first
// touch; the work of every mode is far below the card's rates, so its
// time is the chain's latency, 2048 iterations deep. Measured on an H100
// 80GB HBM3 (700 W limit, chip_smoke.py phase m1): 0.046-0.25 ms for the
// load, store and scalar modes, mt35 1.56, matmul_small 5.02 (its 128
// products live in a 512-byte local array: 165 registers).

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

enum Mode {
  kStaticLoad = 0,
  kDynLoad,
  kDynLoad8,
  kDynStore,
  kSmemRead,
  kSmemWrite,
  kReshape18,
  kMatmulSmall,
  kMt35,
};

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// Sum of v over the block by the halving tree; the result in thread 0.
template <int kThreads>
__device__ float block_tree_sum(float v, float* buf) {
  const int t = threadIdx.x;
  buf[t] = v;
  __syncthreads();
  for (int h = kThreads / 2; h >= 32; h >>= 1) {
    if (t < h) buf[t] = buf[t] + buf[t + h];
    __syncthreads();
  }
  float s = 0.0f;
  if (t < 32) {
    s = buf[t];
    for (int h = 16; h >= 1; h >>= 1) s = s + __shfl_down_sync(kFull, s, h);
  }
  return s;
}

template <int kMode, int kRows>
__global__ void __launch_bounds__(128 * kRows)
dyn_kernel(const float* __restrict__ tab, int n_it, float* __restrict__ out,
           float* scr) {
  constexpr int kThreads = 128 * kRows;
  __shared__ volatile int sm[1024];
  __shared__ float buf[kThreads];
  const int t = threadIdx.x;
  const int l = t & 127;
  const int r = t >> 7;
  const int base = blockIdx.x;
  volatile float* slab = kMode == kDynStore
      ? scr + static_cast<size_t>(blockIdx.x) * 1024 * 128 : nullptr;
  for (int k = t; k < 1024; k += kThreads) sm[k] = 0;
  __syncthreads();
  float acc = static_cast<float>(base);
  for (int i = 0; i < n_it; ++i) {
    const int j = (i * 7 + base) % 900;
    if (kMode == kStaticLoad) {
      acc = acc + tab[l] * static_cast<float>(i);
    } else if (kMode == kDynLoad) {
      acc = acc + tab[j * 128 + l];
    } else if (kMode == kDynLoad8) {
      float row = tab[j * 128 + l];
#pragma unroll
      for (int k = 0; k < 7; ++k) row = row + tab[(j + k + 1) * 128 + l];
      acc = acc + row;
    } else if (kMode == kDynStore) {
      slab[j * 128 + l] = acc;
      acc = acc + 1.0f;
    } else if (kMode == kSmemRead) {
      acc = acc + static_cast<float>(sm[j]);
    } else if (kMode == kSmemWrite) {
      if (t == 0) sm[j] = i;
      acc = acc + 1.0f;
    } else if (kMode == kReshape18) {
      acc = acc + tab[j * 128 + r];
    } else if (kMode == kMatmulSmall) {
      buf[l] = acc;
      __syncthreads();
      float p[128];
#pragma unroll
      for (int k = 0; k < 128; ++k) p[k] = buf[k] * tab[k * 128 + l];
#pragma unroll
      for (int h = 64; h >= 1; h >>= 1) {
#pragma unroll
        for (int k = 0; k < h; ++k) p[k] = p[k] + p[k + h];
      }
      __syncthreads();
      acc = acc + p[0];
    } else {  // kMt35
      const float row = tab[j * 128 + l];
      float x = acc;
#pragma unroll
      for (int k = 0; k < 11; ++k) {
        x = x * row + 1.0f;
        x = min_nan(x, row * x + 0.5f);
        x = max_nan(x - row, x * 0.3f);
      }
      acc = x;
    }
  }
  const float s = block_tree_sum<kThreads>(acc, buf);
  if (t == 0) out[blockIdx.x] = s;
}

template <int kMode, int kRows>
int launch(const float* tab, int n_it, int grid, float* out, float* scr,
           cudaStream_t stream) {
  dyn_kernel<kMode, kRows><<<grid, 128 * kRows, 0, stream>>>(tab, n_it, out,
                                                             scr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define DYN_ENTRY(name, mode, rows)                                         \
  extern "C" int micro_dyn_##name(const float* tab, int n_it, int grid,    \
                                  float* out, float* scr,                  \
                                  cudaStream_t stream) {                   \
    return launch<mode, rows>(tab, n_it, grid, out, scr, stream);          \
  }

DYN_ENTRY(staticload, kStaticLoad, 1)
DYN_ENTRY(dynload, kDynLoad, 1)
DYN_ENTRY(dynload8, kDynLoad8, 1)
DYN_ENTRY(dynstore, kDynStore, 1)
DYN_ENTRY(smemread, kSmemRead, 1)
DYN_ENTRY(smemwrite, kSmemWrite, 1)
DYN_ENTRY(reshape18, kReshape18, 8)
DYN_ENTRY(matmul_small, kMatmulSmall, 1)
DYN_ENTRY(mt35, kMt35, 8)

extern "C" const char* micro_dyn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
