// micro_entry — K1's entry body in isolation, with ablations, for Hopper
// (sm_90a).
//
// Replaces the TPU Pallas kernel scripts/micro/micro_entry.py::kern. Same
// contract: a triangle table (1024,128), read as 13 rows of 128 lanes
// (v0, e1, e2, pid, three normal components); n_ent entries per program.
// Entry j takes rows c = (7 j) % 900 .. c + 12 and ray group
// g = (13 j) % 128 of a (128,8,8) ray scratch, runs Moller-Trumbore on
// the (8 rays, 128 triangles) pairs against the group's best t in a
// (128,8,16) accumulator scratch, reduces to each ray's nearest hit, and
// stores 9 columns (t, pid, u, v, and five selected normal components)
// back. The program's rays are (0.5 + program) * (1..6); its accumulator
// starts at t = 1e30. The output (8,1) is the loop's acc plus group 0's
// t column. The modes cut the body short: loads_only (the row loads and
// two lane sums), blocks_only (the ray block and an 8-ray sum), mt_only
// (through the nearest t), no_write (everything but the store), full, and
// while (full under a loop whose bound is re-read every iteration, as a
// while_loop's condition is). Every program stores into the same output
// block on the TPU, so the last program's is the answer; each CUDA block
// stores its own slot of `out` (grid,8) and the wrapper returns the last
// (and, on request, the last block's accumulator scratch and its loop's
// own acc, before group 0's t is added: in the four modes that never
// write the accumulator, the output is that t, 1e30, plus acc, which
// keeps none of acc's bits).
//
// Design: one block of 1024 threads per program, one (ray, triangle)
// pair each: thread t is ray t / 128, lane t % 128, so a ray's 128 lanes
// are four whole warps. The ray and accumulator scratches live in
// shared memory (96 KB, as dynamic shared memory). Per-ray reductions:
// min and max by warp shuffles and one shared slot per warp; the lane
// sums by the halving tree of the plain version (shared-memory stages
// for strides 64 and 32, shuffles for 16..1), so the sums are
// bit-equal with it even when more than one lane is selected. Lane 0 of
// each ray keeps the ray's acc and writes its accumulator row. Under
// no_write the selected columns are passed to an empty asm statement,
// so nvcc keeps computing them although nothing stores them. min and max
// propagate NaN as jnp.min/max and torch.amin/amax do. Built with
// --fmad=false, bit-equal with the plain version
// (pbrt_tpu_torch/micro/micro_entry.py::micro_entry_ref).
//
// What bounds it: full does about 72 FP32 operations per (ray, triangle)
// pair (53 for the test, the rest the nearest-hit selection): 9.4 G
// operations at the probe's size, 0.28 ms at the card's FP32 rate. It
// runs 64 blocks, one per SM, on a card of 132 SMs, and five block
// barriers per entry; its time is the entry's latency, 2000 deep.
// Measured on an H100 80GB HBM3 (700 W limit, chip_smoke.py phase m1):
// full 4.66 ms, while 4.75, no_write 4.50, mt_only 1.83, loads_only
// 1.07, blocks_only 0.41.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // 8 rays x 128 triangle lanes
constexpr int kGroups = 128;
constexpr int kRayCols = 8;
constexpr int kAccCols = 16;
constexpr int kSums = 7;
constexpr float kEps = 1e-12f;
constexpr float kNoHit = 3e38f;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kLoadsOnly = 0, kBlocksOnly, kMtOnly, kNoWrite, kFullMode,
            kWhile };

struct Smem {
  float ray[kGroups * 8 * kRayCols];   // rayT3 (128, 8, 8)
  float acc[kGroups * 8 * kAccCols];   // accT3 (128, 8, 16)
  float sums[kSums][kThreads];         // the lane sums' tree stages
  float red[2][8][4];                  // per-ray warp partials: min, max
  float blk8[8];                       // blocks_only's per-ray products
  int n_lim;                           // while's bound
};

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// Min (kMax false) or max of v over the 128 lanes of ray r, in every
// thread of the ray.
template <bool kMax>
__device__ __forceinline__ float ray_extreme(float v, float (*red)[4],
                                             int r) {
  for (int h = 16; h >= 1; h >>= 1) {
    const float o = __shfl_xor_sync(kFull, v, h);
    v = kMax ? max_nan(v, o) : min_nan(v, o);
  }
  const int l = threadIdx.x & 127;
  if ((l & 31) == 0) red[r][l >> 5] = v;
  __syncthreads();
  return kMax ? max_nan(max_nan(red[r][0], red[r][1]),
                        max_nan(red[r][2], red[r][3]))
              : min_nan(min_nan(red[r][0], red[r][1]),
                        min_nan(red[r][2], red[r][3]));
}

// Sums of vals[0..n) over the 128 lanes of each ray by the halving tree;
// the results are valid in lane 0 of each ray.
template <int n>
__device__ __forceinline__ void ray_tree_sums(float* vals,
                                              float (*sums)[kThreads]) {
  const int t = threadIdx.x;
  const int l = t & 127;
#pragma unroll
  for (int q = 0; q < n; ++q) sums[q][t] = vals[q];
  __syncthreads();
  if (l < 64) {
#pragma unroll
    for (int q = 0; q < n; ++q) sums[q][t] = sums[q][t] + sums[q][t + 64];
  }
  __syncthreads();
  if (l < 32) {  // four whole warps, one per ray
#pragma unroll
    for (int q = 0; q < n; ++q) {
      float s = sums[q][t] + sums[q][t + 32];
      for (int h = 16; h >= 1; h >>= 1) s = s + __shfl_down_sync(kFull, s, h);
      vals[q] = s;
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
entry_kernel(const float* __restrict__ tri, int n_ent,
             float* __restrict__ out, float* __restrict__ scratch_out,
             float* __restrict__ acc_out) {
  extern __shared__ float smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int t = threadIdx.x;
  const int r = t >> 7;
  const int l = t & 127;
  const float base = 0.5f + static_cast<float>(blockIdx.x);
  for (int k = t; k < kGroups * 8 * kRayCols; k += kThreads) {
    const int c = k & (kRayCols - 1);
    s.ray[k] = c < 6 ? base * (static_cast<float>(c) + 1.0f) : 0.0f;
  }
  for (int k = t; k < kGroups * 8 * kAccCols; k += kThreads) {
    s.acc[k] = (k & (kAccCols - 1)) == 0 ? 1e30f : 0.0f;
  }
  if (t == 0) s.n_lim = n_ent;
  __syncthreads();

  float acc = 0.0f;  // the ray's acc, kept in lane 0
  auto body = [&](int j) {
    const int g = (j * 13) % kGroups;
    const int c = (j * 7) % 900;
    const float* row = tri + c * 128 + l;
    const float v0x = row[0], v0y = row[128], v0z = row[256];
    const float e1x = row[384], e1y = row[512], e1z = row[640];
    const float e2x = row[768], e2y = row[896], e2z = row[1024];
    const float pid = row[1152];
    const float anx = row[1280], any_ = row[1408], anz = row[1536];
    if (kMode == kLoadsOnly) {
      float v[2] = {v0x, pid};
      ray_tree_sums<2>(v, s.sums);
      if (l == 0) acc = acc + v[0] + v[1];
      return;
    }
    const float* rb = s.ray + (g * 8 + r) * kRayCols;
    const float ox = rb[0], oy = rb[1], oz = rb[2];
    const float dx = rb[3], dy = rb[4], dz = rb[5];
    if (kMode == kBlocksOnly) {
      if (l == 0) s.blk8[r] = ox * dz;
      __syncthreads();
      if (l == 0) {
        const float* p = s.blk8;
        acc = acc + (((p[0] + p[4]) + (p[2] + p[6])) +
                     ((p[1] + p[5]) + (p[3] + p[7])));
      }
      return;
    }
    float* ab = s.acc + (g * 8 + r) * kAccCols;
    const float tb = ab[0];
    const float px = dy * e2z - dz * e2y;
    const float py = dz * e2x - dx * e2z;
    const float pz = dx * e2y - dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool ok = fabsf(det) > kEps;
    const float inv_det = ok ? 1.0f / det : 0.0f;
    const float tvx = ox - v0x;
    const float tvy = oy - v0y;
    const float tvz = oz - v0z;
    const float uk = (tvx * px + tvy * py + tvz * pz) * inv_det;
    const float qx = tvy * e1z - tvz * e1y;
    const float qy = tvz * e1x - tvx * e1z;
    const float qz = tvx * e1y - tvy * e1x;
    const float vk = (dx * qx + dy * qy + dz * qz) * inv_det;
    const float tk = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    const bool hit = ok && uk >= 0.0f && vk >= 0.0f && uk + vk <= 1.0f &&
                     tk > 0.0f && tk < tb;
    const float tkh = hit ? tk : kNoHit;
    const float tmin = ray_extreme<false>(tkh, s.red[0], r);
    if (kMode == kMtOnly) {
      if (l == 0) acc = acc + tmin;
      return;
    }
    const bool eq = hit && tkh == tmin;
    const float pid_sel = ray_extreme<true>(eq ? pid : 0.0f, s.red[1], r);
    const bool eq1 = eq && pid == pid_sel;
    float sel[kSums] = {eq1 ? uk : 0.0f,  eq1 ? vk : 0.0f,
                        eq1 ? anx : 0.0f, eq1 ? any_ : 0.0f,
                        eq1 ? anz : 0.0f, eq1 ? anx : 0.0f,
                        eq1 ? any_ : 0.0f};
    ray_tree_sums<kSums>(sel, s.sums);
    if (l == 0) {
      const bool better = tmin < tb;
      float cols[2 + kSums];
      cols[0] = better ? tmin : tb;
      cols[1] = better ? pid_sel : ab[1];
#pragma unroll
      for (int q = 0; q < kSums; ++q) {
        cols[2 + q] = better ? sel[q] : ab[2 + q];
      }
      if (kMode == kNoWrite) {
#pragma unroll
        for (int q = 1; q < 2 + kSums; ++q) asm volatile("" ::"f"(cols[q]));
        acc = acc + cols[0] * 0.0f + tmin;
      } else {
#pragma unroll
        for (int q = 0; q < 2 + kSums; ++q) ab[q] = cols[q];
      }
    }
  };

  if (kMode == kWhile) {
    int j = 0;
    while (j < *static_cast<volatile int*>(&s.n_lim)) {
      body(j);
      __syncthreads();
      ++j;
    }
  } else {
    for (int j = 0; j < n_ent; ++j) {
      body(j);
      __syncthreads();
    }
  }
  if (l == 0) out[blockIdx.x * 8 + r] = acc + s.acc[r * kAccCols];
  if (acc_out != nullptr && blockIdx.x == gridDim.x - 1 && l == 0) {
    acc_out[r] = acc;
  }
  if (scratch_out != nullptr && blockIdx.x == gridDim.x - 1) {
    for (int k = t; k < kGroups * 8 * kAccCols; k += kThreads) {
      scratch_out[k] = s.acc[k];
    }
  }
}

template <int kMode>
int launch(const float* tri, int n_ent, int grid, float* out,
           float* scratch_out, float* acc_out, cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      entry_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  entry_kernel<kMode><<<grid, kThreads, bytes, stream>>>(
      tri, n_ent, out, scratch_out, acc_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ENTRY_ENTRY(name, mode)                                             \
  extern "C" int micro_entry_##name(const float* tri, int n_ent, int grid, \
                                    float* out, float* scratch_out,        \
                                    float* acc_out, cudaStream_t stream) { \
    return launch<mode>(tri, n_ent, grid, out, scratch_out, acc_out,       \
                        stream);                                           \
  }

ENTRY_ENTRY(loads_only, kLoadsOnly)
ENTRY_ENTRY(blocks_only, kBlocksOnly)
ENTRY_ENTRY(mt_only, kMtOnly)
ENTRY_ENTRY(no_write, kNoWrite)
ENTRY_ENTRY(full, kFullMode)
ENTRY_ENTRY(while, kWhile)

extern "C" const char* micro_entry_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
