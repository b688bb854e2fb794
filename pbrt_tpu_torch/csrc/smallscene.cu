// K1 — brute-force small-scene ray/triangle intersection for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel pbrt_tpu/ops/smallscene.py::_kernel. Same
// contract: N rays against a table of T <= 1024 triangles, Moller-Trumbore
// with the hit rule |det| > 1e-12, u >= 0, v >= 0, u + v <= 1,
// 0 < t < t_best; the running best updates on strict '<', so the earliest
// table row wins a tie. Any-hit mode stops at the first hit in table order,
// which is the row the Pallas kernel reports (it collapses t_best to 0 on
// a hit, so no later row can pass the gate).
//
// Table layout (the reference's, so converted scenes are bit-equal): one
// row of 16 floats per triangle, v0 | e1 | e2 | unit normal | pid+1 |
// mat+1 | light+1 | pad. Outputs are int32 ids, not float planes.
//
// What bounds it: a ray reads 28 B and a hit writes 36 B, about 64 B per
// ray; the triangle walk is ~40 flops per (ray, triangle). At Cornell's
// T = 38 that is ~1.5 kflop per 64 B, far above the card's flop/byte
// balance, so the kernel is compute-bound; it is a small share of a
// forward pass next to the integrator's eager elementwise tensor ops.
// Measured on an H100 80GB HBM3 (700 W limit): 0.40 ms per closest-hit
// call on 4,194,304 rays, 1.5% of an 8-lane Cornell forward pass.
//
// Design: one thread per ray. Each block stages the whole table in shared
// memory (T * 64 B, 64 KB at T = 1024, dynamic shared memory above 48 KB);
// every thread of a warp then reads the same triangle word, which shared
// memory broadcasts. Only the best row index and its t, u, v ride in
// registers; the hit row's normal and ids are read once after the walk.
//
// Numerics: built with --fmad=false and IEEE division, so every operation
// rounds once, in the same order as the Pallas body and the plain PyTorch
// twin (pbrt_tpu_torch/ops/smallscene.py::smallscene_intersect_ref); the
// kernel is bit-comparable with the twin.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 16;
constexpr int kThreads = 256;
constexpr float kDetEps = 1e-12f;

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
smallscene_kernel(const float* __restrict__ table, int n_tris,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ tmax, long long n,
                  float* __restrict__ t_out, int* __restrict__ prim_out,
                  float* __restrict__ u_out, float* __restrict__ v_out,
                  float* __restrict__ n_out, int* __restrict__ mat_out,
                  int* __restrict__ light_out) {
  extern __shared__ float tab[];
  for (int i = threadIdx.x; i < n_tris * kCols; i += blockDim.x) {
    tab[i] = table[i];
  }
  __syncthreads();

  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (r >= n) return;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  float tb = tmax[r];
  float ub = 0.0f, vb = 0.0f;
  int best = -1;

  for (int c = 0; c < n_tris; ++c) {
    const float* row = tab + c * kCols;
    const float v0x = row[0], v0y = row[1], v0z = row[2];
    const float e1x = row[3], e1y = row[4], e1z = row[5];
    const float e2x = row[6], e2y = row[7], e2z = row[8];
    const float px = dy * e2z - dz * e2y;
    const float py = dz * e2x - dx * e2z;
    const float pz = dx * e2y - dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool ok = fabsf(det) > kDetEps;
    const float inv_det = ok ? 1.0f / det : 0.0f;
    const float tvx = ox - v0x;
    const float tvy = oy - v0y;
    const float tvz = oz - v0z;
    const float u = (tvx * px + tvy * py + tvz * pz) * inv_det;
    const float qx = tvy * e1z - tvz * e1y;
    const float qy = tvz * e1x - tvx * e1z;
    const float qz = tvx * e1y - tvy * e1x;
    const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
    const float tk = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    const bool hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                     tk > 0.0f && tk < tb;
    if (hit) {
      best = c;
      if (kAnyHit) break;
      tb = tk;
      ub = u;
      vb = v;
    }
  }

  const bool found = best >= 0;
  const float* row = tab + (found ? best : 0) * kCols;
  prim_out[r] = found ? static_cast<int>(row[12]) - 1 : -1;
  if (kAnyHit) {
    t_out[r] = found ? 0.0f : __int_as_float(0x7f800000);
    return;
  }
  t_out[r] = found ? tb : __int_as_float(0x7f800000);
  u_out[r] = ub;
  v_out[r] = vb;
  n_out[3 * r] = found ? row[9] : 0.0f;
  n_out[3 * r + 1] = found ? row[10] : 0.0f;
  n_out[3 * r + 2] = found ? row[11] : 0.0f;
  mat_out[r] = found ? static_cast<int>(row[13]) - 1 : 0;
  light_out[r] = found ? static_cast<int>(row[14]) - 1 : -1;
}

template <bool kAnyHit>
cudaError_t launch(const float* table, int n_tris, const float* o,
                   const float* d, const float* tmax, long long n, float* t,
                   int* prim, float* u, float* v, float* nrm, int* mat,
                   int* light, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_tris) * kCols * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        smallscene_kernel<kAnyHit>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const unsigned blocks =
      static_cast<unsigned>((n + kThreads - 1) / kThreads);
  smallscene_kernel<kAnyHit><<<blocks, kThreads, smem, stream>>>(
      table, n_tris, o, d, tmax, n, t, prim, u, v, nrm, mat, light);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers; in
// any-hit mode u, v, nrm, mat and light are not written (may be null).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int smallscene_launch(const float* table, int n_tris,
                                 const float* o, const float* d,
                                 const float* tmax, long long n, int any_hit,
                                 float* t, int* prim, float* u, float* v,
                                 float* nrm, int* mat, int* light,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      any_hit ? launch<true>(table, n_tris, o, d, tmax, n, t, prim, u, v,
                             nrm, mat, light, s)
              : launch<false>(table, n_tris, o, d, tmax, n, t, prim, u, v,
                              nrm, mat, light, s);
  return static_cast<int>(e);
}

extern "C" const char* smallscene_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
