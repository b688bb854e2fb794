// Shared device code of the cluster kernels K2 (cluster.cu) and K3
// (sweep.cu, both through cluster_walk.cuh) and of the BVH kernel K4
// (traverse.cu): the reference's ray/box slab test of the clusters and
// its Moller-Trumbore triangle test, in the operation order of the plain
// twins (pbrt_tpu_torch/ops/cluster.py::slab, inv_dir, mt_rows;
// pbrt_tpu_torch/accel/bvh.py::bvh_intersect_ref). Built with --fmad=false
// and IEEE division, so every operation rounds once.

#pragma once

#include <cuda_runtime.h>

namespace isect {

constexpr float kEps = 1e-12f;

struct Ray {
  float ox, oy, oz, ix, iy, iz;  // origin and clamped inverse direction
};

__device__ __forceinline__ float inv_dir(float x) {
  return 1.0f / (fabsf(x) < kEps ? kEps : x);
}

// Per-ray AABB test of box row [lox loy loz hix hiy hiz], including the
// closer-hit prune (tmin < t_best); the reference's op order (only the z
// interval clamped at 0).
__device__ __forceinline__ bool slab(const float* __restrict__ box,
                                     const Ray& r, float t_best) {
  const float tx0 = (box[0] - r.ox) * r.ix;
  const float tx1 = (box[3] - r.ox) * r.ix;
  const float ty0 = (box[1] - r.oy) * r.iy;
  const float ty1 = (box[4] - r.oy) * r.iy;
  const float tz0 = (box[2] - r.oz) * r.iz;
  const float tz1 = (box[5] - r.oz) * r.iz;
  const float tmin = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                           fmaxf(fminf(tz0, tz1), 0.0f));
  const float tmx = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                          fmaxf(tz0, tz1));
  return tmx >= tmin && tmin < t_best;
}

// Moller-Trumbore of the ray (o, d) against the triangle (v0, e1, e2). It
// hits when |det| > 1e-12, u >= 0, v >= 0, u + v <= 1 and 0 < t < tb; t, u
// and v are written either way.
__device__ __forceinline__ bool mt_test(float v0x, float v0y, float v0z,
                                        float e1x, float e1y, float e1z,
                                        float e2x, float e2y, float e2z,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float tb, float& t, float& u,
                                        float& v) {
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok = fabsf(det) > kEps;
  const float inv_det = ok ? 1.0f / det : 0.0f;
  const float tvx = ox - v0x;
  const float tvy = oy - v0y;
  const float tvz = oz - v0z;
  u = (tvx * px + tvy * py + tvz * pz) * inv_det;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  v = (dx * qx + dy * qy + dz * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f && t < tb;
}

}  // namespace isect
