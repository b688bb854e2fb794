// K2 — closest / any-hit ray queries over Morton-sorted triangle clusters,
// for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel pbrt_tpu/ops/cluster.py::_cluster_kernel.
// Same tables (the reference's layout, so converted scenes are bit-equal):
// clusters of 128 Morton-adjacent triangles as (C, 128) float planes
// v0 | e1 | e2 | pid+1 | n | mat+1 | light+1, cluster boxes (C, 8) and
// super boxes (S, 8) over runs of 32 clusters.
//
// Contract (the plain twin, pbrt_tpu_torch/ops/cluster.py::
// cluster_intersect_ref, states the same rules and matches bit for bit):
// culling is per ray. A ray walks the supers in order; it walks a super's
// clusters when its slab test of the super box passes at super entry, and
// tests a cluster's 128 triangles when its slab test of the cluster box
// passes. The slab test keeps the reference's op order (only the z interval
// clamped at 0; pass when tmax >= tmin and tmin < t_best). Closest mode: a
// triangle hits when |det| > 1e-12, u >= 0, v >= 0, u + v <= 1 and
// 0 < t < t_best at cluster entry; the cluster's smallest hit t (3e38 when
// it has none, as in the reference) is committed when it is < t_best, with
// the largest pid among exact ties. Any-hit mode: in the first cluster with
// a hit, prim is the largest pid among its hits and t_best becomes 0, so no
// later gate passes.
//
// What bounds it: the Moller-Trumbore tests left after culling, each ~60
// FP32 instructions (built without FMA contraction, IEEE division), against
// 28 B read and 8 B written per ray. On the killeroo-class scene a ray
// needs tens of clusters of 128 triangles, thousands of flops per byte, so
// the kernel is bound by operations; the whole triangle set (~7.3 MB at
// 122k triangles) stays in the 50 MB L2. What it loses against that bound
// is lanes that issue tests no ray needs: a (warp, cluster) visit that one
// ray needs costs 128 serial rows in ray-parallel form.
//
// Design: the warp-level walk of cluster_walk.cuh, on rays that the caller
// has permuted with accel.api.ray_sort_perm. Each warp of 32 rays walks the
// supers in order on its own (__any_sync over the lanes' super tests; a
// warp whose lanes are all finished leaves), and within a super the
// clusters its lanes pass, staged per warp and tested ray-parallel when
// many lanes need them and triangle-parallel (4 rows a lane, a butterfly
// reduction) when few do. Only (t, pid, u, v, slot) of the best hit ride
// in registers; the normal and ids of the hit are read once after the
// walk.
//
// Numerics: built with --fmad=false and IEEE division, so every operation
// rounds once, in the twin's order.

#include <cuda_runtime.h>

#include "cluster_walk.cuh"
#include "triangle.cuh"

namespace {

using isect::inv_dir;
using walk::kThreads;

constexpr int kSuper = 32;  // clusters per super

struct Tables {
  const float* sboxes;
  const float* boxes;
  walk::Planes tri;
  const float* nx;
  const float* ny;
  const float* nz;
  const float* matf;
  const float* lightf;
};

template <bool kAnyHit, bool kAttrs>
__global__ void __launch_bounds__(kThreads)
cluster_kernel(Tables tab, int n_clusters, int n_supers,
               const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmax, long long n,
               float* __restrict__ t_out, int* __restrict__ prim_out,
               float* __restrict__ u_out, float* __restrict__ v_out,
               float* __restrict__ n_out, int* __restrict__ mat_out,
               int* __restrict__ light_out) {
  __shared__ __align__(16) walk::Slot slots[2 * walk::kWarps];

  const int lane = threadIdx.x % walk::kWarp;
  const long long r = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const bool in_range = r < n;
  // Lanes past the end carry t_best = -1: every gate fails for them, but
  // they still take part in the warp's votes.
  float dx = 1.0f, dy = 1.0f, dz = 1.0f;
  walk::Best best{-1.0f, 0.0f, 0.0f, 0.0f, -1, 0};
  isect::Ray ray{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (in_range) {
    ray.ox = o[3 * r];
    ray.oy = o[3 * r + 1];
    ray.oz = o[3 * r + 2];
    dx = d[3 * r];
    dy = d[3 * r + 1];
    dz = d[3 * r + 2];
    best.t = tmax[r];
  }
  ray.ix = inv_dir(dx);
  ray.iy = inv_dir(dy);
  ray.iz = inv_dir(dz);
  const walk::ObjRay mt_ray{ray.ox, ray.oy, ray.oz, dx, dy, dz};
  walk::Slot* const own = slots + 2 * (threadIdx.x / walk::kWarp);

  for (int s = 0; s < n_supers; ++s) {
    // Dead, finished (any-hit) and past-the-end lanes have t_best <= 0.
    if (!__any_sync(walk::kFull, best.t > 0.0f)) break;
    const bool live_s = isect::slab(tab.sboxes + 8 * s, ray, best.t);
    if (!__any_sync(walk::kFull, live_s)) continue;
    walk::walk_clusters<kAnyHit, kAttrs>(
        tab.tri, tab.boxes, own, lane, s * kSuper,
        min((s + 1) * kSuper, n_clusters), live_s, ray, mt_ray, 0, best);
  }

  if (!in_range) return;
  const bool found = best.prim > 0.0f;
  const float inf = __int_as_float(0x7f800000);
  prim_out[r] = found ? static_cast<int>(best.prim) - 1 : -1;
  t_out[r] = found ? best.t : inf;
  if (!kAttrs) return;
  u_out[r] = found ? best.u : 0.0f;
  v_out[r] = found ? best.v : 0.0f;
  const int at = found ? best.slot : 0;
  n_out[3 * r] = found ? tab.nx[at] : 0.0f;
  n_out[3 * r + 1] = found ? tab.ny[at] : 0.0f;
  n_out[3 * r + 2] = found ? tab.nz[at] : 0.0f;
  mat_out[r] = found ? static_cast<int>(tab.matf[at]) - 1 : 0;
  light_out[r] = found ? static_cast<int>(tab.lightf[at]) - 1 : -1;
}

template <bool kAnyHit, bool kAttrs>
cudaError_t launch(const Tables& tab, int n_clusters, int n_supers,
                   const float* o, const float* d, const float* tmax,
                   long long n, float* t, int* prim, float* u, float* v,
                   float* nrm, int* mat, int* light, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((n + kThreads - 1) / kThreads);
  cluster_kernel<kAnyHit, kAttrs><<<blocks, kThreads, 0, stream>>>(
      tab, n_clusters, n_supers, o, d, tmax, n, t, prim, u, v, nrm, mat,
      light);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers; the
// 17 tables come in the order sboxes, boxes, v0x v0y v0z e1x e1y e1z e2x
// e2y e2z pid, nx ny nz matf lightf (the ten triangle planes 16-B aligned,
// for the staging copies). u, v, nrm, mat and light are written
// only in closest mode with defer_attrs == 0 (may be null otherwise).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int cluster_launch(
    const float* sboxes, const float* boxes, const float* v0x,
    const float* v0y, const float* v0z, const float* e1x, const float* e1y,
    const float* e1z, const float* e2x, const float* e2y, const float* e2z,
    const float* pid, const float* nx, const float* ny, const float* nz,
    const float* matf, const float* lightf, int n_clusters, int n_supers,
    const float* o, const float* d, const float* tmax, long long n,
    int any_hit, int defer_attrs, float* t, int* prim, float* u, float* v,
    float* nrm, int* mat, int* light, void* stream) {
  const Tables tab{sboxes, boxes,
                   {v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, pid},
                   nx, ny, nz, matf, lightf};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (any_hit) {
    e = launch<true, false>(tab, n_clusters, n_supers, o, d, tmax, n, t,
                            prim, u, v, nrm, mat, light, s);
  } else if (defer_attrs) {
    e = launch<false, false>(tab, n_clusters, n_supers, o, d, tmax, n, t,
                             prim, u, v, nrm, mat, light, s);
  } else {
    e = launch<false, true>(tab, n_clusters, n_supers, o, d, tmax, n, t,
                            prim, u, v, nrm, mat, light, s);
  }
  return static_cast<int>(e);
}

extern "C" const char* cluster_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
