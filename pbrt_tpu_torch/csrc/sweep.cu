// K3 — closest / any-hit ray queries over instanced triangle clusters, for
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel pbrt_tpu/ops/sweep.py::_sweep_kernel and
// the XLA candidate pre-pass that feeds it (_candidates, a workaround for
// the TPU's scalar core). Same tables (the reference's layout, so converted
// scenes are bit-equal): prototype triangles stored once, in object space,
// as clusters of 128 Morton-adjacent triangles, (C, 128) float planes
// v0 | e1 | e2 | pid+1, object-space cluster boxes (C, 8), and per instance
// a 3x4 world-to-object row (I, 12), its world box (I, 8) and its
// prototype's cluster range (I, 2); and, derived by the wrapper, group
// boxes (C, 8): row first + 32k of a prototype's range holds the union of
// its clusters first + 32k .. first + 32k + 31.
//
// Contract (the plain twin, pbrt_tpu_torch/ops/sweep.py::
// sweep_intersect_ref, states the same rules and matches bit for bit):
// culling is per ray. A ray walks the instances in order and enters one
// when its slab test of the instance's world box passes; it then moves into
// object space (a00*ox + a01*oy + a02*oz + b0, left to right; the direction
// is left unnormalised, so object t equals world t) and walks the
// prototype's clusters in order, testing a cluster's 128 triangles when its
// slab test of the object box passes. The slab test keeps the reference's
// op order (only the z interval clamped at 0; pass when tmax >= tmin and
// tmin < t_best). Closest mode: a triangle hits when |det| > 1e-12, u >= 0,
// v >= 0, u + v <= 1 and 0 < t < t_best at cluster entry; the cluster's
// smallest hit t (3e38 when it has none) is committed with the instance
// when it is < t_best, with the largest pid among exact ties. Any-hit mode:
// in the first cluster with a hit, prim is the largest pid among its hits
// and t_best becomes 0, so no later gate passes. Without instances
// (instanced == 0, one identity instance) the world ray is used as is.
//
// What bounds it: the Moller-Trumbore tests left after culling, ~53 FP32
// operations each (built without FMA contraction, IEEE division), plus 18
// for the transform per (ray, entered instance), against 28 B read and
// 12 B written per ray. A ray needs tens of clusters of 128 triangles,
// thousands of flops per byte, so the kernel is bound by operations; the
// unique triangles (~5 MB at 122k triangles) stay in the 50 MB L2. What it
// loses against that bound is lanes that issue tests no ray needs: a
// (warp, cluster) visit that one ray needs costs 128 serial rows in
// ray-parallel form.
//
// Design: the warp-level walk of cluster_walk.cuh inside an instance loop,
// on rays that the caller has permuted with accel.api.ray_sort_perm. Each
// warp of 32 rays walks the instances in order on its own (__any_sync over
// the lanes' tests of the instance's world box; a warp whose lanes are all
// finished leaves); each lane moves its ray into the instance's object
// space, and the warp walks the prototype's groups of 32 clusters whose
// box some lane passes (as K2 walks its supers), then the group's clusters
// its lanes pass, staged per warp and tested ray-parallel when many lanes
// need them and triangle-parallel (the object-space ray broadcast, 4 rows
// a lane, a butterfly reduction) when few do. A group box holds its
// clusters' boxes and rounding is monotone, so a lane that fails it fails
// each of its clusters' tests: the group gate skips work and changes no
// result (without it, each entered instance cost every lane a slab test
// of each of the prototype's hundreds of clusters). Dead lanes (tmax <= 0:
// the path's masked shadow rays, pad lanes) pass no gate.
//
// Numerics: built with --fmad=false and IEEE division, so every operation
// rounds once, in the twin's order.

#include <cuda_runtime.h>

#include "cluster_walk.cuh"
#include "triangle.cuh"

namespace {

using isect::inv_dir;
using walk::kThreads;

constexpr int kGroup = 32;  // clusters per group box

struct Tables {
  const float* boxes;  // (C, 8) object-space cluster boxes
  const float* ibox;   // (I, 8) instance world boxes
  const int* irange;   // (I, 2) first cluster, cluster count
  const float* w2o;    // (I, 12) world-to-object rows
  const float* gbox;   // (C, 8) group boxes at each group's first row
  walk::Planes tri;
};

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(Tables tab, int n_inst, int instanced,
             const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ tmax, long long n,
             float* __restrict__ t_out, int* __restrict__ prim_out,
             int* __restrict__ inst_out) {
  __shared__ __align__(16) walk::Slot slots[2 * walk::kWarps];

  const int lane = threadIdx.x % walk::kWarp;
  const long long r = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const bool in_range = r < n;
  // Lanes past the end carry t_best = -1: every gate fails for them, but
  // they still take part in the warp's votes.
  float ox = 0.0f, oy = 0.0f, oz = 0.0f;
  float dx = 1.0f, dy = 1.0f, dz = 1.0f;
  walk::Best best{-1.0f, 0.0f, 0.0f, 0.0f, -1, 0};
  if (in_range) {
    ox = o[3 * r];
    oy = o[3 * r + 1];
    oz = o[3 * r + 2];
    dx = d[3 * r];
    dy = d[3 * r + 1];
    dz = d[3 * r + 2];
    best.t = tmax[r];
  }
  const isect::Ray world{ox, oy, oz, inv_dir(dx), inv_dir(dy), inv_dir(dz)};
  walk::Slot* const own = slots + 2 * (threadIdx.x / walk::kWarp);

  for (int i = 0; i < n_inst; ++i) {
    // Dead, finished (any-hit) and past-the-end lanes have t_best <= 0.
    if (!__any_sync(walk::kFull, best.t > 0.0f)) break;
    const bool live_i = isect::slab(tab.ibox + 8 * i, world, best.t);
    if (!__any_sync(walk::kFull, live_i)) continue;
    // The ray in instance i's object space.
    walk::ObjRay obj{ox, oy, oz, dx, dy, dz};
    if (instanced) {
      const float* a = tab.w2o + 12 * i;
      obj.ox = a[0] * ox + a[1] * oy + a[2] * oz + a[3];
      obj.oy = a[4] * ox + a[5] * oy + a[6] * oz + a[7];
      obj.oz = a[8] * ox + a[9] * oy + a[10] * oz + a[11];
      obj.dx = a[0] * dx + a[1] * dy + a[2] * dz;
      obj.dy = a[4] * dx + a[5] * dy + a[6] * dz;
      obj.dz = a[8] * dx + a[9] * dy + a[10] * dz;
    }
    const isect::Ray ray{obj.ox, obj.oy, obj.oz, inv_dir(obj.dx),
                         inv_dir(obj.dy), inv_dir(obj.dz)};
    const int first = tab.irange[2 * i];
    const int last = first + tab.irange[2 * i + 1];
    for (int g = first; g < last; g += kGroup) {
      const bool live_g =
          live_i && isect::slab(tab.gbox + 8 * g, ray, best.t);
      if (!__any_sync(walk::kFull, live_g)) continue;
      walk::walk_clusters<kAnyHit, false>(tab.tri, tab.boxes, own, lane, g,
                                          min(g + kGroup, last), live_g, ray,
                                          obj, i + 1, best);
    }
  }

  if (!in_range) return;
  const bool found = best.prim > 0.0f;
  const float inf = __int_as_float(0x7f800000);
  prim_out[r] = found ? static_cast<int>(best.prim) - 1 : -1;
  inst_out[r] = found ? best.tag - 1 : -1;
  t_out[r] = found ? best.t : inf;
}

template <bool kAnyHit>
cudaError_t launch(const Tables& tab, int n_inst, int instanced,
                   const float* o, const float* d, const float* tmax,
                   long long n, float* t, int* prim, int* inst,
                   cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((n + kThreads - 1) / kThreads);
  sweep_kernel<kAnyHit><<<blocks, kThreads, 0, stream>>>(
      tab, n_inst, instanced, o, d, tmax, n, t, prim, inst);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers; the
// 15 tables come in the order boxes, ibox, irange, w2o, gbox, v0x v0y v0z
// e1x e1y e1z e2x e2y e2z pid (the ten triangle planes 16-B aligned, for
// the staging copies). Returns the cudaError_t of the launch (0 = success).
extern "C" int sweep_launch(
    const float* boxes, const float* ibox, const int* irange,
    const float* w2o, const float* gbox, const float* v0x, const float* v0y,
    const float* v0z, const float* e1x, const float* e1y, const float* e1z,
    const float* e2x, const float* e2y, const float* e2z, const float* pid,
    int n_inst,
    int instanced, const float* o, const float* d, const float* tmax,
    long long n, int any_hit, float* t, int* prim, int* inst, void* stream) {
  const Tables tab{boxes, ibox, irange, w2o, gbox,
                   {v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, pid}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      any_hit ? launch<true>(tab, n_inst, instanced, o, d, tmax, n, t, prim,
                             inst, s)
              : launch<false>(tab, n_inst, instanced, o, d, tmax, n, t, prim,
                              inst, s);
  return static_cast<int>(e);
}

extern "C" const char* sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
