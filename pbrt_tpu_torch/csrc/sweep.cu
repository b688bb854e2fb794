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
// prototype's cluster range (I, 2).
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
// unique triangles (~5 MB at 122k triangles) stay in the 50 MB L2.
//
// Design (simple and right first): one thread per ray, 128 rays per block,
// on rays that the caller has permuted with accel.api.ray_sort_perm so
// that a block is a compact beam. Each thread keeps its own instance and
// cluster masks; __syncthreads_or skips an instance or a cluster no ray of
// the block needs. A cluster some ray needs is staged into shared memory
// once per block (128 triangles x 10 floats, one coalesced load per plane
// and thread); every live ray then tests the 128 rows in order, reading
// the same shared word across the warp (a broadcast). Dead lanes (tmax <=
// 0: the path's masked shadow rays, pad lanes) pass no gate but meet every
// barrier.
//
// Numerics: built with --fmad=false and IEEE division, so every operation
// rounds once, in the twin's order.

#include <cuda_runtime.h>

#include "triangle.cuh"

namespace {

using isect::Ray;
using isect::inv_dir;
using isect::slab;

constexpr int kCluster = 128;
constexpr int kThreads = 128;  // one ray per thread; == kCluster for staging
constexpr int kTriPlanes = 10;  // v0x v0y v0z e1x e1y e1z e2x e2y e2z pid
constexpr float kBig = 3e38f;

static_assert(kThreads == kCluster, "staging loads one triangle per thread");

struct Tables {
  const float* boxes;  // (C, 8) object-space cluster boxes
  const float* ibox;   // (I, 8) instance world boxes
  const int* irange;   // (I, 2) first cluster, cluster count
  const float* w2o;    // (I, 12) world-to-object rows
  const float* tri[kTriPlanes];
};

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(Tables tab, int n_inst, int instanced,
             const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ tmax, long long n,
             float* __restrict__ t_out, int* __restrict__ prim_out,
             int* __restrict__ inst_out) {
  __shared__ float tri[kTriPlanes][kCluster];

  const long long r = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const bool in_range = r < n;
  // Lanes past the end carry t_best = -1: every slab gate fails for them,
  // but they still take part in the block's barriers.
  float ox = 0.0f, oy = 0.0f, oz = 0.0f;
  float dx = 1.0f, dy = 1.0f, dz = 1.0f;
  float t_best = -1.0f;
  if (in_range) {
    ox = o[3 * r];
    oy = o[3 * r + 1];
    oz = o[3 * r + 2];
    dx = d[3 * r];
    dy = d[3 * r + 1];
    dz = d[3 * r + 2];
    t_best = tmax[r];
  }
  const Ray world{ox, oy, oz, inv_dir(dx), inv_dir(dy), inv_dir(dz)};
  float prim_f = 0.0f;  // pid + 1 of the best hit, 0 = none
  int inst_f = 0;       // instance + 1 of the best hit

  for (int i = 0; i < n_inst; ++i) {
    const bool live_i = slab(tab.ibox + 8 * i, world, t_best);
    if (!__syncthreads_or(live_i)) continue;
    // The ray in instance i's object space.
    float lox = ox, loy = oy, loz = oz, ldx = dx, ldy = dy, ldz = dz;
    if (instanced) {
      const float* a = tab.w2o + 12 * i;
      lox = a[0] * ox + a[1] * oy + a[2] * oz + a[3];
      loy = a[4] * ox + a[5] * oy + a[6] * oz + a[7];
      loz = a[8] * ox + a[9] * oy + a[10] * oz + a[11];
      ldx = a[0] * dx + a[1] * dy + a[2] * dz;
      ldy = a[4] * dx + a[5] * dy + a[6] * dz;
      ldz = a[8] * dx + a[9] * dy + a[10] * dz;
    }
    const Ray ray{lox, loy, loz, inv_dir(ldx), inv_dir(ldy), inv_dir(ldz)};
    const int first = tab.irange[2 * i];
    const int last = first + tab.irange[2 * i + 1];
    for (int c = first; c < last; ++c) {
      const bool live_c = live_i && slab(tab.boxes + 8 * c, ray, t_best);
      // The barrier also ends every read of the previous staged cluster.
      if (!__syncthreads_or(live_c)) continue;
      const int src = c * kCluster + threadIdx.x;
#pragma unroll
      for (int k = 0; k < kTriPlanes; ++k) tri[k][threadIdx.x] = tab.tri[k][src];
      __syncthreads();
      if (!live_c) continue;

      const float tb = t_best;  // t_best at cluster entry gates every row
      float bt = kBig, bp = 0.0f;
      bool got = false;
      for (int j = 0; j < kCluster; ++j) {
        float tk, u, v;
        const bool hit = isect::mt_row(tri, j, lox, loy, loz, ldx, ldy, ldz,
                                       tb, tk, u, v);
        const float pid = tri[9][j];
        if (!hit) continue;
        if (kAnyHit) {
          got = true;
          bp = fmaxf(bp, pid);
        } else if (tk < bt || (tk == bt && pid > bp)) {
          bt = tk;
          bp = pid;
        }
      }
      if (kAnyHit) {
        if (got) {
          t_best = 0.0f;
          prim_f = bp;
          inst_f = i + 1;
        }
      } else if (bt < t_best) {
        t_best = bt;
        prim_f = bp;
        inst_f = i + 1;
      }
    }
  }

  if (!in_range) return;
  const bool found = prim_f > 0.0f;
  const float inf = __int_as_float(0x7f800000);
  prim_out[r] = found ? static_cast<int>(prim_f) - 1 : -1;
  inst_out[r] = found ? inst_f - 1 : -1;
  t_out[r] = found ? t_best : inf;
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
// 14 tables come in the order boxes, ibox, irange, w2o, v0x v0y v0z e1x e1y
// e1z e2x e2y e2z pid. Returns the cudaError_t of the launch (0 = success).
extern "C" int sweep_launch(
    const float* boxes, const float* ibox, const int* irange,
    const float* w2o, const float* v0x, const float* v0y, const float* v0z,
    const float* e1x, const float* e1y, const float* e1z, const float* e2x,
    const float* e2y, const float* e2z, const float* pid, int n_inst,
    int instanced, const float* o, const float* d, const float* tmax,
    long long n, int any_hit, float* t, int* prim, int* inst, void* stream) {
  const Tables tab{boxes, ibox, irange, w2o,
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
