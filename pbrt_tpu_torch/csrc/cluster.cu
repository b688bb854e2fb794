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
// 122k triangles) stays in the 50 MB L2.
//
// Design (simple and right first): one thread per ray, 128 rays per block,
// on rays that the caller has permuted with accel.api.ray_sort_perm so that
// a block is a compact beam. Each thread keeps its own super and cluster
// masks; __syncthreads_or skips a super or cluster no ray of the block
// needs. A cluster some ray needs is staged into shared memory once per
// block (128 triangles x 10 floats, one coalesced load per plane and
// thread); every live ray then tests the 128 rows in order, reading the
// same shared word across the warp (a broadcast). Only (t, pid, u, v, slot)
// of the best hit ride in registers; the normal and ids of the hit are read
// once after the walk.
//
// Numerics: built with --fmad=false and IEEE division, so every operation
// rounds once, in the twin's order.

#include <cuda_runtime.h>

namespace {

constexpr int kCluster = 128;
constexpr int kSuper = 32;
constexpr int kThreads = 128;  // one ray per thread; == kCluster for staging
constexpr int kTriPlanes = 10;  // v0x v0y v0z e1x e1y e1z e2x e2y e2z pid
constexpr float kEps = 1e-12f;
constexpr float kBig = 3e38f;

static_assert(kThreads == kCluster, "staging loads one triangle per thread");

struct Tables {
  const float* sboxes;
  const float* boxes;
  const float* tri[kTriPlanes];
  const float* nx;
  const float* ny;
  const float* nz;
  const float* matf;
  const float* lightf;
};

struct Ray {
  float ox, oy, oz, ix, iy, iz;
};

__device__ __forceinline__ float inv_dir(float x) {
  return 1.0f / (fabsf(x) < kEps ? kEps : x);
}

// Per-ray AABB test of box row [lox loy loz hix hiy hiz], including the
// closer-hit prune (tmin < t_best); the reference's op order.
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

template <bool kAnyHit, bool kAttrs>
__global__ void __launch_bounds__(kThreads)
cluster_kernel(Tables tab, int n_clusters, int n_supers,
               const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmax, long long n,
               float* __restrict__ t_out, int* __restrict__ prim_out,
               float* __restrict__ u_out, float* __restrict__ v_out,
               float* __restrict__ n_out, int* __restrict__ mat_out,
               int* __restrict__ light_out) {
  __shared__ float tri[kTriPlanes][kCluster];

  const long long r = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const bool in_range = r < n;
  // Lanes past the end carry t_best = -1: every slab gate fails for them,
  // but they still take part in the block's barriers.
  float dx = 1.0f, dy = 1.0f, dz = 1.0f;
  float t_best = -1.0f;
  Ray ray{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (in_range) {
    ray.ox = o[3 * r];
    ray.oy = o[3 * r + 1];
    ray.oz = o[3 * r + 2];
    dx = d[3 * r];
    dy = d[3 * r + 1];
    dz = d[3 * r + 2];
    t_best = tmax[r];
  }
  ray.ix = inv_dir(dx);
  ray.iy = inv_dir(dy);
  ray.iz = inv_dir(dz);
  float prim_f = 0.0f;  // pid + 1 of the best hit, 0 = none
  float ub = 0.0f, vb = 0.0f;
  int slot = -1;  // cluster * 128 + row of the best hit

  for (int s = 0; s < n_supers; ++s) {
    const bool live_s = slab(tab.sboxes + 8 * s, ray, t_best);
    if (!__syncthreads_or(live_s)) continue;
    const int hi = min((s + 1) * kSuper, n_clusters);
    for (int c = s * kSuper; c < hi; ++c) {
      const bool live_c = live_s && slab(tab.boxes + 8 * c, ray, t_best);
      // The barrier also ends every read of the previous staged cluster.
      if (!__syncthreads_or(live_c)) continue;
      const int src = c * kCluster + threadIdx.x;
#pragma unroll
      for (int k = 0; k < kTriPlanes; ++k) tri[k][threadIdx.x] = tab.tri[k][src];
      __syncthreads();
      if (!live_c) continue;

      const float tb = t_best;  // t_best at cluster entry gates every row
      float bt = kBig, bp = 0.0f, bu = 0.0f, bv = 0.0f;
      int bj = -1;
      bool got = false;
      for (int j = 0; j < kCluster; ++j) {
        const float v0x = tri[0][j], v0y = tri[1][j], v0z = tri[2][j];
        const float e1x = tri[3][j], e1y = tri[4][j], e1z = tri[5][j];
        const float e2x = tri[6][j], e2y = tri[7][j], e2z = tri[8][j];
        const float pid = tri[9][j];
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool ok = fabsf(det) > kEps;
        const float inv_det = ok ? 1.0f / det : 0.0f;
        const float tvx = ray.ox - v0x;
        const float tvy = ray.oy - v0y;
        const float tvz = ray.oz - v0z;
        const float u = (tvx * px + tvy * py + tvz * pz) * inv_det;
        const float qx = tvy * e1z - tvz * e1y;
        const float qy = tvz * e1x - tvx * e1z;
        const float qz = tvx * e1y - tvy * e1x;
        const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
        const float tk = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        const bool hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                         tk > 0.0f && tk < tb;
        if (!hit) continue;
        if (kAnyHit) {
          got = true;
          bp = fmaxf(bp, pid);
        } else if (tk < bt || (tk == bt && pid > bp)) {
          bt = tk;
          bp = pid;
          bu = u;
          bv = v;
          bj = j;
        }
      }
      if (kAnyHit) {
        if (got) {
          t_best = 0.0f;
          prim_f = bp;
        }
      } else if (bt < t_best) {
        t_best = bt;
        prim_f = bp;
        ub = bu;
        vb = bv;
        slot = bj < 0 ? -1 : c * kCluster + bj;
      }
    }
  }

  if (!in_range) return;
  const bool found = prim_f > 0.0f;
  const float inf = __int_as_float(0x7f800000);
  prim_out[r] = found ? static_cast<int>(prim_f) - 1 : -1;
  t_out[r] = found ? t_best : inf;
  if (!kAttrs) return;
  u_out[r] = found ? ub : 0.0f;
  v_out[r] = found ? vb : 0.0f;
  const int at = found ? slot : 0;
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
// e2y e2z pid, nx ny nz matf lightf. u, v, nrm, mat and light are written
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
