// K4 — closest / any-hit ray queries over the implicit-heap BVH, for
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel pbrt_tpu/ops/traverse.py::_traverse_kernel.
// Its docstring gives its contract as that of pbrt_tpu/accel/bvh.py::
// bvh_intersect, which this kernel computes per ray; the Pallas kernel's
// shared-stack packet walk over 1024-ray tiles is a workaround for the
// TPU's lack of a per-lane gather and is not carried over. Tables are the
// reference's build (pbrt_tpu_torch/accel/bvh.py::build_bvh): node boxes
// lo, hi (n_nodes, 3) in heap layout (children of i at 2i+1, 2i+2; leaves
// from 2^depth - 1 on), and leaf triangles v0, e1, e2 (P, 3) and prim ids
// (P,) int32, leaf_size per leaf, padded with prim id -1.
//
// Contract (the plain twin, pbrt_tpu_torch/accel/bvh.py::bvh_intersect_ref,
// states the same rules and matches bit for bit): the root starts on a
// per-ray stack. Pop a node; its slab test passes when the box is not empty
// (lo.x <= hi.x), tmax >= max(tmin, 0) and tmin < t_best. A leaf tests its
// triangles in order (Moller-Trumbore, |det| > 1e-12, u, v >= 0,
// u + v <= 1, 0 < t < t_best, prim id >= 0), t_best shrinking as it goes.
// An inner node pushes the far child, then the near one (child 2i+1 is
// near when its clamped entry distance is <= that of 2i+2). Any-hit mode
// stops at the first hit. A leaf's heap children lie past the node table
// and are never read.
//
// What bounds it: per ray, a few dozen slab tests (~25 FP32 operations,
// two child entries of ~18 more at each inner node) and a few leaves of 4
// Moller-Trumbore tests (53 operations each), against 28 B read and 16 B
// written per ray; the tables (1.6 MB of nodes and 5 MB of triangles at
// 122k triangles) stay in the 50 MB L2. So it is bound by operations and,
// with divergent rays, by the latency of the dependent node loads.
//
// Design (simple and right first): one thread per ray, 128 threads per
// block, the rays in the caller's order (the reference sorts none for this
// tier). The stack holds depth + 2 ints in local memory. Node and triangle
// rows are read through the read-only cache (__ldg).
//
// Numerics: built with --fmad=false and IEEE division, so every operation
// rounds once, in the twin's order.

#include <cuda_runtime.h>

#include "triangle.cuh"

namespace {

constexpr int kThreads = 128;
// Deepest tree the stack holds: 2^30 leaves, beyond any float32 id range.
constexpr int kMaxDepth = 30;

struct Tables {
  const float* lo;   // (n_nodes, 3)
  const float* hi;   // (n_nodes, 3)
  const float* v0;   // (P, 3)
  const float* e1;   // (P, 3)
  const float* e2;   // (P, 3)
  const int* pid;    // (P,)
};

struct SlabRay {
  float ox, oy, oz, ix, iy, iz;
};

// (tmin, tmax) of the ray against box `node`, and whether the box is not
// empty; the twin's _slab.
__device__ __forceinline__ bool node_slab(const Tables& tab, int node,
                                          const SlabRay& r, float& tmin,
                                          float& tmx) {
  const float* lo = tab.lo + 3 * node;
  const float* hi = tab.hi + 3 * node;
  const float lox = __ldg(lo), loy = __ldg(lo + 1), loz = __ldg(lo + 2);
  const float hix = __ldg(hi), hiy = __ldg(hi + 1), hiz = __ldg(hi + 2);
  const float tx0 = (lox - r.ox) * r.ix;
  const float tx1 = (hix - r.ox) * r.ix;
  const float ty0 = (loy - r.oy) * r.iy;
  const float ty1 = (hiy - r.oy) * r.iy;
  const float tz0 = (loz - r.oz) * r.iz;
  const float tz1 = (hiz - r.oz) * r.iz;
  tmin = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  tmx = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return lox <= hix;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
traverse_kernel(Tables tab, int depth, int leaf_size,
                const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ tmax, long long n,
                float* __restrict__ t_out, int* __restrict__ prim_out,
                float* __restrict__ u_out, float* __restrict__ v_out) {
  const long long r = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (r >= n) return;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const SlabRay ray{ox, oy, oz, isect::inv_dir(dx), isect::inv_dir(dy),
                    isect::inv_dir(dz)};
  const int first_leaf = (1 << depth) - 1;
  float t_best = tmax[r];
  int prim = -1;
  float ub = 0.0f, vb = 0.0f;

  int stack[kMaxDepth + 2];
  int sp = 1;
  stack[0] = 0;
  while (sp > 0) {
    const int node = stack[--sp];
    float tmin, tmx;
    const bool full = node_slab(tab, node, ray, tmin, tmx);
    if (!(full && tmx >= fmaxf(tmin, 0.0f) && tmin < t_best)) continue;
    if (node >= first_leaf) {
      const int base = (node - first_leaf) * leaf_size;
      for (int k = 0; k < leaf_size; ++k) {
        const int j = base + k;
        const float* v0 = tab.v0 + 3 * j;
        const float* e1 = tab.e1 + 3 * j;
        const float* e2 = tab.e2 + 3 * j;
        float tk, uk, vk;
        const bool hit = isect::mt_test(
            __ldg(v0), __ldg(v0 + 1), __ldg(v0 + 2), __ldg(e1), __ldg(e1 + 1),
            __ldg(e1 + 2), __ldg(e2), __ldg(e2 + 1), __ldg(e2 + 2), ox, oy,
            oz, dx, dy, dz, t_best, tk, uk, vk);
        const int pk = __ldg(tab.pid + j);
        if (hit && pk >= 0) {
          t_best = tk;
          prim = pk;
          ub = uk;
          vb = vk;
        }
      }
      // Any-hit: a confirmed hit ends the walk.
      if (kAnyHit && prim >= 0) break;
      continue;
    }
    const int c0 = 2 * node + 1;
    float t0, t1, unused;
    node_slab(tab, c0, ray, t0, unused);
    node_slab(tab, c0 + 1, ray, t1, unused);
    const bool near_is_0 = fmaxf(t0, 0.0f) <= fmaxf(t1, 0.0f);
    stack[sp] = near_is_0 ? c0 + 1 : c0;  // far first
    stack[sp + 1] = near_is_0 ? c0 : c0 + 1;
    sp += 2;
  }
  t_out[r] = t_best;
  prim_out[r] = prim;
  u_out[r] = ub;
  v_out[r] = vb;
}

template <bool kAnyHit>
cudaError_t launch(const Tables& tab, int depth, int leaf_size,
                   const float* o, const float* d, const float* tmax,
                   long long n, float* t, int* prim, float* u, float* v,
                   cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((n + kThreads - 1) / kThreads);
  traverse_kernel<kAnyHit><<<blocks, kThreads, 0, stream>>>(
      tab, depth, leaf_size, o, d, tmax, n, t, prim, u, v);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers.
// Returns the cudaError_t of the launch (0 = success), or
// cudaErrorInvalidValue for a tree deeper than the stack holds.
extern "C" int traverse_launch(const float* lo, const float* hi,
                               const float* v0, const float* e1,
                               const float* e2, const int* pid, int depth,
                               int leaf_size, const float* o, const float* d,
                               const float* tmax, long long n, int any_hit,
                               float* t, int* prim, float* u, float* v,
                               void* stream) {
  if (depth < 0 || depth > kMaxDepth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tables tab{lo, hi, v0, e1, e2, pid};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      any_hit ? launch<true>(tab, depth, leaf_size, o, d, tmax, n, t, prim,
                             u, v, s)
              : launch<false>(tab, depth, leaf_size, o, d, tmax, n, t, prim,
                              u, v, s);
  return static_cast<int>(e);
}

extern "C" const char* traverse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
