// K4 — closest / any-hit ray queries over the implicit-heap BVH, for
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel pbrt_tpu/ops/traverse.py::_traverse_kernel.
// Its docstring gives its contract as that of pbrt_tpu/accel/bvh.py::
// bvh_intersect, which this kernel computes per ray; the Pallas kernel's
// shared-stack packet walk over 1024-ray tiles is a workaround for the
// TPU's lack of a per-lane gather and is not carried over. Tables are the
// reference's build (pbrt_tpu_torch/accel/bvh.py::build_bvh), read as the
// packed rows that BVH derives once from it: nodes (n_nodes, 8) f32
// [lo.xyz, 0, hi.xyz, 0] in heap layout (children of i at 2i+1, 2i+2;
// leaves from 2^depth - 1 on), and leaf triangles (P, 12) f32 [v0, e1, e2,
// prim-id bits, 0, 0], leaf_size per leaf, padded with prim id -1.
//
// Contract (the plain twin, pbrt_tpu_torch/accel/bvh.py::bvh_intersect_ref,
// states the same rules and matches bit for bit): the root starts on a
// per-ray stack. Pop a node; its slab test passes when the box is not empty
// (lo.x <= hi.x), tmax >= max(tmin, 0) and tmin < t_best. A leaf tests its
// triangles in order (Moller-Trumbore, |det| > 1e-12, u, v >= 0,
// u + v <= 1, 0 < t < t_best, prim id >= 0), t_best shrinking as it goes.
// An inner node pushes the far child, then the near one (child 2i+1 is
// near when its clamped entry distance is <= that of 2i+2). Any-hit mode
// stops after the leaf of the first hit.
//
// What bounds it: per ray, one slab test for the root and one for each
// child of an inner visit (~142 per camera ray, 25 FP32 operations each)
// and a few leaves of 4 Moller-Trumbore tests (53 each), against 28 B
// read and 16 B written per ray; the tables (2 MB of node rows and 6 MB of
// triangle rows at 122k triangles) stay in the 50 MB L2. The operations
// set the bound; what the card spends its time on is each step's node
// rows, 16-B loads scattered over the warp's lanes through the L1 (a
// larger shared-memory carve-out made it 29-34% slower), and the steps
// themselves: ~71 per camera ray, where the Morton tree's loose boxes
// (the floor widens every ancestor) let a ray into many subtrees.
//
// Design. One thread per ray, in the caller's order (the reference sorts
// none for this tier). The per-ray sequence of leaves tested is the
// twin's, which is why the results are exactly equal:
//   - Children are culled when they are pushed. Each child's slab (tmin,
//     tmax, non-empty) is computed once, with the twin's arithmetic; only
//     children that pass the full test now are pushed, with their tmin. A
//     pop checks tmin < t_best alone and loads nothing. Exact: emptiness
//     and tmax >= max(tmin, 0) do not depend on t_best, and t_best only
//     falls between push and pop. The nearest child pushed is kept in
//     registers as the next node instead of a push and a pop.
//   - Rows are 16-B aligned float4 reads through the read-only cache: a
//     sibling pair is 64 B, a leaf of 4 triangles 192 B. The stack of
//     (node, tmin) lives in local memory.
//   - One heap level per step. Two (the four grandchildren of a node read
//     and pushed in one step) halves the steps but computes six slabs a
//     step instead of two, and measured 16-18% slower (PERF.md §6).
// Selects pick scalars, never structs: a select between two structs
// went through local memory and cost 10-12%.
//
// Numerics: built with --fmad=false and IEEE division, so every operation
// rounds once, in the twin's order.

#include <cuda_runtime.h>

#include "triangle.cuh"

namespace {

constexpr int kThreads = 128;
// Deepest tree the stack holds: 2^30 leaves, beyond any float32 id range.
constexpr int kMaxDepth = 30;

// Entries the stack needs for a tree of `depth`: at most one pending
// sibling per level (depth + 1), and one to spare.
__host__ __device__ constexpr int stack_entries(int depth) {
  return depth + 2;
}

struct SlabRay {
  float ox, oy, oz, ix, iy, iz;
};

struct Box {
  float tmin, tmx;
  bool full;
};

// (tmin, tmax) of the ray against the box [lo, hi], and whether the box is
// not empty; the twin's _slab.
__device__ __forceinline__ Box slab(const float4 lo, const float4 hi,
                                    const SlabRay& r) {
  const float tx0 = (lo.x - r.ox) * r.ix;
  const float tx1 = (hi.x - r.ox) * r.ix;
  const float ty0 = (lo.y - r.oy) * r.iy;
  const float ty1 = (hi.y - r.oy) * r.iy;
  const float tz0 = (lo.z - r.oz) * r.iz;
  const float tz1 = (hi.z - r.oz) * r.iz;
  Box b;
  b.tmin = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  b.tmx = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  b.full = lo.x <= hi.x;
  return b;
}

// The twin's slab test without its t_best part (fixed for a ray).
__device__ __forceinline__ bool passes(const Box& b) {
  return b.full && b.tmx >= fmaxf(b.tmin, 0.0f);
}

// The rows of node i: [lo.xyz, 0] and [hi.xyz, 0].
__device__ __forceinline__ void load_node(const float4* __restrict__ nodes,
                                          int i, float4& lo, float4& hi) {
  lo = __ldg(nodes + 2 * i);
  hi = __ldg(nodes + 2 * i + 1);
}

// The next node, held in registers, and its tmin.
struct Next {
  int node;
  float tmin;
  bool have;
};

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
traverse_kernel(const float4* __restrict__ nodes,
                const float4* __restrict__ tris, int depth, int leaf_size,
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

  // (node, tmin bits) entries in local memory.
  int2 stack[stack_entries(kMaxDepth)];
  int sp = 0;
  Next next{0, 0.0f, false};
  // Offers a step's children in push order (far to near): a child that
  // passes its test now (`ok`) is pushed, except the last one, which is
  // held in registers as the next node.
  auto offer = [&](int child, bool ok, float tmin) {
    if (ok) {
      if (next.have) {
        stack[sp++] = make_int2(next.node, __float_as_int(next.tmin));
      }
      next = Next{child, tmin, true};
    }
  };
  // A sibling pair (a, a + 1), far first: a is near when its clamped
  // entry distance is <= that of a + 1. Scalars are selected, not boxes:
  // a select between two structs would go through local memory.
  auto offer_pair = [&](int a, const Box& ba, const Box& bb) {
    const bool ok_a = passes(ba) && ba.tmin < t_best;
    const bool ok_b = passes(bb) && bb.tmin < t_best;
    const bool near_is_a = fmaxf(ba.tmin, 0.0f) <= fmaxf(bb.tmin, 0.0f);
    offer(near_is_a ? a + 1 : a, near_is_a ? ok_b : ok_a,
          near_is_a ? bb.tmin : ba.tmin);
    offer(near_is_a ? a : a + 1, near_is_a ? ok_a : ok_b,
          near_is_a ? ba.tmin : bb.tmin);
  };
  {
    float4 lo, hi;
    load_node(nodes, 0, lo, hi);
    const Box b = slab(lo, hi, ray);
    offer(0, passes(b) && b.tmin < t_best, b.tmin);  // the root, on entry
  }

  while (true) {
    // Without a held node, pop until an entry passes tmin < t_best;
    // nothing is loaded.
    while (!next.have && sp > 0) {
      const int2 e = stack[--sp];
      if (__int_as_float(e.y) < t_best) next = Next{e.x, 0.0f, true};
    }
    if (!next.have) break;
    const int node = next.node;
    next.have = false;
    if (node >= first_leaf) {
      // A leaf: its triangles in order, t_best shrinking as it goes.
      const int base = (node - first_leaf) * leaf_size;
      for (int k = 0; k < leaf_size; ++k) {
        const float4* row = tris + 3 * (base + k);
        const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);
        float tk, uk, vk;
        const bool hit = isect::mt_test(a.x, a.y, a.z, a.w, b.x, b.y, b.z,
                                        b.w, c.x, ox, oy, oz, dx, dy, dz,
                                        t_best, tk, uk, vk);
        const int pk = __float_as_int(c.y);
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
    float4 lo0, hi0, lo1, hi1;
    load_node(nodes, c0, lo0, hi0);
    load_node(nodes, c0 + 1, lo1, hi1);
    offer_pair(c0, slab(lo0, hi0, ray), slab(lo1, hi1, ray));
  }
  t_out[r] = t_best;
  prim_out[r] = prim;
  u_out[r] = ub;
  v_out[r] = vb;
}

template <bool kAnyHit>
cudaError_t launch(const float4* nodes, const float4* tris, int depth,
                   int leaf_size, const float* o, const float* d,
                   const float* tmax, long long n, float* t, int* prim,
                   float* u, float* v, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((n + kThreads - 1) / kThreads);
  traverse_kernel<kAnyHit><<<blocks, kThreads, 0, stream>>>(
      nodes, tris, depth, leaf_size, o, d, tmax, n, t, prim, u, v);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers;
// nodes and tris must be 16-B aligned. Returns the cudaError_t of the
// launch (0 = success), or cudaErrorInvalidValue for a tree deeper than
// the stack holds.
extern "C" int traverse_launch(const float* nodes, const float* tris,
                               int depth, int leaf_size, const float* o,
                               const float* d, const float* tmax,
                               long long n, int any_hit, float* t,
                               int* prim, float* u, float* v, void* stream) {
  if (depth < 0 || depth > kMaxDepth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float4* nodes4 = reinterpret_cast<const float4*>(nodes);
  const float4* tris4 = reinterpret_cast<const float4*>(tris);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      any_hit ? launch<true>(nodes4, tris4, depth, leaf_size, o, d, tmax, n,
                             t, prim, u, v, s)
              : launch<false>(nodes4, tris4, depth, leaf_size, o, d, tmax,
                              n, t, prim, u, v, s);
  return static_cast<int>(e);
}

// The design constants this library was built with, and the stack entries
// of a launch on a tree of `depth`: out[0..2] = kThreads, kMaxDepth,
// stack_entries(depth).
extern "C" void traverse_constants(int depth, long long* out) {
  out[0] = kThreads;
  out[1] = kMaxDepth;
  out[2] = stack_entries(depth);
}

extern "C" const char* traverse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
