// The warp-level walk shared by K2 (cluster.cu) and K3 (sweep.cu): one warp
// of 32 rays walks a run of 128-triangle clusters on its own, with no block
// barrier, and tests each cluster some of its rays need in one of two lane
// mappings.
//
// What it replaces: a block-staged walk, in which a block of 128 rays voted
// with __syncthreads_or on every cluster, staged any cluster one ray needed,
// and let every needing lane walk the 128 rows while the rest of the block
// idled. On incoherent
// rays (the path's NEE shadow rays) most (warp, cluster) visits have a few
// needing lanes, so 97% of the lane-row tests issued for them belonged to
// lanes that did not need the cluster.
//
// The walk, per warp and run of clusters [first, last):
//   - __ballot_sync over the lanes' own slab tests decides which clusters
//     the warp visits; each lane's gate is its slab test at cluster entry
//     under its own t_best (the twins' per-ray contract).
//   - A visited cluster is copied into one of the warp's two shared slots
//     with cp.async (16 B per lane and plane, 5 KB); the next cluster that
//     passes the warp's vote under the current t_best loads into the other
//     slot while this one is tested. t_best only falls, so that vote is a
//     superset of the lanes that will pass at its entry, which is tested
//     again there. (On the H100, rows read through __ldg instead were
//     18-22% slower on closest queries and at most 11% faster on any-hit,
//     PERF.md.)
//   - Ray-parallel when more than kLoneMax lanes need the cluster: each
//     needing lane tests the 128 rows in order (the shared words are
//     broadcast).
//   - Triangle-parallel when kLoneMax or fewer do: for each needing lane
//     in turn, its ray and its t_best at entry are broadcast, lane l tests
//     rows l, l+32, l+64, l+96, and a 5-step butterfly reduces the lanes'
//     bests. Closest takes the lexicographic minimum of (t ascending, pid
//     descending, row ascending): the order the sequential scan prefers,
//     so the answer (u, v and the row included) is the scan's whatever
//     the order of reduction. Any-hit takes OR of the hits and the largest
//     pid. Min and max are exact, so the bits are the twin's.
//
// Numerics: built with --fmad=false and IEEE division, so every operation
// rounds once, in the twins' order (isect::slab, isect::mt_test).

#pragma once

#include <cuda_runtime.h>

#include "triangle.cuh"

namespace walk {

constexpr int kCluster = 128;  // triangles per cluster
constexpr int kWarp = 32;
constexpr int kRowsPerLane = kCluster / kWarp;
constexpr int kPlanes = 10;  // v0x v0y v0z e1x e1y e1z e2x e2y e2z pid
constexpr int kWarps = 4;    // warps per block
constexpr int kThreads = kWarps * kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3e38f;  // a tested cluster's t without a hit

// A (warp, cluster) visit with at most this many needing lanes is tested
// triangle-parallel, above it ray-parallel (a measured sweep on the H100,
// PERF.md).
constexpr int kLoneMax = 16;

static_assert(kCluster % kWarp == 0, "rows split evenly over the lanes");
static_assert(kCluster == 4 * kWarp, "staging copies 16 B per lane and plane");

// The triangle planes of a cluster table, (C, 128) each, in kPlanes order.
struct Planes {
  const float* p[kPlanes];
};

// One warp's staged cluster: [plane][row]. A block holds two per warp.
using Slot = float[kPlanes][kCluster];

// A lane's best hit so far.
struct Best {
  float t;     // t_best: gates every slab and row test
  float prim;  // pid + 1 of the best hit, 0 = none
  float u, v;  // closest mode with attributes
  int slot;    // cluster * 128 + row of the best hit, -1 = none
  int tag;     // the caller's tag of the walk that found it (K3: instance + 1)
};

// The ray the triangle test uses (object space in K3).
struct ObjRay {
  float ox, oy, oz, dx, dy, dz;
};

// isect::mt_test against row j of a staged cluster.
__device__ __forceinline__ bool row_test(const Slot& rows, int j,
                                         const ObjRay& r, float tb, float& t,
                                         float& u, float& v) {
  return isect::mt_test(rows[0][j], rows[1][j], rows[2][j], rows[3][j],
                        rows[4][j], rows[5][j], rows[6][j], rows[7][j],
                        rows[8][j], r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, tb, t,
                        u, v);
}

// The sequential scan's preference: t ascending, then pid descending, then
// row ascending (the scan keeps the earlier row of an exact tie).
__device__ __forceinline__ bool before(float ta, float pa, int ja, float tb,
                                       float pb, int jb) {
  return ta < tb || (ta == tb && (pa > pb || (pa == pb && ja < jb)));
}

// Commit one cluster's result at lane level, as the twins do.
template <bool kAnyHit, bool kAttrs>
__device__ __forceinline__ void commit(bool got, float bt, float bp, float bu,
                                       float bv, int bj, int c, int tag,
                                       Best& best) {
  if (kAnyHit) {
    if (got) {
      best.t = 0.0f;  // no later gate passes
      best.prim = bp;
      best.tag = tag;
    }
  } else if (bt < best.t) {
    best.t = bt;
    best.prim = bp;
    best.tag = tag;
    if (kAttrs) {
      best.u = bu;
      best.v = bv;
      best.slot = bj < 0 ? -1 : c * kCluster + bj;
    }
  }
}

// Ray-parallel: a needing lane tests the 128 rows in order.
template <bool kAnyHit, bool kAttrs>
__device__ __forceinline__ void ray_parallel(const Slot& rows, bool live,
                                             const ObjRay& r, int c, int tag,
                                             Best& best) {
  if (!live) return;
  const float tb = best.t;  // t_best at cluster entry gates every row
  float bt = kBig, bp = 0.0f, bu = 0.0f, bv = 0.0f;
  int bj = -1;
  bool got = false;
  for (int j = 0; j < kCluster; ++j) {
    float tk, u, v;
    const bool hit = row_test(rows, j, r, tb, tk, u, v);
    const float pid = rows[9][j];
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
  commit<kAnyHit, kAttrs>(got, bt, bp, bu, bv, bj, c, tag, best);
}

// Triangle-parallel: the warp tests the cluster for each needing lane in
// turn, 4 rows a lane, and reduces across the lanes.
template <bool kAnyHit, bool kAttrs>
__device__ __forceinline__ void triangle_parallel(const Slot& rows,
                                                  unsigned need,
                                                  const ObjRay& r, int lane,
                                                  int c, int tag, Best& best) {
  while (need) {
    const int src = __ffs(need) - 1;
    need &= need - 1;
    const ObjRay s{__shfl_sync(kFull, r.ox, src), __shfl_sync(kFull, r.oy, src),
                   __shfl_sync(kFull, r.oz, src), __shfl_sync(kFull, r.dx, src),
                   __shfl_sync(kFull, r.dy, src), __shfl_sync(kFull, r.dz, src)};
    const float tb = __shfl_sync(kFull, best.t, src);
    float bt = kBig, bp = 0.0f, bu = 0.0f, bv = 0.0f;
    int bj = -1;
    bool got = false;
#pragma unroll
    for (int m = 0; m < kRowsPerLane; ++m) {
      const int j = lane + kWarp * m;
      float tk, u, v;
      const bool hit = row_test(rows, j, s, tb, tk, u, v);
      const float pid = rows[9][j];
      if (!hit) continue;
      if (kAnyHit) {
        got = true;
        bp = fmaxf(bp, pid);
      } else if (before(tk, pid, j, bt, bp, bj)) {
        bt = tk;
        bp = pid;
        bu = u;
        bv = v;
        bj = j;
      }
    }
    if (kAnyHit) {
      got = __any_sync(kFull, got);
      // pid + 1 >= 0: the float's bits order as its value.
      bp = __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(bp)));
    } else {
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(kFull, bt, off);
        const float op = __shfl_xor_sync(kFull, bp, off);
        const int oj = __shfl_xor_sync(kFull, bj, off);
        float ou = 0.0f, ov = 0.0f;
        if (kAttrs) {
          ou = __shfl_xor_sync(kFull, bu, off);
          ov = __shfl_xor_sync(kFull, bv, off);
        }
        if (before(ot, op, oj, bt, bp, bj)) {
          bt = ot;
          bp = op;
          bj = oj;
          bu = ou;
          bv = ov;
        }
      }
    }
    if (lane == src) commit<kAnyHit, kAttrs>(got, bt, bp, bu, bv, bj, c, tag, best);
  }
}

// Test one cluster the warp visits; `need` is the ballot of `live`.
template <bool kAnyHit, bool kAttrs>
__device__ __forceinline__ void visit(const Slot& rows, unsigned need,
                                      bool live, const ObjRay& r, int lane,
                                      int c, int tag, Best& best) {
  if (__popc(need) > kLoneMax) {
    ray_parallel<kAnyHit, kAttrs>(rows, live, r, c, tag, best);
  } else {
    triangle_parallel<kAnyHit, kAttrs>(rows, need, r, lane, c, tag, best);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

// Start copying cluster c into `slot`, one 16 B piece per lane and plane,
// as one cp.async group.
__device__ __forceinline__ void stage(Slot& slot, const Planes& tri, int c,
                                      int lane) {
#pragma unroll
  for (int k = 0; k < kPlanes; ++k) {
    cp_async16(&slot[k][4 * lane], tri.p[k] + c * kCluster + 4 * lane);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Walk clusters [first, last) in order. `alive` is the lane's gate for the
// whole run (K2: its super test, K3: its instance test), `box_ray` the ray
// of the slab tests and `r` that of the triangle tests. `slots` are this
// warp's two staging slots. Every lane of the warp calls it together.
template <bool kAnyHit, bool kAttrs>
__device__ __forceinline__ void walk_clusters(
    const Planes& tri, const float* __restrict__ boxes, Slot* slots, int lane,
    int first, int last, bool alive, const isect::Ray& box_ray,
    const ObjRay& r, int tag, Best& best) {
  auto passes = [&](int c) {
    return alive && isect::slab(boxes + 8 * c, box_ray, best.t);
  };
  // The first cluster at or after c that some lane passes now.
  auto next_needed = [&](int c) {
    while (c < last && !__any_sync(kFull, passes(c))) ++c;
    return c;
  };
  int c = next_needed(first);
  if (c >= last) return;
  int buf = 0;
  stage(slots[buf], tri, c, lane);
  while (c < last) {
    const int cn = next_needed(c + 1);
    if (cn < last) {
      stage(slots[buf ^ 1], tri, cn, lane);
      stage_wait<1>();
    } else {
      stage_wait<0>();
    }
    __syncwarp();  // every lane's pieces of slot buf have landed
    const bool live = passes(c);
    const unsigned need = __ballot_sync(kFull, live);
    if (need) {
      visit<kAnyHit, kAttrs>(slots[buf], need, live, r, lane, c, tag, best);
    }
    __syncwarp();  // every lane is done with slot buf before its refill
    buf ^= 1;
    c = cn;
  }
}

}  // namespace walk
