"""Implicit-heap BVH (port of pbrt_tpu/accel/bvh.py): the Morton order of
triangle centroids, the host build and `bvh_intersect_ref`, the plain
PyTorch twin of kernel K4 (`pbrt_tpu_torch/csrc/traverse.cu`, launched by
`ops/traverse.py`).

The build is the reference's numpy code: triangles in Morton order, packed
`leaf_size` to a leaf over a complete binary tree of 2^depth leaves in
heap layout (the children of node i are 2i+1 and 2i+2), padded with
degenerate triangles at 1e30 that carry prim id -1. The reference may sort
with its native C++ radix sort (native/accel_build.cpp), which it
documents as bit-identical to the numpy rule the port keeps.

Traversal contract (the reference's `bvh_intersect`, per ray):
  - inv_d = 1 / where(|d| < 1e-12, 1e-12, d); the root is on the stack.
  - Pop a node. Its slab test passes when tmax >= max(tmin, 0) and
    tmin < t_best, with tmin the largest and tmax the smallest of the
    per-axis entry and exit distances (no clamp inside).
  - A leaf tests its leaf_size triangles in order with Moller-Trumbore:
    a hit needs |det| > 1e-12, u >= 0, v >= 0, u + v <= 1, 0 < t < t_best
    (t_best as updated by the leaf's earlier triangles) and prim id >= 0.
  - An inner node pushes both children near-first: the far one first,
    then the near one, where child 2i+1 is near when its clamped entry
    distance max(tmin, 0) is <= that of 2i+2.
  - Any-hit mode drains the stack at the first hit.
  - Returns (t, prim, u, v): t_best (tmax on a miss), prim -1 and u, v 0
    on a miss.
One rule is the port's own: a node whose box is empty (lo > hi, the
+inf/-inf boxes over padding) fails its test. In the reference such a
box passes every slab test (each axis spans (-inf, inf)), so every ray
walks the whole padding subtree, which holds only prim -1 slots: the rule
removes that work and changes no result (tests/test_torch_bvh.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.tensorclass import static_field, tensorclass

_EPS = 1e-12


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit coords -> 30-bit Morton codes. x: (n, 3) in [0,1)."""
    q = np.clip((x * 1024.0).astype(np.uint32), 0, 1023).astype(np.uint64)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return (
        spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
        | (spread(q[:, 2]) << np.uint64(2))
    )


def morton_order(cent: np.ndarray) -> np.ndarray:
    """Stable ascending-Morton permutation of (n, 3) float32 centroids."""
    lo = cent.min(axis=0)
    hi = cent.max(axis=0)
    norm = (cent - lo) / np.maximum(hi - lo, 1e-12)
    return np.argsort(_morton3(norm), kind="stable")


@tensorclass
class BVH:
    # Complete binary tree over 2^depth leaves, heap layout: (n_nodes, 3).
    node_lo: torch.Tensor
    node_hi: torch.Tensor
    # Morton-ordered triangles, leaf_size per leaf, padded: (P, 3) each.
    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    prim_id: torch.Tensor  # (P,) int32 original triangle index or -1
    depth: int = static_field(default=0)
    leaf_size: int = static_field(default=4)
    # K4's packed rows, derived from the tables above whenever a BVH is
    # made (built, replaced or moved; the twin reads the tables): nodes
    # (n_nodes, 8) f32 [lo.xyz, 0, hi.xyz, 0], 32 B a node; tris (P, 12)
    # f32 [v0, e1, e2, prim-id bits, 0, 0], 48 B a triangle, the prim id's
    # int32 bits stored as a float. Never passed in, so they cannot
    # disagree with the tables.
    nodes: torch.Tensor = dataclasses.field(init=False, repr=False)
    tris: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        nodes, tris = pack_rows(self)
        object.__setattr__(self, "nodes", nodes)
        object.__setattr__(self, "tris", tris)

    @property
    def first_leaf(self) -> int:
        return (1 << self.depth) - 1


def pack_rows(bvh: BVH) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's (n_nodes, 8) node rows and (P, 12) triangle rows from the
    reference tables, bit for bit (BVH.nodes, BVH.tris)."""
    lo, hi = bvh.node_lo, bvh.node_hi
    zn = torch.zeros((lo.shape[0], 1), dtype=torch.float32, device=lo.device)
    nodes = torch.cat([lo, zn, hi, zn], dim=1)
    pid = bvh.prim_id.contiguous().view(torch.float32)[:, None]
    zt = torch.zeros((pid.shape[0], 2), dtype=torch.float32, device=pid.device)
    tris = torch.cat([bvh.v0, bvh.e1, bvh.e2, pid, zt], dim=1)
    return nodes.contiguous(), tris.contiguous()


def build_bvh(tri_verts, leaf_size: int = 4) -> BVH:
    """Host build: Morton-sort triangles, pack into a complete implicit tree
    (the reference's numpy code, so its tables are bit-equal)."""
    tri_verts = np.asarray(tri_verts, np.float32)
    t = tri_verts.shape[0]
    cent = tri_verts.mean(axis=1)
    order = morton_order(cent)
    sorted_tris = tri_verts[order]

    n_leaves_needed = max(1, -(-t // leaf_size))
    depth = max(0, int(np.ceil(np.log2(n_leaves_needed))))
    n_leaves = 1 << depth
    p = n_leaves * leaf_size

    v = np.full((p, 3, 3), 1e30, np.float32)
    v[:t] = sorted_tris
    prim_id = np.full((p,), -1, np.int64)
    prim_id[:t] = order

    leaf_v = v.reshape(n_leaves, leaf_size, 3, 3)
    real = (prim_id.reshape(n_leaves, leaf_size) >= 0)[..., None, None]
    inf = np.float32(np.inf)
    leaf_lo = np.where(real, leaf_v, inf).min(axis=(1, 2))
    leaf_hi = np.where(real, leaf_v, -inf).max(axis=(1, 2))

    n_nodes = 2 * n_leaves - 1
    node_lo = np.full((n_nodes, 3), inf, np.float32)
    node_hi = np.full((n_nodes, 3), -inf, np.float32)
    first_leaf = n_leaves - 1
    node_lo[first_leaf:] = leaf_lo
    node_hi[first_leaf:] = leaf_hi
    for level in range(depth - 1, -1, -1):
        s = (1 << level) - 1
        e = (1 << (level + 1)) - 1
        left = 2 * np.arange(s, e) + 1
        node_lo[s:e] = np.minimum(node_lo[left], node_lo[left + 1])
        node_hi[s:e] = np.maximum(node_hi[left], node_hi[left + 1])

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    return BVH(
        node_lo=f32(node_lo), node_hi=f32(node_hi),
        v0=f32(v[:, 0]), e1=f32(v[:, 1] - v[:, 0]), e2=f32(v[:, 2] - v[:, 0]),
        prim_id=torch.from_numpy(prim_id.astype(np.int32)),
        depth=depth, leaf_size=leaf_size,
    )


def inv_dir(x):
    return 1.0 / torch.where(torch.abs(x) < _EPS, _EPS, x)


def _slab(cols, node, ox, oy, oz, ix, iy, iz):
    """(tmin, tmax) of the rays against the boxes of `node`: the largest
    per-axis entry and the smallest per-axis exit distance."""
    lox, loy, loz, hix, hiy, hiz = (c[node] for c in cols)
    tx0 = (lox - ox) * ix
    tx1 = (hix - ox) * ix
    ty0 = (loy - oy) * iy
    ty1 = (hiy - oy) * iy
    tz0 = (loz - oz) * iz
    tz1 = (hiz - oz) * iz
    tmin = torch.maximum(
        torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
        torch.minimum(tz0, tz1))
    tmx = torch.minimum(
        torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
        torch.maximum(tz0, tz1))
    return tmin, tmx, lox <= hix


def bvh_intersect_ref(bvh: BVH, o, d, tmax, any_hit: bool = False,
                      counts: dict | None = None):
    """Plain PyTorch twin of K4: every ray's stack walk, run in lockstep
    over the rays whose stacks are not empty, in the kernel's operation
    order. `counts`, when given, accumulates the work the kernel does for
    its bound: "nodes" (slab tests of popped nodes), "entries" (children's
    entry distances) and "tris" (leaf triangle tests)."""
    n = o.shape[0]
    dev = o.device
    ox, oy, oz = (o[:, i].contiguous() for i in range(3))
    dx, dy, dz = (d[:, i].contiguous() for i in range(3))
    ix, iy, iz = inv_dir(dx), inv_dir(dy), inv_dir(dz)
    cols = [bvh.node_lo[:, i].contiguous() for i in range(3)] + [
        bvh.node_hi[:, i].contiguous() for i in range(3)]
    tri = [x[:, i].contiguous() for x in (bvh.v0, bvh.e1, bvh.e2)
           for i in range(3)]
    pid = bvh.prim_id
    first_leaf = bvh.first_leaf
    t_best = tmax.clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ub = torch.zeros((n,), dtype=torch.float32, device=dev)
    vb = torch.zeros((n,), dtype=torch.float32, device=dev)
    stack = torch.zeros((n, bvh.depth + 2), dtype=torch.int64, device=dev)
    sp = torch.ones((n,), dtype=torch.int64, device=dev)
    work = {"nodes": 0, "entries": 0, "tris": 0}
    a = torch.arange(n, device=dev)
    while a.numel():
        s = sp[a] - 1
        node = stack[a, s]
        sp[a] = s
        ray = [x[a] for x in (ox, oy, oz, ix, iy, iz)]
        tmin, tmx, full = _slab(cols, node, *ray)
        hit = full & (tmx >= torch.clamp(tmin, min=0.0)) & (tmin < t_best[a])
        work["nodes"] += a.numel()
        leaf = hit & (node >= first_leaf)
        inner = hit & (node < first_leaf)

        lr = a[leaf]
        if lr.numel():
            base = (node[leaf] - first_leaf) * bvh.leaf_size
            rox, roy, roz, rdx, rdy, rdz = (
                x[lr] for x in (ox, oy, oz, dx, dy, dz))
            tb, pb, u_b, v_b = t_best[lr], prim[lr], ub[lr], vb[lr]
            for k in range(bvh.leaf_size):
                j = base + k
                v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
                    c[j] for c in tri)
                px = rdy * e2z - rdz * e2y
                py = rdz * e2x - rdx * e2z
                pz = rdx * e2y - rdy * e2x
                det = e1x * px + e1y * py + e1z * pz
                ok = torch.abs(det) > _EPS
                inv_det = torch.where(ok, 1.0 / det, 0.0)
                tvx = rox - v0x
                tvy = roy - v0y
                tvz = roz - v0z
                uk = (tvx * px + tvy * py + tvz * pz) * inv_det
                qx = tvy * e1z - tvz * e1y
                qy = tvz * e1x - tvx * e1z
                qz = tvx * e1y - tvy * e1x
                vk = (rdx * qx + rdy * qy + rdz * qz) * inv_det
                tk = (e2x * qx + e2y * qy + e2z * qz) * inv_det
                pk = pid[j]
                got = (ok & (uk >= 0.0) & (vk >= 0.0) & (uk + vk <= 1.0)
                       & (tk > 0.0) & (tk < tb) & (pk >= 0))
                tb = torch.where(got, tk, tb)
                pb = torch.where(got, pk, pb)
                u_b = torch.where(got, uk, u_b)
                v_b = torch.where(got, vk, v_b)
            t_best[lr], prim[lr], ub[lr], vb[lr] = tb, pb, u_b, v_b
            work["tris"] += lr.numel() * bvh.leaf_size

        ir = a[inner]
        if ir.numel():
            pn = node[inner]
            rin = [x[inner] for x in ray]
            c0 = 2 * pn + 1
            t0 = torch.clamp(_slab(cols, c0, *rin)[0], min=0.0)
            t1 = torch.clamp(_slab(cols, c0 + 1, *rin)[0], min=0.0)
            near_is_0 = t0 <= t1
            near = torch.where(near_is_0, c0, c0 + 1)
            far = torch.where(near_is_0, c0 + 1, c0)
            si = sp[ir]
            stack[ir, si] = far
            stack[ir, si + 1] = near
            sp[ir] = si + 2
            work["entries"] += 2 * ir.numel()

        a = a[sp[a] > 0]
        if any_hit:
            # A confirmed hit ends the ray: its stack is drained.
            a = a[prim[a] < 0]
    if counts is not None:
        for key, value in work.items():
            counts[key] = counts.get(key, 0) + value
    return t_best, prim, ub, vb
