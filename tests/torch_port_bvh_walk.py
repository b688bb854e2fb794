"""A plain CPU model of K4's walk (pbrt_tpu_torch/csrc/traverse.cu), held
bit for bit to the twin `bvh_intersect_ref` by tests/test_torch_bvh_walk.py.

What it models, per ray, in lockstep over the rays whose stacks are not
empty (as the twin runs):
  - rows read from the packed tables `BVH.nodes` (n_nodes, 8) and
    `BVH.tris` (P, 12), the prim id from the bits of column 9;
  - the root tested on entry; children culled when they are pushed: a
    child goes on the stack, with its tmin, only if its full slab test
    passes now, far child first; a pop checks tmin < t_best alone.
The kernel also keeps the last child a step pushes in registers instead
of pushing and popping it; that changes no order, so the model pushes it.

The slab and Moller-Trumbore arithmetic are the twin's, operation for
operation.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.accel.bvh import BVH, inv_dir
from pbrt_tpu_torch.scenes.meshes import fbm_blob

_EPS = 1e-12


def stack_entries(depth: int) -> int:
    """The kernel's stack_entries(depth): the most entries its stack
    holds for a tree of `depth`."""
    return depth + 2


def unpack(bvh: BVH) -> dict:
    """The reference tables read back out of the packed rows."""
    nodes, tris = bvh.nodes, bvh.tris
    return {"node_lo": nodes[:, 0:3], "node_hi": nodes[:, 4:7],
            "v0": tris[:, 0:3], "e1": tris[:, 3:6], "e2": tris[:, 6:9],
            "prim_id": tris[:, 9].contiguous().view(torch.int32)}


def _slab(nodes, node, ray):
    """(tmin, tmax, not empty) of the rays against rows `node`: the twin's
    _slab on the packed rows."""
    ox, oy, oz, ix, iy, iz = ray
    row = nodes[node]
    lox, loy, loz, hix, hiy, hiz = (row[:, c] for c in (0, 1, 2, 4, 5, 6))
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


def _passes(box):
    tmin, tmx, full = box
    return full & (tmx >= torch.clamp(tmin, min=0.0))


def _pair(a, ba, bb):
    """The sibling pair (a, a + 1) in push order, far first: a is near when
    its clamped entry distance is <= that of a + 1."""
    near_a = torch.clamp(ba[0], min=0.0) <= torch.clamp(bb[0], min=0.0)

    def pick(x, y):
        return tuple(torch.where(near_a, p, q) for p, q in zip(x, y))

    return [(torch.where(near_a, a + 1, a), pick(bb, ba)),
            (torch.where(near_a, a, a + 1), pick(ba, bb))]


def walk(bvh: BVH, o, d, tmax, any_hit: bool = False,
         stats: dict | None = None):
    """(t, prim, u, v) as bvh_intersect_ref gives them. `stats`, when
    given, receives the walk's counts: "pops", "steps" (inner visits),
    "leaves" and "max_stack" (most entries on any ray's stack)."""
    n = o.shape[0]
    dev = o.device
    ox, oy, oz = (o[:, i].contiguous() for i in range(3))
    dx, dy, dz = (d[:, i].contiguous() for i in range(3))
    ix, iy, iz = inv_dir(dx), inv_dir(dy), inv_dir(dz)
    nodes, tris = bvh.nodes, bvh.tris
    tri = [tris[:, c].contiguous() for c in range(9)]
    pid = tris[:, 9].contiguous().view(torch.int32)
    first_leaf = bvh.first_leaf
    t_best = tmax.clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ub = torch.zeros((n,), dtype=torch.float32, device=dev)
    vb = torch.zeros((n,), dtype=torch.float32, device=dev)
    size = stack_entries(bvh.depth)
    st_node = torch.zeros((n, size), dtype=torch.int64, device=dev)
    st_tmin = torch.zeros((n, size), dtype=torch.float32, device=dev)
    sp = torch.zeros((n,), dtype=torch.int64, device=dev)
    count = {"pops": 0, "steps": 0, "leaves": 0, "max_stack": 0}

    def push(rows, candidates):
        # Candidates in push order; each goes on if it passes now.
        for node, box in candidates:
            ok = _passes(box) & (box[0] < t_best[rows])
            r = rows[ok]
            st_node[r, sp[r]] = node[ok]
            st_tmin[r, sp[r]] = box[0][ok]
            sp[r] += 1
        if rows.numel():
            count["max_stack"] = max(count["max_stack"], int(sp[rows].max()))

    every = torch.arange(n, device=dev)
    ray_all = (ox, oy, oz, ix, iy, iz)
    root = torch.zeros_like(every)
    push(every, [(root, _slab(nodes, root, ray_all))])  # tested on entry
    a = every[sp > 0]
    while a.numel():
        s = sp[a] - 1
        node = st_node[a, s]
        go = st_tmin[a, s] < t_best[a]
        sp[a] = s
        count["pops"] += a.numel()
        leaf = go & (node >= first_leaf)
        inner = go & (node < first_leaf)

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
            count["leaves"] += lr.numel()

        pn = node[inner]
        count["steps"] += pn.numel()
        rows = a[inner]
        if rows.numel():
            ray = [x[rows] for x in ray_all]
            c = 2 * pn + 1
            push(rows, _pair(c, _slab(nodes, c, ray),
                             _slab(nodes, c + 1, ray)))

        a = a[sp[a] > 0]
        if any_hit:
            # A confirmed hit ends the ray (the kernel breaks after the leaf).
            a = a[prim[a] < 0]
    if stats is not None:
        stats.update(count)
    return t_best, prim, ub, vb


# The cases of tests/test_torch_bvh_walk.py (model vs twin) and of
# tests/test_torch_cuda.py (kernel vs twin).

def _grid_tris(n_side, step, z):
    """Two triangles per cell of an n_side x n_side grid of quads at pitch
    `step` (coordinates exact in float32), at height z per cell."""
    g = np.arange(n_side, dtype=np.float32) * np.float32(step)
    x0, y0 = (a.ravel() for a in np.meshgrid(g, g))
    zc = np.broadcast_to(np.float32(z), x0.shape) if np.isscalar(z) else z
    q = [np.stack([x0, y0, zc], 1), np.stack([x0 + step, y0, zc], 1),
         np.stack([x0 + step, y0 + step, zc], 1),
         np.stack([x0, y0 + step, zc], 1)]
    return np.concatenate([np.stack([q[0], q[1], q[2]], 1),
                           np.stack([q[0], q[2], q[3]], 1)]).astype(np.float32)


def _random_tris(n, seed):
    r = np.random.default_rng(seed)
    return (r.uniform(-0.3, 0.3, (n, 3, 3))
            + r.uniform(-1.0, 1.0, (n, 1, 3))).astype(np.float32)


def _box_rays(tris, n, seed, dead_every=7):
    """n rays from around the mesh's box: random directions, every
    eleventh axis-parallel, every thirteenth a finite segment, every
    `dead_every`-th dead (tmax = 0)."""
    r = np.random.default_rng(seed)
    lo, hi = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
    o = lo + (hi - lo) * r.uniform(-0.2, 1.2, (n, 3))
    d = r.normal(size=(n, 3))
    d[::11] = np.eye(3)[r.integers(0, 3, len(d[::11]))] * r.choice(
        [-1.0, 1.0], (len(d[::11]), 1))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n, np.inf)
    tmax[::13] = r.uniform(0.0, 1.0, len(tmax[::13])) * np.linalg.norm(hi - lo)
    tmax[::dead_every] = 0.0
    return o, d, tmax


def walk_case(name):
    """(triangles, (o, d, tmax)) of one case."""
    if name == "depth0":
        tris = _random_tris(3, 0)
    elif name == "depth1":
        tris = _random_tris(7, 1)
    elif name == "depth4":
        tris = _random_tris(61, 2)
    elif name == "depth5":
        tris = _random_tris(100, 3)
    elif name == "coplanar_ties":
        # Three bit-equal copies of each triangle (prim ids 3i .. 3i + 2):
        # Morton-adjacent, so copies straddle leaves of 4 and tie on t
        # exactly; the first tested keeps the hit.
        tris = np.repeat(_grid_tris(6, 0.25, np.float32(0.5)), 3, axis=0)
        r = np.random.default_rng(4)
        n = 1024
        o = np.concatenate([r.uniform(0.0, 1.5, (n, 2)),
                            np.full((n, 1), -1.0)], 1)
        d = np.concatenate([r.normal(scale=0.2, size=(n, 2)),
                            np.ones((n, 1))], 1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return tris, (o, d, np.full(n, np.inf))
    elif name == "box_faces":
        # Cells at heights on a 1/4 grid, so box faces lie on grid planes;
        # rays start on such a plane and run inside it (one direction
        # component exactly 0).
        r = np.random.default_rng(5)
        z = (r.integers(0, 4, 64) * 0.25).astype(np.float32)
        tris = _grid_tris(8, 0.25, z)
        n = 1024
        o = r.integers(0, 9, (n, 3)).astype(np.float64) * 0.25
        o[:, 2] = r.integers(0, 4, n) * 0.25
        d = r.normal(size=(n, 3))
        axis = r.integers(0, 3, n)
        d[np.arange(n), axis] = 0.0
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return tris, (o, d, np.full(n, np.inf))
    elif name == "dead_lanes":
        # Every lane dead (tmax = 0), most from inside the root box, so
        # the root passes (tmin < 0) and the walk runs with t_best = 0.
        tris = fbm_blob(3)
        o, d, _ = _box_rays(tris, 1024, 6)
        return tris, (o, d, np.zeros(1024))
    else:
        raise ValueError(f"unknown case {name!r}")
    return tris, _box_rays(tris, 2048, 7)


CASES = ("depth0", "depth1", "depth4", "depth5", "coplanar_ties",
         "box_faces", "dead_lanes")
DEPTHS = {"depth0": 0, "depth1": 1, "depth4": 4, "depth5": 5}
