"""SAH kd-tree aggregate (port of pbrt_tpu/accel/kdtree.py).

Reference analogue: KdTreeAggregate (cpu/aggregates.h:131), pbrt's second
aggregate beside the BVH. The build is the reference's host code (numpy
and recursive Python, SAH over sorted bound edges with traversal cost 1,
intersection cost 5 and the empty-space bonus), copied so the node arrays
are equal. The reference has no kernel for the traversal: its
`kdtree_intersect` is a per-ray while loop with a 64-entry (node, tmin,
tmax) todo stack under vmap. `kdtree_intersect` here runs the same walk in
plain PyTorch, in lockstep over the rays still walking, on either device:
a parity tier for small scenes, as in the reference (the SAH build is not
meant for 10^5 triangles).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..core.tensorclass import static_field, tensorclass

_STACK = 64
_INF = float("inf")

# Build-time cost model (aggregates.cpp KdTreeAggregate ctor defaults).
_ISECT_COST = 5.0
_TRAV_COST = 1.0
_EMPTY_BONUS = 0.5


@tensorclass
class KdTree:
    # Node SoA: axis (0/1/2, 3 == leaf), split position, above-child index
    # (the below child is node + 1, depth-first), leaf prim offset/count
    # into prim_indices.
    axis: torch.Tensor          # (M,) int32
    split: torch.Tensor         # (M,) float32
    above: torch.Tensor         # (M,) int32
    prim_off: torch.Tensor      # (M,) int32
    prim_cnt: torch.Tensor      # (M,) int32
    prim_indices: torch.Tensor  # (K,) int32 triangle ids
    tri_verts: torch.Tensor     # (T, 3, 3)
    bounds_lo: torch.Tensor     # (3,)
    bounds_hi: torch.Tensor     # (3,)
    n_nodes: int = static_field(default=0)


def build_kdtree(tri_verts, max_prims: int = 4,
                 max_depth: int | None = None) -> KdTree:
    """Host-side SAH build (KdTreeAggregate::BuildTree, aggregates.cpp:830);
    the reference's code. tri_verts: (T, 3, 3) float32."""
    tv = np.asarray(tri_verts, np.float32)
    n_tri = tv.shape[0]
    lo_all = tv.min(axis=1)  # (T, 3)
    hi_all = tv.max(axis=1)
    bounds_lo = lo_all.min(axis=0) if n_tri else np.zeros(3, np.float32)
    bounds_hi = hi_all.max(axis=0) if n_tri else np.ones(3, np.float32)
    if max_depth is None:
        # Reference heuristic: 8 + 1.3 log2(N) (aggregates.cpp:789).
        max_depth = int(round(8 + 1.3 * np.log2(max(n_tri, 1) + 1)))

    axis_l, split_l, above_l, off_l, cnt_l = [], [], [], [], []
    prim_indices: list[int] = []

    def add_leaf(prims):
        axis_l.append(3)
        split_l.append(0.0)
        above_l.append(0)
        off_l.append(len(prim_indices))
        cnt_l.append(len(prims))
        prim_indices.extend(int(p) for p in prims)

    def rec(prims, nlo, nhi, depth, bad_refines):
        node_id = len(axis_l)
        if len(prims) <= max_prims or depth == 0:
            add_leaf(prims)
            return node_id
        # SAH over bound edges on each axis (aggregates.cpp:857-929).
        d = nhi - nlo
        inv_total_sa = 1.0 / max(
            2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]), 1e-20
        )
        old_cost = _ISECT_COST * len(prims)
        best = (None, None, np.inf)  # (axis, split_t, cost)
        p_lo = lo_all[prims]
        p_hi = hi_all[prims]
        for ax in np.argsort(-d):  # try widest axis first
            ax = int(ax)
            starts = p_lo[:, ax]
            ends = p_hi[:, ax]
            pos = np.concatenate([starts, ends])
            kind = np.concatenate(
                [np.zeros(len(prims)), np.ones(len(prims))]
            )  # 0 = start, 1 = end
            order = np.lexsort((kind, pos))
            pos, kind = pos[order], kind[order]
            n_below, n_above = 0, len(prims)
            o_ax = [a for a in range(3) if a != ax]
            for i in range(len(pos)):
                if kind[i] == 1:
                    n_above -= 1
                pt = pos[i]
                if nlo[ax] < pt < nhi[ax]:
                    d0, d1 = d[o_ax[0]], d[o_ax[1]]
                    below_sa = 2.0 * (
                        d0 * d1 + (pt - nlo[ax]) * (d0 + d1)
                    )
                    above_sa = 2.0 * (
                        d0 * d1 + (nhi[ax] - pt) * (d0 + d1)
                    )
                    pb = below_sa * inv_total_sa
                    pa = above_sa * inv_total_sa
                    eb = _EMPTY_BONUS if (n_above == 0 or n_below == 0) else 0.0
                    cost = (
                        _TRAV_COST
                        + _ISECT_COST * (1.0 - eb)
                        * (pb * n_below + pa * n_above)
                    )
                    if cost < best[2]:
                        best = (ax, pt, cost)
                if kind[i] == 0:
                    n_below += 1
            if best[0] is not None:
                break  # reference retries other axes only when none found
        if best[0] is None or (
            best[2] > 4.0 * old_cost and len(prims) < 16
        ):
            add_leaf(prims)
            return node_id
        if best[2] > old_cost:
            bad_refines += 1
            if bad_refines == 3:
                add_leaf(prims)
                return node_id
        ax, pt, _ = best
        below = [p for p in prims if lo_all[p][ax] < pt]
        above = [p for p in prims if hi_all[p][ax] > pt]
        # Straddlers land on both sides; flat-on-plane prims go above.
        below += [p for p in prims if lo_all[p][ax] == pt == hi_all[p][ax]
                  and p not in below]
        # Interior node placeholder; children fill in depth-first order.
        axis_l.append(int(ax))
        split_l.append(float(pt))
        above_l.append(0)
        off_l.append(0)
        cnt_l.append(0)
        hi_b = nhi.copy()
        hi_b[ax] = pt
        rec(below, nlo, hi_b, depth - 1, bad_refines)
        lo_a = nlo.copy()
        lo_a[ax] = pt
        above_l[node_id] = len(axis_l)
        rec(above, lo_a, nhi, depth - 1, bad_refines)
        return node_id

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        rec(list(range(n_tri)), bounds_lo.copy(), bounds_hi.copy(),
            max_depth, 0)
    finally:
        sys.setrecursionlimit(old_limit)

    def i32(a):
        return torch.tensor(a, dtype=torch.int32)

    return KdTree(
        axis=i32(axis_l),
        split=torch.tensor(split_l, dtype=torch.float32),
        above=i32(above_l),
        prim_off=i32(off_l),
        prim_cnt=i32(cnt_l),
        prim_indices=i32(prim_indices if prim_indices else [0]),
        tri_verts=torch.from_numpy(
            np.array(tv if n_tri else np.zeros((1, 3, 3)), np.float32)),
        bounds_lo=torch.from_numpy(np.array(bounds_lo, np.float32)),
        bounds_hi=torch.from_numpy(np.array(bounds_hi, np.float32)),
        n_nodes=len(axis_l),
    )


def _tri_hit(tv, o, d):
    """Moller-Trumbore of rays (k, 3) against their triangles tv (k, 3, 3),
    edges from the vertices; (t, u, v) with t = inf on a miss."""
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    px = dy * e2[:, 2] - dz * e2[:, 1]
    py = dz * e2[:, 0] - dx * e2[:, 2]
    pz = dx * e2[:, 1] - dy * e2[:, 0]
    det = e1[:, 0] * px + e1[:, 1] * py + e1[:, 2] * pz
    inv = torch.where(torch.abs(det) < 1e-12, 0.0, 1.0 / det)
    tvec = o - tv[:, 0]
    tx, ty, tz = tvec[:, 0], tvec[:, 1], tvec[:, 2]
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1[:, 2] - tz * e1[:, 1]
    qy = tz * e1[:, 0] - tx * e1[:, 2]
    qz = tx * e1[:, 1] - ty * e1[:, 0]
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2[:, 0] * qx + e2[:, 1] * qy + e2[:, 2] * qz) * inv
    ok = (inv != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-6)
    return torch.where(ok, t, _INF), u, v


def kdtree_intersect(kd: KdTree, o, d, tmax, any_hit: bool = False):
    """Parametric kd traversal (KdTreeAggregate::Intersect,
    aggregates.cpp:1030), the reference's per-ray walk run in lockstep over
    the rays still walking. Returns (t, prim, u, v) with t = inf and prim
    -1 on a miss; with any_hit=True a bool occlusion mask."""
    with torch.no_grad():
        return _walk(kd, o.detach(), d.detach(), tmax.detach(), any_hit)


def _walk(kd: KdTree, o, d, tmax, any_hit: bool):
    n = o.shape[0]
    dev = o.device
    small = torch.abs(d) < 1e-20
    inv_d = torch.where(small, torch.sign(d) * 1e20 + (d == 0.0) * 1e20,
                        1.0 / d)
    t0 = (kd.bounds_lo - o) * inv_d
    t1 = (kd.bounds_hi - o) * inv_d
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    # Conservative slab span, as the reference pads it (scene surfaces on
    # the kd bounds put hits at t == tmax).
    tmin = torch.clamp(torch.amax(tn, dim=1), min=0.0)
    tmx = torch.minimum(torch.amin(tf, dim=1), tmax)
    pad0 = 1e-5 * torch.abs(tmx) + 1e-7
    tmin = torch.clamp(tmin - pad0, min=0.0)
    tmx = tmx + pad0
    alive = tmin <= tmx
    best_t = torch.where(alive, tmax, -_INF)
    best_prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    top = torch.zeros((n,), dtype=torch.int64, device=dev)
    todo_node = torch.zeros((n, _STACK), dtype=torch.int64, device=dev)
    todo_tmin = torch.zeros((n, _STACK), dtype=torch.float32, device=dev)
    todo_tmax = torch.zeros((n, _STACK), dtype=torch.float32, device=dev)
    axis = kd.axis.long()
    above_of = kd.above.long()
    n_idx = kd.prim_indices.shape[0]
    a = torch.nonzero(alive).squeeze(1)
    while a.numel():
        nid = node[a]
        ax = axis[nid]
        leaf = ax == 3

        # ---- Leaves: test the prims in order, then pop the todo stack.
        lr = a[leaf]
        if lr.numel():
            ln = nid[leaf]
            off = kd.prim_off.long()[ln]
            cnt = kd.prim_cnt.long()[ln]
            bt, bp, bu, bv = best_t[lr], best_prim[lr], best_u[lr], best_v[lr]
            ro, rd = o[lr], d[lr]
            for i in range(int(cnt.max()) if cnt.numel() else 0):
                pid = kd.prim_indices[torch.clamp(off + i, 0, n_idx - 1)]
                t, u, v = _tri_hit(kd.tri_verts[pid.long()], ro, rd)
                better = (i < cnt) & (t < bt)
                bt = torch.where(better, t, bt)
                bp = torch.where(better, pid, bp)
                bu = torch.where(better, u, bu)
                bv = torch.where(better, v, bv)
            best_t[lr], best_prim[lr], best_u[lr], best_v[lr] = bt, bp, bu, bv
            has = top[lr] > 0
            stop_early = (bp >= 0) if any_hit else torch.zeros_like(has)
            t1_ = top[lr] - 1
            idx = torch.clamp(t1_, min=0)
            nxt_tmin = todo_tmin[lr, idx]
            # Early out: best hit before the next span's entry (the
            # shrinking tMax, aggregates.cpp:1136).
            closer = bt <= nxt_tmin
            keep = has & ~stop_early & ~(closer & ~torch.isinf(bt))
            node[lr] = torch.where(keep, todo_node[lr, idx], 0)
            tmin[lr] = torch.where(keep, nxt_tmin, 0.0)
            tmx[lr] = torch.where(keep, todo_tmax[lr, idx], 0.0)
            top[lr] = torch.where(has, t1_, 0)
            alive[lr] = keep

        # ---- Interior: order the children, maybe push the far side.
        ir = a[~leaf]
        if ir.numel():
            inid = nid[~leaf]
            iax = ax[~leaf]
            spl = kd.split[inid]
            o_ax = o[ir, iax]
            d_ax = d[ir, iax]
            inv = torch.where(torch.abs(d_ax) < 1e-20, 1e20, 1.0 / d_ax)
            t_plane = (spl - o_ax) * inv
            below_first = (o_ax < spl) | ((o_ax == spl) & (d_ax <= 0))
            below = inid + 1
            above = above_of[inid]
            first = torch.where(below_first, below, above)
            second = torch.where(below_first, above, below)
            pad = 1e-6 * torch.abs(t_plane) + 1e-7
            rmin, rmax = tmin[ir], tmx[ir]
            only_first = (t_plane > rmax + pad) | (t_plane <= 0.0)
            # Strict else-if order (aggregates.cpp:1096): a plane behind the
            # ray resolves to the first child even when t_plane < tmin.
            only_second = ~only_first & (t_plane < rmin - pad)
            push = ~(only_first | only_second)
            it = top[ir]
            slot = torch.clamp(it, max=_STACK - 1)
            todo_node[ir, slot] = torch.where(push, second, todo_node[ir, slot])
            todo_tmin[ir, slot] = torch.where(push, t_plane, todo_tmin[ir, slot])
            todo_tmax[ir, slot] = torch.where(push, rmax, todo_tmax[ir, slot])
            top[ir] = torch.where(push, torch.clamp(it + 1, max=_STACK), it)
            node[ir] = torch.where(only_second, second, first)
            tmx[ir] = torch.where(push, t_plane, rmax)
        a = a[alive[a]]

    hit = (best_prim >= 0) & (best_t < tmax)
    if any_hit:
        return hit
    return (torch.where(hit, best_t, _INF), torch.where(hit, best_prim, -1),
            best_u, best_v)
