"""Acceleration dispatch (port of pbrt_tpu/accel/api.py).

Triangle queries go through one accelerator of the scene: K1
(ops/smallscene.py) for scenes of up to 1024 triangles, K2
(ops/cluster.py) above that, K3 (ops/sweep.py) for instanced scenes from
the parser and `with_accel(kind="sweep")`, the kd-tree (accel/kdtree.py)
or the BVH (K4, ops/traverse.py). When a scene carries several, the
reference's precedence picks one: closest hits take the sweep, then the
small tier, the clusters, the kd-tree and the BVH; any-hit queries take
the sweep, then the kd-tree, the small tier, the clusters and the BVH.
K2 and K3 answer on rays permuted by `ray_sort_perm`, and their
closest-hit queries defer the hit's attributes to `resolve_tri_attrs`
(`resolve_tri_attrs_inst` for instances); the kd-tree and the BVH return
u, v, and the attributes are gathered by prim, as the reference does.
Analytic spheres are tested densely after the triangle tier and merged,
closest wins. A scene with no triangles (the furnace) needs no tier: its
triangle queries miss and the spheres answer. The dense watertight
triangle tester (ROADMAP Queue 1 item 8) is not ported.
"""

from __future__ import annotations

import math

import torch

from ..core.vecmath import cross, normalize
from ..ops.cluster import cluster_intersect
from ..ops.smallscene import smallscene_intersect
from ..ops.sweep import sweep_intersect
from ..ops.traverse import bvh_intersect
from ..shapes.geometry import Interaction
from .dense import sphere_any, sphere_best
from .kdtree import kdtree_intersect


def _spread8(x):
    x = (x | (x << 8)) & 0x00F00F
    x = (x | (x << 4)) & 0x0C30C3
    x = (x | (x << 2)) & 0x249249
    return x


def ray_sort_perm(o, d, tmax):
    """Coherence permutation for K2 and K3: (perm, inv) such that o[perm] puts
    rays of compact beams next to each other and x[perm][inv] == x.

    The reference's key, lexicographic: the 24-bit origin Morton code
    (256^3 cells over the rays' bounding box) first, then the Morton
    interleave of the octahedral direction quantised to 256 x 256. Dead
    lanes (tmax <= 0) get bit 30 so they sort last. Codes fit in 31 bits
    and are held in int64.
    """
    ad = torch.abs(d)
    an = (ad[:, 0:1] + ad[:, 1:2]) + ad[:, 2:3]
    p = d[:, :2] / torch.clamp(an, min=1e-20)
    neg = d[:, 2] < 0
    px = torch.where(neg, (1 - torch.abs(p[:, 1])) * torch.sign(p[:, 0]), p[:, 0])
    py = torch.where(neg, (1 - torch.abs(p[:, 0])) * torch.sign(p[:, 1]), p[:, 1])

    def quant(x):
        return torch.clamp(x.to(torch.int32), 0, 255).to(torch.int64)

    qx = quant((px + 1) * 127.5)
    qy = quant((py + 1) * 127.5)
    dcode = _spread8(qx) | (_spread8(qy) << 1)
    lo = torch.amin(o, dim=0)
    hi = torch.amax(o, dim=0)
    q8 = quant((o - lo) / torch.clamp(hi - lo, min=1e-6) * 255)
    ocode = (_spread8(q8[:, 0]) | (_spread8(q8[:, 1]) << 1)
             | (_spread8(q8[:, 2]) << 2))
    ocode = ocode | torch.where(tmax <= 0.0, 1 << 30, 0)
    perm1 = torch.argsort(dcode, stable=True)
    perm = perm1[torch.argsort(ocode[perm1], stable=True)]
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return perm, inv


def resolve_tri_attrs(geom, o, d, prim):
    """Hit attributes from the (unsorted) triangle table: re-evaluate the
    Moller-Trumbore u, v of triangle `prim` and its unit geometric normal,
    and gather its material and light ids. Misses read triangle 0."""
    n_tri = geom.num_triangles
    tri_idx = torch.clamp(prim, 0, max(n_tri - 1, 0)).long()
    tv = geom.tri_verts[tri_idx]  # (N, 3, 3)
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    ng = normalize(cross(e1, e2))
    pvec = cross(d, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    inv = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = o - tv[:, 0]
    u = torch.sum(tvec * pvec, dim=-1) * inv
    qvec = cross(tvec, e1)
    v = torch.sum(d * qvec, dim=-1) * inv
    return u, v, ng, geom.tri_mat[tri_idx], geom.tri_light[tri_idx]


def resolve_tri_attrs_inst(geom, sweep, o, d, prim, inst):
    """Hit attributes of instanced hits: the prototype triangle `prim`
    (object space) lifted to world space by instance `inst`'s
    object-to-world row, then the Moller-Trumbore u, v and the unit
    geometric normal re-evaluated against the world ray, so non-uniform
    instance scales shade correctly. Misses read triangle 0 of instance
    0."""
    n_tri = geom.num_triangles
    tri_idx = torch.clamp(prim, 0, max(n_tri - 1, 0)).long()
    tv = geom.tri_verts[tri_idx]  # (N, 3, 3) object space
    rows = sweep.o2w[torch.clamp(inst, 0, sweep.o2w.shape[0] - 1).long()]
    m = rows.reshape(-1, 3, 4)
    tv = torch.einsum("nij,nkj->nki", m[:, :, :3], tv) + m[:, None, :, 3]
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    ng = normalize(cross(e1, e2))
    pvec = cross(d, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    inv = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = o - tv[:, 0]
    u = torch.sum(tvec * pvec, dim=-1) * inv
    qvec = cross(tvec, e1)
    v = torch.sum(d * qvec, dim=-1) * inv
    return u, v, ng, geom.tri_mat[tri_idx], geom.tri_light[tri_idx]


def _no_accel():
    return NotImplementedError(
        "scene has no accelerator: call Scene.with_accel() (the dense "
        "watertight tester is not ported, ROADMAP Queue 1 item 8)"
    )


def interp_tri_uv(geom, prim, u, v):
    """Map barycentric (u, v) to the mesh's declared texture coordinates
    (triangle.cpp InterpolateUV); the default per-triangle table is the
    identity map. Non-triangle prims pass through."""
    n_tri = geom.num_triangles
    if n_tri == 0:
        return u, v
    is_tri = (prim >= 0) & (prim < n_tri)
    safe = torch.clamp(prim, 0, n_tri - 1).long()
    uvt = geom.tri_uv[safe]  # (N, 3, 2)
    w0 = (1.0 - u - v)[:, None]
    uvm = w0 * uvt[:, 0] + u[:, None] * uvt[:, 1] + v[:, None] * uvt[:, 2]
    return (
        torch.where(is_tri, uvm[:, 0], u),
        torch.where(is_tri, uvm[:, 1], v),
    )


def _prim_attrs(geom, prim):
    """Unit geometric normal, material and light of triangle `prim` (misses
    read triangle 0): the kd-tree's and the BVH's attributes."""
    tri_idx = torch.clamp(prim, 0, max(geom.num_triangles - 1, 0)).long()
    tv = geom.tri_verts[tri_idx]
    ng = normalize(cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]))
    return ng, geom.tri_mat[tri_idx], geom.tri_light[tri_idx]


def _no_triangles(o):
    """The closest-hit record of a scene without triangles: all misses."""
    n = o.shape[0]
    miss = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    zero = torch.zeros((n,), dtype=o.dtype, device=o.device)
    return (torch.full_like(zero, float("inf")), miss, zero, zero,
            torch.zeros_like(o), torch.zeros_like(miss), miss)


def _tri_closest(scene, o, d, tmax):
    """(t, prim, u, v, ng, mat, light) of the closest triangle hit."""
    if scene.geom.num_triangles == 0:
        return _no_triangles(o)
    if scene.sweep is not None:
        perm, inv = ray_sort_perm(o, d, tmax)
        res = sweep_intersect(scene.sweep, o[perm], d[perm], tmax[perm],
                              any_hit=False)
        t, prim, inst = res["t"][inv], res["prim"][inv], res["inst"][inv]
        if scene.sweep.instanced:
            attrs = resolve_tri_attrs_inst(scene.geom, scene.sweep, o, d,
                                           prim, inst)
        else:
            attrs = resolve_tri_attrs(scene.geom, o, d, prim)
        return (t, prim, *attrs)
    if scene.small is not None:
        res = smallscene_intersect(scene.small, o, d, tmax, any_hit=False)
        return (res["t"], res["prim"], res["u"], res["v"], res["n"],
                res["mat"], res["light"])
    if scene.clusters is not None:
        perm, inv = ray_sort_perm(o, d, tmax)
        res = cluster_intersect(scene.clusters, o[perm], d[perm], tmax[perm],
                                any_hit=False, defer_attrs=True)
        t, prim = res["t"][inv], res["prim"][inv]
        return (t, prim, *resolve_tri_attrs(scene.geom, o, d, prim))
    if scene.kdtree is not None or scene.bvh is not None:
        if scene.kdtree is not None:
            t, prim, u, v = kdtree_intersect(scene.kdtree, o, d, tmax)
        else:
            t, prim, u, v = bvh_intersect(scene.bvh, o, d, tmax)
        t = torch.where(prim >= 0, t, float("inf"))
        return (t, prim, u, v, *_prim_attrs(scene.geom, prim))
    raise _no_accel()


def _merge_spheres(geom, o, d, tmax, t, prim, u, v, ng, mat, light):
    """Fold the nearest sphere hit into the triangle hit where it is
    closer: prim becomes num_triangles + sphere index, uv the spherical
    (phi / 2pi, 1 - theta / pi) of the outward normal (world axes; the
    parser takes spheres under translations and uniform scales only)."""
    t_s, s_idx = sphere_best(geom, o, d, tmax)
    better = t_s < t
    safe = torch.clamp(s_idx, 0, geom.num_spheres - 1).long()
    sc = geom.sph[safe]
    n_s = normalize(o + t_s[:, None] * d - sc[:, :3])
    phi = torch.atan2(n_s[:, 1], n_s[:, 0])
    u_s = torch.where(phi < 0, phi + 2 * math.pi, phi) / (2 * math.pi)
    v_s = 1.0 - torch.arccos(torch.clamp(n_s[:, 2], -1.0, 1.0)) / math.pi
    return (torch.where(better, t_s, t),
            torch.where(better, geom.num_triangles + s_idx, prim),
            torch.where(better, u_s, u), torch.where(better, v_s, v),
            torch.where(better[:, None], n_s, ng),
            torch.where(better, geom.sph_mat[safe], mat),
            torch.where(better, geom.sph_light[safe], light))


def closest(scene, o, d, tmax=None) -> Interaction:
    """Closest hit of each ray (N, 3) within tmax (N,) (default inf)."""
    if tmax is None:
        tmax = torch.full((o.shape[0],), float("inf"), dtype=o.dtype,
                          device=o.device)
    t, prim, u, v, ng, mat, light = _tri_closest(scene, o, d, tmax)
    # Barycentrics -> declared mesh uv first; sphere hits carry their own.
    u, v = interp_tri_uv(scene.geom, prim, u, v)
    if scene.geom.num_spheres > 0:
        t, prim, u, v, ng, mat, light = _merge_spheres(
            scene.geom, o, d, tmax, t, prim, u, v, ng, mat, light)
    valid = prim >= 0
    p = torch.where(valid[:, None], o + t[:, None] * d, 0.0)
    return Interaction(
        valid=valid,
        t=t,
        p=p,
        n=ng,
        uv=torch.stack([u, v], dim=-1),
        wo=-d,
        mat=torch.where(valid, mat, 0),
        light=torch.where(valid, light, -1),
        prim=prim,
        dpdu=torch.zeros_like(o),
    )


def _tri_any(scene, o, d, tmax):
    if scene.geom.num_triangles == 0:
        return torch.zeros(o.shape[:1], dtype=torch.bool, device=o.device)
    if scene.sweep is not None:
        perm, inv = ray_sort_perm(o, d, tmax)
        res = sweep_intersect(scene.sweep, o[perm], d[perm], tmax[perm],
                              any_hit=True)
        return (res["prim"] >= 0)[inv]
    if scene.kdtree is not None:
        return kdtree_intersect(scene.kdtree, o, d, tmax, any_hit=True)
    if scene.small is not None:
        res = smallscene_intersect(scene.small, o, d, tmax, any_hit=True)
        return res["prim"] >= 0
    if scene.clusters is not None:
        perm, inv = ray_sort_perm(o, d, tmax)
        res = cluster_intersect(scene.clusters, o[perm], d[perm], tmax[perm],
                                any_hit=True)
        return (res["prim"] >= 0)[inv]
    if scene.bvh is not None:
        return bvh_intersect(scene.bvh, o, d, tmax, any_hit=True)[1] >= 0
    raise _no_accel()


def any_hit(scene, o, d, tmax) -> torch.Tensor:
    """Occlusion: True where any hit with 0 < t < tmax."""
    occ = _tri_any(scene, o, d, tmax)
    if scene.geom.num_spheres > 0:
        occ = occ | sphere_any(scene.geom, o, d, tmax)
    return occ
