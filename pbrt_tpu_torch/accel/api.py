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
A scene with no tier attached is answered by the dense watertight tester
(accel/dense.py), as in the reference; a scene with no triangles needs
no tier.

After the triangle tier, in the reference's order: the alpha restart
loop (a hit whose alpha cuts it is skipped by re-tracing from just past
it, up to _ALPHA_ROUNDS surfaces; shadow rays run the closest loop once
the scene has alpha), the moving instances at the rays' times
(accel/instances.py), the mesh uv, the spheres, the curve segments, and
the disks, cylinders and bilinear patches, each merged where closer.
Prims are numbered triangles, spheres, curves, disks, cylinders,
patches.
"""

from __future__ import annotations

import math

import torch

from ..core.floats import grad_flows
from ..core.vecmath import cross, normalize
from ..ops.cluster import cluster_intersect
from ..ops.smallscene import smallscene_intersect
from ..ops.sweep import sweep_intersect
from ..ops.traverse import bvh_intersect
from ..shapes.geometry import Interaction
from . import dense
from .dense import sphere_best
from .instances import animated_any, animated_best
from .kdtree import kdtree_intersect

_INF = float("inf")


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


def _has_tier(scene) -> bool:
    return any(x is not None for x in (scene.sweep, scene.small,
                                       scene.clusters, scene.kdtree,
                                       scene.bvh))


def _tri_closest_once(scene, o, d, tmax):
    """(t, prim, u, v, ng, mat, light) of the closest triangle hit, by the
    scene's tier or, with none, the dense tester. The triangles of a scene
    whose only instances move are object-space prototypes: they miss."""
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
    if scene.anim is not None:
        return _no_triangles(o)
    t, prim, u, v = dense.intersect_closest_tri(scene.geom, o, d, tmax)
    return (t, prim, *resolve_tri_attrs(scene.geom, o, d, prim))


_ALPHA_ROUNDS = 4


def _alpha_at(scene, o, d, t, prim, u, v):
    """Alpha of each triangle hit: the triangle's constant times its alpha
    texture at the hit's uv (GeometricPrimitive alpha,
    cpu/primitive.h:59-63)."""
    from ..textures.buffers import evaluate_float

    geom = scene.geom
    safe = torch.clamp(prim, 0, max(geom.num_triangles - 1, 0)).long()
    base = geom.tri_alpha[safe]
    if scene.textures is None:
        return base
    um, vm = interp_tri_uv(geom, prim, u, v)
    p_hit = o + t[:, None] * d
    p_hit = torch.where(torch.isfinite(p_hit), p_hit, 0.0)
    return base * evaluate_float(scene.textures, geom.tri_alpha_tex[safe],
                                 torch.stack([um, vm], dim=-1), p_hit,
                                 torch.ones_like(base))


def _bits(x):
    """The uint32 bit patterns of float32 x, held in int64."""
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _alpha_rand(o, d, k: int):
    """The stochastic alpha test's uniform of restart k, hashed from the
    ray's bits (the reference renderer's HashFloat(o, d))."""
    from ..core.rng import pcg4d, u32_to_uniform

    h0, _, _, _ = pcg4d(_bits(o[:, 0]) ^ _bits(d[:, 1]),
                        _bits(o[:, 1]) ^ _bits(d[:, 2]),
                        _bits(o[:, 2]) ^ _bits(d[:, 0]), k + 1)
    return u32_to_uniform(h0)


def _tri_closest(scene, o, d, tmax):
    """The closest triangle hit with the alpha restart loop: a hit whose
    alpha is 0, or that fails its stochastic test, is skipped by a new
    query from just past it, up to _ALPHA_ROUNDS surfaces (a ray still cut
    after that keeps its hit); a hit that survives its test is final.
    Opaque scenes make one query (the any-hit alpha programs of the
    reference renderer, GeometricPrimitive::Intersect)."""
    res = _tri_closest_once(scene, o, d, tmax)
    if not scene.geom.has_alpha:
        return res
    s = torch.zeros_like(res[0])
    pending = torch.ones(res[0].shape, dtype=torch.bool, device=o.device)
    for k in range(_ALPHA_ROUNDS - 1):
        t, prim, u, v = res[:4]
        a = _alpha_at(scene, o, d, t, prim, u, v)
        cut = (pending & (prim >= 0) & (a < 1.0)
               & ((a <= 0.0) | (_alpha_rand(o, d, k) > a)))
        pending = cut
        eps = 1e-4 * torch.clamp(torch.abs(t), min=1.0)
        s_new = torch.where(cut, t + eps, s)
        o_shift = o + s_new[:, None] * d
        tq = torch.where(cut, tmax - s_new, 0.0)
        r2 = _tri_closest_once(scene, o_shift, d, tq)
        r2 = (r2[0] + s_new, *r2[1:])
        res = tuple(torch.where(cut[:, None] if x.dim() == 2 else cut, y, x)
                    for x, y in zip(res, r2))
        s = s_new
    return res


def _finite_t(valid, t, o, d):
    """t, and under a gradient 0 on the lanes not `valid` (inf on a miss),
    so that the gradient of o + t d through o and d is finite there."""
    return torch.where(valid, t, 0.0) if grad_flows(o, d, t) else t


def hit_point(valid, o, d, t):
    """o + t d on valid lanes, 0 elsewhere."""
    return torch.where(valid[:, None],
                       o + _finite_t(valid, t, o, d)[:, None] * d, 0.0)


def _merge_spheres(geom, o, d, tmax, t, prim, u, v, ng, mat, light):
    """Fold the nearest sphere hit into the triangle hit where it is
    closer: prim becomes num_triangles + sphere index, uv the spherical
    (phi / 2pi, 1 - theta / pi) of the outward normal (world axes; the
    parser takes spheres under translations and uniform scales only)."""
    t_s, s_idx = sphere_best(geom, o, d, tmax)
    better = t_s < t
    safe = torch.clamp(s_idx, 0, geom.num_spheres - 1).long()
    sc = geom.sph[safe]
    n_s = normalize(o + _finite_t(better, t_s, o, d)[:, None] * d
                    - sc[:, :3])
    phi = torch.atan2(n_s[:, 1], n_s[:, 0])
    u_s = torch.where(phi < 0, phi + 2 * math.pi, phi) / (2 * math.pi)
    v_s = 1.0 - torch.arccos(torch.clamp(n_s[:, 2], -1.0, 1.0)) / math.pi
    return (torch.where(better, t_s, t),
            torch.where(better, geom.num_triangles + s_idx, prim),
            torch.where(better, u_s, u), torch.where(better, v_s, v),
            torch.where(better[:, None], n_s, ng),
            torch.where(better, geom.sph_mat[safe], mat),
            torch.where(better, geom.sph_light[safe], light))


def _merge_curves(geom, o, d, tmax, t, prim, u, v, ng, mat, light, dpdu):
    """Fold the nearest curve-segment hit in where it is closer: u the
    curve parameter, v = (h + 1) / 2, the fiber tangent as dpdu."""
    t_c, c_idx, u_c, v_c = dense.curve_best(geom, o, d, tmax)
    better = t_c < t
    safe = torch.clamp(c_idx, 0, geom.num_curves - 1)
    tang, n_c = dense.curve_frame(geom, safe, d)
    b3 = better[:, None]
    return (torch.where(better, t_c, t),
            torch.where(better, geom.num_triangles + geom.num_spheres + c_idx,
                        prim),
            torch.where(better, u_c, u), torch.where(better, v_c, v),
            torch.where(b3, n_c, ng),
            torch.where(better, geom.crv_mat[safe.long()], mat),
            torch.where(better, -1, light), torch.where(b3, tang, dpdu))


def _merge_disk_cyl(geom, o, d, isect: Interaction) -> Interaction:
    """Fold the disk, cylinder and bilinear-patch hits in where closer
    (the closest-wins merge of the other families)."""
    base = geom.num_triangles + geom.num_spheres + geom.num_curves
    for best, n_fam, mats in ((dense.disk_best, geom.num_disks, geom.disk_mat),
                              (dense.cyl_best, geom.num_cyls, geom.cyl_mat),
                              (dense.blp_best, geom.num_blps, geom.blp_mat)):
        if n_fam == 0:
            continue
        t_cur = torch.where(isect.valid, isect.t, _INF)
        t_f, i_f, u_f, v_f = best(geom, o, d, t_cur)
        better = t_f < t_cur
        if best is dense.blp_best:
            ng = dense.blp_normal(geom, i_f, u_f, v_f)
        else:
            kind_disk = torch.full(t_f.shape, best is dense.disk_best,
                                   dtype=torch.bool, device=o.device)
            ng = dense.disk_cyl_normals(geom, o, d, t_f, kind_disk, i_f)
        mat_f = mats[torch.clamp(i_f, 0, n_fam - 1).long()]
        b3 = better[:, None]
        isect = isect.replace(
            valid=isect.valid | better,
            p=torch.where(b3, o + _finite_t(better, t_f, o, d)[:, None] * d,
                          isect.p),
            n=torch.where(b3, ng, isect.n),
            t=torch.where(better, t_f, isect.t),
            uv=torch.where(b3, torch.stack([u_f, v_f], -1), isect.uv),
            mat=torch.where(better, mat_f, isect.mat),
            light=torch.where(better, -1, isect.light),
            prim=torch.where(better, base + i_f, isect.prim),
            dpdu=torch.where(b3, torch.zeros_like(isect.dpdu), isect.dpdu),
        )
        base = base + n_fam
    return isect


def closest(scene, o, d, tmax=None, time=None) -> Interaction:
    """Closest hit of each ray (N, 3) within tmax (N,) (default inf), the
    moving instances at the rays' shutter times `time` (N,) (default the
    shutter midpoint)."""
    geom = scene.geom
    if tmax is None:
        tmax = torch.full((o.shape[0],), _INF, dtype=o.dtype, device=o.device)
    if not _has_tier(scene) and scene.anim is None and not geom.has_alpha:
        isect = dense.intersect_closest(geom, o, d, tmax)
        u, v = interp_tri_uv(geom, isect.prim, isect.uv[:, 0], isect.uv[:, 1])
        return _merge_disk_cyl(geom, o, d, isect.replace(
            uv=torch.stack([u, v], dim=-1)))
    t, prim, u, v, ng, mat, light = _tri_closest(scene, o, d, tmax)
    if scene.anim is not None:
        t_base = torch.minimum(torch.where(prim >= 0, t, _INF), tmax)
        hit_a = animated_best(scene.anim, geom, o, d, t_base, time)
        bet = hit_a[0] < t_base
        t, prim, u, v, ng, mat, light = (
            torch.where(bet[:, None] if x.dim() == 2 else bet, y, x)
            for x, y in zip((t, prim, u, v, ng, mat, light), hit_a))
    # Barycentrics -> declared mesh uv first; the other families carry
    # their own.
    u, v = interp_tri_uv(geom, prim, u, v)
    if geom.num_spheres > 0:
        t, prim, u, v, ng, mat, light = _merge_spheres(
            geom, o, d, tmax, t, prim, u, v, ng, mat, light)
    dpdu = torch.zeros_like(o)
    if geom.num_curves > 0:
        t, prim, u, v, ng, mat, light, dpdu = _merge_curves(
            geom, o, d, tmax, t, prim, u, v, ng, mat, light, dpdu)
    valid = prim >= 0
    p = hit_point(valid, o, d, t)
    return _merge_disk_cyl(geom, o, d, Interaction(
        valid=valid,
        t=t,
        p=p,
        n=ng,
        uv=torch.stack([u, v], dim=-1),
        wo=-d,
        mat=torch.where(valid, mat, 0),
        light=torch.where(valid, light, -1),
        prim=prim,
        dpdu=dpdu,
    ))


def _tri_any(scene, o, d, tmax):
    """Triangle occlusion by the scene's tier (there is one)."""
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
    return bvh_intersect(scene.bvh, o, d, tmax, any_hit=True)[1] >= 0


def _merge_anyhit_quadrics(geom, o, d, tmax, occ):
    """OR the analytic families' occlusion (spheres, curves, disks,
    cylinders, patches) into the triangles'."""
    if geom.num_spheres > 0:
        blk, _ = dense._sph_soa(geom.sph)
        occ = occ | torch.any(torch.isfinite(
            dense._intersect_sph_block(o, d, tmax, blk)), dim=1)
    for n_fam, best in ((geom.num_curves, dense.curve_best),
                        (geom.num_disks, dense.disk_best),
                        (geom.num_cyls, dense.cyl_best),
                        (geom.num_blps, dense.blp_best)):
        if n_fam > 0:
            occ = occ | (best(geom, o, d, tmax)[1] >= 0)
    return occ


def any_hit(scene, o, d, tmax, time=None) -> torch.Tensor:
    """Occlusion: True where any hit with 0 < t < tmax, the moving
    instances at the rays' times."""
    geom = scene.geom

    def with_anim(occ):
        if scene.anim is None:
            return occ
        return occ | animated_any(scene.anim, geom, o, d, tmax, time)

    if geom.has_alpha:
        # The first-hit-wins any-hit queries cannot skip cut surfaces:
        # shadow rays run the closest loop, its stochastic test the same.
        occ = _tri_closest(scene, o, d, tmax)[1] >= 0
    elif _has_tier(scene):
        occ = _tri_any(scene, o, d, tmax)
    elif scene.anim is None:
        occ = dense.intersect_any(geom, o, d, tmax)
        for n_fam, best in ((geom.num_disks, dense.disk_best),
                            (geom.num_cyls, dense.cyl_best),
                            (geom.num_blps, dense.blp_best)):
            if n_fam > 0:
                occ = occ | (best(geom, o, d, tmax)[1] >= 0)
        return occ
    else:
        # Only moving instances: their object-space prototypes are not
        # intersected directly.
        occ = torch.zeros(o.shape[:1], dtype=torch.bool, device=o.device)
    return _merge_anyhit_quadrics(geom, o, d, tmax, with_anim(occ))
