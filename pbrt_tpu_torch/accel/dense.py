"""Dense (brute-force) ray-scene intersection: port of
pbrt_tpu/accel/dense.py.

The watertight triangle tester (shapes.h:820-930, Woop et al.; edge
functions by core/floats.py's difference_of_products, so a shared edge's
two triangles see exactly negated values) answers the queries of a scene
with no tier attached (accel/api.py) and is the oracle of the tiers'
edge rays. The analytic families are tested densely after the triangle
tier: spheres (interval arithmetic), curve segments (the flattened
curves' leaf test), disks, open cylinders and bilinear patches
(Reshetov's quadratic). Every op is plain PyTorch, as the reference's are
plain XLA.

The reference folds 2,048-primitive blocks over every ray at once; here
the blocks keep its boundaries (its ties resolve within a block to the
largest index, across blocks to the earlier block) and the rays are cut
into chunks so that no (rays, block) temporary exceeds _CHUNK_ELEMS
elements.
"""

from __future__ import annotations

import math

import torch

from ..core.floats import difference_of_products as dop
from ..core.floats import fma, grad_flows, scalar, sqrt
from ..core.interval import Interval
from ..core.vecmath import cross, dot, normalize
from ..shapes.geometry import Interaction

_INF = float("inf")
_TRI_BLOCK = 2048  # primitives per block, the reference's
_CHUNK_ELEMS = 1 << 25  # most elements of one (rays, block) temporary


def offset_ray_origin(p, n, d):
    """Spawn-ray origin offset to avoid self-intersection: a scale-aware
    epsilon along the geometric normal, signed toward the outgoing side."""
    # maximum, not clamp: a tie with 1 passes half the gradient, as the
    # reference's jnp.maximum does (the attached estimator moves p).
    scale = torch.maximum(torch.amax(torch.abs(p), dim=-1, keepdim=True),
                          scalar(1.0, p.device))
    eps = 1e-4 * scale
    sign = torch.where(dot(n, d, keepdims=True) >= 0.0, 1.0, -1.0)
    return p + sign * eps * n


def shadow_segment(p, n, wi, dist):
    """Robust shadow segment from a surface point to a light sample
    (Interaction::SpawnRayTo): both ends are offset off their surfaces and
    t_max is parametric in the re-aimed segment.

    Returns (origin, direction, t_max); infinite dist keeps the original
    direction with a large t_max.
    """
    so = offset_ray_origin(p, n, wi)
    finite = torch.isfinite(dist)
    dist_f = torch.where(finite, dist, 1.0)
    target = p + wi * dist_f[..., None]
    seg = target - so
    seg_len = torch.clamp(torch.sqrt(torch.sum(seg * seg, dim=-1)), min=1e-20)
    wi2 = torch.where(finite[..., None], seg / seg_len[..., None], wi)
    smax = torch.where(finite, seg_len * (1.0 - 1e-3), 1e30)
    return so, wi2, smax


def _sph_soa(sph):
    """(S, 4) spheres -> component dict of (S,) tensors and S. The
    reference pads to a multiple of 128 lanes with radius-0 spheres that
    never hit; the port tests the S spheres as they are."""
    s = sph.shape[0]
    return {"cx": sph[:, 0], "cy": sph[:, 1], "cz": sph[:, 2],
            "r": sph[:, 3]}, s


def _intersect_sph_block(o, d, tmax, blk):
    """Ray-sphere on (N, S) components -> t (N, S), inf where missed.

    The quadratic runs through ULP-widened interval arithmetic
    (core/interval.py), the robustness scheme of the reference renderer's
    Sphere::BasicIntersect (shapes.h:110-180); the accept tests use the
    conservative bounds, and two Newton steps refine the root's midpoint."""
    ex = Interval.exact
    ocx = ex(o[:, 0:1]) - ex(blk["cx"][None])
    ocy = ex(o[:, 1:2]) - ex(blk["cy"][None])
    ocz = ex(o[:, 2:3]) - ex(blk["cz"][None])
    dx, dy, dz = ex(d[:, 0:1]), ex(d[:, 1:2]), ex(d[:, 2:3])
    a = dx.sqr() + dy.sqr() + dz.sqr()
    b = (ocx * dx + ocy * dy + ocz * dz) * ex(2.0)
    r = blk["r"][None]
    c = ocx.sqr() + ocy.sqr() + ocz.sqr() - ex(r).sqr()
    # Cancellation-free discriminant (shapes.h:118-136): the closest
    # approach f = oc - (b/2a) d, and discrim = 4a (r + |f|)(r - |f|).
    half_t = b / (a * ex(2.0))
    fx = ocx - half_t * dx
    fy = ocy - half_t * dy
    fz = ocz - half_t * dz
    len_sq = fx.sqr() + fy.sqr() + fz.sqr()
    flen = Interval(lo=sqrt(torch.clamp(len_sq.lo, min=0.0)),
                    hi=sqrt(torch.clamp(len_sq.hi, min=0.0)))
    ri = ex(r)
    disc = (ri + flen) * (ri - flen) * a * ex(4.0)
    has = disc.hi >= 0.0
    root = Interval(lo=sqrt(torch.clamp(disc.lo, min=0.0)),
                    hi=sqrt(torch.clamp(disc.hi, min=0.0)))
    # Stable quadratic (interval.h Quadratic): q = -0.5 (b +- root),
    # t0 = q / a, t1 = c / q, ordered.
    neg_b = b.lo < 0.0
    q = Interval(
        lo=torch.where(neg_b, -0.5 * (b.lo - root.hi), -0.5 * (b.hi + root.hi)),
        hi=torch.where(neg_b, -0.5 * (b.hi - root.lo), -0.5 * (b.lo + root.lo)),
    )
    q = Interval(lo=torch.minimum(q.lo, q.hi), hi=torch.maximum(q.lo, q.hi))
    ra = q / a
    rb = c / q
    t0 = Interval(lo=torch.minimum(ra.lo, rb.lo), hi=torch.minimum(ra.hi, rb.hi))
    t1 = Interval(lo=torch.maximum(ra.lo, rb.lo), hi=torch.maximum(ra.hi, rb.hi))
    # Accept (shapes.h:137-146): reject when the nearer root starts beyond
    # tmax or the farther cannot be positive; take t0 unless it may be
    # behind the origin, then t1.
    tm = tmax[:, None]
    use_t0 = t0.lo > 0.0
    pick_lo = torch.where(use_t0, t0.lo, t1.lo)
    pick_hi = torch.where(use_t0, t0.hi, t1.hi)
    t_mid = 0.5 * (pick_lo + pick_hi)
    # Two Newton steps on f(t) = |oc + t d|^2 - r^2 from the midpoint (the
    # role of the reference renderer's hit-point reprojection).
    ocx_m, ocy_m, ocz_m = (0.5 * (iv.lo + iv.hi) for iv in (ocx, ocy, ocz))
    dxm, dym, dzm = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    for _ in range(2):
        qx = ocx_m + t_mid * dxm
        qy = ocy_m + t_mid * dym
        qz = ocz_m + t_mid * dzm
        f = qx * qx + qy * qy + qz * qz - r * r
        fp = 2.0 * (qx * dxm + qy * dym + qz * dzm)
        t_mid = t_mid - f / torch.where(torch.abs(fp) < 1e-12, 1e-12, fp)
    hit = (has & (r > 0.0) & (t0.lo <= tm) & (t1.hi > 0.0) & (pick_hi <= tm)
           & (t_mid > 0.0))
    return torch.where(hit, t_mid, _INF)


def sphere_best(geom, o, d, tmax):
    """Nearest sphere hit of each ray: (t, index), inf and -1 on a miss;
    the first sphere keeps an exact tie."""
    blk, _ = _sph_soa(geom.sph)
    t_s = _intersect_sph_block(o, d, tmax, blk)
    t, arg = torch.min(t_s, dim=1)
    found = torch.isfinite(t)
    return torch.where(found, t, _INF), torch.where(found, arg, -1).to(torch.int32)


def _ray_chunks(n: int, width: int):
    """Slices of at most _CHUNK_ELEMS // width rays covering [0, n)."""
    step = max(1, _CHUNK_ELEMS // max(width, 1))
    return [slice(i, min(i + step, n)) for i in range(0, n, step)] or [
        slice(0, 0)]


def _by_rays(fn, width: int, o, d, tmax, *rest):
    """fn(o, d, tmax, *rest) over ray chunks, its tuple outputs joined."""
    parts = [fn(o[c], d[c], tmax[c], *(r[c] for r in rest))
             for c in _ray_chunks(o.shape[0], width)]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(x) for x in zip(*parts))


def _blocks(n: int):
    """The reference's block boundaries over n primitives."""
    return [(b, min(b + _TRI_BLOCK, n)) for b in range(0, n, _TRI_BLOCK)]


def _tri_soa(tri_verts):
    """(T, 3, 3) -> dict of (T,) components: v0, v1, v2 (the exact shared
    vertices, which the watertight tester needs)."""
    out = {}
    for k, name in enumerate(("v0", "v1", "v2")):
        for c, ax in (("x", 0), ("y", 1), ("z", 2)):
            out[name + c] = tri_verts[:, k, ax]
    return out


def _slice(soa, a, b):
    return {k: v[a:b] for k, v in soa.items()}


def _intersect_tri_block_wt(o, d, tmax, blk):
    """Watertight ray-triangle test on (N, B) components: translate to the
    ray origin, permute the axes so |d_z| is largest, shear the ray onto
    +z, and decide the hit by the signed 2D edge functions. Returns (t, u,
    v), each (N, B); t is inf where missed. The edge functions never
    contract to a fused multiply-add (difference_of_products is exact in
    plain operations); the shear and the t numerator are fused, as the
    reference's jitted CPU code fuses them, so the two agree to the
    bit."""
    ax, ay, az = torch.abs(d[:, 0:1]), torch.abs(d[:, 1:2]), torch.abs(d[:, 2:3])
    kz = torch.where((az >= ax) & (az >= ay), 2, torch.where(ay >= ax, 1, 0))

    def permute(cx, cy, cz):
        px = torch.where(kz == 0, cy, torch.where(kz == 1, cz, cx))
        py = torch.where(kz == 0, cz, torch.where(kz == 1, cx, cy))
        pz = torch.where(kz == 0, cx, torch.where(kz == 1, cy, cz))
        return px, py, pz

    dxp, dyp, dzp = permute(d[:, 0:1], d[:, 1:2], d[:, 2:3])
    # Winding consistency: if d_z < 0, swap x and y (shapes.h:842).
    neg = dzp < 0.0
    dxp, dyp = torch.where(neg, dyp, dxp), torch.where(neg, dxp, dyp)
    sx = -dxp / dzp
    sy = -dyp / dzp
    sz = 1.0 / dzp

    xs, ys, zs = [], [], []
    for vname in ("v0", "v1", "v2"):
        cx = blk[vname + "x"][None] - o[:, 0:1]
        cy = blk[vname + "y"][None] - o[:, 1:2]
        cz = blk[vname + "z"][None] - o[:, 2:3]
        px, py, pz = permute(cx, cy, cz)
        px, py = torch.where(neg, py, px), torch.where(neg, px, py)
        # The shear and the t numerator below as the reference's CPU build
        # computes them, with its compiler's fused multiply-adds.
        xs.append(fma(sx, pz, px))
        ys.append(fma(sy, pz, py))
        zs.append(sz * pz)
    x0, x1, x2 = xs
    y0, y1, y2 = ys
    z0, z1, z2 = zs

    e0 = dop(x1, y2, y1, x2)
    e1 = dop(x2, y0, y2, x0)
    e2 = dop(x0, y1, y0, x1)
    same_sign = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
                 | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
    det = e0 + e1 + e2
    zt = fma(e2, z2, fma(e0, z0, e1 * z1))
    # The sign-aware t window before the division (shapes.h:886-893).
    tm = tmax[:, None]
    bad_neg = (det < 0) & ((zt >= 0) | (zt < tm * det))
    bad_pos = (det > 0) & ((zt <= 0) | (zt > tm * det))
    hit = same_sign & (det != 0) & ~bad_neg & ~bad_pos
    inv_det = torch.where(det != 0, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    t = zt * inv_det
    u = e1 * inv_det  # the barycentric weight of v1 (Moller-Trumbore's u)
    v = e2 * inv_det
    return torch.where(hit, t, _INF), u, v


def _fold_min(best, t_blk, u_blk, v_blk, block_base: int):
    """Fold a block's per-ray minima into the running (t, idx, u, v): a
    tie inside the block goes to its largest column, and a block only
    replaces a strictly farther hit."""
    t_new = torch.amin(t_blk, dim=1)
    cols = torch.arange(t_blk.shape[1], dtype=torch.int32,
                        device=t_blk.device)[None, :]
    eq = t_blk == t_new[:, None]
    arg = torch.amax(torch.where(eq, cols, -1), dim=1)
    one = eq & (cols == arg[:, None])
    u_new = torch.sum(torch.where(one, u_blk, 0.0), dim=1)
    v_new = torch.sum(torch.where(one, v_blk, 0.0), dim=1)
    better = t_new < best[0]
    return (torch.where(better, t_new, best[0]),
            torch.where(better, block_base + arg, best[1]),
            torch.where(better, u_new, best[2]),
            torch.where(better, v_new, best[3]))


def _miss(o):
    n = o.shape[0]
    return (torch.full((n,), _INF, dtype=o.dtype, device=o.device),
            torch.full((n,), -1, dtype=torch.int32, device=o.device),
            torch.zeros((n,), dtype=o.dtype, device=o.device),
            torch.zeros((n,), dtype=o.dtype, device=o.device))


def _tri_best(soa, n_tri, o, d, tmax):
    best = _miss(o)
    for a, b in _blocks(n_tri):
        t, u, v = _intersect_tri_block_wt(o, d, tmax, _slice(soa, a, b))
        best = _fold_min(best, t, u, v, a)
    return best


def intersect_closest_tri(geom, o, d, tmax=None):
    """The watertight tester's closest triangle of each ray: (t (inf:
    miss), prim (-1: miss), u, v)."""
    if tmax is None:
        tmax = torch.full((o.shape[0],), _INF, dtype=o.dtype, device=o.device)
    n_tri = geom.num_triangles
    if n_tri == 0:
        return _miss(o)
    soa = _tri_soa(geom.tri_verts)
    return _by_rays(lambda o, d, tm: _tri_best(soa, n_tri, o, d, tm),
                    min(n_tri, _TRI_BLOCK), o, d, tmax)


def _crv_soa(geom):
    """Curve segments -> dict of (C,) components with the segment's span
    of the curve parameter."""
    crv = geom.crv
    names = ("ax", "ay", "az", "bx", "by", "bz", "r0", "r1")
    out = {n: crv[:, i] for i, n in enumerate(names)}
    out["u0"] = geom.crv_u[:, 0]
    out["u1"] = geom.crv_u[:, 1]
    return out


def _dot3(a0, b0, a1, b1, a2, b2):
    """a0 b0 + a1 b1 + a2 b2 with the reference's CPU multiply-adds."""
    return fma(a2, b2, fma(a0, b0, a1 * b1))


def _intersect_crv_block(o, d, tmax, blk):
    """Ray against round curve segments on (N, B) components: the closest
    approach of the ray and the segment axis, a hit when the perpendicular
    distance is within the lerped radius, t pulled forward by
    sqrt(r^2 - dist^2) (shapes.cpp Curve::RecursiveIntersect's leaf).
    Returns (t, s, h): s the fraction along the segment, h the signed
    offset over the radius in [-1, 1] (the sign from the (ray x tangent)
    binormal). The multiply-adds are fused where the reference's jitted
    CPU code fuses them, which gives its bits (h feeds the hair BSDF)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    axp, ayp, azp = blk["ax"][None], blk["ay"][None], blk["az"][None]
    ux = blk["bx"][None] - axp
    uy = blk["by"][None] - ayp
    uz = blk["bz"][None] - azp
    w0x = axp - ox
    w0y = ayp - oy
    w0z = azp - oz
    A = _dot3(ux, ux, uy, uy, uz, uz)
    B = _dot3(ux, dx, uy, dy, uz, dz)
    D = _dot3(ux, w0x, uy, w0y, uz, w0z)
    E = _dot3(dx, w0x, dy, w0y, dz, w0z)
    denom = fma(-B, B, A)
    s = torch.where(denom > 1e-12,
                    fma(B, E, -D) / torch.where(denom > 1e-12, denom, 1.0), 0.0)
    s = torch.clamp(s, 0.0, 1.0)
    t_ca = fma(s, B, E)  # the ray parameter of the closest approach
    cx = fma(-s, ux, fma(t_ca, dx, -w0x))
    cy = fma(-s, uy, fma(t_ca, dy, -w0y))
    cz = fma(-s, uz, fma(t_ca, dz, -w0z))
    dist2 = _dot3(cx, cx, cy, cy, cz, cz)
    r0 = blk["r0"][None]
    r = fma(s, blk["r1"][None] - r0, r0.expand_as(s))
    r2 = r * r
    thick = sqrt(torch.clamp(r2 - dist2, min=0.0))
    t = t_ca - thick
    hit = (dist2 <= r2) & (r > 0.0) & (t > 1e-5) & (t < tmax[:, None])
    bnx = fma(dy, uz, -(dz * uy))
    bny = fma(dz, ux, -(dx * uz))
    bnz = fma(dx, uy, -(dy * ux))
    side = _dot3(cx, bnx, cy, bny, cz, bnz)
    h = sqrt(dist2) / torch.clamp(r, min=1e-12)
    h = torch.clamp(torch.where(side >= 0.0, h, -h), -1.0, 1.0)
    return torch.where(hit, t, _INF), s, h


def _crv_best(soa, n_crv, o, d, tmax, best):
    for a, b in _blocks(n_crv):
        blk = _slice(soa, a, b)
        t, s, h = _intersect_crv_block(o, d, tmax, blk)
        u_g = blk["u0"][None] + s * (blk["u1"][None] - blk["u0"][None])
        best = _fold_min(best, t, u_g, 0.5 * (h + 1.0), a)
    return best


def curve_best(geom, o, d, tmax):
    """Nearest curve-segment hit: (t, segment (-1: miss), u, v), u the
    global curve parameter and v = (h + 1) / 2."""
    soa = _crv_soa(geom)
    n_crv = geom.num_curves
    return _by_rays(lambda o, d, tm: _crv_best(soa, n_crv, o, d, tm, _miss(o)),
                    min(n_crv, _TRI_BLOCK), o, d, tmax)


def _closest_all(geom, o, d, tmax):
    """The dense closest (t, idx, u, v) over triangles, spheres and curve
    segments, idx in prim order (intersect_closest's fold)."""
    n_tri, n_sph, n_crv = (geom.num_triangles, geom.num_spheres,
                           geom.num_curves)
    best = _miss(o)
    if n_tri > 0:
        best = _tri_best(_tri_soa(geom.tri_verts), n_tri, o, d, tmax)
    if n_sph > 0:
        blk, _ = _sph_soa(geom.sph)
        t_s = _intersect_sph_block(o, d, tmax, blk)
        zeros = torch.zeros_like(t_s)
        best = _fold_min(best, t_s, zeros, zeros, n_tri)
    if n_crv > 0:
        base = n_tri + n_sph
        best = _crv_best(_crv_soa(geom), n_crv, o, d, tmax,
                         (best[0], best[1] - base, best[2], best[3]))
        best = (best[0], best[1] + base, best[2], best[3])
    return best


def intersect_closest(geom, o, d, tmax=None) -> Interaction:
    """Closest hit over triangles, spheres and curve segments: an
    Interaction with geometric normals (winding; outward for spheres;
    camera-facing and normal to the fiber for curves)."""
    if tmax is None:
        tmax = torch.full((o.shape[0],), _INF, dtype=o.dtype, device=o.device)
    width = max(min(geom.num_triangles, _TRI_BLOCK), geom.num_spheres,
                min(geom.num_curves, _TRI_BLOCK))
    best = _by_rays(lambda o, d, tm: _closest_all(geom, o, d, tm), width,
                    o, d, tmax)
    return assemble_interaction(geom, o, d, best)


def assemble_interaction(geom, o, d, best) -> Interaction:
    """The Interaction of a (t, idx, u, v) best hit; idx ranges [0, T)
    triangles, [T, T + S) spheres, [T + S, T + S + C) curve segments."""
    n_tri, n_sph, n_crv = (geom.num_triangles, geom.num_spheres,
                           geom.num_curves)
    t, idx, u, v = best
    valid = idx >= 0
    idx_safe = torch.clamp(idx, min=0).long()
    # Under a gradient t is 0 in the product on a miss (inf there), so
    # that the gradient through o and d stays finite.
    t_p = torch.where(valid, t, 0.0) if grad_flows(o, d, t) else t
    p = torch.where(valid[:, None], o + t_p[:, None] * d, 0.0)
    n = o.shape[0]
    is_tri = valid & (idx < n_tri)
    if n_tri > 0:
        tri_idx = torch.clamp(idx_safe, max=n_tri - 1)
        tv = geom.tri_verts[tri_idx]
        n_tri_geo = normalize(cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]))
        mat_tri = geom.tri_mat[tri_idx]
        light_tri = geom.tri_light[tri_idx]
    else:
        n_tri_geo = torch.zeros_like(o)
        mat_tri = torch.zeros((n,), dtype=torch.int32, device=o.device)
        light_tri = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    if n_sph > 0:
        sph_idx = torch.clamp(idx_safe - n_tri, 0, n_sph - 1)
        sc = geom.sph[sph_idx]
        n_sph_geo = normalize(p - sc[:, :3])
        mat_sph = geom.sph_mat[sph_idx]
        light_sph = geom.sph_light[sph_idx]
        is_sph = valid & (idx >= n_tri) & (idx < n_tri + n_sph)
        phi = torch.atan2(n_sph_geo[:, 1], n_sph_geo[:, 0])
        u_s = torch.where(phi < 0, phi + 2 * math.pi, phi) / (2 * math.pi)
        v_s = 1.0 - torch.arccos(torch.clamp(n_sph_geo[:, 2], -1.0, 1.0)) / math.pi
        u = torch.where(is_sph, u_s, u)
        v = torch.where(is_sph, v_s, v)
    else:
        n_sph_geo = torch.zeros_like(o)
        mat_sph = torch.zeros((n,), dtype=torch.int32, device=o.device)
        light_sph = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    ng = torch.where(is_tri[:, None], n_tri_geo, n_sph_geo)
    mat = torch.where(is_tri, mat_tri, mat_sph)
    light = torch.where(is_tri, light_tri, light_sph)
    dpdu = torch.zeros_like(o)
    if n_crv > 0:
        is_crv = valid & (idx >= n_tri + n_sph)
        crv_idx = torch.clamp(idx_safe - n_tri - n_sph, 0, n_crv - 1)
        tang, n_c = curve_frame(geom, crv_idx, d)
        ng = torch.where(is_crv[:, None], n_c, ng)
        mat = torch.where(is_crv, geom.crv_mat[crv_idx], mat)
        light = torch.where(is_crv, -1, light)
        dpdu = torch.where(is_crv[:, None], tang, dpdu)
    return Interaction(
        valid=valid, t=t, p=p, n=ng, uv=torch.stack([u, v], dim=-1), wo=-d,
        mat=torch.where(valid, mat, 0), light=torch.where(valid, light, -1),
        prim=idx, dpdu=dpdu,
    )


def curve_frame(geom, crv_idx, d):
    """(tangent, normal) of curve-segment hits: the segment's unit axis and
    the camera-facing normal perpendicular to it (the hair BSDF needs only
    the tangent and a consistent normal plane; h carries the azimuth)."""
    cr = geom.crv[crv_idx.long()]
    tang = normalize(cr[:, 3:6] - cr[:, 0:3])
    wo = -d
    n_c = wo - dot(tang, wo, keepdims=True) * tang
    n_c = n_c / torch.clamp(torch.linalg.norm(n_c, dim=-1, keepdim=True),
                            min=1e-12)
    return tang, n_c


def _any_all(geom, o, d, tmax):
    occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    n_tri = geom.num_triangles
    if n_tri > 0:
        soa = _tri_soa(geom.tri_verts)
        for a, b in _blocks(n_tri):
            t, _, _ = _intersect_tri_block_wt(o, d, tmax, _slice(soa, a, b))
            occ = occ | torch.any(torch.isfinite(t), dim=1)
    if geom.num_spheres > 0:
        blk, _ = _sph_soa(geom.sph)
        occ = occ | torch.any(torch.isfinite(
            _intersect_sph_block(o, d, tmax, blk)), dim=1)
    if geom.num_curves > 0:
        soa = _crv_soa(geom)
        for a, b in _blocks(geom.num_curves):
            t, _, _ = _intersect_crv_block(o, d, tmax, _slice(soa, a, b))
            occ = occ | torch.any(torch.isfinite(t), dim=1)
    return (occ,)


def intersect_any(geom, o, d, tmax) -> torch.Tensor:
    """Occlusion over triangles, spheres and curve segments: True where a
    hit lies within tmax."""
    width = max(min(geom.num_triangles, _TRI_BLOCK), geom.num_spheres,
                min(geom.num_curves, _TRI_BLOCK))
    return _by_rays(lambda o, d, tm: _any_all(geom, o, d, tm), width,
                    o, d, tmax)[0]


# --- Analytic disks, cylinders and bilinear patches -----------------------


def _sum3(a):
    """Sum over the last axis of 3, left to right."""
    return a[..., 0] + a[..., 1] + a[..., 2]


def _pick(a, idx):
    return torch.gather(a, 1, idx[:, None].long())[:, 0]


def _disk_best(dk, o, d, tmax):
    c = dk[None, :, 0:3]
    nrm = dk[None, :, 3:6]
    r = dk[None, :, 6]
    ri = dk[None, :, 7]
    denom = _sum3(d[:, None, :] * nrm)
    denom = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    t = _sum3((c - o[:, None, :]) * nrm) / denom
    p = o[:, None, :] + t[..., None] * d[:, None, :]
    rel = p - c
    dist2 = _sum3(rel * rel)
    hit = ((t > 1e-5) & (t < tmax[:, None]) & (dist2 <= r * r)
           & (dist2 >= ri * ri))
    tm = torch.where(hit, t, _INF)
    idx = torch.argmin(tm, dim=1)
    tb = torch.amin(tm, dim=1)
    phi = torch.atan2(_pick(rel[..., 1], idx), _pick(rel[..., 0], idx)) / (
        2.0 * math.pi) + 0.5
    rad = sqrt(torch.clamp(_pick(dist2, idx), min=0.0)) / torch.clamp(
        _pick(r.expand(dist2.shape), idx), min=1e-9)
    ok = torch.isfinite(tb)
    return (torch.where(ok, tb, _INF), torch.where(ok, idx, -1).to(torch.int32),
            torch.where(ok, phi, 0.0), torch.where(ok, rad, 0.0))


def disk_best(geom, o, d, tmax):
    """Nearest analytic-disk hit: (t, idx (-1: miss), u, v), u = phi / 2pi
    + 1/2, v the radial fraction (Disk::Intersect: the plane solve and
    the radius window). A disk row is [center(3) normal(3) radius
    inner]."""
    if geom.num_disks == 0:
        return _miss(o)
    return _by_rays(lambda o, d, tm: _disk_best(geom.disk, o, d, tm),
                    geom.num_disks * 3, o, d, tmax)


def _cyl_best(cy, o, d, tmax):
    pa = cy[None, :, 0:3]
    ax = cy[None, :, 3:6]
    r = cy[None, :, 6]
    h = cy[None, :, 7]
    rel = o[:, None, :] - pa
    d_ax = _sum3(d[:, None, :] * ax)
    rel_ax = _sum3(rel * ax)
    d_perp = d[:, None, :] - d_ax[..., None] * ax
    rel_perp = rel - rel_ax[..., None] * ax
    a = _sum3(d_perp * d_perp)
    b = 2.0 * _sum3(d_perp * rel_perp)
    cq = _sum3(rel_perp * rel_perp) - r * r
    disc = b * b - 4.0 * a * cq
    sq = sqrt(torch.clamp(disc, min=0.0))
    a_safe = torch.where(torch.abs(a) < 1e-12, 1e-12, a)
    t0 = (-b - sq) / (2.0 * a_safe)
    t1 = (-b + sq) / (2.0 * a_safe)

    def axial_ok(t):
        z = rel_ax + t * d_ax
        return (torch.abs(z) <= h) & (t > 1e-5) & (t < tmax[:, None])

    ok0 = (disc > 0.0) & axial_ok(t0)
    ok1 = (disc > 0.0) & axial_ok(t1)
    tm = torch.where(ok0, t0, torch.where(ok1, t1, _INF))
    tm = torch.where(torch.isfinite(tm), tm, _INF)
    idx = torch.argmin(tm, dim=1)
    tb = torch.amin(tm, dim=1)
    z = _pick(rel_ax, idx) + tb * _pick(d_ax, idx)
    v = torch.clamp((z / torch.clamp(_pick(h.expand(rel_ax.shape), idx),
                                     min=1e-9) + 1.0) * 0.5, 0.0, 1.0)
    ok = torch.isfinite(tb)
    return (torch.where(ok, tb, _INF), torch.where(ok, idx, -1).to(torch.int32),
            torch.where(ok, v, 0.0), torch.zeros_like(tb))


def cyl_best(geom, o, d, tmax):
    """Nearest open-cylinder hit: (t, idx (-1: miss), u, v), u the axial
    fraction and v 0 (Cylinder::Intersect's quadratic). A cylinder row is
    [base point(3) axis(3) radius half_len]; the tube spans the axial
    coordinate [-half_len, half_len] about the base point."""
    if geom.num_cyls == 0:
        return _miss(o)
    return _by_rays(lambda o, d, tm: _cyl_best(geom.cyl, o, d, tm),
                    geom.num_cyls * 3, o, d, tmax)


def disk_cyl_normals(geom, o, d, t, kind_disk, idx):
    """Geometric normals of disk (kind_disk) or cylinder hits."""
    p = o + t[:, None] * d
    if geom.num_disks > 0:
        safe = torch.clamp(idx, 0, geom.num_disks - 1).long()
        n_disk = geom.disk[safe][:, 3:6]
    else:
        n_disk = torch.zeros_like(o)
    if geom.num_cyls > 0:
        row = geom.cyl[torch.clamp(idx, 0, geom.num_cyls - 1).long()]
        pa, ax = row[:, 0:3], row[:, 3:6]
        rel = p - pa
        z = torch.sum(rel * ax, dim=-1, keepdim=True)
        n_cyl = rel - z * ax
        n_cyl = n_cyl / torch.clamp(torch.linalg.norm(n_cyl, dim=-1,
                                                      keepdim=True), min=1e-9)
    else:
        n_cyl = torch.zeros_like(o)
    return torch.where(kind_disk[:, None], n_disk, n_cyl)


def _det3(a, b, c):
    return _sum3(torch.cross(a, b, dim=-1) * c)


def _blp_best(bp, o, d, tmax):
    p00 = bp[None, :, 0:3]
    p10 = bp[None, :, 3:6]
    p01 = bp[None, :, 6:9]
    p11 = bp[None, :, 9:12]
    e10 = p10 - p00
    e00 = p01 - p00
    E = p11 - p10 - p01 + p00
    q = p00 - o[:, None, :]
    dd = d[:, None, :].expand(q.shape)
    A = _det3(e10.expand(q.shape), E.expand(q.shape), dd)
    B = _det3(e10.expand(q.shape), e00.expand(q.shape), dd) + _det3(
        q, E.expand(q.shape), dd)
    C = _det3(q, e00.expand(q.shape), dd)
    # The robust quadratic; linear for planar patches (A ~ 0).
    lin = torch.abs(A) < 1e-12
    disc = B * B - 4.0 * A * C
    sq = sqrt(torch.clamp(disc, min=0.0))
    qf = -0.5 * (B + torch.sign(torch.where(B == 0.0, 1.0, B)) * sq)
    A_s = torch.where(lin, 1.0, A)
    u_a = torch.where(lin, -C / torch.where(torch.abs(B) < 1e-12, 1e-12, B),
                      qf / A_s)
    u_b = torch.where(lin, 2.0,
                      C / torch.where(torch.abs(qf) < 1e-12, 1e-12, qf))
    roots_ok = (lin, disc >= 0.0)
    t_best = torch.full(A.shape, _INF, dtype=o.dtype, device=o.device)
    u_best = torch.zeros_like(t_best)
    v_best = torch.zeros_like(t_best)
    for r, uu in ((0, u_a), (1, u_b)):
        pu = q + uu[..., None] * e10
        gv = e00 + uu[..., None] * E
        pu_x_d = torch.cross(pu, dd, dim=-1)
        gv_x_d = torch.cross(gv, dd, dim=-1)
        denom = _sum3(gv_x_d * gv_x_d)
        vv = -_sum3(pu_x_d * gv_x_d) / torch.where(denom < 1e-18, 1e-18, denom)
        tt = _sum3((pu + vv[..., None] * gv) * dd)
        valid = (roots_ok[0] | roots_ok[1]) if r == 0 else (~lin & roots_ok[1])
        ok = (valid & (uu >= -1e-5) & (uu <= 1.0 + 1e-5) & (vv >= -1e-5)
              & (vv <= 1.0 + 1e-5) & (tt > 1e-5) & (tt < tmax[:, None])
              & (denom > 1e-18))
        better = ok & (tt < t_best)
        t_best = torch.where(better, tt, t_best)
        u_best = torch.where(better, uu, u_best)
        v_best = torch.where(better, vv, v_best)
    idx = torch.argmin(t_best, dim=1)
    tb = torch.amin(t_best, dim=1)
    ok = torch.isfinite(tb)
    return (torch.where(ok, tb, _INF), torch.where(ok, idx, -1).to(torch.int32),
            torch.where(ok, _pick(u_best, idx), 0.0),
            torch.where(ok, _pick(v_best, idx), 0.0))


def blp_best(geom, o, d, tmax):
    """Nearest bilinear-patch hit: (t, idx (-1: miss), u, v). Reshetov's
    quadratic in u from the coplanarity determinant, then v and t of each
    root (BilinearPatch::Intersect, shapes.h:1350). A patch row is [p00
    p10 p01 p11]."""
    if geom.num_blps == 0:
        return _miss(o)
    return _by_rays(lambda o, d, tm: _blp_best(geom.blp, o, d, tm),
                    geom.num_blps * 3, o, d, tmax)


def blp_normal(geom, idx, u, v):
    """Unit geometric normal of bilinear-patch hits: dP/du x dP/dv."""
    row = geom.blp[torch.clamp(idx, 0, max(geom.num_blps, 1) - 1).long()]
    p00, p10 = row[:, 0:3], row[:, 3:6]
    p01, p11 = row[:, 6:9], row[:, 9:12]
    e10 = p10 - p00
    e00 = p01 - p00
    E = p11 - p10 - p01 + p00
    du = e10 + v[:, None] * E
    dv = e00 + u[:, None] * E
    n = torch.cross(du, dv, dim=-1)
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                           min=1e-12)
