"""Ray-spawning helpers and the analytic sphere test of
pbrt_tpu/accel/dense.py.

The dense watertight triangle tester is not ported (ROADMAP Queue 1 item
8): the port's triangle tiers answer every triangle query. Spheres are
tested densely after any triangle tier, as in the reference (scenes hold
few analytic quadrics).
"""

from __future__ import annotations

import torch

from ..core.floats import sqrt
from ..core.interval import Interval
from ..core.vecmath import dot

_INF = float("inf")


def offset_ray_origin(p, n, d):
    """Spawn-ray origin offset to avoid self-intersection: a scale-aware
    epsilon along the geometric normal, signed toward the outgoing side."""
    scale = torch.clamp(torch.amax(torch.abs(p), dim=-1, keepdim=True), min=1.0)
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


def sphere_any(geom, o, d, tmax):
    """True where some sphere is hit within tmax."""
    blk, _ = _sph_soa(geom.sph)
    return torch.any(torch.isfinite(_intersect_sph_block(o, d, tmax, blk)),
                     dim=1)
