"""Animated (motion-blurred) object instances: port of
pbrt_tpu/accel/instances.py.

AnimatedPrimitive (cpu/primitive.h:86-119 in the reference renderer): an
instance's object-to-world transform is an AnimatedTransform; each ray
interpolates it at its time, moves into object space, intersects the
prototype and maps the hit back. As in the reference, the moving
instances are intersected after the triangle tier in a plain pass: the
per-ray transform (lerp T, slerp R, lerp S) is a few (N, 3, 3) products,
and the prototype's triangles are tested by a dense Moller-Trumbore in
blocks of _CHUNK triangles. Scenes carry few moving instances.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tensorclass import static_field, tensorclass
from ..core.transform import AnimatedTransform
from .dense import _by_rays

_INF = float("inf")
_CHUNK = 512  # prototype triangles per dense block


@tensorclass
class AnimatedInstances:
    """TRS-keyframed instances over shared prototypes. `xforms` holds one
    AnimatedTransform per instance, stacked on a leading axis; `ranges`
    each instance's (start, count) triangle range of its prototype in the
    scene's object-space triangle table."""

    xforms: AnimatedTransform
    ranges: tuple = static_field(default=())
    time0: float = static_field(default=0.0)
    time1: float = static_field(default=1.0)

    def xform(self, a: int) -> AnimatedTransform:
        """Instance a's AnimatedTransform."""
        x = self.xforms
        return x.replace(t_start=x.t_start[a], t_end=x.t_end[a],
                         q_start=x.q_start[a], q_end=x.q_end[a],
                         s_start=x.s_start[a], s_end=x.s_end[a])


def stack_xforms(xforms) -> AnimatedTransform:
    """One AnimatedTransform with the instances' fields stacked."""
    first = xforms[0]
    return first.replace(**{
        k: torch.stack([getattr(x, k) for x in xforms])
        for k in ("t_start", "t_end", "q_start", "q_end", "s_start", "s_end")
    })


def build_animated_instances(proto_ranges, pid, o2w0, o2w1,
                             times=(0.0, 1.0)) -> AnimatedInstances:
    """pid: (A,) prototype of each moving instance; o2w0 / o2w1: (A, 4, 4)
    keyframe matrices; proto_ranges: each prototype's triangle range."""
    xforms = [AnimatedTransform.build(np.asarray(o2w0[a], np.float32),
                                      np.asarray(o2w1[a], np.float32),
                                      time0=float(times[0]),
                                      time1=float(times[1]))
              for a in range(len(pid))]
    return AnimatedInstances(
        xforms=stack_xforms(xforms),
        ranges=tuple(tuple(int(x) for x in proto_ranges[int(p)]) for p in pid),
        time0=float(times[0]), time1=float(times[1]),
    )


def _inv3(m):
    """Batched 3x3 inverse by the adjugate over the determinant (clamped
    away from 0 at 1e-30)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], -2)
    det = a * co[..., 0, 0] + b * co[..., 1, 0] + c * co[..., 2, 0]
    det = torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    return co / det[..., None, None]


def _proto_mt(tris, o, d, t_best):
    """Dense Moller-Trumbore of rays (N, 3) against triangles (K, 3, 3) in
    blocks of _CHUNK (and chunks of rays, as accel/dense.py cuts them):
    (t (inf: miss), local prim (-1: miss), u, v); only hits nearer than
    t_best count."""
    return _by_rays(lambda o, d, tb: _proto_mt_rays(tris, o, d, tb),
                    3 * min(tris.shape[0], _CHUNK), o, d, t_best)


def _proto_mt_rays(tris, o, d, t_best):
    n = o.shape[0]
    t_out = torch.full((n,), _INF, dtype=o.dtype, device=o.device)
    p_out = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    u_out = torch.zeros((n,), dtype=o.dtype, device=o.device)
    v_out = torch.zeros((n,), dtype=o.dtype, device=o.device)
    for c0 in range(0, tris.shape[0], _CHUNK):
        blk = tris[c0:c0 + _CHUNK]
        v0 = blk[:, 0]
        e1 = blk[:, 1] - blk[:, 0]
        e2 = blk[:, 2] - blk[:, 0]
        dn = d[:, None, :].expand(n, blk.shape[0], 3)
        pvec = torch.cross(dn, e2[None].expand_as(dn), dim=-1)
        det = torch.sum(e1[None] * pvec, -1)
        inv = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
        tvec = o[:, None, :] - v0[None]
        uk = torch.sum(tvec * pvec, -1) * inv
        qvec = torch.cross(tvec, e1[None].expand_as(tvec), dim=-1)
        vk = torch.sum(d[:, None, :] * qvec, -1) * inv
        tk = torch.sum(e2[None] * qvec, -1) * inv
        hit = ((torch.abs(det) > 1e-12) & (uk >= 0) & (vk >= 0)
               & (uk + vk <= 1) & (tk > 0)
               & (tk < torch.minimum(t_best, t_out)[:, None]))
        tkh = torch.where(hit, tk, _INF)
        arg = torch.argmin(tkh, dim=1)
        t_new = torch.gather(tkh, 1, arg[:, None])[:, 0]
        better = t_new < t_out
        t_out = torch.where(better, t_new, t_out)
        p_out = torch.where(better, c0 + arg.to(torch.int32), p_out)
        u_out = torch.where(better, torch.gather(uk, 1, arg[:, None])[:, 0],
                            u_out)
        v_out = torch.where(better, torch.gather(vk, 1, arg[:, None])[:, 0],
                            v_out)
    return t_out, p_out, u_out, v_out


def animated_best(anim: AnimatedInstances, geom, o, d, t_cur, time=None):
    """Closest hit over the moving instances at each ray's time (None: the
    shutter midpoint, which the integrators other than the path tracer
    take, as in the reference). Returns (t, prim, u, v, ng, mat, light),
    t inf on a miss, prim a global triangle id; only hits nearer than
    t_cur count."""
    n = o.shape[0]
    if time is None:
        time = torch.full((n,), 0.5 * (anim.time0 + anim.time1),
                          dtype=o.dtype, device=o.device)
    t_b = torch.where(torch.isfinite(t_cur), t_cur, _INF)
    t_out = torch.full((n,), _INF, dtype=o.dtype, device=o.device)
    p_out = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    u_out = torch.zeros((n,), dtype=o.dtype, device=o.device)
    v_out = torch.zeros((n,), dtype=o.dtype, device=o.device)
    ng_out = torch.zeros((n, 3), dtype=o.dtype, device=o.device)
    tri_verts = geom.tri_verts
    for a, (start, count) in enumerate(anim.ranges):
        lin, tr = anim.xform(a).interpolate_matrices(time)
        w2o = _inv3(lin)
        o_l = torch.einsum("nij,nj->ni", w2o, o - tr)
        d_l = torch.einsum("nij,nj->ni", w2o, d)  # unnormalised: t kept
        tris = tri_verts[start:start + count]
        nearest = torch.minimum(t_b, t_out)
        t_a, p_l, u_a, v_a = _proto_mt(tris, o_l, d_l, nearest)
        better = t_a < nearest
        prim_g = start + torch.clamp(p_l, min=0)
        # The world-space geometric normal: the hit triangle's edges under
        # the ray's interpolated linear part.
        tv = tri_verts[torch.clamp(prim_g, start, start + count - 1).long()]
        e1w = torch.einsum("nij,nj->ni", lin, tv[:, 1] - tv[:, 0])
        e2w = torch.einsum("nij,nj->ni", lin, tv[:, 2] - tv[:, 0])
        ngw = torch.cross(e1w, e2w, dim=-1)
        ngw = ngw / torch.clamp(torch.linalg.norm(ngw, dim=-1, keepdim=True),
                                min=1e-20)
        t_out = torch.where(better, t_a, t_out)
        p_out = torch.where(better, prim_g.to(torch.int32), p_out)
        u_out = torch.where(better, u_a, u_out)
        v_out = torch.where(better, v_a, v_out)
        ng_out = torch.where(better[:, None], ngw, ng_out)
    safe = torch.clamp(p_out, 0, geom.num_triangles - 1).long()
    mat = geom.tri_mat[safe]
    light = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    return t_out, p_out, u_out, v_out, ng_out, mat, light


def animated_any(anim: AnimatedInstances, geom, o, d, tmax, time=None):
    """Occlusion by the moving instances at each ray's time."""
    return animated_best(anim, geom, o, d, tmax, time)[1] >= 0
