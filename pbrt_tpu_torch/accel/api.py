"""Acceleration dispatch: the small-scene tier (port of accel/api.py).

Every closest-hit and any-hit query goes through K1
(ops/smallscene.py), which `Scene.with_accel()` attaches to scenes of up to
1024 triangles. Larger scenes (clusters, sweep), the BVH and kd-tree, and
the dense watertight tester are not ported (ROADMAP Queue 1 items 6-8).
"""

from __future__ import annotations

import torch

from ..ops.smallscene import smallscene_intersect
from ..shapes.geometry import Interaction


def _small(scene):
    if scene.small is None:
        raise NotImplementedError(
            "scene has no small-scene accelerator: call Scene.with_accel() "
            "(the dense watertight tester is not ported, ROADMAP Queue 1 "
            "item 8)"
        )
    return scene.small


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


def closest(scene, o, d, tmax=None) -> Interaction:
    """Closest hit of each ray (N, 3) within tmax (N,) (default inf)."""
    small = _small(scene)
    if tmax is None:
        tmax = torch.full((o.shape[0],), float("inf"), dtype=o.dtype,
                          device=o.device)
    res = smallscene_intersect(small, o, d, tmax, any_hit=False)
    t, prim = res["t"], res["prim"]
    u, v = interp_tri_uv(scene.geom, prim, res["u"], res["v"])
    valid = prim >= 0
    p = torch.where(valid[:, None], o + t[:, None] * d, 0.0)
    return Interaction(
        valid=valid,
        t=t,
        p=p,
        n=res["n"],
        uv=torch.stack([u, v], dim=-1),
        wo=-d,
        mat=torch.where(valid, res["mat"], 0),
        light=torch.where(valid, res["light"], -1),
        prim=prim,
        dpdu=torch.zeros_like(o),
    )


def any_hit(scene, o, d, tmax) -> torch.Tensor:
    """Occlusion: True where any hit with 0 < t < tmax."""
    res = smallscene_intersect(_small(scene), o, d, tmax, any_hit=True)
    return res["prim"] >= 0
