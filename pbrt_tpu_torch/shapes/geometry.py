"""Flat geometry buffers and surface-interaction records.

Port of pbrt_tpu/shapes/geometry.py: triangles (with their alpha masks),
analytic spheres (emissive ones are sphere lights), curve segments
(shapes/curve.py), disks, open cylinders and bilinear patches, each
family in flat tensors with its material ids. Prims are numbered
triangles, spheres, curves, disks, cylinders, patches (accel/api.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tensorclass import static_field, tensorclass


@tensorclass
class GeometryBuffers:
    """Scene geometry in flat tensors.

    tri_verts:     (T, 3, 3) float32 world-space vertices
    tri_mat:       (T,)      int32   material index
    tri_light:     (T,)      int32   area-light index, -1 if not emissive
    tri_face:      (T,)      int32   face index within the source shape
    tri_alpha:     (T,)      float32 constant alpha (1: opaque)
    tri_alpha_tex: (T,)      int32   alpha texture id (-1: none)
    tri_uv:        (T, 3, 2) float32 per-vertex texture coordinates
    sph:           (S, 4)    float32 sphere center + radius (world space)
    sph_mat:       (S,)      int32   material index
    sph_light:     (S,)      int32   light id of an emissive sphere (after
                                     the area triangles in the light list),
                                     -1 if not emissive
    crv:           (C, 8)    float32 curve segments [p0 p1 r0 r1]
    crv_u:         (C, 2)    float32 each segment's curve-parameter span
    crv_mat:       (C,)      int32
    disk:          (D, 8)    float32 [center(3) normal(3) radius inner]
    disk_mat:      (D,)      int32
    cyl:           (Cy, 8)   float32 [base point(3) axis(3) radius half_len]
    cyl_mat:       (Cy,)     int32
    blp:           (Bp, 12)  float32 bilinear patches [p00 p10 p01 p11]
    blp_mat:       (Bp,)     int32
    has_alpha:     some triangle has alpha < 1 or an alpha texture; the
                   queries run the alpha restart loop only then
    """

    tri_verts: torch.Tensor
    tri_mat: torch.Tensor
    tri_light: torch.Tensor
    tri_face: torch.Tensor
    tri_alpha: torch.Tensor
    tri_alpha_tex: torch.Tensor
    tri_uv: torch.Tensor
    sph: torch.Tensor
    sph_mat: torch.Tensor
    sph_light: torch.Tensor
    crv: torch.Tensor
    crv_u: torch.Tensor
    crv_mat: torch.Tensor
    disk: torch.Tensor
    disk_mat: torch.Tensor
    cyl: torch.Tensor
    cyl_mat: torch.Tensor
    blp: torch.Tensor
    blp_mat: torch.Tensor
    has_alpha: bool = static_field(default=False)

    @staticmethod
    def build(tri_verts=None, tri_mat=None, tri_light=None, tri_face=None,
              tri_alpha=None, tri_alpha_tex=None, tri_uv=None, spheres=None,
              sph_mat=None, sph_light=None, crv=None, crv_u=None,
              crv_mat=None, disk=None, disk_mat=None, cyl=None, cyl_mat=None,
              blp=None, blp_mat=None) -> "GeometryBuffers":
        def n(x):
            return 0 if x is None else len(x)

        t, s, c = n(tri_verts), n(spheres), n(crv)
        nd, ncy, nb = n(disk), n(cyl), n(blp)

        def arr(x, default, dtype):
            x = default if x is None else x
            return torch.as_tensor(np.array(x), dtype=dtype)

        f32, i32 = torch.float32, torch.int32
        return GeometryBuffers(
            tri_verts=arr(tri_verts, np.zeros((t, 3, 3)), f32),
            tri_mat=arr(tri_mat, np.zeros((t,)), i32),
            tri_light=arr(tri_light, np.full((t,), -1), i32),
            tri_face=arr(tri_face, np.zeros((t,)), i32),
            tri_alpha=arr(tri_alpha, np.ones((t,)), f32),
            tri_alpha_tex=arr(tri_alpha_tex, np.full((t,), -1), i32),
            tri_uv=arr(
                tri_uv,
                np.broadcast_to(
                    np.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
                    (t, 3, 2),
                ),
                f32,
            ),
            sph=arr(spheres, np.zeros((s, 4)), f32).reshape(s, 4),
            sph_mat=arr(sph_mat, np.zeros((s,)), i32),
            sph_light=arr(sph_light, np.full((s,), -1), i32),
            crv=arr(crv, np.zeros((c, 8)), f32).reshape(c, 8),
            crv_u=arr(crv_u, np.zeros((c, 2)), f32).reshape(c, 2),
            crv_mat=arr(crv_mat, np.zeros((c,)), i32),
            disk=arr(disk, np.zeros((nd, 8)), f32).reshape(nd, 8),
            disk_mat=arr(disk_mat, np.zeros((nd,)), i32),
            cyl=arr(cyl, np.zeros((ncy, 8)), f32).reshape(ncy, 8),
            cyl_mat=arr(cyl_mat, np.zeros((ncy,)), i32),
            blp=arr(blp, np.zeros((nb, 12)), f32).reshape(nb, 12),
            blp_mat=arr(blp_mat, np.zeros((nb,)), i32),
            has_alpha=bool(
                (tri_alpha is not None and np.any(np.asarray(tri_alpha) < 1.0))
                or (tri_alpha_tex is not None
                    and np.any(np.asarray(tri_alpha_tex) >= 0))),
        )

    @property
    def num_triangles(self) -> int:
        return self.tri_verts.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sph.shape[0]

    @property
    def num_curves(self) -> int:
        return self.crv.shape[0]

    @property
    def num_disks(self) -> int:
        return self.disk.shape[0]

    @property
    def num_cyls(self) -> int:
        return self.cyl.shape[0]

    @property
    def num_blps(self) -> int:
        return self.blp.shape[0]

    def all_mats(self) -> torch.Tensor:
        """Every prim's material id, in prim order."""
        return torch.cat([self.tri_mat, self.sph_mat, self.crv_mat,
                          self.disk_mat, self.cyl_mat, self.blp_mat])


@tensorclass
class Interaction:
    """Surface interaction SOA (ref: SurfaceInteraction, interaction.h:506).

    All fields are batched over rays; `valid` is the hit mask.
    """

    valid: torch.Tensor  # (N,) bool
    t: torch.Tensor  # (N,) ray parameter
    p: torch.Tensor  # (N, 3) hit point
    n: torch.Tensor  # (N, 3) geometric normal (winding)
    uv: torch.Tensor  # (N, 2)
    wo: torch.Tensor  # (N, 3) outgoing (toward origin)
    mat: torch.Tensor  # (N,) int32 material index
    light: torch.Tensor  # (N,) int32 area light index or -1
    prim: torch.Tensor  # (N,) int32 primitive id
    dpdu: torch.Tensor  # (N, 3) surface tangent; zero => any frame


# --- Host-side mesh builders (scene construction helpers) -------------------


def make_quad(p0, p1, p2, p3) -> np.ndarray:
    """Two triangles (2, 3, 3) spanning the quad p0 p1 p2 p3 (ccw)."""
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    return np.stack([np.stack([p0, p1, p2]), np.stack([p0, p2, p3])])


def make_box(lo, hi) -> np.ndarray:
    """12 triangles (12, 3, 3) of an axis-aligned box, outward winding."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    quads = [
        make_quad((x0, y0, z0), (x0, y1, z0), (x1, y1, z0), (x1, y0, z0)),
        make_quad((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)),
        make_quad((x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1)),
        make_quad((x0, y1, z0), (x0, y1, z1), (x1, y1, z1), (x1, y1, z0)),
        make_quad((x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0)),
        make_quad((x1, y0, z0), (x1, y1, z0), (x1, y1, z1), (x1, y0, z1)),
    ]
    return np.concatenate(quads, axis=0)
