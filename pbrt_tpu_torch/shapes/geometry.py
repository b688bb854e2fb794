"""Flat triangle geometry buffers and surface-interaction records.

Port of pbrt_tpu/shapes/geometry.py, triangle fields only. Spheres,
curves, disks, cylinders, bilinear patches and alpha masks are not ported
yet: `GeometryBuffers.build` raises NotImplementedError when handed any.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tensorclass import tensorclass

# Non-triangle shape families (build arguments and reference field names)
# and the ROADMAP Queue 1 item porting them.
UNPORTED_SHAPES = {
    "spheres": 8, "sph": 8, "sph_mat": 8, "sph_light": 8, "crv": 8, "crv_u": 8,
    "crv_mat": 8, "disk": 8, "disk_mat": 8, "cyl": 8, "cyl_mat": 8,
    "blp": 8, "blp_mat": 8,
}


@tensorclass
class GeometryBuffers:
    """Scene triangles in flat tensors.

    tri_verts:     (T, 3, 3) float32 world-space vertices
    tri_mat:       (T,)      int32   material index
    tri_light:     (T,)      int32   area-light index, -1 if not emissive
    tri_face:      (T,)      int32   face index within the source shape
    tri_alpha:     (T,)      float32 constant alpha (all 1: opaque)
    tri_alpha_tex: (T,)      int32   alpha texture id (all -1: none)
    tri_uv:        (T, 3, 2) float32 per-vertex texture coordinates
    """

    tri_verts: torch.Tensor
    tri_mat: torch.Tensor
    tri_light: torch.Tensor
    tri_face: torch.Tensor
    tri_alpha: torch.Tensor
    tri_alpha_tex: torch.Tensor
    tri_uv: torch.Tensor

    @staticmethod
    def build(tri_verts=None, tri_mat=None, tri_light=None, tri_face=None,
              tri_alpha=None, tri_alpha_tex=None, tri_uv=None,
              **other_shapes) -> "GeometryBuffers":
        for name, value in other_shapes.items():
            if name not in UNPORTED_SHAPES:
                raise TypeError(f"unknown geometry argument {name!r}")
            if value is not None and len(value):
                raise NotImplementedError(
                    f"geometry {name!r} is not ported yet (ROADMAP Queue 1 "
                    f"item {UNPORTED_SHAPES[name]}); only triangles are"
                )
        if (tri_alpha is not None and np.any(np.asarray(tri_alpha) < 1.0)) or (
            tri_alpha_tex is not None and np.any(np.asarray(tri_alpha_tex) >= 0)
        ):
            raise NotImplementedError(
                "alpha-masked triangles are not ported yet (ROADMAP Queue 1 "
                "item 7)"
            )
        t = 0 if tri_verts is None else len(tri_verts)

        def arr(x, default, dtype):
            x = default if x is None else x
            return torch.as_tensor(np.array(x), dtype=dtype)

        return GeometryBuffers(
            tri_verts=arr(tri_verts, np.zeros((t, 3, 3)), torch.float32),
            tri_mat=arr(tri_mat, np.zeros((t,)), torch.int32),
            tri_light=arr(tri_light, np.full((t,), -1), torch.int32),
            tri_face=arr(tri_face, np.zeros((t,)), torch.int32),
            tri_alpha=arr(tri_alpha, np.ones((t,)), torch.float32),
            tri_alpha_tex=arr(tri_alpha_tex, np.full((t,), -1), torch.int32),
            tri_uv=arr(
                tri_uv,
                np.broadcast_to(
                    np.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
                    (t, 3, 2),
                ),
                torch.float32,
            ),
        )

    @property
    def num_triangles(self) -> int:
        return self.tri_verts.shape[0]


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
