"""Scene container (port of pbrt_tpu/scene.py).

Geometry, materials and area lights as flat tensors, plus the small-scene
accelerator once `with_accel()` has attached it. The reference's other
optional members (media, textures, BVH, clusters, kd-tree, sweep, animated
instances) are not ported; convert.py refuses scenes that carry them.
"""

from __future__ import annotations

from typing import Optional

import torch

from .core.tensorclass import tensorclass
from .lights.buffers import LightBuffers
from .materials.buffers import MAT_DIFFUSE, MaterialBuffers
from .ops.smallscene import SmallTriAccel, build_smallscene
from .shapes.geometry import GeometryBuffers


@tensorclass
class Scene:
    geom: GeometryBuffers
    materials: MaterialBuffers
    lights: LightBuffers
    # Brute-force small-scene intersector (ops/smallscene.py, kernel K1).
    small: Optional[SmallTriAccel] = None

    def __post_init__(self):
        # Only the diffuse family is shaded yet; materials nothing
        # references (e.g. the Cornell list's copper and glass rows) are
        # carried as data.
        used = torch.unique(self.geom.tri_mat.detach().cpu().long())
        kinds = self.materials.kind.detach().cpu().long()
        bad = sorted(
            {int(kinds[m]) for m in used.tolist()} - {MAT_DIFFUSE}
        )
        if bad:
            raise NotImplementedError(
                f"geometry references material kind(s) {bad}; only diffuse "
                "(kind 0) is ported yet (ROADMAP Queue 1 item 10)"
            )

    def with_accel(self, threshold: int = 1024, kind: str = "auto") -> "Scene":
        """Attach the small-scene intersector (kernel K1).

        Only the tier for scenes of up to `threshold` triangles is ported;
        larger scenes and explicit accelerator kinds raise.
        """
        if kind != "auto":
            raise NotImplementedError(
                f"accelerator kind {kind!r} is not ported yet (ROADMAP Queue "
                "1 items 6-7)"
            )
        n_tri = self.geom.num_triangles
        if n_tri == 0:
            return self
        if n_tri > threshold:
            raise NotImplementedError(
                f"{n_tri} triangles exceed the small-scene tier ({threshold});"
                " the cluster and sweep accelerators are not ported yet "
                "(ROADMAP Queue 1 items 6-7)"
            )
        small = build_smallscene(
            self.geom.tri_verts.detach().cpu().numpy(),
            self.geom.tri_mat.detach().cpu().numpy(),
            self.geom.tri_light.detach().cpu().numpy(),
        )
        return self.replace(small=small.to(self.geom.tri_verts.device))
