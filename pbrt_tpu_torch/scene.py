"""Scene container (port of pbrt_tpu/scene.py).

Geometry, materials and lights as flat tensors, plus the triangle
accelerator once `with_accel()` has attached it: the small-scene table (K1)
or the Morton clusters (K2). The reference's other optional members
(media, textures, BVH, kd-tree, sweep, animated instances) are not ported;
convert.py refuses scenes that carry them.
"""

from __future__ import annotations

from typing import FrozenSet, Optional

import torch

from .core.tensorclass import static_field, tensorclass
from .lights.buffers import LightBuffers
from .materials.buffers import MAT_CONDUCTOR, MAT_DIFFUSE, MaterialBuffers
from .ops.cluster import ClusterAccel, build_clusters
from .ops.smallscene import SmallTriAccel, build_smallscene
from .shapes.geometry import GeometryBuffers

# Material families the BxDF select chain shades (materials/bxdf.py).
SHADED_KINDS = {MAT_DIFFUSE, MAT_CONDUCTOR}


@tensorclass
class Scene:
    geom: GeometryBuffers
    materials: MaterialBuffers
    lights: LightBuffers
    # Brute-force small-scene intersector (ops/smallscene.py, kernel K1).
    small: Optional[SmallTriAccel] = None
    # Morton cluster intersector (ops/cluster.py, kernel K2).
    clusters: Optional[ClusterAccel] = None
    # Material kinds the geometry references; the BxDF select chain runs
    # only their links (materials/bxdf.py). Derived, never passed.
    shaded_kinds: FrozenSet[int] = static_field(init=False, default=frozenset())

    def __post_init__(self):
        # Only the diffuse and conductor families are shaded yet; materials
        # nothing references (e.g. the Cornell list's glass and copper rows)
        # are carried as data.
        used = torch.unique(self.geom.tri_mat.detach().cpu().long())
        kinds = self.materials.kind.detach().cpu().long()
        referenced = frozenset(int(kinds[m]) for m in used.tolist())
        object.__setattr__(self, "shaded_kinds", referenced)
        bad = sorted(referenced - SHADED_KINDS)
        if bad:
            raise NotImplementedError(
                f"geometry references material kind(s) {bad}; only diffuse "
                "(kind 0) and conductor (kind 1) are ported yet (ROADMAP "
                "Queue 1 item 10)"
            )

    def with_accel(self, threshold: int = 1024, kind: str = "auto") -> "Scene":
        """Attach the triangle intersector fitting the scene size.

        Up to `threshold` triangles: the small-scene table (K1). Above it,
        or for kind="cluster": the Morton clusters (K2), the reference's
        default. Exactly one tier is attached; any other is dropped. The sweep accelerator (kind="sweep") is not ported; the
        reference's PBRT_TPU_ACCEL variable is not read.
        """
        n_tri = self.geom.num_triangles
        if n_tri == 0:
            return self
        args = (
            self.geom.tri_verts.detach().cpu().numpy(),
            self.geom.tri_mat.detach().cpu().numpy(),
            self.geom.tri_light.detach().cpu().numpy(),
        )
        dev = self.geom.tri_verts.device
        if kind == "auto" and n_tri <= threshold:
            return self.replace(small=build_smallscene(*args).to(dev),
                                clusters=None)
        if kind in ("auto", "cluster"):
            return self.replace(small=None,
                                clusters=build_clusters(*args).to(dev))
        raise NotImplementedError(
            f"accelerator kind {kind!r} is not ported yet (ROADMAP Queue 1 "
            "item 7); only the small-scene tier and 'cluster' are"
        )
