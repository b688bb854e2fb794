"""Scene container (port of pbrt_tpu/scene.py).

Geometry, materials and lights as flat tensors, plus the one triangle
accelerator the scene carries: the small-scene table (K1) or the Morton
clusters (K2), which `with_accel()` attaches, or the instanced sweep
tables (K3), which the parser attaches to scenes with object instances and
`with_accel(kind="sweep")` to any scene. The reference's other optional
members (media, textures, BVH, kd-tree, animated instances) are not
ported; convert.py refuses scenes that carry them.
"""

from __future__ import annotations

from typing import FrozenSet, Optional

import torch

from .core.tensorclass import static_field, tensorclass
from .lights.buffers import LightBuffers
from .materials.buffers import MAT_CONDUCTOR, MAT_DIFFUSE, MaterialBuffers
from .ops.cluster import ClusterAccel, build_clusters
from .ops.smallscene import SmallTriAccel, build_smallscene
from .ops.sweep import SweepAccel, build_sweep
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
    # Instanced cluster sweep (ops/sweep.py, kernel K3); the only tier
    # that holds object instances.
    sweep: Optional[SweepAccel] = None
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
        default. kind="sweep": the sweep tables (K3) with one identity
        instance. Exactly one tier is attached; any other is dropped. The
        reference's PBRT_TPU_ACCEL variable is not read.
        """
        n_tri = self.geom.num_triangles
        if n_tri == 0:
            return self
        if self.sweep is not None and self.sweep.instanced:
            raise ValueError(
                "the scene's triangles are instance prototypes in object "
                "space; another tier would drop the instances"
            )
        tri_verts = self.geom.tri_verts.detach().cpu().numpy()
        args = (
            tri_verts,
            self.geom.tri_mat.detach().cpu().numpy(),
            self.geom.tri_light.detach().cpu().numpy(),
        )
        dev = self.geom.tri_verts.device
        tiers = dict(small=None, clusters=None, sweep=None)
        if kind == "auto" and n_tri <= threshold:
            return self.replace(**{**tiers,
                                   "small": build_smallscene(*args).to(dev)})
        if kind in ("auto", "cluster"):
            return self.replace(**{**tiers,
                                   "clusters": build_clusters(*args).to(dev)})
        if kind == "sweep":
            return self.replace(**{**tiers,
                                   "sweep": build_sweep(tri_verts).to(dev)})
        raise NotImplementedError(
            f"accelerator kind {kind!r} is not ported yet: the BVH and "
            "kd-tree tiers are ROADMAP Queue 1 item 8"
        )
