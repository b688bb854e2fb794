"""Scene container (port of pbrt_tpu/scene.py).

Geometry, materials and lights as flat tensors, plus the triangle
accelerator the scene carries: the small-scene table (K1) or the Morton
clusters (K2), which `with_accel()` attaches, the instanced sweep tables
(K3), which the parser attaches to scenes with object instances and
`with_accel(kind="sweep")` to any scene, the implicit-heap BVH (K4),
attached as in the reference with
`scene.replace(small=None, clusters=None, bvh=build_bvh(tri_verts))`, or
the SAH kd-tree (`with_kdtree()`). accel/api.py states which tier answers
when several are attached. The texture tables (textures/buffers.py) and
the participating media (media/medium.py: the scene-level medium and the
interior-media stack, which models/volpath.py renders) ride along as in
the reference, and so do the animated instances (accel/instances.py:
moving ObjectInstances, intersected per ray time after the triangle
tier). The triangles of instanced prototypes are in object space: a
scene whose sweep is instanced, or that carries animated instances,
takes no other tier.
"""

from __future__ import annotations

from typing import FrozenSet, Optional

import torch

from .accel.bvh import BVH
from .accel.instances import AnimatedInstances
from .accel.kdtree import KdTree, build_kdtree
from .core.tensorclass import static_field, tensorclass
from .lights.buffers import LightBuffers
from .materials.buffers import MAT_MIX, MaterialBuffers
from .media.medium import MediumBuffers, MediumStack
from .ops.cluster import ClusterAccel, build_clusters
from .ops.smallscene import SmallTriAccel, build_smallscene
from .ops.sweep import SweepAccel, build_sweep
from .shapes.geometry import GeometryBuffers
from .textures.buffers import TextureBuffers

# Material kinds the port shades (materials/bxdf.py): every kind of the
# reference, 0 to 13. A mix row (10) resolves to a sub-material per ray
# before the gather.
SHADED_KINDS = frozenset(range(14))


@tensorclass
class Scene:
    geom: GeometryBuffers
    materials: MaterialBuffers
    lights: LightBuffers
    # Scene-level participating medium (None: vacuum everywhere).
    medium: Optional[MediumBuffers] = None
    # Shape-bounded interior media; rays switch by the per-material
    # med_inside / med_outside on transmission (per-shape MediumInterface).
    media_stack: Optional[MediumStack] = None
    # Texture tables (textures/buffers.py); materials bind them by id.
    textures: Optional[TextureBuffers] = None
    # Brute-force small-scene intersector (ops/smallscene.py, kernel K1).
    small: Optional[SmallTriAccel] = None
    # Morton cluster intersector (ops/cluster.py, kernel K2).
    clusters: Optional[ClusterAccel] = None
    # Instanced cluster sweep (ops/sweep.py, kernel K3); the only tier
    # that holds object instances.
    sweep: Optional[SweepAccel] = None
    # Implicit-heap BVH (accel/bvh.py, kernel K4).
    bvh: Optional[BVH] = None
    # SAH kd-tree (accel/kdtree.py); plain PyTorch on both devices.
    kdtree: Optional[KdTree] = None
    # Moving object instances (accel/instances.py), None without motion.
    anim: Optional[AnimatedInstances] = None
    # Material kinds the geometry references, with the kinds of a
    # referenced mix row's two sub-materials; the BxDF select chain runs
    # only their links (materials/bxdf.py). Derived, never passed.
    shaded_kinds: FrozenSet[int] = static_field(init=False, default=frozenset())

    def __post_init__(self):
        # A material nothing references is carried as data, and its kind's
        # link is not run. The reference resolves a mix one level deep: a
        # mix naming a mix leaves its lanes with kind 10, which no link
        # shades, as there.
        used = torch.unique(self.geom.all_mats().detach().cpu().long()).tolist()
        mats = self.materials
        kinds = mats.kind.detach().cpu().long()
        subs = [int(x) for m in used if int(kinds[m]) == MAT_MIX
                for x in (mats.mix_m0[m], mats.mix_m1[m])]
        if any(not 0 <= x < kinds.shape[0] for x in subs):
            raise ValueError(f"a mix material names sub-materials {subs}; "
                             f"the scene holds {kinds.shape[0]} materials")
        referenced = frozenset(int(kinds[m]) for m in used + subs)
        object.__setattr__(self, "shaded_kinds", referenced)
        bad = sorted(referenced - SHADED_KINDS)
        if bad:
            raise ValueError(f"geometry references unknown material "
                             f"kind(s) {bad}")
        # A referenced material's texture must exist: the overlay would
        # otherwise skip it (no tables) or clamp its id to another texture.
        tex = self.materials.albedo_tex.detach().cpu().long()
        bound = sorted({int(tex[m]) for m in used + subs} - {-1})
        n_tex = 0 if self.textures is None else self.textures.n_textures
        if bound and bound[-1] >= n_tex:
            raise ValueError(f"materials bind texture id(s) {bound}; the "
                             f"scene holds {n_tex} texture(s)")

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
        if ((self.sweep is not None and self.sweep.instanced)
                or self.anim is not None):
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
        tiers = dict(small=None, clusters=None, sweep=None, bvh=None,
                     kdtree=None)
        if kind == "auto" and n_tri <= threshold:
            return self.replace(**{**tiers,
                                   "small": build_smallscene(*args).to(dev)})
        if kind in ("auto", "cluster"):
            return self.replace(**{**tiers,
                                   "clusters": build_clusters(*args).to(dev)})
        if kind == "sweep":
            return self.replace(**{**tiers,
                                   "sweep": build_sweep(tri_verts).to(dev)})
        raise ValueError(
            f"unknown accelerator kind {kind!r}: with_accel takes 'auto', "
            "'cluster' or 'sweep' (attach a BVH with "
            "scene.replace(bvh=build_bvh(...)), a kd-tree with with_kdtree())"
        )

    def with_kdtree(self, max_prims: int = 4) -> "Scene":
        """Attach the SAH kd-tree (KdTreeAggregate analogue), keeping any
        other tier, as the reference does."""
        if self.geom.num_triangles == 0:
            return self
        return self.replace(kdtree=build_kdtree(
            self.geom.tri_verts.detach().cpu().numpy(), max_prims=max_prims,
        ).to(self.geom.tri_verts.device))
