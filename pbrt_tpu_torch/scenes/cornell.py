"""The Cornell box (port of pbrt_tpu/scenes/cornell.py, diffuse variant).

A 1x1x1 box with white floor/ceiling/back, red left wall, green right
wall, two interior boxes and a two-triangle area light below the ceiling.
The material list keeps the reference's unreferenced copper and glass
rows, so the tables match the JAX build row for row.
"""

from __future__ import annotations

import numpy as np

from ..cameras.perspective import PerspectiveCamera
from ..core import transform
from ..lights.buffers import LightBuffers
from ..materials.buffers import (
    MAT_CONDUCTOR,
    MAT_DIELECTRIC,
    MAT_DIFFUSE,
    MaterialBuffers,
)
from ..scene import Scene
from ..shapes.geometry import GeometryBuffers, make_box, make_quad

WHITE = (0.73, 0.73, 0.73)
RED = (0.65, 0.05, 0.05)
GREEN = (0.12, 0.45, 0.15)
LIGHT_RGB = (1.0, 0.8, 0.55)
LIGHT_SCALE = 18.0


def cornell_box(resolution=(256, 256), light_scale: float = LIGHT_SCALE,
                variant: str = "diffuse"):
    """Returns (scene, camera) on the CPU; box spans [0,1]^3, camera on -z.

    variant="specular" (rough copper box + glass sphere) needs spheres and
    the conductor/dielectric BxDFs, which are not ported yet.
    """
    if variant != "diffuse":
        raise NotImplementedError(
            f"cornell_box(variant={variant!r}) needs spheres (ROADMAP Queue 1"
            " item 8) and conductor/dielectric materials (item 10); only "
            "'diffuse' is ported"
        )
    tris = []
    mats = []

    def add(quads, mat_id):
        for q in quads:
            tris.append(q)
            mats.append(mat_id)

    # Materials: 0 white, 1 red, 2 green, 3 copper, 4 glass.
    material_list = [
        {"kind": MAT_DIFFUSE, "albedo": WHITE},
        {"kind": MAT_DIFFUSE, "albedo": RED},
        {"kind": MAT_DIFFUSE, "albedo": GREEN},
        {"kind": MAT_CONDUCTOR, "conductor": "Cu", "roughness": 0.01},
        {"kind": MAT_DIELECTRIC, "eta": 1.5, "roughness": 0.0},
    ]

    # Floor (y=0), ceiling (y=1), back wall (z=1): white.
    add(make_quad((0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)), 0)
    add(make_quad((0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)), 0)
    add(make_quad((0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)), 0)
    # Left wall (x=0): red; right wall (x=1): green.
    add(make_quad((0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)), 1)
    add(make_quad((1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)), 2)
    # Short box (front right) and tall box (back left), white.
    add(make_box((0.55, 0.0, 0.15), (0.85, 0.30, 0.45)), 0)
    add(make_box((0.15, 0.0, 0.50), (0.45, 0.60, 0.80)), 0)

    tri_verts = np.stack(tris)  # (T, 3, 3)
    tri_mat = np.asarray(mats, np.int32)
    tri_light = np.full(len(tris), -1, np.int32)

    # Ceiling light: quad slightly below the ceiling, facing down (-y).
    light_quads = make_quad(
        (0.35, 0.9995, 0.35),
        (0.65, 0.9995, 0.35),
        (0.65, 0.9995, 0.65),
        (0.35, 0.9995, 0.65),
    )
    area_lights = [
        {"verts": light_quads[0], "rgb": LIGHT_RGB, "scale": light_scale},
        {"verts": light_quads[1], "rgb": LIGHT_RGB, "scale": light_scale},
    ]
    for i, spec in enumerate(area_lights):
        tri_verts = np.concatenate([tri_verts, spec["verts"][None]], axis=0)
        tri_mat = np.append(tri_mat, 0).astype(np.int32)
        tri_light = np.append(tri_light, i).astype(np.int32)

    geom = GeometryBuffers.build(
        tri_verts=tri_verts, tri_mat=tri_mat, tri_light=tri_light
    )
    materials = MaterialBuffers.build(material_list)
    lights = LightBuffers.build(area_tris=area_lights)
    scene = Scene(geom=geom, materials=materials, lights=lights)

    cam2world = transform.look_at(
        eye=(0.5, 0.5, -1.45), target=(0.5, 0.5, 0.5), up=(0.0, 1.0, 0.0)
    )
    camera = PerspectiveCamera(
        camera_to_world=cam2world, resolution=tuple(resolution), fov_deg=39.0
    )
    return scene, camera
