"""The many-light hall (port of pbrt_tpu/scenes/manylight.py; bench.py's
manylight_fwd scene, BASELINE config 3: 1,024 lights).

A factory-floor hall: a grid of small emissive ceiling panels with
power-law intensities over a coated-diffuse floor with scattered diffuse
boxes. The numpy draws are the reference's, in its order, so the
geometry and the light tables are bit-equal to its build. The reference's
docstring promises a dim environment that its code never adds; the port
adds none either.
"""

from __future__ import annotations

import numpy as np

from ..cameras.perspective import PerspectiveCamera
from ..core import transform
from ..lights.buffers import LightBuffers
from ..materials.buffers import MAT_COATEDDIFFUSE, MAT_DIFFUSE, MaterialBuffers
from ..scene import Scene
from ..shapes.geometry import GeometryBuffers, make_box, make_quad


def manylight_scene(resolution=(256, 256), n_lights: int = 1024, seed=7,
                    sampler: str = "power"):
    """Returns (scene, camera) on the CPU, the accelerator attached
    (with_accel: the cluster tier, 2,338 triangles at 1,024 lights).
    n_lights must be a square; sampler is the light sampler."""
    r = np.random.default_rng(seed)
    side = int(np.sqrt(n_lights))
    if side * side != n_lights:
        raise ValueError(f"n_lights={n_lights} is not a square")

    tris, mats, tri_light = [], [], []
    area_specs = []

    # Ceiling panel grid at y = 6 over a 40 x 40 hall.
    pitch = 40.0 / side
    for i in range(side):
        for j in range(side):
            x = -20.0 + (i + 0.5) * pitch
            z = -20.0 + (j + 0.5) * pitch
            s = pitch * 0.3
            q = make_quad(
                (x - s, 6.0, z - s), (x + s, 6.0, z - s),
                (x + s, 6.0, z + s), (x - s, 6.0, z + s),
            )
            # Power-law intensities: a few dominant lights.
            scale = float(10.0 * r.pareto(1.5) + 0.2)
            hue = r.uniform(0.6, 1.0, 3)
            for k in range(2):
                tris.append(q[k])
                mats.append(0)
                tri_light.append(len(area_specs))
                area_specs.append(
                    {"verts": q[k], "rgb": tuple(hue), "scale": scale}
                )

    # Floor and scattered boxes.
    for q in make_quad((-20, 0, -20), (20, 0, -20), (20, 0, 20), (-20, 0, 20)):
        tris.append(q)
        mats.append(1)
        tri_light.append(-1)
    for _ in range(24):
        c = r.uniform(-15, 15, 2)
        w = r.uniform(0.4, 1.5, 2)
        h = r.uniform(0.5, 2.5)
        for t in make_box((c[0] - w[0], 0, c[1] - w[1]),
                          (c[0] + w[0], h, c[1] + w[1])):
            tris.append(t)
            mats.append(0)
            tri_light.append(-1)

    geom = GeometryBuffers.build(
        tri_verts=np.asarray(tris, np.float32),
        tri_mat=np.asarray(mats, np.int32),
        tri_light=np.asarray(tri_light, np.int32),
    )
    materials = MaterialBuffers.build(
        [
            {"kind": MAT_DIFFUSE, "albedo": (0.6, 0.6, 0.6)},
            {"kind": MAT_COATEDDIFFUSE, "albedo": (0.35, 0.35, 0.4),
             "coat_roughness": 0.08},
        ]
    )
    lights = LightBuffers.build(area_tris=area_specs, sampler=sampler)
    scene = Scene(geom=geom, materials=materials, lights=lights).with_accel()
    cam2world = transform.look_at(
        eye=(0.0, 2.2, -16.0), target=(0.0, 1.2, 0.0), up=(0.0, 1.0, 0.0)
    )
    camera = PerspectiveCamera(
        camera_to_world=cam2world, resolution=tuple(resolution), fov_deg=55.0
    )
    return scene, camera
