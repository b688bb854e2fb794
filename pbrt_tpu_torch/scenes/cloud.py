"""Volumetric scenes (port of pbrt_tpu/scenes/cloud.py): bench.py's
cloud_fwd scene, a procedural density-grid cloud over a diffuse floor,
and the fog box, an analytic gate.

The density grid is made by the reference's numpy code, so it and every
table built from it are bit-equal to the reference's; no file is read.
Both builders attach the triangle accelerator (with_accel: K1's small
tier), as the port's scene builders do.
"""

from __future__ import annotations

import numpy as np

from ..cameras.perspective import PerspectiveCamera
from ..core import transform
from ..lights.buffers import LightBuffers
from ..materials.buffers import MAT_DIFFUSE, MaterialBuffers
from ..media.medium import MediumBuffers
from ..scene import Scene
from ..shapes.geometry import GeometryBuffers, make_quad


def _procedural_cloud(res=48, seed=0):
    """Smooth blobby density: a sum of gaussians, zero near the box
    boundary (the reference's float32 numpy, step for step)."""
    r = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:res, 0:res, 0:res].astype(np.float32) / (res - 1)
    dens = np.zeros((res, res, res), np.float32)
    for _ in range(6):
        c = r.uniform(0.25, 0.75, 3)
        s = r.uniform(0.08, 0.2)
        a = r.uniform(0.4, 1.0)
        dens += a * np.exp(
            -(((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) / (2 * s * s))
        )
    # Fade to zero at the borders.
    edge = np.minimum.reduce([x, 1 - x, y, 1 - y, z, 1 - z])
    dens *= np.clip(edge * 6.0, 0.0, 1.0)
    return np.clip(dens, 0.0, None)


def cloud_scene(resolution=(128, 128), sigma_scale=8.0, g=0.3,
                emissive=False):
    """A 48^3 density-grid cloud (DDA majorants on a 16^3 grid) over a
    diffuse floor, lit by a distant light and a dim uniform sky. Returns
    (scene, camera) on the CPU."""
    floor = make_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4))
    geom = GeometryBuffers.build(tri_verts=floor)
    mats = MaterialBuffers.build(
        [{"kind": MAT_DIFFUSE, "albedo": (0.4, 0.4, 0.4)}])
    lights = LightBuffers.build(
        distants=[{"dir": (0.3, -1.0, 0.2), "rgb": (1.0, 0.95, 0.9),
                   "scale": 3.0, "illuminant": False}],
        infinite={"rgb": (0.4, 0.55, 0.8), "scale": 0.25,
                  "illuminant": False},
    )
    medium = MediumBuffers.grid(
        density=_procedural_cloud(),
        sigma_a_rgb=(0.15, 0.15, 0.15),
        sigma_s_rgb=(1.0, 1.0, 1.0),
        bounds_lo=(-1.0, 0.6, -1.0),
        bounds_hi=(1.0, 2.6, 1.0),
        g=g,
        scale=sigma_scale,
        le_rgb=(1.0, 0.55, 0.25) if emissive else None,
        le_scale=2.0 if emissive else 0.0,
    )
    scene = Scene(geom=geom, materials=mats, lights=lights, medium=medium)
    cam2world = transform.look_at(
        eye=(0.0, 1.6, -4.5), target=(0.0, 1.4, 0.0), up=(0.0, 1.0, 0.0))
    camera = PerspectiveCamera(camera_to_world=cam2world,
                               resolution=resolution, fov_deg=45.0)
    return scene.with_accel(), camera


def fog_box_scene(sigma_a=1.0, sigma_s=0.0, resolution=(8, 8), le_scale=5.0):
    """Analytic gate: an emissive quad at z = 2 seen through a homogeneous
    slab z in [0.5, 1.5]: L = Le exp(-(sigma_a + sigma_s) * 1)."""
    light_quad = make_quad((-3, -3, 2.0), (-3, 3, 2.0), (3, 3, 2.0),
                           (3, -3, 2.0))
    # Winding: normal = cross(p1 - p0, p2 - p0) = -z (faces the camera).
    geom = GeometryBuffers.build(tri_verts=light_quad,
                                 tri_light=np.array([0, 1], np.int32))
    mats = MaterialBuffers.build([{"kind": MAT_DIFFUSE, "albedo": (0, 0, 0)}])
    lights = LightBuffers.build(area_tris=[
        {"verts": light_quad[0], "rgb": (1, 1, 1), "scale": le_scale,
         "illuminant": False},
        {"verts": light_quad[1], "rgb": (1, 1, 1), "scale": le_scale,
         "illuminant": False},
    ])
    medium = MediumBuffers.homogeneous(
        sigma_a_rgb=(sigma_a,) * 3, sigma_s_rgb=(sigma_s,) * 3,
        bounds_lo=(-10.0, -10.0, 0.5), bounds_hi=(10.0, 10.0, 1.5))
    scene = Scene(geom=geom, materials=mats, lights=lights, medium=medium)
    camera = PerspectiveCamera(
        camera_to_world=transform.Transform.from_matrix(np.eye(4)),
        resolution=resolution, fov_deg=30.0)
    return scene.with_accel(), camera
