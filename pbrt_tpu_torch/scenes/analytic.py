"""Analytic scenes with closed-form radiance, for correctness gates (port
of pbrt_tpu/scenes/analytic.py).

The reference's integrator test scene (integrators_test.cpp:71-97): a
diffuse unit sphere around the camera with a point light at its centre.
With albedo rho and a spectrally flat intensity I, the first-bounce
irradiance on the wall is E = I / r^2 = I, and the equilibrium radiance
seen from inside is L = rho E / (pi (1 - rho)): with I = pi and rho = 0.5,
exactly 1 at every wavelength.
"""

from __future__ import annotations

import numpy as np

from ..cameras.perspective import PerspectiveCamera
from ..core import transform
from ..lights.buffers import LightBuffers
from ..materials.buffers import MAT_DIFFUSE, MaterialBuffers
from ..scene import Scene
from ..shapes.geometry import GeometryBuffers


def furnace_sphere_scene(albedo=0.5, intensity=np.pi, resolution=(10, 10)):
    """Camera and point light at the centre of a diffuse unit sphere; the
    expected radiance is albedo I / (pi (1 - albedo)) (1.0 by default).
    The scene has no triangles, so it needs no triangle accelerator: the
    sphere answers every query."""
    geom = GeometryBuffers.build(
        spheres=np.array([[0.0, 0.0, 0.0, 1.0]], np.float32),
        sph_mat=np.array([0], np.int32),
    )
    gray = (albedo, albedo, albedo)
    materials = MaterialBuffers.build([{"kind": MAT_DIFFUSE, "albedo": gray}])
    # RGB (1, 1, 1) with the illuminant off evaluates to exactly
    # `intensity` at every wavelength.
    lights = LightBuffers.build(points=[{
        "p": (0.0, 0.0, 0.0), "rgb": (1.0, 1.0, 1.0), "scale": intensity,
        "illuminant": False,
    }])
    scene = Scene(geom=geom, materials=materials, lights=lights)
    camera = PerspectiveCamera(
        camera_to_world=transform.Transform.from_matrix(np.eye(4, dtype=np.float32)),
        resolution=resolution,
        fov_deg=45.0,
    )
    return scene, camera
