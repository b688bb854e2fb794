"""A small killeroo-class scene that both packages build from their own
builders, for the tests of the port's large-mesh slice."""

from __future__ import annotations

import importlib

import numpy as np


def small_killeroo_class_scene(pkg: str, resolution=(12, 12)):
    """killeroo_class_scene's materials, lights and camera around small
    meshes (an fBm blob of 1,280 and a torus knot of 1,440 triangles, 2,724
    triangles in all), built by `pkg` ("pbrt_tpu" or "pbrt_tpu_torch") from
    its own builders, with the cluster accelerator (with_accel(threshold=1)).
    Both packages have the same module paths and names."""

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    meshes = mod("scenes.meshes")
    mb = mod("materials.buffers")
    geometry = mod("shapes.geometry")
    blob = meshes.fbm_blob(3, radius=0.62, center=(-0.55, 0.72, 0.15))
    knot = meshes.torus_knot(2, 3, tube=0.1, scale=0.55, nu=60, nv=12,
                             center=(0.75, 0.55, -0.1))
    floor = geometry.make_quad((-3, 0, -3), (3, 0, -3), (3, 0, 3), (-3, 0, 3))
    light_quad = geometry.make_quad(
        (-0.8, 2.6, -0.8), (0.8, 2.6, -0.8), (0.8, 2.6, 0.8), (-0.8, 2.6, 0.8)
    )
    tri_verts = np.concatenate([blob, knot, floor, light_quad]).astype(np.float32)
    tri_mat = np.concatenate([np.full(len(blob), 3), np.full(len(knot), 1),
                              np.zeros(4)]).astype(np.int32)
    tri_light = np.full(len(tri_verts), -1, np.int32)
    tri_light[-2:] = [0, 1]
    materials = mb.MaterialBuffers.build([
        {"kind": mb.MAT_DIFFUSE, "albedo": (0.55, 0.52, 0.48)},
        {"kind": mb.MAT_CONDUCTOR, "conductor": "Cu", "roughness": 0.08},
        {"kind": mb.MAT_DIELECTRIC, "eta": 1.5},
        {"kind": mb.MAT_DIFFUSE, "albedo": (0.32, 0.28, 0.22)},
    ])
    lights = mod("lights.buffers").LightBuffers.build(
        area_tris=[
            {"verts": light_quad[0], "rgb": (1, 0.95, 0.9), "scale": 14.0},
            {"verts": light_quad[1], "rgb": (1, 0.95, 0.9), "scale": 14.0},
        ],
        infinite={"rgb": (0.35, 0.45, 0.7), "scale": 0.25},
    )
    geom = geometry.GeometryBuffers.build(
        tri_verts=tri_verts, tri_mat=tri_mat, tri_light=tri_light
    )
    scene = mod("scene").Scene(geom=geom, materials=materials, lights=lights)
    cam2world = mod("core.transform").look_at(
        eye=(0.0, 1.45, -3.0), target=(0.0, 0.6, 0.0), up=(0.0, 1.0, 0.0)
    )
    camera = mod("cameras.perspective").PerspectiveCamera(
        camera_to_world=cam2world, resolution=tuple(resolution), fov_deg=42.0
    )
    return scene.with_accel(threshold=1), camera
