"""Procedural mesh generators and the mesh benchmark scenes (port of
pbrt_tpu/scenes/meshes.py).

`killeroo_class_scene` is the large-mesh benchmark: an fBm blob and a
torus knot, 122,244 triangles in all, above the small-scene tier, so
`with_accel()` attaches the Morton clusters (kernel K2). Every builder
returns (scene, camera) on the CPU, as the reference's do.
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
from ..shapes.geometry import GeometryBuffers, make_quad


def icosphere(subdiv: int = 3, radius: float = 1.0, center=(0, 0, 0)):
    """Subdivided icosahedron -> (T, 3, 3) triangle array (T = 20 * 4^subdiv)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    tris = verts[faces]  # (20, 3, 3)
    for _ in range(subdiv):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab = (a + b) / 2
        bc = (b + c) / 2
        ca = (c + a) / 2
        for m in (ab, bc, ca):
            m /= np.linalg.norm(m, axis=1, keepdims=True)
        tris = np.concatenate(
            [
                np.stack([a, ab, ca], 1),
                np.stack([ab, b, bc], 1),
                np.stack([ca, bc, c], 1),
                np.stack([ab, bc, ca], 1),
            ]
        )
    return (tris * radius + np.asarray(center)).astype(np.float32)


def torus(major=1.0, minor=0.35, nu=64, nv=32, center=(0, 0, 0)):
    """Triangulated torus -> (T, 3, 3)."""
    u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    v = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    ug, vg = np.meshgrid(u, v, indexing="ij")

    def pt(ug, vg):
        x = (major + minor * np.cos(vg)) * np.cos(ug)
        z = (major + minor * np.cos(vg)) * np.sin(ug)
        y = minor * np.sin(vg)
        return np.stack([x, y, z], -1)

    p00 = pt(ug, vg)
    p10 = pt(np.roll(ug, -1, 0), np.roll(vg, -1, 0) * 0 + vg)
    p01 = pt(ug, np.roll(vg, -1, 1))
    p11 = pt(np.roll(ug, -1, 0), np.roll(vg, -1, 1))
    t1 = np.stack([p00, p10, p11], -2).reshape(-1, 3, 3)
    t2 = np.stack([p00, p11, p01], -2).reshape(-1, 3, 3)
    tris = np.concatenate([t1, t2]).astype(np.float32)
    return tris + np.asarray(center, np.float32)


def mesh_gallery_scene(resolution=(256, 256), subdiv=4):
    """Dense-mesh benchmark: a copper icosphere, a smooth glass torus (the
    dielectric BxDF, its side taken from the triangles' winding) and a
    diffuse icosphere on a floor, under a quad area light and a uniform
    infinite light: 15,620 triangles at subdiv=4 and 9,320 at subdiv=1,
    both on K2's cluster tier."""
    parts = []
    mats = []

    def add(tris, mat):
        parts.append(tris)
        mats.append(np.full(len(tris), mat, np.int32))

    add(icosphere(subdiv, radius=0.55, center=(-0.75, 0.55, 0.2)), 1)
    add(torus(0.5, 0.18, 96, 48, center=(0.75, 0.22, 0.0)), 2)
    add(icosphere(subdiv - 1, radius=0.45, center=(0.0, 0.45, 0.9)), 3)
    add(make_quad((-3, 0, -3), (3, 0, -3), (3, 0, 3), (-3, 0, 3)), 0)

    light_quad = make_quad(
        (-0.8, 2.5, -0.8), (0.8, 2.5, -0.8), (0.8, 2.5, 0.8), (-0.8, 2.5, 0.8)
    )
    tri_verts = np.concatenate(parts + [light_quad])
    tri_mat = np.concatenate(mats + [np.zeros(2, np.int32)])
    tri_light = np.full(len(tri_verts), -1, np.int32)
    tri_light[-2:] = [0, 1]

    materials = MaterialBuffers.build(
        [
            {"kind": MAT_DIFFUSE, "albedo": (0.5, 0.5, 0.5)},
            {"kind": MAT_CONDUCTOR, "conductor": "Cu", "roughness": 0.05},
            {"kind": MAT_DIELECTRIC, "eta": 1.5},
            {"kind": MAT_DIFFUSE, "albedo": (0.2, 0.35, 0.65)},
        ]
    )
    lights = LightBuffers.build(
        area_tris=[
            {"verts": light_quad[0], "rgb": (1, 0.95, 0.9), "scale": 12.0},
            {"verts": light_quad[1], "rgb": (1, 0.95, 0.9), "scale": 12.0},
        ],
        infinite={"rgb": (0.35, 0.45, 0.7), "scale": 0.3},
    )
    geom = GeometryBuffers.build(
        tri_verts=tri_verts, tri_mat=tri_mat, tri_light=tri_light
    )
    scene = Scene(geom=geom, materials=materials, lights=lights).with_accel()
    cam2world = transform.look_at(
        eye=(0.0, 1.3, -3.2), target=(0.0, 0.5, 0.0), up=(0.0, 1.0, 0.0)
    )
    camera = PerspectiveCamera(
        camera_to_world=cam2world, resolution=tuple(resolution), fov_deg=40.0
    )
    return scene, camera


def fbm_blob(subdiv: int = 6, radius: float = 0.8, center=(0, 0, 0),
             seed: int = 7, amp: float = 0.22):
    """Organic creature-class mesh: icosphere displaced by fBm noise along
    its normals — 20 * 4^subdiv triangles (subdiv 6 = 81,920) with the
    uneven curvature distribution of a scanned model (killeroo-class)."""
    tris = icosphere(subdiv, radius=1.0)  # unit, centered at origin
    v = tris.reshape(-1, 3)
    # fBm over direction (shared vertices displace identically because the
    # noise is a pure function of position): 4 octaves of value noise on a
    # hashed integer lattice.
    rng = np.random.default_rng(seed)
    grad_table = rng.normal(size=(256, 3)).astype(np.float32)

    def vnoise(p):
        pi = np.floor(p).astype(np.int64)
        pf = p - pi
        w = pf * pf * (3 - 2 * pf)
        acc = np.zeros(len(p), np.float32)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    c = pi + np.array([dx, dy, dz])
                    h = (c[:, 0] * 73856093 ^ c[:, 1] * 19349663
                         ^ c[:, 2] * 83492791) & 255
                    g = grad_table[h]
                    off = pf - np.array([dx, dy, dz], np.float32)
                    val = np.sum(g * off, axis=-1)
                    wx = w[:, 0] if dx else 1 - w[:, 0]
                    wy = w[:, 1] if dy else 1 - w[:, 1]
                    wz = w[:, 2] if dz else 1 - w[:, 2]
                    acc += val * wx * wy * wz
        return acc

    disp = np.zeros(len(v), np.float32)
    f, a = 2.1, 1.0
    for _ in range(4):
        disp += a * vnoise(v * f)
        f *= 2.03
        a *= 0.5
    v = v * (radius * (1.0 + amp * disp))[:, None]
    return (v.reshape(-1, 3, 3) + np.asarray(center, np.float32)).astype(
        np.float32
    )


def torus_knot(p: int = 2, q: int = 3, tube: float = 0.12, scale: float = 0.5,
               nu: int = 400, nv: int = 48, center=(0, 0, 0)):
    """Triangulated (p, q) torus-knot tube -> (2 * nu * nv, 3, 3)."""
    u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    r = 0.6 + 0.35 * np.cos(q * u)
    cx = r * np.cos(p * u)
    cz = r * np.sin(p * u)
    cy = 0.35 * np.sin(q * u)
    cpath = np.stack([cx, cy, cz], -1) * (scale / 0.95)
    tang = np.roll(cpath, -1, 0) - np.roll(cpath, 1, 0)
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    ref = np.array([0.0, 1.0, 0.0])
    b1 = np.cross(tang, ref)
    b1 /= np.maximum(np.linalg.norm(b1, axis=1, keepdims=True), 1e-8)
    b2 = np.cross(tang, b1)
    v = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    ring = (np.cos(v)[None, :, None] * b1[:, None, :]
            + np.sin(v)[None, :, None] * b2[:, None, :]) * tube
    pts = cpath[:, None, :] + ring  # (nu, nv, 3)
    p00 = pts
    p10 = np.roll(pts, -1, 0)
    p01 = np.roll(pts, -1, 1)
    p11 = np.roll(np.roll(pts, -1, 0), -1, 1)
    t1 = np.stack([p00, p10, p11], -2).reshape(-1, 3, 3)
    t2 = np.stack([p00, p11, p01], -2).reshape(-1, 3, 3)
    return (np.concatenate([t1, t2]) + np.asarray(center, np.float32)).astype(
        np.float32
    )


def killeroo_class_scene(resolution=(512, 512), ply_dir: str | None = None):
    """BASELINE config-2 class benchmark: a >=100k-triangle PLY-loaded mesh
    scene (fBm creature blob + torus knot + floor) under an area light.

    The heavy meshes round-trip through binary PLY (io/ply.py) so the bench
    exercises the same mesh-ingest path a killeroo.ply scene would
    (reference: scenes/killeroo-simple.pbrt uses Shape "plymesh").
    With ply_dir=None the PLY files go to a temporary directory that is
    removed afterwards.
    """
    import os
    import tempfile

    from ..io.ply import read_ply, write_ply

    parts, mats = [], []

    def add(tris, mat):
        parts.append(np.asarray(tris, np.float32))
        mats.append(np.full(len(tris), mat, np.int32))

    blob = fbm_blob(6, radius=0.62, center=(-0.55, 0.72, 0.15))
    knot = torus_knot(2, 3, tube=0.1, scale=0.55, nu=420, nv=48,
                      center=(0.75, 0.55, -0.1))

    # PLY round-trip (shared-vertex indexing) for the two hero meshes.
    with tempfile.TemporaryDirectory(prefix="pbrt_tpu_torch_ply_") as tmp:
        for name, tris_in in (("blob", blob), ("knot", knot)):
            path = os.path.join(ply_dir or tmp, f"{name}.ply")
            flat = tris_in.reshape(-1, 3)
            verts, inv = np.unique(flat.round(6), axis=0, return_inverse=True)
            faces = inv.reshape(-1, 3).astype(np.int32)
            write_ply(path, verts, faces)
            rv, rf = read_ply(path)
            add(rv[rf], 3 if name == "blob" else 1)

    add(make_quad((-3, 0, -3), (3, 0, -3), (3, 0, 3), (-3, 0, 3)), 0)

    light_quad = make_quad(
        (-0.8, 2.6, -0.8), (0.8, 2.6, -0.8), (0.8, 2.6, 0.8), (-0.8, 2.6, 0.8)
    )
    tri_verts = np.concatenate(parts + [light_quad])
    tri_mat = np.concatenate(mats + [np.zeros(2, np.int32)])
    tri_light = np.full(len(tri_verts), -1, np.int32)
    tri_light[-2:] = [0, 1]

    materials = MaterialBuffers.build(
        [
            {"kind": MAT_DIFFUSE, "albedo": (0.55, 0.52, 0.48)},
            {"kind": MAT_CONDUCTOR, "conductor": "Cu", "roughness": 0.08},
            {"kind": MAT_DIELECTRIC, "eta": 1.5},
            {"kind": MAT_DIFFUSE, "albedo": (0.32, 0.28, 0.22)},
        ]
    )
    lights = LightBuffers.build(
        area_tris=[
            {"verts": light_quad[0], "rgb": (1, 0.95, 0.9), "scale": 14.0},
            {"verts": light_quad[1], "rgb": (1, 0.95, 0.9), "scale": 14.0},
        ],
        infinite={"rgb": (0.35, 0.45, 0.7), "scale": 0.25},
    )
    geom = GeometryBuffers.build(
        tri_verts=tri_verts, tri_mat=tri_mat, tri_light=tri_light
    )
    scene = Scene(geom=geom, materials=materials, lights=lights).with_accel()
    cam2world = transform.look_at(
        eye=(0.0, 1.45, -3.0), target=(0.0, 0.6, 0.0), up=(0.0, 1.0, 0.0)
    )
    camera = PerspectiveCamera(
        camera_to_world=cam2world, resolution=tuple(resolution), fov_deg=42.0
    )
    return scene, camera
