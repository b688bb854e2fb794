"""The port's mesh builders, PLY I/O and scene conversion of the cluster
path against the reference on the CPU."""

import os

import numpy as np
import pytest
import torch

from pbrt_tpu.scenes import meshes as jmeshes
from pbrt_tpu_torch.io.ply import read_ply, write_ply
from pbrt_tpu_torch.scenes import meshes

from .torch_port_helpers import flatten_jax
from .torch_port_killeroo import small_killeroo_class_scene

torch.set_num_threads(2)


@pytest.mark.parametrize("name, kwargs", [
    ("icosphere", dict(subdiv=2, radius=0.55, center=(-0.75, 0.55, 0.2))),
    ("torus", dict(major=0.5, minor=0.18, nu=24, nv=12, center=(0.75, 0.22, 0.0))),
    ("fbm_blob", dict(subdiv=3, radius=0.62, center=(-0.55, 0.72, 0.15))),
    ("torus_knot", dict(p=2, q=3, tube=0.1, scale=0.55, nu=60, nv=12,
                        center=(0.75, 0.55, -0.1))),
])
def test_mesh_builders_bit_equal(name, kwargs):
    got = getattr(meshes, name)(**kwargs)
    want = getattr(jmeshes, name)(**kwargs)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_ply_round_trip(tmp_path):
    tris = meshes.torus_knot(2, 3, nu=40, nv=8)
    verts, inv = np.unique(tris.reshape(-1, 3).round(6), axis=0,
                           return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    path = os.path.join(tmp_path, "knot.ply")
    write_ply(path, verts, faces)
    rv, rf = read_ply(path)
    np.testing.assert_array_equal(rv, verts.astype(np.float32))
    np.testing.assert_array_equal(rf, faces)
    # The same bytes the reference's writer produces, read back the same.
    from pbrt_tpu.io.ply import read_ply as jread_ply
    from pbrt_tpu.io.ply import write_ply as jwrite_ply

    jpath = os.path.join(tmp_path, "knot_ref.ply")
    jwrite_ply(jpath, verts, faces)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    jv, jf = jread_ply(jpath)
    np.testing.assert_array_equal(rv, jv)
    np.testing.assert_array_equal(rf, jf)


def test_ascii_ply_fans_polygons(tmp_path):
    path = os.path.join(tmp_path, "quad.ply")
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 4\nproperty float x\n"
                "property float y\nproperty float z\nelement face 1\n"
                "property list uchar int vertex_indices\nend_header\n"
                "0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n")
    verts, faces = read_ply(path)
    assert verts.shape == (4, 3)
    np.testing.assert_array_equal(faces, [[0, 1, 2], [0, 2, 3]])


def test_convert_round_trips_clusters_and_infinite_light():
    from pbrt_tpu_torch.convert import scene_from_arrays

    js, _ = small_killeroo_class_scene("pbrt_tpu", (8, 8))
    ps, _ = small_killeroo_class_scene("pbrt_tpu_torch", (8, 8))
    arrays, static = flatten_jax(js)
    assert any(k.startswith("clusters.") for k in arrays)
    conv = scene_from_arrays(arrays, static)
    assert conv.small is None
    assert (conv.clusters.n_clusters, conv.clusters.n_supers) == (
        js.clusters.n_clusters, js.clusters.n_supers)
    for path, value in arrays.items():
        member, _, name = path.partition(".")
        if member in ("clusters", "lights") and "." not in name:
            got = getattr(getattr(conv, member), name, None)
            if got is not None:
                np.testing.assert_array_equal(got.numpy(), value, path)
    assert conv.lights.has_infinite and conv.lights.n_lights == 3
    # The port's own build gives the same tables.
    for key in ("v0x", "pid", "matf", "lightf", "boxes", "sboxes"):
        assert torch.equal(getattr(ps.clusters, key), getattr(conv.clusters, key))
    np.testing.assert_allclose(ps.lights.select_pmf.numpy(),
                               conv.lights.select_pmf.numpy())

