"""The port's Cornell scene and camera against the JAX build, and the
numpy conversion path (pbrt_tpu_torch.convert)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core.spectrum import N_SPECTRUM
from pbrt_tpu.render import camera_rays_full as jax_camera_rays
from pbrt_tpu.scenes.cornell import cornell_box as jax_cornell_box
from pbrt_tpu_torch.render import camera_rays_full
from pbrt_tpu_torch.scenes.cornell import cornell_box

from .torch_port_helpers import flatten_jax, port_scene_and_camera

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_cornell():
    scene, camera = jax_cornell_box(resolution=(16, 12))
    return scene.with_accel(), camera


def test_cornell_build_matches_jax_field_by_field(jax_cornell):
    scene, _ = cornell_box(resolution=(16, 12))
    scene = scene.with_accel()
    got, got_static = flatten_jax(scene)
    want, want_static = flatten_jax(jax_cornell[0])
    assert set(got) <= set(want)
    for path, value in got.items():
        ref = want[path]
        assert value.shape == ref.shape, path
        if path == "small.table":
            np.testing.assert_array_equal(value, ref)  # bit-equal
        elif value.dtype.kind == "f":
            np.testing.assert_allclose(value, ref, rtol=1e-6, err_msg=path)
        else:
            np.testing.assert_array_equal(value, ref, err_msg=path)
    for path, value in got_static.items():
        assert value == want_static[path], path
    # Every reference array the port does not carry is empty or all zero.
    for path in set(want) - set(got):
        assert not np.any(want[path]), path


def test_specular_cornell_matches_jax():
    """The specular variant (a copper tall box, a glass sphere) builds the
    reference's scene bit for bit."""
    js, _ = jax_cornell_box(resolution=(16, 12), variant="specular")
    ps, _ = cornell_box(resolution=(16, 12), variant="specular")
    want, _ = flatten_jax(js)
    got, _ = flatten_jax(ps)
    from pbrt_tpu_torch.materials.buffers import (
        MAT_CONDUCTOR, MAT_DIELECTRIC, MAT_DIFFUSE)

    assert ps.geom.num_spheres == 1
    assert ps.shaded_kinds == {MAT_DIFFUSE, MAT_CONDUCTOR, MAT_DIELECTRIC}
    for path, value in got.items():
        np.testing.assert_array_equal(value, want[path], err_msg=path)


def test_convert_round_trip(jax_cornell):
    scene, camera = port_scene_and_camera(*jax_cornell)
    built, built_cam = cornell_box(resolution=(16, 12))
    built = built.with_accel()
    for (pa, a), (pb, b) in zip(
        sorted(flatten_jax(scene)[0].items()), sorted(flatten_jax(built)[0].items())
    ):
        assert pa == pb
        np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=pa)
    np.testing.assert_array_equal(scene.small.table.numpy(),
                                  np.asarray(jax_cornell[0].small.table))
    assert camera.resolution == built_cam.resolution == (16, 12)
    np.testing.assert_array_equal(camera.camera_to_world.m.numpy(),
                                  np.asarray(jax_cornell[1].camera_to_world.m))
    # And the converted scene converts back to the same arrays.
    arrays, _ = flatten_jax(jax_cornell[0])
    for path, value in flatten_jax(scene)[0].items():
        np.testing.assert_array_equal(value, arrays[path].astype(value.dtype))


def test_camera_rays_match(jax_cornell):
    _, jcam = jax_cornell
    _, cam = cornell_box(resolution=(16, 12))
    r = np.random.default_rng(0)
    pixel = r.integers(0, 16 * 12, 2048).astype(np.int32)
    sample = r.integers(0, 64, 2048).astype(np.int32)
    jo, jd, jwl, jw = jax_camera_rays(jcam, jnp.asarray(pixel),
                                      jnp.asarray(sample), 0)
    o, d, wl, w = camera_rays_full(cam, torch.from_numpy(pixel),
                                   torch.from_numpy(sample), 0,
                                   n_spectrum=N_SPECTRUM)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_allclose(wl.lam.numpy(), np.asarray(jwl.lam), rtol=1e-5)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


def test_convert_refuses_unported_members(jax_cornell):
    from pbrt_tpu.io.parser import load_pbrt_string as jax_load_pbrt_string
    from pbrt_tpu_torch.convert import scene_from_arrays

    js = jax_cornell[0]
    # The clusters (tests/test_torch_meshes.py), the BVH, the kd-tree
    # (tests/test_torch_bvh.py, tests/test_torch_kdtree.py) and the texture
    # tables (tests/test_torch_parser.py) convert, Ptex tables included.
    tri = ('Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0] '
           '"integer indices" [0 1 2]')
    textured, _, _ = jax_load_pbrt_string(
        'Texture "t" "spectrum" "checkerboard" '
        'Material "diffuse" "texture reflectance" "t" ' + tri)
    assert scene_from_arrays(*flatten_jax(textured)).textures.n_textures == 1
    ptex, _, _ = jax_load_pbrt_string(
        'Texture "t" "spectrum" "ptex" "string filename" "missing.ptx" '
        'Material "diffuse" "texture reflectance" "t" ' + tri)
    assert ptex.textures.has_ptex
    carried = scene_from_arrays(*flatten_jax(ptex)).textures
    assert carried.has_ptex and carried.ptex_res == ptex.textures.ptex_res
    for key in ("ptex_index", "ptex_flat", "ptex_base", "ptex_nfaces"):
        np.testing.assert_array_equal(getattr(carried, key).numpy(),
                                      np.asarray(getattr(ptex.textures, key)))
    # The light BVH and the exhaustive sampler's records convert, table
    # for table.
    from pbrt_tpu.lights import bvh as jax_light_bvh

    sampler_bvh = js.replace(lights=js.lights.replace(
        sampler="bvh", bvh=jax_light_bvh.LightBVH.build(js.lights)))
    port_bvh = scene_from_arrays(*flatten_jax(sampler_bvh)).lights.bvh
    assert port_bvh.max_depth == sampler_bvh.lights.bvh.max_depth == 1
    for name in ("nodes", "paths", "path_len"):
        np.testing.assert_array_equal(
            getattr(port_bvh, name).numpy(),
            np.asarray(getattr(sampler_bvh.lights.bvh, name)))
    recs = jax_light_bvh.pack_light_records(
        jax_light_bvh.light_bounds_arrays(js.lights))
    exhaustive = js.replace(lights=js.lights.replace(
        sampler="exhaustive", exh_recs=jnp.asarray(recs)))
    port = scene_from_arrays(*flatten_jax(exhaustive)).lights
    assert port.sampler == "exhaustive" and port.bvh is None
    np.testing.assert_array_equal(port.exh_recs.numpy(), recs)
    # The scene-level medium (the bench cloud's density grid) and the
    # interior-media stack (fog.pbrt's) convert, table for table.
    from pbrt_tpu.io.parser import load_pbrt as jax_load_pbrt
    from pbrt_tpu.scenes.cloud import cloud_scene as jax_cloud

    for ref, member in ((jax_cloud(resolution=(4, 4))[0], "medium"),
                        (jax_load_pbrt(os.path.join(
                            ROOT, "tests", "goldens", "fog.pbrt"))[0],
                         "media_stack")):
        port = scene_from_arrays(*flatten_jax(ref))
        want, want_static = flatten_jax(getattr(ref, member))
        got, got_static = flatten_jax(getattr(port, member))
        assert set(got) == set(want) and got_static == want_static
        for path, value in want.items():
            np.testing.assert_array_equal(got[path], value, err_msg=path)


@pytest.mark.parametrize("member", ["small", "clusters", "sweep", "bvh",
                                    "kdtree"])
def test_convert_refuses_unknown_accelerator_field(jax_cornell, member):
    """The port carries every field of the accelerators' classes, so a
    field of theirs it does not know is unknown, not unported: one that
    holds data raises ValueError naming it, and one that holds none is
    dropped."""
    from pbrt_tpu_torch.convert import scene_from_arrays

    arrays, static = flatten_jax(jax_cornell[0])
    path = f"{member}.no_such_field"
    with pytest.raises(ValueError, match=f"unknown scene field '{path}'"):
        scene_from_arrays({**arrays, path: np.ones(3, np.float32)}, static)
    with pytest.raises(ValueError, match=f"unknown scene field '{path}'"):
        scene_from_arrays(arrays, {**static, path: 1})
    if member == "small":
        scene = scene_from_arrays({**arrays, path: np.zeros(3)}, static)
        assert scene.small.n_tris == jax_cornell[0].small.n_tris


def test_convert_refuses_unported_shapes():
    """Every shape family converts now: a reference scene with spheres,
    curves, disks, cylinders, bilinear patches and alpha-masked triangles
    (constant and texture alpha) carries across convert.py bit for bit,
    and so does its alpha flag."""
    from pbrt_tpu.io.parser import load_pbrt_string as jax_load_pbrt_string
    from pbrt_tpu_torch.convert import scene_from_arrays

    js, _, _ = jax_load_pbrt_string(
        'Texture "c" "float" "checkerboard" '
        'Shape "disk" "float radius" 0.5 '
        'Shape "cylinder" "float radius" 0.2 '
        'Shape "sphere" "float radius" 0.3 '
        'Shape "bilinearmesh" "point3 P" [0 0 0 1 0 0 0 1 0 1 1 1] '
        'Shape "curve" "point3 P" [0 0 0 0 1 0 1 2 0 1 3 0] '
        '"float width" 0.1 '
        'Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0] '
        '"integer indices" [0 1 2] "float alpha" 0.5 '
        'Shape "trianglemesh" "point3 P" [0 0 1 1 0 1 0 1 1] '
        '"integer indices" [0 1 2] "texture alpha" "c"')
    g = js.geom
    assert (g.num_disks, g.num_cyls, g.num_spheres, g.num_blps) == (1, 1, 1, 1)
    assert g.num_curves > 0 and g.has_alpha
    arrays, static = flatten_jax(js)
    got, got_static = flatten_jax(scene_from_arrays(arrays, static))
    for path, value in arrays.items():
        if path.startswith("geom."):
            np.testing.assert_array_equal(got[path], value, err_msg=path)
    assert got_static["geom.has_alpha"] is True
