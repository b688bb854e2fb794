"""The port's Cornell scene and camera against the JAX build, and the
numpy conversion path (pbrt_tpu_torch.convert)."""

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
    from pbrt_tpu.ops.cluster import build_clusters
    from pbrt_tpu_torch.convert import scene_from_arrays

    js = jax_cornell[0]
    clustered = js.replace(small=None, clusters=build_clusters(
        np.asarray(js.geom.tri_verts), np.asarray(js.geom.tri_mat),
        np.asarray(js.geom.tri_light),
    ))
    with pytest.raises(NotImplementedError, match="item 6"):
        scene_from_arrays(*flatten_jax(clustered))
    sampler_bvh = js.replace(lights=js.lights.replace(sampler="bvh"))
    with pytest.raises(NotImplementedError, match="item 11"):
        scene_from_arrays(*flatten_jax(sampler_bvh))


def test_convert_refuses_unported_shapes():
    from pbrt_tpu_torch.convert import scene_from_arrays

    js, _ = jax_cornell_box(resolution=(8, 8), variant="specular")
    with pytest.raises(NotImplementedError, match="item 8"):
        scene_from_arrays(*flatten_jax(js))
