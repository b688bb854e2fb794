"""The many-light hall (scenes/manylight.py, bench.py's manylight_fwd
scene) in the port against the reference on the CPU.

- The full hall (1,024 panels: 2,048 area lights, 2,338 triangles) with
  the power sampler builds bit-equal to the reference's: geometry,
  materials, light tables and the Morton clusters (K2's tier).
- The hall cut to 16 lights at 16x16, 2 spp, depth 3 without Russian
  roulette, 8 lanes, with the power and with the light-BVH sampler (whose
  tables the fixture holds bit-equal too), per sample against the
  reference's jitted trace with its dense tester
  (tests/data/torch_port/manylight16_{power,bvh}_samples.npz, from
  scripts/make_torch_port_golden_manylight.py), both walks on coarse keys
  (tests/torch_port_coated.py): the same ray count, >= 99% of per-sample
  values within rtol 1e-3 / atol 1e-5, the image mean within rtol 1e-3.
  With the exact keys the port's image mean is within 0.3% of the
  reference's (the walk then draws other numbers on the lanes whose
  directions round differently; the test prints that share).
- The port's pass takes the sorted dispatch (on by default here: the
  floor is coated; its tile cut to 64 lanes so that 512 lanes sort), and
  gives the lockstep chain's samples bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from pbrt_tpu.scenes.manylight import manylight_scene as jax_manylight_scene
from pbrt_tpu_torch.materials import layered
from pbrt_tpu_torch.materials.buffers import MAT_COATEDDIFFUSE, MAT_DIFFUSE
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.ops import cluster
from pbrt_tpu_torch.render import camera_rays_full
from pbrt_tpu_torch.scenes.manylight import manylight_scene

from .torch_port_coated import coarse_walk_keys
from .torch_port_helpers import flatten_jax, share_close

torch.set_num_threads(2)
RES, SPP, DEPTH, S = 16, 2, 3, 8


def _assert_same_tables(ps, js):
    port, _ = flatten_jax(ps)
    ref, ref_static = flatten_jax(js)
    for path, value in port.items():
        want = ref[path]
        assert value.shape == want.shape, path
        np.testing.assert_array_equal(value, want.astype(value.dtype),
                                      err_msg=path)
    # The port carries every geometry field; a reference field it does not
    # carry must be empty.
    for path in set(ref) - set(port):
        assert ref[path].size == 0, path
    assert ps.lights.sampler == ref_static["lights.sampler"]


def test_full_hall_builds_bit_equal():
    ps, pc = manylight_scene(resolution=(256, 256))
    js, jc = jax_manylight_scene(resolution=(256, 256))
    assert ps.geom.num_triangles == 2338 and ps.lights.n_area == 2048
    assert ps.clusters is not None and ps.small is None
    assert ps.shaded_kinds == {MAT_DIFFUSE, MAT_COATEDDIFFUSE}
    _assert_same_tables(ps, js)
    np.testing.assert_array_equal(pc.camera_to_world.m.numpy(),
                                  np.asarray(jc.camera_to_world.m))


DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")


@pytest.fixture(scope="module", params=["power", "bvh"])
def traced(request):
    sampler = request.param
    golden = np.load(os.path.join(DATA, f"manylight16_{sampler}_samples.npz"))
    assert (int(golden["resolution"]), int(golden["spp"]),
            int(golden["max_depth"]), int(golden["n_spectrum"])) == (
                RES, SPP, DEPTH, S)
    js, _ = jax_manylight_scene(resolution=(RES, RES), n_lights=16,
                                sampler=sampler)
    ps, pc = manylight_scene(resolution=(RES, RES), n_lights=16,
                             sampler=sampler)
    _assert_same_tables(ps, js)
    npix = RES * RES
    pixel = torch.arange(npix).repeat(SPP)
    sample = torch.arange(SPP).repeat_interleave(npix)
    po, pd, pwl, _ = camera_rays_full(pc, pixel, sample, 0, n_spectrum=S)
    integ = dict(max_depth=DEPTH, rr_start_depth=DEPTH)
    args = (ps, po, pd, pwl, pixel, sample, 0)
    with coarse_walk_keys(layered):
        cluster.STATS.reset()
        # A 64-lane sort tile, so that the 512 lanes take the sorted
        # dispatch (the default 8,192 would leave them lockstep).
        pL, pst = PathIntegrator(sort_tile=64, **integ).trace_with_stats(
            *args)
        assert cluster.STATS.launches == 0  # the CPU path takes the twin
        lockstep = PathIntegrator(sorted_shading=False, **integ).trace(*args)
    exact = PathIntegrator(**integ).trace(*args)
    return {"sampler": sampler, "jL": golden["radiance"],
            "j_rays": float(golden["rays"]), "pL": pL,
            "p_rays": float(pst["rays"]), "lockstep": lockstep,
            "exact": exact.numpy()}


def test_hall_per_sample(traced):
    jL, pL = traced["jL"], traced["pL"].numpy()
    assert pL.shape == jL.shape == (SPP * RES * RES, S)
    assert np.isfinite(pL).all() and traced["p_rays"] == traced["j_rays"]
    share, n_bad = share_close(pL, jL, rtol=1e-3, atol=1e-5)
    print(f"hall ({traced['sampler']}): {n_bad} of {jL.size} sample values "
          f"disagree (share {share:.5f})")
    assert share >= 0.99
    assert abs(pL.mean() - jL.mean()) <= 1e-3 * abs(jL.mean())
    assert jL.mean() > 0.1


def test_hall_exact_keys_mean(traced):
    jL, exact = traced["jL"], traced["exact"]
    share = share_close(exact, jL, rtol=1e-3, atol=1e-5)[0]
    print(f"hall ({traced['sampler']}), exact walk keys: share {share:.4f}, "
          f"mean {exact.mean():.6f} against {jL.mean():.6f}")
    assert np.isfinite(exact).all()
    assert abs(exact.mean() - jL.mean()) <= 3e-3 * abs(jL.mean())


def test_sorted_shading_equals_lockstep(traced):
    """The pass through the sorted dispatch (sort_tile 64) and the
    lockstep pass give the same samples bit for bit."""
    assert torch.equal(traced["pL"], traced["lockstep"])
