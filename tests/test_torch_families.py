"""The families box (tests/data/torch_port/families.pbrt: hair, subsurface,
measured from an RGL file, mix and retroreflective surfaces) through the
port on the CPU, against the reference.

- The port's parser builds the reference's scene bit for bit, and the
  reference's build carried through convert.scene_from_arrays is the
  port's build.
- One pass at 16x16, 2 spp, depth 5 against the reference's per-sample
  radiance (families16_samples.npz, scripts/make_torch_port_golden_families.py),
  both on coarse mix keys (tests/torch_port_families.py coarse_mix_keys):
  the same ray count (the subsurface probes counted) and >= 99.5% of the
  values within rtol 1e-3 / atol 1e-5 (all of them agree today).
- Sorted shading (every family on its own segment, the subsurface lanes
  as kind 13) bit-equal to the lockstep chain, with the exact keys.
- The subsurface lanes of the volumetric path (no subsurface step there,
  as in the reference) against kind8_volpath8_samples.npz.
"""

import numpy as np
import pytest
import torch

from pbrt_tpu_torch.io.parser import load_pbrt, load_pbrt_string
from pbrt_tpu_torch.materials import bxdf
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.render import camera_rays_full

from .torch_port_families import (
    DATA,
    FAMILIES_PBRT,
    SUBSURFACE_VOLPATH,
    coarse_mix_keys,
)
from .torch_port_helpers import assert_samples_match, flatten_jax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def families():
    return load_pbrt(FAMILIES_PBRT, device="cpu")


def _pass(scene, camera, integ, res, spp, n_spectrum=8):
    npix = res * res
    pixel = torch.arange(npix).repeat(spp)
    sample = torch.arange(spp).repeat_interleave(npix)
    o, d, wl, _ = camera_rays_full(camera.replace(resolution=(res, res)),
                                   pixel, sample, 0, n_spectrum=n_spectrum)
    with torch.no_grad():
        L, stats = integ.trace_with_stats(scene, o, d, wl, pixel, sample, 0)
    return L.numpy(), float(stats["rays"])


def test_build_matches_jax(families):
    from pbrt_tpu.io.parser import load_pbrt as jax_load_pbrt
    from pbrt_tpu_torch.convert import scene_from_arrays

    from .test_torch_parser import _assert_same_build

    jax_built = jax_load_pbrt(FAMILIES_PBRT)
    _assert_same_build(jax_built, families)
    scene = families[0]
    assert scene.shaded_kinds == {0, 1, 7, 8, 9, 10, 11}
    assert scene.small is not None and scene.materials.measured_coeffs.shape[0] == 1
    conv = scene_from_arrays(*flatten_jax(jax_built[0]))
    got, _ = flatten_jax(conv)
    for path, value in flatten_jax(scene)[0].items():
        np.testing.assert_array_equal(got[path], value, err_msg=path)
    assert conv.shaded_kinds == scene.shaded_kinds


def test_samples_match_jax(families):
    scene, camera, settings = families
    golden = np.load(f"{DATA}/families16_samples.npz")
    res, spp = int(golden["resolution"]), int(golden["spp"])
    with coarse_mix_keys(bxdf):
        pL, p_rays = _pass(scene, camera, settings["integrator"], res, spp)
    assert_samples_match(golden["radiance"], float(golden["rays"]), pL, p_rays,
                         share=0.995)


def test_sorted_matches_lockstep(families):
    """Every family on its own segment (sort_tile below the batch) against
    the select chain over all lanes: the same bits."""
    scene, camera, _ = families
    out = [_pass(scene, camera, PathIntegrator(max_depth=5,
                                               sorted_shading=on,
                                               sort_tile=64), 16, 2)
           for on in (True, False)]
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]


def test_volpath_subsurface_lanes_match_jax():
    scene, camera, settings = load_pbrt_string(SUBSURFACE_VOLPATH,
                                               device="cpu")
    assert scene.shaded_kinds == {0, 8}
    golden = np.load(f"{DATA}/kind8_volpath8_samples.npz")
    pL, p_rays = _pass(scene, camera, settings["integrator"],
                       int(golden["resolution"]), int(golden["spp"]))
    assert_samples_match(golden["radiance"], float(golden["rays"]), pL, p_rays,
                         share=0.995)
