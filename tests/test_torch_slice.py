"""The port's forward slice against the JAX reference on the CPU: the path
integrator per sample, rendered images, and the committed golden image that
chip_smoke.py also compares the card's render with.

The reference's CPU path answers hit queries with its dense watertight
tester while the port uses Moller-Trumbore (K1's twin), so a ray through a
shared edge may take another path: the gates count agreeing samples and
pixels (>= 99%) instead of comparing means. The reference's pass and
render are committed (tests/data/torch_port/reference_answers.npz,
scripts/make_torch_port_golden_answers.py); each test checks a digest of
the reference's scene, camera and settings, built live here.
"""

import os

import numpy as np
import pytest
import torch

from pbrt_tpu.core.spectrum import N_SPECTRUM
from pbrt_tpu.models.path import PathIntegrator as JPathIntegrator
from pbrt_tpu.scenes.cornell import cornell_box as jax_cornell_box
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.render import camera_rays_full, render
from pbrt_tpu_torch.scenes.cornell import cornell_box

from .torch_port_helpers import (
    port_scene_and_camera,
    reference_answers,
    reference_trace,
    render_digest,
    share_close,
)

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_port",
                      "cornell32_spp16.npy")


# test_render_image's render (the reference's is committed).
RENDER_KW = dict(spp=4, samples_per_pass=2, seed=3)


def reference_inputs():
    """The reference's Cornell box at 16x16 with its small tier attached
    (which its CPU path skips: the dense tester answers)."""
    js, jc = jax_cornell_box(resolution=(16, 16))
    return js.with_accel(), jc


@pytest.fixture(scope="module")
def cornell16():
    js, jc = reference_inputs()
    return (js, jc), port_scene_and_camera(js, jc)


def test_trace_with_stats_per_sample(cornell16):
    (js, jc), (ps, pc) = cornell16
    npix, k = 16 * 16, 2
    want = reference_trace("trace/cornell16", js, jc,
                           JPathIntegrator(max_depth=5), 16, k)
    pixel = np.tile(np.arange(npix, dtype=np.int32), k)
    sample = np.repeat(np.arange(k, dtype=np.int32), npix)
    tpix, tsam = torch.from_numpy(pixel), torch.from_numpy(sample)
    po, pd, pwl, _ = camera_rays_full(pc, tpix, tsam, 0, n_spectrum=N_SPECTRUM)
    pL, pstats = PathIntegrator(max_depth=5).trace_with_stats(
        ps, po, pd, pwl, tpix, tsam, 0
    )
    assert pL.shape == (npix * k, N_SPECTRUM)
    assert torch.isfinite(pL).all()
    j_rays, p_rays = float(want["rays"]), float(pstats["rays"])
    assert abs(p_rays - j_rays) <= 0.005 * j_rays, (p_rays, j_rays)
    jL = want["L"]
    sample_ok = np.all(
        np.abs(pL.numpy() - jL) <= 1e-5 + 1e-3 * np.abs(jL), axis=-1
    )
    n_bad = int(np.sum(~sample_ok))
    print(f"samples disagreeing with the reference: {n_bad} of {len(sample_ok)}")
    assert np.mean(sample_ok) >= 0.99, n_bad


def test_render_image(cornell16):
    (js, jc), (ps, pc) = cornell16
    want = reference_answers("render/cornell16", render_digest(
        js, jc, JPathIntegrator(max_depth=5), **RENDER_KW))["img"]
    got = render(ps, pc, PathIntegrator(max_depth=5), n_spectrum=N_SPECTRUM,
                 device="cpu", **RENDER_KW).numpy()
    assert got.shape == want.shape == (16, 16, 3)
    share, n_bad = share_close(got, want, rtol=1e-3, atol=1e-5)
    print(f"pixel values disagreeing with the reference: {n_bad}")
    assert share >= 0.99, n_bad


def test_port_render_matches_golden():
    """Same render as chip_smoke.py phase (d), on the CPU: the outlier count
    here is the baseline for the card's gate."""
    golden = np.load(GOLDEN)
    scene, camera = cornell_box(resolution=(32, 32))
    img = render(scene.with_accel(), camera, PathIntegrator(max_depth=5),
                 spp=16, seed=0, samples_per_pass=4, n_spectrum=32,
                 device="cpu").numpy()
    assert np.all(np.isfinite(img))
    share, n_bad = share_close(img, golden, rtol=1e-3, atol=1e-5)
    print(f"pixel values off the golden: {n_bad} of {img.size}")
    assert share >= 0.99, n_bad
