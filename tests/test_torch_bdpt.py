"""The port's bidirectional path tracer (pbrt_tpu_torch/models/bdpt.py)
against the reference on the CPU.

- BDPTIntegrator.trace of two samples on tests/goldens/bdpt.pbrt's room at
  16x16 (depth 5) against the reference's (committed by
  scripts/make_torch_port_golden_lighttransport.py), the t >= 2 radiance L
  and the t = 1 splat image held separately: >= 99% of the values within
  rtol 1e-3 / atol 1e-5 (both read 100%). A wrong camera-importance
  convention would move the whole splat image by a constant, so the
  splats are held on their own.
- render_bdpt at 16x16, 4 spp in passes of 2 against the reference's
  one-sample passes, the same gate; passes of 4 equal to passes of 1
  within float32 rounding of the film's sum.
- tests/test_bdpt.py's gates on the port: with MIS off, the strategy
  classes (0, 3) and (1, 2) estimate the same one-bounce transport (in
  process: no subprocess is needed), and BDPT's mean matches the path
  tracer's on the Cornell box within 0.025.
- A gradient request through BDPT raises (item 5).
"""

import os

import numpy as np
import pytest
import torch

from pbrt_tpu_torch.core import spectrum
from pbrt_tpu_torch.films.rgb import spectrum_to_rgb
from pbrt_tpu_torch.io.parser import load_pbrt
from pbrt_tpu_torch.models.bdpt import BDPTIntegrator, render_bdpt
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.render import render
from pbrt_tpu_torch.samplers.samplers import Sampler
from pbrt_tpu_torch.scenes.cornell import cornell_box

from .torch_port_helpers import share_close

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "torch_port")
ROOM = os.path.join(ROOT, "tests", "goldens", "bdpt.pbrt")


def _room(res):
    scene, camera, settings = load_pbrt(ROOM, device="cpu")
    assert isinstance(settings["integrator"], BDPTIntegrator)
    return scene, camera.replace(resolution=(res, res))


def test_trace_matches_reference_per_sample():
    z = np.load(os.path.join(DATA, "bdpt16_samples.npz"))
    res, lanes = int(z["cfg_resolution"]), int(z["cfg_n_spectrum"])
    scene, camera = _room(res)
    pixel = torch.arange(res * res)
    sampler = Sampler(seed=int(z["cfg_seed"]), kind="independent", spp=4,
                      nx=res)
    integ = BDPTIntegrator(max_depth=int(z["cfg_max_depth"]))
    for s in range(z["L"].shape[0]):
        wl = spectrum.sample_visible(sampler.get_1d(pixel, s, 4), lanes)
        L, splat, n = integ.trace(scene, camera, wl, pixel, s, sampler)
        assert n == res * res and L.shape == z["L"][s].shape
        for name, got, want in (("L", L, z["L"][s]),
                                ("splat", splat, z["splat"][s])):
            share, n_bad = share_close(got.numpy(), want, 1e-3, 1e-5)
            print(f"sample {s} {name}: {share:.4f}")
            assert share >= 0.99, (s, name, n_bad)
            assert want.mean() > 1e-3


def test_render_bdpt_matches_reference():
    want = np.load(os.path.join(DATA, "bdpt16_spp4.npy"))
    scene, camera = _room(want.shape[0])
    img = render_bdpt(scene, camera, spp=4, samples_per_pass=2, seed=0,
                      n_spectrum=8, device="cpu")
    share, n_bad = share_close(img.numpy(), want, 1e-3, 1e-5)
    assert share >= 0.99, n_bad
    one = render_bdpt(scene, camera, spp=4, samples_per_pass=1, seed=0,
                      n_spectrum=8, device="cpu")
    four = render_bdpt(scene, camera, spp=4, samples_per_pass=4, seed=0,
                       n_spectrum=8, device="cpu")
    np.testing.assert_allclose(four.numpy(), one.numpy(), rtol=1e-5,
                               atol=1e-7)


def test_strategy_classes_consistent():
    """tests/test_bdpt.py's check on the port, in process: with MIS off,
    (0, 3) and (1, 2) both estimate one-bounce direct lighting."""
    scene, camera = cornell_box(resolution=(10, 10))
    scene = scene.with_accel()
    spp = 64
    pixel = torch.arange(100).repeat(spp)
    sample = torch.arange(spp).repeat_interleave(100)
    sink = {}
    integ = BDPTIntegrator(max_depth=2, debug_sink=sink, disable_mis=True)
    sampler = Sampler(seed=3, kind="independent", spp=spp, nx=10)
    wl = spectrum.sample_visible(sampler.get_1d(pixel, sample, 4), 8)
    integ.trace(scene, camera, wl, pixel, sample, sampler)
    a, b = (float(spectrum_to_rgb(sink[k], wl).mean()) for k in ((0, 3),
                                                                  (1, 2)))
    assert abs(a - b) < 0.35 * max(a, b), (a, b)
    assert min(a, b) > 0.0


def test_bdpt_matches_path_cornell():
    """tests/test_bdpt.py's CheckSceneAverage-style gate on the port."""
    scene, camera = cornell_box(resolution=(10, 10))
    scene = scene.with_accel()
    img_p = render(scene, camera, PathIntegrator(max_depth=3), spp=80,
                   samples_per_pass=80, seed=1, n_spectrum=8, device="cpu")
    img_b = render_bdpt(scene, camera, spp=80, max_depth=3, seed=2,
                        samples_per_pass=40, n_spectrum=8, device="cpu")
    mp, mb = float(img_p.mean()), float(img_b.mean())
    assert abs(mp - mb) < 0.025, (mp, mb)


def test_bdpt_refuses_gradient():
    scene, camera = _room(8)
    scene.materials.albedo_coeffs.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        render_bdpt(scene, camera, spp=1, n_spectrum=4, device="cpu")
