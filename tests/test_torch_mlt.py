"""The port's PSS-MLT (pbrt_tpu_torch/models/mlt.py) and its erfinv
(pbrt_tpu_torch/core/floats.py) against the reference on the CPU.

- erfinv bit for bit against jax.scipy.special.erfinv on the inputs the
  Gaussian step makes (2z - 1 for the uniforms z = k / 2^24, clipped):
  every ERFINV_STRIDE-th k and the 65,536 next to each end (where the
  tail polynomial and XLA's log take over), and a 100,001-point grid of
  [-1, 1]. ERFINV_STRIDE = 1 holds all 2^24 (~10 s on two threads; it
  passes too).
- tests/test_mlt.py's replay gate on PSSSampler.
- On tests/goldens/mlt.pbrt's room at 16x16, 64 chains of 8 steps, depth
  5, against the reference (committed by
  scripts/make_torch_port_golden_lighttransport.py): the bootstrap's b
  within rtol 1e-5 and its chain starts equal; from those starts, each
  chain's acceptance at steps 0-3 equal on >= 99% of the chains (an ulp
  in a contribution can flip a test, and a flipped chain goes its own way
  for good, so chains are held step by step only for the first steps);
  the image on >= 99% of its values within rtol 1e-3 / atol 1e-5.
- tests/test_mlt.py's gates on the port: MLT's mean against the port's
  path tracer on the Cornell box within 0.03 with correlation > 0.9, and
  a black scene's black image.
- A gradient request through MLT raises (item 5).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu_torch.core.floats import erfinv
from pbrt_tpu_torch.io.parser import load_pbrt
from pbrt_tpu_torch.models.mlt import MLTIntegrator, PSSSampler, render_mlt
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.render import render
from pbrt_tpu_torch.scenes.analytic import furnace_sphere_scene
from pbrt_tpu_torch.scenes.cornell import cornell_box

from .torch_port_helpers import share_close

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "torch_port")
ROOM = os.path.join(ROOT, "tests", "goldens", "mlt.pbrt")


ERFINV_STRIDE = 7


def test_erfinv_bit_equal_to_xla():
    k = np.concatenate([np.arange(0, 1 << 24, ERFINV_STRIDE),
                        np.arange(1 << 16), np.arange((1 << 24) - (1 << 16),
                                                      1 << 24)])
    u = k.astype(np.float32) * np.float32(1.0 / (1 << 24))
    x = np.clip(np.float32(2.0) * u - np.float32(1.0), -0.99999994,
                0.99999994).astype(np.float32)
    x = np.concatenate([x, np.linspace(-1.0, 1.0, 100001, dtype=np.float32)])
    want = np.asarray(jax.jit(jax.scipy.special.erfinv)(jnp.asarray(x)))
    got = erfinv(torch.from_numpy(x)).numpy()
    bad = got.view(np.int32) != want.view(np.int32)
    assert not bad.any(), (int(bad.sum()), x[bad][:4])
    assert np.isinf(got[[-100001, -1]]).all()


def test_pss_sampler_replay():
    u = torch.arange(2 * 5 * 2, dtype=torch.float32).reshape(2, 5, 2) / 100.0
    s = PSSSampler(u=u)
    np.testing.assert_array_equal(s.get_1d(None, 0, 3).numpy(), u[:, 3, 0])
    a, b = s.get_2d(None, 0, 4)
    np.testing.assert_array_equal(a.numpy(), u[:, 4, 0])
    np.testing.assert_array_equal(b.numpy(), u[:, 4, 1])
    # Out-of-range dimensions clamp rather than wrap.
    np.testing.assert_array_equal(s.get_1d(None, 0, 99).numpy(), u[:, 4, 0])


def _chains(z):
    res = int(z["cfg_resolution"])
    scene, camera, settings = load_pbrt(ROOM, device="cpu")
    assert settings["integrator"].n_chains == 256  # the file's
    integ = MLTIntegrator(base=PathIntegrator(max_depth=int(z["cfg_max_depth"])),
                          n_chains=int(z["chains"]),
                          mutations_per_chain=int(z["steps"]))
    return scene, camera.replace(resolution=(res, res)), integ


def test_bootstrap_and_first_steps_match_reference():
    z = np.load(os.path.join(DATA, "mlt16.npz"))
    scene, camera, integ = _chains(z)
    seed, lanes = int(z["cfg_seed"]), int(z["cfg_n_spectrum"])
    b, u0 = integ._bootstrap(scene, camera, seed, lanes)
    assert b == pytest.approx(float(z["b"]), rel=1e-5)
    np.testing.assert_array_equal(u0.numpy(), z["u0"])
    state = integ.start(scene, camera, u0, lanes)
    accepted = z["accepted"]
    for t in range(accepted.shape[0]):
        state, acc = integ.step(scene, camera, state, t, b, seed, lanes)
        same = float(np.mean(acc.numpy() == accepted[t]))
        assert same >= 0.99, (t, same)
    assert 0.2 < accepted.mean() < 0.95


def test_image_matches_reference():
    z = np.load(os.path.join(DATA, "mlt16.npz"))
    scene, camera, integ = _chains(z)
    img = integ.render(scene, camera, seed=int(z["cfg_seed"]),
                       n_spectrum=int(z["cfg_n_spectrum"]), device="cpu")
    share, n_bad = share_close(img.numpy(), z["image"], 1e-3, 1e-5)
    assert share >= 0.99, n_bad
    assert z["image"].mean() > 0.01


def test_mlt_matches_path_cornell():
    """tests/test_mlt.py's gate on the port: the mean within 0.03 of the
    port's path tracer, and the image's structure with it."""
    scene, camera = cornell_box(resolution=(10, 10))
    scene = scene.with_accel()
    img_p = render(scene, camera, PathIntegrator(max_depth=3), spp=96,
                   samples_per_pass=96, seed=1, n_spectrum=8, device="cpu")
    img_m = render_mlt(scene, camera, max_depth=3, seed=2,
                       mutations_per_pixel=192, n_chains=2048, n_spectrum=8,
                       device="cpu")
    mp, mm = float(img_p.mean()), float(img_m.mean())
    assert bool(torch.isfinite(img_m).all())
    assert abs(mp - mm) < 0.03, (mp, mm)
    corr = np.corrcoef(img_p.mean(-1).flatten().numpy(),
                       img_m.mean(-1).flatten().numpy())[0, 1]
    assert corr > 0.9, corr


def test_mlt_zero_scene():
    scene, camera = furnace_sphere_scene(albedo=0.5, intensity=0.0,
                                         resolution=(6, 6))
    integ = MLTIntegrator(base=PathIntegrator(max_depth=2), n_chains=64,
                          mutations_per_chain=4)
    img = integ.render(scene, camera, seed=0, n_spectrum=4, device="cpu")
    assert bool(torch.isfinite(img).all()) and float(img.max()) == 0.0


def test_mlt_refuses_gradient():
    scene, camera, integ = _chains({"cfg_resolution": 8, "cfg_max_depth": 2,
                                    "chains": 16, "steps": 1})
    scene.lights.area_scale.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        integ.render(scene, camera, n_spectrum=4, device="cpu")
