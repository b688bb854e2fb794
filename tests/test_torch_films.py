"""The port's films (pbrt_tpu_torch/films/sensor.py, gbuffer.py,
checkpoint.py) and chunked renders against the reference on the CPU.

- PixelSensor: the XYZ sensor's tables and matrix bit-equal to the
  reference's, the custom-curves sensor's matrix within 1e-6;
  to_sensor_rgb of numpy-seeded spectra within rtol 1e-5 of the
  reference's; the searchsorted + lerp interp bit-equal to jnp.interp,
  with its clamping at both ends.
- render_aovs of the Cornell box (32 x 32, 4 spp, 8 spectral buckets):
  every channel against scripts/make_torch_port_golden_cameras.py's JAX
  golden, >= 99% of the values within rtol 1e-3 / atol 1e-5 (the ids,
  the valid mask and the depth on every pixel the first hits agree on);
  spectral_basis_compress equal to the reference's on it.
- render_resumable stopped after one chunk and resumed equals the
  one-shot render_resumable bit for bit, and render_chunked the single
  render within float summation order.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import spectrum as jax_spectrum
from pbrt_tpu.films.gbuffer import spectral_basis_compress as jax_compress
from pbrt_tpu.films.sensor import PixelSensor as JaxSensor
from pbrt_tpu_torch.core import spectrum
from pbrt_tpu_torch.films.checkpoint import (
    load_checkpoint, render_resumable, save_checkpoint)
from pbrt_tpu_torch.films.gbuffer import render_aovs, spectral_basis_compress
from pbrt_tpu_torch.films.sensor import PixelSensor, interp
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.render import render, render_chunked
from pbrt_tpu_torch.scenes.cornell import cornell_box

from . import torch_port_cameras as C
from .torch_port_helpers import share_close

torch.set_num_threads(2)
_GOLDEN = np.load(C.GOLDEN)
AOV_CHANNELS = ("rgb", "p", "n", "uv", "depth", "albedo_rgb", "material_id",
                "prim_id", "valid", "variance", "spectral")


def _sensors():
    lam = np.linspace(400.0, 700.0, 61)
    curves = [np.exp(-0.5 * ((lam - c) / 30.0) ** 2) for c in (600, 540, 450)]
    return ((JaxSensor.xyz(0.8), PixelSensor.xyz(0.8)),
            (JaxSensor.from_curves(lam, *curves, imaging_ratio=1.5),
             PixelSensor.from_curves(lam, *curves, imaging_ratio=1.5)))


@pytest.mark.parametrize("which", [0, 1], ids=["xyz", "curves"])
def test_sensor_matches_reference(which):
    js, ts = _sensors()[which]
    for f in ("lam_grid", "response", "imaging_ratio"):
        assert np.array_equal(np.asarray(getattr(js, f)),
                              getattr(ts, f).numpy()), f
    np.testing.assert_allclose(ts.rgb_from_sensor.numpy(),
                               np.asarray(js.rgb_from_sensor), atol=1e-6)
    r = np.random.default_rng(3)
    u = r.random(512).astype(np.float32)
    n = jax_spectrum.N_SPECTRUM
    vals = r.random((512, n)).astype(np.float32)
    jwl = jax_spectrum.sample_visible(jnp.asarray(u))
    twl = spectrum.sample_visible(torch.from_numpy(u), n)
    got = ts.to_sensor_rgb(torch.from_numpy(vals), twl).numpy()
    want = np.asarray(js.to_sensor_rgb(jnp.asarray(vals), jwl))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_interp_is_jnp_interp():
    xp = np.linspace(395.0, 705.0, 128).astype(np.float32)
    fp = np.random.default_rng(4).random(128).astype(np.float32)
    x = np.concatenate([np.random.default_rng(5).uniform(380, 720, 4096),
                        xp, [xp[0], xp[-1], 380.0, 720.0]]).astype(np.float32)
    got = interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp))
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                                 jnp.asarray(fp)))
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.fixture(scope="module")
def aovs():
    scene, camera = cornell_box(resolution=(C.CFG["res"], C.CFG["res"]))
    return render_aovs(scene.with_accel(), camera,
                       PathIntegrator(max_depth=C.CFG["max_depth"]),
                       seed=C.CFG["seed"], n_spectrum=C.CFG["n_spectrum"],
                       device="cpu", **C.AOV_CFG)


@pytest.mark.parametrize("channel", AOV_CHANNELS)
def test_gbuffer_channel_matches_golden(aovs, channel):
    got = aovs[channel].numpy()
    want = _GOLDEN["aov_" + channel]
    assert got.shape == want.shape
    share, n_off = share_close(got, want, rtol=1e-3, atol=1e-5)
    assert share >= 0.99, (share, n_off)
    if channel in ("material_id", "prim_id", "valid"):
        assert np.array_equal(got, want)
    if channel == "spectral":
        gc, gb = spectral_basis_compress(aovs[channel], 4)
        wc, wb = jax_compress(want, 4)
        np.testing.assert_allclose(np.abs(gb), np.abs(np.asarray(wb)),
                                   atol=2e-3)


def test_checkpoint_resume_is_bit_equal(tmp_path):
    scene, camera = cornell_box(resolution=(8, 8))
    scene = scene.with_accel()
    integ = PathIntegrator(max_depth=3)
    kw = dict(seed=2, samples_per_pass=2, chunk_spp=4, sampler_kind="zsobol",
              filter_kind="gaussian", n_spectrum=8, device="cpu")
    whole = render_resumable(scene, camera, integ, 12,
                             str(tmp_path / "whole.npz"), **kw)
    # Stop after the first chunk: the state a killed render leaves.
    first = render(scene, camera, integ, spp=4, seed=2, samples_per_pass=2,
                   sample_offset=0, total_spp=12, sampler_kind="zsobol",
                   filter_kind="gaussian", n_spectrum=8, device="cpu")
    path = str(tmp_path / "resumed.npz")
    save_checkpoint(path, first * 4, 4, 12, 2)
    rgb_sum, done, total, seed = load_checkpoint(path, device="cpu")
    assert (done, total, seed) == (4, 12, 2)
    with pytest.raises(TypeError, match="device"):
        load_checkpoint(path)  # no default device: the caller names it
    assert torch.equal(rgb_sum, first * 4)
    resumed = render_resumable(scene, camera, integ, 12, path, **kw)
    assert torch.equal(resumed, whole)
    with pytest.raises(ValueError, match="12-spp render"):
        render_resumable(scene, camera, integ, 16, path, **kw)
    chunked = render_chunked(scene, camera, integ, spp=12, seed=2,
                             samples_per_pass=2, chunk_spp=4,
                             sampler_kind="zsobol", filter_kind="gaussian",
                             n_spectrum=8, device="cpu")
    one = render(scene, camera, integ, spp=12, seed=2, samples_per_pass=2,
                 sampler_kind="zsobol", filter_kind="gaussian", n_spectrum=8,
                 device="cpu")
    np.testing.assert_allclose(chunked.numpy(), one.numpy(), rtol=1e-5,
                               atol=1e-7)
    assert os.path.exists(path)
