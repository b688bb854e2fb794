"""The port's ambient-occlusion, random-walk, function and spectral-band
integrators, the parser's Integrator directive and the scene-file entry
(render.render_file) against the reference on the CPU.

- AO and random-walk traces of tests/goldens/bdpt.pbrt's room at 16x16, 2
  spp, and their 4 spp images, against the reference's (committed by
  scripts/make_torch_port_golden_lighttransport.py): >= 99% of the values
  within rtol 1e-3 / atol 1e-5 (AO reads 100%: a visibility test).
- FunctionIntegrator, every test function at 8x8, 4 spp: equal to the
  reference's within rtol 1e-6; another sampler raises (item 14).
- render_spectral on the room at 16x16, 4 bands, 2 spp a band: the RGB
  and the bands against the reference's, the same gate; the band-limited
  hero wavelengths within 1e-4 nm; tests/test_spectralpath.py's gate on
  the port (the sum of the bands' RGB within 15% of a full-range render's
  mean), with a camera factory.
- The parser builds bdpt, mlt, sppm, lightpath and function with the
  reference's parameters and defaults, and ambientocclusion and
  randomwalk as pbrt-v4 does; any other name raises ValueError (the
  reference renders it as a path trace), and so does a light tracer on a
  scene with media.
- render_file dispatches each integrator to its render loop.
- A gradient request through AO, the random walk or the band renders
  raises (item 5).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.io.parser import load_pbrt_string as jax_load_pbrt_string
from pbrt_tpu.models.spectralpath import (
    sample_band_wavelengths as jax_band_wavelengths)
from pbrt_tpu_torch.io.parser import load_pbrt, load_pbrt_string
from pbrt_tpu_torch.models.ao import (
    AOIntegrator, RandomWalkIntegrator, SimplePathIntegrator)
from pbrt_tpu_torch.models.bdpt import BDPTIntegrator
from pbrt_tpu_torch.models.function import FunctionIntegrator
from pbrt_tpu_torch.models.lightpath import LightPathIntegrator
from pbrt_tpu_torch.models.mlt import MLTIntegrator
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.models.spectralpath import (
    render_spectral, sample_band_wavelengths)
from pbrt_tpu_torch.models.sppm import SPPMIntegrator
from pbrt_tpu_torch.render import camera_rays_full, render, render_file

from .torch_port_helpers import flatten_jax, share_close

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "torch_port")
GOLDENS = os.path.join(ROOT, "tests", "goldens")
ROOM = os.path.join(GOLDENS, "bdpt.pbrt")


def _room(res):
    scene, camera, _ = load_pbrt(ROOM, device="cpu")
    return scene, camera.replace(resolution=(res, res))


@pytest.mark.parametrize("name", ["ao", "randomwalk"])
def test_ao_and_random_walk_match_reference(name):
    z = np.load(os.path.join(DATA, "ao16.npz"))
    res, spp = int(z["cfg_resolution"]), int(z["spp_samples"])
    lanes, seed = int(z["cfg_n_spectrum"]), int(z["cfg_seed"])
    scene, camera = _room(res)
    integ = (AOIntegrator() if name == "ao"
             else RandomWalkIntegrator(max_depth=int(z["cfg_max_depth"])))
    pixel = torch.arange(res * res).repeat(spp)
    sample = torch.arange(spp).repeat_interleave(res * res)
    o, d, wl, _ = camera_rays_full(camera, pixel, sample, seed,
                                   n_spectrum=lanes)
    L, stats = integ.trace_with_stats(scene, o, d, wl, pixel, sample, seed)
    share, n_bad = share_close(L.numpy(), z[name], 1e-3, 1e-5)
    assert share >= 0.99, n_bad
    assert float(stats["rays"]) > 0 and z[name].mean() > 1e-3
    img = render(scene, camera, integ, spp=int(z["spp_image"]),
                 samples_per_pass=int(z["spp_image"]), seed=seed,
                 n_spectrum=lanes, device="cpu")
    share, n_bad = share_close(img.numpy(), z[name + "_image"], 1e-3, 1e-5)
    assert share >= 0.99, n_bad


def test_simple_path_is_path_without_mis():
    integ = SimplePathIntegrator(max_depth=3, sample_lights=False)
    assert isinstance(integ, PathIntegrator)
    assert (integ.max_depth, integ.use_nee, integ.use_mis) == (3, False, False)


def test_function_integrator_matches_reference():
    z = np.load(os.path.join(DATA, "function8.npz"))
    res, spp = int(z["resolution"]), int(z["spp"])
    names = [k for k in z.files if k + "_exact" in z.files]
    assert len(names) == 6
    for name in names:
        est, exact = FunctionIntegrator(func=name).render(
            (res, res), spp, seed=int(z["cfg_seed"]), device="cpu")
        np.testing.assert_allclose(est.numpy(), z[name], rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        assert exact == float(z[name + "_exact"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        FunctionIntegrator().render((4, 4), 4, sampler_kind="halton",
                                    device="cpu")
    with pytest.raises(ValueError, match="unknown function"):
        FunctionIntegrator(func="cubic")


def test_band_wavelengths_match_reference():
    u = np.random.default_rng(2).random(512, dtype=np.float32)
    for lo, hi in ((360.0, 455.0), (607.5, 830.0)):
        want = jax_band_wavelengths(jnp.asarray(u), jnp.float32(lo),
                                    jnp.float32(hi))
        got = sample_band_wavelengths(torch.from_numpy(u), lo, hi,
                                      n_spectrum=want.lam.shape[-1])
        np.testing.assert_allclose(got.lam.numpy(), np.asarray(want.lam),
                                   rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got.pdf.numpy(), np.asarray(want.pdf))
        assert float(got.lam.min()) >= lo and float(got.lam.max()) <= hi


def test_spectral_bands_match_reference():
    z = np.load(os.path.join(DATA, "spectral16.npz"))
    scene, camera = _room(int(z["cfg_resolution"]))
    rgb, bands = render_spectral(
        scene, camera, n_bands=int(z["n_bands"]),
        spp_per_band=int(z["spp_per_band"]), seed=int(z["cfg_seed"]),
        max_depth=int(z["spectral_max_depth"]),
        n_spectrum=int(z["cfg_n_spectrum"]), device="cpu")
    for name, got in (("rgb", rgb), ("bands", bands)):
        share, n_bad = share_close(got.numpy(), z[name], 1e-3, 1e-5)
        assert share >= 0.99, (name, n_bad)
    assert z["bands"].mean() > 1e-4


def test_band_sum_matches_full_render():
    """tests/test_spectralpath.py's gate on the port, the camera given by
    a factory (the dispersion hook): the bands' summed RGB within 15% of a
    full-range render's mean."""
    scene, camera = _room(16)
    centres = []

    def factory(lam_c):
        centres.append(lam_c)
        return camera

    rgb, bands = render_spectral(scene, factory, n_bands=4, spp_per_band=8,
                                 max_depth=3, n_spectrum=8, device="cpu")
    full = render(scene, camera, PathIntegrator(max_depth=3), spp=32,
                  samples_per_pass=16, n_spectrum=8, device="cpu")
    assert bands.shape == (16, 16, 4) and bool((bands >= -1e-4).all())
    assert len(centres) == 5 and centres[1] < centres[-1]
    assert abs(float(rgb.mean()) - float(full.mean())) < 0.15 * float(
        full.mean())


_HEAD = """LookAt 0 1 -3  0 1 0  0 1 0
Camera "perspective" "float fov" 50
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
"""
_WORLD = """WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [4 4 4]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-0.5 2 -0.5  0.5 2 -0.5  0.5 2 0.5  -0.5 2 0.5]
AttributeEnd
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4]
"""


@pytest.mark.parametrize("line, cls, fields", [
    ('Integrator "bdpt" "integer maxdepth" 3', BDPTIntegrator,
     {"max_depth": 3}),
    ('Integrator "lightpath"', LightPathIntegrator, {"max_depth": 5}),
    ('Integrator "sppm" "integer maxdepth" 4 "float radius" 0.05',
     SPPMIntegrator, {"max_depth": 4, "initial_radius": 0.05,
                      "photons_per_iteration": 0, "k_candidates": 32}),
    ('Integrator "sppm"', SPPMIntegrator, {"initial_radius": 0.0}),
    ('Integrator "mlt" "integer maxdepth" 4 "integer chains" 128 '
     '"float sigma" 0.02 "float largestepprobability" 0.25', MLTIntegrator,
     {"n_chains": 128, "sigma": 0.02, "p_large": 0.25}),
    ('Integrator "mlt"', MLTIntegrator,
     {"n_chains": 4096, "sigma": 0.01, "p_large": 0.3}),
    ('Integrator "function" "string function" "sin"', FunctionIntegrator,
     {"func": "sin"}),
    ('Integrator "function"', FunctionIntegrator, {"func": "quadratic"}),
], ids=["bdpt", "lightpath", "sppm", "sppm_defaults", "mlt",
        "mlt_defaults", "function", "function_default"])
def test_parser_builds_reference_integrators(line, cls, fields):
    text = _HEAD + line + "\n" + _WORLD
    _, _, jset = jax_load_pbrt_string(text)
    _, _, pset = load_pbrt_string(text, device="cpu")
    got, want = pset["integrator"], jset["integrator"]
    assert isinstance(got, cls) and type(want).__name__ == cls.__name__
    _, got_static = flatten_jax(got)
    _, want_static = flatten_jax(want)
    assert got_static.keys() <= want_static.keys()
    for key, value in got_static.items():
        assert value == want_static[key], key
    for key, value in fields.items():
        assert getattr(got, key) == value, key
    if cls is MLTIntegrator:
        assert got.base.max_depth == want.base.max_depth


def test_parser_integrator_names():
    for line, cls, fields in (
            ('Integrator "ambientocclusion" "float maxdistance" 2.5',
             AOIntegrator, {"max_distance": 2.5}),
            ('Integrator "randomwalk" "integer maxdepth" 3',
             RandomWalkIntegrator, {"max_depth": 3})):
        _, _, settings = load_pbrt_string(_HEAD + line + "\n" + _WORLD,
                                          device="cpu")
        integ = settings["integrator"]
        assert isinstance(integ, cls)
        assert all(getattr(integ, k) == v for k, v in fields.items())
    # The reference renders an unknown name as a path trace; the port
    # refuses it.
    with pytest.raises(ValueError, match="unknown Integrator 'aov'"):
        load_pbrt_string(_HEAD + 'Integrator "aov"\n' + _WORLD, device="cpu")
    with open(os.path.join(GOLDENS, "fog.pbrt")) as f:
        fog = f.read().replace('"volpath"', '"bdpt"')
    with pytest.raises(ValueError, match="does not trace participating"):
        load_pbrt_string(fog, device="cpu")


@pytest.mark.parametrize("name, cls, spp", [
    ("bdpt", BDPTIntegrator, 1), ("sppm", SPPMIntegrator, 1),
    ("mlt", MLTIntegrator, 1)])
def test_render_file_dispatch(name, cls, spp, monkeypatch):
    from pbrt_tpu_torch.models import bdpt, mlt, sppm

    scene, camera, settings = load_pbrt(os.path.join(GOLDENS, name + ".pbrt"),
                                        device="cpu")
    assert isinstance(settings["integrator"], cls)
    calls = []
    for mod, attr in ((bdpt, "render_bdpt"), (mlt, "render_mlt"),
                      (sppm.SPPMIntegrator, "render")):
        fn = getattr(mod, attr)
        monkeypatch.setattr(mod, attr, lambda *a, _fn=fn, _n=attr, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    img = render_file(scene, camera.replace(resolution=(8, 8)), settings,
                      spp=spp, seed=1, n_spectrum=4, device="cpu")
    assert calls == [{"bdpt": "render_bdpt", "sppm": "render",
                      "mlt": "render_mlt"}[name]]
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())


def test_render_file_function_and_path():
    text = (_HEAD + 'Integrator "function" "string function" "linear"\n'
            + _WORLD)
    scene, camera, settings = load_pbrt_string(text, device="cpu")
    img = render_file(scene, camera, settings, spp=64, device="cpu")
    assert img.shape == (8, 8, 3)
    assert abs(float(img.mean()) - 0.5) < 0.05
    scene, camera, settings = load_pbrt_string(_HEAD + _WORLD, device="cpu")
    got = render_file(scene, camera, settings, spp=2, samples_per_pass=2,
                      n_spectrum=4, device="cpu")
    want = render(scene, camera, settings["integrator"], spp=2,
                  samples_per_pass=2, n_spectrum=4, device="cpu")
    assert torch.equal(got, want)


@pytest.mark.parametrize("which", ["ao", "randomwalk", "spectral"])
def test_gradient_refused(which):
    scene, camera = _room(8)
    scene.lights.area_scale.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        if which == "spectral":
            render_spectral(scene, camera, n_bands=2, spp_per_band=1,
                            n_spectrum=4, device="cpu")
        else:
            integ = (AOIntegrator() if which == "ao"
                     else RandomWalkIntegrator(max_depth=2))
            render(scene, camera, integ, spp=1, n_spectrum=4, device="cpu")
