"""Keyword arguments of the reference's public functions that the port
takes with the reference's meaning, each held against the reference on a
small input:

- PixelSensor.from_curves(white_src=): not read (the fit is under D65);
- SimplePathIntegrator(sample_bsdf=): not read (the path always samples
  the BSDF);
- trace_through_stack(eta_start=): not read (each surface carries the
  indices on both its sides);
- BDPTIntegrator.trace(n_paths=): not read (the splats are normalised by
  the call's own paths);
- bake_measured(n_quad=): not read (one evaluation per cell);
- staged_masked_loop(stages=): the caller's stage plan. Its steps set the
  stage boundaries and the steps in all; the port sizes each stage from
  its live lanes, so its width divisors are not read, and the boundaries
  change no result.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from .torch_port_helpers import flatten_jax, share_close

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "torch_port")


def _white_src():
    from pbrt_tpu.films.sensor import PixelSensor as JSensor
    from pbrt_tpu_torch.films.sensor import PixelSensor

    lam = np.linspace(400.0, 700.0, 31)
    r = np.exp(-0.5 * ((lam - 600) / 40) ** 2)
    g = np.exp(-0.5 * ((lam - 540) / 40) ** 2)
    b = np.exp(-0.5 * ((lam - 450) / 30) ** 2)
    got = PixelSensor.from_curves(lam, r, g, b, white_src="stdillum-A")
    want = JSensor.from_curves(lam, r, g, b, white_src="stdillum-A")
    assert not got.is_xyz and not want.is_xyz
    for key in ("lam_grid", "response", "rgb_from_sensor", "imaging_ratio"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(want, key)), key)


def _sample_bsdf():
    from pbrt_tpu.models.ao import SimplePathIntegrator as JSimplePath
    from pbrt_tpu_torch.models.ao import SimplePathIntegrator

    for flag in (True, False):
        _, got = flatten_jax(SimplePathIntegrator(max_depth=3, sample_bsdf=flag))
        _, want = flatten_jax(JSimplePath(max_depth=3, sample_bsdf=flag))
        shared = got.keys() & want.keys()
        assert {"max_depth", "use_nee", "use_mis", "rr_start_depth"} <= shared
        for key in shared:
            assert got[key] == want[key], key


def _eta_start():
    from pbrt_tpu.cameras import lens as jlens
    from pbrt_tpu_torch.cameras import lens as tlens

    path = os.path.join(DATA, "doublet.dat")
    r = np.random.default_rng(0)
    n = 4096
    o = np.concatenate([r.uniform(-3, 3, (n, 2)), np.full((n, 1), -60.0)],
                       -1).astype(np.float32)
    d = np.concatenate([r.uniform(-0.05, 0.05, (n, 2)), np.ones((n, 1))],
                       -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jo, jd, jv = (np.asarray(x) for x in jlens.trace_through_stack(
        jlens.load_lens_file(path), jnp.asarray(o), jnp.asarray(d),
        eta_start=1.33))
    to, td, tv = (x.numpy() for x in tlens.trace_through_stack(
        tlens.load_lens_file(path), torch.from_numpy(o), torch.from_numpy(d),
        eta_start=1.33))
    assert np.mean(tv == jv) >= 0.999 and jv.mean() > 0.25
    both = tv & jv
    np.testing.assert_allclose(to[both], jo[both], rtol=0, atol=1e-5)
    assert np.abs(td[both] - jd[both]).max() < 1e-5


def _n_paths():
    """One sample of tests/test_torch_bdpt.py's per-sample golden, traced
    with n_paths, on that test's gate."""
    from pbrt_tpu_torch.core import spectrum
    from pbrt_tpu_torch.io.parser import load_pbrt
    from pbrt_tpu_torch.models.bdpt import BDPTIntegrator
    from pbrt_tpu_torch.samplers.samplers import Sampler

    z = np.load(os.path.join(DATA, "bdpt16_samples.npz"))
    res, lanes = int(z["cfg_resolution"]), int(z["cfg_n_spectrum"])
    scene, camera, _ = load_pbrt(os.path.join(ROOT, "tests", "goldens",
                                              "bdpt.pbrt"), device="cpu")
    camera = camera.replace(resolution=(res, res))
    pixel = torch.arange(res * res)
    sampler = Sampler(seed=int(z["cfg_seed"]), kind="independent", spp=4,
                      nx=res)
    wl = spectrum.sample_visible(sampler.get_1d(pixel, 0, 4), lanes)
    L, splat, n = BDPTIntegrator(max_depth=int(z["cfg_max_depth"])).trace(
        scene, camera, wl, pixel, 0, sampler, n_paths=4 * res * res)
    assert n == res * res
    for got, want in ((L, z["L"][0]), (splat, z["splat"][0])):
        assert share_close(got.numpy(), want, 1e-3, 1e-5)[0] >= 0.99


def _n_quad():
    from pbrt_tpu.materials.measured import bake_measured as jbake
    from pbrt_tpu_torch.materials.measured import bake_measured

    def lambert(xp):
        def f(wo, wi):
            c = xp.asarray([0.2, 0.5, 0.8], dtype=xp.float32) / np.pi
            return c * (wi[..., 2:3] * 0 + 1) * (wo[..., 2:3] > 0)
        return f

    got = bake_measured(lambert(torch), n_quad=8)
    want = jbake(lambert(jnp), n_quad=8)
    np.testing.assert_array_equal(got, want)


def _stages():
    from pbrt_tpu.ops.compact import staged_masked_loop as jloop
    from pbrt_tpu_torch.ops.compact import staged_masked_loop

    n, steps = 1000, 30
    plan = [(1, 4), (2, 3), (8, 10), (4, 5)]  # 22 steps in all
    r = np.random.default_rng(0)
    limit = r.uniform(0.0, 3.0, n).astype(np.float32)
    limit[:300] = 1e9  # lanes that walk to the end
    step = r.uniform(0.05, 0.4, n).astype(np.float32)

    def jbody(inp, it, st):
        live = st["acc"] < st["limit"]
        return {"acc": jnp.where(live, st["acc"] + inp["step"], st["acc"]),
                "limit": st["limit"],
                "steps": st["steps"] + live.astype(jnp.int32)}

    def tbody(inp, it, st, u):
        live = st["acc"] < st["limit"]
        return {"acc": torch.where(live, st["acc"] + inp["step"], st["acc"]),
                "limit": st["limit"],
                "steps": st["steps"] + live.to(torch.int32)}

    def live(s):
        return s["acc"] < s["limit"]

    want = jax.jit(lambda inp, st: jloop(jbody, inp, st, live, steps,
                                         stages=plan))(
        {"step": jnp.asarray(step)},
        {"acc": jnp.zeros(n), "limit": jnp.asarray(limit),
         "steps": jnp.zeros(n, jnp.int32)})
    outs = []
    for compact in (True, False):
        outs.append(staged_masked_loop(
            tbody, {"step": torch.from_numpy(step)},
            {"acc": torch.zeros(n), "limit": torch.from_numpy(limit),
             "steps": torch.zeros(n, dtype=torch.int32)},
            live, steps, compact=compact, stages=plan))
    assert int(np.asarray(want["steps"]).max()) == 22
    for got in outs:
        for key in ("acc", "steps"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]), key)


KEYWORDS = {
    "white_src": _white_src, "sample_bsdf": _sample_bsdf,
    "eta_start": _eta_start, "n_paths": _n_paths, "n_quad": _n_quad,
    "stages": _stages,
}


@pytest.mark.parametrize("keyword", sorted(KEYWORDS))
def test_reference_keyword_taken_with_its_meaning(keyword):
    KEYWORDS[keyword]()
