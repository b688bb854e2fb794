"""The port's lights against the reference's on the CPU, on numpy-seeded
inputs: the tabulated distributions, the equal-area maps, the light
tables of a scene holding every light type, NEE sampling of each type,
the sphere lights' emission and MIS pdf, the power pmf, the furnace's
closed form, and the refusals (the light BVH and exhaustive samplers,
SampleLe's origin without emitters, gradients of the new light
tensors).

Tolerances, each for its reason:
- the distributions' tables, and every light table: bit for bit (the
  port sums its cdfs in the reference's XLA CPU order, `_cumsum_f32`);
- 1D and 2D sampling on the same tables: bin indices and pdfs bit for
  bit, points within 2.4e-7;
- the equal-area maps: within 1e-6 (cos, sin and atan of two libraries);
- sample_li: is_delta equal; L, pdf and dist within rtol 1e-4 and wi
  within 1e-5 on >= 99.5% of the 4,096 lanes (a lane on a texel's, a
  cone's or a window's edge may take the neighbouring value).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import sampling as jsampling
from pbrt_tpu.core import spectrum as jspec
from pbrt_tpu.core import vecmath as jvecmath
from pbrt_tpu.lights.buffers import LightBuffers as JLightBuffers
from pbrt_tpu.lights.envmap import EnvironmentMap as JEnvironmentMap
from pbrt_tpu_torch.core import sampling, spectrum, vecmath
from pbrt_tpu_torch.lights.buffers import LightBuffers
from pbrt_tpu_torch.lights.envmap import EnvironmentMap
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.render import camera_rays
from pbrt_tpu_torch.scenes.analytic import furnace_sphere_scene

from .torch_port_helpers import flatten_jax

torch.set_num_threads(2)
N = 4096
S = jspec.N_SPECTRUM


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jit(dist, method):
    """dist.method under jax.jit with the tables passed in, not closed
    over: closed-over tables are constants that XLA folds (a division by
    a constant integral becomes a multiply)."""
    run = jax.jit(lambda d, *args: getattr(d, method)(*args))
    return lambda *args: run(dist, *args)


def _func(r, shape):
    """A non-negative table with an all-zero row and a zero run."""
    f = r.gamma(0.7, size=shape).astype(np.float32)
    f[..., : shape[-1] // 4] *= (r.uniform(size=shape[:-1]) > 0.3)[..., None]
    if len(shape) == 2:
        f[1] = 0.0
    return f


# --- distributions ------------------------------------------------------------


@pytest.mark.parametrize("shape", [(37,), (9, 300)])
def test_piecewise_1d_build_and_sample(shape):
    r = np.random.default_rng(shape[-1])
    f = _func(r, shape)
    lo, hi = (-1.5, 2.5) if len(shape) == 1 else (0.0, 1.0)
    jd = jsampling.PiecewiseConstant1D.build(jnp.asarray(f), lo, hi)
    pd = sampling.PiecewiseConstant1D.build(f, lo, hi)
    for name in ("func", "cdf", "integral"):
        np.testing.assert_array_equal(_np(getattr(pd, name)),
                                      _np(getattr(jd, name)), name)
    u = r.uniform(size=(N,) + shape[:-1]).astype(np.float32)
    u[:8] = 0.0
    x, pdf, idx = pd.sample(_t(u))
    jx, jpdf, jidx = _jit(jd, 'sample')(jnp.asarray(u))
    np.testing.assert_array_equal(idx.numpy(), _np(jidx))
    np.testing.assert_array_equal(pdf.numpy(), _np(jpdf))
    np.testing.assert_allclose(x.numpy(), _np(jx), rtol=2.4e-7, atol=2.4e-7)
    np.testing.assert_array_equal(pd.pdf(x).numpy(), _np(_jit(jd, 'pdf')(jx)))


def test_piecewise_2d_build_sample_pdf():
    r = np.random.default_rng(7)
    f = _func(r, (48, 80))
    jd = jsampling.PiecewiseConstant2D.build(jnp.asarray(f))
    pd = sampling.PiecewiseConstant2D.build(f)
    want, _ = flatten_jax(jd)
    got, _ = flatten_jax(pd)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], path)
    u = r.uniform(size=(N, 2)).astype(np.float32)
    p, pdf = pd.sample(_t(u))
    jp, jpdf = _jit(jd, 'sample')(jnp.asarray(u))
    np.testing.assert_array_equal(pdf.numpy(), _np(jpdf))
    np.testing.assert_allclose(p.numpy(), _np(jp), rtol=0, atol=2.4e-7)
    q = r.uniform(size=(N, 2)).astype(np.float32)
    np.testing.assert_array_equal(pd.pdf(_t(q)).numpy(),
                                  _np(_jit(jd, 'pdf')(jnp.asarray(q))))


def test_windowed_2d_build_sample_pdf():
    """Windows inside the unit square, some empty (zero integral); the
    bisection's 13 steps compare SAT differences, so a sample may land one
    step apart where the two libraries round a difference apart: points
    within 2e-4 and pdfs within rtol 1e-5 on >= 99% of the samples."""
    r = np.random.default_rng(11)
    f = _func(r, (40, 56))
    jd = jsampling.WindowedPiecewiseConstant2D.build(jnp.asarray(f))
    pd = sampling.WindowedPiecewiseConstant2D.build(f)
    np.testing.assert_array_equal(pd.func.numpy(), _np(jd.func))
    np.testing.assert_array_equal(pd.sat.numpy(), _np(jd.sat))
    a = r.uniform(size=(N, 2, 2)).astype(np.float32)
    b = np.concatenate([np.sort(a[:, 0], -1), np.sort(a[:, 1], -1)], -1)
    b[:16, 2:] = [0.03, 0.04]  # the zero row's band: an empty window
    u = r.uniform(size=(N, 2)).astype(np.float32)
    # The reference eagerly: under jit its unrolled bisection takes ~35 s
    # to compile.
    np.testing.assert_allclose(pd.window_integral(_t(b)).numpy(),
                               _np(jd.window_integral(jnp.asarray(b))),
                               rtol=1e-5, atol=1e-9)
    p, pdf = pd.sample(_t(u), _t(b))
    jp, jpdf = jd.sample(jnp.asarray(u), jnp.asarray(b))
    p_ok = np.all(np.abs(p.numpy() - _np(jp)) <= 2e-4, axis=-1)
    pdf_ok = np.abs(pdf.numpy() - _np(jpdf)) <= 1e-5 * np.abs(_np(jpdf))
    assert p_ok.mean() >= 0.99 and pdf_ok.mean() >= 0.99, (
        p_ok.mean(), pdf_ok.mean())
    assert np.all(pdf.numpy()[:16] == 0.0)
    np.testing.assert_allclose(pd.pdf(_t(u), _t(b)).numpy(),
                               _np(jd.pdf(jnp.asarray(u), jnp.asarray(b))),
                               rtol=1e-5)


def test_equal_area_maps_and_cone():
    r = np.random.default_rng(3)
    p = r.uniform(size=(N, 2)).astype(np.float32)
    p[:4] = [[0.5, 0.5], [0.0, 0.0], [1.0, 0.5], [0.25, 0.75]]
    d = r.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:3] = [[0, 0, 1], [0, 0, -1], [1, 0, 0]]
    d = d.astype(np.float32)
    np.testing.assert_allclose(
        vecmath.equal_area_square_to_sphere(_t(p)).numpy(),
        _np(jvecmath.equal_area_square_to_sphere(jnp.asarray(p))),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        vecmath.equal_area_sphere_to_square(_t(d)).numpy(),
        _np(jvecmath.equal_area_sphere_to_square(jnp.asarray(d))),
        rtol=0, atol=1e-6)
    cmax = r.uniform(-0.5, 0.999, N).astype(np.float32)
    np.testing.assert_allclose(
        sampling.sample_uniform_cone(_t(p), _t(cmax)).numpy(),
        _np(jsampling.sample_uniform_cone(jnp.asarray(p), jnp.asarray(cmax))),
        rtol=0, atol=2e-6)
    np.testing.assert_allclose(
        sampling.uniform_cone_pdf(_t(cmax)).numpy(),
        _np(jsampling.uniform_cone_pdf(jnp.asarray(cmax))), rtol=1e-6)


# --- a scene holding every light type ---------------------------------------


def _specs(r):
    img = r.gamma(1.0, size=(8, 12, 3)).astype(np.float32)
    return dict(
        area_tris=[
            {"verts": [[-0.8, 2.6, -0.8], [0.8, 2.6, -0.8], [0.8, 2.6, 0.8]],
             "rgb": (1, 0.95, 0.9), "scale": 14.0},
            {"verts": [[-0.8, 2.6, -0.8], [0.8, 2.6, 0.8], [-0.8, 2.6, 0.8]],
             "rgb": (1, 0.95, 0.9), "scale": 14.0, "two_sided": True},
        ],
        sphere_lights=[
            {"c": (0.0, 1.0, 0.0), "r": 0.5, "rgb": (4.0, 3.0, 2.0)},
            {"c": (1.5, 0.3, -1.0), "r": 0.2, "rgb": (1.0, 1.0, 1.0),
             "scale": 9.0, "two_sided": True, "illuminant": False},
        ],
        points=[{"p": (2.0, 4.0, -3.0), "rgb": (30, 30, 30)},
                {"p": (-1.0, 0.5, 1.0), "rgb": (5, 2, 1), "scale": 2.0,
                 "illuminant": False}],
        spots=[{"p": (0.0, 4.0, -1.0), "to": (0.0, 0.0, 0.0),
                "rgb": (60, 55, 50), "coneangle": 35.0, "conedelta": 10.0},
               {"p": (1.0, 3.0, 1.0), "rgb": (20, 20, 20)}],
        # One of each with an image, one with a constant: each costs a
        # 64 x 64 grid of spectrum fits.
        projections=[{"p": (0.0, 3.0, -2.0), "to": (0.0, 0.0, 0.5),
                      "fov": 60.0, "rgb_image": img, "scale": 3.0}],
        gonios=[{"p": (-0.5, 1.5, -0.5), "to": (0.5, 2.5, 1.5),
                 "rgb": (3, 3, 3)}],
        distants=[{"dir": (1.0, -2.0, 1.0), "rgb": (1.5, 1.4, 1.2)},
                  {"dir": (0.0, -1.0, 0.0), "rgb": (0.5, 0.5, 0.6),
                   "scale": 2.0}],
    )


@pytest.fixture(scope="module")
def every_light():
    """Each package's light tables of the same specs, power-sampled, and
    the same tables with the uniform pmf (a build with sampler="uniform"
    differs only there)."""
    r = np.random.default_rng(5)
    specs = _specs(r)
    env_img = r.gamma(0.8, size=(16, 16, 3)).astype(np.float32)
    jl = JLightBuffers.build(sampler="power",
                             envmap=JEnvironmentMap.build(env_img, 1.5),
                             **specs)
    pl = LightBuffers.build(sampler="power",
                            envmap=EnvironmentMap.build(env_img, 1.5),
                            **specs)
    n = pl.n_lights
    pmf = np.full(n, 1.0 / n)
    uniform = dict(select_pmf=pmf.astype(np.float32),
                   select_cdf=np.cumsum(pmf).astype(np.float32))
    return {"power": (jl, pl), "uniform": (
        jl.replace(sampler="uniform",
                   **{k: jnp.asarray(v) for k, v in uniform.items()}),
        pl.replace(sampler="uniform",
                   **{k: torch.from_numpy(v) for k, v in uniform.items()}))}


def test_every_light_builds_like_jax(every_light):
    """Every table bit for bit, the light counts and id layout the same;
    the power pmf within 1e-6 (the environment's power is a mean over its
    image, which the two libraries sum in another order)."""
    for sampler, (jl, pl) in every_light.items():
        assert pl.n_lights == jl.n_lights == 2 + 2 + 2 + 2 + 1 + 1 + 2 + 1
        for name in ("n_area", "n_sphl", "n_point", "n_spot", "n_proj",
                     "n_gonio", "n_distant", "n_bvh", "n_inf_list",
                     "_p_infinite", "has_env", "has_infinite"):
            assert getattr(pl, name) == getattr(jl, name), name
        want, want_static = flatten_jax(jl)
        got, got_static = flatten_jax(pl)
        for path, value in got.items():
            if path in ("select_cdf", "select_pmf"):
                np.testing.assert_allclose(value, want[path], rtol=1e-6)
            else:
                np.testing.assert_array_equal(value, want[path], path)
        assert set(want) == set(got)
        assert got_static == {k: want_static[k] for k in got_static}
        if sampler == "power":
            pmf = pl.select_pmf.numpy()
            assert np.ptp(pmf) > 0.01 and abs(pmf.sum() - 1) < 1e-6


def _sample_inputs(seed):
    r = np.random.default_rng(seed)
    p = r.uniform(-2.0, 3.0, (N, 3)).astype(np.float32)
    p[:64] = (np.array([0.0, 1.0, 0.0]) + r.uniform(-0.3, 0.3, (64, 3))
              ).astype(np.float32)  # inside the first sphere light
    us = r.uniform(size=N).astype(np.float32)
    up = r.uniform(size=(N, 2)).astype(np.float32)
    uw = r.uniform(size=N).astype(np.float32)
    return p, us, up, uw


def _agree(got, want, rtol, atol, share=0.995, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ok = np.abs(got - want) <= atol + rtol * np.abs(want)
    ok = ok.reshape(len(ok), -1).all(axis=-1)
    assert ok.mean() >= share, (what, int((~ok).sum()))
    return ok


@pytest.mark.parametrize("sampler", ["uniform", "power"])
def test_sample_li_every_type(every_light, sampler):
    jl, pl = every_light[sampler]
    p, us, up, uw = _sample_inputs(13)
    jwl = jspec.sample_visible(jnp.asarray(uw))
    pwl = spectrum.sample_visible(_t(uw), S)
    want = jax.jit(lambda p, lam, us, up: jl.sample_li(p, lam, us, up))(
        jnp.asarray(p), jwl.lam, jnp.asarray(us), jnp.asarray(up))
    got = pl.sample_li(_t(p), pwl.lam, _t(us), _t(up))
    idx = _np(jl.select(None, None, jnp.asarray(us))[0])
    np.testing.assert_array_equal(pl.select(None, None, _t(us))[0].numpy(), idx)
    # Every light of the list is drawn.
    assert len(np.unique(idx)) == jl.n_lights
    np.testing.assert_array_equal(got.is_delta.numpy(), _np(want.is_delta))
    assert got.is_delta.numpy().sum() > N // 4
    _agree(got.L, want.L, 1e-4, 1e-6, what="L")
    _agree(got.wi, want.wi, 0, 1e-5, what="wi")
    _agree(got.pdf, want.pdf, 1e-4, 0, what="pdf")
    dist, wdist = got.dist.numpy(), _np(want.dist)
    np.testing.assert_array_equal(np.isinf(dist), np.isinf(wdist))
    fin = np.isfinite(wdist)
    _agree(dist[fin], wdist[fin], 1e-5, 0, what="dist")
    # The delta lights' pdf is their selection pmf alone.
    delta = got.is_delta.numpy()
    np.testing.assert_array_equal(
        got.pdf.numpy()[delta], pl.select_pmf.numpy()[idx[delta]])


def test_sphere_lights_emitted_and_pdf(every_light):
    """emitted, area_radiance and pdf_li_area on hits of the area and
    sphere lights, from points outside and inside the spheres."""
    jl, pl = every_light["power"]
    r = np.random.default_rng(17)
    idx = r.integers(-1, 4, N).astype(np.int32)  # -1, area 0-1, spheres 2-3
    n = r.normal(size=(N, 3)).astype(np.float32)
    wo = r.normal(size=(N, 3)).astype(np.float32)
    p, _, _, uw = _sample_inputs(19)
    dist = r.uniform(0.1, 5.0, N).astype(np.float32)
    cos = r.uniform(-1.0, 1.0, N).astype(np.float32)
    jwl = jspec.sample_visible(jnp.asarray(uw))
    lam = spectrum.sample_visible(_t(uw), S).lam
    ji, jn, jwo = jnp.asarray(idx), jnp.asarray(n), jnp.asarray(wo)
    np.testing.assert_allclose(pl.emitted(_t(idx), _t(n), _t(wo), lam).numpy(),
                               _np(jax.jit(jl.emitted)(ji, jn, jwo, jwl.lam)),
                               rtol=1e-5, atol=1e-6)
    ok = idx >= 0
    np.testing.assert_allclose(
        pl.area_radiance(_t(idx[ok]), lam[ok]).numpy(),
        _np(jax.jit(jl.area_radiance)(ji[ok], jwl.lam[ok])), rtol=1e-5,
        atol=1e-6)
    got = pl.pdf_li_area(_t(idx), _t(dist), _t(cos), p_ref=_t(p)).numpy()
    want = _np(jax.jit(lambda i, t, c, p: jl.pdf_li_area(i, t, c, p_ref=p))(
        ji, jnp.asarray(dist), jnp.asarray(cos), jnp.asarray(p)))
    # Seen from just outside a sphere's Taylor switch (sin^2 = 6.85e-4),
    # 1 - cos(thetaMax) cancels: one lane in 4,096 is 1.7e-5 off.
    _agree(got, want, 1e-5, 0, share=0.999, what="pdf_li_area")
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.all(got[idx < 0] == 0.0) and np.all(got[idx >= 0] > 0.0)
    np.testing.assert_allclose(
        pl.selection_pmf(_t(idx)).numpy(),
        _np(jl.selection_pmf(ji)), rtol=1e-6)


# --- the furnace and the refusals ---------------------------------------------


def test_furnace_closed_form():
    """10x10, 4 spp, depth 16 without Russian roulette, as the reference's
    tests/test_integrator.py gates it: the spectral mean within +-0.025 of
    1 (the scene has no triangles: the sphere block answers every
    query)."""
    scene, camera = furnace_sphere_scene()
    assert scene.geom.num_triangles == 0 and scene.small is None
    integ = PathIntegrator(max_depth=16, rr_start_depth=100)
    pixel = torch.arange(100)
    got = []
    for s in range(4):
        o, d, wl = camera_rays(camera, pixel, s, 0, n_spectrum=S)
        got.append(integ.trace(scene, o, d, wl, pixel, s, 0))
    mean = float(torch.stack(got).mean())
    assert abs(mean - 1.0) < 0.025, mean


@pytest.mark.parametrize("sampler", ["bvh", "exhaustive"])
def test_unported_samplers_raise(sampler):
    """The light BVH and exhaustive samplers, refused until they were
    ported, build; one point light is picked with pmf 1 (their tables and
    pmfs against the reference: tests/test_torch_lightbvh.py). An unknown
    sampler name raises."""
    lights = LightBuffers.build(points=[{"p": (0, 1, 0), "rgb": (1, 1, 1)}],
                                sampler=sampler)
    assert (lights.bvh is not None) == (sampler == "bvh")
    assert (lights.exh_recs is not None) == (sampler == "exhaustive")
    p = torch.tensor([[0.0, 0.0, 0.0], [3.0, 1.0, -2.0]])
    n = torch.tensor([[0.0, 1.0, 0.0], [0.0, 0.0, 0.0]])
    idx, pmf = lights.select(p, n, torch.tensor([0.1, 0.9]))
    assert idx.tolist() == [0, 0] and pmf.tolist() == [1.0, 1.0]
    with pytest.raises(ValueError, match="unknown light sampler"):
        LightBuffers.build(sampler=sampler + "_tree")


def test_sample_le_origin_raises():
    """SampleLe's origin is ported (tests/test_torch_lightpath.py holds it
    against the reference); it raises without emissive geometry, and for
    lights of other kinds (item 16)."""
    lights = LightBuffers.build(sphere_lights=[
        {"c": (0, 0, 0), "r": 1.0, "rgb": (1, 1, 1)}])
    org = lights.sample_le_origin(torch.zeros(4), torch.full((4, 2), 0.25))
    np.testing.assert_allclose(torch.linalg.norm(org["p"], dim=-1).numpy(),
                               1.0, rtol=1e-6)
    assert org["idx"].tolist() == [0] * 4
    with pytest.raises(ValueError, match="no emissive geometry"):
        LightBuffers.build().sample_le_origin(torch.zeros(4),
                                              torch.zeros(4, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 16"):
        LightBuffers.build(points=[{"p": (0, 0, 0), "rgb": (1, 1, 1)}]
                           ).sample_le_origin(torch.zeros(4), torch.zeros(4, 2))


def test_new_light_gradients_refused(every_light):
    """The light tables train under the estimators of their goldens
    (tests/test_torch_grad_leaves.py, and the image light's importance
    tables under remat and cvjp, tests/test_torch_grad_leaves_rest.py); a
    request outside an estimator's table raises naming item 5
    (models/path.py's guard): the point, spot and image lights' tables
    under the attached estimator, which has no golden of theirs. The
    sphere light's trains under all."""
    _, pl = every_light["uniform"]
    scene, camera = furnace_sphere_scene(resolution=(2, 2))
    pixel = torch.arange(4)
    o, d, wl = camera_rays(camera, pixel, 0, 0, n_spectrum=8)
    refusing = {"point_scale": {"attached"}, "spot_coeffs": {"attached"},
                "env.scale": {"attached"},
                "env.dist.conditional.func": {"attached"},
                "sphl_scale": set()}
    for path, by in refusing.items():
        lights = pl
        head, _, leaf = path.rpartition(".")
        if head:
            parts = head.split(".")
            objs = [lights]
            for part in parts:
                objs.append(getattr(objs[-1], part))
            new = dataclasses.replace(
                objs[-1], **{leaf: getattr(objs[-1], leaf).clone()
                             .requires_grad_(True)})
            for part, parent in zip(reversed(parts), reversed(objs[:-1])):
                new = dataclasses.replace(parent, **{part: new})
            lights = new
        else:
            lights = dataclasses.replace(
                lights, **{leaf: getattr(lights, leaf).clone()
                           .requires_grad_(True)})
        for est, kw in (("remat", {}), ("attached", {"replay_grad": False})):
            trace = functools.partial(
                PathIntegrator(max_depth=2, **kw).trace,
                scene.replace(lights=lights), o, d, wl, pixel, 0, 0)
            if est in by:
                with pytest.raises(NotImplementedError,
                                   match="ROADMAP Queue 1 item 5"):
                    trace()
            else:
                assert bool(torch.isfinite(trace()).all()), (path, est)
