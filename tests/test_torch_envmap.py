"""The image-based infinite light (EnvironmentMap) and the portal light of
the port against the reference's on the CPU: their tables, escaped
radiance, MIS pdf and NEE samples through LightBuffers, the parser's
"infinite" forms (a square image, a portal over an image, a portal over
the constant L), and the renders of the golden files spot.pbrt and
envmap.pbrt at 16x16, 4 spp, against the reference's renders (its small
tier answers on the CPU with its dense tester).

Tolerances: tables bit for bit; radiance, pdfs and sampled directions within rtol 1e-4 / atol 1e-6 (wi
1e-5) on >= 99.5% of the lanes (a lane on a texel's edge may take its
neighbour); renders: >= 99% of pixel values within rtol 1e-3 / atol
1e-5, the gate of the other render parity tests.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import spectrum as jspec
from pbrt_tpu.io.parser import load_pbrt as jax_load_pbrt
from pbrt_tpu.io.parser import load_pbrt_string as jax_load_pbrt_string
from pbrt_tpu.lights import portal as jportal
from pbrt_tpu.lights.buffers import LightBuffers as JLightBuffers
from pbrt_tpu.lights.envmap import EnvironmentMap as JEnvironmentMap
from pbrt_tpu.render import render as jax_render
from pbrt_tpu_torch.convert import scene_from_arrays
from pbrt_tpu_torch.core import spectrum
from pbrt_tpu_torch.io.parser import load_pbrt, load_pbrt_string
from pbrt_tpu_torch.lights import portal
from pbrt_tpu_torch.lights.buffers import LightBuffers
from pbrt_tpu_torch.lights.envmap import EnvironmentMap
from pbrt_tpu_torch.render import render

from .test_torch_parser import _assert_same_build
from .torch_port_helpers import flatten_jax, share_close

torch.set_num_threads(2)
N = 4096
S = jspec.N_SPECTRUM
# A hole in a ceiling at y = 2, its corners counter-clockwise seen from
# the lit interior below (the frame's z is +y).
CORNERS = np.array([[-1.0, 2.0, -1.0], [-1.0, 2.0, 1.0], [1.0, 2.0, 1.0],
                    [1.0, 2.0, -1.0]])


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _agree(got, want, rtol, atol, share=0.995, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ok = np.abs(got - want) <= atol + rtol * np.abs(want)
    ok = ok.reshape(len(ok), -1).all(axis=-1)
    assert ok.mean() >= share, (what, int((~ok).sum()))


def _same_tables(port_obj, jax_obj):
    want, _ = flatten_jax(jax_obj)
    got, _ = flatten_jax(port_obj)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], path)


def _inputs(seed, n=N):
    r = np.random.default_rng(seed)
    d = r.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    p = r.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    p[::9, 1] = 2.5  # above the portal's ceiling: it cannot be seen
    uw = r.uniform(size=n).astype(np.float32)
    up = r.uniform(size=(n, 2)).astype(np.float32)
    us = r.uniform(size=n).astype(np.float32)
    return d, p, uw, up, us


def _reference_queries(lights, d, lam, p, us, up):
    return (lights.escaped_radiance(d, lam, p), lights.pdf_escaped(d, p),
            lights.sample_li(p, lam, us, up))


def _queries(jl, pl, seed, n=N, jit=True):
    """escaped_radiance, pdf_escaped and sample_li of both light tables on
    the same directions, points and draws; the reference's under one
    jax.jit with its tables passed in (a portal's unrolled bisection
    compiles for ~35 s, so it runs eagerly)."""
    d, p, uw, up, us = _inputs(seed, n)
    jlam = jspec.sample_visible(jnp.asarray(uw)).lam
    lam = spectrum.sample_visible(_t(uw), S).lam
    ref = jax.jit(_reference_queries) if jit else _reference_queries
    w_rad, w_pdf, want = ref(jl, jnp.asarray(d), jlam, jnp.asarray(p),
                             jnp.asarray(us), jnp.asarray(up))
    _agree(pl.escaped_radiance(_t(d), lam, _t(p)), w_rad, 1e-4, 1e-6,
           what="radiance")
    _agree(pl.pdf_escaped(_t(d), _t(p)), w_pdf, 1e-4, 1e-6,
           what="pdf_escaped")
    got = pl.sample_li(_t(p), lam, _t(us), _t(up))
    _agree(got.L, want.L, 1e-4, 1e-6, what="L")
    _agree(got.wi, want.wi, 0, 1e-5, what="wi")
    _agree(got.pdf, want.pdf, 1e-4, 1e-6, what="pdf")
    np.testing.assert_array_equal(got.is_delta.numpy(), _np(want.is_delta))
    return got


def test_environment_map_matches():
    """A 16x16 octahedral map beside a point light (power pmf): tables,
    escaped radiance, MIS pdf and NEE samples (envmap.pbrt renders the
    map alone)."""
    r = np.random.default_rng(1)
    img = r.gamma(0.8, size=(16, 16, 3)).astype(np.float32)
    img[:4, :5] = 0.0  # a dark corner: zero-luminance texels
    jenv, penv = JEnvironmentMap.build(img, 2.0), EnvironmentMap.build(img, 2.0)
    _same_tables(penv, jenv)
    point = [{"p": (0.0, 1.0, 0.0), "rgb": (3, 3, 3)}]
    jl = JLightBuffers.build(envmap=jenv, points=point, sampler="power")
    pl = LightBuffers.build(envmap=penv, points=point, sampler="power")
    np.testing.assert_allclose(pl.select_pmf.numpy(), _np(jl.select_pmf),
                               rtol=1e-6)
    got = _queries(jl, pl, 2)
    delta = got.is_delta.numpy()
    assert 0 < delta.mean() < 1 and bool((got.pdf[~delta] > 0).any())


def test_from_latlong_matches():
    """The lat-long resampling (imgtool makeequiarea) at 16x16, from a
    9x18 source: bit for bit. (On a 8x16 source, 4 of the 256 texel
    centres map exactly onto a source texel's edge, where one ulp of cos
    or sin picks the neighbour.)"""
    r = np.random.default_rng(3)
    src = r.gamma(1.0, size=(9, 18, 3)).astype(np.float32)
    penv = EnvironmentMap.from_latlong(src, out_res=16)
    _same_tables(penv, JEnvironmentMap.from_latlong(src, out_res=16))
    assert penv.resolution == (16, 16)


def test_portal_light_matches():
    """A portal over a lat-long image (16x16 in portal space), seen from
    points below it and from points above, which cannot see it."""
    r = np.random.default_rng(5)
    src = r.gamma(1.0, size=(8, 16, 3)).astype(np.float32)
    jpl = jportal.PortalLight.build(src, CORNERS, res=16, strength=1.5)
    ppl = portal.PortalLight.build(src, CORNERS, res=16, strength=1.5)
    _same_tables(ppl, jpl)
    jl = JLightBuffers.build(envmap=jpl)
    pl = LightBuffers.build(envmap=ppl)
    got = _queries(jl, pl, 6, n=1024, jit=False)
    p = _inputs(6, 1024)[1]
    above = p[:, 1] > 2.0
    assert np.all(got.pdf.numpy()[above] == 0.0)
    assert np.mean(got.pdf.numpy()[~above] > 0.0) > 0.9


def _write_pfm(path, img):
    img = np.asarray(img, "<f4")
    with open(path, "wb") as f:
        f.write(f"PF\n{img.shape[1]} {img.shape[0]}\n-1\n".encode())
        f.write(np.flipud(img).tobytes())


_SCENE = """
LookAt 0 1 -3  0 1 0  0 1 0
Camera "perspective" "float fov" 45
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
Translate 0 0.5 0
{light}
Shape "trianglemesh" "integer indices" [0 1 2]
  "point3 P" [-1 0 -1  1 0 -1  1 0 1]
"""


@pytest.mark.parametrize("light", [
    'LightSource "infinite" "string filename" "square.pfm" "float scale" 2',
    'LightSource "infinite" "string filename" "latlong.pfm" '
    '"point3 portal" [-1 2 -1 -1 2 1 1 2 1 1 2 -1]',
    'LightSource "infinite" "rgb L" [0.3 0.4 0.5] '
    '"point3 portal" [-1 2 -1 -1 2 1 1 2 1 1 2 -1]',
], ids=["image", "portal_image", "portal_L"])
def test_parser_infinite_forms(light, tmp_path, monkeypatch):
    """Each form of LightSource "infinite" builds the reference's light
    tables, through the CTM, and convert.py carries the reference's light
    across to the same tables. The portal image is built at 16x16 in both
    packages (its 128x128 default is no part of the parser)."""
    r = np.random.default_rng(7)
    _write_pfm(tmp_path / "square.pfm", r.gamma(1.0, size=(8, 8, 3)))
    _write_pfm(tmp_path / "latlong.pfm", r.gamma(1.0, size=(8, 16, 3)))
    for mod in (jportal, portal):
        build = mod.PortalLight.build
        monkeypatch.setattr(mod.PortalLight, "build", staticmethod(
            lambda img, corners, build=build: build(img, corners, res=16)))
    text = _SCENE.format(light=light)
    jax_built = jax_load_pbrt_string(text, str(tmp_path))
    port_built = load_pbrt_string(text, str(tmp_path), device="cpu")
    _assert_same_build(jax_built, port_built)
    env = port_built[0].lights.env
    want = EnvironmentMap if "square" in light else portal.PortalLight
    assert isinstance(env, want) and not port_built[0].lights.has_infinite
    # convert.py carries the reference's light, its distribution included.
    converted = scene_from_arrays(*flatten_jax(jax_built[0])).lights.env
    assert type(converted) is type(env)
    _same_tables(converted, env)


@pytest.mark.parametrize("name", ["spot.pbrt", "envmap.pbrt"])
def test_golden_file_renders_like_jax(name):
    """16x16, 4 spp of the golden file in both packages (the build itself
    is held bit for bit by tests/test_torch_parser.py)."""
    path = os.path.join("tests", "goldens", name)
    js, jc, jset = jax_load_pbrt(path)
    ps, pc, pset = load_pbrt(path, device="cpu")
    kw = dict(spp=4, samples_per_pass=4, seed=0)
    want = np.asarray(jax_render(js, jc.replace(resolution=(16, 16)),
                                 jset["integrator"], **kw))
    got = render(ps, pc.replace(resolution=(16, 16)), pset["integrator"],
                 n_spectrum=S, device="cpu", **kw).numpy()
    assert got.shape == want.shape == (16, 16, 3) and np.isfinite(got).all()
    assert got.mean() > 0.01
    share, n_bad = share_close(got, want, rtol=1e-3, atol=1e-5)
    print(f"pixel values disagreeing with the reference: {n_bad}")
    assert share >= 0.99, n_bad
