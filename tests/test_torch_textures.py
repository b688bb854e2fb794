"""The texture system of the port against the reference on the CPU, on
the same numpy-seeded inputs: Perlin noise, fBm and turbulence, the MIP
pyramid and its lookups, the texture tables and every texture family but
Ptex (two-level references included), the per-ray albedo fit, and
per-sample renders of texture.pbrt and imagetex.pbrt at 16x16, 2 spp.

Tolerances: the noise, the pyramid and the tables bit for bit (the
noise against the reference run op by op; under jax.jit XLA fuses its
lerps and differs by up to 1.5e-6, held at atol 2e-6). MIP lookups and
texture values (the reference op by op) within rtol 1e-5 / atol 1e-6.
The per-ray fit (12
damped Newton steps) against the reference's `_fit_albedo_jnp` under
jax.jit, as it runs in a render: its sums run in another order, so on >=
99.5% of the lanes the coefficients agree within rtol / atol 5e-3 and the
spectra `eval_sigmoid(coeffs, lam)` within 1e-5 absolute. The rest are
saturated colors (a channel near 0 or 1) that 12 steps leave
unconverged, where the trajectory depends on the last bit: the
reference's own numpy and jitted fits differ there by up to 0.92 (7 of
4,096 lanes of these inputs), the port's and the jitted by up to 0.997
(8 lanes). Renders: the same ray count and >= 99% of per-sample values
within rtol 1e-3 / atol 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import mipmap as jmip
from pbrt_tpu.core import noise as jnoise
from pbrt_tpu.core import rgb2spec as jr2s
from pbrt_tpu.io.parser import load_pbrt as jax_load_pbrt
from pbrt_tpu.textures import buffers as jtex
from pbrt_tpu_torch.core import mipmap, noise, rgb2spec
from pbrt_tpu_torch.io.parser import load_pbrt
from pbrt_tpu_torch.textures import buffers as tex

from .torch_port_helpers import assert_samples_match, flatten_jax, trace_pair

torch.set_num_threads(2)
N = 4096
GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("fn", ["perlin", "fbm", "turbulence"])
def test_noise_matches(fn):
    p = np.random.default_rng(0).uniform(-20, 20, (N, 3)).astype(np.float32)
    got = getattr(noise, fn)(_t(p)).numpy()
    want = getattr(jnoise, fn)(jnp.asarray(p))
    np.testing.assert_array_equal(got, np.asarray(want))
    _close(got, jax.jit(getattr(jnoise, fn))(jnp.asarray(p)), rtol=0, atol=2e-6)
    assert np.abs(got).max() > 0.3


@pytest.mark.parametrize("shape", [(5, 7), (1, 6), (4, 1), (8, 8)])
def test_pyramid_bit_equal(shape):
    img = np.random.default_rng(1).uniform(0, 1, (*shape, 3)).astype(np.float32)
    got, want = mipmap.build_pyramid(img), jmip.build_pyramid(img)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    m, jm = mipmap.MIPMap.build(img), jmip.MIPMap.build(img)
    np.testing.assert_array_equal(m.flat.numpy(), np.asarray(jm.flat))
    assert (m.offsets, m.widths, m.heights) == (jm.offsets, jm.widths, jm.heights)


@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
def test_mipmap_lookups_match(wrap):
    r = np.random.default_rng(2)
    img = r.uniform(0, 1, (5, 7, 3)).astype(np.float32)
    m, jm = mipmap.MIPMap.build(img, wrap), jmip.MIPMap.build(img, wrap)
    uv = r.uniform(-1, 2, (N, 2)).astype(np.float32)
    width = np.exp(r.uniform(-8, 1, N)).astype(np.float32)
    _close(m.lookup_trilinear(_t(uv), _t(width)),
           jm.lookup_trilinear(jnp.asarray(uv), jnp.asarray(width)))
    d0 = r.normal(scale=0.05, size=(N, 2)).astype(np.float32)
    d1 = r.normal(scale=0.01, size=(N, 2)).astype(np.float32)
    _close(m.lookup_ewa(_t(uv), _t(d0), _t(d1)),
           jm.lookup_ewa(jnp.asarray(uv), jnp.asarray(d0), jnp.asarray(d1)))


def _leaf_specs():
    """One row of every family that references no other texture, every
    mapping, and two images of other sizes."""
    r = np.random.default_rng(3)
    return [
        {"kind": "constant", "rgb0": (0.2, 0.4, 0.6)},
        {"kind": "checker", "rgb0": (0.9, 0.1, 0.1), "rgb1": (0.1, 0.1, 0.9),
         "uscale": 4.0, "vscale": 3.0, "udelta": 0.25},
        {"kind": "checker", "mapping": "spherical", "uscale": 8.0,
         "vscale": 4.0},
        {"kind": "checker", "mapping": "cylindrical", "uscale": 6.0,
         "vdelta": 0.5},
        {"kind": "checker", "mapping": "planar", "aux0": (1.0, 0.5, 0.0),
         "aux1": (0.0, 0.2, 1.0), "udelta": 0.1},
        {"kind": "marble", "rgb0": (0.08, 0.06, 0.06),
         "rgb1": (0.9, 0.87, 0.83), "uscale": 2.0},
        {"kind": "fbm", "rgb1": (0.8, 0.7, 0.6)},
        {"kind": "wrinkled", "rgb1": (0.5, 0.6, 0.7)},
        {"kind": "windy"},
        {"kind": "bilerp", "rgb0": (1, 0, 0), "rgb1": (0, 1, 0),
         "rgb2": (0, 0, 1), "rgb3": (1, 1, 0), "uscale": 2.0},
        {"kind": "dots", "rgb0": (0.9, 0.9, 0.2), "rgb1": (0.1, 0.2, 0.3),
         "uscale": 3.0, "vscale": 3.0},
        {"kind": "imagemap", "rgb_image": r.uniform(0, 1, (6, 10, 3))},
        {"kind": "image", "rgb_image": r.uniform(0, 2, (3, 3, 3)),
         "udelta": 0.3},
    ]


def _ref_specs():
    """Rows that reference rows that reference rows: scale, mix with a
    texture amount, direction mix and a checkerboard with texture arms,
    over cheap leaves (the noise families are held by the leaf table;
    under references they multiply the reference's op count)."""
    leaves = _leaf_specs()
    return [leaves[0], leaves[1], leaves[9], leaves[10], leaves[11],
            {"kind": "scale", "sub0": 1, "f0": 0.5},
            {"kind": "mix", "sub0": 4, "sub1": 3, "sub2": 2},
            {"kind": "directionmix", "sub0": 2, "sub1": 3,
             "aux0": (0.0, 0.6, 0.8)},
            {"kind": "checkerboard", "sub0": 5, "sub1": 6, "uscale": 2.0},
            {"kind": "scale", "rgb0": (0.5, 1.0, 0.25), "sub2": 3},
            {"kind": "mix", "rgb0": (1, 0, 0), "rgb1": (0, 0, 1), "f0": 0.3,
             "sub1": 4}]


@pytest.fixture(scope="module")
def tables():
    return {name: (tex.TextureBuffers.build(specs),
                   jtex.TextureBuffers.build(specs))
            for name, specs in (("leaf", _leaf_specs()), ("refs", _ref_specs()))}


@pytest.mark.parametrize("which", ["leaf", "refs"])
def test_texture_tables_bit_equal(tables, which):
    got, want = tables[which]
    arrays, static = flatten_jax(got)
    want_arrays, want_static = flatten_jax(want)
    assert set(arrays) == set(want_arrays) and static == want_static
    for path, value in arrays.items():
        np.testing.assert_array_equal(value, want_arrays[path], err_msg=path)
    assert got.has_refs == (which == "refs")
    if which == "leaf":
        # Every leaf family; two images resampled to 8x16, every level of
        # the pyramid flattened.
        assert set(got.families) == set(range(12)) - {4, 5, 6}
        assert got.img_flat.shape == (2, 128 + 32 + 8 + 2 + 1, 3)


def _rays(seed, n_textures):
    r = np.random.default_rng(seed)
    uv = r.uniform(-3, 3, (N, 2)).astype(np.float32)
    p = r.uniform(-2, 2, (N, 3)).astype(np.float32)
    n = r.normal(size=(N, 3))
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    width = np.where(r.uniform(0, 1, N) < 0.5, 0.0,
                     np.exp(r.uniform(-6, 0, N))).astype(np.float32)
    tid = r.integers(-1, n_textures, N).astype(np.int32)
    return r, tid, uv, p, n, width


@pytest.mark.parametrize("which", ["leaf", "refs"])
def test_every_family_evaluates_like_jax(tables, which):
    """evaluate_rgb and evaluate_float on every family (the reference op
    by op), with per-ray mip footprints and a shading normal for the
    direction mix; each row is held on its own lanes."""
    got_t, want_t = tables[which]
    _, tid, uv, p, n, width = _rays(4, got_t.n_textures)
    got = tex.evaluate_rgb(got_t, _t(tid), _t(uv), _t(p), _t(width), _t(n)).numpy()
    want = np.asarray(jtex.evaluate_rgb(
        want_t, jnp.asarray(tid), jnp.asarray(uv), jnp.asarray(p),
        jnp.asarray(width), jnp.asarray(n)))
    assert got.shape == (N, 3) and np.isfinite(got).all()
    for k in range(got_t.n_textures):
        lanes = tid == k
        assert lanes.sum() > 100
        _close(got[lanes], want[lanes])
        assert k == 0 or np.ptp(want[lanes]) > 0.0  # each varies over uv
    base = np.random.default_rng(5).uniform(0, 1, N).astype(np.float32)
    _close(tex.evaluate_float(got_t, _t(tid), _t(uv), _t(p), _t(base)),
           jtex.evaluate_float(want_t, jnp.asarray(tid), jnp.asarray(uv),
                               jnp.asarray(p), jnp.asarray(base)))


def _spectra_agree(got_c, want_c, lam):
    coeff_ok = np.all(np.abs(got_c - want_c) <= 5e-3 + 5e-3 * np.abs(want_c),
                      axis=-1)
    assert coeff_ok.mean() >= 0.995, int(np.sum(~coeff_ok))
    got = rgb2spec.eval_sigmoid(_t(got_c), _t(lam)).numpy()
    want = np.asarray(jr2s.eval_sigmoid(jnp.asarray(want_c), jnp.asarray(lam)))
    lane_ok = np.all(np.abs(got - want) <= 1e-5, axis=-1)
    assert lane_ok.mean() >= 0.995, int(np.sum(~lane_ok))


def test_per_ray_fit_matches_jitted_reference():
    r = np.random.default_rng(6)
    rgb = r.uniform(0, 1, (N, 3)).astype(np.float32)
    rgb[:16] = 0.0
    rgb[16:32] = 1.0
    got = rgb2spec.fit_albedo_rays(_t(rgb), iters=12).numpy()
    want = np.asarray(jax.jit(lambda x: jr2s._fit_albedo_jnp(x, "srgb", 12))(
        jnp.asarray(rgb)))
    assert got.shape == (N, 3)
    lam = r.uniform(360, 830, (N, 8)).astype(np.float32)
    _spectra_agree(got, want, lam)


def test_albedo_coeffs_overlay_matches(tables):
    """Textured rows get the fitted texture value, rows of id -1 keep their
    base coefficients exactly (the reference jitted, as it runs)."""
    got_t, want_t = tables["refs"]
    r, tid, uv, p, n, _ = _rays(7, got_t.n_textures)
    base = r.normal(size=(N, 3)).astype(np.float32)
    got = tex.evaluate_albedo_coeffs(got_t, _t(tid), _t(uv), _t(p),
                                     _t(base)).numpy()
    want = np.asarray(jax.jit(jtex.evaluate_albedo_coeffs)(
        want_t, jnp.asarray(tid), jnp.asarray(uv), jnp.asarray(p),
        jnp.asarray(base)))
    np.testing.assert_array_equal(got[tid < 0], base[tid < 0])
    lam = r.uniform(360, 830, (N, 8)).astype(np.float32)
    _spectra_agree(got, want, lam)


def test_ptex_rows_raise():
    """A Ptex row builds its tables (tests/test_torch_io.py holds them and
    the lookup against the reference); one without its faces raises."""
    built = tex.TextureBuffers.build(
        [{"kind": "ptex", "ptex_faces": [np.ones((2, 2, 3))]}])
    assert built.has_ptex and built.ptex_res == 4
    with pytest.raises(KeyError, match="ptex_faces"):
        tex.TextureBuffers.build([{"kind": "ptex"}])


@pytest.mark.parametrize("name", ["texture.pbrt", "imagetex.pbrt"])
def test_golden_file_traces_like_jax(name):
    """16x16, 2 spp per sample: a checkerboard floor and a scaled
    checkerboard sphere (two levels, spherical uv), and a PFM image over a
    pow2 MIP pyramid; the albedo fit runs for every ray of every bounce."""
    path = os.path.join(GOLDENS, name)
    js, jc, jset = jax_load_pbrt(path)
    ps, pc, pset = load_pbrt(path, device="cpu")
    assert ps.textures is not None and ps.small is not None
    depth = pset["integrator"].max_depth
    assert_samples_match(*trace_pair(js.replace(small=None), jc, ps, pc,
                                     depth, res=16, spp=2))
