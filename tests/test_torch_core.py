"""pbrt_tpu_torch core against pbrt_tpu core: RNG, sampler, colour, rgb2spec,
frames and warps. Inputs come from a numpy seed; JAX runs on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import cie as jcie
from pbrt_tpu.core import rgb2spec as jr2s
from pbrt_tpu.core import rng as jrng
from pbrt_tpu.core import sampling as jsampling
from pbrt_tpu.core import spectrum as jspec
from pbrt_tpu.core import vecmath as jvec
from pbrt_tpu.films import rgb as jfilm
from pbrt_tpu.samplers import samplers as jsamplers
from pbrt_tpu_torch.core import cie, rgb2spec, rng, sampling, spectrum, vecmath
from pbrt_tpu_torch.films import rgb as film
from pbrt_tpu_torch.samplers import samplers

torch.set_num_threads(2)

N_COORDS = 100_000
S = jspec.N_SPECTRUM


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return np.asarray(x)


def test_pcg4d_bit_exact_full_uint32_range():
    r = np.random.default_rng(0)
    cols = [r.integers(0, 2**32, N_COORDS, dtype=np.uint64) for _ in range(4)]
    cols[0][:4] = [0, 2**31 - 1, 2**31, 2**32 - 1]  # edges of the range
    want = jrng.pcg4d(*(jnp.asarray(c.astype(np.uint32)) for c in cols))
    got = rng.pcg4d(*(_t(c.astype(np.int64)) for c in cols))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), _np(w).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7, -3])
def test_sampler_draws_bit_exact(seed):
    r = np.random.default_rng(1)
    # Coordinates over the whole uint32 range (the reference hashes ids as
    # uint32; the port holds them in int64).
    pixel = r.integers(0, 2**32, N_COORDS, dtype=np.uint64)
    sample = r.integers(0, 2**32, N_COORDS, dtype=np.uint64)
    jpix, jsam = jnp.asarray(pixel.astype(np.uint32)), jnp.asarray(sample.astype(np.uint32))
    ppix, psam = _t(pixel.astype(np.int64)), _t(sample.astype(np.int64))
    js = jsamplers.as_sampler(seed)
    ps = samplers.as_sampler(seed)
    for dim in (0, 4, 13, 47):
        np.testing.assert_array_equal(
            ps.get_1d(ppix, psam, dim).numpy(), _np(js.get_1d(jpix, jsam, dim))
        )
        for g, w in zip(ps.get_2d(ppix, psam, dim), js.get_2d(jpix, jsam, dim)):
            np.testing.assert_array_equal(g.numpy(), _np(w))


def _wavelengths(n=4096, seed=2):
    u = np.random.default_rng(seed).uniform(0, 1, n).astype(np.float32)
    return jspec.sample_visible(jnp.asarray(u)), spectrum.sample_visible(_t(u), S)


def test_sample_visible():
    jwl, pwl = _wavelengths()
    np.testing.assert_allclose(pwl.lam.numpy(), _np(jwl.lam), rtol=1e-5)
    np.testing.assert_allclose(pwl.pdf.numpy(), _np(jwl.pdf), rtol=1e-5)


def test_cie_xyz_d65_and_y_integral():
    lam = np.random.default_rng(3).uniform(360, 830, (512, 8)).astype(np.float32)
    np.testing.assert_allclose(
        cie.cie_xyz(_t(lam)).numpy(), _np(jcie.cie_xyz(jnp.asarray(lam))),
        rtol=1e-5, atol=1e-7,
    )
    # Include the table nodes themselves and the clamped ends.
    lam_d = np.concatenate([lam.ravel(), np.arange(370, 800, 5, dtype=np.float32)])
    np.testing.assert_allclose(
        cie.illuminant_d65(_t(lam_d)).numpy(),
        _np(jcie.illuminant_d65(jnp.asarray(lam_d))), rtol=1e-6,
    )
    assert cie.CIE_Y_INTEGRAL == jcie.CIE_Y_INTEGRAL


def test_to_xyz_and_spectrum_to_rgb():
    jwl, pwl = _wavelengths(2048, seed=4)
    vals = np.random.default_rng(5).uniform(0, 3, (2048, S)).astype(np.float32)
    np.testing.assert_allclose(
        spectrum.to_xyz(_t(vals), pwl).numpy(),
        _np(jspec.to_xyz(jnp.asarray(vals), jwl)), rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        film.spectrum_to_rgb(_t(vals), pwl).numpy(),
        _np(jfilm.spectrum_to_rgb(jnp.asarray(vals), jwl)), rtol=1e-5, atol=1e-6,
    )


CORNELL_RGBS = [(0.73, 0.73, 0.73), (0.65, 0.05, 0.05), (0.12, 0.45, 0.15),
                (0.25, 0.25, 0.25)]


def test_rgb2spec_fits_of_cornell_rgbs():
    np.testing.assert_allclose(
        rgb2spec.fit_albedo(CORNELL_RGBS).numpy(),
        _np(jr2s.fit_albedo(jnp.asarray(CORNELL_RGBS, jnp.float32))), rtol=1e-5,
    )
    emit = [np.asarray((1.0, 0.8, 0.55)) * 18.0, (0.2004, 0.9240, 1.1022),
            (3.9129, 2.4476, 2.1422)]
    pc, ps = rgb2spec.fit_unbounded(emit)
    jc, js = jr2s.fit_unbounded(jnp.asarray(emit, jnp.float32))
    np.testing.assert_allclose(pc.numpy(), _np(jc), rtol=1e-5)
    np.testing.assert_allclose(ps.numpy(), _np(js), rtol=1e-5)


def test_eval_sigmoid_and_illuminant():
    jwl, pwl = _wavelengths(1024, seed=6)
    coeffs = np.random.default_rng(7).normal(0, 3, (1024, 3)).astype(np.float32)
    scale = np.random.default_rng(8).uniform(0, 20, 1024).astype(np.float32)
    # sigmoid(z) = 0.5 + 0.5 z / sqrt(1 + z^2) cancels for z << 0: one ulp
    # of 0.5 (6e-8) of absolute error is inherent, hence the atol.
    np.testing.assert_allclose(
        rgb2spec.eval_sigmoid(_t(coeffs), pwl.lam).numpy(),
        _np(jr2s.eval_sigmoid(jnp.asarray(coeffs), jwl.lam)),
        rtol=1e-5, atol=1e-7,
    )
    np.testing.assert_allclose(
        rgb2spec.eval_illuminant(_t(coeffs), _t(scale), pwl.lam).numpy(),
        _np(jr2s.eval_illuminant(jnp.asarray(coeffs), jnp.asarray(scale), jwl.lam)),
        rtol=1e-5, atol=1e-6,
    )


def _unit_vectors(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    v[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0]]  # axis cases
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_frames_match():
    ns = _unit_vectors(4096, 9)
    dpdu = np.zeros_like(ns)
    dpdu[::3] = _unit_vectors(4096, 10)[::3]  # some lanes carry a tangent
    for got, want in zip(
        vecmath.coordinate_system(_t(ns)), jvec.coordinate_system(jnp.asarray(ns))
    ):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6)
    for got, want in zip(
        vecmath.shading_frame(_t(ns), _t(dpdu)),
        jvec.shading_frame(jnp.asarray(ns), jnp.asarray(dpdu)),
    ):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6)
    w = _unit_vectors(4096, 11)
    t1, t2 = vecmath.coordinate_system(_t(ns))
    loc = vecmath.to_local(_t(w), t1, t2, _t(ns))
    np.testing.assert_allclose(
        vecmath.from_local(loc, t1, t2, _t(ns)).numpy(), w, atol=1e-5
    )


def test_warps_match():
    u = np.random.default_rng(12).uniform(0, 1, (8192, 2)).astype(np.float32)
    u[:3] = [[0.5, 0.5], [0.0, 0.0], [0.25, 0.75]]
    for name in ("sample_uniform_disk_concentric", "sample_uniform_triangle"):
        np.testing.assert_allclose(
            getattr(sampling, name)(_t(u)).numpy(),
            _np(getattr(jsampling, name)(jnp.asarray(u))), atol=1e-6,
        )
    # z = sqrt(1 - x^2 - y^2): an ulp (6e-8) of difference in 1 - r^2 from
    # cos/sin becomes 6e-8 / (2 z) in z, over 1e-6 for z < 0.03. Compare
    # x, y and z^2 everywhere and z itself away from the rim.
    got = sampling.sample_cosine_hemisphere(_t(u)).numpy()
    want = _np(jsampling.sample_cosine_hemisphere(jnp.asarray(u)))
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=1e-6)
    np.testing.assert_allclose(got[:, 2] ** 2, want[:, 2] ** 2, atol=1e-6)
    rim = want[:, 2] < 0.15
    np.testing.assert_allclose(got[~rim, 2], want[~rim, 2], atol=1e-6)
    a, b = (np.random.default_rng(13).uniform(0, 5, (2, 4096)).astype(np.float32))
    a[:8] = 0.0
    np.testing.assert_allclose(
        sampling.power_heuristic(1, _t(a), 1, _t(b)).numpy(),
        _np(jsampling.power_heuristic(1, jnp.asarray(a), 1, jnp.asarray(b))),
        rtol=1e-6,
    )
