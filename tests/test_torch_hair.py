"""The port's hair BSDF (pbrt_tpu_torch/materials/hair.py) against the
reference's on the CPU, on the same numpy-seeded inputs: f and pdf at
given directions, sampling, the pigment mappings, and the port's own
white furnace and chi-square test (tests/chisq.py).

Tolerances: f and pdf at given directions within rtol 1e-4 / atol 1e-6 on
>= 99.5% of the lanes and rtol 1e-3 on all. The lobes are float32 series
and exponentials of angles from atan2 and asin, which XLA and PyTorch
round apart by an ulp; at beta ~0.02 the lobe's steepness turns that ulp
into up to 3.7e-4 of f (1.1e-5 at beta >= 0.2). Sampled directions
within 5e-5 absolute on >= 99.5% of the lanes (a lane whose uniform sits
on a lobe pmf's step picks the other lobe), f and pdf there, away from
grazing (|wi.z| > 0.05), within rtol 1e-3. The pigment mappings within
rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.materials import hair as jhair
from pbrt_tpu_torch.materials import hair

from .chisq import run_chi2, uniform_streams
from .torch_port_helpers import share_close

torch.set_num_threads(2)
N = 4096
S = 8


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(seed, beta_lo=0.2):
    """Per-lane h, eta, sigma_a (N, S), beta_m, beta_n, alpha and wo, wi."""
    r = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        h=r.uniform(-0.999, 0.999, N).astype(f32),
        eta=r.uniform(1.3, 1.8, N).astype(f32),
        sigma_a=r.uniform(0.0, 3.0, (N, S)).astype(f32),
        beta_m=r.uniform(beta_lo, 0.9, N).astype(f32),
        beta_n=r.uniform(beta_lo, 0.9, N).astype(f32),
        alpha=r.uniform(0.0, 4.0, N).astype(f32),
    ), _unit(r, N), _unit(r, N)


def _args(params, pkg):
    conv = jnp.asarray if pkg == "jax" else torch.from_numpy
    return [conv(params[k]) for k in ("h", "eta", "sigma_a", "beta_m",
                                       "beta_n", "alpha")]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("fn", ["hair_f", "hair_pdf"])
@pytest.mark.parametrize("seed, beta_lo", [(0, 0.2), (1, 0.02)],
                         ids=["rough", "smooth"])
def test_f_and_pdf_match_jax(fn, seed, beta_lo):
    params, wo, wi = _inputs(seed, beta_lo)
    want = np.asarray(getattr(jhair, fn)(*_args(params, "jax"),
                                         jnp.asarray(wo), jnp.asarray(wi)))
    got = getattr(hair, fn)(*_args(params, "torch"), _t(wo), _t(wi)).numpy()
    assert np.isfinite(got).all()
    share, n_bad = share_close(got, want, rtol=1e-4, atol=1e-6)
    assert share >= 0.995, n_bad
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


def test_sample_matches_jax():
    params, wo, _ = _inputs(2)
    r = np.random.default_rng(12)
    u2 = r.uniform(size=(N, 2)).astype(np.float32)
    uc = r.uniform(size=N).astype(np.float32)
    jwi, jf, jpdf = (np.asarray(x) for x in jhair.hair_sample(
        *_args(params, "jax"), jnp.asarray(wo), jnp.asarray(u2),
        jnp.asarray(uc)))
    wi, f, pdf = (x.numpy() for x in hair.hair_sample(
        *_args(params, "torch"), _t(wo), _t(u2), _t(uc)))
    assert np.isfinite(wi).all() and np.isfinite(f).all()
    close = np.all(np.abs(wi - jwi) <= 5e-5, axis=-1)
    assert close.mean() >= 0.995, int((~close).sum())
    ok = close & (np.abs(jwi[:, 2]) > 0.05)
    np.testing.assert_allclose(pdf[ok], jpdf[ok], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(f[ok], jf[ok], rtol=1e-3, atol=1e-6)


def test_sigma_a_mappings_match_jax():
    for ce, cp in ((1.3, 0.0), (0.3, 0.8), (8.0, 0.1)):
        np.testing.assert_allclose(
            hair.sigma_a_from_concentration(ce, cp).numpy(),
            np.asarray(jhair.sigma_a_from_concentration(ce, cp)), rtol=1e-6)
    c = np.asarray([0.05, 0.3, 0.8, 0.99], np.float32)
    for beta_n in (0.1, 0.3, 0.8):
        np.testing.assert_allclose(
            hair.sigma_a_from_reflectance(c, beta_n).numpy(),
            np.asarray(jhair.sigma_a_from_reflectance(jnp.asarray(c), beta_n)),
            rtol=1e-6)


def _wo(n, seed=3):
    u = uniform_streams(n, 2, seed=seed)
    z = 1.0 - 2.0 * u[:, 0]
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    ph = 2 * np.pi * u[:, 1]
    return _t(np.stack([r * np.cos(ph), r * np.sin(ph), z], -1)
              .astype(np.float32))


@pytest.mark.parametrize("beta", [0.2, 0.8])
def test_white_furnace(beta):
    """sigma_a = 0 conserves energy: E[f |cos| / pdf] ~ 1 over random wo
    (pbrt-v4 hair_test.cpp WhiteFurnaceSampled), at three offsets h."""
    n = 1 << 16
    wo = _wo(n)
    u = _t(uniform_streams(n, 3, seed=17).astype(np.float32))
    full = lambda v: torch.full((n,), v)  # noqa: E731
    for h in (-0.6, 0.1, 0.7):
        wi, f, pdf = hair.hair_sample(full(h), full(1.55), torch.zeros(n, 4),
                                      full(beta), full(beta), full(2.0), wo,
                                      u[:, :2], u[:, 2])
        w = f.mean(-1) * torch.abs(wi[:, 2])
        w = torch.where(pdf > 0, w / torch.clamp(pdf, min=1e-9), 0.0)
        est = float(w.mean())
        assert 0.95 < est < 1.05, f"h={h} beta={beta}: furnace={est}"


def test_chisq():
    """The sampled directions' histogram against hair_pdf's quadrature."""
    h, beta_m, beta_n, deg = 0.5, 0.3, 0.3, 35.0
    t = np.deg2rad(deg)
    wo_v = np.array([np.sin(t), np.cos(t) * 0.8, np.cos(t) * 0.6], np.float32)
    wo_v /= np.linalg.norm(wo_v)

    def consts(n):
        full = lambda v: torch.full((n,), v)  # noqa: E731
        return (full(h), full(1.55), torch.full((n, 4), 0.25), full(beta_m),
                full(beta_n), full(2.0), _t(np.tile(wo_v, (n, 1))))

    def sample_fn(u2, uc):
        n = u2.shape[0]
        wi, _, pdf = hair.hair_sample(*consts(n), _t(u2.astype(np.float32)),
                                      _t(uc.astype(np.float32)))
        return wi.numpy(), (pdf > 0).numpy()

    def pdf_fn(wi):
        return hair.hair_pdf(*consts(wi.shape[0]), _t(wi)).numpy()

    ok, p, stat, dof = run_chi2(sample_fn, pdf_fn, n_samples=1 << 18,
                                seed=35, n_tests=1, sub=3)
    assert ok, f"hair chi2 p={p:.2e} stat={stat:.1f} dof={dof}"
