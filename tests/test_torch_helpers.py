"""The reference's public helpers that no render path of the port calls
(core/sampling.py, floats.py, vecmath.py, cie.py, spectrum.py, rng.py)
against the JAX package's on the same inputs, on the CPU, with the cases
of tests/test_core_sampling.py, test_foundation.py, test_core_color.py and
test_core_geometry.py.

Integer hashes, selections and sums whose every operation is one IEEE
rounding in both packages are bit-equal. Where a transcendental function
(cos, sin, log, exp, acos, atan2) or a reduction's order enters, the two
math libraries may round differently: those values are held within 4
float32 ulps of their scale (rtol 5e-7, with an atol of 5e-7 for values
that cancel to near zero), and the integer decisions they feed (a
reservoir's survivor, a cone's containment) must agree on every lane.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import cie as jcie
from pbrt_tpu.core import floats as jfloats
from pbrt_tpu.core import rng as jrng
from pbrt_tpu.core import sampling as jsampling
from pbrt_tpu.core import spectrum as jspectrum
from pbrt_tpu.core import vecmath as jvec
from pbrt_tpu_torch.core import cie, floats, rng, sampling, spectrum, vecmath

torch.set_num_threads(2)
ULP = dict(rtol=5e-7, atol=5e-7)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(kw or ULP))


def _uniform_grid(n):
    u = (np.arange(n) + 0.5) / n
    a, b = np.meshgrid(u, u, indexing="ij")
    return np.stack([a.ravel(), b.ravel()], axis=-1).astype(np.float32)


def _rand_dirs(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


# --- core/rng.py -------------------------------------------------------------

def test_hash_u32_and_uniform_4d_bit_equal():
    x = np.concatenate([np.arange(4096), [0xFFFFFFFF, 0x80000000, 12345678]])
    _same(rng.hash_u32(_t(x)).numpy().astype(np.uint32),
          jrng.hash_u32(jnp.asarray(x, jnp.uint32)))
    assert rng.hash_u32(7) == int(jrng.hash_u32(7))
    pix = np.arange(1 << 12)
    got = rng.uniform_4d(_t(pix), 3, 7, seed=42)
    want = jrng.uniform_4d(jnp.asarray(pix), 3, 7, seed=42)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _same(g, w)
        assert 0.0 <= float(g.min()) and float(g.max()) < 1.0
    assert float(torch.mean(torch.abs(got[0] - got[1]))) > 0.1


# --- core/sampling.py --------------------------------------------------------

def test_uniform_hemisphere_and_exponential():
    u = _uniform_grid(64)
    d = sampling.sample_uniform_hemisphere(_t(u))
    _close(d, jsampling.sample_uniform_hemisphere(jnp.asarray(u)))
    np.testing.assert_allclose(vecmath.length(d).numpy(), 1.0, atol=1e-4)
    assert float(d[..., 2].min()) >= 0.0
    assert abs(float(d[..., 2].mean()) - 0.5) < 0.01  # E[cos] = 1/2
    assert sampling.UNIFORM_HEMISPHERE_PDF == jsampling.UNIFORM_HEMISPHERE_PDF
    t = sampling.sample_exponential(_t(u[:, 0]), 2.5)
    _close(t, jsampling.sample_exponential(jnp.asarray(u[:, 0]), 2.5))
    assert abs(float(t.mean()) - 1.0 / 2.5) < 0.01


def test_triangle_warp_roundtrip():
    u = _uniform_grid(32)
    b = sampling.sample_uniform_triangle(_t(u))
    u_back = sampling.invert_uniform_triangle(b)
    _same(u_back, jsampling.invert_uniform_triangle(
        jsampling.sample_uniform_triangle(jnp.asarray(u))))
    np.testing.assert_allclose(u_back.numpy(), u, atol=1e-5)


@pytest.mark.parametrize("n", [4, 40])
def test_sample_discrete(n):
    """The reference's case (4 weights) and a table longer than one of
    XLA's 16-entry scan blocks: index, pmf and remapped u bit-equal."""
    w = (np.asarray([1.0, 2.0, 3.0, 2.0], np.float32) if n == 4 else
         np.random.default_rng(5).uniform(0.0, 3.0, n).astype(np.float32))
    u = ((np.arange(8192) + 0.5) / 8192).astype(np.float32)
    wb = np.broadcast_to(w, (8192, n)).copy()
    idx, pmf, u_new = sampling.sample_discrete(_t(wb), _t(u))
    jidx, jpmf, ju = jsampling.sample_discrete(jnp.asarray(wb), jnp.asarray(u))
    _same(idx, jidx)
    _same(pmf, jpmf)
    _same(u_new, ju)
    counts = np.bincount(idx.numpy(), minlength=n) / 8192
    np.testing.assert_allclose(counts, w / w.sum(), atol=0.01)
    assert float(u_new.min()) >= 0.0 and float(u_new.max()) < 1.0


def test_mis_heuristics():
    r = np.random.default_rng(2)
    f, g = (r.uniform(0.0, 4.0, 1000).astype(np.float32) for _ in range(2))
    f[::7] = 0.0
    _same(sampling.balance_heuristic(1, _t(f), 2, _t(g)),
          jsampling.balance_heuristic(1, jnp.asarray(f), 2, jnp.asarray(g)))
    assert abs(float(sampling.balance_heuristic(1, torch.tensor(2.0), 1,
                                                torch.tensor(1.0)))
               - 2.0 / 3.0) < 1e-6
    assert float(sampling.balance_heuristic(1, torch.tensor(0.0), 1,
                                            torch.tensor(1.0))) == 0.0


def test_variance_estimator():
    est = sampling.VarianceEstimator.zeros()
    jest = jsampling.VarianceEstimator.zeros()
    xs = [1.0, 2.0, 3.0, 4.0]
    for x in xs:
        est = est.add(torch.tensor(x))
        jest = jest.add(jnp.asarray(x))
    _same(est.mean, jest.mean)
    _same(est.variance(), jest.variance())
    np.testing.assert_allclose(float(est.mean), 2.5)
    np.testing.assert_allclose(float(est.variance()), np.var(xs, ddof=1))
    assert est.n.dtype == torch.int32
    lanes = np.random.default_rng(1).normal(size=(5, 64)).astype(np.float32)
    est = sampling.VarianceEstimator.zeros((64,))
    jest = jsampling.VarianceEstimator.zeros((64,))
    for row in lanes:
        est, jest = est.add(_t(row)), jest.add(jnp.asarray(row))
    _same(est.variance(), jest.variance())


def test_weighted_reservoir_sampler():
    """Streaming selection frequencies converge to the weights'
    proportions, and merged reservoirs match one stream (sampling.h:82);
    every lane's survivor is the reference's."""
    n = 20000
    weights = np.asarray([1.0, 3.0, 0.5, 5.5])
    lanes = np.arange(n)

    def stream(mod, rng_mod, lanes_of, empty, split):
        res = [empty((n,), 1), empty((n,), 1)]
        for i, w in enumerate(weights):
            u = rng_mod.uniform_1d(lanes_of(lanes), i, 13 if split else 7,
                                   17 if split else 11)
            k = int(split and i >= 2)
            res[k] = res[k].add(mod.full((n, 1), float(i)),
                                mod.full((n,), float(w)), u)
        if split:
            return res[0].merge(res[1], rng_mod.uniform_1d(lanes_of(lanes),
                                                           9, 23, 29))
        return res[0]

    for split in (False, True):
        got = stream(torch, rng, _t, sampling.WeightedReservoirSampler.empty,
                     split)
        want = stream(jnp, jrng, jnp.asarray,
                      jsampling.WeightedReservoirSampler.empty, split)
        for k in ("value", "weight_sum", "survivor_w"):
            _same(getattr(got, k), getattr(want, k))
        np.testing.assert_allclose(float(got.weight_sum[0]), weights.sum(),
                                   rtol=1e-6)
        freq = np.bincount(got.value[:, 0].numpy().astype(int),
                           minlength=4) / n
        np.testing.assert_allclose(freq, weights / weights.sum(), atol=0.02)


# --- core/floats.py ----------------------------------------------------------

def test_gamma_two_sum_and_compensated_sum():
    for n in (1, 3, 7):
        _same(floats.gamma(n), jfloats.gamma(n))
        assert vecmath.gamma(n) == jvec.gamma(n)
    assert float(floats.gamma(3)) > 0.0
    assert floats.MACHINE_EPSILON == jfloats.MACHINE_EPSILON
    s, err = floats.two_sum(torch.tensor(1.0), torch.tensor(1e-9))
    assert abs((float(s) + float(err)) - (1.0 + 1e-9)) < 1e-17
    r = np.random.default_rng(3)
    a, b = ((r.normal(size=4096) * 10.0 ** r.integers(-8, 8, 4096)).astype(
        np.float32) for _ in range(2))
    for g, w in zip(floats.two_sum(_t(a), _t(b)),
                    jfloats.two_sum(jnp.asarray(a), jnp.asarray(b))):
        _same(g, w)
    n = 10000
    vals = np.concatenate([[1.0], np.full(n, 1e-8)]).astype(np.float32)
    comp = floats.compensated_sum(_t(vals))
    _same(comp, jfloats.compensated_sum(jnp.asarray(vals)))
    naive = float(np.cumsum(vals, dtype=np.float32)[-1])
    exact = 1.0 + 1e-8 * n
    assert abs(float(comp) - exact) < abs(naive - exact)
    assert abs(float(comp) - exact) < 1e-7
    mat = r.normal(size=(3, 50, 4)).astype(np.float32)
    _same(floats.compensated_sum(_t(mat), axis=1),
          jfloats.compensated_sum(jnp.asarray(mat), axis=1))


# --- core/vecmath.py ---------------------------------------------------------

def test_small_vector_helpers():
    a, b = _rand_dirs(256, 1) * 2.0, _rand_dirs(256, 2)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = _t(a), _t(b)
    t = np.random.default_rng(3).random((256, 1)).astype(np.float32)
    _same(vecmath.absdot(ta, tb), jvec.absdot(ja, jb))
    _close(vecmath.length(ta), jvec.length(ja))
    _close(vecmath.distance(ta, tb), jvec.distance(ja, jb))
    _same(vecmath.lerp(_t(t), ta, tb), jvec.lerp(jnp.asarray(t), ja, jb))
    _same(vecmath.face_forward(ta, tb), jvec.face_forward(ja, jb))
    _close(vecmath.reflect(tb, ta), jvec.reflect(jb, ja))
    _close(vecmath.safe_acos(tb[:, 0] * 1.1), jvec.safe_acos(jb[:, 0] * 1.1))
    _close(vecmath.spherical_theta(tb), jvec.spherical_theta(jb))
    _close(vecmath.spherical_phi(tb), jvec.spherical_phi(jb))
    st, ct, ph = (_t(x) for x in (t[:, 0], 1.0 - t[:, 0], 6.0 * t[:, 0]))
    _close(vecmath.spherical_direction(st, ct, ph),
           jvec.spherical_direction(*(jnp.asarray(x.numpy())
                                      for x in (st, ct, ph))))
    # The reference's reflection case.
    n = torch.tensor([[0.0, 0.0, 1.0]])
    wo = vecmath.normalize(torch.tensor([[1.0, 0.0, 1.0]]))
    np.testing.assert_allclose(
        vecmath.reflect(wo, n).numpy(),
        vecmath.normalize(torch.tensor([[-1.0, 0.0, 1.0]])).numpy(), atol=1e-6)


def test_octahedral_roundtrip():
    v = _rand_dirs(512, 3)
    e = vecmath.octahedral_encode(_t(v))
    je = jvec.octahedral_encode(jnp.asarray(v))
    _same(e, je)
    assert float(e.abs().max()) <= 1.0 + 1e-6
    back = vecmath.octahedral_decode(e)
    _close(back, jvec.octahedral_decode(je))
    np.testing.assert_allclose(back.numpy(), v, atol=1e-5)


def test_direction_cone():
    up = torch.tensor([[0.0, 0.0, 1.0]])
    x = torch.tensor([[1.0, 0.0, 0.0]])
    c_up = vecmath.DirectionCone.from_direction(up)
    assert bool(c_up.inside(up)[0]) and not bool(c_up.inside(x)[0])
    u = vecmath.direction_cone_union(
        vecmath.DirectionCone.from_direction(up),
        vecmath.DirectionCone.from_direction(x))
    bis = torch.tensor([[np.sqrt(0.5), 0.0, np.sqrt(0.5)]])
    assert bool(u.inside(bis)[0])
    assert not bool(u.inside(torch.tensor([[0.0, 0.0, -1.0]]))[0])
    bc = vecmath.bound_subtended_directions(
        torch.tensor([0.0, 0.0, 0.0]), torch.tensor([1.0, 1.0, 1.0]),
        torch.tensor([[5.0, 0.5, 0.5], [0.5, 0.5, 0.5]]))
    assert float(bc.cos_theta[0]) > 0.9 and float(bc.cos_theta[1]) == -1.0
    assert bool(bc.inside(torch.tensor([[-1.0, 0.0, 0.0]]))[0])
    whole = vecmath.DirectionCone.entire_sphere()
    jwhole = jvec.DirectionCone.entire_sphere()
    _same(whole.w, jwhole.w)
    _same(whole.cos_theta, jwhole.cos_theta)


def test_direction_cones_against_reference():
    """Unions over every case (empty, nested both ways, merged, whole
    sphere) and bounds from points inside and outside the box, per lane
    against the reference; containment decisions equal on every probe."""
    r = np.random.default_rng(9)
    n = 512
    wa, wb = _rand_dirs(n, 4), _rand_dirs(n, 5)
    ca = r.uniform(-1.0, 1.0, n).astype(np.float32)
    cb = r.uniform(-1.0, 1.0, n).astype(np.float32)
    ca[::11] = 2.0  # empty
    cb[5::13] = 2.0
    cb[1::17] = 1.0  # single directions
    wb[2::19] = wa[2::19]  # shared axes
    a = vecmath.DirectionCone(w=_t(wa), cos_theta=_t(ca))
    b = vecmath.DirectionCone(w=_t(wb), cos_theta=_t(cb))
    ja = jvec.DirectionCone(w=jnp.asarray(wa), cos_theta=jnp.asarray(ca))
    jb = jvec.DirectionCone(w=jnp.asarray(wb), cos_theta=jnp.asarray(cb))
    got = vecmath.direction_cone_union(a, b)
    want = jvec.direction_cone_union(ja, jb)
    _close(got.w, want.w, rtol=1e-5, atol=1e-5)
    _close(got.cos_theta, want.cos_theta, rtol=1e-5, atol=1e-5)
    probe = _rand_dirs(n, 6)
    inside = got.inside(_t(probe)).numpy()
    jinside = np.asarray(want.inside(jnp.asarray(probe)))
    margin = np.abs(np.sum(probe * got.w.numpy(), -1) - got.cos_theta.numpy())
    assert np.all((inside == jinside) | (margin < 1e-5))
    lo = r.uniform(-1.0, 0.0, (n, 3)).astype(np.float32)
    hi = lo + r.uniform(0.1, 2.0, (n, 3)).astype(np.float32)
    p = r.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    bc = vecmath.bound_subtended_directions(_t(lo), _t(hi), _t(p))
    jbc = jvec.bound_subtended_directions(jnp.asarray(lo), jnp.asarray(hi),
                                          jnp.asarray(p))
    _close(bc.w, jbc.w)
    _close(bc.cos_theta, jbc.cos_theta)
    assert 0 < int((bc.cos_theta == -1.0).sum()) < n


# --- core/cie.py and core/spectrum.py ----------------------------------------

def test_blackbody_wien():
    lam = np.linspace(200.0, 1500.0, 2601).astype(np.float32)
    vals = cie.blackbody(_t(lam), 6000.0)
    _close(vals, jcie.blackbody(jnp.asarray(lam), 6000.0))
    assert abs(float(lam[int(torch.argmax(vals))]) - 482.9) < 2.0
    nb = cie.normalized_blackbody(_t(lam), 6000.0)
    _close(nb, jcie.normalized_blackbody(jnp.asarray(lam), 6000.0))
    assert abs(float(nb.max()) - 1.0) < 1e-3
    _close(spectrum.blackbody_normalized(_t(lam), 3000.0),
           jspectrum.blackbody_normalized(jnp.asarray(lam), 3000.0))


def test_illuminants_and_whitepoint():
    lam = np.linspace(360.0, 830.0, 941).astype(np.float32)
    a = cie.illuminant_a(_t(lam))
    _close(a, jcie.illuminant_a(jnp.asarray(lam)))
    assert abs(float(cie.illuminant_a(torch.tensor(560.0))) - 100.0) < 1e-3
    _same(cie.illuminant_e(_t(lam)), jcie.illuminant_e(jnp.asarray(lam)))
    wx, wy = cie.whitepoint_xy()
    _same(np.array([wx, wy]), jcie.whitepoint_xy())
    assert abs(wx - 0.3127) < 0.01 and abs(wy - 0.3290) < 0.01
    for port_ill, ref_ill in ((cie.illuminant_a, jcie.illuminant_a),
                              (cie.illuminant_e, jcie.illuminant_e)):
        _same(cie.whitepoint_xy(port_ill), jcie.whitepoint_xy(ref_ill))
    np.testing.assert_allclose(cie.whitepoint_xy(cie.illuminant_e),
                               [1.0 / 3.0, 1.0 / 3.0], atol=0.01)


def test_hero_wavelength_sampling():
    n_spec = jspectrum.N_SPECTRUM
    u = np.linspace(0.0, 0.999, 64).astype(np.float32)
    wl = spectrum.sample_uniform_hero(_t(u), n_spec)
    jwl = jspectrum.sample_uniform_hero(jnp.asarray(u))
    _same(wl.lam, jwl.lam)
    _same(wl.pdf, jwl.pdf)
    assert wl.lam.shape == (64, n_spec)
    assert float(wl.lam.min()) >= spectrum.LAMBDA_MIN - 1e-3
    assert float(wl.lam.max()) <= spectrum.LAMBDA_MAX + 1e-3
    # A constant spectrum has luminance equal to its value.
    ones = torch.ones_like(wl.lam)
    y = spectrum.luminance(ones, wl)
    _close(y, jspectrum.luminance(jnp.ones_like(jwl.lam), jwl))
    np.testing.assert_allclose(y.numpy(), 1.0, rtol=0.05)
    vals = np.random.default_rng(2).random((64, n_spec)).astype(np.float32)
    _close(spectrum.average(_t(vals)), jspectrum.average(jnp.asarray(vals)))
    c = spectrum.constant(0.25, wl.lam)
    _same(c, jspectrum.constant(0.25, jwl.lam))
    assert c.shape == wl.lam.shape


def test_piecewise_linear():
    """jnp.interp's rule: inside the table, on its knots, on a repeated
    knot and outside it (the end values held)."""
    lams = np.asarray([400.0, 450.0, 500.0, 500.0, 600.0, 700.0], np.float32)
    vals = np.asarray([0.1, 0.8, 0.3, 0.6, 0.2, 0.9], np.float32)
    lam = np.concatenate([
        np.random.default_rng(4).uniform(380.0, 720.0, 2000), lams,
        [380.0, 720.0]]).astype(np.float32)
    got = spectrum.piecewise_linear(lams, vals, _t(lam))
    want = jspectrum.piecewise_linear(jnp.asarray(lams), jnp.asarray(vals),
                                      jnp.asarray(lam))
    _close(got, want, rtol=2.4e-7, atol=1.2e-7)
    np.testing.assert_allclose(got.numpy(), np.interp(lam, lams, vals),
                               atol=1e-6)
