"""Chiang-style hair BSDF over ray batches (port of pbrt_tpu/materials/hair.py).

The per-lobe loop over the scattering orders p = 0..P_MAX of pbrt-v4's
HairBxDF (bxdfs.h HairBxDF, bxdfs.cpp) is a stacked p axis, so the
longitudinal (Mp), azimuthal (Np) and attenuation (Ap) factors evaluate as
one batched computation; all control flow is a select.

Hair frame (as the reference): the curve tangent is the local +x axis, so
sin(theta) = w.x and the azimuth is atan2(w.z, w.y); the shading normal is
z (f divides by |wi.z|).
"""

from __future__ import annotations

import math

import torch

from ..core import floats
from ..core.vecmath import safe_sqrt as _safe_sqrt

P_MAX = 3
_EPS = 1e-7
_SQRT_PI_OVER_8 = 0.626657069


def _sqr(x):
    return x * x


def _ipow(x, n: int):
    """x ** n for an integer n by repeated squaring, in the order of the
    reference's integer power (lax.integer_pow)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _safe_asin(x):
    return torch.arcsin(torch.clamp(x, -1.0, 1.0))


def _i0(x):
    """Modified Bessel I0 by its power series (10 terms, as pbrt-v4)."""
    val = torch.zeros_like(x)
    x2i = torch.ones_like(x)
    ifact = 1.0
    i4 = 1.0
    for i in range(10):
        if i > 1:
            ifact *= i
        val = val + x2i / (i4 * ifact * ifact)
        x2i = x2i * x * x
        i4 *= 4.0
    return val


def _log_i0(x):
    xe = torch.clamp(x, min=_EPS)
    big = x + 0.5 * (-math.log(2.0 * math.pi) + torch.log(1.0 / xe)
                     + 1.0 / (8.0 * xe))
    small = torch.log(_i0(torch.clamp(x, max=12.0)))
    return torch.where(x > 12.0, big, small)


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering lobe (bxdfs.h Mp), with the stable small-v
    form."""
    v = torch.clamp(v, min=1e-5)
    small = v <= 0.1
    vs = vb = v
    if floats.grad_flows(cos_ti, cos_to, sin_ti, sin_to, v):
        # Each form sees a v of its own range (the same values on the
        # lanes that take it): the other form's overflow would reach the
        # gradient as 0 * inf.
        vs = torch.where(small, v, 0.1)
        vb = torch.where(small, 1.0, v)
    a = cos_ti * cos_to / vs
    b = sin_ti * sin_to / vs
    small_v = torch.exp(_log_i0(a) - b - 1.0 / vs + 0.6931
                        + torch.log(1.0 / (2.0 * vs)))
    if vb is not vs:
        a = cos_ti * cos_to / vb
        b = sin_ti * sin_to / vb
    # sinh(1/v) overflows for small v; the unused branch's argument is
    # clamped.
    inv_v = torch.clamp(1.0 / vb, max=30.0)
    big_v = torch.exp(-b) * _i0(a) / (floats.sinh(inv_v) * 2.0 * vb)
    return torch.where(small, small_v, big_v)


def _logistic(x, s):
    x = torch.abs(x)
    e = torch.exp(-x / s)
    return e / (s * _sqr(1.0 + e))


def _logistic_cdf(x, s):
    z = -x / s
    if floats.grad_flows(z):
        # exp(z) overflows where s is small (the rows that are not hair,
        # whose beta_n is a coat roughness): the value is kept and its
        # gradient, 0 * inf on lanes a where drops, is cut there.
        far = z > 80.0
        near = 1.0 / (1.0 + torch.exp(torch.where(far, 0.0, z)))
        return torch.where(far, 1.0 / (1.0 + torch.exp(z.detach())), near)
    return 1.0 / (1.0 + torch.exp(z))


def _trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / (_logistic_cdf(b, s) - _logistic_cdf(a, s))


def _sample_trimmed_logistic(u, s, a, b):
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    x = -s * torch.log(
        1.0 / torch.clamp(u * k + _logistic_cdf(a, s), _EPS, 1.0 - _EPS) - 1.0)
    return torch.clamp(x, a, b)


def _phi_p(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * math.pi


def _np(phi, p, s, gamma_o, gamma_t):
    dphi = phi - _phi_p(p, gamma_o, gamma_t)
    dphi = torch.remainder(dphi + math.pi, 2.0 * math.pi) - math.pi
    return _trimmed_logistic(dphi, s, -math.pi, math.pi)


def longitudinal_variance(beta_m):
    """v[p] for p = 0..P_MAX, stacked on a last axis of 4."""
    v0 = _sqr(0.726 * beta_m + 0.812 * _sqr(beta_m) + 3.7 * _ipow(beta_m, 20))
    return torch.stack([v0, 0.25 * v0, 4.0 * v0, 4.0 * v0], dim=-1)


def azimuthal_s(beta_n):
    return _SQRT_PI_OVER_8 * (
        0.265 * beta_n + 1.194 * _sqr(beta_n) + 5.372 * _ipow(beta_n, 22)
    )


def _tilt_tables(alpha):
    """sin / cos of 2^k alpha for k = 0..2 by angle doubling."""
    s0 = torch.sin(torch.deg2rad(alpha))
    c0 = _safe_sqrt(1.0 - _sqr(s0))
    s1 = 2.0 * c0 * s0
    c1 = _sqr(c0) - _sqr(s0)
    s2 = 2.0 * c1 * s1
    c2 = _sqr(c1) - _sqr(s1)
    return (s0, s1, s2), (c0, c1, c2)


def _tilted_o(sin_to, cos_to, alpha):
    """(sin, |cos|) of the tilted theta_o for each p, stacked (..., 4): p = 0
    turns by +2 alpha, p = 1 by -alpha, p = 2 by -4 alpha, p >= 3 not at
    all (bxdfs.cpp)."""
    (s0, s1, s2), (c0, c1, c2) = _tilt_tables(alpha)
    sin_p = torch.stack([
        sin_to * c1 - cos_to * s1,
        sin_to * c0 + cos_to * s0,
        sin_to * c2 + cos_to * s2,
        sin_to,
    ], dim=-1)
    cos_p = torch.stack([
        cos_to * c1 + sin_to * s1,
        cos_to * c0 - sin_to * s0,
        cos_to * c2 - sin_to * s2,
        cos_to,
    ], dim=-1)
    return sin_p, torch.abs(cos_p)


def _fr_dielectric(cos_i, eta):
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = (1.0 - _sqr(cos_i)) / _sqr(eta)
    cos_t = _safe_sqrt(1.0 - sin2_t)
    r_par = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=_EPS)
    r_per = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=_EPS)
    fr = 0.5 * (_sqr(r_par) + _sqr(r_per))
    return torch.where(sin2_t >= 1.0, 1.0, torch.clamp(fr, 0.0, 1.0))


def _geom_terms(h, eta, sin_to, cos_to):
    """gamma_o, gamma_t, cos gamma_t and cos theta_t, which f, pdf and
    sample share."""
    gamma_o = _safe_asin(h)
    etap = _safe_sqrt(_sqr(eta) - _sqr(sin_to)) / torch.clamp(cos_to, min=_EPS)
    sin_gt = h / torch.clamp(etap, min=_EPS)
    cos_gt = _safe_sqrt(1.0 - _sqr(sin_gt))
    gamma_t = _safe_asin(sin_gt)
    sin_tt = sin_to / eta
    cos_tt = _safe_sqrt(1.0 - _sqr(sin_tt))
    return gamma_o, gamma_t, cos_gt, cos_tt


def _ap(cos_to, eta, h, T):
    """Attenuation per lobe, (..., 4, S); T is (..., S) (bxdfs.h Ap)."""
    cos_go = _safe_sqrt(1.0 - _sqr(h))
    f = _fr_dielectric(cos_to * cos_go, eta)[..., None]
    a0 = f.expand(T.shape)
    a1 = _sqr(1.0 - f) * T
    a2 = a1 * T * f
    a3 = a2 * f * T / torch.clamp(1.0 - T * f, min=_EPS)
    return torch.stack([a0, a1, a2, a3], dim=-2)


def _transmittance(sigma_a, cos_gt, cos_tt):
    return torch.exp(-sigma_a * (2.0 * cos_gt / torch.clamp(cos_tt, min=_EPS))[..., None])


def _ap_pdf(cos_to, eta, h, sigma_a):
    """Lobe-selection pmf (..., 4): the spectrally averaged Ap, normalized."""
    sin_to = _safe_sqrt(1.0 - _sqr(cos_to))
    _, _, cos_gt, cos_tt = _geom_terms(h, eta, sin_to, cos_to)
    ap = _ap(cos_to, eta, h, _transmittance(sigma_a, cos_gt, cos_tt)).mean(dim=-1)
    return ap / torch.clamp(ap.sum(dim=-1, keepdim=True), min=_EPS)


def _angles(w):
    """(sin theta, cos theta, phi) of a direction in the hair frame."""
    sin_t = w[..., 0]
    return sin_t, _safe_sqrt(1.0 - _sqr(sin_t)), floats.atan2(w[..., 2], w[..., 1])


def _lobes(h, eta, beta_m, beta_n, alpha, wo, wi):
    """Mp and Np (with the uniform p = P_MAX term) of each lobe, (N, 4),
    and cos theta_o."""
    sin_to, cos_to, phi_o = _angles(wo)
    sin_ti, cos_ti, phi_i = _angles(wi)
    gamma_o, gamma_t, cos_gt, cos_tt = _geom_terms(h, eta, sin_to, cos_to)
    v = longitudinal_variance(beta_m)
    s = azimuthal_s(beta_n)
    sin_top, cos_top = _tilted_o(sin_to, cos_to, alpha)
    mp = _mp(cos_ti[..., None], cos_top, sin_ti[..., None], sin_top, v)
    p_idx = torch.arange(P_MAX, dtype=wo.dtype, device=wo.device)
    np_ = _np((phi_i - phi_o)[..., None], p_idx,
              s[..., None] if s.ndim else s,
              gamma_o[..., None], gamma_t[..., None])
    np_full = torch.cat(
        [np_, torch.full_like(np_[..., :1], 1.0 / (2.0 * math.pi))], dim=-1)
    return mp, np_full, cos_to, (cos_gt, cos_tt)


def hair_f(h, eta, sigma_a, beta_m, beta_n, alpha, wo, wi):
    """f(wo, wi): (N, S). sigma_a (N, S); h, eta, beta_m, beta_n and alpha
    (N,)."""
    mp, np_full, cos_to, (cos_gt, cos_tt) = _lobes(
        h, eta, beta_m, beta_n, alpha, wo, wi)
    ap = _ap(cos_to, eta, h, _transmittance(sigma_a, cos_gt, cos_tt))
    fsum = (mp[..., None] * ap * np_full[..., None]).sum(dim=-2)
    return fsum / torch.clamp(torch.abs(wi[..., 2]), min=_EPS)[..., None]


def hair_pdf(h, eta, sigma_a, beta_m, beta_n, alpha, wo, wi):
    """Solid-angle pdf of hair_sample, (N,)."""
    mp, np_full, cos_to, _ = _lobes(h, eta, beta_m, beta_n, alpha, wo, wi)
    ap_pdf = _ap_pdf(cos_to, eta, h, sigma_a)
    return (mp * ap_pdf * np_full).sum(dim=-1)


def _pick(table, p):
    return torch.gather(table.expand(p.shape + table.shape[-1:]), -1,
                        p[..., None])[..., 0]


def hair_sample(h, eta, sigma_a, beta_m, beta_n, alpha, wo, u2, uc):
    """Sample wi. Returns (wi (N, 3), f (N, S), pdf (N,)).

    The lobe p is drawn from the Ap pmf with uc (its remainder reused for
    the azimuthal logistic), the longitudinal angle by inverting Mp with
    u2 (bxdfs.cpp HairBxDF::Sample_f)."""
    sin_to, cos_to, phi_o = _angles(wo)
    gamma_o, gamma_t, _, _ = _geom_terms(h, eta, sin_to, cos_to)
    ap_pdf = _ap_pdf(cos_to, eta, h, sigma_a)
    c0 = ap_pdf[..., 0]
    c1 = c0 + ap_pdf[..., 1]
    c2 = c1 + ap_pdf[..., 2]
    cdf = torch.stack([c0, c1, c2, c2 + ap_pdf[..., 3]], dim=-1)
    p = (uc[..., None] >= cdf[..., :-1]).sum(dim=-1)  # (N,) in 0..3
    lo = torch.where(p > 0, _pick(cdf, torch.clamp(p - 1, min=0)), 0.0)
    pmf_p = _pick(ap_pdf, p)
    uc_rem = torch.clamp((uc - lo) / torch.clamp(pmf_p, min=_EPS), 0.0, 1.0 - 1e-6)

    vp = _pick(longitudinal_variance(beta_m), p)
    s = azimuthal_s(beta_n)
    sin_top_all, cos_top_all = _tilted_o(sin_to, cos_to, alpha)
    sin_top = _pick(sin_top_all, p)
    cos_top = _pick(cos_top_all, p)

    # Longitudinal: invert Mp.
    u0 = torch.clamp(u2[..., 0], min=1e-5)
    cos_theta = 1.0 + vp * torch.log(
        u0 + (1.0 - u2[..., 0]) * torch.exp(-2.0 / torch.clamp(vp, min=1e-5)))
    sin_theta = _safe_sqrt(1.0 - _sqr(cos_theta))
    cos_phi_l = torch.cos(2.0 * math.pi * u2[..., 1])
    sin_ti = -cos_theta * sin_top + sin_theta * cos_phi_l * cos_top
    cos_ti = _safe_sqrt(1.0 - _sqr(sin_ti))

    # Azimuthal: a trimmed logistic around Phi(p) for p < P_MAX, uniform
    # for p = P_MAX.
    dphi_log = _phi_p(p.to(wo.dtype), gamma_o, gamma_t) + _sample_trimmed_logistic(
        uc_rem, s, -math.pi, math.pi)
    dphi = torch.where(p == P_MAX, 2.0 * math.pi * uc_rem, dphi_log)
    phi_i = phi_o + dphi
    wi = torch.stack([sin_ti, cos_ti * torch.cos(phi_i),
                      cos_ti * torch.sin(phi_i)], dim=-1)
    return (wi, hair_f(h, eta, sigma_a, beta_m, beta_n, alpha, wo, wi),
            hair_pdf(h, eta, sigma_a, beta_m, beta_n, alpha, wo, wi))


# --- Pigments (bxdfs.cpp HairBxDF::SigmaAFromConcentration / Reflectance) --

# Melanin absorption coefficients (Chiang et al. 2016).
_EUMELANIN_RGB = (0.419, 0.697, 1.37)
_PHEOMELANIN_RGB = (0.187, 0.4, 1.05)


def sigma_a_from_concentration(ce, cp):
    """RGB absorption of eumelanin / pheomelanin concentrations, (3,)."""
    eu = torch.tensor(_EUMELANIN_RGB, dtype=torch.float32)
    ph = torch.tensor(_PHEOMELANIN_RGB, dtype=torch.float32)
    return ce * eu + cp * ph


def sigma_a_from_reflectance(c, beta_n):
    """The absorption that gives reflectance c at azimuthal roughness
    beta_n."""
    denom = (
        5.969
        - 0.215 * beta_n
        + 2.532 * _sqr(beta_n)
        - 10.73 * beta_n ** 3
        + 5.574 * beta_n ** 4
        + 0.245 * beta_n ** 5
    )
    return _sqr(torch.log(torch.clamp(torch.as_tensor(c, dtype=torch.float32),
                                      min=1e-5)) / denom)
