"""Microfacet distribution + Fresnel terms (port of
pbrt_tpu/materials/scattering.py, the parts the conductor and dielectric
families use).

Trowbridge-Reitz (GGX) with visible-normal sampling, the dielectric
Fresnel term FrDielectric and the conductor's FrComplex (reference
util/scattering.h). All functions take batched local directions (z =
shading normal) and are branch-free.
"""

from __future__ import annotations

import math

import torch

from ..core.sampling import sample_uniform_disk_concentric
from ..core.vecmath import cross, length_squared, normalize, safe_sqrt

_EPS = 1e-9


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def sin2_theta(w):
    return torch.clamp(1.0 - cos2_theta(w), min=0.0)


def tan2_theta(w):
    return sin2_theta(w) / torch.clamp(cos2_theta(w), min=1e-12)


# --- Fresnel ----------------------------------------------------------------


def fr_dielectric(cos_theta_i, eta):
    """Unpolarized Fresnel reflectance for a real IOR (scattering.h
    FrDielectric). cos_theta_i may be negative (arriving from below); eta
    is the transmission side's IOR over the incident side's before any
    flip."""
    cos_theta_i = torch.clamp(cos_theta_i, -1.0, 1.0)
    flip = cos_theta_i < 0.0
    eta = torch.where(flip, 1.0 / eta, eta)
    cos_theta_i = torch.abs(cos_theta_i)
    sin2_t = (1.0 - cos_theta_i * cos_theta_i) / (eta * eta)
    tir = sin2_t >= 1.0
    cos_theta_t = safe_sqrt(1.0 - sin2_t)
    r_parl = (eta * cos_theta_i - cos_theta_t) / torch.clamp(
        eta * cos_theta_i + cos_theta_t, min=_EPS
    )
    r_perp = (cos_theta_i - eta * cos_theta_t) / torch.clamp(
        cos_theta_i + eta * cos_theta_t, min=_EPS
    )
    fr = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, 1.0, fr)


def fr_complex(cos_theta_i, eta, k):
    """Unpolarized Fresnel reflectance for a conductor with complex IOR
    eta + i k, exact formula in real arithmetic (scattering.h FrComplex).
    Broadcasts over spectral axes."""
    cos_theta_i = torch.clamp(torch.abs(cos_theta_i), 0.0, 1.0)
    cos2 = cos_theta_i * cos_theta_i
    sin2 = 1.0 - cos2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - sin2
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * e2 * k2)
    t1 = a2b2 + cos2
    a = safe_sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * cos_theta_i
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=_EPS)
    t3 = cos2 * a2b2 + sin2 * sin2
    t4 = t2 * sin2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=_EPS)
    return torch.clamp(0.5 * (rs + rp), 0.0, 1.0)


# --- Trowbridge-Reitz (GGX), isotropic --------------------------------------


def ggx_d(wm, alpha):
    """Microfacet NDF D(wm)."""
    a2 = alpha * alpha
    c2 = cos2_theta(wm)
    t = c2 * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * t * t, min=1e-12)


def ggx_lambda(w, alpha):
    return 0.5 * (safe_sqrt(1.0 + alpha * alpha * tan2_theta(w)) - 1.0)


def ggx_g1(w, alpha):
    return 1.0 / (1.0 + ggx_lambda(w, alpha))


def ggx_g(wo, wi, alpha):
    return 1.0 / (1.0 + ggx_lambda(wo, alpha) + ggx_lambda(wi, alpha))


def ggx_sample_wm(wo, u2, alpha):
    """Sample the visible normal distribution (Heitz 2018; scattering.h
    Sample_wm). wo local; returns unit half-vectors wm with z >= 0."""
    wh = normalize(torch.stack(
        [alpha * wo[..., 0], alpha * wo[..., 1], wo[..., 2]], dim=-1
    ))
    wh = torch.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    up = torch.zeros_like(wh)
    up[..., 2] = 1.0
    t1_raw = cross(up, wh)
    degenerate = length_squared(t1_raw) < 1e-9
    x_axis = torch.zeros_like(wh)
    x_axis[..., 0] = 1.0
    t1 = torch.where(
        degenerate[..., None],
        x_axis,
        t1_raw / torch.clamp(
            torch.sqrt(length_squared(t1_raw, keepdims=True)), min=1e-12
        ),
    )
    t2 = cross(wh, t1)
    p = sample_uniform_disk_concentric(u2)
    h = safe_sqrt(1.0 - p[..., 0] * p[..., 0])
    py = ((1.0 + wh[..., 2]) * 0.5 * p[..., 1]
          + (1.0 - (1.0 + wh[..., 2]) * 0.5) * h)
    pz = safe_sqrt(1.0 - p[..., 0] ** 2 - py ** 2)
    nh = p[..., 0:1] * t1 + py[..., None] * t2 + pz[..., None] * wh
    wm = torch.stack(
        [alpha * nh[..., 0], alpha * nh[..., 1],
         torch.clamp(nh[..., 2], min=1e-6)],
        dim=-1,
    )
    return normalize(wm)


def ggx_pdf_wm(wo, wm, alpha):
    """Visible-NDF pdf of wm given wo (scattering.h PDF)."""
    return (
        ggx_g1(wo, alpha)
        / torch.clamp(torch.abs(wo[..., 2]), min=1e-8)
        * ggx_d(wm, alpha)
        * torch.abs(torch.sum(wo * wm, dim=-1))
    )


def effectively_smooth(alpha):
    """pbrt's EffectivelySmooth threshold (scattering.h)."""
    return alpha < 1e-3


def roughness_to_alpha(roughness):
    """pbrt-v4 maps user roughness to alpha = sqrt(roughness)
    (materials.cpp RoughnessToAlpha)."""
    return torch.sqrt(torch.clamp(roughness, min=0.0))
