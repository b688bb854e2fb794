"""Separable BSSRDF with the Burley normalized-diffusion profile (port of
pbrt_tpu/materials/bssrdf.py).

pbrt-v4 tabulates a photon-beam-diffusion profile (bssrdf.h
TabulatedBSSRDF) and inverts it by table search; the reference replaces
the tables by Christensen and Burley's closed-form normalized-diffusion
profile ("Approximate Reflectance Profiles for Efficient Subsurface
Scattering", Pixar memo 15-04), inverted by Newton steps: no table.

- burley_d: the per-wavelength shaping distance from (albedo, mean free
  path).
- The profile Sp(r), its polar pdf and cdf, and the radius sampler.
- fresnel_moment1: the d'Eon / Irving polynomial of the Sw normalization.
- subsurface_exit: the probe. It samples a disk offset in the tangent
  frame, probes along -n with one closest-hit query of a per-ray tmax
  (accel/api.py: K1, or K2 above 1024 triangles, on the card) and moves
  the path vertex to the exit it finds, with the spectral profile over
  its pdf as the weight (one probe axis; pbrt-v4 combines three by MIS).
"""

from __future__ import annotations

import math

import torch

from ..accel import api as accel_api
from ..core.vecmath import normalize


def burley_d(albedo, mfp):
    """Shaping distance d per wavelength from the albedo and the mean free
    path (Burley's fit of the scaling that keeps the diffuse
    reflectance)."""
    a = torch.abs(albedo - 0.8)
    s = 1.85 - albedo + 7.0 * (a * (a * a))
    return torch.clamp(mfp, min=1e-6) / torch.clamp(s, min=1e-4)


def burley_profile(r, d):
    """Sp(r): radially symmetric, integrates (2 pi r dr over the plane) to
    1; the albedo multiplies outside."""
    r = torch.clamp(r, min=1e-6)
    return (torch.exp(-r / d) + torch.exp(-r / (3.0 * d))) / (8.0 * math.pi * d * r)


def burley_cdf(r, d):
    """cdf of the polar-measure profile: 1 - e^-x / 4 - 3 e^(-x/3) / 4."""
    x = r / d
    return 1.0 - 0.25 * torch.exp(-x) - 0.75 * torch.exp(-x / 3.0)


def burley_pdf_r(r, d):
    """Polar pdf p(r) = Sp(r) 2 pi r (integrates to 1 over r)."""
    return burley_profile(r, d) * 2.0 * math.pi * torch.clamp(r, min=1e-6)


def burley_sample_r(u, d, iters: int = 10):
    """Invert the cdf by damped Newton steps (elementwise)."""
    u = torch.clamp(u, 1e-5, 1.0 - 1e-5)
    x = torch.ones_like(u)  # the first guess, in units of d
    for _ in range(iters):
        f = 1.0 - 0.25 * torch.exp(-x) - 0.75 * torch.exp(-x / 3.0) - u
        fp = 0.25 * torch.exp(-x) + 0.25 * torch.exp(-x / 3.0)
        x = torch.clamp(x - f / torch.clamp(fp, min=1e-6), 1e-4, 60.0)
    return x * d


def fresnel_moment1(eta):
    """First moment of the Fresnel reflectance (the d'Eon and Irving
    polynomial fit of pbrt-v4's FresnelMoment1)."""
    e2 = eta * eta
    e3 = e2 * eta
    e4 = e3 * eta
    e5 = e4 * eta
    lo = (0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
          + 2.49277 * e4 - 0.68441 * e5)
    hi = (-4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
          - 1.27198 * e4 + 0.12746 * e5)
    return torch.where(eta < 1.0, lo, hi)


def subsurface_exit(scene, isect, ns, t1, t2, albedo, mfp_hero, u_r, u_phi,
                    r_max_factor: float = 8.0):
    """Move subsurface entry vertices to sampled exit points.

    isect: the entry interactions; ns, t1, t2: their shading frame;
    albedo: (N, S) spectral single-scattering albedo; mfp_hero: (N,) the
    hero mean free path that drives the radius; u_r, u_phi: (N,) uniforms.
    Every lane issues the probe; the caller masks the result.

    Returns (p_exit, n_exit, weight (N, S), ok). The weight is the full
    spectral profile over the hero radius's pdf, clamped to 20; a probe
    that finds no surface of the same material leaves the vertex at the
    entry with weight 1 (ok False).
    """
    d_hero = burley_d(torch.mean(albedo, dim=-1), mfp_hero)
    r = burley_sample_r(u_r, d_hero)
    r_cap = r_max_factor * d_hero
    r = torch.minimum(r, r_cap)
    phi = 2.0 * math.pi * u_phi
    # The probe chord is perpendicular to the surface (one axis, ns).
    h = torch.sqrt(torch.clamp(r_cap * r_cap - r * r, min=1e-8))
    offset = r[..., None] * (torch.cos(phi)[..., None] * t1
                             + torch.sin(phi)[..., None] * t2)
    o_probe = isect.p + offset + ns * h[..., None]
    probe = accel_api.closest(scene, o_probe, -ns,
                              tmax=torch.full_like(r, 2.0) * h)
    same_mat = probe.valid & (probe.mat == isect.mat)

    p_exit = torch.where(same_mat[..., None], probe.p, isect.p)
    n_exit = torch.where(same_mat[..., None], probe.n, isect.n)
    # The exit's radius in the entry's tangent plane.
    dp = p_exit - isect.p
    r_exit = torch.sqrt(torch.clamp(
        torch.sum(dp * dp, -1) - torch.sum(dp * ns, -1) ** 2, min=1e-12))
    r_exit = torch.maximum(r_exit, 1e-4 * d_hero)

    # Spectral weight: albedo Sp(r_exit) per wavelength over the hero
    # radius's polar pdf turned into the area measure at the exit.
    d_spec = burley_d(albedo, mfp_hero[..., None])
    sp = albedo * burley_profile(r_exit[..., None], d_spec)
    cos_probe = torch.abs(torch.sum(
        normalize(torch.where(same_mat[..., None], probe.n, ns)) * ns, -1))
    pdf_area = (burley_pdf_r(r_exit, d_hero) / (2.0 * math.pi * r_exit)
                * torch.clamp(cos_probe, min=0.1))
    w = torch.where(same_mat[..., None],
                    sp / torch.clamp(pdf_area, min=1e-12)[..., None], 1.0)
    # Grazing probes through thin geometry can spike the estimator.
    w = torch.clamp(w, max=20.0)
    return p_exit, n_exit, w, same_mat
