"""Henyey-Greenstein phase function (port of pbrt_tpu/media/phase.py).

Directions are world-space; wo points back along the arriving ray (pbrt's
p(wo, wi) with both directions away from the collision point). g is a
Python float or a tensor broadcast against the rays.
"""

from __future__ import annotations

import math

import torch

from ..core.vecmath import coordinate_system, dot, from_local, normalize

INV_4PI = 1.0 / (4.0 * math.pi)


def _g(g, like):
    return torch.clamp(torch.as_tensor(g, dtype=torch.float32,
                                       device=like.device), -0.99, 0.99)


def hg_p(cos_theta, g):
    """HG density over solid angle; cos_theta = dot(wo, wi)."""
    g = _g(g, cos_theta)
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / torch.clamp(
        denom * torch.sqrt(torch.clamp(denom, min=1e-12)), min=1e-12)


def hg_pdf(wo, wi, g):
    return hg_p(dot(wo, wi), g)


def hg_sample(wo, u2, g):
    """Sample wi with pdf = hg_p(dot(wo, wi)). Returns (wi, pdf).

    cos_theta is measured against +wo, so for g > 0 the density peaks at
    wi = -wo, the ray continuing forward (HGPhaseFunction::Sample_p).
    |g| < 1e-3 samples the sphere uniformly.
    """
    g = _g(g, wo)
    u0, u1 = u2[..., 0], u2[..., 1]
    iso = torch.abs(g) < 1e-3
    g_safe = torch.where(iso, 1e-3, g)
    sqr = (1.0 - g_safe * g_safe) / (1.0 + g_safe - 2.0 * g_safe * u0)
    cos_hg = -(1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe)
    cos_iso = 1.0 - 2.0 * u0
    cos_theta = torch.clamp(torch.where(iso, cos_iso, cos_hg), -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * math.pi * u1
    # Frame around +wo: wi with dot(wi, wo) = cos_theta.
    axis = normalize(wo)
    t1, t2 = coordinate_system(axis)
    local = torch.stack([sin_theta * torch.cos(phi),
                         sin_theta * torch.sin(phi), cos_theta], dim=-1)
    wi = from_local(local, t1, t2, axis)
    return wi, hg_p(dot(wo, wi), g)
