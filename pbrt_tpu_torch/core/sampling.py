"""Sampling warps the path integrator uses (port of core/sampling.py)."""

from __future__ import annotations

import math

import torch

INV_PI = 1.0 / math.pi


def sample_uniform_disk_concentric(u):
    """Shirley-Chiu concentric map: [0,1]^2 -> unit disk. u: (..., 2)."""
    uo = 2.0 * u - 1.0
    x, y = uo[..., 0], uo[..., 1]
    zero = (x == 0.0) & (y == 0.0)
    use_x = torch.abs(x) > torch.abs(y)
    r = torch.where(use_x, x, y)
    safe = torch.where(r == 0.0, 1.0, r)
    theta = torch.where(
        use_x,
        (math.pi / 4.0) * (y / safe),
        (math.pi / 2.0) - (math.pi / 4.0) * (x / safe),
    )
    p = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    return torch.where(zero[..., None], 0.0, p)


def sample_cosine_hemisphere(u):
    d = sample_uniform_disk_concentric(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    return torch.cat([d, z[..., None]], dim=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def sample_uniform_triangle(u):
    """Low-distortion triangle warp returning barycentrics (b0, b1, b2)
    (the sqrt-free fold: split the square along the diagonal)."""
    u0, u1 = u[..., 0], u[..., 1]
    flip = u0 < u1
    b0 = torch.where(flip, u0 / 2.0, u0 - u1 / 2.0)
    b1 = torch.where(flip, u1 - b0, u1 / 2.0)
    return torch.stack([b0, b1, 1.0 - b0 - b1], dim=-1)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """Veach's beta=2 power heuristic (sampling.h PowerHeuristic)."""
    f = nf * f_pdf
    g = ng * g_pdf
    w = f * f / torch.clamp(f * f + g * g, min=1e-38)
    return torch.where(f_pdf > 0.0, w, 0.0)
