"""Vector geometry on batched (..., 3) tensors (port of core/vecmath.py,
the pieces the path integrator, the lights and the dielectric BxDFs use).

Frame conventions match the reference exactly (branchless Duff et al.
basis with the same signs), so sampled directions agree lane for lane.
"""

from __future__ import annotations

import math

import torch

from . import floats


def dot(a, b, keepdims: bool = False):
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length_squared(v, keepdims: bool = False):
    return torch.sum(v * v, dim=-1, keepdim=keepdims)


def normalize(v, eps: float = 1e-20):
    return v * torch.rsqrt(torch.clamp(length_squared(v, keepdims=True), min=eps))


def coordinate_system(v):
    """Branchless orthonormal basis from a unit vector (Duff et al. 2017).

    Returns (t1, t2) with (t1, t2, v) an orthonormal right-handed frame.
    """
    z = v[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = v[..., 0] * v[..., 1] * a
    t1 = torch.stack(
        [1.0 + sign * v[..., 0] * v[..., 0] * a, sign * b, -sign * v[..., 0]],
        dim=-1,
    )
    t2 = torch.stack([b, sign + v[..., 1] * v[..., 1] * a, -v[..., 1]], dim=-1)
    return t1, t2


def shading_frame(ns, dpdu):
    """Shading-frame tangents (t1, t2) for normal ns and optional tangent.

    Where dpdu is nonzero the frame is anchored to it (t1 = dpdu
    orthogonalized against ns); elsewhere the branchless Duff basis.
    """
    t1d, t2d = coordinate_system(ns)
    has_t = torch.sum(dpdu * dpdu, dim=-1, keepdim=True) > 1e-12
    tang = dpdu - dot(dpdu, ns, keepdims=True) * ns
    norm = torch.sqrt(
        torch.clamp(torch.sum(tang * tang, dim=-1, keepdim=True), min=1e-24)
    )
    t1c = tang / norm
    t1 = torch.where(has_t, t1c, t1d)
    t2 = torch.where(has_t, cross(ns, t1c), t2d)
    return t1, t2


def to_local(v, t1, t2, n):
    """World -> shading-local (z = n) coordinates."""
    return torch.stack([dot(v, t1), dot(v, t2), dot(v, n)], dim=-1)


def from_local(v, t1, t2, n):
    """Shading-local -> world coordinates."""
    return v[..., 0:1] * t1 + v[..., 1:2] * t2 + v[..., 2:3] * n


def safe_sqrt(x):
    """sqrt(max(x, 0)). Under a gradient its gradient is 0 where x <= 0
    (the clamped sqrt's is 0 * inf = NaN there, which would reach an
    attached estimator's gradient through lanes that a where drops)."""
    if not floats.grad_flows(x):
        return torch.sqrt(torch.clamp(x, min=0.0))
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


_safe_sqrt = safe_sqrt


def refract(wi, n, eta):
    """Refract wi through the interface with normal n (pbrt's Refract,
    util/scattering.h): eta is the relative IOR of the non-normal side over
    the normal side; a wi below n flips both n and eta. eta broadcasts to
    wi[..., 0].

    Returns (valid, wt, eta_eff): valid is False under total internal
    reflection; eta_eff is the relative IOR actually used.
    """
    cos_theta_i = dot(wi, n)
    flip = cos_theta_i < 0.0
    eta = torch.where(flip, 1.0 / eta, eta)
    cos_theta_i = torch.abs(cos_theta_i)
    n = torch.where(flip[..., None], -n, n)
    sin2_theta_i = torch.clamp(1.0 - cos_theta_i * cos_theta_i, min=0.0)
    sin2_theta_t = sin2_theta_i / (eta * eta)
    valid = sin2_theta_t < 1.0
    cos_theta_t = _safe_sqrt(1.0 - sin2_theta_t)
    wt = (-wi / eta[..., None]
          + (cos_theta_i / eta - cos_theta_t)[..., None] * n)
    return valid, wt, eta


def equal_area_square_to_sphere(p):
    """Low-distortion [0,1]^2 -> unit sphere map (Clarberg 2008;
    vecmath.h EqualAreaSquareToSphere), the octahedral layout of
    environment maps and goniometric images."""
    u = 2.0 * p[..., 0] - 1.0
    v = 2.0 * p[..., 1] - 1.0
    up = torch.abs(u)
    vp = torch.abs(v)
    sd = 1.0 - (up + vp)
    d = torch.abs(sd)
    r = 1.0 - d
    phi = torch.where(
        r == 0.0, 1.0, (vp - up) / torch.where(r == 0.0, 1.0, r) + 1.0
    ) * (math.pi / 4.0)
    z = torch.sign(sd) * (1.0 - r * r)
    cos_phi = torch.sign(u) * torch.cos(phi)
    sin_phi = torch.sign(v) * torch.sin(phi)
    s = r * _safe_sqrt(2.0 - r * r)
    return torch.stack([cos_phi * s, sin_phi * s, z], dim=-1)


def equal_area_sphere_to_square(d):
    """Inverse of equal_area_square_to_sphere."""
    x = torch.abs(d[..., 0])
    y = torch.abs(d[..., 1])
    z = torch.abs(d[..., 2])
    r = _safe_sqrt(1.0 - z)
    a = torch.maximum(x, y)
    b = torch.minimum(x, y)
    b = torch.where(a == 0.0, 0.0, b / torch.where(a == 0.0, 1.0, a))
    phi = torch.atan(b) * (2.0 / math.pi)  # atan on [0, 1] -> [0, 1/2]
    phi = torch.where(x < y, 1.0 - phi, phi)
    v_ = phi * r
    u_ = r - v_
    # The southern hemisphere folds over the square's corners.
    south = d[..., 2] < 0.0
    u2 = torch.where(south, 1.0 - v_, u_)
    v2 = torch.where(south, 1.0 - u_, v_)
    # +0 counts as positive (sign(0) == 0 would collapse the -z pole onto
    # the +z centre).
    u2 = torch.where(d[..., 0] >= 0.0, u2, -u2)
    v2 = torch.where(d[..., 1] >= 0.0, v2, -v2)
    return torch.stack([0.5 * (u2 + 1.0), 0.5 * (v2 + 1.0)], dim=-1)
