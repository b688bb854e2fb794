"""Vector geometry on batched (..., 3) tensors (port of core/vecmath.py,
the pieces the path integrator uses).

Frame conventions match the reference exactly (branchless Duff et al.
basis with the same signs), so sampled directions agree lane for lane.
"""

from __future__ import annotations

import torch


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
