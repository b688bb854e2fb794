"""Vector geometry on batched (..., 3) tensors (port of core/vecmath.py:
frames, the small vector helpers, reflection and refraction, the
octahedral and equal-area maps, and DirectionCone with its bounds).

Frame conventions match the reference exactly (branchless Duff et al.
basis with the same signs), so sampled directions agree lane for lane.
"""

from __future__ import annotations

import math

import torch

from . import floats
from .tensorclass import tensorclass

# A conservative machine epsilon for pbrt's gamma(n) FP error bound
# (float.h gamma).
MACHINE_EPS = floats.MACHINE_EPSILON


def gamma(n: int) -> float:
    return (n * MACHINE_EPS) / (1 - n * MACHINE_EPS)


def dot(a, b, keepdims: bool = False):
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def absdot(a, b, keepdims: bool = False):
    return torch.abs(dot(a, b, keepdims=keepdims))


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length_squared(v, keepdims: bool = False):
    return torch.sum(v * v, dim=-1, keepdim=keepdims)


def length(v, keepdims: bool = False):
    return torch.sqrt(length_squared(v, keepdims=keepdims))


def normalize(v, eps: float = 1e-20):
    return v * torch.rsqrt(torch.clamp(length_squared(v, keepdims=True), min=eps))


def distance(a, b):
    return length(a - b)


def lerp(t, a, b):
    return (1.0 - t) * a + t * b


def safe_acos(x):
    return torch.acos(torch.clamp(x, -1.0, 1.0))


def face_forward(n, v):
    """Flip n into the hemisphere of v."""
    s = torch.sign(dot(n, v, keepdims=True))
    return n * torch.where(s == 0, 1.0, s)


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


def spherical_direction(sin_theta, cos_theta, phi):
    st = torch.clamp(sin_theta, -1.0, 1.0)
    return torch.stack(
        [st * torch.cos(phi), st * torch.sin(phi),
         torch.clamp(cos_theta, -1.0, 1.0)], dim=-1)


def spherical_theta(v):
    return safe_acos(v[..., 2])


def spherical_phi(v):
    p = floats.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0.0, p + 2.0 * math.pi, p)


def reflect(wo, n):
    """Mirror reflection of wo about n (both pointing away from the
    surface)."""
    return -wo + 2.0 * dot(wo, n, keepdims=True) * n


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


def _sign_of(x):
    return torch.where(x >= 0, 1.0, -1.0)


def octahedral_encode(v):
    """Unit vector -> octahedral coordinates in [-1, 1]^2 (vecmath.h
    OctahedralVector, kept in float32 rather than 16-bit)."""
    d = torch.sum(torch.abs(v), dim=-1, keepdim=True)
    p = v[..., :2] / d
    x, y = p[..., 0], p[..., 1]
    neg = v[..., 2] < 0.0
    xo = torch.where(neg, (1.0 - torch.abs(y)) * _sign_of(x), x)
    yo = torch.where(neg, (1.0 - torch.abs(x)) * _sign_of(y), y)
    return torch.stack([xo, yo], dim=-1)


def octahedral_decode(e):
    """Inverse of octahedral_encode."""
    x, y = e[..., 0], e[..., 1]
    z = 1.0 - torch.abs(x) - torch.abs(y)
    neg = z < 0.0
    xd = torch.where(neg, (1.0 - torch.abs(y)) * _sign_of(x), x)
    yd = torch.where(neg, (1.0 - torch.abs(x)) * _sign_of(y), y)
    return normalize(torch.stack([xd, yd, z], dim=-1))


@tensorclass
class DirectionCone:
    """Cone of directions: axis w and the cosine of its half-angle
    (vecmath.h DirectionCone). cos_theta = 1 is one direction, -1 the whole
    sphere; an empty cone has cos_theta = 2, so a union with it returns
    the other cone."""

    w: torch.Tensor  # (..., 3) unit axis
    cos_theta: torch.Tensor  # (...,)

    @staticmethod
    def entire_sphere(device="cpu") -> "DirectionCone":
        return DirectionCone(
            w=torch.tensor([0.0, 0.0, 1.0], device=device),
            cos_theta=torch.tensor(-1.0, device=device),
        )

    @staticmethod
    def from_direction(w) -> "DirectionCone":
        w = torch.as_tensor(w, dtype=torch.float32)
        return DirectionCone(w=w, cos_theta=w.new_ones(w.shape[:-1]))

    @property
    def is_empty(self):
        return self.cos_theta > 1.0

    def inside(self, v):
        """Whether direction v lies in the cone (vecmath.h Inside)."""
        return (~self.is_empty) & (
            torch.sum(normalize(v) * self.w, dim=-1) >= self.cos_theta)


def bound_subtended_directions(lo, hi, p):
    """DirectionCone of the directions from p toward the box [lo, hi]
    (vecmath.h BoundSubtendedDirections): the cone about the direction to
    the centre that holds the bounding sphere; the whole sphere when p is
    inside that sphere."""
    lo, hi = torch.as_tensor(lo), torch.as_tensor(hi)
    center = 0.5 * (lo + hi)
    radius = 0.5 * torch.sqrt(torch.sum((hi - lo) ** 2, dim=-1))
    to_c = center - p
    d2 = torch.sum(to_c * to_c, dim=-1)
    inside_sphere = d2 < radius * radius
    sin2 = torch.clamp(radius * radius / torch.clamp(d2, min=1e-12), 0.0, 1.0)
    cos_theta = torch.sqrt(1.0 - sin2)
    w = to_c / torch.clamp(torch.sqrt(d2), min=1e-12)[..., None]
    z_axis = torch.zeros_like(w)
    z_axis[..., 2] = 1.0
    return DirectionCone(
        w=torch.where(inside_sphere[..., None], z_axis, w),
        cos_theta=torch.where(inside_sphere, -1.0, cos_theta),
    )


def direction_cone_union(a: DirectionCone, b: DirectionCone) -> DirectionCone:
    """Smallest cone holding both (vecmath.h Union), branch-free: either
    cone empty, either inside the other, and the merged cone are all
    computed and selected per lane."""
    ta = torch.acos(torch.clamp(a.cos_theta, -1.0, 1.0))
    tb = torch.acos(torch.clamp(b.cos_theta, -1.0, 1.0))
    td = torch.acos(torch.clamp(torch.sum(a.w * b.w, dim=-1), -1.0, 1.0))
    b_in_a = torch.clamp(td + tb, max=math.pi) <= ta
    a_in_b = torch.clamp(td + ta, max=math.pi) <= tb
    # The merged cone: its spread about the rotated axis.
    theta_o = 0.5 * (ta + td + tb)
    whole = theta_o >= math.pi
    theta_r = torch.clamp(theta_o - ta, 0.0, math.pi)
    # a.w rotated toward b.w by theta_r (Rodrigues).
    axis = cross(a.w, b.w)
    alen = torch.sqrt(torch.sum(axis * axis, dim=-1))
    degenerate = alen < 1e-8
    axis_n = axis / torch.clamp(alen, min=1e-12)[..., None]
    c = torch.cos(theta_r)[..., None]
    s = torch.sin(theta_r)[..., None]
    w_rot = (a.w * c + cross(axis_n, a.w) * s
             + axis_n * torch.sum(axis_n * a.w, -1, keepdim=True) * (1.0 - c))
    w_gen = torch.where(degenerate[..., None], a.w, w_rot)
    cos_gen = torch.where(whole, -1.0, torch.cos(theta_o))

    def pick(x_a, x_b, x_gen, lift):
        return torch.where(
            lift(a.is_empty), x_b, torch.where(
                lift(b.is_empty), x_a, torch.where(
                    lift(b_in_a), x_a, torch.where(lift(a_in_b), x_b, x_gen))))

    return DirectionCone(
        w=pick(a.w, b.w, w_gen, lambda m: m[..., None]),
        cos_theta=pick(a.cos_theta, b.cos_theta, cos_gen, lambda m: m),
    )
