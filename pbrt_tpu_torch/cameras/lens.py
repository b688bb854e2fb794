"""Lens-stack ray tracing through conic and aspheric interfaces (port of
pbrt_tpu/cameras/lens.py; RealisticCamera's TraceLensesFromFilm,
cameras.h:485-604, and the conic/aspheric surfaces of the ISET fork's
OmniCamera and HumanEyeCamera, :607-1086).

A LensStack lists its surfaces film -> scene along +z (film at z = 0).
trace_through_stack advances every ray through one surface at a time, a
Python loop over the E surfaces (the reference's lax.scan), with a
validity mask in place of early exits: a ray clipped by an aperture,
totally internally reflected or missing a surface keeps valid = False and
its last position. Each surface's parameters are read on the host once
(LensStack.host, float32 values), so the per-surface branches (planar or
curved, aperture stop, aspheric) are Python branches and the per-lane
ops take the reference's float32 scalars.

Surface model: conicoid r^2 - 2 R z + (1 + Q) z^2 = 0 (z from the
vertex), R == 0 a plane; optional even-asphere terms sum_i a_i r^(4+2i)
refine the conic hit by Newton steps on the sag. HURB diffraction
(Freniere et al. 1999; diffractHURB, cameras.cpp:2092/2742) deflects
rays at a planar aperture stop by Gaussian angles whose sigmas grow as
the ray passes closer to the stop's edge.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core.floats import atan2
from ..core.tensorclass import static_field, tensorclass
from ..core.vecmath import dot, normalize

_EPS = 1e-9
_F32 = np.float32


@tensorclass
class LensStack:
    """Per-surface arrays, ordered along +z (film at z = 0, scene beyond)."""

    vertex_z: torch.Tensor  # (E,) z of each surface vertex
    radius: torch.Tensor  # (E,) curvature radius (0 = planar)
    conic: torch.Tensor  # (E,) conic constant Q
    aperture2: torch.Tensor  # (E,) squared aperture radius
    eta_after: torch.Tensor  # (E,) IOR of the medium after (z >) the surface
    eta_before: torch.Tensor  # (E,) IOR before the surface
    # Even-asphere coefficients a_i (E, K) on top of the conicoid.
    aspheric: Optional[torch.Tensor] = None
    has_aspheric: bool = static_field(default=False)
    # Host copies of the per-surface values (float32), derived.
    host: tuple = static_field(init=False, default=(), repr=False)

    def __post_init__(self):
        cols = [self.vertex_z, self.radius, self.conic, self.aperture2,
                self.eta_after, self.eta_before]
        vals = [c.detach().cpu().numpy().astype(np.float32) for c in cols]
        asp = (self.aspheric.detach().cpu().numpy().astype(np.float32)
               if self.aspheric is not None else None)
        rows = []
        for i in range(len(vals[0])):
            row = [v[i] for v in vals]
            row.append(tuple(asp[i]) if asp is not None else None)
            rows.append(tuple(row))
        object.__setattr__(self, "host", tuple(rows))

    @staticmethod
    def from_pbrt_elements(rows, eta_scene: float = 1.0, conic=None,
                           aspheric=None) -> "LensStack":
        """rows: pbrt lens-file rows [curvature_radius, thickness, eta,
        aperture_diameter], listed front (scene side) to back (film side),
        thickness the distance to the next surface toward the film
        (RealisticCamera::Create). Returns the stack film -> scene with
        the z positions accumulated."""
        rows = np.asarray(rows, np.float64)
        n = rows.shape[0]
        z = 0.0
        zs = []
        for i in range(n):
            zs.append(z)
            z += rows[i, 1]
        vertex_z = z - np.asarray(zs)  # distance from the film plane
        order = np.argsort(vertex_z)
        # eta per row = IOR of the medium behind the surface (toward the
        # film); walking film -> scene it is the medium before the surface.
        eta_rows = rows[:, 2].copy()
        eta_rows[eta_rows == 0] = 1.0
        eta_before = eta_rows[order]
        eta_after = np.append(eta_before[1:], eta_scene)
        ap = rows[order, 3] / 2.0
        conic_arr = (np.zeros((n,)) if conic is None
                     else np.asarray(conic, np.float64)[order])
        asp = None
        has_asp = False
        if aspheric is not None:
            asp_np = np.asarray(aspheric, np.float64)[order]
            has_asp = bool(np.any(asp_np != 0.0))
            asp = _t(asp_np) if has_asp else None

        return LensStack(vertex_z=_t(vertex_z[order]), radius=_t(rows[order, 0]),
                         conic=_t(conic_arr), aperture2=_t(ap * ap),
                         eta_after=_t(eta_after), eta_before=_t(eta_before),
                         aspheric=asp, has_aspheric=has_asp)

    @staticmethod
    def build(surfaces) -> "LensStack":
        """surfaces: list of dicts (ordered film -> scene) with keys z,
        radius, conic, aperture, eta_before, eta_after."""
        def g(k, d=0.0):
            return np.asarray([s.get(k, d) for s in surfaces], np.float32)

        ap = g("aperture", 1e3)
        return LensStack(vertex_z=_t(g("z")), radius=_t(g("radius")),
                         conic=_t(g("conic")), aperture2=_t(ap * ap),
                         eta_after=_t(g("eta_after", 1.0)),
                         eta_before=_t(g("eta_before", 1.0)))

    @property
    def n_surfaces(self) -> int:
        return self.vertex_z.shape[0]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _intersect_conicoid(o, d, vz, radius, conic):
    """Ray vs the conicoid (or plane, radius 0) with its vertex at z = vz:
    (t, valid). Scalars are float32 host values."""
    oz = o[..., 2] - float(vz)
    dz = d[..., 2]
    if radius == 0.0:
        t = torch.where(torch.abs(dz) > _EPS, -oz / dz, -1.0)
        return t, t > _EPS
    k = float(_F32(1.0) + conic)
    r = float(radius)
    ox, oy = o[..., 0], o[..., 1]
    dx, dy = d[..., 0], d[..., 1]
    a = dx * dx + dy * dy + k * dz * dz
    b = 2.0 * (ox * dx + oy * dy + k * oz * dz - r * dz)
    c = ox * ox + oy * oy + k * oz * oz - 2.0 * r * oz
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    q = torch.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
    a_ok = torch.abs(a) > _EPS
    q_ok = torch.abs(q) > _EPS
    t0 = torch.where(a_ok, q / torch.where(a_ok, a, 1.0), -1.0)
    t1 = torch.where(q_ok, c / torch.where(q_ok, q, 1.0), -1.0)
    tlo = torch.minimum(t0, t1)
    thi = torch.maximum(t0, t1)
    # The nearest forward root on the vertex-side cap (|z_local| <= |R|);
    # the far branch of the conicoid is not lens glass.
    cap = float(_F32(abs(radius)) * _F32(1.0001))

    def root_ok(t):
        return (t > 1e-5) & (torch.abs(oz + t * dz) <= cap)

    t = torch.where(root_ok(tlo), tlo, torch.where(root_ok(thi), thi, -1.0))
    return t, (t > _EPS) & (disc >= 0.0)


def _sag_terms(r2, radius, conic):
    """(s, denom) of the conicoid sag r^2 / (R + sign(R) s)."""
    k = float(_F32(1.0) + conic)
    s = torch.sqrt(torch.clamp(float(_F32(radius) * _F32(radius)) - k * r2,
                               min=1e-12))
    denom = float(radius) + float(np.sign(radius)) * s
    return s, torch.where(torch.abs(denom) > _EPS, denom, 1.0)


def _sag(r2, radius, conic, asp):
    """Surface sag z(r^2): conicoid + even-asphere polynomial terms."""
    _, denom = _sag_terms(r2, radius, conic)
    z = r2 / denom
    pw = r2 * r2
    for a_i in asp:  # sum_i a_i (r^2)^(2+i)
        z = z + float(a_i) * pw
        pw = pw * r2
    return z


def _sag_prime(r2, radius, conic, asp):
    """d sag / d(r^2)."""
    k = float(_F32(1.0) + conic)
    s, denom = _sag_terms(r2, radius, conic)
    dz = ((denom + r2 * float(np.sign(radius)) * k / (2.0 * s))
          / (denom * denom))
    pw = r2
    for i, a_i in enumerate(asp):
        dz = dz + float(_F32(a_i) * _F32(2.0 + i)) * pw
        pw = pw * r2
    return dz


def _refine_aspheric(o, d, t, vz, radius, conic, asp, iters: int = 5):
    """Newton-refine the conic hit against the full (conic + polynomial)
    sag: solve z_ray(t) = sag(r^2(t))."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2] - float(vz)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    for _ in range(iters):
        x = ox + t * dx
        y = oy + t * dy
        r2 = x * x + y * y
        f = oz + t * dz - _sag(r2, radius, conic, asp)
        fp = dz - _sag_prime(r2, radius, conic, asp) * 2.0 * (x * dx + y * dy)
        t = t - f / torch.where(torch.abs(fp) > _EPS, fp, 1.0)
    return t


def _aspheric_normal(p, radius, conic, asp):
    """Gradient of z - sag(r^2): (-sag' 2x, -sag' 2y, 1), oriented -z."""
    r2 = p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]
    sp = _sag_prime(r2, radius, conic, asp)
    n = normalize(torch.stack([-2.0 * sp * p[..., 0], -2.0 * sp * p[..., 1],
                               torch.ones_like(r2)], dim=-1))
    return torch.where((n[..., 2] > 0.0)[..., None], -n, n)


def _conicoid_normal(p, vz, radius, conic):
    """Gradient of the conicoid's implicit function, oriented toward the
    film side (-z); a plane's normal is the axis."""
    if radius == 0.0:
        nz = torch.full_like(p[..., 2], -1.0)
        zero = 0.0
    else:
        k = float(_F32(1.0) + conic)
        nz = 2.0 * k * (p[..., 2] - float(vz)) - 2.0 * float(radius)
        zero = 2.0
    n = normalize(torch.stack([zero * p[..., 0], zero * p[..., 1], nz], dim=-1))
    return torch.where((n[..., 2] > 0.0)[..., None], -n, n)


def _refract(wi, n, eta: np.float32):
    """core/vecmath.py::refract with one relative IOR for every lane:
    (valid, wt)."""
    cos_i = dot(wi, n)
    flip = cos_i < 0.0
    eta_l = torch.where(flip, float(_F32(1.0) / eta), float(eta))
    cos_i = torch.abs(cos_i)
    n = torch.where(flip[..., None], -n, n)
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = sin2_i / (eta_l * eta_l)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wt = -wi / eta_l[..., None] + (cos_i / eta_l - cos_t)[..., None] * n
    return sin2_t < 1.0, wt


def _hurb_deflect(p, d, aperture_r: float, wavelength_mm, noise):
    """Heisenberg-uncertainty ray bending at an aperture stop (diffractHURB,
    cameras.cpp:2092-2167 HumanEye, :2742-2822 Omni): Gaussian deviations
    of the azimuth and elevation in the (S = radial toward the nearest
    edge, L = tangential, U = +z) frame, sigma_i = atan(lambda / (1.41 *
    d_edge_i * 2 pi)). noise: (N, 2) standard normals; lengths in mm."""
    px, py = p[..., 0], p[..., 1]
    dist = torch.sqrt(px * px + py * py)
    safe = torch.clamp(dist, min=1e-8)
    far = dist > 1e-8
    cs = torch.where(far, px / safe, 1.0)
    sn = torch.where(far, py / safe, 0.0)
    d_edge_s = torch.clamp(aperture_r - dist, min=1e-7)
    d_edge_l = torch.sqrt(torch.clamp(float(_F32(aperture_r) * _F32(aperture_r))
                                      - dist * dist, min=1e-14))
    two_pi = 2.0 * math.pi
    sigma_s = torch.atan(wavelength_mm / (1.41 * d_edge_s * two_pi))
    sigma_l = torch.atan(wavelength_mm / (1.41 * d_edge_l * two_pi))
    proj_s = d[..., 0] * cs + d[..., 1] * sn
    proj_l = -d[..., 0] * sn + d[..., 1] * cs
    proj_u = d[..., 2]
    theta_a = atan2(proj_s, proj_u) + noise[..., 0] * sigma_s
    theta_e = (atan2(proj_l, torch.sqrt(proj_s * proj_s + proj_u * proj_u))
               + noise[..., 1] * sigma_l)
    new_l = torch.sin(theta_e)
    new_su = torch.cos(theta_e)
    new_s = new_su * torch.sin(theta_a)
    new_u = new_su * torch.cos(theta_a)
    return normalize(torch.stack([new_s * cs - new_l * sn,
                                  new_s * sn + new_l * cs, new_u], dim=-1))


def trace_through_stack(stack: LensStack, o, d, eta_start=1.0,
                        hurb_noise=None, wavelength_nm=550.0):
    """Trace rays (film side, travelling +z) through every surface.

    o, d: (N, 3). Returns (o_out, d_out, valid). hurb_noise: optional
    (N, 2) standard normals enabling HURB diffraction at the planar
    aperture stops; wavelength_nm is a scalar or a per-ray (N,) tensor.
    eta_start is taken and, as in the reference, not read: each surface
    carries the indices on both its sides."""
    if isinstance(wavelength_nm, torch.Tensor):
        wl_mm = wavelength_nm.to(torch.float32) * 1e-6
    else:
        wl_mm = float(_F32(wavelength_nm) * _F32(1e-6))
    valid = torch.ones(o.shape[:-1], dtype=torch.bool, device=o.device)
    for vz, radius, conic, ap2, eta_a, eta_b, asp in stack.host:
        t, ok = _intersect_conicoid(o, d, vz, radius, conic)
        aspheric = (asp is not None and float(np.abs(np.asarray(asp)).sum()) > 0.0
                    and radius != 0.0)
        if aspheric:
            t = _refine_aspheric(o, d, t, vz, radius, conic, asp)
        p = o + t[..., None] * d
        r2 = p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]
        ok = ok & (r2 <= float(ap2))
        if radius == 0.0 and eta_b == eta_a:  # aperture stop: no refraction
            new_d = d
            if hurb_noise is not None:
                new_d = _hurb_deflect(p, d, float(np.sqrt(ap2)), wl_mm,
                                      hurb_noise)
            new_valid = valid & ok
        else:
            nrm = (_aspheric_normal(p, radius, conic, asp) if aspheric
                   else _conicoid_normal(p, vz, radius, conic))
            v_ok, new_d = _refract(-d, nrm, _F32(eta_a) / _F32(eta_b))
            new_valid = valid & ok & v_ok
        o = torch.where(new_valid[..., None], p, o)
        d = torch.where(new_valid[..., None], normalize(new_d), d)
        valid = new_valid
    return o, d, valid


def load_lens_file(path: str, eta_scene: float = 1.0) -> LensStack:
    """Parse a pbrt .dat lens description: whitespace-separated rows
    `curvature_radius thickness eta aperture_diameter`, front (scene side)
    first, '#' comments; mm; eta 0 = air; radius 0 = the aperture stop
    (RealisticCamera::Create)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) != 4:
                raise ValueError(f"bad lens row: {line!r}")
            rows.append(vals)
    if not rows:
        raise ValueError(f"empty lens file: {path}")
    return LensStack.from_pbrt_elements(np.asarray(rows, np.float64),
                                        eta_scene=eta_scene)

