"""Participating media (port of pbrt_tpu/media/medium.py).

One scene-level medium occupies a world AABB (vacuum outside), of a
static `kind`: homogeneous, a density grid (`grid`, trilinear over
voxel centres), a per-voxel RGB grid (`rgbgrid`) or the procedural cloud.
Grid media carry a coarse majorant grid for the DDA walk (MajorantGrid,
DDAMajorantIterator). Shape-bounded homogeneous interior media live in a
MediumStack addressed by a per-ray index.

Every table is built on the host, bit-equal to the reference's: the
spectrum fits (core/rgb2spec.py, its float32 numpy solve), the majorant
grid's max-pool and dilation, the global density maximum and the rgbgrid's
wavelength-max majorant over the reference's 32-wavelength grid
(`_RGBGRID_LAMBDA`, evaluated in numpy as the reference's eager XLA ops
round it). Lookups are tensor arithmetic on the rays' device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import cie, rgb2spec
from ..core.take import take
from ..core.tensorclass import static_field, tensorclass

MEDIUM_NONE = "none"
MEDIUM_HOMOGENEOUS = "homogeneous"
MEDIUM_GRID = "grid"
MEDIUM_RGBGRID = "rgbgrid"
MEDIUM_CLOUD = "cloud"

# med_inside / med_outside sentinels of a material row.
MED_KEEP = -2  # no interface on this surface: crossing keeps the medium
MED_VACUUM = -1

# The reference's eager jnp.linspace(360, 830, 32) in float32, value for
# value: it rounds 6 of the 32 entries otherwise than numpy's or torch's
# linspace, and the rgbgrid majorant is the max over these wavelengths.
_RGBGRID_LAMBDA = np.asarray([
    360.0, 375.16132, 390.32257, 405.48386, 420.64517, 435.80646, 450.9677,
    466.129, 481.2903, 496.45163, 511.6129, 526.7742, 541.9355, 557.0968,
    572.25806, 587.4193, 602.5806, 617.74194, 632.9032, 648.0645, 663.2258,
    678.3871, 693.5484, 708.70966, 723.871, 739.0322, 754.19354, 769.3548,
    784.5161, 799.6774, 814.8387, 830.0], np.float32)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def _eval_unbounded_np(coeffs, scale, lam):
    """rgb2spec.eval_unbounded in float32 numpy, op for op as the
    reference's XLA evaluates it on the host (plain division, no fused
    multiply-add)."""
    f32 = np.float32
    x = (lam - f32(cie.LAMBDA_MIN)) / f32(cie.LAMBDA_MAX - cie.LAMBDA_MIN)
    z = (coeffs[..., 0:1] * x + coeffs[..., 1:2]) * x + coeffs[..., 2:3]
    return scale[..., None] * (f32(0.5) + f32(0.5) * z / np.sqrt(f32(1) + z * z))


@tensorclass
class MediumStack:
    """Named homogeneous interior media addressed by a per-ray index.

    Each shape bounded by a MediumInterface can carry an interior medium;
    rays switch medium on transmission (the integrator carries an (N,)
    index, -1 for vacuum). The segment inside a medium always ends at the
    next surface hit, so free flight is sampled in closed form.
    """

    sigma_a_coeffs: torch.Tensor  # (M, 3)
    sigma_a_scale: torch.Tensor  # (M,)
    sigma_s_coeffs: torch.Tensor  # (M, 3)
    sigma_s_scale: torch.Tensor  # (M,)
    g: torch.Tensor  # (M,) HG asymmetry

    @staticmethod
    def build(specs) -> "MediumStack":
        """specs: list of dicts {sigma_a, sigma_s (rgb), g, scale}."""
        sa = np.asarray([np.asarray(s.get("sigma_a", (1, 1, 1)), np.float32)
                         * s.get("scale", 1.0) for s in specs], np.float32)
        ss = np.asarray([np.asarray(s.get("sigma_s", (1, 1, 1)), np.float32)
                         * s.get("scale", 1.0) for s in specs], np.float32)
        sa_c, sa_s = rgb2spec.fit_unbounded(sa)
        ss_c, ss_s = rgb2spec.fit_unbounded(ss)
        return MediumStack(
            sigma_a_coeffs=sa_c, sigma_a_scale=sa_s,
            sigma_s_coeffs=ss_c, sigma_s_scale=ss_s,
            g=_f32([s.get("g", 0.0) for s in specs]),
        )

    @property
    def n_media(self) -> int:
        return self.g.shape[0]

    def sigma_at_idx(self, idx, lam):
        """(sigma_a, sigma_s) spectra (N, S) for per-ray medium index idx;
        zero where idx < 0 (vacuum or no medium)."""
        safe = torch.clamp(idx, 0, self.n_media - 1).long()
        inside = (idx >= 0)[..., None]
        sa = rgb2spec.eval_unbounded(take(self.sigma_a_coeffs, safe),
                                     take(self.sigma_a_scale, safe), lam)
        ss = rgb2spec.eval_unbounded(take(self.sigma_s_coeffs, safe),
                                     take(self.sigma_s_scale, safe), lam)
        return torch.where(inside, sa, 0.0), torch.where(inside, ss, 0.0)

    def g_at(self, idx):
        safe = torch.clamp(idx, 0, self.n_media - 1).long()
        return torch.where(idx >= 0, take(self.g, safe), 0.0)


def _pool_dilate_max(vox, m):
    """Max-pool a (nz, ny, nx) voxel field onto m^3 cells plus a 1-cell
    dilation (conservative for trilinear lookups near borders;
    MajorantGrid, media.h:105). The reference's numpy, unchanged."""
    vox = np.asarray(vox, np.float32)

    def _ceil_pad(d):
        pads = [(-s) % m for s in d.shape]
        return np.pad(d, [(0, p) for p in pads], mode="edge")

    dp = _ceil_pad(vox)
    z, y, x = dp.shape
    maj = dp.reshape(m, z // m, m, y // m, m, x // m).max(axis=(1, 3, 5))
    padded = np.pad(maj, 1, mode="edge")
    return np.maximum.reduce(
        [
            padded[dz : dz + m, dy : dy + m, dx : dx + m]
            for dz in (0, 1, 2)
            for dy in (0, 1, 2)
            for dx in (0, 1, 2)
        ]
    )


def _rgbgrid_placeholder():
    return dict(
        sa_grid_coeffs=torch.zeros((1, 1, 1, 3)),
        sa_grid_scale=torch.zeros((1, 1, 1)),
        ss_grid_coeffs=torch.zeros((1, 1, 1, 3)),
        ss_grid_scale=torch.zeros((1, 1, 1)),
    )


def _fit_scaled(rgb, scale):
    """(coeffs (3,), scale ()) of one RGB times scale, as the reference
    fits it."""
    c, s = rgb2spec.fit_unbounded(np.asarray(rgb, np.float32) * scale)
    return c, s.reshape(())


@tensorclass
class MediumBuffers:
    # Spectral scattering parameters (sigmoid fits x scale).
    sigma_a_coeffs: torch.Tensor  # (3,)
    sigma_a_scale: torch.Tensor  # ()
    sigma_s_coeffs: torch.Tensor  # (3,)
    sigma_s_scale: torch.Tensor  # ()
    g: torch.Tensor  # () HG asymmetry
    # Emission of grid media: Le_scale x fit where the density is > 0.
    le_coeffs: torch.Tensor  # (3,)
    le_scale: torch.Tensor  # ()
    bounds_lo: torch.Tensor  # (3,) world AABB of the medium
    bounds_hi: torch.Tensor  # (3,)
    # Density grid (kind grid), (nz, ny, nx), unit-scaled.
    density: torch.Tensor
    # Coarse majorant grid (mz, my, mx) of density maxima; for rgbgrid
    # media in sigma units (wavelength-max sigma_t).
    maj_grid: torch.Tensor
    # Per-voxel RGBUnboundedSpectrum fits of rgbgrid media.
    sa_grid_coeffs: torch.Tensor  # (gz, gy, gx, 3)
    sa_grid_scale: torch.Tensor  # (gz, gy, gx)
    ss_grid_coeffs: torch.Tensor
    ss_grid_scale: torch.Tensor
    # Global density maximum: the global majorant is sigma_t_max x this.
    max_density: torch.Tensor
    # Procedural cloud [density, wispiness, frequency] (kind cloud).
    cloud_params: Optional[torch.Tensor] = None
    kind: str = static_field(default=MEDIUM_NONE)

    @staticmethod
    def none() -> "MediumBuffers":
        z3, z = torch.zeros((3,)), torch.zeros(())
        one = torch.ones((1, 1, 1))
        return MediumBuffers(
            sigma_a_coeffs=z3, sigma_a_scale=z, sigma_s_coeffs=z3.clone(),
            sigma_s_scale=z.clone(), g=z.clone(), le_coeffs=z3.clone(),
            le_scale=z.clone(), bounds_lo=z3.clone(), bounds_hi=z3.clone(),
            density=one, maj_grid=one.clone(), **_rgbgrid_placeholder(),
            max_density=torch.ones(()), kind=MEDIUM_NONE,
        )

    @staticmethod
    def homogeneous(sigma_a_rgb, sigma_s_rgb, bounds_lo, bounds_hi, g=0.0,
                    scale=1.0) -> "MediumBuffers":
        sa_c, sa_s = _fit_scaled(sigma_a_rgb, scale)
        ss_c, ss_s = _fit_scaled(sigma_s_rgb, scale)
        one = torch.ones((1, 1, 1))
        return MediumBuffers(
            sigma_a_coeffs=sa_c, sigma_a_scale=sa_s,
            sigma_s_coeffs=ss_c, sigma_s_scale=ss_s, g=_f32(g),
            le_coeffs=torch.zeros((3,)), le_scale=torch.zeros(()),
            bounds_lo=_f32(bounds_lo), bounds_hi=_f32(bounds_hi),
            density=one, maj_grid=one.clone(), **_rgbgrid_placeholder(),
            max_density=torch.ones(()), kind=MEDIUM_HOMOGENEOUS,
        )

    @staticmethod
    def grid(density, sigma_a_rgb, sigma_s_rgb, bounds_lo, bounds_hi,
             g=0.0, scale=1.0, le_rgb=None, le_scale=0.0,
             maj_res=16) -> "MediumBuffers":
        """density: (nz, ny, nx); sigma_{a,s} scale with the local
        density."""
        density = np.asarray(density, np.float32)
        sa_c, sa_s = _fit_scaled(sigma_a_rgb, scale)
        ss_c, ss_s = _fit_scaled(sigma_s_rgb, scale)
        if le_rgb is None:
            le_c, le_s = torch.zeros((3,)), torch.zeros(())
        else:
            le_c, le_s = _fit_scaled(le_rgb, le_scale)
        return MediumBuffers(
            sigma_a_coeffs=sa_c, sigma_a_scale=sa_s,
            sigma_s_coeffs=ss_c, sigma_s_scale=ss_s, g=_f32(g),
            le_coeffs=le_c, le_scale=le_s,
            bounds_lo=_f32(bounds_lo), bounds_hi=_f32(bounds_hi),
            density=_f32(density),
            maj_grid=_f32(_pool_dilate_max(density, maj_res)),
            **_rgbgrid_placeholder(),
            max_density=_f32(float(density.max())), kind=MEDIUM_GRID,
        )

    @staticmethod
    def rgbgrid(sigma_a_grid, sigma_s_grid, bounds_lo, bounds_hi, g=0.0,
                scale=1.0, maj_res=16) -> "MediumBuffers":
        """Per-voxel RGB extinction (RGBGridMedium, media.h:599):
        sigma_{a,s}_grid (nz, ny, nx, 3), each voxel lifted to a spectrum
        fit; lookups interpolate the fits trilinearly. The majorant grid
        holds the per-voxel wavelength-max sigma_t over 32 wavelengths."""
        sa = np.asarray(sigma_a_grid, np.float32) * scale
        ss = np.asarray(sigma_s_grid, np.float32) * scale
        sa_c, sa_s = rgb2spec.fit_unbounded(sa)
        ss_c, ss_s = rgb2spec.fit_unbounded(ss)
        lam = _RGBGRID_LAMBDA[None, :]
        sig_t = (_eval_unbounded_np(sa_c.numpy().reshape(-1, 3),
                                    sa_s.numpy().reshape(-1), lam)
                 + _eval_unbounded_np(ss_c.numpy().reshape(-1, 3),
                                      ss_s.numpy().reshape(-1), lam))
        vox_max = np.max(sig_t, axis=-1).reshape(sa.shape[:3])
        z3, z = torch.zeros((3,)), torch.zeros(())
        return MediumBuffers(
            sigma_a_coeffs=z3, sigma_a_scale=z, sigma_s_coeffs=z3.clone(),
            sigma_s_scale=z.clone(), g=_f32(g), le_coeffs=z3.clone(),
            le_scale=z.clone(),
            bounds_lo=_f32(bounds_lo), bounds_hi=_f32(bounds_hi),
            density=torch.ones((1, 1, 1)),
            maj_grid=_f32(_pool_dilate_max(vox_max * 1.001, maj_res)),
            sa_grid_coeffs=sa_c, sa_grid_scale=sa_s,
            ss_grid_coeffs=ss_c, ss_grid_scale=ss_s,
            max_density=_f32(float(vox_max.max()) * 1.001),
            kind=MEDIUM_RGBGRID,
        )

    @staticmethod
    def cloud(sigma_a_rgb, sigma_s_rgb, bounds_lo, bounds_hi, g=0.0,
              scale=1.0, density: float = 1.0, wispiness: float = 1.0,
              frequency: float = 5.0) -> "MediumBuffers":
        """Procedural cloud (CloudMedium, media.h:430): density in [0, 1],
        so the homogeneous majorant is exact."""
        base = MediumBuffers.homogeneous(sigma_a_rgb, sigma_s_rgb, bounds_lo,
                                         bounds_hi, g=g, scale=scale)
        return base.replace(cloud_params=_f32([density, wispiness, frequency]),
                            kind=MEDIUM_CLOUD)

    # -- queries (batched over rays) -----------------------------------------

    @property
    def is_none(self) -> bool:
        return self.kind == MEDIUM_NONE

    @property
    def emissive(self) -> bool:
        # Every grid medium, as in the reference, also at Lescale 0.
        return self.kind == MEDIUM_GRID

    def bounds_segment(self, o, d, t_max):
        """Clip rays to the medium AABB: (t0, t1), t1 <= t_max, t1 <= t0
        where the ray misses the bounds."""
        inv = 1.0 / torch.where(torch.abs(d) < 1e-12, 1e-12, d)
        ta = (self.bounds_lo[None] - o) * inv
        tb = (self.bounds_hi[None] - o) * inv
        t0 = torch.clamp(torch.amax(torch.minimum(ta, tb), dim=-1), min=0.0)
        t1 = torch.minimum(torch.amin(torch.maximum(ta, tb), dim=-1), t_max)
        return t0, t1

    def _unit(self, p):
        """p in the medium's unit cube."""
        return (p - self.bounds_lo[None]) / torch.clamp(
            self.bounds_hi[None] - self.bounds_lo[None], min=1e-12)

    def _trilinear(self, field, p):
        """Voxel-centred trilinear lookup over the bounds. field: (nz, ny,
        nx) or (nz, ny, nx, C); (N,) or (N, C), zero outside the bounds
        (GridMedium's convention)."""
        chan = field.ndim == 4
        nz, ny, nx = field.shape[:3]
        res = torch.tensor([nx, ny, nz], dtype=torch.float32, device=p.device)
        g = self._unit(p)
        gc = g * res - 0.5
        gi = torch.floor(gc)
        f = gc - gi
        gi = gi.to(torch.int32).long()
        flat = field.reshape((nz * ny * nx,) + tuple(field.shape[3:]))

        def tap(dx, dy, dz):
            xi = torch.clamp(gi[..., 0] + dx, 0, nx - 1)
            yi = torch.clamp(gi[..., 1] + dy, 0, ny - 1)
            zi = torch.clamp(gi[..., 2] + dz, 0, nz - 1)
            return take(flat, (zi * ny + yi) * nx + xi)

        fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
        if chan:
            fx, fy, fz = fx[..., None], fy[..., None], fz[..., None]
        d00 = tap(0, 0, 0) * (1 - fx) + tap(1, 0, 0) * fx
        d10 = tap(0, 1, 0) * (1 - fx) + tap(1, 1, 0) * fx
        d01 = tap(0, 0, 1) * (1 - fx) + tap(1, 0, 1) * fx
        d11 = tap(0, 1, 1) * (1 - fx) + tap(1, 1, 1) * fx
        d0 = d00 * (1 - fy) + d10 * fy
        d1 = d01 * (1 - fy) + d11 * fy
        out = d0 * (1 - fz) + d1 * fz
        inside = torch.all((g >= 0.0) & (g <= 1.0), dim=-1)
        if chan:
            inside = inside[..., None]
        return torch.where(inside, out, 0.0)

    def _cloud_density(self, p):
        """Procedural cloud density in [0, 1] (CloudMedium::Density,
        media.h:478-510): five Perlin octaves at noise-perturbed points,
        falling off with altitude (y in medium space); DNoise's vector
        perturbation is three decorrelated scalar-noise taps, as in the
        reference."""
        from ..core.noise import perlin

        dens, wisp, freq = (self.cloud_params[0], self.cloud_params[1],
                            self.cloud_params[2])
        q = self._unit(p)
        inside = torch.all((q >= 0.0) & (q <= 1.0), dim=-1)
        pp = freq[..., None] * q
        vomega, vlambda = 0.05 * wisp, 10.0
        offs = torch.tensor([[31.416, 0.0, 0.0], [0.0, 27.183, 0.0],
                             [0.0, 0.0, 14.142]], dtype=torch.float32,
                            device=p.device)
        for _ in range(2):
            dn = torch.stack([perlin(vlambda * pp + offs[k][None])
                              for k in range(3)], dim=-1)
            pp = pp + vomega * dn
            vomega = vomega * 0.5
            vlambda = vlambda * 1.99
        d = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
        omega, lam_s = 0.5, 1.0
        for _ in range(5):
            d = d + omega * perlin(lam_s * pp)
            omega *= 0.5
            lam_s *= 1.99
        y = q[..., 1]
        d = torch.clamp((1.0 - y) * 4.5 * dens * d, 0.0, 1.0)
        d = d + 2.0 * torch.clamp(0.5 - y, min=0.0)
        return torch.where(inside, torch.clamp(d, 0.0, 1.0), 0.0)

    def density_at(self, p):
        """Density at world points p: (N,) -- trilinear for grids,
        procedural for the cloud, 1 for homogeneous media."""
        if self.kind == MEDIUM_CLOUD:
            return self._cloud_density(p)
        if self.kind != MEDIUM_GRID:
            return torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
        return self._trilinear(self.density, p)

    def corner_table(self):
        """(V, 8) table of the 8 edge-clamped trilinear corner taps of each
        base cell, index dz*4 + dy*2 + dx: one row gather a lookup, hoisted
        out of the walks."""
        f = self.density
        nz, ny, nx = f.shape
        fp = torch.nn.functional.pad(f[None, None], (1, 1, 1, 1, 1, 1),
                                     mode="replicate")[0, 0]
        corners = torch.stack(
            [fp[dz:dz + nz + 1, dy:dy + ny + 1, dx:dx + nx + 1]
             for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)], dim=-1)
        return corners.reshape(-1, 8)

    def density_at_fast(self, p, ctab):
        """Trilinear density through the corner table: _trilinear's taps,
        the 8-term weighted sum taken in corner order."""
        nz, ny, nx = self.density.shape
        res = torch.tensor([nx, ny, nz], dtype=torch.float32, device=p.device)
        g = self._unit(p)
        gc = g * res - 0.5
        gi = torch.floor(gc)
        fr = gc - gi
        hi = torch.tensor([nx - 1, ny - 1, nz - 1], dtype=torch.int64,
                          device=p.device)
        bi = torch.clamp(gi.to(torch.int32).long(), min=-1)
        bi = torch.minimum(bi, hi) + 1
        base = (bi[..., 2] * (ny + 1) + bi[..., 1]) * (nx + 1) + bi[..., 0]
        rows = take(ctab, base)  # (N, 8)
        fx, fy, fz = fr[..., 0], fr[..., 1], fr[..., 2]
        wx = (1.0 - fx, fx)
        wy = (1.0 - fy, fy)
        wz = (1.0 - fz, fz)
        # An explicit left-to-right sum, so a lane's value never depends on
        # the batch it is computed in (the compacted walks).
        out = None
        for c in range(8):
            w = wz[c >> 2] * wy[(c >> 1) & 1] * wx[c & 1]
            term = rows[:, c] * w
            out = term if out is None else out + term
        inside = torch.all((g >= 0.0) & (g <= 1.0), dim=-1)
        return torch.where(inside, out, 0.0)

    def sigma_at(self, p, lam):
        """(sigma_a, sigma_s) spectra (N, S) at world points: the unit
        spectra times the density, or the rgbgrid's interpolated fits
        (RGBGridMedium::SamplePoint)."""
        if self.kind == MEDIUM_RGBGRID:
            sa = rgb2spec.eval_unbounded(
                self._trilinear(self.sa_grid_coeffs, p),
                self._trilinear(self.sa_grid_scale, p), lam)
            ss = rgb2spec.eval_unbounded(
                self._trilinear(self.ss_grid_coeffs, p),
                self._trilinear(self.ss_grid_scale, p), lam)
            return sa, ss
        sa_u, ss_u = self.sigma_base(lam)
        dens = self.density_at(p)[..., None]
        return sa_u * dens, ss_u * dens

    def sigma_base(self, lam):
        """Unit-density (sigma_a, sigma_s) spectra at the wavelengths."""
        sa = rgb2spec.eval_unbounded(self.sigma_a_coeffs[None],
                                     self.sigma_a_scale[None], lam)
        ss = rgb2spec.eval_unbounded(self.sigma_s_coeffs[None],
                                     self.sigma_s_scale[None], lam)
        return sa, ss

    def sigma_majorant(self, lam):
        """Wavelength-independent majorant (N,) >= sigma_t(lam, p) for all
        of the ray's wavelengths and all p."""
        if self.kind == MEDIUM_RGBGRID:
            return self.max_density.expand(lam.shape[:-1])
        sa, ss = self.sigma_base(lam)
        return torch.amax(sa + ss, dim=-1) * self.max_density

    # -- DDA majorants (DDAMajorantIterator, media.h:136-214) ----------------

    def majorant_local(self, p, lam_maj_base):
        """Majorant of the coarse cell containing p: the cell's density
        maximum times lam_maj_base (N,), the unit-density majorant; 0
        outside the grid (vacuum)."""
        mz, my, mx = self.maj_grid.shape
        rel = self._unit(p)
        inside = torch.all((rel >= 0.0) & (rel < 1.0), dim=-1)
        ix = torch.clamp((rel[..., 0] * mx).to(torch.int32).long(), 0, mx - 1)
        iy = torch.clamp((rel[..., 1] * my).to(torch.int32).long(), 0, my - 1)
        iz = torch.clamp((rel[..., 2] * mz).to(torch.int32).long(), 0, mz - 1)
        dmax = self.maj_grid.reshape(-1)[(iz * my + iy) * mx + ix]
        return torch.where(inside, dmax * lam_maj_base, 0.0)

    def cell_exit_t(self, o, d, t):
        """Ray parameter of the exit from the majorant cell containing
        p(t), nudged past the boundary: the DDA step (media.h:183-206)."""
        mz, my, mx = self.maj_grid.shape
        res = torch.tensor([mx, my, mz], dtype=torch.float32, device=o.device)
        ext = torch.clamp(self.bounds_hi - self.bounds_lo, min=1e-12)
        cs = ext[None] / res[None]
        p = o + t[..., None] * d
        idx = torch.floor((p - self.bounds_lo[None]) / cs)
        bound = self.bounds_lo[None] + (idx + (d > 0.0).to(d.dtype)) * cs
        small = torch.abs(d) < 1e-12
        inv = 1.0 / torch.where(small, 1e-12, d)
        t_ax = torch.where(small, 1e30, (bound - o) * inv)
        t_exit = torch.amin(t_ax, dim=-1)
        return torch.maximum(t_exit, t) + 1e-4 * torch.amax(cs)

    def le_at(self, p, lam):
        """Volumetric emission radiance (GridMedium Le) where the density
        is positive."""
        le = rgb2spec.eval_unbounded(self.le_coeffs[None],
                                     self.le_scale[None], lam)
        dens = self.density_at(p)
        return torch.where((dens > 0.0)[..., None], le, 0.0)
