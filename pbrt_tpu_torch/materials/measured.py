"""Measured (tabulated) isotropic BRDFs (port of pbrt_tpu/materials/measured.py).

pbrt-v4's MeasuredBxDF (bxdfs.h) reads the Dupuy-Jakob RGL format; the
reference keeps its capability (render from measured reflectance, no
analytic model) in a dense isotropic half-angle table f(theta_h, theta_d,
phi_d), the MERL parameterization the RGL format is distilled from, of
per-cell RGB lifted to spectra by unbounded sigmoid fits. theta_h is
sqrt-warped (dense near the specular peak). Sampling is the cosine
hemisphere's (materials/bxdf.py).

`bake_measured` turns any BRDF into a table (numpy, on the host);
materials/rgl.py bakes a .bsdf file with it. A lookup gathers 8
trilinear taps from the table by plain indexing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import floats, rgb2spec
from ..core.take import take
from ..core.vecmath import cross

N_TH = 32  # theta_h bins (sqrt warped)
N_TD = 32  # theta_d bins
N_PD = 16  # phi_d bins over [0, pi] (reciprocity folds the rest)


def _norm3(v, eps):
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)).clamp(min=eps)


def _half_diff_angles(wo, wi):
    """(theta_h, theta_d, phi_d) of the half-angle parameterization."""
    h = wo + wi
    hn = h / _norm3(h, 1e-9)
    th = torch.arccos(torch.clamp(hn[..., 2], -1.0, 1.0))
    # wi in the frame whose pole is h gives the difference angles.
    cos_td = torch.clamp(torch.sum(hn * wi, dim=-1), -1.0, 1.0)
    td = torch.arccos(cos_td)
    # phi_d: wi's azimuth about h, from the plane that holds z.
    z = torch.tensor([0.0, 0.0, 1.0], dtype=wo.dtype, device=wo.device)
    t = z - hn * hn[..., 2:3]
    t = t / _norm3(t, 1e-9)
    b = cross(hn, t)
    wd = wi - hn * cos_td[..., None]
    pd = floats.atan2(torch.sum(wd * b, dim=-1), torch.sum(wd * t, dim=-1))
    # Isotropic mirror symmetry: f(phi_d) = f(-phi_d), so fold by |phi_d|.
    pd = torch.abs(pd)
    return th, td, torch.clamp(pd, max=np.pi - 1e-6)


def _cell_coords(th, td, pd):
    """Continuous cell coordinates (cell centres at integer + 0.5)."""
    x_h = torch.sqrt(torch.clamp(th / (np.pi / 2), 0.0, 1.0 - 1e-6)) * N_TH
    x_d = torch.clamp(td / (np.pi / 2), 0.0, 1.0 - 1e-6) * N_TD
    x_p = torch.clamp(pd / np.pi, 0.0, 1.0 - 1e-6) * N_PD
    return x_h, x_d, x_p


def trilinear_taps(th, td, pd):
    """The 8 (flat cell index, weight) taps of a trilinear lookup."""
    x_h, x_d, x_p = _cell_coords(th, td, pd)
    h0 = torch.clamp(torch.floor(x_h - 0.5).to(torch.int64), 0, N_TH - 1)
    d0 = torch.clamp(torch.floor(x_d - 0.5).to(torch.int64), 0, N_TD - 1)
    p0 = torch.clamp(torch.floor(x_p - 0.5).to(torch.int64), 0, N_PD - 1)
    fh = torch.clamp(x_h - 0.5 - h0, 0.0, 1.0)
    fd = torch.clamp(x_d - 0.5 - d0, 0.0, 1.0)
    fp = torch.clamp(x_p - 0.5 - p0, 0.0, 1.0)
    taps = []
    for a in (0, 1):
        for b in (0, 1):
            for c in (0, 1):
                ih = torch.clamp(h0 + a, max=N_TH - 1)
                idd = torch.clamp(d0 + b, max=N_TD - 1)
                ip = torch.clamp(p0 + c, max=N_PD - 1)
                w = ((fh if a else 1.0 - fh) * (fd if b else 1.0 - fd)
                     * (fp if c else 1.0 - fp))
                taps.append(((ih * N_TD + idd) * N_PD + ip, w))
    return taps


def lookup(coeffs, scale, base, wo, wi, lam):
    """The tabulated BRDF at sampled wavelengths, (N, S): coeffs (M*T, 3)
    and scale (M*T,) hold M flattened tables of T cells each; base (N,)
    is the first cell of each ray's table. Zero across hemispheres."""
    same = wo[..., 2] * wi[..., 2] > 0.0
    # Fold to the upper hemisphere (isotropic, reciprocal data).
    flip = wo[..., 2:3] < 0.0
    wo_u = torch.where(flip, -wo, wo)
    wi_u = torch.where(flip, -wi, wi)
    val = 0.0
    for idx, w in trilinear_taps(*_half_diff_angles(wo_u, wi_u)):
        i = base + idx
        val = val + w[..., None] * rgb2spec.eval_unbounded(
            take(coeffs, i), take(scale, i), lam)
    return torch.where(same[..., None], val, 0.0)


@dataclasses.dataclass
class MeasuredBRDF:
    coeffs: torch.Tensor  # (N_TH, N_TD, N_PD, 3) sigmoid fits of f's RGB
    scale: torch.Tensor  # (N_TH, N_TD, N_PD) unbounded-spectrum scales

    @staticmethod
    def from_table(rgb_table) -> "MeasuredBRDF":
        """rgb_table: (N_TH, N_TD, N_PD, 3) BRDF values (1/sr)."""
        t = np.asarray(rgb_table, np.float32)
        assert t.shape == (N_TH, N_TD, N_PD, 3), t.shape
        c, s = rgb2spec.fit_unbounded(t)
        return MeasuredBRDF(coeffs=c, scale=s)

    def f(self, wo, wi, lam):
        """The tabulated BRDF at sampled wavelengths: (N, S)."""
        base = torch.zeros(wo.shape[:-1], dtype=torch.int64, device=wo.device)
        return lookup(self.coeffs.reshape(-1, 3), self.scale.reshape(-1),
                      base, wo, wi, lam)


def bake_measured(f_rgb_fn, n_quad: int = 64) -> np.ndarray:
    """Bake a BRDF into the (N_TH, N_TD, N_PD, 3) table, on the host.

    f_rgb_fn(wo, wi) -> (..., 3) RGB BRDF values, local frame z up; it
    is given float32 CPU tensors. Each cell is evaluated at the (wo, wi)
    pair of its centre. n_quad is taken and, as in the reference, not
    read: one evaluation per cell, no quadrature."""
    # Cell centres of the sqrt-warped theta_h axis: the lookup coordinate
    # is x = sqrt(th / (pi/2)) * N_TH, so centre i sits at ((i+.5)/N)^2.
    th = (((np.arange(N_TH) + 0.5) / N_TH) ** 2) * (np.pi / 2)
    td = (np.arange(N_TD) + 0.5) / N_TD * (np.pi / 2)
    pd = (np.arange(N_PD) + 0.5) / N_PD * np.pi
    TH, TD, PD = np.meshgrid(th, td, pd, indexing="ij")
    # (wo, wi) from the half and difference angles: h in the xz plane, wi
    # turned from the h-pole frame, wo the mirror of wi about h.
    hvec = np.stack([np.sin(TH), np.zeros_like(TH), np.cos(TH)], -1)
    t = np.stack([np.zeros_like(TH), np.zeros_like(TH), np.ones_like(TH)],
                 -1) - hvec * hvec[..., 2:3]
    t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-9)
    b = np.cross(hvec, t)
    wd = np.sin(TD)[..., None] * (np.cos(PD)[..., None] * t
                                  + np.sin(PD)[..., None] * b)
    wi = wd + np.cos(TD)[..., None] * hvec
    wo = 2.0 * np.sum(wi * hvec, -1, keepdims=True) * hvec - wi
    # Cells whose centre dips below the horizon are still read by valid
    # grazing pairs: clamp to just above grazing rather than zero.
    for arr in (wi, wo):
        arr[..., 2] = np.maximum(arr[..., 2], 0.02)
        arr /= np.maximum(np.linalg.norm(arr, axis=-1, keepdims=True), 1e-9)
    wi_t = torch.from_numpy(wi.reshape(-1, 3).astype(np.float32))
    wo_t = torch.from_numpy(wo.reshape(-1, 3).astype(np.float32))
    vals = np.array(f_rgb_fn(wo_t, wi_t)).reshape(N_TH, N_TD, N_PD, 3)
    return np.clip(np.nan_to_num(vals), 0.0, None).astype(np.float32)
