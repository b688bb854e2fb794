"""Pixel sensor: spectral response -> sensor RGB with white balance (port
of pbrt_tpu/films/sensor.py; PixelSensor, film.h:36-117, the ISET fork's
camera-sensor pipeline: spectral sensitivities, exposure (imagingRatio),
a least-squares XYZ-from-sensor matrix). The default sensitivities are
the CIE XYZ matching functions (pbrt's default sensor). The tables and
the matrix are built on the host with the reference's numpy code.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import cie, colorspace, spectrum
from ..core.floats import fma
from ..core.tensorclass import static_field, tensorclass


def interp(x, xp, fp):
    """jnp.interp on tensors, bit for bit: piecewise-linear through (xp,
    fp) (xp increasing) by searchsorted and a lerp, fp[0] below xp[0] and
    fp[-1] above xp[-1], in jnp.interp's order of operations."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.float32).eps))
    # fp[i - 1] + t * df with one rounding, as XLA's contracted
    # multiply-add (core/floats.py::fma).
    f = torch.where(dx0, fp[i - 1],
                    fma(delta / torch.where(dx0, 1.0, dx), df, fp[i - 1]))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


@tensorclass
class PixelSensor:
    lam_grid: torch.Tensor  # (K,) uniform wavelength grid
    response: torch.Tensor  # (3, K) r / g / b sensitivities
    rgb_from_sensor: torch.Tensor  # (3, 3) raw sensor integrals -> linear RGB
    imaging_ratio: torch.Tensor  # () exposure scale
    is_xyz: bool = static_field(default=True)

    @staticmethod
    def xyz(imaging_ratio: float = 1.0, cs=colorspace.SRGB) -> "PixelSensor":
        """The colorimetric sensor: CIE XYZ matching + the colorspace's
        matrix."""
        lam = np.linspace(cie.LAMBDA_MIN, cie.LAMBDA_MAX, 128)
        return PixelSensor(
            lam_grid=torch.from_numpy(lam.astype(np.float32)),
            response=torch.from_numpy(cie.cie_xyz_np(lam).T.astype(np.float32)),
            rgb_from_sensor=torch.from_numpy(
                np.asarray(cs.rgb_from_xyz, np.float32)),
            imaging_ratio=torch.tensor(imaging_ratio, dtype=torch.float32),
            is_xyz=True)

    @staticmethod
    def from_curves(lam, r, g, b, imaging_ratio: float = 1.0,
                    cs=colorspace.SRGB, white_src=None) -> "PixelSensor":
        """Custom sensitivities (the ISET camera-sensor path): the
        least-squares XYZ-from-sensor matrix over smooth training
        reflectances under D65 (film.h:60-110 fits the 24 swatches).
        white_src is taken and, as in the reference, not read: the fit is
        always under D65."""
        lam = np.asarray(lam, np.float64)
        resp = np.stack([r, g, b]).astype(np.float64)  # (3, K)
        k = lam.shape[0]
        x = (lam - lam.min()) / (lam.max() - lam.min())
        train = [np.ones(k)]
        for c in (0.25, 0.5, 0.75):
            train.append(1.0 / (1.0 + np.exp(-12 * (x - c))))
            train.append(np.exp(-0.5 * ((x - c) / 0.15) ** 2))
        train = np.stack(train)  # (T, K)
        illum = cie.illuminant_d65_np(lam)
        cmf = cie.cie_xyz_np(lam)  # (K, 3)
        xyz_t = (train * illum) @ cmf / np.sum(cmf[:, 1] * illum)
        sens_t = (train * illum) @ resp.T / max(np.sum(resp[1] * illum), 1e-9)
        m, *_ = np.linalg.lstsq(sens_t, xyz_t, rcond=None)  # sensor -> XYZ
        return PixelSensor(
            lam_grid=torch.from_numpy(lam.astype(np.float32)),
            response=torch.from_numpy(resp.astype(np.float32)),
            rgb_from_sensor=torch.from_numpy(
                (np.asarray(cs.rgb_from_xyz) @ m.T).astype(np.float32)),
            imaging_ratio=torch.tensor(imaging_ratio, dtype=torch.float32),
            is_xyz=False)

    def to_sensor_rgb(self, values, wl):
        """Monte Carlo sensor integration: (..., S) spectra -> (..., 3)."""
        r = torch.stack([interp(wl.lam, self.lam_grid, self.response[i])
                         for i in range(3)], dim=-1)  # (..., S, 3)
        w = spectrum.safe_div(values, wl.pdf)[..., None] * r
        raw = torch.mean(w, dim=-2) / cie.CIE_Y_INTEGRAL
        return (raw @ self.rgb_from_sensor.T) * self.imaging_ratio
