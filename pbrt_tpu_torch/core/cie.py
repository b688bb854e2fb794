"""CIE colorimetry: colour matching functions, illuminants D65, A and E,
Planck's blackbody and the whitepoint chromaticity.

Port of pbrt_tpu/core/cie.py. The CMFs are the Wyman-Sloan-Shirley
multi-lobe Gaussian fits, evaluated on tensors through the same Chebyshev
series the reference fits on the host; D65 is the published 10 nm table.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import cheb

# Visible range used throughout (the ISET fork's LambdaMin/LambdaMax).
LAMBDA_MIN = 395.0
LAMBDA_MAX = 705.0


def _gauss(lam, alpha, mu, sigma1, sigma2):
    """Piecewise (asymmetric) Gaussian lobe of the Wyman et al. fits."""
    sigma = np.where(lam < mu, sigma1, sigma2)
    t = (lam - mu) / sigma
    return alpha * np.exp(-0.5 * t * t)


def _cie_x_gauss(lam):
    return (
        _gauss(lam, 1.056, 599.8, 37.9, 31.0)
        + _gauss(lam, 0.362, 442.0, 16.0, 26.7)
        + _gauss(lam, -0.065, 501.1, 20.4, 26.2)
    )


def _cie_y_gauss(lam):
    return _gauss(lam, 0.821, 568.8, 46.9, 40.5) + _gauss(
        lam, 0.286, 530.9, 16.3, 31.1
    )


def _cie_z_gauss(lam):
    return _gauss(lam, 1.217, 437.0, 11.8, 36.0) + _gauss(
        lam, 0.681, 459.0, 26.0, 13.8
    )


_CHEB_LO, _CHEB_HI, _CHEB_DEG = 360.0, 830.0, 48


@functools.cache
def _cheb_xyz():
    return tuple(
        cheb.chebfit_fn(fn, _CHEB_LO, _CHEB_HI, _CHEB_DEG)
        for fn in (_cie_x_gauss, _cie_y_gauss, _cie_z_gauss)
    )


def cie_x(lam):
    return torch.clamp(
        cheb.chebeval(lam, _cheb_xyz()[0], _CHEB_LO, _CHEB_HI), min=0.0
    )


def cie_y(lam):
    return torch.clamp(
        cheb.chebeval(lam, _cheb_xyz()[1], _CHEB_LO, _CHEB_HI), min=0.0
    )


def cie_z(lam):
    return torch.clamp(
        cheb.chebeval(lam, _cheb_xyz()[2], _CHEB_LO, _CHEB_HI), min=0.0
    )


def cie_xyz(lam):
    """Stacked (..., 3) color matching functions."""
    return torch.stack([cie_x(lam), cie_y(lam), cie_z(lam)], dim=-1)


def _compute_y_integral() -> float:
    """Integral of cie_y over [360, 830] nm (host).

    The trapezoid rule written out as numpy.trapezoid computes it, so the
    value matches the reference's bit for bit on numpy versions that lack
    `trapezoid` (it appeared in numpy 2.0)."""
    lam = np.linspace(360.0, 830.0, 4701)
    y = np.maximum(
        cheb.chebeval_np(lam, _cheb_xyz()[1], _CHEB_LO, _CHEB_HI), 0.0
    )
    return float(np.add.reduce(np.diff(lam) * (y[1:] + y[:-1]) / 2.0))


# Normalizes XYZ so that a unit spectrum maps to Y == 1.
CIE_Y_INTEGRAL = _compute_y_integral()

# Standard illuminant D65, CIE publication values, 10 nm from 380 nm,
# normalized to 100 at 560 nm.
_D65_LAMBDA_START = 380.0
_D65_STEP = 10.0
_D65_VALUES = np.array(
    [
        49.9755, 54.6482, 82.7549, 91.486, 93.4318, 86.6823, 104.865,
        117.008, 117.812, 114.861, 115.923, 108.811, 109.354, 107.802,
        104.790, 107.689, 104.405, 104.046, 100.000, 96.3342, 95.788,
        88.6856, 90.0062, 89.5991, 87.6987, 83.2886, 83.6992, 80.0268,
        80.2146, 82.2778, 78.2842, 69.7213, 71.6091, 74.349, 61.604,
        69.8856, 75.087, 63.5927, 46.4182, 66.8054, 63.3828,
    ],
    dtype=np.float32,
)
_D65_LAMBDAS = _D65_LAMBDA_START + _D65_STEP * np.arange(len(_D65_VALUES))


def illuminant_d65(lam):
    """Relative spectral power of CIE D65 (100 at 560 nm).

    The reference's hat-basis sum (cie.py:147): sum_k v_k max(0, 1 -
    |lam - l_k| / 10). At any lam only the two hats of the enclosing 10 nm
    interval are non-zero, and every other term adds an exact 0.0, so the
    sum of those two terms is the same float32 value in two gathers
    instead of 41 passes over the tensor.
    """
    lo, hi = float(_D65_LAMBDAS[0]), float(_D65_LAMBDAS[-1])
    lam = torch.clamp(lam, lo, hi)
    n = len(_D65_VALUES)
    k = torch.clamp(
        torch.floor((lam - lo) * (1.0 / _D65_STEP)).to(torch.int64), 0, n - 2
    )
    vals = torch.as_tensor(_D65_VALUES, device=lam.device)
    lk = lo + _D65_STEP * k.to(lam.dtype)
    h0 = torch.clamp(1.0 - torch.abs(lam - lk) * 0.1, min=0.0)
    h1 = torch.clamp(1.0 - torch.abs(lam - (lk + _D65_STEP)) * 0.1, min=0.0)
    return vals[k] * h0 + vals[k + 1] * h1


# Host-side numpy mirrors for build-time computations.
def cie_xyz_np(lam: np.ndarray) -> np.ndarray:
    cx, cy, cz = _cheb_xyz()
    return np.stack(
        [
            np.maximum(cheb.chebeval_np(lam, c, _CHEB_LO, _CHEB_HI), 0.0)
            for c in (cx, cy, cz)
        ],
        axis=-1,
    )


def illuminant_d65_np(lam: np.ndarray) -> np.ndarray:
    return np.interp(lam, _D65_LAMBDAS, _D65_VALUES)


def blackbody(lam_nm, temperature_k):
    """Planck's law: spectral radiance (W / (m^2 sr m)) at lam_nm
    nanometres (spectrum.h Blackbody). A Python float lam_nm is worked in
    double up to the exponential, then in float32, as the reference's
    jnp.exp of a Python float does."""
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    lam = lam_nm * 1e-9
    lam5 = lam * lam * lam * lam * lam
    denom = lam * kb * temperature_k
    # A Python number over a tensor is the tensor's reciprocal times the
    # number in PyTorch: a 0-d tensor numerator keeps the one division.
    if isinstance(denom, torch.Tensor):
        e = torch.exp(_f32(h * c, denom.device) / denom)
    else:
        e = torch.exp(_f32((h * c) / denom, "cpu"))
    return _f32(2.0 * h * c * c, e.device) / (lam5 * (e - 1.0))


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def normalized_blackbody(lam_nm, temperature_k):
    """Blackbody scaled so that its peak (Wien's law) is 1."""
    lam_max_nm = 2.8977721e-3 / temperature_k * 1e9
    peak = blackbody(lam_max_nm, temperature_k)
    return blackbody(lam_nm, temperature_k) / peak.to(
        torch.as_tensor(lam_nm).device)


def illuminant_a(lam):
    """CIE standard illuminant A: a 2856 K blackbody, 100 at 560 nm."""
    return 100.0 * blackbody(lam, 2856.0) / blackbody(560.0, 2856.0).to(lam.device)


def illuminant_e(lam):
    """The equal-energy illuminant."""
    return torch.ones_like(lam) * 100.0


def whitepoint_xy(illuminant=None) -> np.ndarray:
    """Chromaticity (x, y) of an illuminant under the CMF fits (host)."""
    lam = np.linspace(360.0, 830.0, 941)
    if illuminant is None or illuminant is illuminant_d65:
        spd = illuminant_d65_np(lam)
    else:
        spd = illuminant(torch.as_tensor(lam, dtype=torch.float32)).numpy()
    xyz = np.sum(cie_xyz_np(lam) * spd[:, None], axis=0)
    return xyz[:2] / xyz.sum()
