"""Sampled spectra and hero-wavelength sampling (port of core/spectrum.py).

A sampled spectrum is a float32 tensor whose trailing axis holds one value
per wavelength lane. The lane count is an explicit argument here (default
32); the reference fixes it at import from PBRT_TPU_NSPECTRUM, which this
package never reads.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cie
from .tensorclass import tensorclass

N_SPECTRUM_DEFAULT = 32
LAMBDA_MIN = cie.LAMBDA_MIN
LAMBDA_MAX = cie.LAMBDA_MAX
_RANGE = LAMBDA_MAX - LAMBDA_MIN


@tensorclass
class SampledWavelengths:
    """Per-ray wavelength samples and their sampling pdfs.

    lam: (..., S) wavelengths in nm; pdf: (..., S) pdf of each sample.
    """

    lam: torch.Tensor
    pdf: torch.Tensor


# pdf(lambda) proportional to sech^2(0.0072 (lambda - 538)), with an
# analytically invertible CDF (SampleVisibleWavelengths, spectrum.h:357).
_VIS_A = 0.0072
_VIS_MU = 538.0


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


# The reference evaluates these constants as float32 jnp scalars; doing the
# same keeps the sampled wavelengths within an ulp of it.
_T0 = torch.tanh(_f32(_VIS_A * (LAMBDA_MIN - _VIS_MU)))
_T1 = torch.tanh(_f32(_VIS_A * (LAMBDA_MAX - _VIS_MU)))
_VIS_NORM = float(_f32(_VIS_A) / (_T1 - _T0))


def _visible_pdf(lam):
    inside = (lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX)
    return torch.where(
        inside, _VIS_NORM / torch.cosh(_VIS_A * (lam - _VIS_MU)) ** 2, 0.0
    )


def _visible_sample(u):
    return _VIS_MU + torch.atanh(float(_T0) + u * float(_T1 - _T0)) / _VIS_A


def sample_uniform_hero(u, n_spectrum: int = N_SPECTRUM_DEFAULT):
    """Hero-wavelength sampling: one uniform hero and n_spectrum - 1
    rotated strata (SampledWavelengths::SampleUniform, spectrum.h:303).
    u: (...,) uniforms -> SampledWavelengths of shape (..., n_spectrum)."""
    lam0 = LAMBDA_MIN + u[..., None] * _RANGE
    offsets = torch.arange(n_spectrum, dtype=lam0.dtype, device=u.device) * (
        _RANGE / n_spectrum)
    lam = lam0 + offsets
    lam = torch.where(lam > LAMBDA_MAX, lam - _RANGE, lam)
    return SampledWavelengths(lam=lam, pdf=torch.full_like(lam, 1.0 / _RANGE))


def sample_visible(u, n_spectrum: int = N_SPECTRUM_DEFAULT):
    """Hero sampling with the visible-sensitivity importance distribution.

    u: (...,) uniforms -> SampledWavelengths of shape (..., n_spectrum).
    """
    offs = torch.arange(n_spectrum, dtype=torch.float32, device=u.device)
    up = u[..., None] + offs / n_spectrum
    up = torch.where(up > 1.0, up - 1.0, up)
    lam = _visible_sample(up)
    return SampledWavelengths(lam=lam, pdf=_visible_pdf(lam))


def safe_div(a, b):
    return torch.where(b != 0.0, a / torch.where(b == 0.0, 1.0, b), 0.0)


def to_xyz(values, wl: SampledWavelengths):
    """Monte Carlo estimate of the XYZ tristimulus of a sampled spectrum.

    values: (..., S); returns (..., 3). Reference: SampledSpectrum::ToXYZ.
    """
    cmf = cie.cie_xyz(wl.lam)  # (..., S, 3)
    integrand = safe_div(values, wl.pdf)[..., None] * cmf
    return torch.mean(integrand, dim=-2) / cie.CIE_Y_INTEGRAL


def luminance(values, wl: SampledWavelengths):
    y = cie.cie_y(wl.lam)
    return torch.mean(safe_div(values, wl.pdf) * y, dim=-1) / cie.CIE_Y_INTEGRAL


def average(values):
    return torch.mean(values, dim=-1)


# --- Spectra evaluated at sampled wavelengths ---------------------------------


def constant(value, lam):
    return torch.broadcast_to(
        torch.as_tensor(value, device=lam.device)[..., None], lam.shape)


def piecewise_linear(lams_table, vals_table, lam):
    """A piecewise-linear spectrum at sampled wavelengths
    (PiecewiseLinearSpectrum, spectrum.h:478): jnp.interp's rule, the
    end values held outside the table."""
    xp = torch.as_tensor(lams_table, dtype=torch.float32, device=lam.device)
    fp = torch.as_tensor(vals_table, dtype=torch.float32, device=lam.device)
    i = torch.clamp(torch.searchsorted(xp, lam, right=True), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = lam - xp[i - 1]
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(lam < xp[0], fp[0], f)
    return torch.where(lam > xp[-1], fp[-1], f)


def blackbody_normalized(lam, temperature_k):
    return cie.normalized_blackbody(lam, temperature_k)
