"""Sampled spectra and hero-wavelength sampling (port of core/spectrum.py).

A sampled spectrum is a float32 tensor whose trailing axis holds one value
per wavelength lane. The lane count is an explicit argument here (default
32); the reference fixes it at import from PBRT_TPU_NSPECTRUM, which this
package never reads.
"""

from __future__ import annotations

import torch

from . import cie
from .tensorclass import tensorclass

N_SPECTRUM_DEFAULT = 32
LAMBDA_MIN = cie.LAMBDA_MIN
LAMBDA_MAX = cie.LAMBDA_MAX


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
