"""SpectralPath: chromatic-aberration band rendering, the ISET fork's
SpectralPathIntegrator (port of pbrt_tpu/models/spectralpath.py;
integrators.h:382-416, integrators.cpp:2477-2951 of the fork).

The visible range splits into `n_bands` bands; each band is traced with
its own camera (a factory band_centre_nm -> camera is the dispersion hook:
an eye or lens camera rebuilt at the band's centre wavelength) and its own
hero wavelengths restricted to the band, and the film keeps each band's
spectral radiance. The bands are a Python loop around one band render.
Eye and lens cameras wait for ROADMAP Queue 1 item 14; the hook takes any
camera the port has.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import spectrum
from ..films.rgb import spectrum_to_rgb
from ..samplers.samplers import Sampler
from .path import PathIntegrator, refuse_gradient


def sample_band_wavelengths(u, band_lo: float, band_hi: float,
                            n_spectrum: int = spectrum.N_SPECTRUM_DEFAULT):
    """Hero sampling restricted to [band_lo, band_hi]: (...,) uniforms ->
    SampledWavelengths (..., n_spectrum). The band's width, step and pdf
    are float32, as the reference's traced scalars are."""
    lo, hi = np.float32(band_lo), np.float32(band_hi)
    width = hi - lo
    lam0 = float(lo) + u[..., None] * float(width)
    offsets = torch.arange(n_spectrum, dtype=lam0.dtype, device=u.device) * (
        float(width / np.float32(n_spectrum)))
    lam = lam0 + offsets
    lam = torch.where(lam > float(hi), lam - float(width), lam)
    return spectrum.SampledWavelengths(
        lam=lam, pdf=torch.full_like(lam, float(np.float32(1.0) / width)))


def render_spectral(scene, camera_or_factory, n_bands: int = 8,
                    spp_per_band: int = 8, seed: int = 0, max_depth: int = 5,
                    integrator=None,
                    n_spectrum: int = spectrum.N_SPECTRUM_DEFAULT, *, device):
    """Render band by band on `device`. Returns (rgb (ny, nx, 3), spectral
    (ny, nx, n_bands)): each band estimates its own sub-range's integral
    (its pdf restricted to the band), so the full-range RGB is the sum over
    the bands; spectral holds each band's mean radiance.

    camera_or_factory: a camera, or a callable band_centre_nm -> camera.
    """
    from ..render import camera_rays_full, on_device

    refuse_gradient(scene, "render_spectral")
    if callable(camera_or_factory) and not hasattr(camera_or_factory,
                                                   "resolution"):
        factory = camera_or_factory
    else:
        factory = lambda lam_c: camera_or_factory  # noqa: E731
    scene, camera0 = on_device(scene, factory(560.0), device)
    nx, ny = camera0.resolution
    npix = nx * ny
    integ = integrator or PathIntegrator(max_depth=max_depth)
    sampler = Sampler(seed=int(seed), kind="independent", spp=spp_per_band)
    dev = scene.geom.tri_verts.device
    pixel = torch.arange(npix, dtype=torch.int64, device=dev).repeat(
        spp_per_band)
    sample = torch.arange(spp_per_band, dtype=torch.int64,
                          device=dev).repeat_interleave(npix)
    edges = np.linspace(spectrum.LAMBDA_MIN, spectrum.LAMBDA_MAX, n_bands + 1)
    rgb_acc = torch.zeros((ny, nx, 3), dtype=torch.float32, device=dev)
    bands = []
    for b in range(n_bands):
        # The reference passes the band's edges as float32 scalars.
        lo, hi = np.float32(edges[b]), np.float32(edges[b + 1])
        camera = factory(0.5 * (float(edges[b]) + float(edges[b + 1])))
        camera = camera.to(dev)
        o, d, _, w = camera_rays_full(camera, pixel, sample, sampler,
                                      n_spectrum=n_spectrum)
        wl = sample_band_wavelengths(sampler.get_1d(pixel, sample, 4), lo, hi,
                                     n_spectrum)
        radiance = integ.trace(scene, o, d, wl, pixel, sample, sampler)
        rgb = spectrum_to_rgb(radiance, wl) * w[:, None]
        rgb_acc = rgb_acc + torch.mean(rgb.reshape(spp_per_band, ny, nx, 3),
                                       dim=0)
        band_val = torch.mean(spectrum.safe_div(radiance, wl.pdf), dim=-1) * w
        bands.append(torch.mean(band_val.reshape(spp_per_band, ny, nx), dim=0)
                     / float(np.float32(hi) - np.float32(lo)))
    return rgb_acc, torch.stack(bands, dim=-1)
