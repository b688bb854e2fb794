"""GBuffer film: geometric and shading AOVs beside the radiance (port of
pbrt_tpu/films/gbuffer.py; GBufferFilm, film.h:325-433, with the ISET
fork's extensions, film.h:155-156, 328-333: position, normal, uv, albedo,
depth, material and primitive ids, per-pixel variance, and optional
per-wavelength-bucket radiance with SVD spectral-basis compression,
film.cpp:836-1005). The first-hit query is the scene's accelerator's
closest query (K1 on the card for a small scene).
"""

from __future__ import annotations

import numpy as np
import torch

from ..accel import api as accel_api
from ..core import rgb2spec
from ..core import spectrum as spec_mod
from ..core.floats import recip
from ..core.vecmath import dot
from .rgb import spectrum_to_rgb


def render_aovs(scene, camera, integrator, spp: int = 4, seed: int = 0,
                spectral_buckets: int = 0,
                n_spectrum: int = spec_mod.N_SPECTRUM_DEFAULT, *, device):
    """Render radiance + first-hit AOVs on `device`. Returns a dict of
    (ny, nx, C) tensors (C omitted where 1): rgb, p, n, uv, depth,
    albedo_rgb, material_id, prim_id, valid, variance (the per-pixel
    luminance variance over samples) and, with spectral_buckets > 0,
    spectral (ny, nx, spectral_buckets). One wave of spp samples a pixel,
    the independent sampler."""
    from ..render import camera_rays, on_device
    from ..samplers.samplers import Sampler

    scene, camera = on_device(scene, camera, device)
    nx, ny = camera.resolution
    npix = nx * ny
    sampler = Sampler.create("independent", spp=spp, seed=seed)
    dev = torch.device(device)
    pixel = torch.arange(npix, dtype=torch.int64, device=dev).repeat(spp)
    sample = torch.arange(spp, dtype=torch.int64,
                          device=dev).repeat_interleave(npix)
    o, d, wl = camera_rays(camera, pixel, sample, sampler,
                           n_spectrum=n_spectrum)
    radiance = integrator.trace(scene, o, d, wl, pixel, sample, sampler)
    rgb = spectrum_to_rgb(radiance, wl)  # (spp * npix, 3)

    # First-hit geometry AOVs (VisibleSurface, film.h:137-157).
    isect = accel_api.closest(scene, o, d)
    cos = dot(isect.n, isect.wo, keepdims=True)
    ns = isect.n * torch.sign(torch.where(cos == 0.0, 1.0, cos))
    coeffs = scene.materials.gather(isect.mat)["albedo_coeffs"]
    # The albedo's RGB: the fitted sigmoid spectrum projected back through
    # the fit's round-trip matrix, on its quadrature grid.
    rgb_from_s, lamq = rgb2spec._projection("srgb")
    alb_spec = rgb2spec.eval_sigmoid(coeffs, torch.from_numpy(lamq).to(dev))
    albedo_rgb = alb_spec @ torch.from_numpy(rgb_from_s).to(dev).T  # (N, 3)

    def avg(x):
        return torch.mean(x.reshape((spp, ny, nx) + tuple(x.shape[1:])), dim=0)

    lum = torch.mean(rgb, dim=-1).reshape(spp, ny, nx)
    mean_l = torch.mean(lum, dim=0)
    var = (torch.mean((lum - mean_l[None]) ** 2, dim=0)
           * (spp / max(spp - 1, 1)))
    out = {
        "rgb": avg(rgb),
        "p": avg(isect.p),
        "n": avg(ns),
        "uv": avg(isect.uv),
        "depth": avg(torch.where(isect.valid, isect.t, 0.0)),
        "albedo_rgb": avg(albedo_rgb),
        "material_id": avg(isect.mat.to(torch.float32)),
        "prim_id": avg(isect.prim.to(torch.float32)),
        "valid": avg(isect.valid.to(torch.float32)),
        "variance": var,
    }
    if spectral_buckets > 0:
        scale = recip(spec_mod.LAMBDA_MAX - spec_mod.LAMBDA_MIN)
        b = torch.clamp(((wl.lam - spec_mod.LAMBDA_MIN) * scale
                         * spectral_buckets).to(torch.int32),
                        0, spectral_buckets - 1).long()
        w = spec_mod.safe_div(radiance, wl.pdf)
        # Each lane's weight into its bucket (the reference's one-hot
        # einsum), over the lanes' count.
        spectral = torch.zeros((w.shape[0], spectral_buckets),
                               dtype=w.dtype, device=dev)
        spectral = spectral.scatter_add_(1, b, w) / radiance.shape[-1]
        out["spectral"] = avg(spectral)
    return out


def spectral_basis_compress(spectral_img, n_basis: int = 6):
    """SVD spectral-basis compression of a (ny, nx, B) radiance image on
    the host (the ISET fork's BDCSVD at GBuffer write time,
    film.cpp:836-1005): (coefficients (ny, nx, n_basis), basis (n_basis,
    B)) with img ~= coeffs @ basis, as numpy arrays."""
    if isinstance(spectral_img, torch.Tensor):
        spectral_img = spectral_img.detach().cpu().numpy()
    ny, nx, b = spectral_img.shape
    flat = spectral_img.reshape(-1, b)
    _, _, vt = np.linalg.svd(flat, full_matrices=False)
    basis = vt[:n_basis]  # (n_basis, B)
    return (flat @ basis.T).reshape(ny, nx, n_basis), basis
