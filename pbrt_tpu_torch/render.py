"""Render orchestration: camera samples -> integrator -> film.

Port of pbrt_tpu/render.py. One call evaluates a whole sample wave (every
pixel x samples_per_pass samples) as one batch, and a Python loop runs the
waves, so memory stays O(pixels x samples_per_pass) in-flight rays.
"""

from __future__ import annotations

import math

import torch

from .core import spectrum
from .films.rgb import RGBFilm, spectrum_to_rgb
from .filters.filters import Filter
from .samplers.samplers import Sampler, as_sampler


def camera_rays_full(camera, pixel, sample_idx, sampler, jitter: bool = True,
                     filt=None, n_spectrum: int = spectrum.N_SPECTRUM_DEFAULT):
    """Primary rays + wavelengths + camera weight for pixel ids.

    Every camera family: the perspective, orthographic and spherical
    cameras return (o, d); the lens cameras (realistic / omni, the human
    eye, RTF) also a per-ray weight, 0 where the lens vignettes.
    pixel, sample_idx: (N,) integer tensors (sample_idx may be an int);
    sampler: a Sampler or an int seed; filt: a filters.Filter whose
    importance-sampled offset and sign weight replace the box jitter (the
    box keeps the jitter). Returns (o, d, wl, w).
    """
    sampler = as_sampler(sampler)
    nx, _ = camera.resolution
    jx, jy = sampler.get_2d(pixel, sample_idx, 0)
    w_filter = None
    if not jitter:
        jx = torch.full_like(jx, 0.5)
        jy = torch.full_like(jy, 0.5)
    elif filt is not None and filt.kind != "box":
        fs = filt.sample(torch.stack([jx, jy], dim=-1))
        jx = 0.5 + fs.p[..., 0]
        jy = 0.5 + fs.p[..., 1]
        w_filter = fs.weight
    px = (pixel % nx).to(torch.float32) + jx
    py = torch.div(pixel, nx, rounding_mode="floor").to(torch.float32) + jy
    p_film = torch.stack([px, py], dim=-1)
    ul0, ul1 = sampler.get_2d(pixel, sample_idx, 2)
    kw = {}
    if getattr(camera, "motion", None) is not None:
        # The shutter time (dim 5) moves the camera.
        kw["time"] = camera.sample_time(sampler.get_1d(pixel, sample_idx, 5))
    u_wl = sampler.get_1d(pixel, sample_idx, 4)
    wl = spectrum.sample_visible(u_wl, n_spectrum)
    if getattr(camera, "diffraction", False):
        # HURB needs the hero wavelength inside the lens trace.
        kw["wavelength_nm"] = wl.lam[..., 0]
    out = camera.generate_rays(p_film, torch.stack([ul0, ul1], dim=-1), **kw)
    if len(out) == 3:
        o, d, w = out
    else:
        o, d = out
        w = torch.ones_like(px)
    if w_filter is not None:
        w = w * w_filter
    return o, d, wl, w


def camera_rays(camera, pixel, sample_idx, sampler, jitter: bool = True,
                n_spectrum: int = spectrum.N_SPECTRUM_DEFAULT):
    """camera_rays_full without the camera weight: (o, d, wl)."""
    o, d, wl, _ = camera_rays_full(camera, pixel, sample_idx, sampler, jitter,
                                   None, n_spectrum)
    return o, d, wl


def check_device(device) -> torch.device:
    """`device` as a torch.device. A CUDA device without a card raises, and
    so does TF32 matmul on (the renders keep float32); nothing falls back
    to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r}: no CUDA device is available")
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "the renders keep float32 throughout: set "
                "torch.backends.cuda.matmul.allow_tf32 = False"
            )
    return device


def on_device(scene, camera, device):
    """The scene and camera moved to `device` (check_device)."""
    device = check_device(device)
    return scene.to(device), camera.to(device)


def render(scene, camera, integrator, spp: int = 16, seed: int = 0,
           samples_per_pass: int = 1, jitter: bool = True,
           sampler_kind: str = "independent", sample_offset: int = 0,
           total_spp: int | None = None, filter_kind: str = "box",
           n_spectrum: int = spectrum.N_SPECTRUM_DEFAULT, *,
           device) -> torch.Tensor:
    """Render and return the developed linear-RGB image (ny, nx, 3).

    `device` is required: the scene and camera are moved there and every
    wave runs there. A CUDA device without a card raises; nothing falls
    back to the CPU. sample_offset/total_spp cover sample indices
    [sample_offset, sample_offset + spp) of a total_spp-sample render.
    """
    device = torch.device(device)
    filt = None
    if filter_kind != "box":
        filt = Filter.create(filter_kind).to(device)
    if spp % samples_per_pass != 0:
        raise ValueError("spp must divide by samples_per_pass")
    scene, camera = on_device(scene, camera, device)
    nx, ny = camera.resolution
    sampler = Sampler(
        seed=int(seed), kind=sampler_kind, spp=total_spp or spp, nx=nx,
        log2_res=max(1, (max(nx, ny) - 1).bit_length()),
    )
    npix = nx * ny
    k = samples_per_pass
    pixel_b = torch.arange(npix, dtype=torch.int64, device=device).repeat(k)
    film = RGBFilm.zeros((nx, ny), device)
    for pass_idx in range(spp // k):
        first = sample_offset + pass_idx * k
        sample_b = torch.arange(
            first, first + k, dtype=torch.int64, device=device
        ).repeat_interleave(npix)
        o, d, wl, w = camera_rays_full(
            camera, pixel_b, sample_b, sampler, jitter, filt, n_spectrum
        )
        radiance = integrator.trace(scene, o, d, wl, pixel_b, sample_b, sampler)
        rgb = spectrum_to_rgb(radiance, wl) * w[:, None]  # (k*npix, 3)
        # NaN/Inf sample quarantine: drop non-finite samples (value AND
        # weight), as the reference does per sample in Film::AddSample.
        finite = torch.all(torch.isfinite(rgb), dim=-1)
        rgb = torch.where(finite[:, None], rgb, 0.0)
        rgb_img = torch.sum(rgb.reshape(k, ny, nx, 3), dim=0) / k
        w_img = torch.mean(finite.to(rgb.dtype).reshape(k, ny, nx), dim=0)
        rgb_img = torch.where(
            w_img[..., None] > 0.0,
            rgb_img / torch.clamp(w_img, min=1e-12)[..., None],
            0.0,
        )
        film = film.add_sample_image(rgb_img, w_img)
    return film.image()


def render_chunked(scene, camera, integrator, spp: int = 64, seed: int = 0,
                   samples_per_pass: int = 4, chunk_spp: int = 8, *, device,
                   **kw) -> torch.Tensor:
    """render() split into calls of chunk_spp samples each, the sample
    indices continuing across chunks, so the result is the one-call
    render's up to the order of the sums."""
    chunk_spp = max(samples_per_pass, chunk_spp - chunk_spp % samples_per_pass)
    imgs = []
    done = 0
    while done < spp:
        cur = min(chunk_spp, spp - done)
        # A tail chunk may not divide by samples_per_pass: the gcd does.
        imgs.append(render(scene, camera, integrator, spp=cur, seed=seed,
                           samples_per_pass=math.gcd(samples_per_pass, cur),
                           sample_offset=done, total_spp=spp, device=device,
                           **kw) * cur)
        done += cur
    return sum(imgs) / spp


def render_file(scene, camera, settings, spp: int | None = None, seed: int = 0,
                samples_per_pass: int = 1,
                n_spectrum: int = spectrum.N_SPECTRUM_DEFAULT, *, device):
    """Render a parsed scene file (io/parser.py's (scene, camera,
    settings)) with the integrator it names, as pbrt_tpu's
    tools/pbrt_render.py does: the light tracers and MLT own their render
    loops, the rest go through render(). `spp` (default the file's) is the
    samples per pixel of render() and BDPT, SPPM's iterations, MLT's
    mutations per pixel, the light path's paths per pixel and the function
    integrator's samples. Returns the (ny, nx, 3) linear-RGB image."""
    from .models.bdpt import BDPTIntegrator, render_bdpt
    from .models.function import FunctionIntegrator
    from .models.lightpath import LightPathIntegrator, render_lightpath
    from .models.mlt import MLTIntegrator, render_mlt
    from .models.sppm import SPPMIntegrator

    integ = settings["integrator"]
    spp = int(settings["spp"] if spp is None else spp)
    kw = {"n_spectrum": n_spectrum, "device": device}
    if isinstance(integ, FunctionIntegrator):
        est, _ = integ.render(camera.resolution, spp,
                              sampler_kind=settings["sampler"], seed=seed,
                              device=device)
        return est[..., None].expand(*est.shape, 3)
    if isinstance(integ, MLTIntegrator):
        return render_mlt(scene, camera, max_depth=integ.base.max_depth,
                          seed=seed, mutations_per_pixel=spp,
                          n_chains=integ.n_chains, sigma=integ.sigma,
                          p_large=integ.p_large, **kw)
    if isinstance(integ, SPPMIntegrator):
        return integ.render(scene, camera, n_iterations=spp, seed=seed, **kw)
    if isinstance(integ, BDPTIntegrator):
        return render_bdpt(scene, camera, spp=spp, max_depth=integ.max_depth,
                           seed=seed, samples_per_pass=samples_per_pass, **kw)
    if isinstance(integ, LightPathIntegrator):
        nx, ny = camera.resolution
        return render_lightpath(scene, camera, n_paths_total=spp * nx * ny,
                                max_depth=integ.max_depth, seed=seed, **kw)
    return render(scene, camera, integ, spp=spp, seed=seed,
                  samples_per_pass=samples_per_pass,
                  sampler_kind=settings["sampler"], **kw)
