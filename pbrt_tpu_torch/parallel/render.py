"""Sharded rendering over a device mesh (port of
pbrt_tpu/parallel/render.py).

Two data-parallel decompositions:
  * tile-sharded: pixels split over the mesh; the film shards are
    concatenated, with no other traffic between devices.
  * spp-sharded: every device renders every pixel at a subset of the
    sample indices; the films are summed.

Both are repeatable bit for bit: a sample's value is a hash of (pixel,
sample, dimension), so each pixel's radiance does not depend on the
layout, and the films are summed in mesh order on the mesh's first
device. Each shard runs on its device in turn (the host drives one
shard's waves, then the next's), samples_per_pass samples to a wave; the
accumulation is the reference's: acc + spectrum_to_rgb(L, wl) * w over
the samples in order, then / spp, with no quarantine of non-finite
samples.
"""

from __future__ import annotations

import torch

from ..core import spectrum
from ..films.rgb import spectrum_to_rgb
from ..render import camera_rays_full
from .mesh import Mesh, one_process, replicate, shard_bounds, shard_pixels


def accumulate(scene, camera, integrator, pixel, samples, seed,
               n_spectrum: int, samples_per_pass: int = 1):
    """sum over `samples` of spectrum_to_rgb(L, wl) * w for the pixel ids
    `pixel` (on the scene's device): the film delta of one shard. Up to
    samples_per_pass samples are traced in one batch; a lane's value does
    not depend on its batch, and the sum runs sample by sample in order,
    so the result is the same bits for any samples_per_pass."""
    samples = [int(s) for s in samples]
    n = pixel.shape[0]
    acc = torch.zeros((n, 3), dtype=torch.float32, device=pixel.device)
    for first in range(0, len(samples), samples_per_pass):
        batch = samples[first:first + samples_per_pass]
        pix = pixel.repeat(len(batch))
        sample = torch.tensor(batch, dtype=pixel.dtype,
                              device=pixel.device).repeat_interleave(n)
        o, d, wl, w = camera_rays_full(camera, pix, sample, int(seed),
                                       n_spectrum=n_spectrum)
        L = integrator.trace(scene, o, d, wl, pix, sample, int(seed))
        rgb = spectrum_to_rgb(L, wl) * w[:, None]
        for j in range(len(batch)):
            acc = acc + rgb[j * n:(j + 1) * n]
    return acc


def render_tile_shards(scene, camera, integrator, mesh: Mesh, spp: int,
                       seed: int, n_spectrum: int,
                       samples_per_pass: int = 1) -> list:
    """This process's film shards of a pixel-sharded render: (npix /
    mesh.size, 3) each, on its mesh device, already divided by spp."""
    nx, ny = camera.resolution
    pixels = shard_pixels(torch.arange(nx * ny, dtype=torch.int64), mesh)
    scenes = replicate(scene, mesh)
    cameras = replicate(camera, mesh)
    return [accumulate(sc, cam, integrator, pix, range(spp), seed,
                       n_spectrum, samples_per_pass) / spp
            for sc, cam, pix in zip(scenes, cameras, pixels)]


def render_tile_sharded(scene, camera, integrator, mesh: Mesh, spp: int = 4,
                        seed: int = 0,
                        n_spectrum: int = spectrum.N_SPECTRUM_DEFAULT,
                        samples_per_pass: int = 1):
    """Pixels sharded over the mesh. Returns the (ny, nx, 3) image on the
    mesh's first device."""
    nx, ny = camera.resolution
    shards = render_tile_shards(scene, camera, integrator, one_process(mesh),
                                spp, seed, n_spectrum, samples_per_pass)
    first = mesh.devices[0]
    return torch.cat([s.to(first) for s in shards]).reshape(ny, nx, 3)


def render_spp_sharded(scene, camera, integrator, mesh: Mesh, spp: int = 8,
                       seed: int = 0,
                       n_spectrum: int = spectrum.N_SPECTRUM_DEFAULT,
                       samples_per_pass: int = 1):
    """Sample indices sharded over the mesh; the films summed in mesh
    order on the mesh's first device. Returns the (ny, nx, 3) image
    there."""
    nx, ny = camera.resolution
    npix = nx * ny
    mesh = one_process(mesh)
    scenes = replicate(scene, mesh)
    cameras = replicate(camera, mesh)
    films = []
    for (a, b), sc, cam, dev in zip(shard_bounds(spp, mesh), scenes, cameras,
                                    mesh.devices):
        pixel = torch.arange(npix, dtype=torch.int64, device=dev)
        films.append(accumulate(sc, cam, integrator, pixel, range(a, b),
                                seed, n_spectrum, samples_per_pass))
    first = mesh.devices[0]
    total = films[0].to(first)
    for f in films[1:]:
        total = total + f.to(first)
    return (total / spp).reshape(ny, nx, 3)
