#!/usr/bin/env python
"""Write the io scenes' input files with the reference's writers and
render the JAX reference goldens of those scenes, which the PyTorch port
is held against.

- tests/data/torch_port/io/{sky.exr, left.exr, right.png, back.qoi,
  floor.ptx, ceiling.ptx, cube.ptx, wall.ptx, smoke.nvdb}: the inputs of
  io_surfaces.pbrt and io_smoke.pbrt (tests/torch_port_io.py's SMALL
  size, seed 0), written by pbrt_tpu/io's writers.
- tests/data/torch_port/io_{surfaces,smoke}32_spp4.npy: each scene
  through the reference's parser at 32x32, 4 spp in one pass, the file's
  integrator (path, or volpath for io_smoke; depth 5), 8 wavelength
  lanes, seed 0; io_smoke with the medium entry inset
  (tests/torch_port_media.py). chip_smoke.py phase d28 holds the card
  against them.
- tests/data/torch_port/io_{surfaces,smoke}16_samples.npz: per-sample
  radiance (512, 8) and the traced ray count of one pass at 16x16, 2 spp,
  8 lanes, seed 0, the reference's jitted trace_with_stats (io_smoke's
  entry inset). tests/test_torch_io_render.py holds the port's CPU trace
  against them.

The reference runs on the CPU with its dense triangle tester. Usage
(from the repository root; ~2 minutes):
    JAX_PLATFORMS=cpu PBRT_TPU_NSPECTRUM=8 python scripts/make_torch_port_golden_io.py
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "tests", "data", "torch_port")


def _jax(io):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pbrt_tpu.core.spectrum import N_SPECTRUM

    if N_SPECTRUM != io.IMAGE["n_spectrum"]:
        raise SystemExit(f"set PBRT_TPU_NSPECTRUM={io.IMAGE['n_spectrum']} "
                         f"(got {N_SPECTRUM})")
    return jax


def _scenes(io, res: int):
    """{name: (scene, camera, integrator, inset entry?)} of the reference,
    no accelerator attached."""
    from pbrt_tpu.io.parser import load_pbrt

    out = {}
    for name in io.SCENES:
        scene, camera, settings = load_pbrt(
            os.path.join(io.IO_DIR, name + ".pbrt"))
        if settings.get("warnings"):
            raise SystemExit(f"{name}: {settings['warnings']}")
        scene = scene.replace(small=None, clusters=None)
        out[name] = (scene, camera.replace(resolution=(res, res)),
                     settings["integrator"], io.INSET[name])
    return out


def _inset(on: bool):
    from pbrt_tpu.media.medium import MediumBuffers
    from tests.torch_port_media import inset_entry

    return inset_entry(MediumBuffers) if on else contextlib.nullcontext()


def render_images(io) -> dict:
    _jax(io)
    from pbrt_tpu.render import render

    g = io.IMAGE
    out = {}
    for name, (scene, camera, integ, inset) in _scenes(
            io, g["resolution"]).items():
        with _inset(inset):
            img = render(scene, camera, integ, spp=g["spp"], seed=g["seed"],
                         samples_per_pass=g["spp"])
            out[name] = np.asarray(img, np.float32)
    return out


def trace_samples(io) -> dict:
    jax = _jax(io)
    import jax.numpy as jnp

    from pbrt_tpu.render import camera_rays_full

    g = io.SAMPLES
    res, spp = g["resolution"], g["spp"]
    npix = res * res
    pixel = jnp.tile(jnp.arange(npix, dtype=jnp.int32), spp)
    sample = jnp.repeat(jnp.arange(spp, dtype=jnp.int32), npix)
    out = {}
    for name, (scene, camera, integ, inset) in _scenes(io, res).items():
        o, d, wl, _ = camera_rays_full(camera, pixel, sample, g["seed"])
        with _inset(inset):
            L, stats = jax.jit(lambda s, o, d, wl: integ.trace_with_stats(
                s, o, d, wl, pixel, sample, g["seed"]))(scene, o, d, wl)
            out[name] = {"radiance": np.asarray(L, np.float32),
                         "rays": np.float32(stats["rays"]),
                         "max_depth": np.int32(integ.max_depth),
                         **{k: np.asarray(v) for k, v in g.items()}}
    return out


def main() -> None:
    sys.path.insert(0, ROOT)
    from tests import torch_port_io as io

    os.makedirs(io.IO_DIR, exist_ok=True)
    io.write_inputs("pbrt_tpu", io.IO_DIR, io.SMALL, io.SEED)
    for name in sorted(os.listdir(io.IO_DIR)):
        print(f"{name}: {os.path.getsize(os.path.join(io.IO_DIR, name))} bytes")
    t0 = time.perf_counter()
    for name, img in render_images(io).items():
        if not np.all(np.isfinite(img)):
            raise SystemExit(f"{name}: golden render has non-finite pixels")
        path = os.path.join(OUT_DIR, f"{name}32_spp4.npy")
        np.save(path, img)
        print(f"wrote {path}: mean {img.mean():.6f}")
    print(f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, out in trace_samples(io).items():
        path = os.path.join(OUT_DIR, f"{name}16_samples.npz")
        np.savez(path, **out)
        print(f"wrote {path}: mean {out['radiance'].mean():.6f}, rays "
              f"{float(out['rays'])}")
    print(f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
