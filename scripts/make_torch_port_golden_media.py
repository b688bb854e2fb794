#!/usr/bin/env python
"""Render the JAX reference goldens of the volumetric path, which the
PyTorch port is held against.

- tests/data/torch_port/cloud32_spp4.npy: bench.py's cloud_fwd scene
  (scenes/cloud.py cloud_scene: a 48^3 density grid, DDA majorants) at
  32x32, 4 spp in one pass, VolPathIntegrator(max_depth=6) (bench's: DDA
  on, Russian roulette from depth 3), 8 wavelength lanes, seed 0, the
  medium entry inset (tests/torch_port_media.py inset_entry): a (32, 32,
  3) float32 image. chip_smoke.py phase d21 holds the card against it.
- tests/data/torch_port/fog32_spp4.npy: tests/goldens/fog.pbrt (a
  homogeneous interior medium behind a material-less sphere, a point
  light) through the reference's parser, 32x32, 4 spp, the file's
  integrator (volpath, depth 5), 8 lanes, seed 0 (no scene-level medium,
  so no entry to inset). Phase d21 too.
- tests/data/torch_port/{cloud16,fog16}_samples.npz: per-sample radiance
  (512, 8) and the traced ray count of one pass of those two scenes at
  16x16, 2 spp, 8 lanes, seed 0, the reference's jitted trace_with_stats
  (the cloud's entry inset). tests/test_torch_volpath.py holds the port's
  CPU trace against them.
- tests/data/torch_port/fogbox8_grad.npz: tests/test_gradients.py's
  medium configuration (scenes/cloud.py fog_box_scene with sigma_a 0.8,
  8x8, 48 spp in one batch, VolPathIntegrator(max_depth=2,
  rr_start_depth=100, use_nee=False, max_null_steps=32, max_tr_steps=32,
  differentiable=True), 8 lanes, seed 0): the mean radiance and its
  gradient with respect to medium.sigma_a_scale, one jax.value_and_grad.
  tests/test_torch_volpath.py and chip_smoke.py phase g6 hold the port's
  against it.

The reference runs on the CPU with its dense triangle tester. Usage
(from the repository root; ~2 minutes):
    JAX_PLATFORMS=cpu PBRT_TPU_NSPECTRUM=8 python scripts/make_torch_port_golden_media.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "tests", "data", "torch_port")
FOG_FILE = os.path.join(ROOT, "tests", "goldens", "fog.pbrt")

# The settings of the goldens; the tests and chip_smoke.py read them back
# from the files.
IMAGE = dict(resolution=32, spp=4, n_spectrum=8, seed=0)
SAMPLES = dict(resolution=16, spp=2, n_spectrum=8, seed=0)
CLOUD_DEPTH = 6
GRAD = dict(resolution=8, spp=48, n_spectrum=8, seed=0, sigma_a=0.8,
            le_scale=5.0, max_depth=2, rr_start_depth=100, max_steps=32)


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pbrt_tpu.core.spectrum import N_SPECTRUM

    if N_SPECTRUM != IMAGE["n_spectrum"]:
        raise SystemExit(
            f"set PBRT_TPU_NSPECTRUM={IMAGE['n_spectrum']} (got {N_SPECTRUM})")
    return jax


def _scenes(res: int):
    """{name: (scene, camera, integrator, inset entry?)} of the reference,
    no accelerator attached."""
    from pbrt_tpu.io.parser import load_pbrt
    from pbrt_tpu.models.volpath import VolPathIntegrator
    from pbrt_tpu.scenes.cloud import cloud_scene

    scene, camera = cloud_scene(resolution=(res, res))
    out = {"cloud": (scene, camera, VolPathIntegrator(max_depth=CLOUD_DEPTH),
                     True)}
    scene, camera, settings = load_pbrt(FOG_FILE)
    scene = scene.replace(small=None, clusters=None)
    out["fog"] = (scene, camera.replace(resolution=(res, res)),
                  settings["integrator"], False)
    return out


def _inset(on: bool):
    import contextlib

    from pbrt_tpu.media.medium import MediumBuffers
    from tests.torch_port_media import inset_entry

    return inset_entry(MediumBuffers) if on else contextlib.nullcontext()


def render_images() -> dict:
    _jax()
    from pbrt_tpu.render import render

    g = IMAGE
    out = {}
    for name, (scene, camera, integ, inset) in _scenes(g["resolution"]).items():
        with _inset(inset):
            img = render(scene, camera, integ, spp=g["spp"], seed=g["seed"],
                         samples_per_pass=g["spp"])
            out[name] = np.asarray(img, np.float32)
    return out


def trace_samples() -> dict:
    jax = _jax()
    import jax.numpy as jnp

    from pbrt_tpu.render import camera_rays_full

    g = SAMPLES
    res, spp = g["resolution"], g["spp"]
    npix = res * res
    pixel = jnp.tile(jnp.arange(npix, dtype=jnp.int32), spp)
    sample = jnp.repeat(jnp.arange(spp, dtype=jnp.int32), npix)
    out = {}
    for name, (scene, camera, integ, inset) in _scenes(res).items():
        o, d, wl, _ = camera_rays_full(camera, pixel, sample, g["seed"])
        with _inset(inset):
            L, stats = jax.jit(lambda s, o, d, wl: integ.trace_with_stats(
                s, o, d, wl, pixel, sample, g["seed"]))(scene, o, d, wl)
            out[name] = {"radiance": np.asarray(L, np.float32),
                         "rays": np.float32(stats["rays"]),
                         "max_depth": np.int32(integ.max_depth),
                         **{k: np.asarray(v) for k, v in g.items()}}
    return out


def fog_box_grad() -> dict:
    jax = _jax()
    import jax.numpy as jnp

    from pbrt_tpu.models.volpath import VolPathIntegrator
    from pbrt_tpu.render import camera_rays
    from pbrt_tpu.scenes.cloud import fog_box_scene

    g = GRAD
    res, spp = g["resolution"], g["spp"]
    scene, camera = fog_box_scene(sigma_a=g["sigma_a"], sigma_s=0.0,
                                  le_scale=g["le_scale"],
                                  resolution=(res, res))
    integ = VolPathIntegrator(
        max_depth=g["max_depth"], rr_start_depth=g["rr_start_depth"],
        use_nee=False, max_null_steps=g["max_steps"],
        max_tr_steps=g["max_steps"], differentiable=True)
    npix = res * res
    pixel = jnp.tile(jnp.arange(npix, dtype=jnp.int32), spp)
    sample = jnp.repeat(jnp.arange(spp, dtype=jnp.int32), npix)
    seed = jnp.int32(g["seed"])

    def loss(sa_scale):
        s = scene.replace(medium=scene.medium.replace(sigma_a_scale=sa_scale))
        o, d, wl = camera_rays(camera, pixel, sample, seed)
        return jnp.mean(integ.trace(s, o, d, wl, pixel, sample, seed))

    value, grad = jax.value_and_grad(loss)(scene.medium.sigma_a_scale)
    return {"loss": np.float32(value), "grad_sigma_a_scale": np.float32(grad),
            "sigma_a_scale": np.float32(scene.medium.sigma_a_scale),
            **{k: np.asarray(v) for k, v in g.items()}}


def main() -> None:
    sys.path.insert(0, ROOT)
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    for name, img in render_images().items():
        if not np.all(np.isfinite(img)):
            raise SystemExit(f"{name}: golden render has non-finite pixels")
        path = os.path.join(OUT_DIR, f"{name}32_spp4.npy")
        np.save(path, img)
        print(f"wrote {path}: mean {img.mean():.6f}")
    print(f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, out in trace_samples().items():
        path = os.path.join(OUT_DIR, f"{name}16_samples.npz")
        np.savez(path, **out)
        print(f"wrote {path}: mean {out['radiance'].mean():.6f}, rays "
              f"{float(out['rays'])}")
    print(f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out = fog_box_grad()
    if not (np.isfinite(out["loss"]) and np.isfinite(out["grad_sigma_a_scale"])):
        raise SystemExit("the gradient golden is not finite")
    path = os.path.join(OUT_DIR, "fogbox8_grad.npz")
    np.savez(path, **out)
    print(f"wrote {path}: loss {float(out['loss']):.6f}, grad "
          f"{float(out['grad_sigma_a_scale']):.6f}, "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
