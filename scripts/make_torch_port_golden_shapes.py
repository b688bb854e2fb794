#!/usr/bin/env python
"""Render the JAX reference goldens of the shapes box and the moving
instanced field, which the PyTorch port is held against.

The scenes are tests/data/torch_port/shapes.pbrt (every shape family and
both kinds of shape alpha) and tests/data/torch_port/motion.pbrt (six
static and two moving instances of an object with an alpha-cut fence),
through the reference's parser, with the file's integrator (path, depth
5), 8 wavelength lanes, seed 0. shapes.pbrt runs on the reference's dense
watertight tester (its CPU path for a small scene), op by op
(jax.disable_jit: its jitted trace rounds otherwise where XLA fuses, and
on this scene that alone moves a lane's path and two of the pass's
queries), its stochastic alpha test keyed on rounded ray bits
(tests/torch_port_shapes.py coarse_alpha_keys: the port is held against
these goldens with the same keys); motion.pbrt jitted, on its sweep (the
Pallas kernel in interpret mode) and its animated pass, its alpha
texture 0 or 1 (no stochastic test).

- tests/data/torch_port/{shapes,motion}16_samples.npz: the per-sample
  radiance (512, 8) and the traced ray count of one pass at 16x16, 2 spp,
  the reference's trace_with_stats. tests/test_torch_shapes.py and
  tests/test_torch_motion.py hold the port's CPU trace against them.
- tests/data/torch_port/{shapes,motion}32_spp4.npy: 32x32, 4 spp in one
  pass, (32, 32, 3) float32 images. chip_smoke.py phase d25 holds the
  card against them.
- tests/data/torch_port/motion32_grad.npz: bench.py's loss (the MSE of
  spectrum_to_rgb against 0.25) on motion.pbrt at 32x32, 4 spp in passes
  of 2, depth 5 without Russian roulette, and its gradients with respect
  to materials.albedo_coeffs and lights.area_scale from one
  jax.value_and_grad a pass (the reference's default remat path), their
  means over the passes. chip_smoke.py phase g7 holds the card against it.

Usage (from the repository root):
    JAX_PLATFORMS=cpu PBRT_TPU_NSPECTRUM=8 python scripts/make_torch_port_golden_shapes.py [part ...]
parts: samples, images, grad (default all).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "tests", "data", "torch_port")

# The settings of the goldens; the tests and chip_smoke.py read them back
# from the files.
IMAGE = dict(resolution=32, spp=4, n_spectrum=8, seed=0)
SAMPLES = dict(resolution=16, spp=2, n_spectrum=8, seed=0)
GRAD = dict(resolution=32, spp=4, samples_per_pass=2, n_spectrum=8,
            max_depth=5, rr_start_depth=5, seed=0, target=0.25)


def _scene(name: str, res: int):
    """The reference's (scene, camera, integrator) of a scene file."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pbrt_tpu.core.spectrum import N_SPECTRUM
    from pbrt_tpu.io.parser import load_pbrt

    if N_SPECTRUM != IMAGE["n_spectrum"]:
        raise SystemExit(
            f"set PBRT_TPU_NSPECTRUM={IMAGE['n_spectrum']} (got {N_SPECTRUM})")
    scene, camera, settings = load_pbrt(os.path.join(OUT_DIR, f"{name}.pbrt"))
    if name == "shapes":
        scene = scene.replace(small=None)
    return scene, camera.replace(resolution=(res, res)), settings["integrator"]


@contextlib.contextmanager
def _reference_mode(name: str):
    """shapes.pbrt op by op on coarse alpha keys; motion.pbrt jitted as it
    is."""
    import jax

    from pbrt_tpu.accel import api
    from tests.torch_port_shapes import coarse_alpha_keys

    if name != "shapes":
        yield
        return
    with coarse_alpha_keys(api), jax.disable_jit():
        yield


def trace_samples(name: str) -> dict:
    import jax
    import jax.numpy as jnp

    from pbrt_tpu.render import camera_rays_full

    g = SAMPLES
    res, spp = g["resolution"], g["spp"]
    scene, camera, integ = _scene(name, res)
    npix = res * res
    pixel = jnp.tile(jnp.arange(npix, dtype=jnp.int32), spp)
    sample = jnp.repeat(jnp.arange(spp, dtype=jnp.int32), npix)
    o, d, wl, _ = camera_rays_full(camera, pixel, sample, g["seed"])
    with _reference_mode(name):
        L, stats = jax.jit(lambda s, o, d, wl: integ.trace_with_stats(
            s, o, d, wl, pixel, sample, g["seed"]))(scene, o, d, wl)
    return {"radiance": np.asarray(L, np.float32),
            "rays": np.float32(stats["rays"]),
            "max_depth": np.int32(integ.max_depth),
            **{k: np.asarray(v) for k, v in g.items()}}


def render_image(name: str) -> np.ndarray:
    from pbrt_tpu.render import render

    g = IMAGE
    scene, camera, integ = _scene(name, g["resolution"])
    with _reference_mode(name):
        img = render(scene, camera, integ, spp=g["spp"], seed=g["seed"],
                     samples_per_pass=g["spp"])
    return np.asarray(img, np.float32)


def golden_grad() -> dict:
    import jax
    import jax.numpy as jnp

    from pbrt_tpu.films.rgb import spectrum_to_rgb
    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.render import camera_rays

    g = GRAD
    res, k = g["resolution"], g["samples_per_pass"]
    scene, camera, _ = _scene("motion", res)
    integrator = PathIntegrator(max_depth=g["max_depth"],
                                rr_start_depth=g["rr_start_depth"])
    npix = res * res
    pixel_b = jnp.tile(jnp.arange(npix, dtype=jnp.int32), (k,))
    target = jnp.full((npix * k, 3), g["target"], jnp.float32)
    seed = jnp.int32(g["seed"])

    @jax.jit
    def grad_pass(albedo_coeffs, area_scale, pass_idx):
        def loss_fn(albedo_coeffs, area_scale):
            s = scene.replace(
                materials=scene.materials.replace(albedo_coeffs=albedo_coeffs),
                lights=scene.lights.replace(area_scale=area_scale),
            )
            sample_b = jnp.repeat(
                pass_idx * k + jnp.arange(k, dtype=jnp.int32), npix)
            o, d, wl = camera_rays(camera, pixel_b, sample_b, seed)
            radiance = integrator.trace(s, o, d, wl, pixel_b, sample_b, seed)
            return jnp.mean((spectrum_to_rgb(radiance, wl) - target) ** 2)

        return jax.value_and_grad(loss_fn, argnums=(0, 1))(
            albedo_coeffs, area_scale)

    losses, g_albedo, g_area = [], [], []
    for p in range(g["spp"] // k):
        loss, (ga, gs) = grad_pass(scene.materials.albedo_coeffs,
                                   scene.lights.area_scale, jnp.int32(p))
        losses.append(float(loss))
        g_albedo.append(np.asarray(ga, np.float64))
        g_area.append(np.asarray(gs, np.float64))
    return {
        "loss": np.float32(np.mean(losses)),
        "pass_losses": np.asarray(losses, np.float32),
        "grad_albedo_coeffs": np.mean(g_albedo, axis=0).astype(np.float32),
        "grad_area_scale": np.mean(g_area, axis=0).astype(np.float32),
        **{k_: np.asarray(v) for k_, v in g.items()},
    }


def main() -> None:
    sys.path.insert(0, ROOT)
    parts = sys.argv[1:] or ["samples", "images", "grad"]
    os.makedirs(OUT_DIR, exist_ok=True)
    for name in ("shapes", "motion"):
        if "samples" in parts:
            t0 = time.perf_counter()
            out = trace_samples(name)
            path = os.path.join(OUT_DIR, f"{name}16_samples.npz")
            np.savez(path, **out)
            print(f"wrote {path}: mean {out['radiance'].mean():.6f}, rays "
                  f"{float(out['rays'])}, {time.perf_counter() - t0:.1f} s")
        if "images" in parts:
            t0 = time.perf_counter()
            img = render_image(name)
            if not np.all(np.isfinite(img)):
                raise SystemExit(f"the {name} golden has non-finite pixels")
            path = os.path.join(OUT_DIR, f"{name}32_spp4.npy")
            np.save(path, img)
            print(f"wrote {path}: mean {img.mean():.6f}, "
                  f"{time.perf_counter() - t0:.1f} s")
    if "grad" in parts:
        t0 = time.perf_counter()
        out = golden_grad()
        for key in ("loss", "grad_albedo_coeffs", "grad_area_scale"):
            if not np.all(np.isfinite(out[key])):
                raise SystemExit(f"golden {key} is not finite")
        path = os.path.join(OUT_DIR, "motion32_grad.npz")
        np.savez(path, **out)
        print(f"wrote {path}: loss {float(out['loss']):.6f}, area_scale "
              f"grad {out['grad_area_scale']}, "
              f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
