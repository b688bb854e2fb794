#!/usr/bin/env python
"""Render the JAX reference goldens of the many-light hall and the coated
Cornell box and compute the reference's gradients on the latter, which
the PyTorch port is held against.

- tests/data/torch_port/manylight32_{power,bvh}_spp4.npy: the full hall
  (scenes/manylight.py: 1,024 panel lights, seed 7, a coated-diffuse
  floor) with the power and with the light-BVH sampler, 32x32, 4 spp in
  one pass, depth 4 without Russian roulette (bench.py's manylight_fwd
  integrator), 8 wavelength lanes, seed 0, rendered by pbrt_tpu on the CPU
  with its dense triangle tester (the cluster accelerator dropped): (32,
  32, 3) float32 images.
- tests/data/torch_port/coated_cornell32_grad.npz: the Cornell box with
  coated materials (tests/torch_port_coated.py coated_cornell), 32x32, 4
  spp in passes of 2, depth 5 without Russian roulette, 8 lanes, seed 0,
  bench.py's cornell_fwdbwd loss (the MSE of spectrum_to_rgb against
  0.25) and its gradients with respect to materials.albedo_coeffs (4, 3)
  and lights.area_scale (2,), one jax.value_and_grad per pass (the
  reference's default grad_mode="remat"), as
  scripts/make_torch_port_golden_grad.py computes them for the diffuse box
  but op by op (jax.disable_jit): jitted, XLA's CPU compile of the
  rematerialized walks (four of them in each bounce) had not finished
  after 28 minutes.
- tests/data/torch_port/{manylight16_power,manylight16_bvh,
  coated_cornell16}_samples.npz: per-sample radiance (512, 8) and the
  traced ray count of one pass: the hall cut to 16 lights with each
  sampler, and the coated Cornell box, 16x16, 2 spp, depth 3 without
  Russian roulette, 8 lanes, seed 0, the reference's jitted
  trace_with_stats with its dense tester. tests/test_torch_manylight.py
  and tests/test_torch_coated.py hold the port's CPU trace against them
  (the reference's compile of the coated box's four walks takes over a
  minute; here it is paid once).

All are made with the layered walk keyed on coarse direction bits
(tests/torch_port_coated.py coarse_walk_keys), the keying the port's
comparisons use: with the exact keys, the last-bit rounding differences
between XLA and PyTorch re-key a third of the walks. chip_smoke.py phases
d18 and g5 compare the card with these files.

Usage (from the repository root; ~15 minutes):
    JAX_PLATFORMS=cpu PBRT_TPU_NSPECTRUM=8 python scripts/make_torch_port_golden_manylight.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "tests", "data", "torch_port")

# The settings of the goldens; chip_smoke.py reads the gradient file's
# back from it and renders the hall with HALL.
HALL = dict(resolution=32, spp=4, samples_per_pass=4, n_spectrum=8,
            max_depth=4, seed=0)
GRAD = dict(resolution=32, spp=4, samples_per_pass=2, n_spectrum=8,
            max_depth=5, rr_start_depth=5, seed=0, target=0.25)
SAMPLES = dict(resolution=16, spp=2, n_spectrum=8, max_depth=3, seed=0)


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pbrt_tpu.core.spectrum import N_SPECTRUM

    if N_SPECTRUM != HALL["n_spectrum"]:
        raise SystemExit(
            f"set PBRT_TPU_NSPECTRUM={HALL['n_spectrum']} (got {N_SPECTRUM})")
    return jax


def render_hall(sampler: str) -> np.ndarray:
    _jax()
    from pbrt_tpu.materials import layered
    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.render import render
    from pbrt_tpu.scenes.manylight import manylight_scene
    from tests.torch_port_coated import coarse_walk_keys

    res, depth = HALL["resolution"], HALL["max_depth"]
    scene, camera = manylight_scene(resolution=(res, res), sampler=sampler)
    scene = scene.replace(clusters=None)
    with coarse_walk_keys(layered):
        img = render(scene, camera,
                     PathIntegrator(max_depth=depth, rr_start_depth=depth),
                     spp=HALL["spp"], seed=HALL["seed"],
                     samples_per_pass=HALL["samples_per_pass"])
        return np.asarray(img, np.float32)


def trace_samples(scene, camera) -> dict:
    """One pass of SAMPLES through the reference's jitted trace: (N, 8)
    radiance and the traced ray count, with the settings."""
    jax = _jax()
    import jax.numpy as jnp

    from pbrt_tpu.materials import layered
    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.render import camera_rays_full
    from tests.torch_port_coated import coarse_walk_keys

    g = SAMPLES
    res, spp, depth = g["resolution"], g["spp"], g["max_depth"]
    npix = res * res
    pixel = jnp.tile(jnp.arange(npix, dtype=jnp.int32), spp)
    sample = jnp.repeat(jnp.arange(spp, dtype=jnp.int32), npix)
    o, d, wl, _ = camera_rays_full(camera.replace(resolution=(res, res)),
                                   pixel, sample, g["seed"])
    integ = PathIntegrator(max_depth=depth, rr_start_depth=depth)
    with coarse_walk_keys(layered):
        L, stats = jax.jit(lambda s, o, d, wl: integ.trace_with_stats(
            s, o, d, wl, pixel, sample, g["seed"]))(scene, o, d, wl)
        return {"radiance": np.asarray(L, np.float32),
                "rays": np.float32(stats["rays"]),
                **{k: np.asarray(v) for k, v in g.items()}}


def sample_goldens() -> dict:
    """{file stem: trace_samples(...)} of the hall (16 lights, each
    sampler) and the coated Cornell box, with the dense tester."""
    _jax()
    from pbrt_tpu.scenes.manylight import manylight_scene
    from tests.torch_port_coated import coated_cornell

    res = (SAMPLES["resolution"],) * 2
    out = {}
    for sampler in ("power", "bvh"):
        scene, camera = manylight_scene(resolution=res, n_lights=16,
                                        sampler=sampler)
        out[f"manylight16_{sampler}_samples"] = trace_samples(
            scene.replace(clusters=None), camera)
    scene, camera = coated_cornell("pbrt_tpu", res)
    out["coated_cornell16_samples"] = trace_samples(scene, camera)
    return out


def coated_grad() -> dict:
    jax = _jax()
    import jax.numpy as jnp

    from pbrt_tpu.films.rgb import spectrum_to_rgb
    from pbrt_tpu.materials import layered
    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.render import camera_rays
    from tests.torch_port_coated import coarse_walk_keys, coated_cornell

    g = GRAD
    res, k = g["resolution"], g["samples_per_pass"]
    scene, camera = coated_cornell("pbrt_tpu", (res, res))
    scene = scene.with_accel()
    integrator = PathIntegrator(max_depth=g["max_depth"],
                                rr_start_depth=g["rr_start_depth"])
    npix = res * res
    pixel_b = jnp.tile(jnp.arange(npix, dtype=jnp.int32), (k,))
    target = jnp.full((npix * k, 3), g["target"], jnp.float32)
    seed = jnp.int32(g["seed"])

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
    with coarse_walk_keys(layered), jax.disable_jit():
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
        **{k_: np.asarray(v) for k_, v in GRAD.items()},
    }


def main() -> None:
    sys.path.insert(0, ROOT)
    os.makedirs(OUT_DIR, exist_ok=True)
    for sampler in ("power", "bvh"):
        t0 = time.perf_counter()
        img = render_hall(sampler)
        if not np.all(np.isfinite(img)):
            raise SystemExit(f"{sampler}: golden render has non-finite pixels")
        out = os.path.join(OUT_DIR, f"manylight32_{sampler}_spp4.npy")
        np.save(out, img)
        print(f"wrote {out}: mean {img.mean():.6f}, "
              f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for stem, out in sample_goldens().items():
        path = os.path.join(OUT_DIR, stem + ".npz")
        np.savez(path, **out)
        print(f"wrote {path}: mean {out['radiance'].mean():.6f}, rays "
              f"{float(out['rays'])}")
    print(f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out = coated_grad()
    for key in ("loss", "grad_albedo_coeffs", "grad_area_scale"):
        if not np.all(np.isfinite(out[key])):
            raise SystemExit(f"golden {key} is not finite")
    path = os.path.join(OUT_DIR, "coated_cornell32_grad.npz")
    np.savez(path, **out)
    print(f"wrote {path}: loss {float(out['loss']):.6f}, area_scale grad "
          f"{out['grad_area_scale']}, {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
