#!/usr/bin/env python
"""Compute the JAX reference's image-loss gradients the PyTorch port is
held against.

Cornell box (diffuse), 32x32, 4 spp in passes of 2, 8 wavelength lanes,
path depth 5 without Russian roulette (rr_start_depth=5), seed 0,
small-scene accelerator attached, the reference's default gradient path
(grad_mode="remat"). The loss is bench.py's cornell_fwdbwd loss: the mean
squared error of spectrum_to_rgb against 0.25, one loss per pass. Each
pass's loss and its gradients with respect to materials.albedo_coeffs (5,
3) and lights.area_scale (2,) come from one jax.value_and_grad by
pbrt_tpu on the CPU; the file holds their means over the passes and the
settings, in tests/data/torch_port/cornell32_grad.npz. chip_smoke.py
phase g computes the same on the card with pbrt_tpu_torch.

Usage (from the repository root; ~30 s):
    JAX_PLATFORMS=cpu PBRT_TPU_NSPECTRUM=8 python scripts/make_torch_port_golden_grad.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port", "cornell32_grad.npz")

# The settings of the golden; chip_smoke.py phase g reads them back from
# the file.
GOLDEN = dict(resolution=32, spp=4, samples_per_pass=2, n_spectrum=8,
              max_depth=5, rr_start_depth=5, seed=0, target=0.25)


def golden_grad() -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pbrt_tpu.core.spectrum import N_SPECTRUM
    from pbrt_tpu.films.rgb import spectrum_to_rgb
    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.render import camera_rays
    from pbrt_tpu.scenes.cornell import cornell_box

    g = GOLDEN
    if N_SPECTRUM != g["n_spectrum"]:
        raise SystemExit(
            f"set PBRT_TPU_NSPECTRUM={g['n_spectrum']} (got {N_SPECTRUM})"
        )
    res, k = g["resolution"], g["samples_per_pass"]
    scene, camera = cornell_box(resolution=(res, res))
    scene = scene.with_accel()
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
        **{k_: np.asarray(v) for k_, v in GOLDEN.items()},
    }


def main() -> None:
    sys.path.insert(0, ROOT)
    out = golden_grad()
    for key in ("loss", "grad_albedo_coeffs", "grad_area_scale"):
        if not np.all(np.isfinite(out[key])):
            raise SystemExit(f"golden {key} is not finite")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(OUT, **out)
    print(f"wrote {OUT}: loss {float(out['loss']):.6f}, area_scale grad "
          f"{out['grad_area_scale']}")


if __name__ == "__main__":
    main()
