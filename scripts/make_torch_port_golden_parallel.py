#!/usr/bin/env python
"""Compute the JAX reference's sharded renders and mesh training step that
the PyTorch port's parallel/ modules are held against.

pbrt_tpu runs on the CPU with 8 virtual devices, the mesh of
tests/test_parallel.py and tests/test_multihost.py: the Cornell box at
16x16 (small-scene tier attached), PathIntegrator(max_depth=3), 8
wavelength lanes, seed 0.

- "tile4", "tile8": render_tile_sharded on the 8-device mesh at 4 and 8 spp;
- "spp8": render_spp_sharded on the same mesh at 8 spp;
- the training step (training_step on the mesh, lr 1): pixels
  arange(256) twice, sample indices 0 and 1 (512 rays), a flat 0.25
  target; "step_loss", and "step_<leaf>" the updated albedo_coeffs (5, 3)
  and area_scale (2,), with "start_<leaf>" the values before the step,
  so that start - step is the gradient;
- the multi-process entry points run in this one process over the same
  8-device mesh, with the inputs parallel/mp_worker.py gives them (4 spp,
  a flat 0.25 target): "mp_img" from render_multiprocess, and "mp_loss",
  "mp_albedo_coeffs" and "mp_area_scale" (the gradients) from
  train_step_multiprocess.

It writes tests/data/torch_port/parallel16.npz; tests/test_torch_parallel.py
holds the port's render_tile_sharded, render_spp_sharded and
training_step(mesh=...) on a CPU mesh of 8 against it, and
tests/test_torch_multiprocess.py the port's gloo workers.

Usage (from the repository root, ~3 min):
    JAX_PLATFORMS=cpu PBRT_TPU_NSPECTRUM=8 python scripts/make_torch_port_golden_parallel.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "data", "torch_port", "parallel16.npz")
GOLDEN = dict(resolution=16, max_depth=3, n_spectrum=8, seed=0, n_devices=8,
              step_samples=2, target=0.25, lr=1.0, mp_spp=4)


def main() -> None:
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        f"{flags} --xla_force_host_platform_device_count="
        f"{GOLDEN['n_devices']}").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pbrt_tpu.core.spectrum import N_SPECTRUM
    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.parallel.mesh import make_mesh
    from pbrt_tpu.parallel.multiprocess import (
        render_multiprocess,
        train_step_multiprocess,
    )
    from pbrt_tpu.parallel.render import (
        render_spp_sharded,
        render_tile_sharded,
    )
    from pbrt_tpu.parallel.train import training_step
    from pbrt_tpu.scenes.cornell import cornell_box

    g = GOLDEN
    if N_SPECTRUM != g["n_spectrum"]:
        raise SystemExit(f"set PBRT_TPU_NSPECTRUM={g['n_spectrum']} "
                         f"(got {N_SPECTRUM})")
    if len(jax.devices()) < g["n_devices"]:
        raise SystemExit(f"need {g['n_devices']} CPU devices, have "
                         f"{len(jax.devices())}")
    res = g["resolution"]
    scene, camera = cornell_box(resolution=(res, res))
    scene = scene.with_accel()
    integ = PathIntegrator(max_depth=g["max_depth"])
    mesh = make_mesh(g["n_devices"])
    out = {k: np.asarray(v) for k, v in g.items()}
    t0 = time.perf_counter()
    for spp in (4, 8):
        out[f"tile{spp}"] = np.asarray(render_tile_sharded(
            scene, camera, integ, mesh, spp=spp, seed=g["seed"]))
    out["spp8"] = np.asarray(render_spp_sharded(
        scene, camera, integ, mesh, spp=8, seed=g["seed"]))
    print(f"renders {time.perf_counter() - t0:.1f} s")
    npix = res * res
    k = g["step_samples"]
    pixel = jnp.tile(jnp.arange(npix, dtype=jnp.int32), (k,))
    sample = jnp.repeat(jnp.arange(k, dtype=jnp.int32), npix)
    target = jnp.full((npix * k, 3), g["target"], jnp.float32)
    t0 = time.perf_counter()
    loss, new_scene = training_step(mesh, scene, camera, integ, pixel, target,
                                    sample, g["seed"], lr=g["lr"])
    print(f"training step {time.perf_counter() - t0:.1f} s")
    out["step_loss"] = np.asarray(loss)
    for name, old, new in (
            ("albedo_coeffs", scene.materials.albedo_coeffs,
             new_scene.materials.albedo_coeffs),
            ("area_scale", scene.lights.area_scale,
             new_scene.lights.area_scale)):
        out[f"start_{name}"] = np.asarray(old)
        out[f"step_{name}"] = np.asarray(new)
    t0 = time.perf_counter()
    out["mp_img"] = render_multiprocess(scene, camera, integ, mesh,
                                        spp=g["mp_spp"], seed=g["seed"])
    mp_target = np.full((npix, 3), g["target"], np.float32)
    mp_loss, mp_grads = train_step_multiprocess(
        scene, camera, integ, mp_target, mesh, spp=g["mp_spp"],
        seed=g["seed"])
    print(f"multi-process entry points {time.perf_counter() - t0:.1f} s")
    out["mp_loss"] = np.asarray(mp_loss, np.float32)
    for name, grad in mp_grads.items():
        out[f"mp_{name}"] = np.asarray(grad)
    np.savez_compressed(OUT, **out)
    for key in ("tile4", "tile8", "spp8", "mp_img"):
        print(key, out[key].shape, float(out[key].mean()))
    print("loss", float(out["step_loss"]), "->", OUT)


if __name__ == "__main__":
    main()
