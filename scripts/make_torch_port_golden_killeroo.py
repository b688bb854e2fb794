#!/usr/bin/env python
"""Render the JAX reference golden of the killeroo-class scene that the
PyTorch port's card render is held against.

killeroo_class_scene (122,244 triangles, Morton cluster accelerator), 64x64,
4 spp in one pass, 8 wavelength lanes, path depth 5 with the default
Russian roulette, seed 0 — rendered by pbrt_tpu on the CPU (the cluster
kernel in Pallas interpret mode) and saved as a (64, 64, 3) float32 array
to tests/data/torch_port/killeroo64_spp4.npy. chip_smoke.py phase (d2)
renders pbrt_tpu_torch on the GPU with the same settings and compares.

Usage (from the repository root):
    JAX_PLATFORMS=cpu PBRT_TPU_NSPECTRUM=8 python scripts/make_torch_port_golden_killeroo.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port", "killeroo64_spp4.npy")

# The settings the golden is rendered with; chip_smoke.py phase (d2) renders
# the port with the same ones.
GOLDEN = dict(resolution=(64, 64), spp=4, samples_per_pass=4, n_spectrum=8,
              max_depth=5, seed=0)


def render_golden() -> np.ndarray:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pbrt_tpu.core.spectrum import N_SPECTRUM
    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.render import render
    from pbrt_tpu.scenes.meshes import killeroo_class_scene

    if N_SPECTRUM != GOLDEN["n_spectrum"]:
        raise SystemExit(
            f"set PBRT_TPU_NSPECTRUM={GOLDEN['n_spectrum']} (got {N_SPECTRUM})"
        )
    if os.environ.get("PBRT_TPU_ACCEL", "cluster") != "cluster":
        raise SystemExit("the golden uses the cluster accelerator: unset "
                         "PBRT_TPU_ACCEL")
    scene, camera = killeroo_class_scene(resolution=GOLDEN["resolution"])
    assert scene.clusters is not None
    img = render(
        scene, camera, PathIntegrator(max_depth=GOLDEN["max_depth"]),
        spp=GOLDEN["spp"], seed=GOLDEN["seed"],
        samples_per_pass=GOLDEN["samples_per_pass"],
    )
    return np.asarray(img, np.float32)


def main() -> None:
    sys.path.insert(0, ROOT)
    t0 = time.perf_counter()
    img = render_golden()
    if not np.all(np.isfinite(img)):
        raise SystemExit("golden render has non-finite pixels")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.save(OUT, img)
    print(f"wrote {OUT}: shape {img.shape}, mean {img.mean():.6f}, "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
