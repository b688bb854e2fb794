#!/usr/bin/env python
"""Render the JAX reference golden image the PyTorch port is held against.

Cornell box (diffuse), 32x32, 16 spp in passes of 4, 32 wavelength lanes,
path depth 5 with the default Russian roulette, seed 0, small-scene
accelerator attached — rendered by pbrt_tpu on the CPU and saved as a
(32, 32, 3) float32 array to tests/data/torch_port/cornell32_spp16.npy.
chip_smoke.py (on the GPU) and tests/test_torch_slice.py (on the CPU)
compare pbrt_tpu_torch renders with it.

Usage (from the repository root):
    JAX_PLATFORMS=cpu PBRT_TPU_NSPECTRUM=32 python scripts/make_torch_port_golden.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port", "cornell32_spp16.npy")

# The settings the golden is rendered with. chip_smoke.py phase (d) and
# tests/test_torch_slice.py render the port with the same ones.
GOLDEN = dict(resolution=(32, 32), spp=16, samples_per_pass=4, n_spectrum=32,
              max_depth=5, seed=0)


def render_golden() -> np.ndarray:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pbrt_tpu.core.spectrum import N_SPECTRUM
    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.render import render
    from pbrt_tpu.scenes.cornell import cornell_box

    if N_SPECTRUM != GOLDEN["n_spectrum"]:
        raise SystemExit(
            f"set PBRT_TPU_NSPECTRUM={GOLDEN['n_spectrum']} (got {N_SPECTRUM})"
        )
    scene, camera = cornell_box(resolution=GOLDEN["resolution"])
    img = render(
        scene.with_accel(), camera, PathIntegrator(max_depth=GOLDEN["max_depth"]),
        spp=GOLDEN["spp"], seed=GOLDEN["seed"],
        samples_per_pass=GOLDEN["samples_per_pass"],
    )
    return np.asarray(img, np.float32)


def main() -> None:
    sys.path.insert(0, ROOT)
    img = render_golden()
    if not np.all(np.isfinite(img)):
        raise SystemExit("golden render has non-finite pixels")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.save(OUT, img)
    print(f"wrote {OUT}: shape {img.shape}, mean {img.mean():.6f}")


if __name__ == "__main__":
    main()
