#!/usr/bin/env python
"""Render the JAX reference goldens of three golden scene files lit by
delta and image lights, which the PyTorch port's card renders are held
against: spot.pbrt (a spot light), envmap.pbrt (an image infinite light)
and plymesh.pbrt (a point and a uniform infinite light).

Each file through pbrt_tpu's parser at 32x32, 4 spp in one pass, 8
wavelength lanes, the file's integrator (depth 4, default Russian
roulette), the independent sampler, seed 0, rendered by pbrt_tpu on the
CPU with its dense triangle tester (plymesh.pbrt's cluster accelerator is
dropped: the Pallas kernel in interpret mode gives the same hits, slower),
and saved as (32, 32, 3) float32 arrays to
tests/data/torch_port/{spot,envmap,plymesh}32_spp4.npy. chip_smoke.py
phase d12 renders pbrt_tpu_torch on the GPU with the same settings and
compares.

Usage (from the repository root):
    JAX_PLATFORMS=cpu PBRT_TPU_NSPECTRUM=8 python scripts/make_torch_port_golden_lights.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "tests", "data", "torch_port")
FILES = ("spot", "envmap", "plymesh")

# The settings the goldens are rendered with; chip_smoke.py phase d12
# renders the port with the same ones.
GOLDEN = dict(resolution=(32, 32), spp=4, samples_per_pass=4, n_spectrum=8,
              seed=0)


def render_golden(name: str) -> np.ndarray:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pbrt_tpu.core.spectrum import N_SPECTRUM
    from pbrt_tpu.io.parser import load_pbrt
    from pbrt_tpu.render import render

    if N_SPECTRUM != GOLDEN["n_spectrum"]:
        raise SystemExit(
            f"set PBRT_TPU_NSPECTRUM={GOLDEN['n_spectrum']} (got {N_SPECTRUM})"
        )
    scene, camera, settings = load_pbrt(
        os.path.join(ROOT, "tests", "goldens", name + ".pbrt"))
    scene = scene.replace(clusters=None)
    img = render(
        scene, camera.replace(resolution=GOLDEN["resolution"]),
        settings["integrator"], spp=GOLDEN["spp"], seed=GOLDEN["seed"],
        samples_per_pass=GOLDEN["samples_per_pass"],
    )
    return np.asarray(img, np.float32)


def main() -> None:
    sys.path.insert(0, ROOT)
    os.makedirs(OUT_DIR, exist_ok=True)
    for name in FILES:
        t0 = time.perf_counter()
        img = render_golden(name)
        if not np.all(np.isfinite(img)):
            raise SystemExit(f"{name}: golden render has non-finite pixels")
        out = os.path.join(OUT_DIR, f"{name}32_spp4.npy")
        np.save(out, img)
        print(f"wrote {out}: shape {img.shape}, mean {img.mean():.6f}, "
              f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
