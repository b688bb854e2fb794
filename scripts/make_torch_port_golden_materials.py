#!/usr/bin/env python
"""Render the JAX reference goldens of the four golden scene files that
need the dielectric BxDFs or the textures, which the PyTorch port's card
renders are held against: dielectric.pbrt (a rough glass and a thin
dielectric sphere), spheres.pbrt (a smooth glass sphere), texture.pbrt (a
checkerboard floor and a scaled checkerboard sphere) and imagetex.pbrt (a
PFM image texture).

Each file with the settings of scripts/make_torch_port_golden_lights.py
(its render_golden: 32x32, 4 spp in one pass, 8 wavelength lanes, the
file's integrator, seed 0, pbrt_tpu on the CPU with its dense triangle
tester), saved as (32, 32, 3) float32 arrays to
tests/data/torch_port/{dielectric,spheres,texture,imagetex}32_spp4.npy.
chip_smoke.py phase d17 renders pbrt_tpu_torch on the GPU with the same
settings and compares.

Usage (from the repository root):
    JAX_PLATFORMS=cpu PBRT_TPU_NSPECTRUM=8 python scripts/make_torch_port_golden_materials.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("dielectric", "spheres", "texture", "imagetex")


def main() -> None:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from make_torch_port_golden_lights import OUT_DIR, render_golden

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
