#!/usr/bin/env python
"""Render the JAX reference golden of the instanced field that the PyTorch
port's renders are held against.

tests/data/torch_port/instanced_field.pbrt (36 instances of a 81,920- and
a 40,320-triangle PLY prototype, written by pbrt_tpu's own mesh builders),
loaded by pbrt_tpu's parser (the sweep accelerator), rendered at 64x64, 4
spp in one pass, 8 wavelength lanes, the file's path integrator (depth 5,
default Russian roulette), seed 0, on the CPU (the sweep kernel in Pallas
interpret mode), and saved as a (64, 64, 3) float32 array to
tests/data/torch_port/instanced64_spp4.npy. chip_smoke.py phase (d3)
renders pbrt_tpu_torch on the GPU with the same settings and compares;
tests/test_torch_instanced.py compares a window of it on the CPU.

Usage (from the repository root):
    JAX_PLATFORMS=cpu PBRT_TPU_NSPECTRUM=8 python scripts/make_torch_port_golden_instanced.py
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port", "instanced64_spp4.npy")

# The settings the golden is rendered with; chip_smoke.py phase (d3) and
# tests/test_torch_instanced.py render the port with the same ones.
GOLDEN = dict(resolution=(64, 64), spp=4, samples_per_pass=4, n_spectrum=8,
              seed=0)


def render_golden() -> np.ndarray:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pbrt_tpu.core.spectrum import N_SPECTRUM
    from pbrt_tpu.io.parser import load_pbrt_string
    from pbrt_tpu.render import render
    from tests.torch_port_instanced import field_text, write_field_meshes

    if N_SPECTRUM != GOLDEN["n_spectrum"]:
        raise SystemExit(
            f"set PBRT_TPU_NSPECTRUM={GOLDEN['n_spectrum']} (got {N_SPECTRUM})"
        )
    with tempfile.TemporaryDirectory(prefix="instanced_field_") as tmp:
        write_field_meshes("pbrt_tpu", tmp)
        scene, camera, settings = load_pbrt_string(field_text(), tmp)
    assert scene.sweep is not None and scene.sweep.instanced
    img = render(
        scene, camera.replace(resolution=GOLDEN["resolution"]),
        settings["integrator"], spp=GOLDEN["spp"], seed=GOLDEN["seed"],
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
