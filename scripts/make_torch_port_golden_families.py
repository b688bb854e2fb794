#!/usr/bin/env python
"""Render the JAX reference goldens of the families box, which the
PyTorch port is held against.

The scene is tests/data/torch_port/families.pbrt (tests/goldens/box.pbrt's
room with hair, subsurface, measured, mix and retroreflective surfaces;
the measured wall reads the synthetic families.bsdf beside it), through
the reference's parser, with the file's integrator (path, depth 5), 8
wavelength lanes, seed 0, the mix materials keyed on the hit point and
wo rounded to a grid (tests/torch_port_families.py coarse_mix_keys: the
port is held against these goldens with the same keys). The reference
runs op by op (jax.disable_jit): its jitted trace rounds otherwise where
XLA fuses, and on this scene that alone moves 10 of the 512 samples of
the 16x16 pass past rtol 1e-3 and 23 queries' liveness (hair lobe picks,
measured-table cells, subsurface probes), while the op-by-op trace and
the port's agree on every value and every query.

- tests/data/torch_port/families32_spp4.npy: 32x32, 4 spp in one pass, a
  (32, 32, 3) float32 image. chip_smoke.py phase d22 holds the card
  against it.
- tests/data/torch_port/families16_samples.npz: the per-sample radiance
  (512, 8) and the traced ray count of one pass at 16x16, 2 spp, the
  reference's trace_with_stats. tests/test_torch_families.py holds
  the port's CPU trace against it.
- tests/data/torch_port/kind8_volpath8_samples.npz: the per-sample
  radiance (128, 8) and ray count of tests/torch_port_families.py's
  SUBSURFACE_VOLPATH (a subsurface floor, the file's volpath integrator,
  depth 3) at 8x8, 2 spp: the reference's volpath has no subsurface step,
  so its kind-8 lanes shade with the normalized-Fresnel lobe.

The reference runs on the CPU with its dense triangle tester. Usage (from
the repository root):
    JAX_PLATFORMS=cpu PBRT_TPU_NSPECTRUM=8 python scripts/make_torch_port_golden_families.py
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "tests", "data", "torch_port")
SCENE_FILE = os.path.join(OUT_DIR, "families.pbrt")

# The settings of the goldens; the tests and chip_smoke.py read them back
# from the files.
IMAGE = dict(resolution=32, spp=4, n_spectrum=8, seed=0)
SAMPLES = dict(resolution=16, spp=2, n_spectrum=8, seed=0)


def _scene(res: int):
    """The reference's (scene, camera, integrator), no accelerator."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pbrt_tpu.core.spectrum import N_SPECTRUM
    from pbrt_tpu.io.parser import load_pbrt

    if N_SPECTRUM != IMAGE["n_spectrum"]:
        raise SystemExit(
            f"set PBRT_TPU_NSPECTRUM={IMAGE['n_spectrum']} (got {N_SPECTRUM})")
    scene, camera, settings = load_pbrt(SCENE_FILE)
    scene = scene.replace(small=None, clusters=None)
    return scene, camera.replace(resolution=(res, res)), settings["integrator"]


@contextlib.contextmanager
def _reference_mode():
    """Coarse mix keys, op by op."""
    import jax

    from pbrt_tpu.materials import bxdf
    from tests.torch_port_families import coarse_mix_keys

    with coarse_mix_keys(bxdf), jax.disable_jit():
        yield


def render_image() -> np.ndarray:
    from pbrt_tpu.render import render

    g = IMAGE
    scene, camera, integ = _scene(g["resolution"])
    with _reference_mode():
        img = render(scene, camera, integ, spp=g["spp"], seed=g["seed"],
                     samples_per_pass=g["spp"])
    return np.asarray(img, np.float32)


def trace_samples() -> dict:
    import jax.numpy as jnp

    from pbrt_tpu.render import camera_rays_full

    g = SAMPLES
    res, spp = g["resolution"], g["spp"]
    scene, camera, integ = _scene(res)
    npix = res * res
    pixel = jnp.tile(jnp.arange(npix, dtype=jnp.int32), spp)
    sample = jnp.repeat(jnp.arange(spp, dtype=jnp.int32), npix)
    o, d, wl, _ = camera_rays_full(camera, pixel, sample, g["seed"])
    with _reference_mode():
        L, stats = integ.trace_with_stats(scene, o, d, wl, pixel, sample,
                                          g["seed"])
    return {"radiance": np.asarray(L, np.float32),
            "rays": np.float32(stats["rays"]),
            "max_depth": np.int32(integ.max_depth),
            **{k: np.asarray(v) for k, v in g.items()}}


def trace_volpath_kind8() -> dict:
    import jax.numpy as jnp

    from pbrt_tpu.io.parser import load_pbrt_string
    from pbrt_tpu.render import camera_rays_full
    from tests.torch_port_families import SUBSURFACE_VOLPATH

    g = dict(SAMPLES, resolution=8)
    scene, camera, settings = load_pbrt_string(SUBSURFACE_VOLPATH)
    scene = scene.replace(small=None, clusters=None)
    integ = settings["integrator"]
    npix = g["resolution"] ** 2
    pixel = jnp.tile(jnp.arange(npix, dtype=jnp.int32), g["spp"])
    sample = jnp.repeat(jnp.arange(g["spp"], dtype=jnp.int32), npix)
    o, d, wl, _ = camera_rays_full(camera, pixel, sample, g["seed"])
    with _reference_mode():
        L, stats = integ.trace_with_stats(scene, o, d, wl, pixel, sample,
                                          g["seed"])
    return {"radiance": np.asarray(L, np.float32),
            "rays": np.float32(stats["rays"]),
            **{k: np.asarray(v) for k, v in g.items()}}


def main() -> None:
    sys.path.insert(0, ROOT)
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    out = trace_samples()
    path = os.path.join(OUT_DIR, "families16_samples.npz")
    np.savez(path, **out)
    print(f"wrote {path}: mean {out['radiance'].mean():.6f}, rays "
          f"{float(out['rays'])}, {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out = trace_volpath_kind8()
    path = os.path.join(OUT_DIR, "kind8_volpath8_samples.npz")
    np.savez(path, **out)
    print(f"wrote {path}: mean {out['radiance'].mean():.6f}, rays "
          f"{float(out['rays'])}, {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    img = render_image()
    if not np.all(np.isfinite(img)):
        raise SystemExit("the golden render has non-finite pixels")
    path = os.path.join(OUT_DIR, "families32_spp4.npy")
    np.save(path, img)
    print(f"wrote {path}: mean {img.mean():.6f}, "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
