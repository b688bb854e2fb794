#!/usr/bin/env python
"""Render the JAX reference goldens of the cameras, films, filters and
samplers, which the PyTorch port is held against (its tests on the CPU,
chip_smoke.py's d26 and d27 on the card).

The scenes and settings are tests/torch_port_cameras.py's: the Cornell
box through each camera family, the reference's dense tester answering
(no accelerator), 8 wavelength lanes, seed 0.

- cameras32.npz: for each of lens, omni, ortho, spherical and rtf, the
  render() image at 32 x 32, 4 spp in one pass, depth 5, with its sampler
  and filter ("<name>"), its share of camera rays with weight > 0
  ("<name>_share") and its mean ("<name>_mean"); the eye's
  render_spectral (4 bands x 2 spp) "eye_rgb" and "eye_bands"; every
  channel of render_aovs of the Cornell box's perspective camera (4 spp,
  8 spectral buckets) as "aov_<channel>"; and the reference's host data
  the port carries across: the doublet's exit-pupil bounds
  ("lens_pupil_bounds") and the RTF fit ("rtf_coeffs", "rtf_powers",
  "rtf_front_z_mm", "rtf_pupil_radius_mm").
- sppm_ortho16.npz: SPPMIntegrator.render of the Cornell box through the
  orthographic camera at 16 x 16 (SPPM_CFG: 2 iterations of 4,096
  photons, depth 5, seed 0): the image ("image"), the radii ("radius")
  and the photon counts n ("n").
- sampler_draws.npz: for each sampler kind and settings a and b, the
  jitted get_1d and get_2d of dimensions 0-40 at 4,096 lanes: the sha256
  prefix of every draw's float32 bits ("<kind>_<cfg>_digest", (123,))
  and the first 64 lanes whole ("<kind>_<cfg>_head", (123, 64)).

Usage (from the repository root; ~5 minutes; name parts to make only
those: cameras, sppm, samplers):
    JAX_PLATFORMS=cpu PBRT_TPU_NSPECTRUM=8 python scripts/make_torch_port_golden_cameras.py [part ...]
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_port_cameras as C  # noqa: E402


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pbrt_tpu.core.spectrum import N_SPECTRUM

    if N_SPECTRUM != C.CFG["n_spectrum"]:
        raise SystemExit(f"set PBRT_TPU_NSPECTRUM={C.CFG['n_spectrum']} "
                         f"(got {N_SPECTRUM})")
    # The pmj02 tables' cache must hold concrete arrays before any trace.
    from pbrt_tpu.samplers.samplers import _pmj_tables

    _pmj_tables()
    return jax


def _cornell():
    from pbrt_tpu.scenes.cornell import cornell_box

    scene, camera = cornell_box(resolution=(C.CFG["res"], C.CFG["res"]))
    return scene, camera


def cameras() -> dict:
    jax = _jax()
    import jax.numpy as jnp

    from pbrt_tpu.films.gbuffer import render_aovs
    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.models.spectralpath import render_spectral
    from pbrt_tpu.render import camera_rays_full, render
    from pbrt_tpu.samplers.samplers import Sampler

    scene, persp = _cornell()
    res, spp = C.CFG["res"], C.CFG["spp"]
    integ = PathIntegrator(max_depth=C.CFG["max_depth"])
    out = {}
    for name, (kind, filt) in C.RENDERS.items():
        cam = C.CAMERAS[name]("pbrt_tpu", res)
        if name == "lens":
            out["lens_pupil_bounds"] = np.asarray(cam.pupil_bounds, np.float32)
        if name == "rtf":
            out["rtf_coeffs"] = np.asarray(cam.coeffs, np.float32)
            out["rtf_powers"] = np.asarray(cam.powers, np.int32)
            out["rtf_front_z_mm"] = np.float32(cam.front_z_mm)
            out["rtf_pupil_radius_mm"] = np.float32(cam.pupil_radius_mm)
        kw = dict(spp=spp, seed=C.CFG["seed"], samples_per_pass=spp,
                  sampler_kind=kind, filter_kind=filt)
        if name == "rtf":
            # The reference's RTF camera reads its powers with np.asarray,
            # which fails on the traced camera of the jitted render
            # (pbrt_tpu/cameras/rtf.py:55): trace the render with the
            # camera closed over, a constant.
            img = jax.jit(lambda sc: render.__wrapped__(sc, cam, integ, **kw))(
                scene)
        else:
            img = render(scene, cam, integ, **kw)
        sampler = Sampler.create(kind, spp=spp, seed=C.CFG["seed"], nx=res,
                                 log2_res=max(1, (res - 1).bit_length()))
        pixel = jnp.tile(jnp.arange(res * res, dtype=jnp.int32), (spp,))
        sample = jnp.repeat(jnp.arange(spp, dtype=jnp.int32), res * res)
        _, _, _, w = jax.jit(lambda p, s: camera_rays_full(
            cam, p, s, sampler))(pixel, sample)
        out[name] = np.asarray(img, np.float32)
        out[name + "_share"] = np.float32(np.mean(np.asarray(w) > 0))
        out[name + "_mean"] = np.float32(out[name].mean())
        print(f"{name}: mean {out[name].mean():.6f}, weight > 0 on "
              f"{out[name + '_share']:.4f} of the rays", flush=True)
    rgb, bands = render_spectral(scene, C.eye_factory("pbrt_tpu", res),
                                 seed=C.CFG["seed"], **C.EYE_CFG)
    out["eye_rgb"] = np.asarray(rgb, np.float32)
    out["eye_bands"] = np.asarray(bands, np.float32)
    print(f"eye: mean {out['eye_rgb'].mean():.6f}", flush=True)
    aovs = render_aovs(scene, persp, integ, seed=C.CFG["seed"], **C.AOV_CFG)
    for k, v in aovs.items():
        out["aov_" + k] = np.asarray(v, np.float32)
    return out


def sppm() -> dict:
    _jax()
    from pbrt_tpu.models.sppm import SPPMIntegrator

    scene, _ = _cornell()
    cfg = C.SPPM_CFG
    integ = SPPMIntegrator(max_depth=cfg["max_depth"],
                           photons_per_iteration=cfg["photons"])
    img, stats = integ.render(scene, C.ortho_camera("pbrt_tpu", cfg["res"]),
                              n_iterations=cfg["iterations"],
                              seed=cfg["seed"], return_stats=True)
    out = {"image": np.asarray(img, np.float32),
           "radius": np.asarray(stats["radius"], np.float32),
           "n": np.asarray(stats["n"], np.float32)}
    print(f"sppm_ortho: mean {out['image'].mean():.6f}", flush=True)
    return out


def samplers() -> dict:
    jax = _jax()
    import jax.numpy as jnp

    from pbrt_tpu.samplers.samplers import Sampler

    out = {}
    for cfg_name in ("a", "b"):
        cfg = C.SAMPLER_CFGS[cfg_name]
        pixel, sample = C.draw_lanes(C.DRAW_LANES, cfg)
        for kind in C.SAMPLER_KINDS:
            s = Sampler.create(kind, spp=cfg["spp"], seed=cfg["seed"],
                               nx=cfg["nx"], log2_res=cfg["log2_res"])
            vals = jax.jit(lambda p, q: jnp.stack(C.draws(s, p, q)))(
                jnp.asarray(pixel), jnp.asarray(sample))
            vals = np.asarray(vals, np.float32)
            out[f"{kind}_{cfg_name}_digest"] = C.digests(vals)
            out[f"{kind}_{cfg_name}_head"] = vals[:, :C.DRAW_KEEP]
            print(f"{kind} {cfg_name}: done", flush=True)
    return out


def main() -> None:
    parts = sys.argv[1:] or ["cameras", "sppm", "samplers"]
    if "cameras" in parts:
        out = cameras()
        if not all(np.all(np.isfinite(v)) for v in out.values()
                   if np.asarray(v).dtype.kind == "f"):
            raise SystemExit("non-finite camera golden")
        np.savez(C.GOLDEN, **out)
        print(f"wrote {C.GOLDEN}")
    if "sppm" in parts:
        out = sppm()
        if not all(np.all(np.isfinite(v)) for v in out.values()):
            raise SystemExit("non-finite SPPM golden")
        np.savez(C.SPPM_GOLDEN, **out)
        print(f"wrote {C.SPPM_GOLDEN}")
    if "samplers" in parts:
        np.savez(C.SAMPLER_GOLDEN, **samplers())
        print(f"wrote {C.SAMPLER_GOLDEN}")


if __name__ == "__main__":
    main()
