#!/usr/bin/env python
"""Render the JAX reference goldens of the light-tracing and specialty
integrators, which the PyTorch port is held against.

Scenes: tests/goldens/bdpt.pbrt's room (an indirect-lit box, a quad light
facing the ceiling), sppm.pbrt (a glass sphere's caustic) and mlt.pbrt
(the room again), through the reference's parser, no accelerator attached
(the reference's dense tester answers), 8 wavelength lanes, seed 0.

- lightpath16_lanes.npz: one LightPathIntegrator.render_splats pass of
  256 paths (sample 0, depth 5) on the room at 16x16: every connection's
  per-lane pixel and RGB contribution ("pix" (6, 256), "contrib" (6, 256,
  3); connection 0 is the light's own point, then one a bounce) and the
  pass's splat image. Recorded op by op (jax.disable_jit) at the
  scatter-adds.
- lightpath16_spp4.npy: render_lightpath at 16x16, 4 passes of 256 paths
  (chip_smoke.py phase d24).
- bdpt16_samples.npz: BDPTIntegrator.trace of samples 0 and 1 on the room
  at 16x16 (depth 5): "L" (2, 256, 8), the t >= 2 radiance, and "splat"
  (2, 256, 3), the t = 1 splats, held separately.
- bdpt16_spp4.npy: render_bdpt at 16x16, 4 spp (phase d24).
- sppm16.npz: on sppm.pbrt at 16x16 (its radius 0.08), 4,096 photons an
  iteration (the file's default, one a pixel, deposits twice at 16x16):
  iteration 0's camera pass (visible points "vp_p", "vp_set", "vp_beta", "Ld"), its
  photon pass ("phi", "m", "overflow"), and after 4 iterations the radii
  ("radius4"), n ("n4") and the image ("image4").
- mlt16.npz: MLTIntegrator(PathIntegrator(5), 64 chains, 8 steps) on
  mlt.pbrt's room at 16x16: the bootstrap's b and chain starts "u0" (64,
  48, 2), the acceptance of each chain at steps 0-3 ("accepted" (4, 64),
  recorded op by op at the acceptance select) and the image ("image").
- ao16.npz: per-sample radiance (512, 8) of AOIntegrator and
  RandomWalkIntegrator(max_depth 5) traces on the room at 16x16, 2 spp
  ("ao", "randomwalk"), and render() images at 16x16, 4 spp ("ao_image",
  "randomwalk_image"; phase d24 holds the AO one).
- spectral16.npz: render_spectral on the room at 16x16, 4 bands, 2 spp a
  band, depth 3: "rgb" (16, 16, 3) and "bands" (16, 16, 4) (phase d24).
- function8.npz: FunctionIntegrator.render of every test function at
  8x8, 4 spp, with its exact integral.

Usage (from the repository root; ~3 minutes; name parts to make only
those: lightpath, bdpt, sppm, mlt, ao, spectral, function):
    JAX_PLATFORMS=cpu PBRT_TPU_NSPECTRUM=8 python scripts/make_torch_port_golden_lighttransport.py [part ...]
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "tests", "data", "torch_port")
GOLDEN_FILES = os.path.join(ROOT, "tests", "goldens")

# The settings of the goldens; the tests and chip_smoke.py read them back
# from the files.
G = dict(resolution=16, n_spectrum=8, seed=0, max_depth=5)
LIGHTPATH = dict(paths_per_pass=256, passes=4)
BDPT = dict(samples=2, spp=4)
SPPM = dict(iterations=4, photons=4096)
MLT = dict(chains=64, steps=8, checked_steps=4)
AO = dict(spp_samples=2, spp_image=4)
SPECTRAL = dict(n_bands=4, spp_per_band=2, max_depth=3)
FUNCTION = dict(resolution=8, spp=4)


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pbrt_tpu.core.spectrum import N_SPECTRUM

    if N_SPECTRUM != G["n_spectrum"]:
        raise SystemExit(
            f"set PBRT_TPU_NSPECTRUM={G['n_spectrum']} (got {N_SPECTRUM})")
    return jax


def load(name: str, res: int = G["resolution"]):
    """(scene, camera, settings) of a golden file, no accelerator."""
    from pbrt_tpu.io.parser import load_pbrt

    scene, camera, settings = load_pbrt(os.path.join(GOLDEN_FILES,
                                                     name + ".pbrt"))
    return (scene.replace(small=None, clusters=None),
            camera.replace(resolution=(res, res)), settings)


@contextlib.contextmanager
def recorded_scatter_adds(sink: list):
    """Record (index, values) of every x.at[index].add(values)."""
    from jax._src.numpy import array_methods

    add = array_methods._IndexUpdateRef.add

    def recording(self, values, **kw):
        sink.append((np.asarray(self.index), np.asarray(values)))
        return add(self, values, **kw)

    array_methods._IndexUpdateRef.add = recording
    try:
        yield
    finally:
        array_methods._IndexUpdateRef.add = add


def lightpath() -> dict:
    jax = _jax()
    import jax.numpy as jnp

    from pbrt_tpu.core import spectrum
    from pbrt_tpu.models.lightpath import LightPathIntegrator, render_lightpath
    from pbrt_tpu.samplers.samplers import Sampler

    scene, camera, _ = load("bdpt")
    n = LIGHTPATH["paths_per_pass"]
    sampler = Sampler.create("independent", spp=1, seed=G["seed"])
    wl = spectrum.sample_visible(
        sampler.get_1d(jnp.arange(n, dtype=jnp.int32), 0, 5))
    adds = []
    with jax.disable_jit(), recorded_scatter_adds(adds):
        img = LightPathIntegrator(max_depth=G["max_depth"]).render_splats(
            scene, camera, n, wl, jnp.int32(0), sampler)
    lanes = {"pix": np.stack([a[0] for a in adds]).astype(np.int32),
             "contrib": np.stack([a[1] for a in adds]).astype(np.float32),
             "image": np.asarray(img, np.float32)}
    image = render_lightpath(
        scene, camera, n_paths_total=n * LIGHTPATH["passes"],
        max_depth=G["max_depth"], seed=G["seed"], paths_per_pass=n)
    return lanes, np.asarray(image, np.float32)


def bdpt() -> tuple:
    jax = _jax()
    import jax.numpy as jnp

    from pbrt_tpu.core import spectrum
    from pbrt_tpu.models.bdpt import BDPTIntegrator, render_bdpt
    from pbrt_tpu.samplers.samplers import Sampler

    scene, camera, _ = load("bdpt")
    res = G["resolution"]
    pixel = jnp.arange(res * res, dtype=jnp.int32)
    sampler = Sampler.create("independent", spp=BDPT["spp"], seed=G["seed"],
                             nx=res)
    integ = BDPTIntegrator(max_depth=G["max_depth"])

    @jax.jit
    def one(scene, s):
        wl = spectrum.sample_visible(sampler.get_1d(pixel, s, 4))
        L, splat, _ = integ.trace(scene, camera, wl, pixel, s, sampler)
        return L, splat

    Ls, splats = zip(*(one(scene, jnp.int32(s))
                       for s in range(BDPT["samples"])))
    samples = {"L": np.asarray(Ls, np.float32),
               "splat": np.asarray(splats, np.float32)}
    image = render_bdpt(scene, camera, spp=BDPT["spp"],
                        max_depth=G["max_depth"], seed=G["seed"])
    return samples, np.asarray(image, np.float32)


def sppm() -> dict:
    jax = _jax()
    import jax.numpy as jnp

    from pbrt_tpu.core import spectrum

    scene, camera, settings = load("sppm")
    integ = settings["integrator"].replace(photons_per_iteration=SPPM["photons"])
    res = G["resolution"]
    npix = res * res
    hash_size = 1 << max(8, int(np.ceil(np.log2(2 * npix))))
    radius = jnp.full((npix,), integ.initial_radius, jnp.float32)

    @jax.jit
    def first(scene):
        wl = spectrum.sample_visible(jnp.full((npix,), jnp.float32(0.5)))
        cam = integ._camera_pass(scene, camera, wl, jnp.int32(0),
                                 jnp.int32(G["seed"]))
        grid = integ._build_grid(cam["vp_p"], radius, cam["vp_set"],
                                 hash_size)
        phi, m, overflow = integ._photon_pass(
            scene, wl, grid, cam, radius, jnp.int32(0),
            jnp.int32(G["seed"]) + 1, hash_size)
        return cam, phi, m, overflow

    cam, phi, m, overflow = first(scene)
    img, stats = integ.render(scene, camera, n_iterations=SPPM["iterations"],
                              seed=G["seed"], return_stats=True)
    return {"vp_p": np.asarray(cam["vp_p"]), "vp_set": np.asarray(cam["vp_set"]),
            "vp_beta": np.asarray(cam["vp_beta"]), "Ld": np.asarray(cam["Ld"]),
            "phi": np.asarray(phi), "m": np.asarray(m),
            "overflow": np.int64(overflow),
            "radius4": np.asarray(stats["radius"]),
            "n4": np.asarray(stats["n"]),
            "image4": np.asarray(img, np.float32)}


class _RecordingJnp:
    """jax.numpy with `where` recording the chains' acceptance selects
    (a (N, 1, 1) condition over the (N, D, 2) samples)."""

    def __init__(self, jnp, sink):
        self._jnp, self._sink = jnp, sink

    def __getattr__(self, name):
        return getattr(self._jnp, name)

    def where(self, cond, *args):
        if getattr(cond, "ndim", 0) == 3 and args and args[0].ndim == 3:
            self._sink.append(np.asarray(cond)[:, 0, 0])
        return self._jnp.where(cond, *args)


def mlt() -> dict:
    jax = _jax()
    import jax.numpy as jnp

    from pbrt_tpu.models import mlt as mlt_mod
    from pbrt_tpu.models.path import PathIntegrator

    scene, camera, _ = load("mlt")
    integ = mlt_mod.MLTIntegrator(base=PathIntegrator(max_depth=G["max_depth"]),
                                  n_chains=MLT["chains"],
                                  mutations_per_chain=MLT["steps"])
    b, u0 = integ._bootstrap(scene, camera, G["seed"])
    image = integ.render(scene, camera, seed=G["seed"])
    # The acceptance of the first steps, op by op: every select over the
    # samples is is_large's (the proposal) or the acceptance; the
    # acceptance is the second of each step.
    sink = []
    mlt_mod.jnp = _RecordingJnp(jnp, sink)
    try:
        short = integ.replace(mutations_per_chain=MLT["checked_steps"])
        with jax.disable_jit():
            short.render(scene, camera, seed=G["seed"])
    finally:
        mlt_mod.jnp = jnp
    accepted = np.stack(sink[1::2]).astype(bool)
    return {"b": np.float64(b), "u0": np.asarray(u0, np.float32),
            "accepted": accepted, "image": np.asarray(image, np.float32)}


def ao() -> dict:
    jax = _jax()
    import jax.numpy as jnp

    from pbrt_tpu.models.ao import AOIntegrator, RandomWalkIntegrator
    from pbrt_tpu.render import camera_rays_full, render

    scene, camera, _ = load("bdpt")
    res, spp = G["resolution"], AO["spp_samples"]
    npix = res * res
    pixel = jnp.tile(jnp.arange(npix, dtype=jnp.int32), spp)
    sample = jnp.repeat(jnp.arange(spp, dtype=jnp.int32), npix)
    o, d, wl, _ = camera_rays_full(camera, pixel, sample, G["seed"])
    out = {}
    for name, integ in (("ao", AOIntegrator()),
                        ("randomwalk",
                         RandomWalkIntegrator(max_depth=G["max_depth"]))):
        L = jax.jit(lambda s, o, d, wl: integ.trace(
            s, o, d, wl, pixel, sample, G["seed"]))(scene, o, d, wl)
        out[name] = np.asarray(L, np.float32)
        out[name + "_image"] = np.asarray(render(
            scene, camera, integ, spp=AO["spp_image"], seed=G["seed"],
            samples_per_pass=AO["spp_image"]), np.float32)
    return out


def spectral() -> dict:
    _jax()
    from pbrt_tpu.models.spectralpath import render_spectral

    scene, camera, _ = load("bdpt")
    rgb, bands = render_spectral(
        scene, camera, n_bands=SPECTRAL["n_bands"],
        spp_per_band=SPECTRAL["spp_per_band"], seed=G["seed"],
        max_depth=SPECTRAL["max_depth"])
    return {"rgb": np.asarray(rgb, np.float32),
            "bands": np.asarray(bands, np.float32)}


def function() -> dict:
    _jax()
    from pbrt_tpu.models.function import _FUNCTIONS, FunctionIntegrator

    res = FUNCTION["resolution"]
    out = {}
    for name in _FUNCTIONS:
        est, exact = FunctionIntegrator(func=name).render(
            (res, res), spp=FUNCTION["spp"], seed=G["seed"])
        out[name] = np.asarray(est, np.float32)
        out[name + "_exact"] = np.float64(exact)
    return out


def main() -> int:
    os.makedirs(OUT_DIR, exist_ok=True)

    def save(name, **arrays):
        np.savez_compressed(os.path.join(OUT_DIR, name), **arrays,
                            **{f"cfg_{k}": v for k, v in G.items()})

    parts = set(sys.argv[1:]) or {"lightpath", "bdpt", "sppm", "mlt", "ao",
                                   "spectral", "function"}
    if "lightpath" in parts:
        lanes, image = lightpath()
        save("lightpath16_lanes.npz", **lanes,
             paths=LIGHTPATH["paths_per_pass"])
        np.save(os.path.join(OUT_DIR, "lightpath16_spp4.npy"), image)
    if "bdpt" in parts:
        samples, image = bdpt()
        save("bdpt16_samples.npz", **samples)
        np.save(os.path.join(OUT_DIR, "bdpt16_spp4.npy"), image)
    if "sppm" in parts:
        save("sppm16.npz", **sppm(), iterations=SPPM["iterations"],
             photons=SPPM["photons"])
    if "mlt" in parts:
        save("mlt16.npz", **mlt(), chains=MLT["chains"], steps=MLT["steps"])
    if "ao" in parts:
        save("ao16.npz", **ao(), spp_samples=AO["spp_samples"],
             spp_image=AO["spp_image"])
    if "spectral" in parts:
        save("spectral16.npz", **spectral(), n_bands=SPECTRAL["n_bands"],
             spp_per_band=SPECTRAL["spp_per_band"],
             spectral_max_depth=SPECTRAL["max_depth"])
    if "function" in parts:
        save("function8.npz", **function(), resolution=FUNCTION["resolution"],
             spp=FUNCTION["spp"])
    for name in sorted(os.listdir(OUT_DIR)):
        if name.split("1")[0] in ("lightpath", "bdpt", "sppm", "mlt", "ao",
                                  "spectral", "function8.npz"):
            print(name, os.path.getsize(os.path.join(OUT_DIR, name)))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
