#!/usr/bin/env python
"""Compute the JAX reference's image-loss gradients the PyTorch port is
held against.

The loss is bench.py's cornell_fwdbwd loss: the mean squared error of
spectrum_to_rgb against 0.25, 8 wavelength lanes, seed 0, path depth 5
without Russian roulette (rr_start_depth=5), small-scene accelerator
attached. pbrt_tpu runs on the CPU. Each golden is one --which:

- "cornell" (the default): the Cornell box (diffuse), 32x32, 4 spp in
  passes of 2, the reference's default gradient path (grad_mode="remat").
  Each pass's loss and its gradients with respect to
  materials.albedo_coeffs (5, 3) and lights.area_scale (2,) come from one
  jax.value_and_grad; the file holds their means over the passes and the
  settings, in tests/data/torch_port/cornell32_grad.npz. chip_smoke.py
  phase g computes the same on the card with pbrt_tpu_torch.
- "modes": tests/data/torch_port/grad_modes16.npz, 16x16, 2 spp in one
  pass (tests/torch_port_grad.py builds the same scenes in the port):
  - the textured Cornell box of tests/test_gradients.py's texel test
    (a 4x4 image texture on material 0): the loss and its gradients with
    respect to albedo_coeffs, area_scale and textures.img_flat under
    grad_mode="remat" (keys "remat_*") and under grad_mode="cvjp" with
    each replay_remat ("cvjp_full_*", "cvjp_dots_*", "cvjp_none_*");
  - the Cornell box with material 1 a rough dielectric (roughness 0.25,
    eta 1.5; tests/test_gradients.py's IOR test) under the attached
    estimator (replay_grad=False): albedo_coeffs, area_scale and
    materials.eta ("attached_*").
  chip_smoke.py phases g8-g10 hold the card against these.
- "families": tests/data/torch_port/families16_grad.npz, the families box
  (tests/data/torch_port/families.pbrt, the file's integrator: path,
  depth 5; its subsurface block makes the reference's estimator the
  attached one) at 16x16, 2 spp, with the mix materials on coarse keys
  and op by op, as the families goldens are made
  (scripts/make_torch_port_golden_families.py): albedo_coeffs and
  area_scale. chip_smoke.py phase g11 holds the card against it.

Under the attached estimator the gradient follows the sampled directions
into the next hit point, so how the queries are differentiated matters.
The reference's accelerator queries are detached (ops/detach.py), but on
the CPU its small-scene tier is answered by the dense tester, which is
not; the script wraps that query in jax.lax.stop_gradient, so that the
hit points move as p = o + t d with t fixed, as on the reference's
accelerator and in the port. The attached goldens are forward-mode
derivatives (jax.jacfwd): the reference's reverse mode answers NaN for
some entries (0 * inf through a where on lanes that miss, or whose
sample failed; ROADMAP Queue 3). Each file records, per leaf, whether the
reverse-mode gradient was finite ("reverse_finite_*").

Usage (from the repository root; "cornell" ~30 s, "modes" ~4 min,
"families" ~4 min):
    JAX_PLATFORMS=cpu PBRT_TPU_NSPECTRUM=8 python scripts/make_torch_port_golden_grad.py [--which cornell|modes|families]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "torch_port")
OUT = os.path.join(DATA, "cornell32_grad.npz")
OUT_MODES = os.path.join(DATA, "grad_modes16.npz")
OUT_FAMILIES = os.path.join(DATA, "families16_grad.npz")

# The settings of the golden; chip_smoke.py phase g reads them back from
# the file.
GOLDEN = dict(resolution=32, spp=4, samples_per_pass=2, n_spectrum=8,
              max_depth=5, rr_start_depth=5, seed=0, target=0.25)
# The settings of the modes and families goldens (one pass).
SMALL = dict(resolution=16, spp=2, n_spectrum=8, max_depth=5,
             rr_start_depth=5, seed=0, target=0.25)
# The textured box's leaves and the dielectric box's.
TEXEL_LEAVES = ("materials.albedo_coeffs", "lights.area_scale",
                "textures.img_flat")
ATTACHED_LEAVES = ("materials.albedo_coeffs", "lights.area_scale",
                   "materials.eta")
DEFAULT_LEAVES = ("materials.albedo_coeffs", "lights.area_scale")
# (key prefix, PathIntegrator keywords) of the textured box's estimators.
TEXEL_MODES = (("remat", {}),
               ("cvjp_full", {"grad_mode": "cvjp", "replay_remat": "full"}),
               ("cvjp_dots", {"grad_mode": "cvjp", "replay_remat": "dots"}),
               ("cvjp_none", {"grad_mode": "cvjp", "replay_remat": "none"}))


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pbrt_tpu.core.spectrum import N_SPECTRUM

    if N_SPECTRUM != GOLDEN["n_spectrum"]:
        raise SystemExit(
            f"set PBRT_TPU_NSPECTRUM={GOLDEN['n_spectrum']} (got {N_SPECTRUM})"
        )
    return jax


def golden_grad() -> dict:
    jax = _jax()
    import jax.numpy as jnp

    from pbrt_tpu.films.rgb import spectrum_to_rgb
    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.render import camera_rays
    from pbrt_tpu.scenes.cornell import cornell_box

    g = GOLDEN
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


def _get(scene, path):
    obj = scene
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _set(scene, updates):
    by_child = {}
    for path, value in updates.items():
        child, leaf = path.split(".", 1)
        by_child.setdefault(child, {})[leaf] = value
    return scene.replace(**{c: getattr(scene, c).replace(**v)
                            for c, v in by_child.items()})


@contextlib.contextmanager
def detached_queries():
    """The reference's triangle queries with stop_gradient on o, d and
    tmax, as its accelerator tiers answer them (ops/detach.py)."""
    import jax

    from pbrt_tpu.accel import api

    once = api._tri_closest_once

    def detached(scene, o, d, tmax):
        sg = jax.lax.stop_gradient
        return once(scene, sg(o), sg(d), sg(tmax))

    api._tri_closest_once = detached
    try:
        yield
    finally:
        api._tri_closest_once = once


def _loss_fn(scene, camera, integrator, g):
    """loss(params) for {dotted path: value}: the bench loss of one pass
    of g's shape."""
    import jax.numpy as jnp

    from pbrt_tpu.films.rgb import spectrum_to_rgb
    from pbrt_tpu.render import camera_rays

    res, spp = g["resolution"], g["spp"]
    npix = res * res
    pixel = jnp.tile(jnp.arange(npix, dtype=jnp.int32), (spp,))
    sample = jnp.repeat(jnp.arange(spp, dtype=jnp.int32), npix)
    target = jnp.full((npix * spp, 3), g["target"], jnp.float32)
    seed = jnp.int32(g["seed"])

    def loss(params):
        s = _set(scene, params)
        o, d, wl = camera_rays(camera, pixel, sample, seed)
        radiance = integrator.trace(s, o, d, wl, pixel, sample, seed)
        return jnp.mean((spectrum_to_rgb(radiance, wl) - target) ** 2)

    return loss


def _gradients(prefix, scene, camera, integrator, leaves, forward_mode,
               jit=True) -> dict:
    """{prefix_loss, prefix_grad_<leaf>, prefix_reverse_finite_<leaf>}:
    reverse mode, or forward mode where `forward_mode`."""
    import jax

    g = SMALL
    loss = _loss_fn(scene, camera, integrator, g)
    params = {p: _get(scene, p) for p in leaves}
    maybe_jit = jax.jit if jit else (lambda f: f)
    t0 = time.perf_counter()
    value, rev = maybe_jit(jax.value_and_grad(loss))(params)
    out = {f"{prefix}_loss": np.float32(value)}
    fwd = maybe_jit(jax.jacfwd(loss))(params) if forward_mode else None
    for p in leaves:
        key = p.split(".")[-1]
        r = np.asarray(rev[p], np.float32)
        out[f"{prefix}_reverse_finite_{key}"] = np.bool_(np.isfinite(r).all())
        out[f"{prefix}_grad_{key}"] = (np.asarray(fwd[p], np.float32)
                                       if forward_mode else r)
    print(f"{prefix}: loss {float(value):.6f}, "
          f"{time.perf_counter() - t0:.1f} s, reverse finite "
          f"{[bool(out[f'{prefix}_reverse_finite_' + p.split('.')[-1]]) for p in leaves]}",
          flush=True)
    return out


def texel_cornell(res: int):
    """tests/test_gradients.py's textured Cornell box (a 4x4 image
    texture, seed 3, on material 0), accelerator attached."""
    import jax.numpy as jnp

    from pbrt_tpu.scenes.cornell import cornell_box
    from pbrt_tpu.textures.buffers import TextureBuffers

    scene, camera = cornell_box(resolution=(res, res))
    rng = np.random.default_rng(3)
    tex_rgb = rng.uniform(0.2, 0.8, (4, 4, 3)).astype(np.float32)
    textures = TextureBuffers.build([{"kind": "image", "rgb_image": tex_rgb}])
    nmat = int(scene.materials.kind.shape[0])
    atex = np.full((nmat,), -1, np.int32)
    atex[0] = 0
    scene = scene.replace(
        materials=scene.materials.replace(albedo_tex=jnp.asarray(atex)),
        textures=textures)
    return scene.with_accel(), camera


def dielectric_cornell(res: int):
    """tests/test_gradients.py's IOR box: material 1 a dielectric, every
    row's roughness 0.25 and eta 1.5, accelerator attached."""
    import jax.numpy as jnp

    from pbrt_tpu.materials.buffers import MAT_DIELECTRIC
    from pbrt_tpu.scenes.cornell import cornell_box

    scene, camera = cornell_box(resolution=(res, res))
    nmat = int(scene.materials.kind.shape[0])
    kinds = np.where(np.arange(nmat) == 1, MAT_DIELECTRIC,
                     np.asarray(scene.materials.kind))
    mats = scene.materials.replace(
        kind=jnp.asarray(kinds), any_dielectric=True,
        roughness=jnp.full((nmat,), 0.25, jnp.float32),
        eta=jnp.full((nmat,), 1.5, jnp.float32))
    return scene.replace(materials=mats).with_accel(), camera


def golden_modes() -> dict:
    _jax()
    from pbrt_tpu.models.path import PathIntegrator

    g = SMALL
    res = g["resolution"]
    out = {k: np.asarray(v) for k, v in g.items()}
    scene, camera = texel_cornell(res)
    for prefix, kw in TEXEL_MODES:
        integ = PathIntegrator(max_depth=g["max_depth"],
                               rr_start_depth=g["rr_start_depth"], **kw)
        out.update(_gradients(prefix, scene, camera, integ, TEXEL_LEAVES,
                              forward_mode=False))
    scene, camera = dielectric_cornell(res)
    integ = PathIntegrator(max_depth=g["max_depth"],
                           rr_start_depth=g["rr_start_depth"],
                           replay_grad=False)
    with detached_queries():
        out.update(_gradients("attached", scene, camera, integ,
                              ATTACHED_LEAVES, forward_mode=True))
    return out


def golden_families() -> dict:
    jax = _jax()
    from pbrt_tpu.io.parser import load_pbrt
    from pbrt_tpu.materials import bxdf
    from tests.torch_port_families import FAMILIES_PBRT, coarse_mix_keys

    g = SMALL
    scene, camera, settings = load_pbrt(FAMILIES_PBRT)
    scene = scene.with_accel()
    camera = camera.replace(resolution=(g["resolution"],) * 2)
    integ = settings["integrator"]
    if integ.max_depth != g["max_depth"]:
        raise SystemExit(f"families.pbrt's depth is {integ.max_depth}")
    out = {k: np.asarray(v) for k, v in g.items()}
    with coarse_mix_keys(bxdf), jax.disable_jit(), detached_queries():
        out.update(_gradients("families", scene, camera, integ,
                              DEFAULT_LEAVES, forward_mode=True, jit=False))
    return out


def _check_and_save(path, out):
    for key, v in out.items():
        if "_grad_" in key or key.endswith("loss"):
            if not np.all(np.isfinite(v)):
                raise SystemExit(f"golden {key} is not finite")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **out)
    print(f"wrote {path}")


def main() -> None:
    sys.path.insert(0, ROOT)
    ap = argparse.ArgumentParser()
    ap.add_argument("--which", default="cornell",
                    choices=("cornell", "modes", "families"))
    which = ap.parse_args().which
    if which == "cornell":
        out = golden_grad()
        _check_and_save(OUT, out)
        print(f"loss {float(out['loss']):.6f}, area_scale grad "
              f"{out['grad_area_scale']}")
    elif which == "modes":
        _check_and_save(OUT_MODES, golden_modes())
    else:
        _check_and_save(OUT_FAMILIES, golden_families())


if __name__ == "__main__":
    main()
