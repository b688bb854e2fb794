"""Shared helpers of the tests that hold pbrt_tpu_torch against pbrt_tpu.

The JAX reference runs on the CPU; data crosses between the two packages
as numpy arrays only.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def flatten_jax(obj, prefix: str = ""):
    """Flatten a reference dataclass tree into (arrays, static) dicts keyed
    by dotted field paths, as pbrt_tpu_torch.convert expects. Fields a
    constructor does not take (derived in __post_init__) are left out; a
    tuple of dataclasses (the moving instances' transforms) flattens
    entry by entry ("anim.xforms.0.t_start", ...)."""
    arrays, static = {}, {}
    for f in dataclasses.fields(obj):
        if not f.init:
            continue
        value = getattr(obj, f.name)
        path = prefix + f.name
        if f.metadata.get("static", False) or value is None:
            static[path] = value
        elif dataclasses.is_dataclass(value):
            a, s = flatten_jax(value, path + ".")
            arrays.update(a)
            static.update(s)
        elif isinstance(value, tuple) and all(
                dataclasses.is_dataclass(v) for v in value):
            for i, v in enumerate(value):
                a, s = flatten_jax(v, f"{path}.{i}.")
                arrays.update(a)
                static.update(s)
        else:
            arrays[path] = np.asarray(value)
    return arrays, static


def port_scene_and_camera(jax_scene, jax_camera):
    """Convert a reference (scene, camera) pair to the port through numpy."""
    from pbrt_tpu_torch.convert import camera_from_arrays, scene_from_arrays

    scene = scene_from_arrays(*flatten_jax(jax_scene))
    camera = camera_from_arrays(*flatten_jax(jax_camera),
                                kind=type(jax_camera).__name__)
    return scene, camera


def share_close(a, b, rtol, atol):
    """Fraction of elements of a and b that agree within rtol/atol."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    ok = np.abs(a - b) <= atol + rtol * np.abs(b)
    return float(np.mean(ok)), int(np.sum(~ok))


def trace_pair(js, jc, ps, pc, max_depth, res, spp):
    """One pass of spp samples per pixel at res x res, seed 0, through both
    packages: the reference's jitted trace_with_stats (its caller leaves no
    accelerator on `js`, so its dense tester answers, as on its CPU path)
    and the port's. Returns (jax radiance, jax rays, port radiance, port
    rays), radiance (spp * res * res, S) numpy."""
    import jax
    import jax.numpy as jnp
    import torch

    from pbrt_tpu.core.spectrum import N_SPECTRUM
    from pbrt_tpu.models.path import PathIntegrator as JPathIntegrator
    from pbrt_tpu.render import camera_rays_full as jax_camera_rays
    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.render import camera_rays_full

    npix = res * res
    pixel = np.tile(np.arange(npix, dtype=np.int32), spp)
    sample = np.repeat(np.arange(spp, dtype=np.int32), npix)
    jpix, jsam = jnp.asarray(pixel), jnp.asarray(sample)
    o, d, wl, _ = jax_camera_rays(jc.replace(resolution=(res, res)), jpix,
                                  jsam, 0)
    j_integ = JPathIntegrator(max_depth=max_depth)
    trace = jax.jit(lambda s, o, d, wl: j_integ.trace_with_stats(
        s, o, d, wl, jpix, jsam, 0))
    jL, jstats = trace(js, o, d, wl)
    tpix, tsam = torch.from_numpy(pixel), torch.from_numpy(sample)
    po, pd, pwl, _ = camera_rays_full(pc.replace(resolution=(res, res)), tpix,
                                      tsam, 0, n_spectrum=N_SPECTRUM)
    pL, pstats = PathIntegrator(max_depth=max_depth).trace_with_stats(
        ps, po, pd, pwl, tpix, tsam, 0)
    return (np.asarray(jL), float(jstats["rays"]), pL.numpy(),
            float(pstats["rays"]))


def assert_samples_match(jL, j_rays, pL, p_rays, share=0.99):
    """The render gate of the port's parity tests: the same ray count and
    >= `share` of the per-sample radiance values within rtol 1e-3 / atol
    1e-5 of the reference's."""
    assert pL.shape == jL.shape and np.isfinite(pL).all()
    assert p_rays == j_rays, (p_rays, j_rays)
    got, n_bad = share_close(pL, jL, rtol=1e-3, atol=1e-5)
    print(f"sample values disagreeing with the reference: {n_bad} of {jL.size}")
    assert got >= share, n_bad
    assert jL.mean() > 0.01
