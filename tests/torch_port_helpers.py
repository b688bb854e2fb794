"""Shared helpers of the tests that hold pbrt_tpu_torch against pbrt_tpu.

The JAX reference runs on the CPU; data crosses between the two packages
as numpy arrays only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np

# The reference's answers to the tests' costliest live calls (the Pallas
# kernels in interpret mode, jitted traces, renders and gradients), made by
# scripts/make_torch_port_golden_answers.py from the tests' own inputs.
ANSWERS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_port", "reference_answers.npz")


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


def _batch(res, spp):
    npix = res * res
    return (np.tile(np.arange(npix, dtype=np.int32), spp),
            np.repeat(np.arange(spp, dtype=np.int32), npix))


def tree_inputs(obj) -> dict:
    """A reference dataclass tree as digest inputs: its arrays, and its
    static fields as one string."""
    arrays, static = flatten_jax(obj)
    return {**arrays, "static": np.asarray(repr(sorted(static.items())))}


def trace_digest(js, jc, integ, res, spp) -> str:
    """The digest of jax_trace's inputs."""
    from pbrt_tpu.core.spectrum import N_SPECTRUM

    return inputs_digest(tree_inputs(js), tree_inputs(jc), dict(
        integrator=np.asarray(repr(integ)), res=np.asarray(res),
        spp=np.asarray(spp), n_spectrum=np.asarray(N_SPECTRUM)))


def jax_trace(js, jc, integ, res, spp) -> dict:
    """One pass of the reference, live: spp samples per pixel at res x
    res, seed 0, through its jitted integ.trace_with_stats (its callers
    leave no accelerator on `js`, or one its CPU path skips, so its dense
    tester answers). {"L": (spp * res * res, S), "rays", "rgb": (spp *
    res * res, 3) spectrum_to_rgb of L}."""
    import jax
    import jax.numpy as jnp

    from pbrt_tpu.films.rgb import spectrum_to_rgb
    from pbrt_tpu.render import camera_rays_full as jax_camera_rays

    pixel, sample = _batch(res, spp)
    jpix, jsam = jnp.asarray(pixel), jnp.asarray(sample)
    o, d, wl, _ = jax_camera_rays(jc.replace(resolution=(res, res)), jpix,
                                  jsam, 0)
    trace = jax.jit(lambda s, o, d, wl: integ.trace_with_stats(
        s, o, d, wl, jpix, jsam, 0))
    jL, jstats = trace(js, o, d, wl)
    return {"L": np.asarray(jL), "rays": np.asarray(float(jstats["rays"])),
            "rgb": np.asarray(spectrum_to_rgb(jL, wl))}


def reference_trace(key, js, jc, integ, res, spp) -> dict:
    """jax_trace's committed answer under `key` for these inputs."""
    return reference_answers(key, trace_digest(js, jc, integ, res, spp))


def trace_pair(key, js, jc, ps, pc, max_depth, res, spp):
    """One pass of spp samples per pixel at res x res, seed 0, through both
    packages with PathIntegrator(max_depth): the reference's (jax_trace,
    committed under `key`, its inputs' digest checked) and the port's.
    Returns (jax radiance, jax rays, port radiance, port rays), radiance
    (spp * res * res, S) numpy."""
    import torch

    from pbrt_tpu.core.spectrum import N_SPECTRUM
    from pbrt_tpu.models.path import PathIntegrator as JPathIntegrator
    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.render import camera_rays_full

    want = reference_trace(key, js, jc, JPathIntegrator(max_depth=max_depth),
                           res, spp)
    pixel, sample = _batch(res, spp)
    tpix, tsam = torch.from_numpy(pixel), torch.from_numpy(sample)
    po, pd, pwl, _ = camera_rays_full(pc.replace(resolution=(res, res)), tpix,
                                      tsam, 0, n_spectrum=N_SPECTRUM)
    pL, pstats = PathIntegrator(max_depth=max_depth).trace_with_stats(
        ps, po, pd, pwl, tpix, tsam, 0)
    return (want["L"], float(want["rays"]), pL.numpy(),
            float(pstats["rays"]))


def render_digest(js, jc, integrator, **kw) -> str:
    """The digest of a reference render's inputs: the scene, the camera,
    the integrator's fields and render()'s keywords."""
    from pbrt_tpu.core.spectrum import N_SPECTRUM

    return inputs_digest(tree_inputs(js), tree_inputs(jc), dict(
        integrator=np.asarray(repr(integrator)),
        kw=np.asarray(repr(sorted(kw.items()))),
        n_spectrum=np.asarray(N_SPECTRUM)))


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


def inputs_digest(*named: dict) -> str:
    """sha256 over dicts of arrays, key by key in sorted order: the dtype,
    shape and bytes of each."""
    h = hashlib.sha256()
    for d in named:
        for key in sorted(d):
            a = np.ascontiguousarray(d[key])
            h.update(f"{key}:{a.dtype.str}:{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def reference_answers(key: str, digest: str) -> dict:
    """The reference's committed answers under `key`
    (tests/data/torch_port/reference_answers.npz, made by
    scripts/make_torch_port_golden_answers.py), after checking that they
    were computed from inputs with this digest."""
    prefix = f"{key}/"
    with np.load(ANSWERS) as z:
        assert prefix + "digest" in z.files, (
            f"{key}: no committed answer; rerun "
            "scripts/make_torch_port_golden_answers.py")
        assert str(z[prefix + "digest"]) == digest, (
            f"{key}: the golden's inputs differ from the test's; rerun "
            "scripts/make_torch_port_golden_answers.py")
        return {k[len(prefix):]: z[k] for k in z.files
                if k.startswith(prefix) and k != prefix + "digest"}
