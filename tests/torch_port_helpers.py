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
    constructor does not take (derived in __post_init__) are left out."""
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
        else:
            arrays[path] = np.asarray(value)
    return arrays, static


def port_scene_and_camera(jax_scene, jax_camera):
    """Convert a reference (scene, camera) pair to the port through numpy."""
    from pbrt_tpu_torch.convert import camera_from_arrays, scene_from_arrays

    scene = scene_from_arrays(*flatten_jax(jax_scene))
    camera = camera_from_arrays(*flatten_jax(jax_camera))
    return scene, camera


def share_close(a, b, rtol, atol):
    """Fraction of elements of a and b that agree within rtol/atol."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    ok = np.abs(a - b) <= atol + rtol * np.abs(b)
    return float(np.mean(ok)), int(np.sum(~ok))
