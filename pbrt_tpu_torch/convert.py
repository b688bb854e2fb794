"""Carry a JAX scene and camera across to the port, through numpy only.

`scene_from_arrays(arrays, static)` builds the port's Scene from the
reference scene's fields. `arrays` maps dataclass field paths to numpy
arrays ("geom.tri_verts", "materials.albedo_coeffs", "lights.area_scale",
"small.table", "clusters.boxes", ...); `static` maps the paths of static
(non-array) fields to their values ("small.n_tris", "lights.sampler",
"geom.has_alpha", ...).
A field the port does not carry raises NotImplementedError when it holds
data (a non-empty, non-zero array, or a static value other than the one
the port implies), naming the ROADMAP Queue 1 item that will port it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .cameras.perspective import PerspectiveCamera
from .core.transform import Transform
from .lights.buffers import LightBuffers
from .materials.buffers import MaterialBuffers
from .ops.cluster import ClusterAccel
from .ops.smallscene import SmallTriAccel
from .ops.sweep import SweepAccel
from .scene import Scene
from .shapes.geometry import UNPORTED_SHAPES, GeometryBuffers

# Scene members the port does not carry -> ROADMAP Queue 1 item.
_UNPORTED_MEMBERS = {
    "medium": 12, "media_stack": 12, "textures": 10, "bvh": 8,
    "kdtree": 8, "anim": 7,
}
# Static fields the port does not carry, with the only value it accepts.
_IMPLIED_STATIC = {
    "geom.has_alpha": False,
    "camera.motion": None,
}
_LIGHT_ITEM = 11  # ROADMAP Queue 1 item of the unported lights


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)  # a writable copy
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a)


def _carries_data(a) -> bool:
    a = np.asarray(a)
    return a.size > 0 and bool(np.any(a))


def _unported(path: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"scene field {path!r} is not ported yet (ROADMAP Queue 1 item {item})"
    )


def _section(cls, prefix: str, arrays: dict, static: dict, item_of,
             **extra):
    """Build one port dataclass from the `prefix.` entries (plus `extra`
    keyword fields); entries naming fields the port does not have must
    carry no data."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for path, value in list(arrays.items()) + list(static.items()):
        if not path.startswith(prefix + "."):
            continue
        name = path[len(prefix) + 1:]
        if name in fields:
            is_static = fields[name].metadata.get("static", False)
            kwargs[name] = value if is_static else _tensor(value)
        elif path in _IMPLIED_STATIC:
            if value != _IMPLIED_STATIC[path]:
                raise _unported(path, item_of(name))
        elif path in static:
            if value is not None:
                raise _unported(path, item_of(name))
        elif _carries_data(value):
            raise _unported(path, item_of(name))
    return cls(**kwargs, **extra)


def scene_from_arrays(arrays: dict[str, np.ndarray], static: dict) -> Scene:
    """Build the port's Scene from a reference scene's flattened fields."""
    for path in list(arrays) + list(static):
        member = path.split(".", 1)[0]
        if member in _UNPORTED_MEMBERS:
            if path in arrays or static[path] is not None:
                raise _unported(path, _UNPORTED_MEMBERS[member])
        elif member not in ("geom", "materials", "lights", "small",
                            "clusters", "sweep"):
            raise ValueError(f"unknown scene field {path!r}")
    geom = _section(GeometryBuffers, "geom", arrays, static,
                    lambda n: UNPORTED_SHAPES.get(n, 8))
    materials = _section(MaterialBuffers, "materials", arrays, static,
                         lambda n: 10)
    lights = _section(LightBuffers, "lights", arrays, static,
                      lambda n: _LIGHT_ITEM)
    accels = {}
    for member, cls in (("small", SmallTriAccel), ("clusters", ClusterAccel),
                        ("sweep", SweepAccel)):
        if any(p.startswith(member + ".") for p in list(arrays) + list(static)):
            accels[member] = _section(cls, member, arrays, static, lambda n: 6)
    return Scene(geom=geom, materials=materials, lights=lights, **accels)


def camera_from_arrays(arrays: dict[str, np.ndarray],
                       static: dict) -> PerspectiveCamera:
    """Build the port's PerspectiveCamera from a reference camera's
    flattened fields ("camera_to_world.m", "camera_to_world.m_inv" and the
    static "resolution", "fov_deg", ...)."""
    c2w = Transform(m=_tensor(arrays["camera_to_world.m"]),
                    m_inv=_tensor(arrays["camera_to_world.m_inv"]))
    arrays = {"camera." + k: v for k, v in arrays.items()
              if not k.startswith("camera_to_world.")}
    static = {"camera." + k: v for k, v in static.items()}
    return _section(PerspectiveCamera, "camera", arrays, static,
                    lambda n: 14, camera_to_world=c2w)
