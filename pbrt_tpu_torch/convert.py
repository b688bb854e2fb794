"""Carry a JAX scene and camera across to the port, through numpy only.

`scene_from_arrays(arrays, static)` builds the port's Scene from the
reference scene's fields. `arrays` maps dataclass field paths to numpy
arrays ("geom.tri_verts", "materials.albedo_coeffs", "lights.area_scale",
"small.table", "clusters.boxes", "bvh.node_lo", ...); `static` maps the
paths of static (non-array) fields to their values ("small.n_tris",
"lights.sampler", "geom.has_alpha", "bvh.depth", ...).
A field the port does not carry raises NotImplementedError when it holds
data (a non-empty, non-zero array, or a static value other than the one
the port implies), naming the ROADMAP Queue 1 item that will port it. An
image-based infinite light ("lights.env.*") is carried as the port's
EnvironmentMap or, when it has portal corners, PortalLight, with its
distribution's tables. The light BVH ("lights.bvh.*") is carried as the
port's LightBVH, and the exhaustive sampler's records ("lights.exh_recs")
as a tensor. Every material field is carried (the measured tables and
the mix columns included), so an unknown one is a ValueError. The
texture tables ("textures.*", the flat texel table included) are
carried as the port's TextureBuffers; one with a Ptex row
raises (ROADMAP Queue 1 item 15). The scene-level medium ("medium.*",
its static "medium.kind") and the interior-media stack ("media_stack.*")
are carried member for member as the port's MediumBuffers and
MediumStack. The moving instances ("anim.xforms.<i>.<field>", each
instance's keyframes decomposed, with the static "anim.ranges",
"anim.time0" and "anim.time1") are carried as the port's
AnimatedInstances, and a camera's "motion.*" as its AnimatedTransform.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from .accel.bvh import BVH
from .accel.instances import AnimatedInstances, stack_xforms
from .accel.kdtree import KdTree
from .cameras.perspective import PerspectiveCamera
from .core.transform import AnimatedTransform, Transform
from .lights.buffers import LightBuffers
from .lights.bvh import LightBVH
from .lights.envmap import EnvironmentMap
from .lights.portal import PortalLight
from .materials.buffers import MaterialBuffers
from .media.medium import MediumBuffers, MediumStack
from .ops.cluster import ClusterAccel
from .ops.smallscene import SmallTriAccel
from .ops.sweep import SweepAccel
from .scene import Scene
from .shapes.geometry import GeometryBuffers
from .textures.buffers import TextureBuffers

_XFORM_ARRAYS = ("t_start", "t_end", "q_start", "q_end", "s_start", "s_end")


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


def _section(cls, prefix: str, arrays: dict, static: dict, item_of=None,
             **extra):
    """Build one port dataclass from the `prefix.` entries (plus `extra`
    keyword fields); entries naming fields the port does not have must
    carry no data (item_of(name): the ROADMAP item that will port them;
    None where the port carries every field, and such an entry is
    unknown). A None for a tensor field keeps its default."""

    def refuse(path, name):
        if item_of is None:
            return ValueError(f"unknown scene field {path!r}")
        return _unported(path, item_of(name))

    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for path, value in list(arrays.items()) + list(static.items()):
        if not path.startswith(prefix + "."):
            continue
        name = path[len(prefix) + 1:]
        if name in fields:
            is_static = fields[name].metadata.get("static", False)
            if value is None and not is_static:
                continue
            kwargs[name] = value if is_static else _tensor(value)
        elif path in static:
            if value is not None:
                raise refuse(path, name)
        elif _carries_data(value):
            raise refuse(path, name)
    return cls(**kwargs, **extra)


def _nested(cls, prefix: str, arrays: dict):
    """Build a nest of port dataclasses from the `prefix`-ed entries, field
    by field; floats (a distribution's range) stay Python floats."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        path = prefix + f.name
        kind = hints[f.name]
        if dataclasses.is_dataclass(kind):
            kwargs[f.name] = _nested(kind, path + ".", arrays)
        elif kind is float:
            kwargs[f.name] = float(arrays.pop(path))
        else:
            kwargs[f.name] = _tensor(arrays.pop(path))
    return cls(**kwargs)


def _env_from_arrays(arrays: dict):
    """The image or portal light of the "lights.env." entries (removed
    from `arrays`), or None."""
    env = {p: arrays.pop(p) for p in list(arrays)
           if p.startswith("lights.env.")}
    if not env:
        return None
    cls = PortalLight if "lights.env.corners" in env else EnvironmentMap
    out = _nested(cls, "lights.env.", env)
    if env:
        raise ValueError(f"unknown environment light fields {sorted(env)}")
    return out


def _xform(prefix: str, arrays: dict, static: dict) -> AnimatedTransform:
    """The AnimatedTransform of the `prefix.` entries."""
    known = {f"{prefix}.{k}" for k in _XFORM_ARRAYS + ("time0", "time1")}
    extra = sorted(p for p in list(arrays) + list(static)
                   if p.startswith(prefix + ".") and p not in known)
    if extra:
        raise ValueError(f"unknown animated transform fields {extra}")
    return AnimatedTransform(
        **{k: _tensor(arrays[f"{prefix}.{k}"]) for k in _XFORM_ARRAYS},
        time0=float(static[f"{prefix}.time0"]),
        time1=float(static[f"{prefix}.time1"]))


def _anim_from_arrays(arrays: dict, static: dict) -> AnimatedInstances:
    """The moving instances of the "anim." entries."""
    n = len({p.split(".")[2] for p in arrays if p.startswith("anim.xforms.")})
    known = {"anim.ranges", "anim.time0", "anim.time1"}
    extra = sorted(p for p in list(arrays) + list(static)
                   if p.startswith("anim.") and p not in known
                   and not p.startswith("anim.xforms."))
    if extra:
        raise ValueError(f"unknown animated instance fields {extra}")
    xforms = [_xform(f"anim.xforms.{i}", arrays, static) for i in range(n)]
    return AnimatedInstances(
        xforms=stack_xforms(xforms),
        ranges=tuple(tuple(int(x) for x in r) for r in static["anim.ranges"]),
        time0=float(static["anim.time0"]), time1=float(static["anim.time1"]))


def scene_from_arrays(arrays: dict[str, np.ndarray], static: dict) -> Scene:
    """Build the port's Scene from a reference scene's flattened fields."""
    for path in list(arrays) + list(static):
        if path.split(".", 1)[0] not in (
                "geom", "materials", "lights", "textures", "medium",
                "media_stack", "small", "clusters", "sweep", "bvh", "kdtree",
                "anim"):
            raise ValueError(f"unknown scene field {path!r}")
    geom = _section(GeometryBuffers, "geom", arrays, static)
    materials = _section(MaterialBuffers, "materials", arrays, static)
    arrays = dict(arrays)
    env = _env_from_arrays(arrays)
    extra = {"env": env}
    if any(p.startswith("lights.bvh.") for p in list(arrays) + list(static)):
        extra["bvh"] = _section(LightBVH, "lights.bvh", arrays, static)
        arrays = {p: v for p, v in arrays.items()
                  if not p.startswith("lights.bvh.")}
        static = {p: v for p, v in static.items()
                  if not p.startswith("lights.bvh.")}
    if "lights.exh_recs" in arrays:
        extra["exh_recs"] = _tensor(arrays.pop("lights.exh_recs"))
    static = {p: v for p, v in static.items()
              if not (p in ("lights.env", "lights.bvh", "lights.exh_recs")
                      and v is None)}
    lights = _section(LightBuffers, "lights", arrays, static, **extra)
    optional = {}
    if any(p.startswith("textures.") for p in list(arrays) + list(static)):
        optional["textures"] = _section(TextureBuffers, "textures", arrays,
                                      static, lambda n: 15)
    for member, cls in (("medium", MediumBuffers),
                        ("media_stack", MediumStack)):
        if any(p.startswith(member + ".") for p in list(arrays) + list(static)):
            optional[member] = _section(cls, member, arrays, static)
    for member, cls in (("small", SmallTriAccel), ("clusters", ClusterAccel),
                        ("sweep", SweepAccel), ("bvh", BVH),
                        ("kdtree", KdTree)):
        if any(p.startswith(member + ".") for p in list(arrays) + list(static)):
            optional[member] = _section(cls, member, arrays, static, lambda n: 6)
    if any(p.startswith("anim.") for p in arrays):
        optional["anim"] = _anim_from_arrays(arrays, static)
    return Scene(geom=geom, materials=materials, lights=lights, **optional)


def camera_from_arrays(arrays: dict[str, np.ndarray],
                       static: dict) -> PerspectiveCamera:
    """Build the port's PerspectiveCamera from a reference camera's
    flattened fields ("camera_to_world.m", "camera_to_world.m_inv",
    "motion.*" and the static "resolution", "fov_deg", ...)."""
    c2w = Transform(m=_tensor(arrays["camera_to_world.m"]),
                    m_inv=_tensor(arrays["camera_to_world.m_inv"]))
    extra = {"camera_to_world": c2w}
    if any(k.startswith("motion.") for k in arrays):
        extra["motion"] = _xform("motion", arrays, static)
    arrays = {"camera." + k: v for k, v in arrays.items()
              if not k.startswith(("camera_to_world.", "motion."))}
    static = {"camera." + k: v for k, v in static.items()
              if not k.startswith("motion.")}
    return _section(PerspectiveCamera, "camera", arrays, static,
                    lambda n: 14, **extra)
