"""Carry a JAX scene and camera across to the port, through numpy only.

`scene_from_arrays(arrays, static)` builds the port's Scene from the
reference scene's fields. `arrays` maps dataclass field paths to numpy
arrays ("geom.tri_verts", "materials.albedo_coeffs", "lights.area_scale",
"small.table", "clusters.boxes", "bvh.node_lo", ...); `static` maps the
paths of static (non-array) fields to their values ("small.n_tris",
"lights.sampler", "geom.has_alpha", "bvh.depth", ...).
The port carries every field of the reference's scene classes, so a
field it does not know raises ValueError ("unknown scene field") when it
holds data (a non-empty, non-zero array, or a static value other than
None). An
image-based infinite light ("lights.env.*") is carried as the port's
EnvironmentMap or, when it has portal corners, PortalLight, with its
distribution's tables. The light BVH ("lights.bvh.*") is carried as the
port's LightBVH, and the exhaustive sampler's records ("lights.exh_recs")
as a tensor. Every material field is carried (the measured tables and
the mix columns included), so an unknown one is a ValueError. The
texture tables ("textures.*", the flat texel table and the Ptex tables
included) are carried as the port's TextureBuffers. The scene-level medium ("medium.*",
its static "medium.kind") and the interior-media stack ("media_stack.*")
are carried member for member as the port's MediumBuffers and
MediumStack. The moving instances ("anim.xforms.<i>.<field>", each
instance's keyframes decomposed, with the static "anim.ranges",
"anim.time0" and "anim.time1") are carried as the port's
AnimatedInstances, and a camera's "motion.*" as its AnimatedTransform.
`camera_from_arrays` carries every camera class (perspective, realistic
and omni with their lens stacks, exit-pupil bounds and microlens arrays,
the human eye, RTF, orthographic and spherical), dispatched on the
reference camera's class name; `sampler_from_arrays` and
`filter_from_arrays` carry a Sampler's fields and a Filter's table.
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


def _section(cls, prefix: str, arrays: dict, static: dict, **extra):
    """Build one port dataclass from the `prefix.` entries (plus `extra`
    keyword fields); an entry naming a field the port does not have is
    unknown and must carry no data. A None for a tensor field keeps its
    default."""

    def refuse(path):
        return ValueError(f"unknown scene field {path!r}")

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
                raise refuse(path)
        elif _carries_data(value):
            raise refuse(path)
    return cls(**kwargs, **extra)


def _unwrap(kind):
    """T of Optional[T]."""
    args = [a for a in typing.get_args(kind) if a is not type(None)]
    return args[0] if typing.get_origin(kind) is typing.Union and args else kind


def _tree(cls, prefix: str, arrays: dict, static: dict):
    """Build a port tensorclass (and the tensorclasses nested in it) from
    the `prefix`-ed entries, removing the ones it takes: static fields
    from `static`, tensors from `arrays` (floats as Python floats), a
    nested tensorclass from its own prefix, a None from a static None.
    Derived (init=False) fields are rebuilt, never carried."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if not f.init:
            continue
        path = prefix + f.name
        kind = _unwrap(hints[f.name])
        if path in static:
            value = static.pop(path)
            if value is not None or not f.metadata.get("static", False):
                kwargs[f.name] = value
            continue
        if dataclasses.is_dataclass(kind) and any(
                p.startswith(path + ".") for p in list(arrays) + list(static)):
            kwargs[f.name] = _tree(kind, path + ".", arrays, static)
        elif path in arrays:
            value = arrays.pop(path)
            kwargs[f.name] = float(value) if kind is float else _tensor(value)
    return cls(**kwargs)


def _leftover(what: str, arrays: dict, static: dict) -> None:
    extra = sorted(list(arrays) + list(static))
    if extra:
        raise ValueError(f"unknown {what} fields {extra}")


def _env_from_arrays(arrays: dict):
    """The image or portal light of the "lights.env." entries (removed
    from `arrays`), or None."""
    env = {p: arrays.pop(p) for p in list(arrays)
           if p.startswith("lights.env.")}
    if not env:
        return None
    cls = PortalLight if "lights.env.corners" in env else EnvironmentMap
    out = _tree(cls, "lights.env.", env, {})
    _leftover("environment light", env, {})
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
                                        static)
    for member, cls in (("medium", MediumBuffers),
                        ("media_stack", MediumStack)):
        if any(p.startswith(member + ".") for p in list(arrays) + list(static)):
            optional[member] = _section(cls, member, arrays, static)
    for member, cls in (("small", SmallTriAccel), ("clusters", ClusterAccel),
                        ("sweep", SweepAccel), ("bvh", BVH),
                        ("kdtree", KdTree)):
        if any(p.startswith(member + ".") for p in list(arrays) + list(static)):
            optional[member] = _section(cls, member, arrays, static)
    if any(p.startswith("anim.") for p in arrays):
        optional["anim"] = _anim_from_arrays(arrays, static)
    return Scene(geom=geom, materials=materials, lights=lights, **optional)


def _camera_classes() -> dict:
    from .cameras.humaneye import HumanEyeCamera
    from .cameras.realistic import RealisticCamera
    from .cameras.rtf import RTFCamera
    from .cameras.simple import OrthographicCamera, SphericalCamera

    return {c.__name__: c for c in (
        PerspectiveCamera, RealisticCamera, HumanEyeCamera, RTFCamera,
        OrthographicCamera, SphericalCamera)}


def camera_from_arrays(arrays: dict[str, np.ndarray], static: dict,
                       kind: str = "PerspectiveCamera"):
    """Build the port's camera of class `kind` (the reference camera's
    class name) from the reference camera's flattened fields
    ("camera_to_world.m", the lens stack's "lens.vertex_z", ...,
    "pupil_bounds", "microlens.stack.*", "microlens.offsets", an RTF
    camera's "coeffs" and "powers", "motion.*", and the static
    "resolution", "fov_deg", "diffraction", "microlens.dims", ...)."""
    classes = _camera_classes()
    if kind not in classes:
        raise ValueError(f"unknown camera class {kind!r}; the port has "
                         f"{sorted(classes)}")
    arrays, static = dict(arrays), dict(static)
    extra = {}
    if any(k.startswith("motion.") for k in arrays):
        extra["motion"] = _xform("motion", arrays, static)
        for k in [k for k in list(arrays) + list(static)
                  if k.startswith("motion.")]:
            arrays.pop(k, None)
            static.pop(k, None)
    cam = _tree(classes[kind], "", arrays, static)
    _leftover(kind, arrays, static)
    return cam.replace(**extra) if extra else cam


def sampler_from_arrays(arrays: dict[str, np.ndarray], static: dict):
    """The port's Sampler from a reference Sampler's flattened fields (the
    "seed" array and the static kind, spp, nx and log2_res)."""
    from .samplers.samplers import Sampler

    arrays, static = dict(arrays), dict(static)
    seed = int(arrays.pop("seed"))
    fields = {k: static.pop(k) for k in ("kind", "spp", "nx", "log2_res")}
    _leftover("sampler", arrays, static)
    return Sampler(seed=seed, **fields)


def filter_from_arrays(arrays: dict[str, np.ndarray], static: dict):
    """The port's Filter from a reference Filter's flattened fields (its
    table "values", its distribution "dist.*" and the static kind, radius
    and integral ratio)."""
    from .filters.filters import Filter

    arrays, static = dict(arrays), dict(static)
    filt = _tree(Filter, "", arrays, static)
    _leftover("filter", arrays, static)
    return filt
