""".pbrt scene-description parser -> (Scene, PerspectiveCamera, settings).

Port of pbrt_tpu/io/parser.py, numpy only up to the builders: the same
tokens, parameter lists, float64 graphics state and instancing rules, so a
file parses to the same triangles, materials, lights and camera as in the
reference. The directive subset:

  transforms: Identity LookAt Translate Rotate Scale Transform ConcatTransform
              CoordinateSystem CoordSysTransform TransformTimes ActiveTransform
  state:      AttributeBegin/End TransformBegin/End ObjectBegin/End
              ObjectInstance ReverseOrientation WorldBegin/End Include Import
  options:    Camera "perspective", Film "rgb", Sampler independent/random,
              Integrator path/simplepath; Filter, Accelerator, Option and
              ColorSpace are consumed
  scene:      Material / MakeNamedMaterial / NamedMaterial (diffuse and the
              names the reference maps to it, conductor), Shape trianglemesh
              and plymesh, AreaLightSource "diffuse", LightSource "infinite"
              with a uniform "rgb L"

A feature the port lacks (another camera, sampler or integrator, textures,
other materials, shapes, lights, alpha, media, animated instances) raises
NotImplementedError naming its ROADMAP Queue 1 item, at parse or build
time; nothing renders without it. Where the reference approximates and
warns ("material X approximated as diffuse", unknown directives, shapes
and lights), the port does the same, since that is the reference's
behaviour.

Instancing is true instancing: an instanced prototype's triangles are
stored once in object space and the sweep accelerator (ops/sweep.py, K3)
walks each instance under its transform. Emissive objects are flattened
into world-space copies, with the reference's warning.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..cameras.perspective import PerspectiveCamera
from ..core import transform as tfm
from ..lights.buffers import LightBuffers
from ..materials.buffers import MAT_CONDUCTOR, MAT_DIFFUSE, MaterialBuffers
from ..models.path import PathIntegrator
from ..ops.sweep import build_sweep
from ..scene import Scene
from ..shapes.geometry import GeometryBuffers
from .ply import read_ply


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {item})"
    )


def tokenize(text: str):
    """pbrt tokens: strings, brackets, numbers/identifiers; # comments.
    (The reference's pure-Python tokenizer, its behavioural spec.)"""
    toks = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in " \t\r\n":
            i += 1
        elif c == "#":
            while i < n and text[i] != "\n":
                i += 1
        elif c == '"':
            j = text.index('"', i + 1)
            toks.append(text[i:j + 1])
            i = j + 1
        elif c in "[]":
            toks.append(c)
            i += 1
        else:
            j = i
            while j < n and text[j] not in ' \t\r\n"[]#':
                j += 1
            toks.append(text[i:j])
            i = j
    return toks


class _TokenStream:
    def __init__(self, tokens):
        self.toks = tokens
        self.pos = 0

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self):
        t = self.peek()
        self.pos += 1
        return t

    def done(self):
        return self.pos >= len(self.toks)


_DIRECTIVES = {
    "Integrator", "Sampler", "Film", "Filter", "PixelFilter", "Camera",
    "Accelerator", "Option", "LookAt", "Translate", "Rotate", "Scale",
    "Transform", "ConcatTransform", "Identity", "WorldBegin", "WorldEnd",
    "AttributeBegin", "AttributeEnd", "TransformBegin", "TransformEnd",
    "ObjectBegin", "ObjectEnd", "ObjectInstance", "ReverseOrientation",
    "Material", "MakeNamedMaterial", "NamedMaterial", "Texture", "Shape",
    "LightSource", "AreaLightSource", "MakeNamedMedium", "MediumInterface",
    "Include", "Import", "ColorSpace", "CoordinateSystem", "CoordSysTransform",
    "Attribute", "TransformTimes", "ActiveTransform",
}

# Material families of the reference parser the port cannot shade yet.
_UNPORTED_MATERIALS = {
    "subsurface", "none", "interface", "", "diffusetransmission",
    "retroreflective", "mix", "measured", "coateddiffuse", "coatedconductor",
    "dielectric", "glass", "thindielectric", "hair",
}
# Shapes the reference builds that the port does not (item 8).
_UNPORTED_SHAPES = {"sphere", "disk", "cylinder", "bilinearmesh",
                    "loopsubdiv", "curve"}
_UNPORTED_LIGHTS = {"point", "spot", "distant", "projection", "goniometric"}


def _parse_params(ts: _TokenStream):
    """Parse `"type name" [values...]` pairs until the next directive."""
    params = {}
    while True:
        t = ts.peek()
        if t is None or not t.startswith('"'):
            break
        decl = ts.next()[1:-1].split()
        if len(decl) == 1:
            ptype, pname = "string", decl[0]
        else:
            ptype, pname = decl[0], decl[1]
        vals = []
        if ts.peek() == "[":
            ts.next()
            while ts.peek() != "]":
                vals.append(ts.next())
            ts.next()
        else:
            vals.append(ts.next())

        def conv(v):
            if v.startswith('"'):
                return v[1:-1]
            if v in ("true", "false"):
                return v == "true"
            return float(v)

        params[pname] = (ptype, [conv(v) for v in vals])
    return params


def _get(params, name, default=None):
    if name in params:
        v = params[name][1]
        return v[0] if len(v) == 1 else v
    return default


def _get_vec(params, name, default=None):
    if name in params:
        ptype, vals = params[name]
        if ptype == "texture":
            return default
        return np.asarray(vals, np.float64)
    return default


def _no_textures(params, where: str):
    for name, (ptype, _) in params.items():
        if ptype == "texture":
            raise _unported(f"texture parameter {name!r} of {where}", 10)


class PbrtParser:
    """Stateful scene builder (BasicSceneBuilder, scene.cpp:57-230)."""

    _UV_IDENTITY = np.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]], np.float32)

    def __init__(self, base_dir="."):
        self.base_dir = base_dir
        self.ctm = np.eye(4)
        self.stack = []
        self.named_ctm = {}
        # graphics state
        self.cur_material = 0
        self.cur_area_light = None
        self.reverse = False
        # collected scene; per-shape arrays, concatenated at build
        self.materials = [{"kind": MAT_DIFFUSE, "albedo": (0.5, 0.5, 0.5)}]
        self.named_materials = {}
        self.tris = []  # (n, 3, 3) float32 per emitted shape
        self.tri_mat = []
        self.tri_light = []
        self.tri_face = []
        self.tri_uv = []
        self.n_tris = 0
        self._pending_uv = None  # (n, 3, 2) for the shape being emitted
        self.area_lights = []
        self.infinite = None
        # camera / settings
        self.camera_params = {}
        self.world_to_camera = np.eye(4)
        self.resolution = (256, 256)
        self.integrator = "path"
        self.integrator_params = {}
        self.sampler_kind = "independent"
        self.spp = 16
        # objects (instancing): name -> [(tris, material, area light)]
        self.objects = {}
        self.cur_object = None
        self.object_base = {}
        # Recorded (name, object_to_world, o2w_end) instance references.
        self.instances = []
        # ActiveTransform state: "all" applies transform directives to both
        # keyframes; "start"/"end" to one (scene.cpp TransformSet).
        self.active_transform = "all"
        self.ctm_end = None  # end-keyframe CTM; None == same as self.ctm
        self.warnings = []

    # -- transforms ----------------------------------------------------------

    def _apply(self, m):
        if self.active_transform in ("all", "start"):
            self.ctm = self.ctm @ m
        if self.ctm_end is not None and self.active_transform in ("all", "end"):
            self.ctm_end = self.ctm_end @ m

    def _pts(self, pts):
        h = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
        return (h @ self.ctm.T)[:, :3]

    # -- main loop -----------------------------------------------------------

    def parse_file(self, path: str):
        with open(path) as f:
            text = f.read()
        self.base_dir = os.path.dirname(os.path.abspath(path))
        self.parse_string(text)
        return self

    def parse_string(self, text: str):
        ts = _TokenStream(tokenize(text))
        while not ts.done():
            d = ts.next()
            handler = getattr(self, "_d_" + d, None)
            if handler is None:
                if d in _DIRECTIVES:
                    _parse_params(ts)  # consume and ignore
                    self.warnings.append(f"ignored directive {d}")
                else:
                    self.warnings.append(f"unknown token {d}")
                continue
            handler(ts)
        return self

    # -- rendering options ---------------------------------------------------

    def _d_Integrator(self, ts):
        self.integrator = ts.next()[1:-1]
        self.integrator_params = _parse_params(ts)
        if self.integrator not in ("path", "simplepath"):
            raise _unported(f"Integrator {self.integrator!r}", 13)

    def _d_Sampler(self, ts):
        kind = ts.next()[1:-1]
        p = _parse_params(ts)
        if kind not in ("independent", "random"):
            raise _unported(f"Sampler {kind!r}", 14)
        self.sampler_kind = "independent"
        self.spp = int(_get(p, "pixelsamples", 16))

    def _d_Film(self, ts):
        kind = ts.next()[1:-1]
        p = _parse_params(ts)
        if kind != "rgb":
            raise _unported(f"Film {kind!r}", 14)
        self.resolution = (
            int(_get(p, "xresolution", 256)),
            int(_get(p, "yresolution", 256)),
        )

    def _d_Filter(self, ts):
        ts.next()
        _parse_params(ts)

    _d_PixelFilter = _d_Filter
    _d_Accelerator = _d_Filter

    def _d_Option(self, ts):
        _parse_params(ts)

    def _d_ColorSpace(self, ts):
        ts.next()

    def _d_Camera(self, ts):
        kind = ts.next()[1:-1]
        self.camera_params = _parse_params(ts)
        if kind != "perspective":
            raise _unported(f"Camera {kind!r}", 14)
        self.world_to_camera = self.ctm.copy()

    # -- transforms and graphics state -----------------------------------------

    def _d_Identity(self, ts):
        self.ctm = np.eye(4)

    def _d_LookAt(self, ts):
        v = [float(ts.next()) for _ in range(9)]
        c2w = tfm.look_at(v[0:3], v[3:6], v[6:9]).m.numpy().astype(np.float64)
        self._apply(np.linalg.inv(c2w))  # LookAt appends world-to-camera

    def _d_Translate(self, ts):
        v = [float(ts.next()) for _ in range(3)]
        self._apply(tfm.translate(v).m.numpy().astype(np.float64))

    def _d_Rotate(self, ts):
        a = float(ts.next())
        axis = [float(ts.next()) for _ in range(3)]
        self._apply(tfm.rotate(axis, a).m.numpy().astype(np.float64))

    def _d_Scale(self, ts):
        v = [float(ts.next()) for _ in range(3)]
        self._apply(tfm.scale(v).m.numpy().astype(np.float64))

    def _matrix(self, ts):
        if ts.next() != "[":
            raise ValueError("expected '[' before a 4x4 matrix")
        v = [float(ts.next()) for _ in range(16)]
        if ts.next() != "]":
            raise ValueError("expected ']' after a 4x4 matrix")
        return np.asarray(v, np.float64).reshape(4, 4).T  # column-major

    def _d_Transform(self, ts):
        m = self._matrix(ts)
        if self.active_transform in ("all", "start"):
            self.ctm = m
        if self.ctm_end is not None and self.active_transform in ("all", "end"):
            self.ctm_end = m.copy()

    def _d_ConcatTransform(self, ts):
        self._apply(self._matrix(ts))

    def _d_CoordinateSystem(self, ts):
        self.named_ctm[ts.next()[1:-1]] = self.ctm.copy()

    def _d_CoordSysTransform(self, ts):
        name = ts.next()[1:-1]
        if name in self.named_ctm:
            self.ctm = self.named_ctm[name].copy()
        elif name == "camera":
            self.ctm = np.linalg.inv(self.world_to_camera)

    def _d_WorldBegin(self, ts):
        self.ctm = np.eye(4)

    def _d_WorldEnd(self, ts):
        pass

    def _d_AttributeBegin(self, ts):
        self.stack.append(
            (self.ctm.copy(), self.cur_material, self.cur_area_light,
             self.reverse,
             None if self.ctm_end is None else self.ctm_end.copy(),
             self.active_transform)
        )

    def _d_AttributeEnd(self, ts):
        (self.ctm, self.cur_material, self.cur_area_light, self.reverse,
         self.ctm_end, self.active_transform) = self.stack.pop()

    _d_TransformBegin = _d_AttributeBegin
    _d_TransformEnd = _d_AttributeEnd

    def _d_ReverseOrientation(self, ts):
        self.reverse = not self.reverse

    def _d_TransformTimes(self, ts):
        # The shutter interval of animated transforms, which build() refuses.
        float(ts.next()), float(ts.next())

    def _d_ActiveTransform(self, ts):
        """ActiveTransform StartTime|EndTime|All: which CTM keyframe later
        transform directives update. Differing keyframes on an
        ObjectInstance make it animated, which build() refuses."""
        which = ts.next()
        if self.ctm_end is None:
            self.ctm_end = self.ctm.copy()
        self.active_transform = {
            "StartTime": "start", "EndTime": "end", "All": "all"
        }.get(which, "all")

    def _d_Include(self, ts):
        name = ts.next()[1:-1]
        with open(os.path.join(self.base_dir, name)) as f:
            self.parse_string(f.read())

    _d_Import = _d_Include

    # -- materials, textures and media ---------------------------------------

    def _material_from_params(self, mtype, p):
        _no_textures(p, f"material {mtype!r}")
        if mtype in _UNPORTED_MATERIALS:
            raise _unported(f"material {mtype!r}", 10)
        spec = {"kind": MAT_DIFFUSE, "albedo": (0.5, 0.5, 0.5)}
        refl = _get_vec(p, "reflectance")
        if refl is None:
            refl = _get_vec(p, "albedo")
        if mtype in ("conductor", "metal"):
            spec["kind"] = MAT_CONDUCTOR
            spec["roughness"] = float(_get(p, "roughness", 0.01) or 0.01)
        elif mtype != "diffuse":
            # "matte" and unknown families, as the reference renders them.
            self.warnings.append(f"material {mtype} approximated as diffuse")
        if refl is not None and len(np.atleast_1d(refl)) == 3:
            spec["albedo"] = tuple(np.asarray(refl, float))
        return spec

    def _d_Material(self, ts):
        mtype = ts.next()[1:-1]
        p = _parse_params(ts)
        self.materials.append(self._material_from_params(mtype, p))
        self.cur_material = len(self.materials) - 1

    def _d_MakeNamedMaterial(self, ts):
        name = ts.next()[1:-1]
        p = _parse_params(ts)
        mtype = _get(p, "type", "diffuse")
        self.materials.append(self._material_from_params(mtype, p))
        self.named_materials[name] = len(self.materials) - 1

    def _d_NamedMaterial(self, ts):
        name = ts.next()[1:-1]
        self.cur_material = self.named_materials.get(name, 0)

    def _d_Texture(self, ts):
        raise _unported(f"Texture {ts.next()}", 10)

    def _d_MakeNamedMedium(self, ts):
        raise _unported(f"MakeNamedMedium {ts.next()}", 12)

    def _d_MediumInterface(self, ts):
        raise _unported("MediumInterface", 12)

    # -- lights --------------------------------------------------------------

    def _d_AreaLightSource(self, ts):
        ts.next()  # "diffuse"
        p = _parse_params(ts)
        L = _get_vec(p, "L")
        scale = float(_get(p, "scale", 1.0) or 1.0)
        rgb = tuple(L) if L is not None and len(L) == 3 else (1.0, 1.0, 1.0)
        self.cur_area_light = {
            "rgb": rgb,
            "scale": scale,
            "two_sided": bool(_get(p, "twosided", False)),
        }

    def _d_LightSource(self, ts):
        ltype = ts.next()[1:-1]
        p = _parse_params(ts)
        scale = float(_get(p, "scale", 1.0) or 1.0)
        if ltype in _UNPORTED_LIGHTS:
            raise _unported(f"LightSource {ltype!r}", 11)
        if ltype == "infinite":
            if _get(p, "filename") or _get_vec(p, "portal") is not None:
                raise _unported("image-based or portal infinite light", 11)
            L = _get_vec(p, "L")
            self.infinite = {
                "rgb": tuple(L) if L is not None else (1.0, 1.0, 1.0),
                "scale": scale,
            }
        else:
            self.warnings.append(f"light {ltype} unsupported; skipped")

    # -- shapes --------------------------------------------------------------

    def _emit_triangles(self, tris_world):
        n = len(tris_world)
        if n == 0:
            self._pending_uv = None
            return
        uvs = self._pending_uv
        self._pending_uv = None
        if uvs is None:
            uvs = np.broadcast_to(self._UV_IDENTITY, (n, 3, 2))
        v = np.asarray(tris_world).astype(np.float32)
        if self.reverse:
            uvs = uvs[:, ::-1]
            v = v[:, ::-1]
        light = np.full((n,), -1, np.int32)
        if self.cur_area_light is not None:
            base = len(self.area_lights)
            light = np.arange(base, base + n, dtype=np.int32)
            self.area_lights.extend(
                {"verts": v[i].copy(), **self.cur_area_light} for i in range(n)
            )
        self._append(v, np.full((n,), self.cur_material, np.int32), light,
                     np.arange(n, dtype=np.int32), uvs)

    def _append(self, v, mat, light, face, uvs):
        self.tris.append(np.ascontiguousarray(v, np.float32))
        self.tri_mat.append(mat)
        self.tri_light.append(light)
        self.tri_face.append(face)
        self.tri_uv.append(np.asarray(uvs, np.float32))
        self.n_tris += len(v)

    def _d_Shape(self, ts):
        stype = ts.next()[1:-1]
        p = _parse_params(ts)
        if "alpha" in p:
            ptype, vals = p["alpha"]
            if ptype == "texture" or float(vals[0]) != 1.0:
                raise _unported("shape alpha", 7)
        _no_textures(p, f"shape {stype!r}")
        if stype in _UNPORTED_SHAPES:
            raise _unported(f"shape {stype!r}", 8)
        if stype == "trianglemesh":
            pts = _get_vec(p, "P").reshape(-1, 3)
            idx = np.asarray(p["indices"][1], np.int64).reshape(-1, 3)
            tris = self._pts(pts)[idx]
            uv = _get_vec(p, "uv")
            if uv is None:
                uv = _get_vec(p, "st")
            if uv is not None:
                self._pending_uv = np.asarray(uv, np.float32).reshape(-1, 2)[idx]
        elif stype == "plymesh":
            verts, faces = read_ply(os.path.join(self.base_dir, _get(p, "filename")))
            tris = self._pts(verts)[faces]
        else:
            self.warnings.append(f"shape {stype} unknown; skipped")
            return
        if self.cur_object is not None:
            # As in the reference, a shape inside ObjectBegin/End neither
            # stores nor clears the pending uv table (ROADMAP Queue 3); no
            # ported feature reads uv, so parity holds either way.
            self.objects[self.cur_object].append(
                (tris, self.cur_material, self.cur_area_light)
            )
        else:
            self._emit_triangles(tris)

    # -- instancing ----------------------------------------------------------

    def _d_ObjectBegin(self, ts):
        name = ts.next()[1:-1]
        self.cur_object = name
        self.objects[name] = []
        self._d_AttributeBegin(ts)
        self.object_base[name] = self.ctm.copy()

    def _d_ObjectEnd(self, ts):
        self._d_AttributeEnd(ts)
        self.cur_object = None

    def _object_local(self, name, tris):
        """An object's triangles, stored under the CTM of its ObjectBegin,
        back in the object's own space."""
        base_inv = np.linalg.inv(self.object_base[name])
        return (tris.reshape(-1, 3) @ base_inv[:3, :3].T
                + base_inv[:3, 3]).reshape(-1, 3, 3)

    def _d_ObjectInstance(self, ts):
        """Record (prototype, transform): geometry stays unique and the
        sweep accelerator walks each instance. Emissive objects are
        flattened into world-space copies, as in the reference (pbrt itself
        refuses area lights under instancing)."""
        name = ts.next()[1:-1]
        entries = self.objects.get(name, [])
        if not entries:
            return
        if any(area is not None for _, _, area in entries):
            self.warnings.append(
                f"ObjectInstance '{name}': emissive object flattened "
                "(reference: area lights unsupported under instancing)"
            )
            saved = (self.cur_material, self.cur_area_light)
            for tris, mat, area in entries:
                local = self._object_local(name, tris).reshape(-1, 3)
                h = np.concatenate([local, np.ones((len(local), 1))], axis=1)
                world = (h @ self.ctm.T)[:, :3].reshape(-1, 3, 3)
                self.cur_material, self.cur_area_light = mat, area
                self._emit_triangles(world)
            self.cur_material, self.cur_area_light = saved
            return
        o2w_end = self.ctm_end if self.ctm_end is not None else self.ctm
        self.instances.append((name, self.ctm.copy(), o2w_end.copy()))

    def _build_instances(self):
        """Append the prototypes' triangles (object space, once each) and
        return (proto_ranges, proto_id, o2w, o2w_end), or None when no
        instance was recorded. The root geometry is prototype 0 under one
        identity instance."""
        if not self.instances:
            return None
        proto_ranges = []
        name_to_pid = {}
        inst_pid, inst_o2w, inst_o2w_end = [], [], []
        if self.n_tris:
            proto_ranges.append((0, self.n_tris))
            inst_pid.append(0)
            inst_o2w.append(np.eye(4, dtype=np.float32))
            inst_o2w_end.append(np.eye(4, dtype=np.float32))
        for name, o2w, o2w_end in self.instances:
            if name not in name_to_pid:
                start = self.n_tris
                for tris, mat, _area in self.objects[name]:
                    local = self._object_local(name, tris).astype(np.float32)
                    n = len(local)
                    # The reference gives prototype triangles the identity
                    # uv table whatever the shape declared (ROADMAP Queue 3).
                    self._append(local, np.full((n,), mat, np.int32),
                                 np.full((n,), -1, np.int32),
                                 np.arange(n, dtype=np.int32),
                                 np.broadcast_to(self._UV_IDENTITY, (n, 3, 2)))
                name_to_pid[name] = len(proto_ranges)
                proto_ranges.append((start, self.n_tris - start))
            inst_pid.append(name_to_pid[name])
            inst_o2w.append(o2w.astype(np.float32))
            inst_o2w_end.append(o2w_end.astype(np.float32))
        return (proto_ranges, np.asarray(inst_pid, np.int32),
                np.stack(inst_o2w), np.stack(inst_o2w_end))

    # -- finalize ------------------------------------------------------------

    def build(self):
        """Returns (scene, camera, settings dict), on the CPU."""
        inst_tables = self._build_instances()

        def cat(parts, shape, dtype):
            if not parts:
                return np.zeros((0, *shape), dtype)
            return np.concatenate(parts).astype(dtype, copy=False)

        tri_verts = cat(self.tris, (3, 3), np.float32)
        geom = GeometryBuffers.build(
            tri_verts=tri_verts,
            tri_mat=cat(self.tri_mat, (), np.int32),
            tri_light=cat(self.tri_light, (), np.int32),
            tri_face=cat(self.tri_face, (), np.int32),
            tri_uv=cat(self.tri_uv, (3, 2), np.float32),
        )
        scene = Scene(
            geom=geom,
            materials=MaterialBuffers.build(self.materials),
            lights=LightBuffers.build(area_tris=self.area_lights,
                                      infinite=self.infinite),
        )
        if inst_tables is not None:
            proto_ranges, pid, o2w, o2w_end = inst_tables
            if (np.abs(o2w - o2w_end).max(axis=(1, 2)) > 1e-7).any():
                raise _unported("animated ObjectInstance (ActiveTransform)", 7)
            scene = scene.replace(sweep=build_sweep(
                tri_verts, proto_ranges=proto_ranges, instances=(pid, o2w)))
        else:
            scene = scene.with_accel()

        c2w = np.linalg.inv(self.world_to_camera)
        camera = PerspectiveCamera(
            camera_to_world=tfm.Transform.from_matrix(c2w.astype(np.float32)),
            resolution=self.resolution,
            fov_deg=float(_get(self.camera_params, "fov", 90.0)),
        )
        max_depth = int(_get(self.integrator_params, "maxdepth", 5))
        settings = {
            "spp": self.spp,
            "sampler": self.sampler_kind,
            "integrator": PathIntegrator(max_depth=max_depth),
            "warnings": self.warnings,
        }
        return scene, camera, settings


def _on(device, scene, camera, settings):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"load_pbrt(device={str(device)!r}): no CUDA "
                           "device is available")
    return scene.to(device), camera.to(device), settings


def load_pbrt(path: str, device="cuda"):
    """Parse a .pbrt file onto `device` (the card unless the caller asks
    for the CPU). Returns (scene, camera, settings)."""
    return _on(device, *PbrtParser().parse_file(path).build())


def load_pbrt_string(text: str, base_dir: str = ".", device="cuda"):
    """Parse .pbrt text, resolving file names against base_dir."""
    return _on(device, *PbrtParser(base_dir).parse_string(text).build())
