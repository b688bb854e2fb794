""".pbrt scene-description parser -> (Scene, camera, settings).

Port of pbrt_tpu/io/parser.py, numpy only up to the builders: the same
tokens, parameter lists, float64 graphics state and instancing rules, so a
file parses to the same triangles, materials, lights and camera as in the
reference. The directive subset:

  transforms: Identity LookAt Translate Rotate Scale Transform ConcatTransform
              CoordinateSystem CoordSysTransform TransformTimes ActiveTransform
  state:      AttributeBegin/End TransformBegin/End ObjectBegin/End
              ObjectInstance ReverseOrientation WorldBegin/End Include Import
  options:    Camera "perspective", and "realistic" / "omni" with a
              "lensfile" (.dat, or an omni .json with its microlens
              block; "filmdiag", "diffractionEnabled",
              "microlenssensoroffset", "microlenssimulationradius"),
              Film "rgb", Sampler independent / random, stratified,
              sobol, paddedsobol, zsobol, halton and pmj02bn,
              Integrator path/simplepath/volpath/simplevolpath (a path
              integrator becomes volpath when the scene has media, with
              the reference's warning), bdpt, mlt, sppm, lightpath and
              function with the reference's parameters and defaults, and
              ambientocclusion / randomwalk (pbrt-v4's, which the
              reference renders as a path trace); any other name raises
              ValueError, where the reference renders a path trace; a
              light tracer on a scene with media raises ValueError;
              Filter, Accelerator, Option and ColorSpace are consumed
  scene:      Material / MakeNamedMaterial / NamedMaterial (diffuse and the
              names the reference maps to it, conductor, dielectric / glass,
              thindielectric, diffusetransmission, coateddiffuse,
              coatedconductor, hair, subsurface, measured (an RGL .bsdf
              file or a baked .npy table), mix, retroreflective, and
              "" / "none" / "interface", the material-less boundary), a
              texture-typed "reflectance" or "albedo",
              Texture (constant, checkerboard, scale, mix, directionmix,
              bilerp, dots, fbm, wrinkled, windy, marble, imagemap, ptex),
              Shape trianglemesh, plymesh, sphere (analytic outside objects; an
              emissive one is a sphere light, or an icosphere when reversed
              or inside an object, as in the reference), disk (analytic;
              64 segments when emissive or under an anisotropic scale),
              cylinder (analytic and open; 64 x 2 triangles when
              emissive), bilinearmesh (analytic patches; a 4 x 4 grid of
              quads each when emissive), loopsubdiv and curve (bezier or
              bspline, flattened to round segments), each with an "alpha"
              (a float or a float texture), AreaLightSource "diffuse"
  lights:     LightSource point, spot, distant, projection, goniometric and
              infinite (uniform "rgb L", an image "string filename", a
              "point3 portal" over either); light and texture images are
              EXR, PFM, PNG or QOI (io/image.py, the reference's readers)
  media:      MakeNamedMedium homogeneous (without p0/p1 an interior-media
              stack entry, with them the scene-level AABB medium),
              uniformgrid / grid (with Le, Lescale), cloud, rgbgrid and
              nanovdb (a density grid read from a .nvdb file, its world
              bounds through the CTM);
              MediumInterface (per-shape material clones carrying the
              inside / outside stack indices; a grid-like medium binds the
              scene level)

Triangle meshes' buffers and PLY reads go through the reference's
BufferCache (io/buffercache.py), which shares repeated ones. A
texture-typed material parameter other than the reflectance raises
ValueError: the reference has none (its parser takes float() of the
texture's name). Where the reference approximates and
warns ("material X approximated as diffuse", unknown directives and
shapes, a texture used before it is defined), the port does the same,
since that is the reference's behaviour. Eight departures raise where the
reference warns and renders something else: an unknown light type
(pbrt-v4 stops on one too), a light image that cannot be read (the
reference renders the light with its constant I or L), an unknown Texture
class (the reference binds 0.5 gray), an imagemap whose image cannot be
read (the reference binds a 0.5 gray image), a Ptex texture whose .ptx
file cannot be read (the reference binds one 0.5 gray face), a "nanovdb"
medium whose .nvdb file or grid cannot be read (the reference warns and
skips the medium), a measured material with no readable table (the
reference binds a gray table) and a mix that names an undefined material
(the reference falls back to diffuse). Four more
raise ValueError where the reference renders something else: a camera
type other than perspective, realistic and omni (the reference loads it
as perspective with a warning), a realistic or omni camera without a
lensfile or whose lens file does not load (the reference warns and
renders the perspective camera), a film type other than rgb (the
reference reads it as rgb) and an unknown sampler name (the reference
renders the independent sampler). Another
raises ValueError where the reference renders a fault: an analytic shape
(a non-emissive sphere, disk, cylinder or bilinear mesh, or a curve)
inside ObjectBegin, which the reference draws once in world space under
the ObjectBegin transform and no instance carries.

Instancing is true instancing: an instanced prototype's triangles are
stored once in object space and the sweep accelerator (ops/sweep.py, K3)
walks each static instance under its transform. An instance whose
ActiveTransform keyframes differ (by more than 1e-7) moves over the
TransformTimes interval: it is an animated instance (accel/instances.py),
intersected per ray time after the sweep. Emissive objects are flattened
into world-space copies, with the reference's warning.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from ..cameras.perspective import PerspectiveCamera
from ..core import transform as tfm
from ..lights.buffers import LightBuffers
from ..materials.buffers import (
    MAT_COATEDCONDUCTOR,
    MAT_COATEDDIFFUSE,
    MAT_CONDUCTOR,
    MAT_DIELECTRIC,
    MAT_DIFFUSE,
    MAT_DIFFUSETRANS,
    MAT_HAIR,
    MAT_INTERFACE,
    MAT_MEASURED,
    MAT_MIX,
    MAT_RETRO,
    MAT_SUBSURFACE,
    MAT_THINDIELECTRIC,
    MaterialBuffers,
)
from ..media.medium import MED_VACUUM, MediumBuffers, MediumStack
from ..models.path import PathIntegrator
from ..models.volpath import VolPathIntegrator
from ..native import tokenize_native
from ..lights.envmap import EnvironmentMap
from ..lights.portal import PortalLight
from ..ops.sweep import build_sweep
from ..scene import Scene
from ..accel.instances import build_animated_instances
from ..scenes.meshes import icosphere
from ..shapes.curve import build_curve_segments
from ..shapes.geometry import GeometryBuffers
from ..shapes.subdiv import loop_subdivide
from ..textures.buffers import TextureBuffers
from .buffercache import BufferCache
from .image import read_image_rgb
from .nanovdb import read_nanovdb
from .ptex import read_ptex


# Sampler names and the kinds they build (the reference's mapping).
SAMPLERS = {
    "independent": "independent", "random": "independent",
    "stratified": "stratified", "sobol": "sobol", "paddedsobol": "padded",
    "zsobol": "zsobol", "halton": "halton", "pmj02bn": "pmj02bn",
}

# What a reader raises on a file it cannot read: missing, of an unknown
# format, truncated or corrupt, or without the named grid.
_READ_ERRORS = (OSError, ValueError, KeyError, struct.error, zlib.error)

# Integrator names the parser builds: the reference's, and pbrt-v4's
# ambientocclusion and randomwalk.
INTEGRATORS = ("path", "simplepath", "volpath", "simplevolpath", "bdpt",
               "mlt", "sppm", "lightpath", "function", "ambientocclusion",
               "randomwalk")


def tokenize(text: str):
    """pbrt tokens: strings, brackets, numbers/identifiers; # comments.
    The native C++ pass (native/tokenizer.cpp), built on first use; a
    failed build raises. `tokenize_py` is its plain twin."""
    return tokenize_native(text)


def tokenize_py(text: str):
    """tokenize in Python (the reference's pure-Python tokenizer, its
    behavioural spec)."""
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

# Material parameters that may name a texture (the albedo overlay). The
# reference has no other texture-typed material parameter: its parser
# takes float() of a texture-typed roughness's or eta's name, which raises,
# and so does the port's, on any other texture-typed parameter.
_TEXTURED_PARAMS = ("reflectance", "albedo")


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


def _no_textures(params, where: str, allowed=()):
    for name, (ptype, _) in params.items():
        if ptype == "texture" and name not in allowed:
            raise ValueError(
                f"texture parameter {name!r} of {where}: the reference has "
                "no texture-typed roughness, eta or other material "
                "parameter; only the reflectance binds a texture")


class PbrtParser:
    """Stateful scene builder (BasicSceneBuilder, scene.cpp:57-230)."""

    _UV_IDENTITY = np.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]], np.float32)

    def __init__(self, base_dir="."):
        self.base_dir = base_dir
        self.ctm = np.eye(4)
        self.stack = []
        self.named_ctm = {}
        # Mesh-buffer dedup (the reference's BufferCache, util/buffercache.h).
        self.buffer_cache = BufferCache()
        # graphics state
        self.cur_material = 0
        self.cur_area_light = None
        self.reverse = False
        # collected scene; per-shape arrays, concatenated at build
        self.materials = [{"kind": MAT_DIFFUSE, "albedo": (0.5, 0.5, 0.5)}]
        self.named_materials = {}
        self.tex_specs = []  # TextureBuffers rows
        self.named_tex = {}  # texture name -> row
        self.tris = []  # (n, 3, 3) float32 per emitted shape
        self.tri_mat = []
        self.tri_light = []
        self.tri_face = []
        self.tri_uv = []
        # Alpha masks (GeometricPrimitive alpha, cpu/primitive.h:59-63):
        # each triangle's (constant, texture id), from its shape's "alpha".
        self.tri_alpha = []
        self.tri_alpha_tex = []
        self.cur_alpha = (1.0, -1)
        self.n_tris = 0
        self._pending_uv = None  # (n, 3, 2) for the shape being emitted
        self.spheres = []  # [cx, cy, cz, r] in world space
        self.sph_mat = []
        self.sph_light = []  # per sphere: index into sphere_lights, or -1
        self.sphere_lights = []  # emissive analytic spheres: c, r, rgb, ...
        self.curves = []  # curve specs for build_curve_segments
        self.disks = []  # (row, material)
        self.cyls = []
        self.blps = []
        self.area_lights = []
        self.points = []
        self.spots = []
        self.distants = []
        self.projections = []
        self.gonios = []
        self.infinite = None
        self.envmap = None  # EnvironmentMap or PortalLight
        # camera / settings
        # media: named media, the interior-media stack specs and their
        # indices, the scene-level medium and the current MediumInterface
        self.named_media = {}
        self.media_specs = []
        self.named_media_idx = {}
        self.scene_medium = None
        self.cur_interface = None  # (inside_idx, outside_idx) or None
        self._interface_mat_cache = {}
        self.any_interface = False
        self.camera_params = {}
        self.world_to_camera = np.eye(4)
        self.resolution = (256, 256)
        self.integrator = "path"
        self.integrator_params = {}
        self.sampler_kind = "independent"
        self.spp = 16
        self.camera_type = "perspective"
        # objects (instancing): name -> [(tris, material, area light)]
        self.objects = {}
        self.cur_object = None
        self.object_base = {}
        # Recorded (name, object_to_world, o2w_end) instance references; the
        # shutter interval of moving ones.
        self.instances = []
        self.transform_times = (0.0, 1.0)
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
        if self.integrator not in INTEGRATORS:
            # The reference renders an unknown name as a path trace.
            raise ValueError(
                f"unknown Integrator {self.integrator!r}; the port builds "
                f"{', '.join(INTEGRATORS)}")

    def _integrator(self, has_media: bool):
        """The file's integrator, with the reference's parameters and
        defaults (pbrt_tpu/io/parser.py's integrator block)."""
        p = self.integrator_params
        name = self.integrator
        max_depth = int(_get(p, "maxdepth", 5))
        if name in ("path", "simplepath", "volpath", "simplevolpath"):
            if name in ("volpath", "simplevolpath"):
                return VolPathIntegrator(max_depth=max_depth)
            if has_media:
                # Media need the null-scattering walk; pbrt errors, the
                # reference upgrades (render.cpp's integrator/media check).
                self.warnings.append("scene has media; integrator upgraded "
                                     "to volpath")
                return VolPathIntegrator(max_depth=max_depth)
            return PathIntegrator(max_depth=max_depth)
        if has_media:
            raise ValueError(f"Integrator {name!r} does not trace "
                             "participating media; use volpath")
        if name == "mlt":
            from ..models.mlt import MLTIntegrator

            return MLTIntegrator(
                base=PathIntegrator(max_depth=max_depth),
                n_chains=int(_get(p, "chains", 4096)),
                sigma=float(_get(p, "sigma", 0.01)),
                p_large=float(_get(p, "largestepprobability", 0.3)))
        if name == "bdpt":
            from ..models.bdpt import BDPTIntegrator

            return BDPTIntegrator(max_depth=max_depth)
        if name == "lightpath":
            from ..models.lightpath import LightPathIntegrator

            return LightPathIntegrator(max_depth=max_depth)
        if name == "function":
            from ..models.function import FunctionIntegrator

            return FunctionIntegrator(
                func=str(_get(p, "function", "quadratic")))
        if name == "sppm":
            from ..models.sppm import SPPMIntegrator

            return SPPMIntegrator(max_depth=max_depth,
                                  initial_radius=float(_get(p, "radius", 0.0)))
        from ..models.ao import AOIntegrator, RandomWalkIntegrator

        if name == "ambientocclusion":
            return AOIntegrator(
                max_distance=float(_get(p, "maxdistance", 1e30)))
        return RandomWalkIntegrator(max_depth=max_depth)

    def _d_Sampler(self, ts):
        kind = ts.next()[1:-1]
        p = _parse_params(ts)
        if kind not in SAMPLERS:
            # The reference renders an unknown name with the independent
            # sampler (pbrt_tpu/io/parser.py:306).
            raise ValueError(f"unknown Sampler {kind!r}; the samplers are "
                             f"{sorted(SAMPLERS)}")
        self.sampler_kind = SAMPLERS[kind]
        self.spp = int(_get(p, "pixelsamples", 16))

    def _d_Film(self, ts):
        kind = ts.next()[1:-1]
        p = _parse_params(ts)
        if kind != "rgb":
            # The reference reads any film type as an RGB film
            # (pbrt_tpu/io/parser.py:309-310).
            raise ValueError(f"Film {kind!r}: the file entry develops an "
                             "RGB film only; render a GBuffer with "
                             "films/gbuffer.py::render_aovs")
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
        if kind not in ("perspective", "realistic", "omni"):
            # The reference loads another type as perspective with a
            # warning (pbrt_tpu/io/parser.py:1634-1638).
            raise ValueError(f"Camera {kind!r}: the file entry builds the "
                             "perspective, realistic and omni cameras; build "
                             "the others from pbrt_tpu_torch.cameras")
        self.camera_type = kind
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
             self.reverse, self.cur_interface,
             None if self.ctm_end is None else self.ctm_end.copy(),
             self.active_transform)
        )

    def _d_AttributeEnd(self, ts):
        (self.ctm, self.cur_material, self.cur_area_light, self.reverse,
         self.cur_interface, self.ctm_end,
         self.active_transform) = self.stack.pop()

    _d_TransformBegin = _d_AttributeBegin
    _d_TransformEnd = _d_AttributeEnd

    def _d_ReverseOrientation(self, ts):
        self.reverse = not self.reverse

    def _d_TransformTimes(self, ts):
        """TransformTimes start end: the shutter interval of animated
        transforms (scene.cpp TransformTimes)."""
        self.transform_times = (float(ts.next()), float(ts.next()))

    def _d_ActiveTransform(self, ts):
        """ActiveTransform StartTime|EndTime|All: which CTM keyframe later
        transform directives update. Differing keyframes on an
        ObjectInstance make it an animated instance."""
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
        _no_textures(p, f"material {mtype!r}", _TEXTURED_PARAMS)
        spec = {"kind": MAT_DIFFUSE, "albedo": (0.5, 0.5, 0.5)}
        refl = _get_vec(p, "reflectance")
        if refl is None:
            refl = _get_vec(p, "albedo")
        # A texture-typed reflectance binds the named texture by id
        # (TextureParameterDictionary::GetSpectrumTexture).
        tex_id = self._tex_ref(p, "reflectance")
        if tex_id < 0:
            tex_id = self._tex_ref(p, "albedo")
        if tex_id >= 0:
            spec["albedo_texture"] = tex_id
        if mtype in ("none", "interface", ""):
            # A pure media boundary: rays pass straight through, switching
            # media (material-less shapes with a MediumInterface).
            spec["kind"] = MAT_INTERFACE
        elif mtype == "subsurface":
            # SubsurfaceMaterial: sigma_a and sigma_s give the single-
            # scattering albedo and the mean free path of the Burley
            # profile (materials/bssrdf.py).
            spec["kind"] = MAT_SUBSURFACE
            sa = _get_vec(p, "sigma_a")
            ssv = _get_vec(p, "sigma_s")
            spec["eta"] = float(_get(p, "eta", 1.33))
            if sa is not None or ssv is not None:
                sa = np.asarray(sa if sa is not None else (0.0011, 0.0024, 0.014))
                ssv = np.asarray(ssv if ssv is not None else (2.55, 3.21, 3.77))
                st = np.maximum(sa + ssv, 1e-6)
                spec["albedo"] = tuple(ssv / st)
                spec["mfp"] = tuple(1.0 / st)
            else:
                m_ = _get_vec(p, "mfp")
                spec["mfp"] = (
                    tuple(m_) if m_ is not None and len(np.atleast_1d(m_)) == 3
                    else ((float(m_),) * 3 if m_ is not None else (0.2,) * 3))
        elif mtype == "retroreflective":
            # The ISET fork's RetroreflectiveBxDF: conductor microfacet
            # parameters and the wo-peaked retro lobe.
            spec["kind"] = MAT_RETRO
            spec["roughness"] = float(_get(p, "roughness", 0.05) or 0.05)
            spec["conductor"] = _get(p, "conductor", "Al")
        elif mtype == "mix":
            # MixMaterial: "string materials" names two named materials
            # defined before it; amount is the probability of the first.
            # The reference falls back to diffuse when a name is not
            # defined; the port raises.
            names = _get(p, "materials")
            pair = [names] if isinstance(names, str) else list(names or [])
            missing = [nm for nm in pair if nm not in self.named_materials]
            if len(pair) != 2 or missing:
                raise ValueError(
                    f"mix material: \"materials\" must name two defined "
                    f"named materials (got {pair}, undefined {missing})")
            spec["kind"] = MAT_MIX
            spec["mix_m0"] = self.named_materials[pair[0]]
            spec["mix_m1"] = self.named_materials[pair[1]]
            spec["mix_amount"] = float(_get(p, "amount", 0.5))
        elif mtype == "measured":
            # MeasuredBxDF: an RGL .bsdf file, read exactly and baked into
            # the half-angle table (materials/rgl.py), or a baked
            # (N_TH, N_TD, N_PD, 3) .npy table. The reference warns and
            # binds a gray table when neither can be read; the port raises.
            spec["kind"] = MAT_MEASURED
            spec["measured_table"] = self._measured_table(_get(p, "filename"))
        elif mtype == "hair":
            # pbrt-v4's HairMaterial::Create: sigma_a, else reflectance,
            # else eumelanin / pheomelanin (eumelanin 1.3 by default).
            from ..materials import hair as hair_mod

            spec["kind"] = MAT_HAIR
            spec["roughness"] = float(_get(p, "beta_m", 0.3) or 0.3)
            spec["coat_roughness"] = float(_get(p, "beta_n", 0.3) or 0.3)
            spec["eta"] = float(_get(p, "eta", 1.55) or 1.55)
            spec["hair_alpha"] = float(_get(p, "alpha", 2.0) or 2.0)
            sig = _get_vec(p, "sigma_a")
            if sig is None and refl is not None:
                sig = hair_mod.sigma_a_from_reflectance(
                    np.asarray(refl, np.float32), spec["coat_roughness"]
                ).numpy()
            if sig is None:
                ce = float(_get(p, "eumelanin", 1.3) or 1.3)
                cp = float(_get(p, "pheomelanin", 0.0) or 0.0)
                sig = hair_mod.sigma_a_from_concentration(ce, cp).numpy()
            if len(np.atleast_1d(sig)) == 3:
                spec["hair_sigma_a"] = tuple(np.asarray(sig, float))
            refl = None  # the reflectance is the pigment, not an albedo
        elif mtype in ("conductor", "metal"):
            spec["kind"] = MAT_CONDUCTOR
            spec["roughness"] = float(_get(p, "roughness", 0.01) or 0.01)
        elif mtype in ("dielectric", "glass"):
            spec["kind"] = MAT_DIELECTRIC
            spec["eta"] = float(_get(p, "eta", 1.5) or 1.5)
            spec["roughness"] = float(_get(p, "roughness", 0.0) or 0.0)
        elif mtype == "thindielectric":
            spec["kind"] = MAT_THINDIELECTRIC
            spec["eta"] = float(_get(p, "eta", 1.5) or 1.5)
        elif mtype == "diffusetransmission":
            spec["kind"] = MAT_DIFFUSETRANS
            # The reference defaults reflectance and transmittance to 0.25
            # (DiffuseTransmissionMaterial::Create).
            spec["albedo"] = (0.25, 0.25, 0.25)
            t = _get_vec(p, "transmittance")
            if t is not None and len(np.atleast_1d(t)) == 3:
                spec["transmittance"] = tuple(np.asarray(t, float))
        elif mtype == "coateddiffuse":
            spec["kind"] = MAT_COATEDDIFFUSE
            spec["roughness"] = float(_get(p, "roughness", 0.1) or 0.1)
            # The coat lobe's roughness is interface.roughness, as in the
            # reference's CoatedDiffuseMaterial, not the base's.
            spec["coat_roughness"] = float(
                _get(p, "interface.roughness", 0.05) or 0.05)
        elif mtype == "coatedconductor":
            spec["kind"] = MAT_COATEDCONDUCTOR
            spec["roughness"] = float(
                _get(p, "conductor.roughness", 0.05) or 0.05)
            spec["coat_roughness"] = float(
                _get(p, "interface.roughness", 0.05) or 0.05)
        elif mtype != "diffuse":
            # "matte" and unknown families, as the reference renders them.
            self.warnings.append(f"material {mtype} approximated as diffuse")
        if refl is not None and len(np.atleast_1d(refl)) == 3:
            spec["albedo"] = tuple(np.asarray(refl, float))
        return spec

    def _measured_table(self, fname):
        """The (N_TH, N_TD, N_PD, 3) table a measured material names."""
        if not fname:
            raise ValueError('measured material without a "filename"')
        path = os.path.join(self.base_dir, fname)
        try:
            if fname.endswith(".bsdf"):
                from ..materials.rgl import bake_rgl

                return bake_rgl(path)
            return np.load(path)
        except (OSError, ValueError, KeyError) as e:
            raise ValueError(f"measured material: cannot read {fname!r} "
                             f"({e})") from e

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
        """Texture "name" "type" "class" params: one TextureBuffers row,
        bound by materials through its id. An unknown class raises (the
        reference binds 0.5 gray and warns)."""
        name = ts.next()[1:-1]
        ts.next()  # "spectrum" or "float": one row layout for both
        tclass = ts.next()[1:-1]
        p = _parse_params(ts)
        spec = self._texture_spec(tclass, p)
        if spec is None:
            raise ValueError(f"Texture {name!r}: unknown texture class "
                             f"{tclass!r}")
        self.named_tex[name] = len(self.tex_specs)
        self.tex_specs.append(spec)

    def _tex_ref(self, p, key):
        """The texture id of a parameter declared `"texture key" "name"`,
        or -1 when absent or not texture-typed. A texture used before its
        definition is ignored with a warning, as in the reference."""
        if key in p and p[key][0] == "texture":
            tname = p[key][1][0]
            if tname in self.named_tex:
                return self.named_tex[tname]
            self.warnings.append(f"texture '{tname}' referenced before "
                                 "definition; ignored")
        return -1

    def _texture_spec(self, tclass, p):
        """One Texture directive as a TextureBuffers spec (the reference's
        CreateTexture dispatch, textures.cpp), or None for an unknown
        class."""

        def rgb(key, default):
            v = _get_vec(p, key)
            if v is None:
                return default
            v = np.atleast_1d(np.asarray(v, np.float64))
            return tuple(v) if v.size == 3 else (float(v[0]),) * 3

        def amount(key, default):
            # A texture-typed scale or amount is bound through sub2 and
            # keeps the default; the reference takes float() of the
            # texture's name and raises (ROADMAP Queue 3).
            if key in p and p[key][0] == "texture":
                return default
            return float(_get(p, key, default))

        spec = {
            "uscale": float(_get(p, "uscale", 1.0)),
            "vscale": float(_get(p, "vscale", 1.0)),
            "udelta": float(_get(p, "udelta", 0.0)),
            "vdelta": float(_get(p, "vdelta", 0.0)),
            "mapping": _get(p, "mapping", "uv"),
        }
        v1 = _get_vec(p, "v1")
        v2 = _get_vec(p, "v2")
        if v1 is not None:
            spec["aux0"] = tuple(v1)
        if v2 is not None:
            spec["aux1"] = tuple(v2)
        if tclass == "constant":
            spec.update(kind="constant", rgb0=rgb("value", (1.0, 1.0, 1.0)))
        elif tclass in ("checkerboard", "checker"):
            spec.update(
                kind="checker",
                rgb0=rgb("tex1", (1.0, 1.0, 1.0)),
                rgb1=rgb("tex2", (0.0, 0.0, 0.0)),
                sub0=self._tex_ref(p, "tex1"),
                sub1=self._tex_ref(p, "tex2"),
            )
        elif tclass == "scale":
            spec.update(
                kind="scale",
                rgb0=rgb("tex", (1.0, 1.0, 1.0)),
                sub0=self._tex_ref(p, "tex"),
                f0=amount("scale", 1.0),
                sub2=self._tex_ref(p, "scale"),
            )
        elif tclass == "mix":
            spec.update(
                kind="mix",
                rgb0=rgb("tex1", (0.0, 0.0, 0.0)),
                rgb1=rgb("tex2", (1.0, 1.0, 1.0)),
                sub0=self._tex_ref(p, "tex1"),
                sub1=self._tex_ref(p, "tex2"),
                f0=amount("amount", 0.5),
                sub2=self._tex_ref(p, "amount"),
            )
        elif tclass == "directionmix":
            d = _get_vec(p, "dir")
            spec.update(
                kind="directionmix",
                rgb0=rgb("tex1", (0.0, 0.0, 0.0)),
                rgb1=rgb("tex2", (1.0, 1.0, 1.0)),
                sub0=self._tex_ref(p, "tex1"),
                sub1=self._tex_ref(p, "tex2"),
                aux0=tuple(d) if d is not None else (0.0, 1.0, 0.0),
            )
        elif tclass == "bilerp":
            spec.update(
                kind="bilerp",
                rgb0=rgb("v00", (0.0, 0.0, 0.0)),
                rgb1=rgb("v01", (1.0, 1.0, 1.0)),
                rgb2=rgb("v10", (0.0, 0.0, 0.0)),
                rgb3=rgb("v11", (1.0, 1.0, 1.0)),
            )
        elif tclass == "dots":
            spec.update(
                kind="dots",
                rgb0=rgb("inside", (1.0, 1.0, 1.0)),
                rgb1=rgb("outside", (0.0, 0.0, 0.0)),
            )
        elif tclass in ("fbm", "wrinkled", "windy", "marble"):
            spec.update(kind=tclass)
            if tclass == "marble":
                spec.update(
                    rgb0=(0.08, 0.06, 0.06), rgb1=(0.9, 0.87, 0.83),
                    uscale=float(_get(p, "scale", 1.0)),
                )
        elif tclass == "imagemap":
            img = self._texture_image(_get(p, "filename"))
            spec.update(kind="image",
                        rgb_image=img * float(_get(p, "scale", 1.0)))
        elif tclass == "ptex":
            spec.update(kind="ptex",
                        ptex_faces=self._ptex_faces(_get(p, "filename")),
                        f0=float(_get(p, "scale", 1.0)))
        else:
            return None
        return spec

    def _texture_image(self, fname):
        """An imagemap's image. One that cannot be read raises (the
        reference binds a 0.5 gray image and warns)."""
        if not fname:
            raise ValueError("imagemap texture without a \"filename\"")
        try:
            return read_image_rgb(os.path.join(self.base_dir, fname))
        except _READ_ERRORS as e:
            raise ValueError(f"texture image {fname!r} cannot be read: {e}") from e

    def _ptex_faces(self, fname):
        """A Ptex texture's faces. A .ptx file that cannot be read raises
        (the reference binds one 0.5 gray face and warns)."""
        if not fname:
            raise ValueError("ptex texture without a \"filename\"")
        try:
            return read_ptex(os.path.join(self.base_dir, fname))[0]
        except _READ_ERRORS as e:
            raise ValueError(f"ptex file {fname!r} cannot be read: {e}") from e

    def _d_MakeNamedMedium(self, ts):
        """MakeNamedMedium "name" "string type" ... (media.cpp
        Medium::Create's homogeneous, uniformgrid, cloud, rgbgrid and
        nanovdb)."""
        name = ts.next()[1:-1]
        p = _parse_params(ts)
        mtype = _get(p, "type", "homogeneous")
        scale = float(_get(p, "scale", 1.0))
        g = float(_get(p, "g", 0.0))
        sa = _get_vec(p, "sigma_a")
        ss = _get_vec(p, "sigma_s")
        sa = tuple(sa) if sa is not None else (1.0, 1.0, 1.0)
        ss = tuple(ss) if ss is not None else (1.0, 1.0, 1.0)
        # Bounds: p0 / p1 in medium space through the CTM (the axis-aligned
        # subset, as in the reference).
        p0 = _get_vec(p, "p0")
        p1 = _get_vec(p, "p1")
        lo = np.asarray(p0 if p0 is not None else (0, 0, 0), np.float64)
        hi = np.asarray(p1 if p1 is not None else (1, 1, 1), np.float64)
        corners = self._pts(np.asarray([lo, hi], np.float64))
        blo = np.minimum(corners[0], corners[1])
        bhi = np.maximum(corners[0], corners[1])
        if mtype == "homogeneous":
            med = MediumBuffers.homogeneous(sa, ss, blo, bhi, g=g, scale=scale)
            # Without p0 / p1 (pbrt's homogeneous media have none) the
            # medium is shape-bounded, a stack entry for MediumInterface;
            # explicit bounds keep the scene-level AABB binding.
            if p0 is None and p1 is None:
                self.named_media_idx[name] = len(self.media_specs)
                self.media_specs.append(
                    {"sigma_a": sa, "sigma_s": ss, "g": g, "scale": scale})
        elif mtype in ("uniformgrid", "grid"):
            dens = _get_vec(p, "density")
            nx = int(_get(p, "nx", 1))
            ny = int(_get(p, "ny", 1))
            nz = int(_get(p, "nz", 1))
            if dens is None:
                self.warnings.append(f"medium {name}: no density grid; skipped")
                return
            le = _get_vec(p, "Le")
            med = MediumBuffers.grid(
                np.asarray(dens, np.float32).reshape(nz, ny, nx), sa, ss,
                blo, bhi, g=g, scale=scale,
                le_rgb=tuple(le) if le is not None else None,
                le_scale=float(_get(p, "Lescale", 1.0)),
            )
        elif mtype == "cloud":
            med = MediumBuffers.cloud(
                sa, ss, blo, bhi, g=g, scale=scale,
                density=float(_get(p, "density", 1.0)),
                wispiness=float(_get(p, "wispiness", 1.0)),
                frequency=float(_get(p, "frequency", 5.0)),
            )
        elif mtype == "rgbgrid":
            nx = int(_get(p, "nx", 1))
            ny = int(_get(p, "ny", 1))
            nz = int(_get(p, "nz", 1))
            shape = (nz, ny, nx, 3)

            def grid(v, const):
                if v is not None and np.asarray(v).size == nz * ny * nx * 3:
                    return np.asarray(v, np.float32).reshape(shape)
                return np.broadcast_to(np.asarray(const, np.float32), shape)

            med = MediumBuffers.rgbgrid(
                grid(_get_vec(p, "sigma_a"), sa),
                grid(_get_vec(p, "sigma_s"), ss), blo, bhi, g=g, scale=scale)
        elif mtype == "nanovdb":
            # NanoVDBMedium (media.h): the density grid from the .nvdb
            # file; its world bounds come from the grid, then the CTM.
            fn = _get(p, "filename")
            if not fn:
                self.warnings.append(f"medium {name}: nanovdb needs filename")
                return
            gname = _get(p, "gridname", "density")
            try:
                nv = read_nanovdb(os.path.join(self.base_dir, fn), gname)
            except _READ_ERRORS as e:
                raise ValueError(f"medium {name!r}: the grid {gname!r} of "
                                 f"{fn!r} cannot be read: {e}") from e
            corners = self._pts(np.asarray([nv.world_min, nv.world_max],
                                           np.float64))
            med = MediumBuffers.grid(
                np.asarray(nv.values, np.float32), sa, ss,
                np.minimum(corners[0], corners[1]),
                np.maximum(corners[0], corners[1]), g=g, scale=scale,
                le_scale=float(_get(p, "LeScale", 1.0)),
            )
        else:
            self.warnings.append(f"medium type {mtype} unsupported; skipped")
            return
        self.named_media[name] = med

    def _d_MediumInterface(self, ts):
        """MediumInterface "inside" "outside": homogeneous named media
        attach per shape (the following shapes of this attribute scope
        carry the stack indices, and rays switch on transmission); a grid,
        cloud or bounded homogeneous medium binds the scene level. ""
        means vacuum."""
        inside = ts.next()[1:-1]
        outside = ""
        if ts.peek() and ts.peek().startswith('"'):
            outside = ts.next()[1:-1]

        def resolve(nm):
            if not nm:
                return MED_VACUUM
            if nm in self.named_media_idx:
                return self.named_media_idx[nm]
            if nm in self.named_media:
                return None  # scene-level medium
            self.warnings.append(f"medium '{nm}' not defined")
            return MED_VACUUM

        in_idx = resolve(inside)
        out_idx = resolve(outside)
        if in_idx is None or out_idx is None:
            name = inside if in_idx is None else outside
            if self.scene_medium is not None:
                self.warnings.append("multiple scene-level MediumInterface "
                                     "bindings; last one wins")
            self.scene_medium = self.named_media[name]
            return
        self.cur_interface = (in_idx, out_idx)

    def _interfaced_material(self):
        """The material of shapes under the current MediumInterface: the
        graphics-state material cloned with the (inside, outside) indices,
        one clone per (material, interface) pair."""
        iface = self.cur_interface
        if iface is None or iface == (MED_VACUUM, MED_VACUUM):
            return self.cur_material
        key = (self.cur_material, iface)
        hit = self._interface_mat_cache.get(key)
        if hit is not None:
            return hit
        mat = dict(self.materials[self.cur_material])
        mat["med_inside"] = iface[0]
        mat["med_outside"] = iface[1]
        idx = len(self.materials)
        self.materials.append(mat)
        self._interface_mat_cache[key] = idx
        self.any_interface = True
        return idx

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
        """The reference's light directives, through the CTM as it applies
        it (lights.cpp Light::Create)."""
        ltype = ts.next()[1:-1]
        p = _parse_params(ts)
        scale = float(_get(p, "scale", 1.0) or 1.0)

        def rgb(name):
            v = _get_vec(p, name)
            return tuple(v) if v is not None else (1, 1, 1)

        if ltype == "point":
            frm = _get_vec(p, "from", np.zeros(3))
            self.points.append({"p": tuple(self._pts(frm[None])[0]),
                                "rgb": rgb("I"), "scale": scale})
        elif ltype == "spot":
            frm = _get_vec(p, "from", np.zeros(3))
            to = _get_vec(p, "to", np.asarray([0.0, 0.0, 1.0]))
            self.spots.append(
                {"p": tuple(self._pts(frm[None])[0]),
                 "to": tuple(self._pts(to[None])[0]),
                 "rgb": rgb("I"), "scale": scale,
                 "coneangle": float(_get(p, "coneangle", 30.0)),
                 "conedelta": float(_get(p, "conedeltaangle", 5.0))})
        elif ltype == "distant":
            frm = _get_vec(p, "from", np.zeros(3))
            to = _get_vec(p, "to", np.asarray([0.0, 0.0, 1.0]))
            dw = self._pts(to[None])[0] - self._pts(frm[None])[0]
            self.distants.append({"dir": tuple(dw), "rgb": rgb("L"),
                                  "scale": scale})
        elif ltype == "projection":
            # An image projected through a perspective window; the CTM
            # places and orients the light (lights.h:482).
            self.projections.append(
                {"p": tuple(self._pts(np.zeros((1, 3)))[0]),
                 "to": tuple(self._pts(np.asarray([[0.0, 0.0, 1.0]]))[0]),
                 "fov": float(_get(p, "fov", 90.0)), "rgb": rgb("I"),
                 "rgb_image": self._light_image(p), "scale": scale})
        elif ltype == "goniometric":
            # An equal-area octahedral intensity image over direction
            # (lights.h:584).
            pos = self._pts(_get_vec(p, "from", np.zeros(3))[None])[0]
            self.gonios.append(
                {"p": tuple(pos), "to": tuple(pos + np.asarray([0.0, 0.0, 1.0])),
                 "rgb": rgb("I"), "rgb_image": self._light_image(p),
                 "scale": scale})
        elif ltype == "infinite":
            L = _get_vec(p, "L")
            self.infinite = {
                "rgb": tuple(L) if L is not None else (1.0, 1.0, 1.0),
                "scale": scale,
            }
            img = self._light_image(p)
            portal = _get_vec(p, "portal")
            if portal is not None:
                # PortalImageInfiniteLight (lights.h:738): the image, or the
                # constant L, seen through a rectangular portal.
                corners = self._pts(np.asarray(portal, np.float64).reshape(4, 3))
                if img is None:
                    img = np.ones((8, 16, 3), np.float32) * np.asarray(
                        self.infinite["rgb"], np.float32)
                self.envmap = PortalLight.build(np.asarray(img) * scale,
                                                corners)
                self.infinite = None
            elif img is not None:
                img = np.asarray(img) * scale
                # A square image is an equal-area octahedral map (pbrt-v4
                # requires it, lights.cpp ImageInfiniteLight); a 2:1 one is
                # taken as lat-long and resampled (imgtool makeequiarea).
                self.envmap = (EnvironmentMap.build(img)
                               if img.shape[0] == img.shape[1]
                               else EnvironmentMap.from_latlong(img))
                self.infinite = None
        else:
            # The reference warns and renders without it; pbrt-v4 itself
            # stops on an unknown light type, and so does the port.
            raise ValueError(f"LightSource {ltype!r}: unknown light type")

    def _light_image(self, p):
        """The light's "string filename" image, or None without one. An
        image that cannot be read raises (the reference warns and renders
        the light with its constant I or L)."""
        fname = _get(p, "filename")
        if not fname:
            return None
        try:
            return read_image_rgb(os.path.join(self.base_dir, fname))
        except _READ_ERRORS as e:
            raise ValueError(f"light image {fname!r} cannot be read: {e}") from e

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
                     np.arange(n, dtype=np.int32), uvs, self.cur_alpha)

    def _append(self, v, mat, light, face, uvs, alpha):
        n = len(v)
        self.tris.append(np.ascontiguousarray(v, np.float32))
        self.tri_mat.append(mat)
        self.tri_light.append(light)
        self.tri_face.append(face)
        self.tri_uv.append(np.asarray(uvs, np.float32))
        self.tri_alpha.append(np.full((n,), alpha[0], np.float32))
        self.tri_alpha_tex.append(np.full((n,), alpha[1], np.int32))
        self.n_tris += n

    def _d_Shape(self, ts):
        mat_save = self.cur_material
        self.cur_material = self._interfaced_material()
        try:
            self._shape(ts)
        finally:
            self.cur_material = mat_save

    def _shape(self, ts):
        stype = ts.next()[1:-1]
        p = _parse_params(ts)
        _no_textures(p, f"shape {stype!r}", ("alpha",))
        # The shape's alpha: a float texture or a constant.
        a_tex = self._tex_ref(p, "alpha")
        if a_tex >= 0:
            self.cur_alpha = (1.0, a_tex)
        else:
            try:
                self.cur_alpha = (float(_get(p, "alpha", 1.0)), -1)
            except (TypeError, ValueError):
                self.cur_alpha = (1.0, -1)
        analytic = self.cur_area_light is None
        if stype == "trianglemesh":
            pts = self.buffer_cache.canonical(_get_vec(p, "P").reshape(-1, 3))
            idx = self.buffer_cache.canonical(
                np.asarray(p["indices"][1], np.int64).reshape(-1, 3))
            tris = self._pts(pts)[idx]
            uv = _get_vec(p, "uv")
            if uv is None:
                uv = _get_vec(p, "st")
            if uv is not None:
                self._pending_uv = np.asarray(uv, np.float32).reshape(-1, 2)[idx]
        elif stype == "plymesh":
            verts, faces = self.buffer_cache.read_ply(
                os.path.join(self.base_dir, _get(p, "filename")))
            tris = self._pts(verts)[faces]
        elif stype == "sphere":
            self._sphere(p)
            return
        elif stype == "disk":
            tris = self._disk(p) if analytic else self._tessellate_disk(p)
            if tris is None:
                return
        elif stype == "cylinder":
            if analytic:
                self._cylinder(p)
                return
            tris = self._tessellate_cylinder(p)
        elif stype == "bilinearmesh":
            quads = _get_vec(p, "P").reshape(-1, 3)
            idx = _get_vec(p, "indices")
            if idx is not None:
                quads = quads[np.asarray(idx, np.int64).reshape(-1, 4)]
            else:
                quads = quads.reshape(-1, 4, 3)
            if analytic:
                self._outside_objects(stype)
                for qd in quads:
                    w = self._pts(qd.astype(np.float64))
                    # pbrt's vertex order: p00, p10, p01, p11.
                    self.blps.append((tuple(w.reshape(-1)), self.cur_material))
                return
            tris = self._tessellate_patches(quads)
        elif stype == "loopsubdiv":
            pts = _get_vec(p, "P").reshape(-1, 3)
            idx = _get_vec(p, "indices")
            if idx is None:
                self.warnings.append("loopsubdiv needs indices; skipped")
                return
            levels = int(_get(p, "levels", _get(p, "nlevels", 3)))
            vv, ff = loop_subdivide(pts, np.asarray(idx, np.int64).reshape(-1, 3),
                                    levels)
            tris = self._pts(vv.astype(np.float64))[ff]
        elif stype == "curve":
            # shapes.cpp CreateCurve: cubic bezier or bspline control
            # points, full widths; every type is treated as round.
            self._outside_objects(stype)
            w = float(_get(p, "width", 1.0))
            self.curves.append({
                "cp": self._pts(_get_vec(p, "P").reshape(-1, 3)).astype(
                    np.float32),
                "basis": _get(p, "basis", "bezier"),
                "width0": float(_get(p, "width0", w)),
                "width1": float(_get(p, "width1", w)),
                "mat": self.cur_material,
            })
            return
        else:
            self.warnings.append(f"shape {stype} unknown; skipped")
            return
        if self.cur_object is not None:
            # As in the reference, a shape inside ObjectBegin/End neither
            # stores nor clears the pending uv table (ROADMAP Queue 3); no
            # ported feature reads uv, so parity holds either way.
            self.objects[self.cur_object].append(
                (tris, self.cur_material, self.cur_area_light, self.cur_alpha)
            )
        else:
            self._emit_triangles(tris)

    def _outside_objects(self, stype):
        """Refuse an analytic shape inside ObjectBegin: the reference
        draws it once in world space under the ObjectBegin transform, and
        no instance carries it (ROADMAP Queue 3)."""
        if self.cur_object is not None:
            raise ValueError(
                f'a Shape "{stype}" inside ObjectBegin: the reference draws '
                "it once in world space, carried by no instance")

    def _disk(self, p):
        """An analytic disk (Disk::Intersect: a plane solve and a radius
        window) under a rigid, uniformly scaled CTM; under an anisotropic
        scale the tessellation, with the reference's warning."""
        r = float(_get(p, "radius", 1.0))
        ri = float(_get(p, "innerradius", 0.0))
        h = float(_get(p, "height", 0.0))
        c_w = self._pts(np.asarray([[0.0, 0.0, h]]))[0]
        e1 = self._pts(np.asarray([[1.0, 0.0, h]]))[0] - c_w
        e2 = self._pts(np.asarray([[0.0, 1.0, h]]))[0] - c_w
        s1, s2 = np.linalg.norm(e1), np.linalg.norm(e2)
        if abs(s1 - s2) < 1e-5 * max(s1, s2):
            self._outside_objects("disk")
            n_w = np.cross(e1, e2)
            n_w /= max(np.linalg.norm(n_w), 1e-12)
            self.disks.append((tuple(c_w) + tuple(n_w) + (r * s1, ri * s1),
                               self.cur_material))
            return None
        self.warnings.append("disk under anisotropic scale: tessellated")
        return self._tessellate_disk(p)

    def _tessellate_disk(self, p):
        r = float(_get(p, "radius", 1.0))
        ri = float(_get(p, "innerradius", 0.0))
        h = float(_get(p, "height", 0.0))
        seg = 64
        ang = np.linspace(0, 2 * np.pi, seg + 1)
        outer = np.stack([r * np.cos(ang), r * np.sin(ang),
                          np.full(seg + 1, h)], -1)
        inner = np.stack([ri * np.cos(ang), ri * np.sin(ang),
                          np.full(seg + 1, h)], -1)
        tris = []
        for i in range(seg):
            tris.append([inner[i], outer[i], outer[i + 1]])
            if ri > 0:
                tris.append([inner[i], outer[i + 1], inner[i + 1]])
        local = np.asarray(tris, np.float32).reshape(-1, 3)
        return self._pts(local).reshape(-1, 3, 3)

    def _cylinder(self, p):
        """An analytic open cylinder (Cylinder::Intersect): base point at
        the middle of [zmin, zmax], unit axis, radius and half length in
        world space."""
        r = float(_get(p, "radius", 1.0))
        z0 = float(_get(p, "zmin", -1.0))
        z1 = float(_get(p, "zmax", 1.0))
        zc = 0.5 * (z0 + z1)
        base_w = self._pts(np.asarray([[0.0, 0.0, zc]]))[0]
        top_w = self._pts(np.asarray([[0.0, 0.0, z1]]))[0]
        rad_w = self._pts(np.asarray([[1.0, 0.0, zc]]))[0] - base_w
        axis = top_w - base_w
        half = np.linalg.norm(axis)
        self._outside_objects("cylinder")
        if half > 1e-12:
            axis /= half
            self.cyls.append((tuple(base_w) + tuple(axis)
                              + (r * np.linalg.norm(rad_w), half),
                              self.cur_material))
        else:
            self.warnings.append("degenerate cylinder; skipped")

    def _tessellate_cylinder(self, p):
        r = float(_get(p, "radius", 1.0))
        z0 = float(_get(p, "zmin", -1.0))
        z1 = float(_get(p, "zmax", 1.0))
        seg = 64
        ang = np.linspace(0, 2 * np.pi, seg + 1)
        lo = np.stack([r * np.cos(ang), r * np.sin(ang), np.full(seg + 1, z0)], -1)
        hi = np.stack([r * np.cos(ang), r * np.sin(ang), np.full(seg + 1, z1)], -1)
        tris = []
        for i in range(seg):
            tris.append([lo[i], lo[i + 1], hi[i + 1]])
            tris.append([lo[i], hi[i + 1], hi[i]])
        local = np.asarray(tris, np.float32).reshape(-1, 3)
        return self._pts(local).reshape(-1, 3, 3)

    def _tessellate_patches(self, quads):
        """Each bilinear patch (p00, p10, p01, p11) as a 4 x 4 grid of
        quads, two triangles each."""
        tris = []
        k = 4
        for p00, p10, p01, p11 in quads:
            def bl(u, v):
                return ((1 - u) * (1 - v) * p00 + u * (1 - v) * p10
                        + (1 - u) * v * p01 + u * v * p11)
            for i in range(k):
                for j in range(k):
                    a = bl(i / k, j / k)
                    b = bl((i + 1) / k, j / k)
                    c = bl((i + 1) / k, (j + 1) / k)
                    d = bl(i / k, (j + 1) / k)
                    tris.append([a, b, c])
                    tris.append([a, c, d])
        world = self._pts(np.asarray(tris, np.float32).reshape(-1, 3))
        return world.reshape(-1, 3, 3)

    def _sphere(self, p):
        """An analytic sphere: the centre through the CTM and the radius
        times the norm of the CTM's first column (uniform scale assumed, as
        pbrt requires), as the reference builds it. An emissive sphere is a
        sphere light (exact geometry, cone-sampled NEE), or, reversed or
        inside an object, an emissive icosphere in world space, as in the
        reference."""
        r = float(_get(p, "radius", 1.0))
        center = self._pts(np.zeros((1, 3)))[0]
        sc = np.linalg.norm(self.ctm[:3, 0])
        if self.cur_area_light is not None:
            if self.reverse or self.cur_object is not None:
                self._emit_triangles(icosphere(2, r * sc, center))
                return
            self.sph_light.append(len(self.sphere_lights))
            self.sphere_lights.append(
                {"c": center, "r": r * sc, **self.cur_area_light})
        else:
            self._outside_objects("sphere")
            self.sph_light.append(-1)
        self.spheres.append([*center, r * sc])
        self.sph_mat.append(self.cur_material)

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
        if any(area is not None for _, _, area, _ in entries):
            self.warnings.append(
                f"ObjectInstance '{name}': emissive object flattened "
                "(reference: area lights unsupported under instancing)"
            )
            saved = (self.cur_material, self.cur_area_light, self.cur_alpha)
            for tris, mat, area, alpha in entries:
                local = self._object_local(name, tris).reshape(-1, 3)
                h = np.concatenate([local, np.ones((len(local), 1))], axis=1)
                world = (h @ self.ctm.T)[:, :3].reshape(-1, 3, 3)
                self.cur_material, self.cur_area_light = mat, area
                self.cur_alpha = alpha
                self._emit_triangles(world)
            self.cur_material, self.cur_area_light, self.cur_alpha = saved
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
                for tris, mat, _area, alpha in self.objects[name]:
                    local = self._object_local(name, tris).astype(np.float32)
                    n = len(local)
                    # The reference gives prototype triangles the identity
                    # uv table whatever the shape declared (ROADMAP Queue 3).
                    self._append(local, np.full((n,), mat, np.int32),
                                 np.full((n,), -1, np.int32),
                                 np.arange(n, dtype=np.int32),
                                 np.broadcast_to(self._UV_IDENTITY, (n, 3, 2)),
                                 alpha)
                name_to_pid[name] = len(proto_ranges)
                proto_ranges.append((start, self.n_tris - start))
            inst_pid.append(name_to_pid[name])
            inst_o2w.append(o2w.astype(np.float32))
            inst_o2w_end.append(o2w_end.astype(np.float32))
        return (proto_ranges, np.asarray(inst_pid, np.int32),
                np.stack(inst_o2w), np.stack(inst_o2w_end))

    # -- finalize ------------------------------------------------------------

    def _analytic(self) -> dict:
        """GeometryBuffers.build's curve, disk, cylinder and patch
        arguments."""
        out = {}
        if self.curves:
            out.update(zip(("crv", "crv_u", "crv_mat"),
                           build_curve_segments(self.curves)))
        for rows, key in ((self.disks, "disk"), (self.cyls, "cyl"),
                          (self.blps, "blp")):
            if rows:
                out[key] = np.asarray([r for r, _ in rows], np.float32)
                out[key + "_mat"] = np.asarray([m for _, m in rows], np.int32)
        return out

    def _lens_camera(self, c2w):
        """Camera "realistic" / "omni" with a lensfile (.dat, or an omni
        .json with an optional microlens block): the port's
        RealisticCamera, as the reference builds it
        (pbrt_tpu/io/parser.py:1581-1627)."""
        from ..cameras.lens import load_lens_file
        from ..cameras.realistic import RealisticCamera, load_lens_json

        p = self.camera_params
        lensfile = _get(p, "lensfile")
        if not lensfile:
            # The reference renders the perspective camera with a warning
            # (pbrt_tpu/io/parser.py:1629-1633).
            raise ValueError(f"Camera {self.camera_type!r} needs a "
                             "\"string lensfile\"")
        path = os.path.join(self.base_dir, lensfile)
        microlens = None
        try:
            if lensfile.endswith(".json"):
                lens, microlens = load_lens_json(
                    path,
                    # pbrt takes metres; the lens math keeps mm.
                    microlens_sensor_offset_mm=float(
                        _get(p, "microlenssensoroffset", 0.001)) * 1000.0,
                    sim_radius=int(_get(p, "microlenssimulationradius", 0)))
            else:
                lens = load_lens_file(path)
        except (OSError, ValueError, KeyError, TypeError, IndexError) as e:
            # The reference falls back to the perspective camera with a
            # warning (pbrt_tpu/io/parser.py:1624-1628).
            raise ValueError(f"lensfile {lensfile!r}: {e}") from e
        camera = RealisticCamera.create(
            camera_to_world=c2w, lens=lens, resolution=self.resolution,
            film_diag_mm=float(_get(p, "filmdiag", 35.0)),
            # No exit-pupil bounds behind a microlens relay
            # (OmniCamera::BoundExitPupil's early out).
            exit_pupil=microlens is None,
        ).replace(microlens=microlens,
                  diffraction=bool(_get(p, "diffractionEnabled", False)))
        if _get(p, "aperturediameter"):
            self.warnings.append("aperturediameter override not applied; "
                                 "edit the lens file's stop row instead")
        return camera

    def build(self):
        """Returns (scene, camera, settings dict), on the CPU."""
        self.buffer_stats = self.buffer_cache.report_stats()
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
            tri_alpha=cat(self.tri_alpha, (), np.float32),
            tri_alpha_tex=cat(self.tri_alpha_tex, (), np.int32),
            spheres=np.asarray(self.spheres, np.float32).reshape(-1, 4)
            if self.spheres else None,
            sph_mat=np.asarray(self.sph_mat, np.int32)
            if self.spheres else None,
            # Sphere-light ids follow the area triangles in the light list.
            sph_light=np.asarray(
                [len(self.area_lights) + q if q >= 0 else -1
                 for q in self.sph_light], np.int32)
            if self.spheres else None,
            **self._analytic(),
        )
        lights = LightBuffers.build(
            area_tris=self.area_lights, sphere_lights=self.sphere_lights,
            points=self.points, spots=self.spots,
            projections=self.projections, gonios=self.gonios,
            distants=self.distants, infinite=self.infinite,
            envmap=self.envmap,
        )
        media_stack = None
        if self.any_interface and self.media_specs:
            media_stack = MediumStack.build(self.media_specs)
        scene = Scene(geom=geom,
                      materials=MaterialBuffers.build(self.materials),
                      lights=lights,
                      textures=TextureBuffers.build(self.tex_specs)
                      if self.tex_specs else None,
                      medium=self.scene_medium, media_stack=media_stack)
        if inst_tables is not None:
            # Static instances go to the sweep, moving ones to the animated
            # pass.
            proto_ranges, pid, o2w, o2w_end = inst_tables
            moving = np.abs(o2w - o2w_end).max(axis=(1, 2)) > 1e-7
            sweep = anim = None
            if (~moving).any():
                sweep = build_sweep(tri_verts, proto_ranges=proto_ranges,
                                    instances=(pid[~moving], o2w[~moving]))
            if moving.any():
                anim = build_animated_instances(
                    proto_ranges, pid[moving], o2w[moving], o2w_end[moving],
                    times=self.transform_times)
            scene = scene.replace(sweep=sweep, anim=anim)
        else:
            scene = scene.with_accel()

        c2w = tfm.Transform.from_matrix(
            np.linalg.inv(self.world_to_camera).astype(np.float32))
        if self.camera_type == "perspective":
            camera = PerspectiveCamera(
                camera_to_world=c2w, resolution=self.resolution,
                fov_deg=float(_get(self.camera_params, "fov", 90.0)))
        else:
            camera = self._lens_camera(c2w)
        integrator = self._integrator(self.scene_medium is not None
                                      or media_stack is not None)
        settings = {
            "spp": self.spp,
            "sampler": self.sampler_kind,
            "integrator": integrator,
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
