"""The scene-leaf gradient goldens' cases, shared by
scripts/make_torch_port_golden_leaves.py (the JAX reference's side),
tests/test_torch_grad_leaves.py, tests/test_torch_grad_leaves_rest.py
and chip_smoke.py phases g12, g13, e17 and e18 (the port's):
each scene built by either package from the same file or recipe, the
estimators each golden holds, the leaves each asks for and the probe
directions of the tables.

A golden entry is keyed "<scene>_<estimator>_...": the loss
("..._loss"), and per leaf either the full gradient ("..._grad_<leaf>")
or, for a table whose reverse-mode gradient the reference answers NaN,
the forward-mode derivative along N_DIRS directions drawn from a numpy
seed ("..._jvp_<leaf>", dotted with `directions`), with whether the
reverse mode was finite ("..._reverse_finite_<leaf>"). Leaf keys are the
dotted path with "." as "__" ("lights__env__coeffs").

This module imports neither JAX nor the reference (either package's
modules are imported by name, through `pkg`), so chip_smoke.py can use
it.
"""

from __future__ import annotations

import contextlib
import importlib
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "torch_port")
GOLDENS_DIR = os.path.join(ROOT, "tests", "goldens")

# The settings of the surface goldens (the families golden's) and of the
# media and volpath goldens.
SURFACE = dict(resolution=16, spp=2, n_spectrum=8, max_depth=5,
               rr_start_depth=5, seed=0, target=0.25)
MEDIA = dict(SURFACE, resolution=8, max_steps=32)
# Probe directions of a table's forward-mode derivative.
N_DIRS = 4
DIR_SEED = 20

# Each group's golden file.
GOLDEN_FILES = {
    "materials": os.path.join(DATA, "leaves_materials16_grad.npz"),
    "textures": os.path.join(DATA, "leaves_textures16_grad.npz"),
    "lights": os.path.join(DATA, "leaves_lights16_grad.npz"),
    "media": os.path.join(DATA, "leaves_media8_grad.npz"),
    "volpath": os.path.join(DATA, "leaves_volpath8_grad.npz"),
    "sampling": os.path.join(DATA, "leaves_sampling16_grad.npz"),
}


def _m(*names):
    return tuple(f"materials.{n}" for n in names)


COND_LEAVES = _m("cond_eta_coeffs", "cond_eta_scale", "cond_k_coeffs",
                 "cond_k_scale")
# (group, scene, estimators, leaves): the reference's gradient of the
# bench loss with respect to `leaves` under each estimator is a golden.
CASES = (
    # 5e.1: the families box (its subsurface block makes the estimator
    # the attached one) and the coated Cornell box with a
    # diffuse-transmission block.
    ("materials", "families", ("attached",),
     COND_LEAVES + _m("roughness", "coat_roughness", "hair_sigma_coeffs",
                      "hair_sigma_scale", "hair_alpha", "ss_mfp_coeffs",
                      "ss_mfp_scale", "mix_amount", "measured_coeffs",
                      "measured_scale")),
    ("materials", "coated", ("remat", "cvjp", "attached"),
     COND_LEAVES + _m("roughness", "coat_roughness", "thickness",
                      "trans_coeffs")),
    # 5e.2: texture.pbrt (checkerboard and scale), a bilerp / mix /
    # constant scene, and io_surfaces' Ptex textures.
    ("textures", "texture", ("remat", "cvjp"),
     ("textures.rgb0", "textures.rgb1", "textures.f0",
      "lights.point_coeffs", "lights.point_scale", "lights.distant_coeffs",
      "lights.distant_scale")),
    ("textures", "textured", ("remat", "cvjp"),
     ("textures.rgb0", "textures.rgb1", "textures.rgb2", "textures.rgb3",
      "textures.f0")),
    ("textures", "ptex", ("remat", "cvjp"), ("textures.ptex_flat",)),
    # 5e.3: the spot light over a rough conductor, the point and uniform
    # infinite lights, the image and portal lights, and one scene with an
    # area, a sphere, a projection, a goniometric and a distant light.
    ("lights", "spot", ("remat", "cvjp"),
     ("lights.spot_coeffs", "lights.spot_scale") + COND_LEAVES
     + _m("roughness")),
    ("lights", "plymesh", ("remat", "cvjp"),
     ("lights.point_coeffs", "lights.point_scale", "lights.infinite_coeffs",
      "lights.infinite_scale")),
    ("lights", "envmap", ("remat", "cvjp"),
     ("lights.env.coeffs", "lights.env.scale", "lights.env.strength")),
    ("lights", "portal", ("remat", "cvjp"),
     ("lights.env.coeffs", "lights.env.scale_tx", "lights.env.strength")),
    ("lights", "lightkinds", ("remat", "cvjp", "attached"),
     ("lights.area_coeffs", "lights.sphl_coeffs", "lights.sphl_scale",
      "lights.proj_coeffs", "lights.proj_scale_tx", "lights.gonio_coeffs",
      "lights.gonio_scale_tx", "lights.distant_coeffs",
      "lights.distant_scale")),
    # 5e.4: VolPathIntegrator(differentiable=True) through a homogeneous
    # slab, a density grid and an RGB grid.
    ("media", "fog", ("volpath",),
     ("medium.sigma_a_coeffs", "medium.sigma_s_coeffs", "medium.g")),
    ("media", "grid", ("volpath",),
     ("medium.density", "medium.sigma_a_coeffs", "medium.sigma_s_coeffs",
      "medium.g")),
    ("media", "rgbgrid", ("volpath",),
     ("medium.sa_grid_coeffs", "medium.sa_grid_scale",
      "medium.ss_grid_coeffs", "medium.ss_grid_scale", "medium.g")),
    # 5e.5: surface and light leaves through the differentiable volumetric
    # path: the fog box's slab, and the families box inside a homogeneous
    # scene-level medium.
    ("volpath", "fogsurf", ("volpath",),
     ("materials.albedo_coeffs", "lights.area_scale")),
    ("volpath", "volfamilies", ("volpath",),
     ("materials.albedo_coeffs", "lights.area_scale",
      "medium.sigma_a_coeffs", "medium.sigma_s_coeffs")
     + _m("hair_sigma_coeffs", "hair_sigma_scale", "hair_alpha",
          "ss_mfp_coeffs", "ss_mfp_scale", "measured_coeffs",
          "measured_scale", "mix_amount")),
    # 5e.7: fog.pbrt's sphere of interior medium.
    ("volpath", "interior", ("volpath",),
     tuple(f"media_stack.{n}" for n in (
         "sigma_a_coeffs", "sigma_a_scale", "sigma_s_coeffs",
         "sigma_s_scale", "g"))),
    # 5e.8: the majorants of the 8^3 density grid.
    ("volpath", "majorants", ("volpath",),
     ("medium.maj_grid", "medium.max_density")),
    # 5e.8: the image light's importance tables, and the light selection's
    # tables of leaf_lights.pbrt.
    ("sampling", "envdist", ("remat", "cvjp"),
     tuple(f"lights.env.dist.{t}.{f}" for t in ("conditional", "marginal")
           for f in ("func", "cdf", "integral")) + ("lights.env.luminance",)),
    ("sampling", "selection", ("remat", "cvjp"),
     ("lights.select_pmf", "lights.select_cdf")),
    # 5e.6: the light BVH's node table, the hall cut to 16 lights.
    ("sampling", "lightbvh", ("remat", "cvjp"), ("lights.bvh.nodes",)),
)
# Leaves whose gradient is zero by construction, with the rows (None:
# all): the reference picks a mix material's sub-material where u <
# amount, a step in amount; the bilerp, constant and checkerboard rows of
# leaf_textures.pbrt read no f0 (its mix row's amount does).
# Through the volumetric path, which has no subsurface step (a subsurface
# surface shades with its exit lobe), the families box's mean free path
# is read by nothing, and neither is the density grid's max_density but
# through the detached majorants. Under remat the image light's cdfs,
# its marginal func, its rows' integrals and its luminance, and the
# selection cdf, reach the loss only through sampling decisions and
# detached pdfs.
ZERO_BY_CONSTRUCTION = {("families", "materials.mix_amount"): None,
                        ("textured", "textures.f0"): (0, 1, 2),
                        ("volfamilies", "materials.mix_amount"): None,
                        ("volfamilies", "materials.ss_mfp_coeffs"): None,
                        ("volfamilies", "materials.ss_mfp_scale"): None,
                        ("majorants", "medium.max_density"): None,
                        **{("envdist", f"lights.env.{t}"): None for t in (
                            "dist.conditional.cdf",
                            "dist.conditional.integral",
                            "dist.marginal.func", "dist.marginal.cdf",
                            "luminance")},
                        ("selection", "lights.select_cdf"): None}
# The sampling tables reach the loss only through the MIS pdfs, which
# cvjp's replay reads from its records in both packages: under cvjp their
# gradients are zero by construction (the light BVH's node table, index
# columns and all, included).
SAMPLING_TABLES = (
    *(f"lights.env.dist.{t}.{f}" for t in ("conditional", "marginal")
      for f in ("func", "cdf", "integral")),
    "lights.env.luminance", "lights.select_pmf", "lights.select_cdf",
    "lights.bvh.nodes")
# A table has more entries than this: its golden is held along
# directions where the reference's reverse mode is NaN. A leaf whose
# forward mode is NaN too has no golden ("..._forward_finite_<leaf>"
# False) and stays refused.
SMALL_LEAF = 64

_PBRT = {
    "families": os.path.join(DATA, "families.pbrt"),
    "texture": os.path.join(GOLDENS_DIR, "texture.pbrt"),
    "textured": os.path.join(DATA, "leaf_textures.pbrt"),
    "ptex": os.path.join(DATA, "io", "io_surfaces.pbrt"),
    "spot": os.path.join(GOLDENS_DIR, "spot.pbrt"),
    "plymesh": os.path.join(GOLDENS_DIR, "plymesh.pbrt"),
    "envmap": os.path.join(GOLDENS_DIR, "envmap.pbrt"),
    "portal": os.path.join(DATA, "leaf_portal.pbrt"),
    "lightkinds": os.path.join(DATA, "leaf_lights.pbrt"),
    "volfamilies": os.path.join(DATA, "families.pbrt"),
    "interior": os.path.join(GOLDENS_DIR, "fog.pbrt"),
    "envdist": os.path.join(GOLDENS_DIR, "envmap.pbrt"),
    "selection": os.path.join(DATA, "leaf_lights.pbrt"),
}
# The cases whose scene is the fog box with a medium of `_medium`.
_FOG_BOX = {"fog": "fog", "grid": "grid", "rgbgrid": "rgbgrid",
            "fogsurf": "fog", "majorants": "grid"}


def key_of(leaf: str) -> str:
    return leaf.replace(".", "__")


def cases(groups=None):
    """[(group, scene, estimator, leaves)] of a group, of a tuple of
    groups or of all."""
    if isinstance(groups, str):
        groups = (groups,)
    return [(g, s, e, leaves) for g, s, ests, leaves in CASES
            for e in ests if groups is None or g in groups]


def group_of(name: str) -> str:
    return next(g for g, s, _, _ in CASES if s == name)


def zero_rows(name: str, est: str, leaf: str):
    """The rows (None: all) of a case's leaf whose gradient is zero by
    construction, or False."""
    if est == "cvjp" and leaf in SAMPLING_TABLES:
        return None
    return ZERO_BY_CONSTRUCTION.get((name, leaf), False)


def directions(leaf: str, shape) -> np.ndarray:
    """(N_DIRS, *shape) float64 probe directions of a table leaf, from a
    seed of its name."""
    seed = DIR_SEED + sum(map(ord, leaf))
    return np.random.default_rng(seed).standard_normal(
        (N_DIRS, *tuple(shape)))


def answered(z, prefix: str, leaves) -> dict:
    """The leaves of golden entry `prefix` ("<scene>_<estimator>") that
    have a golden: {leaf: ("grad" or "jvp", float64 value)}."""
    out = {}
    for p in leaves:
        for what in ("grad", "jvp"):
            key = f"{prefix}_{what}_{key_of(p)}"
            if key in z:
                out[p] = (what, np.asarray(z[key], np.float64))
    return out


def leaf_errors(want: dict, grads: dict) -> dict:
    """Each leaf's largest error over its golden's largest magnitude (a
    table held along directions: its dot products'), from `answered`'s
    goldens and {leaf: numpy gradient}; "finite" whether every gradient
    entry is."""
    out = {"finite": all(bool(np.all(np.isfinite(g)))
                         for g in grads.values())}
    for p, (what, w) in want.items():
        g = np.asarray(grads[p], np.float64)
        if what == "jvp":
            g = np.tensordot(directions(p, g.shape), g, axes=g.ndim)
        scale = float(np.max(np.abs(w)))
        err = float(np.max(np.abs(g - w.reshape(g.shape))))
        out[p] = err / scale if scale else err
    return out


_GOLDENS, _SCENES, _RUNS = {}, {}, {}


def golden(group: str) -> dict:
    """A group's golden file, read once a process."""
    if group not in _GOLDENS:
        _GOLDENS[group] = dict(np.load(GOLDEN_FILES[group]))
    return _GOLDENS[group]


def port_scene(name: str):
    """(scene, camera) of a case on the port's CPU at its golden's
    resolution, built once a process (its lights' and tables' fits shared
    by its estimators)."""
    if name not in _SCENES:
        res = settings_of(group_of(name))["resolution"]
        _SCENES[name] = leaf_scene("pbrt_tpu_torch", name, res)
    return _SCENES[name]


def port_run(group: str, name: str, est: str):
    """(golden loss, {leaf: (kind, golden)}, loss, {leaf: gradient}) of a
    case through the port on the CPU, computed once a process."""
    from .torch_port_grad import pass_loss_and_grads

    if (name, est) not in _RUNS:
        z = golden(group)
        leaves = dict((s, lv) for _, s, _, lv in CASES)[name]
        want = answered(z, f"{name}_{est}", leaves)
        g = settings_of(group)
        scene, camera = port_scene(name)
        with keys("pbrt_tpu_torch", name):
            loss, grads = pass_loss_and_grads(
                scene, camera, integrator("pbrt_tpu_torch", est),
                tuple(want), g["resolution"], g["spp"])
        _RUNS[name, est] = (float(z[f"{name}_{est}_loss"]), want, loss,
                            grads)
    return _RUNS[name, est]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def coated_trans_cornell(pkg: str, resolution):
    """tests/torch_port_coated.py's coated Cornell box with a fifth row, a
    diffuse-transmission material, on the short box, lifted 0.002 off the
    floor: its bottom face, which rays now reach from inside, would lie
    on the floor's plane, and a tie between two materials goes to either
    under two float pipelines."""
    from .torch_port_coated import coated_cornell

    mb = _mod(pkg, "materials.buffers")
    scene, camera = coated_cornell(pkg, resolution)
    mats = [
        {"kind": mb.MAT_COATEDDIFFUSE, "albedo": (0.7, 0.7, 0.7),
         "roughness": 0.2, "coat_roughness": 0.05, "thickness": 0.05},
        {"kind": mb.MAT_DIFFUSE, "albedo": (0.65, 0.05, 0.05)},
        {"kind": mb.MAT_DIFFUSE, "albedo": (0.12, 0.45, 0.15)},
        {"kind": mb.MAT_COATEDCONDUCTOR, "conductor": "Au", "roughness": 0.1,
         "coat_roughness": 0.08, "thickness": 0.02},
        {"kind": mb.MAT_DIFFUSETRANS, "albedo": (0.4, 0.5, 0.6),
         "transmittance": (0.5, 0.3, 0.2)},
    ]
    geometry = _mod(pkg, "shapes.geometry")
    n_box = len(geometry.make_box((0, 0, 0), (1, 1, 1)))
    g = scene.geom
    tri_mat = np.array(np.asarray(g.tri_mat), np.int32)
    verts = np.array(np.asarray(g.tri_verts), np.float32)
    n_tri = tri_mat.shape[0]
    # The short box: the box before the tall one.
    short = slice(n_tri - 2 - 2 * n_box, n_tri - 2 - n_box)
    tri_mat[short] = 4
    verts[short, :, 1] += np.float32(0.002)
    geom = geometry.GeometryBuffers.build(
        tri_verts=verts, tri_mat=tri_mat,
        tri_light=np.array(np.asarray(g.tri_light), np.int32))
    return scene.replace(geom=geom,
                         materials=mb.MaterialBuffers.build(mats)), camera


def _medium(pkg, name):
    """The media golden's medium: a homogeneous slab, an 8^3 density grid
    or an 8^3 RGB grid, within the fog box's view."""
    mm = _mod(pkg, "media.medium").MediumBuffers
    if name == "fog":
        return mm.homogeneous(sigma_a_rgb=(0.5, 0.4, 0.3),
                              sigma_s_rgb=(0.6, 0.8, 1.0),
                              bounds_lo=(-10.0, -10.0, 0.5),
                              bounds_hi=(10.0, 10.0, 1.5), g=0.3)
    rng = np.random.default_rng(7)
    lo, hi = (-0.35, -0.35, 0.5), (0.35, 0.35, 1.5)
    if name == "grid":
        density = rng.uniform(0.2, 1.0, (8, 8, 8)).astype(np.float32)
        return mm.grid(density=density, sigma_a_rgb=(0.4, 0.5, 0.6),
                       sigma_s_rgb=(0.9, 0.7, 0.5), bounds_lo=lo,
                       bounds_hi=hi, g=0.3, scale=1.5, maj_res=4)
    sa = rng.uniform(0.1, 0.8, (8, 8, 8, 3)).astype(np.float32)
    ss = rng.uniform(0.2, 1.2, (8, 8, 8, 3)).astype(np.float32)
    return mm.rgbgrid(sigma_a_grid=sa, sigma_s_grid=ss, bounds_lo=lo,
                      bounds_hi=hi, g=-0.2, maj_res=4)


def in_medium(pkg: str, scene):
    """The scene inside a homogeneous medium filling the families box, as
    tests/test_torch_guards.py's volumetric requests use (the port's on
    the scene's device)."""
    medium = _mod(pkg, "media.medium").MediumBuffers.homogeneous(
        sigma_a_rgb=(0.1,) * 3, sigma_s_rgb=(0.1,) * 3,
        bounds_lo=(-9.0,) * 3, bounds_hi=(9.0,) * 3)
    if pkg == "pbrt_tpu_torch":
        medium = medium.to(scene.geom.tri_verts.device)
    return scene.replace(medium=medium)


def leaf_scene(pkg: str, name: str, resolution: int, device=None):
    """(scene, camera) of a case in package `pkg` ("pbrt_tpu" or
    "pbrt_tpu_torch"), the accelerator attached; the port's on `device`
    (the CPU by default)."""
    res = (resolution, resolution)
    if name == "coated":
        scene, camera = coated_trans_cornell(pkg, res)
    elif name in _FOG_BOX:
        scene, camera = _mod(pkg, "scenes.cloud").fog_box_scene(
            sigma_a=0.5, sigma_s=0.5, resolution=res)
        scene = scene.replace(medium=_medium(pkg, _FOG_BOX[name]))
    elif name == "lightbvh":
        scene, camera = _mod(pkg, "scenes.manylight").manylight_scene(
            resolution=res, n_lights=16, sampler="bvh")
    else:
        kw = {"device": "cpu"} if pkg == "pbrt_tpu_torch" else {}
        scene, camera, _ = _mod(pkg, "io.parser").load_pbrt(_PBRT[name], **kw)
        camera = camera.replace(resolution=res)
        if name == "volfamilies":
            scene = in_medium(pkg, scene)
    scene = scene.with_accel()
    if device is not None:
        scene, camera = scene.to(device), camera.to(device)
    return scene, camera


def integrator(pkg: str, estimator: str, settings=None):
    """The case's integrator in `pkg`: the path integrator at the
    goldens' depth without Russian roulette under `estimator`, or the
    differentiable volumetric path ("volpath")."""
    g = settings or SURFACE
    if estimator == "volpath":
        steps = MEDIA["max_steps"]
        return _mod(pkg, "models.volpath").VolPathIntegrator(
            max_depth=g["max_depth"], rr_start_depth=g["rr_start_depth"],
            max_null_steps=steps, max_tr_steps=steps, differentiable=True)
    kw = {"remat": {}, "cvjp": {"grad_mode": "cvjp"},
          "attached": {"replay_grad": False}}[estimator]
    return _mod(pkg, "models.path").PathIntegrator(
        max_depth=g["max_depth"], rr_start_depth=g["rr_start_depth"], **kw)


@contextlib.contextmanager
def keys(pkg: str, name: str):
    """The cross-pipeline conventions the goldens are made on, in either
    package: the mix materials' and the layered walk's coarse hash keys
    (the families and coated boxes; harmless elsewhere) and, for the
    media, the inset medium entry (tests/torch_port_media.py)."""
    from .torch_port_coated import coarse_walk_keys
    from .torch_port_families import coarse_mix_keys
    from .torch_port_media import inset_entry

    with contextlib.ExitStack() as stack:
        stack.enter_context(coarse_mix_keys(_mod(pkg, "materials.bxdf")))
        stack.enter_context(coarse_walk_keys(_mod(pkg, "materials.layered")))
        if name in _FOG_BOX:
            stack.enter_context(inset_entry(
                _mod(pkg, "media.medium").MediumBuffers))
        yield


def settings_of(group: str) -> dict:
    return MEDIA if group in ("media", "volpath") else SURFACE
