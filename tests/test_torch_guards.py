"""The port's guard rails: no JAX import, loud failure on features outside
the ported slice, and no silent fallback from a requested CUDA device."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pbrt_tpu_torch.accel.bvh import build_bvh
from pbrt_tpu_torch.filters.filters import Filter
from pbrt_tpu_torch.io.image import read_image_rgb
from pbrt_tpu_torch.io.parser import load_pbrt_string
from pbrt_tpu_torch.lights.buffers import LightBuffers
from pbrt_tpu_torch.materials.buffers import (
    MAT_CONDUCTOR,
    MAT_DIELECTRIC,
    MAT_DIFFUSE,
    MAT_RETRO,
    MAT_SUBSURFACE,
    MaterialBuffers,
)
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.parallel.train import training_step
from pbrt_tpu_torch.render import camera_rays, camera_rays_full, render
from pbrt_tpu_torch.samplers.samplers import Sampler
from pbrt_tpu_torch.scene import Scene
from pbrt_tpu_torch.scenes.cornell import cornell_box
from pbrt_tpu_torch.scenes.manylight import manylight_scene
from pbrt_tpu_torch.scenes.meshes import mesh_gallery_scene
from pbrt_tpu_torch.shapes.geometry import GeometryBuffers, make_quad
from pbrt_tpu_torch.textures.buffers import TextureBuffers

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_no_jax():
    code = (
        "import sys, pbrt_tpu_torch.render, pbrt_tpu_torch.convert, "
        "pbrt_tpu_torch.scenes.cornell, pbrt_tpu_torch.scenes.meshes, "
        "pbrt_tpu_torch.ops.cluster, pbrt_tpu_torch.ops.sweep, "
        "pbrt_tpu_torch.io.ply, pbrt_tpu_torch.io.parser, "
        "pbrt_tpu_torch.parallel.train, pbrt_tpu_torch.scenes.manylight, "
        "pbrt_tpu_torch.materials.sorted, pbrt_tpu_torch.lights.bvh, "
        "pbrt_tpu_torch.media.medium, pbrt_tpu_torch.media.phase, "
        "pbrt_tpu_torch.ops.compact, pbrt_tpu_torch.models.volpath, "
        "pbrt_tpu_torch.scenes.cloud, pbrt_tpu_torch.materials.hair, "
        "pbrt_tpu_torch.materials.measured, pbrt_tpu_torch.materials.rgl, "
        "pbrt_tpu_torch.materials.bssrdf, pbrt_tpu_torch.models.lightpath, "
        "pbrt_tpu_torch.models.bdpt, pbrt_tpu_torch.models.sppm, "
        "pbrt_tpu_torch.models.mlt, pbrt_tpu_torch.models.ao, "
        "pbrt_tpu_torch.models.function, "
        "pbrt_tpu_torch.models.spectralpath, pbrt_tpu_torch.accel.instances, "
        "pbrt_tpu_torch.core.quaternion, pbrt_tpu_torch.shapes.curve, "
        "pbrt_tpu_torch.shapes.subdiv, pbrt_tpu_torch.samplers.sobol, "
        "pbrt_tpu_torch.samplers.pmj02, pbrt_tpu_torch.filters.filters, "
        "pbrt_tpu_torch.cameras.lens, pbrt_tpu_torch.cameras.realistic, "
        "pbrt_tpu_torch.cameras.humaneye, pbrt_tpu_torch.cameras.rtf, "
        "pbrt_tpu_torch.cameras.simple, pbrt_tpu_torch.films.sensor, "
        "pbrt_tpu_torch.films.gbuffer, pbrt_tpu_torch.films.checkpoint, "
        "pbrt_tpu_torch.io.image, pbrt_tpu_torch.io.ptex, "
        "pbrt_tpu_torch.io.nanovdb, pbrt_tpu_torch.io.buffercache; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'pbrt_tpu' or m.startswith('pbrt_tpu.')]; "
        "sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_package_sources_never_import_jax():
    pkg = os.path.join(ROOT, "pbrt_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    for line in f:
                        s = line.strip()
                        assert not (s.startswith(("import jax", "from jax"))
                                    or "pbrt_tpu." in s and "import" in s
                                    and "pbrt_tpu_torch" not in s), (name, s)


def _quad_geom(mat=0):
    return dict(tri_verts=make_quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)),
                tri_mat=np.array([mat, mat], np.int32))



def _light_bvh_gradient():
    """A gradient request on the light BVH's node table (the hall with the
    BVH sampler, cut to 4 lights)."""
    scene, camera = manylight_scene(resolution=(2, 2), n_lights=4,
                                    sampler="bvh")
    tree = scene.lights.bvh
    scene = scene.replace(lights=scene.lights.replace(
        bvh=tree.replace(nodes=tree.nodes.clone().requires_grad_(True))))
    pixel = torch.arange(4)
    o, d, wl = camera_rays(camera, pixel, 0, 0, n_spectrum=8)
    PathIntegrator().trace(scene, o, d, wl, pixel, 0, 0)


def _gallery_with_torus_kind(kind):
    scene, _ = mesh_gallery_scene(resolution=(8, 8), subdiv=1)
    kinds = scene.materials.kind.clone()
    assert kinds[2] == MAT_DIELECTRIC
    kinds[2] = kind
    return scene.replace(materials=scene.materials.replace(kind=kinds))


def _material_gradient(scene, field):
    """A request for the gradient of the materials' `field` through
    `scene` (the rays of a 2x2 Cornell camera)."""
    m = scene.materials
    scene = scene.replace(materials=m.replace(
        **{field: getattr(m, field).clone().requires_grad_(True)}))
    pixel = torch.arange(4)
    o, d, wl = camera_rays(cornell_box(resolution=(2, 2))[1], pixel, 0, 0,
                           n_spectrum=8)
    PathIntegrator().trace(scene.with_accel(), o, d, wl, pixel, 0, 0)


def _raises(build, exc, match):
    """`build` raises `exc` matching `match`."""
    build.raises = (exc, match)
    return build


def _value_error(build, match):
    """A departure: `build` raises ValueError matching `match`."""
    return _raises(build, ValueError, match)


@pytest.mark.parametrize("build", [
    # Training over a device mesh waits for torch.distributed (item 15).
    lambda: training_step(*cornell_box(resolution=(2, 2)), PathIntegrator(),
                          torch.arange(4), torch.zeros(4, 3), mesh=object()),
    # Every shape family, shape alpha and moving instance is ported
    # (tests/test_torch_shapes.py, test_torch_alpha.py,
    # test_torch_motion.py), and every camera and film (item 14,
    # tests/test_torch_cameras.py, test_torch_films.py); the file entry
    # refuses a lens camera without its lens and a film other than rgb,
    # where the reference renders a perspective camera or an RGB film.
    _value_error(lambda: load_pbrt_string('Camera "realistic"', device="cpu"),
                 "lensfile"),
    _value_error(lambda: load_pbrt_string('Film "gbuffer"', device="cpu"),
                 "Film 'gbuffer'"),
    # Every light type and light sampler is ported (the exhaustive one
    # here); SampleLe's origin, for the light-tracing integrators, only on
    # emissive geometry, as in the reference (item 16).
    lambda: LightBuffers.build(points=[{"p": (0, 1, 0), "rgb": (1, 1, 1)}],
                               sampler="exhaustive").sample_le_origin(
                                   torch.zeros(4), torch.zeros(4, 2)),
    # Every image format of the reference is read (EXR, PFM, PNG, QOI;
    # tests/test_torch_io.py); a missing file raises, naming it.
    _raises(lambda: read_image_rgb("sky.exr"), OSError, "sky.exr"),
    # The light BVH renders; a gradient of its node table is refused.
    _light_bvh_gradient,
    # Every texture family is ported, Ptex included; a Ptex texture whose
    # file cannot be read raises, naming it (the reference binds gray).
    _value_error(lambda: load_pbrt_string(
        'Texture "t" "spectrum" "ptex" "string filename" "t.ptx"',
        device="cpu"), "ptex file 't.ptx' cannot be read"),
    # The plain, coated and retroreflective conductors render
    # (tests/test_torch_coated.py, tests/test_torch_families.py) and carry
    # the default gradients (tests/test_torch_grad_refusal.py); a gradient
    # of the roughness is refused: the reference's is NaN (item 5).
    lambda: _material_gradient(Scene(
        geom=GeometryBuffers.build(**_quad_geom(mat=1)),
        materials=MaterialBuffers.build([{"kind": MAT_DIFFUSE},
                                         {"kind": MAT_RETRO}]),
        lights=LightBuffers.build()), "roughness"),
    # Every sampler kind of the reference is ported
    # (tests/test_torch_samplers.py); another name raises.
    _value_error(lambda: Sampler(kind="owen"), "unknown sampler kind"),
    # A NanoVDB medium builds (tests/test_torch_io.py); one whose file
    # cannot be read raises, naming it (the reference warns and skips it).
    _value_error(lambda: load_pbrt_string(
        'MakeNamedMedium "v" "string type" "nanovdb" '
        '"string filename" "v.nvdb"', device="cpu"), "'v.nvdb' cannot be read"),
    # The gallery's glass torus is shaded (tests/test_torch_dielectric.py),
    # and so are a diffuse-transmission one (tests/test_torch_coated.py)
    # and a subsurface one, which carries the default gradients; a
    # gradient of its mean free path has no gate and is refused (item 5).
    lambda: _material_gradient(_gallery_with_torus_kind(MAT_SUBSURFACE),
                               "ss_mfp_coeffs"),
], ids=["device_mesh", "realistic_camera", "gbuffer_film",
        "point_light", "infinite_light", "light_bvh", "texture",
        "referenced_conductor", "sobol_sampler", "nanovdb_medium",
        "mesh_gallery_dielectric"])
def test_unsupported_features_raise(build):
    exc, match = getattr(build, "raises",
                         (NotImplementedError, "ROADMAP Queue 1 item"))
    with pytest.raises(exc, match=match):
        build()


def test_a_missing_texture_raises():
    """A material that binds a texture the scene does not hold raises; the
    reference skips the overlay (no tables) or clamps the id."""
    geom = GeometryBuffers.build(**_quad_geom(mat=1))
    materials = MaterialBuffers.build([{"kind": MAT_DIFFUSE},
                                       {"kind": MAT_DIFFUSE, "albedo_texture": 1}])
    with pytest.raises(ValueError, match="texture id"):
        Scene(geom=geom, materials=materials, lights=LightBuffers.build())
    one = TextureBuffers.build([{"kind": "constant"}])
    with pytest.raises(ValueError, match="texture id"):
        Scene(geom=geom, materials=materials, lights=LightBuffers.build(),
              textures=one)
    two = TextureBuffers.build([{"kind": "constant"}, {"kind": "checker"}])
    scene = Scene(geom=geom, materials=materials, lights=LightBuffers.build(),
                  textures=two)
    assert scene.textures.n_textures == 2


def test_accelerator_tiers():
    scene, _ = cornell_box(resolution=(8, 8))
    small = scene.with_accel()
    assert small.small is not None and small.clusters is None
    # Exactly one tier is attached, whatever the scene held before.
    for attached in (scene.with_accel(threshold=16),
                     scene.with_accel(kind="cluster"),
                     small.with_accel(kind="cluster")):
        assert attached.small is None and attached.clusters is not None
        assert attached.clusters.n_clusters == 1  # 38 triangles
    back = small.with_accel(kind="cluster").with_accel()
    assert back.small is not None and back.clusters is None
    # The BVH is attached as in the reference; with_accel drops it again.
    tri_verts = scene.geom.tri_verts.numpy()
    bvh = small.replace(small=None, bvh=build_bvh(tri_verts))
    assert bvh.bvh.depth == 4 and bvh.bvh.prim_id.shape == (64,)
    assert bvh.with_accel().bvh is None
    # with_kdtree keeps the other tiers, as in the reference.
    kd = small.with_kdtree()
    assert kd.kdtree is not None and kd.small is not None
    assert kd.with_accel(kind="cluster").kdtree is None
    with pytest.raises(ValueError, match="unknown accelerator kind"):
        scene.with_accel(kind="bvh")
    conductor = Scene(geom=GeometryBuffers.build(**_quad_geom(mat=1)),
                      materials=MaterialBuffers.build(
                          [{"kind": MAT_DIFFUSE}, {"kind": MAT_CONDUCTOR}]),
                      lights=LightBuffers.build(infinite={"rgb": (1, 1, 1)}))
    assert conductor.lights.has_infinite and conductor.lights.n_lights == 1
    assert conductor.shaded_kinds == {MAT_CONDUCTOR}


def test_unreferenced_non_diffuse_rows_are_carried():
    scene, _ = cornell_box(resolution=(8, 8))
    assert scene.materials.kind.tolist() == [0, 0, 0, 1, 2]
    assert scene.materials.any_conductor and scene.materials.any_dielectric
    # The BxDF chain runs only the links of referenced kinds, so the spare
    # copper row costs the Cornell pass nothing.
    assert scene.shaded_kinds == {MAT_DIFFUSE}


def test_queries_need_the_accelerator():
    """A scene with no tier attached is answered by the dense watertight
    tester, as in the reference: the Cornell box renders as on K1's twin
    (the two testers agree but for rays through the quads' diagonals)."""
    scene, camera = cornell_box(resolution=(8, 8))
    dense = render(scene, camera, PathIntegrator(), spp=2, device="cpu")
    small = render(scene.with_accel(), camera, PathIntegrator(), spp=2,
                   device="cpu")
    close = torch.isclose(dense, small, rtol=1e-3, atol=1e-5)
    assert close.float().mean() >= 0.99 and float(dense.mean()) > 0.05


def test_cuda_device_does_not_fall_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    scene, camera = cornell_box(resolution=(4, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        render(scene.with_accel(), camera, PathIntegrator(), spp=1, device="cuda")


def test_non_box_filter_raises():
    """The reference's five filters are ported (tests/test_torch_filters.py);
    a kind it lacks raises ValueError."""
    scene, camera = cornell_box(resolution=(4, 4))
    with pytest.raises(ValueError, match="unknown filter kind 'sinc'"):
        render(scene.with_accel(), camera, PathIntegrator(), spp=1,
               device="cpu", filter_kind="sinc")
    _, _, _, w = camera_rays_full(camera, torch.arange(4), 0, 0,
                                  filt=Filter.create("gaussian"))
    assert torch.equal(w, torch.ones(4))
