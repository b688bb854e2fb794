"""The port's guard rails: no JAX import, loud failure on features outside
the ported slice, and no silent fallback from a requested CUDA device."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pbrt_tpu_torch.lights.buffers import LightBuffers
from pbrt_tpu_torch.materials.buffers import (
    MAT_COATEDCONDUCTOR,
    MAT_CONDUCTOR,
    MAT_DIFFUSE,
    MaterialBuffers,
)
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.render import camera_rays_full, render
from pbrt_tpu_torch.samplers.samplers import Sampler
from pbrt_tpu_torch.scene import Scene
from pbrt_tpu_torch.scenes.cornell import cornell_box
from pbrt_tpu_torch.scenes.meshes import mesh_gallery_scene
from pbrt_tpu_torch.shapes.geometry import GeometryBuffers, make_quad

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_no_jax():
    code = (
        "import sys, pbrt_tpu_torch.render, pbrt_tpu_torch.convert, "
        "pbrt_tpu_torch.scenes.cornell, pbrt_tpu_torch.scenes.meshes, "
        "pbrt_tpu_torch.ops.cluster, pbrt_tpu_torch.ops.sweep, "
        "pbrt_tpu_torch.io.ply, pbrt_tpu_torch.io.parser; "
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



@pytest.mark.parametrize("build", [
    lambda: cornell_box(variant="specular"),
    lambda: GeometryBuffers.build(**_quad_geom(),
                                  spheres=np.array([[0.5, 0.5, 0.5, 0.1]])),
    lambda: GeometryBuffers.build(**_quad_geom(), tri_alpha=np.array([0.5, 1.0])),
    lambda: LightBuffers.build(points=[{"p": (0, 1, 0), "rgb": (1, 1, 1)}]),
    # The image-based infinite light (an environment map) is not ported;
    # the uniform one is.
    lambda: LightBuffers.build(infinite={"rgb": (1, 1, 1)}, envmap=object()),
    lambda: LightBuffers.build(sampler="bvh"),
    lambda: MaterialBuffers.build([{"kind": MAT_DIFFUSE, "albedo_texture": 2}]),
    # Of the conductor families only the plain conductor is ported.
    lambda: Scene(geom=GeometryBuffers.build(**_quad_geom(mat=1)),
                  materials=MaterialBuffers.build(
                      [{"kind": MAT_DIFFUSE}, {"kind": MAT_COATEDCONDUCTOR}]),
                  lights=LightBuffers.build()),
    lambda: Sampler(kind="sobol"),
    # The BVH and kd-tree tiers are not ported.
    lambda: cornell_box()[0].with_accel(kind="bvh"),
    lambda: mesh_gallery_scene(resolution=(8, 8), subdiv=1),  # glass torus
], ids=["specular_variant", "sphere", "alpha", "point_light", "infinite_light",
        "light_bvh", "texture", "referenced_conductor", "sobol_sampler",
        "explicit_accel", "mesh_gallery_dielectric"])
def test_unsupported_features_raise(build):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        build()


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
    scene, camera = cornell_box(resolution=(4, 4))
    with pytest.raises(NotImplementedError, match="with_accel"):
        render(scene, camera, PathIntegrator(), spp=1, device="cpu")


def test_cuda_device_does_not_fall_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    scene, camera = cornell_box(resolution=(4, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        render(scene.with_accel(), camera, PathIntegrator(), spp=1, device="cuda")


def test_non_box_filter_raises():
    scene, camera = cornell_box(resolution=(4, 4))
    with pytest.raises(NotImplementedError, match="item 14"):
        render(scene.with_accel(), camera, PathIntegrator(), spp=1,
               device="cpu", filter_kind="gaussian")

    class Gaussian:
        kind = "gaussian"

    with pytest.raises(NotImplementedError, match="item 14"):
        camera_rays_full(camera, torch.arange(4), 0, 0, filt=Gaussian())
