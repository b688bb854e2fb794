"""Gradient requests that the port does not answer raise (ROADMAP Queue 1
item 5): with autograd on, a scene tensor outside the default trainable
set (materials.albedo_coeffs, lights.area_scale), the ray origins or
directions, or the wavelengths that require grad raise NotImplementedError
at entry, and so does a gradient asked through an unported gradient mode
or of a texture table, or through a hair, subsurface, measured, mix or
retroreflective material. Under torch.no_grad() the render is what it was
without a request."""

import pytest
import torch

from pbrt_tpu_torch.io.parser import load_pbrt
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.parallel.train import render_loss_and_grad, training_step
from pbrt_tpu_torch.render import camera_rays_full, render
from pbrt_tpu_torch.scenes.cornell import cornell_box

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cornell8():
    scene, camera = cornell_box(resolution=(8, 8))
    return scene.with_accel(), camera


def _with_grad(scene, member, field):
    part = getattr(scene, member)
    x = getattr(part, field).clone().requires_grad_(True)
    return scene.replace(**{member: part.replace(**{field: x})})


def test_render_with_a_scene_grad_request_raises(cornell8):
    """Roughness is outside the trainable set: the reference's gradient
    of it is not finite on a conductor."""
    scene, camera = cornell8
    scene = _with_grad(scene, "materials", "roughness")
    with pytest.raises(NotImplementedError, match="item 5"):
        render(scene, camera, PathIntegrator(max_depth=5), spp=1,
               device="cpu")


@pytest.mark.parametrize("which", ["tri_verts", "o", "d", "wl"])
def test_trace_with_a_grad_request_raises(cornell8, which):
    scene, camera = cornell8
    pixel = torch.arange(64)
    o, d, wl, _ = camera_rays_full(camera, pixel, 0, 0)
    if which == "tri_verts":
        scene = _with_grad(scene, "geom", "tri_verts")
    elif which == "wl":
        wl = wl.replace(lam=wl.lam.clone().requires_grad_(True))
    else:
        o, d = (x.clone().requires_grad_(k == which)
                for k, x in (("o", o), ("d", d)))
    with pytest.raises(NotImplementedError, match="item 5"):
        PathIntegrator(max_depth=5).trace(scene, o, d, wl, pixel, 0, 0)


@pytest.mark.parametrize("mode", [
    {"grad_mode": "cvjp"}, {"replay_grad": False}, {"replay_remat": "dots"},
])
def test_unported_grad_mode_raises(cornell8, mode):
    scene, camera = cornell8
    pixel = torch.arange(64)
    o, d, wl, _ = camera_rays_full(camera, pixel, 0, 0)
    integ = PathIntegrator(max_depth=5, **mode)
    asked = _with_grad(scene, "materials", "albedo_coeffs")
    with pytest.raises(NotImplementedError, match="item 5"):
        integ.trace(asked, o, d, wl, pixel, 0, 0)
    # Without a gradient request the mode changes nothing.
    got = integ.trace(scene, o, d, wl, pixel, 0, 0)
    want = PathIntegrator(max_depth=5).trace(scene, o, d, wl, pixel, 0, 0)
    assert torch.equal(got, want)


def test_training_step_over_a_mesh_raises(cornell8):
    scene, camera = cornell8
    pixel = torch.arange(64)
    with pytest.raises(NotImplementedError, match="item 15"):
        training_step(scene, camera, PathIntegrator(max_depth=5), pixel,
                      torch.zeros((64, 3)), mesh=object())


def test_no_grad_renders_as_without_a_request(cornell8):
    scene, camera = cornell8
    kw = dict(spp=2, samples_per_pass=2, device="cpu")
    want = render(scene, camera, PathIntegrator(max_depth=5), **kw)
    asked = _with_grad(scene, "materials", "albedo_coeffs")
    with torch.no_grad():
        got = render(asked, camera, PathIntegrator(max_depth=5), **kw)
    assert torch.equal(got, want) and not got.requires_grad


@pytest.fixture(scope="module")
def imagetex8():
    """imagetex.pbrt at 8x8: an image-textured floor and a plain diffuse
    sphere."""
    scene, camera, settings = load_pbrt("tests/goldens/imagetex.pbrt",
                                        device="cpu")
    return scene, camera.replace(resolution=(8, 8)), settings["integrator"]


@pytest.mark.parametrize("field", ["rgb0", "f0", "img_flat"])
def test_texture_grad_request_raises(imagetex8, field):
    """Texture tables are not trainable: a request raises (item 5)."""
    scene, camera, integrator = imagetex8
    scene = _with_grad(scene, "textures", field)
    with pytest.raises(NotImplementedError, match="item 5"):
        render(scene, camera, integrator, spp=1, device="cpu")


def test_textured_albedo_rows_get_no_gradient(imagetex8):
    """The texture overwrites a textured row's albedo at every hit, so its
    gradient is zero, as in the reference; the sphere's row has one."""
    scene, camera, integrator = imagetex8
    pixel = torch.arange(64).repeat(2)
    sample = torch.arange(2).repeat_interleave(64)
    _, grads = render_loss_and_grad(scene, camera, integrator, pixel,
                                    torch.full((128, 3), 0.25), sample, 0,
                                    n_spectrum=8)
    g = grads["materials.albedo_coeffs"]
    tex_rows = scene.materials.albedo_tex >= 0
    assert tex_rows.tolist() == [False, True, False]
    assert torch.all(g[tex_rows] == 0.0) and torch.all(torch.isfinite(g))
    assert torch.any(g[2] != 0.0)


@pytest.mark.parametrize("differentiable, member, field", [
    # The reference differentiates media only with differentiable=True.
    (False, "medium", "sigma_a_scale"),
    # Of the medium's tensors only sigma_a_scale and sigma_s_scale train.
    (True, "medium", "sigma_a_coeffs"),
    (True, "medium", "g"),
    # Nor does any surface parameter through the volumetric path.
    (True, "materials", "albedo_coeffs"),
])
def test_medium_grad_request_raises(differentiable, member, field):
    """Gradients through media: the fog box's sigma_a_scale and
    sigma_s_scale with differentiable=True (tests/test_torch_volpath.py);
    any other request raises (item 5)."""
    from pbrt_tpu_torch.models.volpath import VolPathIntegrator
    from pbrt_tpu_torch.scenes.cloud import fog_box_scene

    scene, camera = fog_box_scene(resolution=(4, 4))
    integ = VolPathIntegrator(max_depth=2, differentiable=differentiable)
    pixel = torch.arange(16)
    o, d, wl, _ = camera_rays_full(camera, pixel, 0, 0, n_spectrum=8)
    asked = _with_grad(scene, member, field)
    with pytest.raises(NotImplementedError, match="item 5"):
        integ.trace(asked, o, d, wl, pixel, 0, 0)


def _family_quad(kind):
    """A quad of material `kind` (a mix over two diffuse rows for kind 10;
    a measured row without a table reads none, which the refusal does not
    need) beside Cornell's camera."""
    import numpy as np

    from pbrt_tpu_torch.lights.buffers import LightBuffers
    from pbrt_tpu_torch.materials.buffers import MaterialBuffers
    from pbrt_tpu_torch.scene import Scene
    from pbrt_tpu_torch.shapes.geometry import GeometryBuffers, make_quad

    mats = [{"kind": 0}, {"kind": 0, "albedo": (0.2, 0.3, 0.4)},
            {"kind": kind, "mix_m0": 0, "mix_m1": 1, "mix_amount": 0.3}]
    quad = make_quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))
    return Scene(geom=GeometryBuffers.build(
                     tri_verts=quad, tri_mat=np.array([2, 2], np.int32)),
                 materials=MaterialBuffers.build(mats),
                 lights=LightBuffers.build()).with_accel()


@pytest.mark.parametrize("kind", [7, 8, 9, 10, 11],
                         ids=["hair", "subsurface", "measured", "mix",
                              "retroreflective"])
def test_forward_only_family_grad_request_raises(cornell8, kind):
    """The families of the hair / subsurface / measured / mix /
    retroreflective slice render forward only: with autograd on, a request
    for even a default trainable raises (item 5); under torch.no_grad()
    the same trace runs."""
    _, camera = cornell8
    scene = _family_quad(kind)
    assert kind in scene.shaded_kinds
    pixel = torch.arange(64)
    o, d, wl, _ = camera_rays_full(camera, pixel, 0, 0, n_spectrum=8)
    asked = _with_grad(scene, "materials", "albedo_coeffs")
    with pytest.raises(NotImplementedError, match="item 5"):
        PathIntegrator(max_depth=2).trace(asked, o, d, wl, pixel, 0, 0)
    with torch.no_grad():
        L = PathIntegrator(max_depth=2).trace(asked, o, d, wl, pixel, 0, 0)
    assert torch.isfinite(L).all()
