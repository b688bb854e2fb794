"""Gradient requests: what the port answers and what it refuses (ROADMAP
Queue 1 item 5). With autograd on, a scene tensor outside the
estimator's trainable set (models/path.py TRAINABLE: albedo_coeffs,
area_scale and img_flat under every estimator, eta under the attached
one), the ray origins or directions, or the wavelengths that require grad
raise NotImplementedError at entry; so do the texture tables other than
img_flat and conductor roughness. Each estimator (remat, cvjp with every
replay_remat, attached) and each of the hair, subsurface, measured, mix
and retroreflective families answers, held against the reference's
gradients in committed goldens (scripts/make_torch_port_golden_grad.py).
Under torch.no_grad() the render is what it was without a request."""

import numpy as np
import pytest
import torch

from pbrt_tpu_torch.io.parser import load_pbrt
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.parallel.train import render_loss_and_grad, training_step
from pbrt_tpu_torch.render import camera_rays_full, render
from pbrt_tpu_torch.scenes.cornell import cornell_box

from .torch_port_families import coarse_mix_keys
from .torch_port_grad import (
    ATTACHED_LEAVES,
    DEFAULT_LEAVES,
    FAMILIES_GRAD,
    GRAD_MODES,
    GRAD_RTOL_OF_MAX,
    LOSS_RTOL,
    TEXEL_LEAVES,
    TEXEL_MODES,
    dielectric_cornell,
    families_box,
    golden,
    grad_errors,
    pass_loss_and_grads,
    texel_cornell,
)

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


@pytest.mark.parametrize("field", ["rgb0", "f0"])
def test_texture_grad_request_raises(imagetex8, field):
    """Of the texture tables only img_flat trains: a request for another
    raises (item 5)."""
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




def test_roughness_grad_request_raises_under_every_estimator(cornell8):
    """Conductor roughness stays refused (the reference's gradient is
    NaN, ROADMAP Queue 3), and eta outside the attached estimator."""
    scene, camera = cornell8
    pixel = torch.arange(64)
    o, d, wl, _ = camera_rays_full(camera, pixel, 0, 0, n_spectrum=8)
    for kw in ({}, {"grad_mode": "cvjp"}, {"replay_grad": False}):
        asked = _with_grad(scene, "materials", "roughness")
        with pytest.raises(NotImplementedError, match="roughness.*Queue 3"):
            PathIntegrator(max_depth=2, **kw).trace(asked, o, d, wl, pixel,
                                                    0, 0)
    for kw in ({}, {"grad_mode": "cvjp"}):
        asked = _with_grad(scene, "materials", "eta")
        with pytest.raises(NotImplementedError, match="eta.*replay_grad"):
            PathIntegrator(max_depth=2, **kw).trace(asked, o, d, wl, pixel,
                                                    0, 0)


@pytest.mark.parametrize("mode", ["remat", "cvjp_full", "cvjp_dots",
                                  "cvjp_none", "attached"])
def test_grad_mode_matches_golden(mode):
    """Each estimator against the reference's gradients
    (tests/data/torch_port/grad_modes16.npz; 16x16, 2 spp, depth 5, the
    bench loss): the textured Cornell box's albedo_coeffs, area_scale and
    img_flat under remat and cvjp with each replay_remat, and the rough
    dielectric box's albedo_coeffs, area_scale and eta under the attached
    estimator; each gradient within 1e-3 of its golden's largest entry,
    the loss within a relative 1e-4."""
    z = np.load(GRAD_MODES)
    res, spp = int(z["resolution"]), int(z["spp"])
    if mode == "attached":
        scene, camera = dielectric_cornell(res)
        kw, leaves = {"replay_grad": False}, ATTACHED_LEAVES
    else:
        scene, camera = texel_cornell(res)
        kw, leaves = dict(TEXEL_MODES)[mode], TEXEL_LEAVES
    integ = PathIntegrator(max_depth=int(z["max_depth"]),
                           rr_start_depth=int(z["rr_start_depth"]), **kw)
    assert integ.estimator(scene) == mode.split("_")[0]
    loss, grads = pass_loss_and_grads(scene.with_accel(), camera, integ,
                                      leaves, res, spp)
    errs = grad_errors(loss, grads, *golden(z, mode, leaves))
    assert errs["ok"], errs


@pytest.fixture(scope="module")
def families_grads():
    """The families box's loss and gradients (the attached estimator: it
    holds a subsurface block) at the golden's shape, on coarse mix keys
    as the golden was made."""
    from pbrt_tpu_torch.materials import bxdf

    z = np.load(FAMILIES_GRAD)
    res, spp = int(z["resolution"]), int(z["spp"])
    scene, camera, integ = families_box(res)
    assert integ.estimator(scene) == "attached"
    with coarse_mix_keys(bxdf):
        loss, grads = pass_loss_and_grads(scene, camera, integ,
                                          DEFAULT_LEAVES, res, spp)
    return scene, golden(z, "families", DEFAULT_LEAVES), loss, grads


@pytest.mark.parametrize("kind", [7, 8, 9, 10, 11],
                         ids=["hair", "subsurface", "measured", "mix",
                              "retroreflective"])
def test_family_gradient_matches_golden(families_grads, kind):
    """Each family answers the default trainable set (item 5d): on the
    families box (tests/data/torch_port/families16_grad.npz) the loss, the
    area_scale gradient and the albedo rows of the family's material (a
    mix's with its two sub-materials') within 1e-3 of the golden's
    largest entry; and on a quad of the family alone under the default
    estimator, finite gradients."""
    scene, (want_loss, want), loss, grads = families_grads
    kinds = scene.materials.kind
    rows = [int(m) for m in torch.nonzero(kinds == kind)]
    if kind == 10:
        m = scene.materials
        rows += [int(m.mix_m0[rows[0]]), int(m.mix_m1[rows[0]])]
    picked = {"materials.albedo_coeffs": rows, "lights.area_scale": None}
    for name, g in grads.items():
        scale = float(np.max(np.abs(want[name])))
        sel = slice(None) if picked[name] is None else picked[name]
        err = np.abs(g[sel] - want[name][sel])
        assert np.all(np.isfinite(g)) and np.all(err <= GRAD_RTOL_OF_MAX
                                                 * scale), (name, err, scale)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)

    _, camera = cornell_box(resolution=(8, 8))
    quad = _family_quad(kind)
    pixel = torch.arange(64)
    _, grads = render_loss_and_grad(quad, camera, PathIntegrator(max_depth=2),
                                    pixel, torch.full((64, 3), 0.25), 0, 0,
                                    n_spectrum=8)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


def _family_quad(kind):
    """A quad of material `kind` (a mix over two diffuse rows for kind 10;
    a measured row without a table reads none) before Cornell's camera,
    lit by a point light on the camera's side."""
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
                 lights=LightBuffers.build(points=[{
                     "p": (0.5, 0.5, -0.5), "rgb": (1.0, 1.0, 1.0),
                     "scale": 4.0}])).with_accel()
