"""The port's gradient estimators beyond the default (ROADMAP Queue 1 item
5a-5d) on the CPU: the reference's finite-difference gates of the texel
and the IOR gradients (tests/test_gradients.py), the detached default
against the attached estimator, grad_mode="cvjp" with every
replay_remat against the remat path, and the cvjp forward against the
primal. The gradients against the reference's own are held in
tests/test_torch_grad_refusal.py against committed goldens; nothing here
runs the reference.
"""

import numpy as np
import pytest
import torch

from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.render import camera_rays
from pbrt_tpu_torch.scenes.cornell import cornell_box

from .torch_port_grad import (
    TEXEL_LEAVES,
    dielectric_cornell,
    pass_loss_and_grads,
    texel_cornell,
)

torch.set_num_threads(2)


def _mean_image(scene, camera, integrator, res=8, spp=4, seed=0):
    """tests/test_gradients.py's loss: the mean radiance of a pass."""
    npix = res * res
    pixel = torch.arange(npix).repeat(spp)
    sample = torch.arange(spp).repeat_interleave(npix)
    o, d, wl = camera_rays(camera, pixel, sample, seed)
    return torch.mean(integrator.trace(scene, o, d, wl, pixel, sample, seed))


def _check_grad(loss_fn, theta0, eps, rtol, n_check):
    """tests/test_gradients.py's _check_grad: reverse mode against central
    differences on the n_check largest entries, every entry finite."""
    x = theta0.clone().requires_grad_(True)
    g, = torch.autograd.grad(loss_fn(x), x)
    g = g.numpy().ravel()
    assert np.all(np.isfinite(g))
    for i in np.argsort(-np.abs(g))[:n_check]:
        tp, tm = theta0.clone().reshape(-1), theta0.clone().reshape(-1)
        tp[i] += eps
        tm[i] -= eps
        with torch.no_grad():
            fd = (float(loss_fn(tp.reshape(theta0.shape)))
                  - float(loss_fn(tm.reshape(theta0.shape)))) / (2 * eps)
        assert abs(fd - g[i]) <= rtol * max(abs(fd), abs(g[i]), 1e-6), \
            (i, fd, g[i])


def test_texture_texel_gradient_matches_fd():
    """The texel gradient (item 5a) under the default estimator: 8x8,
    depth 2, eps 1e-2, rtol 0.06 on the two largest entries."""
    scene, camera = texel_cornell(8)
    integ = PathIntegrator(max_depth=2, rr_start_depth=100)

    def loss(flat):
        return _mean_image(
            scene.replace(textures=scene.textures.replace(img_flat=flat)),
            camera, integ)

    _check_grad(loss, scene.textures.img_flat, eps=1e-2, rtol=0.06,
                n_check=2)


def test_ior_gradient_matches_fd():
    """The dielectric's eta under the attached estimator (item 5b): depth
    3, eps 5e-3, rtol 0.08 on the largest entry. Every entry is finite
    (the reference's reverse mode answers NaN for three of the five,
    ROADMAP Queue 3)."""
    scene, camera = dielectric_cornell(8)
    assert 2 in scene.shaded_kinds  # the dielectric's link runs
    integ = PathIntegrator(max_depth=3, rr_start_depth=100,
                           replay_grad=False)
    mats = scene.materials

    def loss(eta):
        return _mean_image(scene.replace(materials=mats.replace(eta=eta)),
                           camera, integ)

    _check_grad(loss, mats.eta, eps=5e-3, rtol=0.08, n_check=1)


def test_detached_default_matches_attached_for_albedo():
    """The detachment drops only sampling-Jacobian terms, which albedo
    does not reach: both estimators agree (rtol 1e-4, atol 1e-7)."""
    scene, camera = cornell_box(resolution=(8, 8))

    def grad(integ):
        x = scene.materials.albedo_coeffs.clone().requires_grad_(True)
        s = scene.replace(materials=scene.materials.replace(albedo_coeffs=x))
        return torch.autograd.grad(_mean_image(s, camera, integ), x)[0]

    g_det = grad(PathIntegrator(max_depth=3, rr_start_depth=100))
    g_att = grad(PathIntegrator(max_depth=3, rr_start_depth=100,
                                replay_grad=False))
    assert torch.any(g_det != 0.0)
    np.testing.assert_allclose(g_det.numpy(), g_att.numpy(), rtol=1e-4,
                               atol=1e-7)


# cvjp against remat: the same estimator, so the loss is bit-equal and
# each gradient within 1e-5 of its tensor's largest entry (measured: bit-
# equal on the 8x8 textured box).
CVJP_RTOL_OF_MAX = 1e-5


@pytest.fixture(scope="module")
def remat_texel():
    scene, camera = texel_cornell(8)
    scene = scene.with_accel()
    integ = PathIntegrator(max_depth=5, rr_start_depth=5)
    return scene, camera, pass_loss_and_grads(scene, camera, integ,
                                              TEXEL_LEAVES, 8, 2)


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_cvjp_matches_remat(remat_texel, remat):
    """grad_mode="cvjp" (item 5c) on the textured box, 8x8, 2 spp, depth
    5: the loss bit-equal to remat's, every leaf's gradient within
    CVJP_RTOL_OF_MAX of the largest entry."""
    scene, camera, (want_loss, want) = remat_texel
    integ = PathIntegrator(max_depth=5, rr_start_depth=5, grad_mode="cvjp",
                           replay_remat=remat)
    loss, grads = pass_loss_and_grads(scene, camera, integ, TEXEL_LEAVES,
                                      8, 2)
    assert loss == want_loss
    for name in TEXEL_LEAVES:
        scale = np.max(np.abs(want[name]))
        assert scale > 0.0, name
        np.testing.assert_allclose(grads[name], want[name], rtol=0,
                                   atol=CVJP_RTOL_OF_MAX * scale,
                                   err_msg=name)


def test_cvjp_forward_equals_primal():
    """The cvjp forward (the recording trace) is bit-equal to the primal,
    radiance and ray count."""
    scene, camera = texel_cornell(8)
    scene = scene.with_accel()
    pixel = torch.arange(64).repeat(2)
    sample = torch.arange(2).repeat_interleave(64)
    o, d, wl = camera_rays(camera, pixel, sample, 0)
    integ = PathIntegrator(max_depth=5, rr_start_depth=2, grad_mode="cvjp")
    with torch.no_grad():
        want, want_stats = integ.trace_with_stats(scene, o, d, wl, pixel,
                                                  sample, 0)
    x = scene.textures.img_flat.clone().requires_grad_(True)
    asked = scene.replace(textures=scene.textures.replace(img_flat=x))
    got, stats = integ.trace_with_stats(asked, o, d, wl, pixel, sample, 0)
    assert got.requires_grad and torch.equal(got.detach(), want)
    assert torch.equal(stats["rays"], want_stats["rays"])
