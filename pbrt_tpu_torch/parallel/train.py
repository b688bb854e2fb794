"""Differentiable rendering: image loss, its gradients and one SGD step.

Port of the single-device part of pbrt_tpu/parallel/train.py. The
inverse-rendering training step renders a batch of pixels, compares it
with a target image and differentiates the loss with respect to
continuous scene parameters (albedo sigmoid coefficients, light emission
scales, texels, the dielectric's IOR) through the integrator's gradient
estimator (models/path.py). The reference's pixel sharding and gradient
all-reduce over a device mesh are not ported (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

import torch

from ..core import spectrum
from ..films.rgb import spectrum_to_rgb
from ..models.path import DEFAULT_TRAINABLE
from ..models.path import get_leaf as _get_path
from ..models.path import with_leaves as _set_paths
from ..render import camera_rays

__all__ = ["DEFAULT_TRAINABLE", "render_loss_and_grad", "training_step"]


def _render_pixels(scene, camera, integrator, pixel, sample_idx, seed,
                   n_spectrum):
    o, d, wl = camera_rays(camera, pixel, sample_idx, seed,
                           n_spectrum=n_spectrum)
    radiance = integrator.trace(scene, o, d, wl, pixel, sample_idx, seed)
    return spectrum_to_rgb(radiance, wl)  # (N, 3)


def render_loss_and_grad(scene, camera, integrator, pixel, target_rgb,
                         sample_idx, seed, trainable=DEFAULT_TRAINABLE,
                         n_spectrum: int = spectrum.N_SPECTRUM_DEFAULT):
    """L2 image loss and its gradients with respect to `trainable`, dotted
    scene paths that the integrator's estimator differentiates (for the
    path integrator, models/path.py TRAINABLE; a leaf outside it raises
    NotImplementedError naming it). The queries are detached. Everything
    runs on the device of the scene's tensors, where the gradients land
    too. Returns (loss, {path: grad})."""
    params = {p: _get_path(scene, p).detach().requires_grad_(True)
              for p in trainable}
    with torch.enable_grad():
        s = _set_paths(scene, params)
        rgb = _render_pixels(s, camera, integrator, pixel, sample_idx, seed,
                             n_spectrum)
        loss = torch.mean((rgb - target_rgb) ** 2)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(params, grads))


def training_step(scene, camera, integrator, pixel, target_rgb, sample_idx=0,
                  seed=0, lr: float = 1e-2, trainable=DEFAULT_TRAINABLE, *,
                  mesh=None, n_spectrum: int = spectrum.N_SPECTRUM_DEFAULT):
    """One SGD step on scene parameters on one device. Returns (loss,
    new_scene) with each trainable leaf p replaced by p - lr * grad.

    The scene (and so its parameters) stays on its device; pixel and
    target_rgb are moved there. A device mesh (the reference's first
    argument: pixel sharding and the gradient psum) raises: multi-device
    training waits for torch.distributed (ROADMAP Queue 1 item 15).
    """
    if mesh is not None:
        raise NotImplementedError(
            "training_step over a device mesh is not ported yet (ROADMAP "
            "Queue 1 item 15); call it without one"
        )
    dev = _get_path(scene, trainable[0]).device
    camera = camera.to(dev)
    pixel = torch.as_tensor(pixel, device=dev)
    target_rgb = torch.as_tensor(target_rgb, dtype=torch.float32, device=dev)
    loss, grads = render_loss_and_grad(
        scene, camera, integrator, pixel, target_rgb, sample_idx, seed,
        trainable=trainable, n_spectrum=n_spectrum,
    )
    with torch.no_grad():
        new_scene = _set_paths(
            scene, {p: _get_path(scene, p).detach() - lr * grads[p]
                    for p in trainable}
        )
    return loss, new_scene
