"""Differentiable rendering: image loss, its gradients and one SGD step,
on one device or sharded over a device mesh (port of
pbrt_tpu/parallel/train.py).

The inverse-rendering training step renders a batch of pixels, compares it
with a target image and differentiates the loss with respect to
continuous scene parameters (albedo sigmoid coefficients, light emission
scales, texels, the dielectric's IOR) through the integrator's gradient
estimator (models/path.py). Over a mesh the pixels and the target are
split into contiguous shards, one per mesh device, and the scene is
replicated; each shard's loss is its squared error over the global pixel
count, so the shards' losses and gradients sum to the one-device ones.
The sums run in mesh order on the mesh's first device, where the
parameters are updated (the reference's gradient psum).
"""

from __future__ import annotations

import torch

from ..core import spectrum
from ..films.rgb import spectrum_to_rgb
from ..models.path import DEFAULT_TRAINABLE
from ..models.path import get_leaf as _get_path
from ..models.path import with_leaves as _set_paths
from ..render import camera_rays
from .mesh import Mesh, one_process, replicate, shard_pixels

__all__ = ["DEFAULT_TRAINABLE", "loss_and_grad", "render_loss_and_grad",
           "training_step"]


def _render_pixels(scene, camera, integrator, pixel, sample_idx, seed,
                   n_spectrum):
    o, d, wl = camera_rays(camera, pixel, sample_idx, seed,
                           n_spectrum=n_spectrum)
    radiance = integrator.trace(scene, o, d, wl, pixel, sample_idx, seed)
    return spectrum_to_rgb(radiance, wl)  # (N, 3)


def loss_and_grad(scene, render, target_rgb, trainable=DEFAULT_TRAINABLE,
                  n_total: int | None = None):
    """sum((render(scene') - target_rgb)^2) / n_total, with scene' the scene
    whose `trainable` leaves are detached copies that require grad, and
    its gradients with respect to them. n_total defaults to
    target_rgb.numel() (the mean); a shard of a larger image passes the
    global count, so that the shards' losses and gradients sum to the
    whole image's. Returns (loss, {path: grad}) on the scene's device."""
    params = {p: _get_path(scene, p).detach().requires_grad_(True)
              for p in trainable}
    if n_total is None:
        n_total = target_rgb.numel()
    with torch.enable_grad():
        rgb = render(_set_paths(scene, params))
        loss = torch.sum((rgb - target_rgb) ** 2) / n_total
        if loss.requires_grad:
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        else:
            # No leaf reaches the loss (a medium's majorants, detached).
            grads = [torch.zeros_like(p) for p in params.values()]
    return loss.detach(), dict(zip(params, grads))


def render_loss_and_grad(scene, camera, integrator, pixel, target_rgb,
                         sample_idx, seed, trainable=DEFAULT_TRAINABLE,
                         n_spectrum: int = spectrum.N_SPECTRUM_DEFAULT, *,
                         n_total: int | None = None):
    """L2 image loss of one sample a pixel (loss_and_grad) and its
    gradients with respect to `trainable`, dotted scene paths that the
    integrator's estimator differentiates (for the path integrator,
    models/path.py TRAINABLE; a leaf outside it raises
    NotImplementedError naming it). The queries are detached. Everything
    runs on the device of the scene's tensors, where the gradients land
    too. Returns (loss, {path: grad})."""
    return loss_and_grad(
        scene, lambda s: _render_pixels(s, camera, integrator, pixel,
                                        sample_idx, seed, n_spectrum),
        target_rgb, trainable, n_total)


def training_step(scene, camera, integrator, pixel, target_rgb, sample_idx=0,
                  seed=0, lr: float = 1e-2, trainable=DEFAULT_TRAINABLE, *,
                  mesh=None, n_spectrum: int = spectrum.N_SPECTRUM_DEFAULT):
    """One SGD step on scene parameters. Returns (loss, new_scene) with
    each trainable leaf p replaced by p - lr * grad.

    Without a mesh it runs on the device of the scene's tensors; pixel,
    target_rgb and a sample_idx tensor are moved there. With a mesh
    (parallel/mesh.py) pixel, target_rgb and a per-pixel sample_idx are
    sharded over it and the scene replicated; the loss and the gradients
    are summed in mesh order on the mesh's first device, and the new
    scene lives there.
    """
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, not "
                            f"{type(mesh).__name__}")
        return _mesh_step(scene, camera, integrator, pixel, target_rgb,
                          sample_idx, seed, lr, trainable, one_process(mesh),
                          n_spectrum)
    dev = _get_path(scene, trainable[0]).device
    camera = camera.to(dev)
    pixel = torch.as_tensor(pixel, device=dev)
    target_rgb = torch.as_tensor(target_rgb, dtype=torch.float32, device=dev)
    if isinstance(sample_idx, torch.Tensor):
        sample_idx = sample_idx.to(dev)
    loss, grads = render_loss_and_grad(
        scene, camera, integrator, pixel, target_rgb, sample_idx, seed,
        trainable=trainable, n_spectrum=n_spectrum,
    )
    return loss, _sgd(scene, grads, lr, trainable)


def _sgd(scene, grads, lr, trainable):
    with torch.no_grad():
        return _set_paths(
            scene, {p: _get_path(scene, p).detach() - lr * grads[p]
                    for p in trainable}
        )


def _mesh_step(scene, camera, integrator, pixel, target_rgb, sample_idx,
               seed, lr, trainable, mesh, n_spectrum):
    pixel = torch.as_tensor(pixel)
    target_rgb = torch.as_tensor(target_rgb, dtype=torch.float32)
    pixels = shard_pixels(pixel, mesh)
    targets = shard_pixels(target_rgb, mesh)
    if isinstance(sample_idx, torch.Tensor) and sample_idx.ndim:
        samples = shard_pixels(sample_idx, mesh)
    else:
        samples = [sample_idx] * mesh.local_size
    parts = [
        render_loss_and_grad(sc, cam, integrator, pix, tgt, smp, seed,
                             trainable, n_spectrum,
                             n_total=target_rgb.numel())
        for sc, cam, pix, tgt, smp in zip(replicate(scene, mesh),
                                          replicate(camera, mesh), pixels,
                                          targets, samples)
    ]
    first = mesh.devices[0]
    loss = parts[0][0].to(first)
    grads = {p: parts[0][1][p].to(first) for p in trainable}
    for part_loss, part_grads in parts[1:]:
        loss = loss + part_loss.to(first)
        grads = {p: grads[p] + part_grads[p].to(first) for p in trainable}
    return loss, _sgd(scene.to(first), grads, lr, trainable)
