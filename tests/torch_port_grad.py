"""The gradient goldens' scenes and loss in the port, for the tests and
chip_smoke.py (numpy and torch only): the textured Cornell box, the
Cornell box with a rough dielectric, the families box, and the bench
loss of one pass with its gradients, as
scripts/make_torch_port_golden_grad.py computes them with the reference
(tests/data/torch_port/grad_modes16.npz, families16_grad.npz).
"""

from __future__ import annotations

import os

import numpy as np
import torch

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
GRAD_MODES = os.path.join(DATA, "grad_modes16.npz")
FAMILIES_GRAD = os.path.join(DATA, "families16_grad.npz")

TEXEL_LEAVES = ("materials.albedo_coeffs", "lights.area_scale",
                "textures.img_flat")
ATTACHED_LEAVES = ("materials.albedo_coeffs", "lights.area_scale",
                   "materials.eta")
DEFAULT_LEAVES = ("materials.albedo_coeffs", "lights.area_scale")
# (golden key prefix, PathIntegrator keywords) of the textured box's
# estimators.
TEXEL_MODES = (("remat", {}),
               ("cvjp_full", {"grad_mode": "cvjp", "replay_remat": "full"}),
               ("cvjp_dots", {"grad_mode": "cvjp", "replay_remat": "dots"}),
               ("cvjp_none", {"grad_mode": "cvjp", "replay_remat": "none"}))
# The gate of every gradient against its golden: each entry within 1e-3
# of its tensor's largest magnitude (chip_smoke.py phase g's), and the
# loss within a relative 1e-4.
GRAD_RTOL_OF_MAX = 1e-3
LOSS_RTOL = 1e-4


def texel_cornell(res: int):
    """tests/test_gradients.py's textured Cornell box: a 4x4 image texture
    (seed 3) on material 0. No accelerator attached."""
    from pbrt_tpu_torch.scenes.cornell import cornell_box
    from pbrt_tpu_torch.textures.buffers import TextureBuffers

    scene, camera = cornell_box(resolution=(res, res))
    rng = np.random.default_rng(3)
    tex_rgb = rng.uniform(0.2, 0.8, (4, 4, 3)).astype(np.float32)
    textures = TextureBuffers.build([{"kind": "image", "rgb_image": tex_rgb}])
    atex = torch.full(scene.materials.kind.shape, -1, dtype=torch.int32)
    atex[0] = 0
    return scene.replace(
        materials=scene.materials.replace(albedo_tex=atex),
        textures=textures), camera


def dielectric_cornell(res: int):
    """tests/test_gradients.py's IOR box: material 1 a dielectric, every
    row's roughness 0.25 and eta 1.5. No accelerator attached."""
    from pbrt_tpu_torch.materials.buffers import MAT_DIELECTRIC
    from pbrt_tpu_torch.scenes.cornell import cornell_box

    scene, camera = cornell_box(resolution=(res, res))
    m = scene.materials
    kind = m.kind.clone()
    kind[1] = MAT_DIELECTRIC
    n = kind.shape[0]
    return scene.replace(materials=m.replace(
        kind=kind, roughness=torch.full((n,), 0.25),
        eta=torch.full((n,), 1.5))), camera


def families_box(res: int, device="cpu"):
    """tests/data/torch_port/families.pbrt with its integrator."""
    from pbrt_tpu_torch.io.parser import load_pbrt

    scene, camera, settings = load_pbrt(os.path.join(DATA, "families.pbrt"),
                                        device=device)
    return scene, camera.replace(resolution=(res, res)), settings["integrator"]


def pass_loss_and_grads(scene, camera, integrator, leaves, res: int,
                        spp: int, lanes: int = 8, target: float = 0.25,
                        seed: int = 0, first_sample: int = 0):
    """The bench loss of one pass (spp samples per pixel over res x res
    from sample first_sample on) and its gradients with respect to
    `leaves`, on the scene's device, through
    parallel.train.render_loss_and_grad. Returns (float loss, {leaf:
    float64 numpy gradient})."""
    from pbrt_tpu_torch.parallel.train import render_loss_and_grad

    dev = scene.geom.tri_verts.device
    npix = res * res
    pixel = torch.arange(npix, device=dev).repeat(spp)
    sample = torch.arange(first_sample, first_sample + spp,
                          device=dev).repeat_interleave(npix)
    tgt = torch.full((npix * spp, 3), target, device=dev)
    loss, grads = render_loss_and_grad(
        scene, camera.replace(resolution=(res, res)).to(dev), integrator,
        pixel, tgt, sample, seed, trainable=leaves, n_spectrum=lanes)
    return float(loss), {k: g.detach().cpu().double().numpy()
                         for k, g in grads.items()}


def golden(z, prefix: str, leaves) -> tuple:
    """(loss, {leaf: gradient}) of a golden file's `prefix` entries."""
    return float(z[f"{prefix}_loss"]), {
        p: np.asarray(z[f"{prefix}_grad_{p.split('.')[-1]}"], np.float64)
        for p in leaves}


def grad_errors(loss, grads, want_loss, want) -> dict:
    """The loss's relative error and each gradient's largest error over
    its golden's largest magnitude; "ok" when all are within bounds and
    finite."""
    out = {"loss_rel_err": abs(loss - want_loss) / abs(want_loss)}
    ok = out["loss_rel_err"] <= LOSS_RTOL
    for name, g in grads.items():
        w = np.asarray(want[name], np.float64).reshape(g.shape)
        scale = float(np.max(np.abs(w)))
        err = float(np.max(np.abs(g - w))) if g.size else 0.0
        out[name] = err / scale if scale else err
        ok &= bool(np.all(np.isfinite(g))) and err <= GRAD_RTOL_OF_MAX * scale
    out["ok"] = bool(ok)
    return out
