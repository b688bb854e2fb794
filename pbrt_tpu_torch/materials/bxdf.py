"""Branchless BxDF evaluation/sampling over ray batches.

Port of pbrt_tpu/materials/bxdf.py, diffuse family only. Directions are in
the shading-local frame (z = shading normal); spectral values are (N, S).

Dispatch keeps the reference's select chain: each family is evaluated for
every ray and the material `kind` tag selects per ray with torch.where.
Only the diffuse link exists yet; the other families (ROADMAP Queue 1
item 10) slot in as further selects. `Scene` refuses geometry that
references a non-diffuse material, so no lane ever needs a missing link.
"""

from __future__ import annotations

import torch

from ..core import rgb2spec
from ..core.sampling import (
    INV_PI,
    cosine_hemisphere_pdf,
    sample_cosine_hemisphere,
)
from .buffers import MAT_DIFFUSE


def _abscos(w):
    return torch.abs(w[..., 2])


def _same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0.0


# --- Diffuse (Lambertian) ---------------------------------------------------


def diffuse_f(albedo, wo, wi):
    same = _same_hemisphere(wo, wi)
    return torch.where(same[..., None], albedo * INV_PI, 0.0)


def diffuse_sample(albedo, wo, u2):
    wi = sample_cosine_hemisphere(u2)
    flip = torch.where(wo[..., 2] < 0.0, -1.0, 1.0)
    wi = torch.cat([wi[..., :2], wi[..., 2:3] * flip[..., None]], dim=-1)
    pdf = cosine_hemisphere_pdf(_abscos(wi))
    return wi, albedo * INV_PI, pdf


def diffuse_pdf(wo, wi):
    same = _same_hemisphere(wo, wi)
    return torch.where(same, cosine_hemisphere_pdf(_abscos(wi)), 0.0)


# --- Dispatch ---------------------------------------------------------------


def surface_params(scene, isect, lam=None):
    """Per-ray material parameters at a surface interaction."""
    params = scene.materials.gather(isect.mat)
    if lam is not None:
        params["lam"] = lam
    return params


def evaluate(params, wo, wi, lam):
    """f(wo, wi) for each ray given gathered material params; (N, S)."""
    kind = params["kind"]
    albedo = rgb2spec.eval_sigmoid(params["albedo_coeffs"], lam)
    return torch.where(
        (kind == MAT_DIFFUSE)[..., None], diffuse_f(albedo, wo, wi), 0.0
    )


def pdf(params, wo, wi):
    kind = params["kind"]
    return torch.where(kind == MAT_DIFFUSE, diffuse_pdf(wo, wi), 0.0)


def sample(params, wo, lam, u2, uc):
    """Sample wi for each ray. Returns dict(wi, f, pdf, specular)."""
    albedo = rgb2spec.eval_sigmoid(params["albedo_coeffs"], lam)
    wi, f, p = diffuse_sample(albedo, wo, u2)
    specular = torch.zeros(wo.shape[:-1], dtype=torch.bool, device=wo.device)
    return {"wi": wi, "f": f, "pdf": p, "specular": specular}
