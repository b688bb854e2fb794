"""Branchless BxDF evaluation/sampling over ray batches.

Port of pbrt_tpu/materials/bxdf.py: the diffuse and conductor families.
Directions are in the shading-local frame (z = shading normal); spectral
values are (N, S).

Dispatch keeps the reference's select chain: each family is evaluated for
every ray and the material `kind` tag selects per ray with torch.where; a
family's link runs only when the scene's geometry references that family
(`params["any_conductor"]`, from `Scene.shaded_kinds`). The reference
keys the link on the material list instead; an unreferenced row selects
no live lane, so the image is the same, and a list with a spare copper
row (Cornell's) skips the link. The other families (ROADMAP Queue 1 item
10) slot in as further selects. `Scene` refuses geometry that references
them, so no lane ever needs a missing link.
"""

from __future__ import annotations

import torch

from ..core import rgb2spec
from ..core.sampling import (
    INV_PI,
    cosine_hemisphere_pdf,
    sample_cosine_hemisphere,
)
from ..core.vecmath import normalize
from . import scattering as sc
from .buffers import MAT_CONDUCTOR, MAT_DIFFUSE

_EPS = 1e-8


def _abscos(w):
    return torch.abs(w[..., 2])


def _same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0.0


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


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


# --- Conductor (bxdfs.h ConductorBxDF) --------------------------------------


def conductor_f(eta, k, alpha, wo, wi):
    """Rough-conductor BRDF; 0 where effectively smooth. eta, k: (N, S)."""
    same = _same_hemisphere(wo, wi)
    cos_o = _abscos(wo)
    cos_i = _abscos(wi)
    wm = wo + wi
    wm_ok = torch.sum(wm * wm, dim=-1) > 1e-16
    wm = normalize(wm)
    f_spec = sc.fr_complex(torch.abs(_dot(wo, wm))[..., None], eta, k)
    d = sc.ggx_d(wm, alpha)
    g = sc.ggx_g(wo, wi, alpha)
    scale = d * g / torch.clamp(4.0 * cos_o * cos_i, min=_EPS)
    rough = ~sc.effectively_smooth(alpha)
    ok = same & wm_ok & rough & (cos_o > 0) & (cos_i > 0)
    return torch.where(ok[..., None], scale[..., None] * f_spec, 0.0)


def conductor_pdf(alpha, wo, wi):
    same = _same_hemisphere(wo, wi)
    wm = wo + wi
    wm_ok = torch.sum(wm * wm, dim=-1) > 1e-16
    wm = normalize(wm)
    wm = torch.where((wm[..., 2] < 0.0)[..., None], -wm, wm)
    p = sc.ggx_pdf_wm(wo, wm, alpha) / torch.clamp(
        4.0 * torch.abs(_dot(wo, wm)), min=_EPS
    )
    rough = ~sc.effectively_smooth(alpha)
    return torch.where(same & wm_ok & rough, p, 0.0)


def conductor_sample(eta, k, alpha, wo, u2):
    """Returns (wi, f, pdf, specular). Smooth -> perfect mirror delta."""
    smooth = sc.effectively_smooth(alpha)
    wi_s = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
    f_s = sc.fr_complex(_abscos(wi_s)[..., None], eta, k) / torch.clamp(
        _abscos(wi_s), min=_EPS
    )[..., None]
    wm = sc.ggx_sample_wm(wo, u2, torch.clamp(alpha, min=1e-3))
    wi_r = -wo + 2.0 * _dot(wo, wm)[..., None] * wm
    pdf_r = sc.ggx_pdf_wm(wo, wm, alpha) / torch.clamp(
        4.0 * torch.abs(_dot(wo, wm)), min=_EPS
    )
    f_r = conductor_f(eta, k, alpha, wo, wi_r)
    same_r = _same_hemisphere(wo, wi_r)
    wi = torch.where(smooth[..., None], wi_s, wi_r)
    f = torch.where(smooth[..., None], f_s, f_r)
    p = torch.where(smooth, 1.0, torch.where(same_r, pdf_r, 0.0))
    return wi, f, p, smooth


def _gather_spectral_eta_k(params, lam):
    eta = rgb2spec.eval_unbounded(
        params["cond_eta_coeffs"], params["cond_eta_scale"], lam
    )
    k = rgb2spec.eval_unbounded(
        params["cond_k_coeffs"], params["cond_k_scale"], lam
    )
    return eta, k


# --- Dispatch ---------------------------------------------------------------


def surface_params(scene, isect, lam=None):
    """Per-ray material parameters at a surface interaction."""
    params = scene.materials.gather(isect.mat)
    params["any_conductor"] = MAT_CONDUCTOR in scene.shaded_kinds
    if lam is not None:
        params["lam"] = lam
    return params


def evaluate(params, wo, wi, lam):
    """f(wo, wi) for each ray given gathered material params; (N, S).
    Delta lobes (smooth conductors) return 0 here: their contribution
    arrives only through sampling."""
    kind = params["kind"]
    albedo = rgb2spec.eval_sigmoid(params["albedo_coeffs"], lam)
    f = torch.where(
        (kind == MAT_DIFFUSE)[..., None], diffuse_f(albedo, wo, wi), 0.0
    )
    if params["any_conductor"]:
        alpha = sc.roughness_to_alpha(params["roughness"])
        eta_c, k_c = _gather_spectral_eta_k(params, lam)
        f = torch.where(
            (kind == MAT_CONDUCTOR)[..., None],
            conductor_f(eta_c, k_c, alpha, wo, wi), f,
        )
    return f


def pdf(params, wo, wi):
    kind = params["kind"]
    p = torch.where(kind == MAT_DIFFUSE, diffuse_pdf(wo, wi), 0.0)
    if params["any_conductor"]:
        alpha = sc.roughness_to_alpha(params["roughness"])
        p = torch.where(kind == MAT_CONDUCTOR, conductor_pdf(alpha, wo, wi), p)
    return p


def sample(params, wo, lam, u2, uc):
    """Sample wi for each ray. Returns dict(wi, f, pdf, specular)."""
    kind = params["kind"]
    albedo = rgb2spec.eval_sigmoid(params["albedo_coeffs"], lam)
    wi, f, p = diffuse_sample(albedo, wo, u2)
    specular = torch.zeros(wo.shape[:-1], dtype=torch.bool, device=wo.device)
    if params["any_conductor"]:
        alpha = sc.roughness_to_alpha(params["roughness"])
        eta_c, k_c = _gather_spectral_eta_k(params, lam)
        wi_c, f_c, p_c, spec_c = conductor_sample(eta_c, k_c, alpha, wo, u2)
        m = kind == MAT_CONDUCTOR
        wi = torch.where(m[..., None], wi_c, wi)
        f = torch.where(m[..., None], f_c, f)
        p = torch.where(m, p_c, p)
        specular = torch.where(m, spec_c, specular)
    return {"wi": wi, "f": f, "pdf": p, "specular": specular}
