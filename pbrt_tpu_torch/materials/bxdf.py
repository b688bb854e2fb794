"""Branchless BxDF evaluation/sampling over ray batches.

Port of pbrt_tpu/materials/bxdf.py: every family of the reference (the
diffuse, conductor, dielectric, thin-dielectric, diffuse-transmission,
coated diffuse and coated conductor, hair, measured and retroreflective
BxDFs, the normalized-Fresnel lobe a subsurface lane exits with, the
material-less interface's passthrough link), the mix materials' per-ray
resolution and the textured-albedo overlay of `surface_params`.
Directions are in the shading-local frame (z = shading normal); spectral
values are (N, S). The dielectric families return a scalar f of shape
(N,), broadcast to (N, S) by the select chain.

Dispatch keeps the reference's select chain: each family is evaluated for
every ray and the material `kind` tag selects per ray with torch.where; a
family's link runs only when the scene's geometry references that family
(the `params["any_*"]` flags of `surface_params`, from
`Scene.shaded_kinds`, which counts a mix's two sub-materials as
referenced). The reference keys the links on the material list instead,
and runs the coated conductor's link whenever the list holds a coated
family and a conductor one; an unreferenced row selects no live lane, so
the image is the same, and a list with spare copper and glass rows
(Cornell's) skips their links. The coated families take f from the
layered walk (materials/layered.py) in `evaluate` and `sample`, and the
pdf and the sampled direction from the two-lobe approximation, as the
reference does. materials/sorted.py runs the chain per family.
"""

from __future__ import annotations

import math

import torch

from ..core import rgb2spec
from ..core import rng
from ..core.sampling import (
    INV_PI,
    cosine_hemisphere_pdf,
    sample_cosine_hemisphere,
)
from ..core.take import take
from ..core.vecmath import normalize, refract
from . import hair
from . import measured
from . import scattering as sc
from .bssrdf import fresnel_moment1
from .buffers import (
    MAT_COATEDCONDUCTOR,
    MAT_COATEDDIFFUSE,
    MAT_CONDUCTOR,
    MAT_DIELECTRIC,
    MAT_DIFFUSE,
    MAT_DIFFUSETRANS,
    MAT_HAIR,
    MAT_INTERFACE,
    MAT_MEASURED,
    MAT_MIX,
    MAT_NORMFRESNEL,
    MAT_RETRO,
    MAT_SUBSURFACE,
    MAT_THINDIELECTRIC,
)
from . import layered

# The per-ray flags of `surface_params`: the kind whose link each gates.
# A subsurface lane shades with the normalized-Fresnel lobe: the path
# integrator rewrites its kind to MAT_NORMFRESNEL at the exit vertex, and
# evaluate / pdf / sample rewrite a kind still MAT_SUBSURFACE (the
# volumetric path has no subsurface step), so one flag gates both kinds.
FAMILY_FLAGS = {
    MAT_CONDUCTOR: "any_conductor",
    MAT_DIELECTRIC: "any_dielectric",
    MAT_THINDIELECTRIC: "any_thin",
    MAT_DIFFUSETRANS: "any_diffusetrans",
    MAT_COATEDDIFFUSE: "any_coated_diffuse",
    MAT_COATEDCONDUCTOR: "any_coated_conductor",
    MAT_HAIR: "any_hair",
    MAT_SUBSURFACE: "any_subsurface",
    MAT_NORMFRESNEL: "any_subsurface",
    MAT_MEASURED: "any_measured",
    MAT_RETRO: "any_retro",
}
FLAGS = tuple(dict.fromkeys(FAMILY_FLAGS.values()))

# The mix materials' hash salt ("MIXC").
_MIX_SALT = 0x4D495843

_EPS = 1e-8


def _cos(w):
    return w[..., 2]


def _abscos(w):
    return torch.abs(w[..., 2])


def _same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0.0


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _mirror(wo):
    """Specular reflection about the local normal."""
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)


# --- Diffuse (Lambertian) ---------------------------------------------------


def diffuse_f(albedo, wo, wi):
    same = _same_hemisphere(wo, wi)
    return torch.where(same[..., None], albedo * INV_PI, 0.0)


def _cosine_sample(wo, u2):
    """A cosine-distributed direction on wo's side, and its pdf."""
    wi = sample_cosine_hemisphere(u2)
    flip = torch.where(wo[..., 2] < 0.0, -1.0, 1.0)
    wi = torch.cat([wi[..., :2], wi[..., 2:3] * flip[..., None]], dim=-1)
    return wi, cosine_hemisphere_pdf(_abscos(wi))


def diffuse_sample(albedo, wo, u2):
    wi, pdf = _cosine_sample(wo, u2)
    return wi, albedo * INV_PI, pdf


def diffuse_pdf(wo, wi):
    same = _same_hemisphere(wo, wi)
    return torch.where(same, cosine_hemisphere_pdf(_abscos(wi)), 0.0)


# --- Normalized Fresnel (bxdfs.h NormalizedFresnelBxDF) ---------------------
# The BSSRDF's Sw lobe: the normalized Fresnel transmittance
# (1 - Fr(cos_i, eta)) / (c pi), with c = 1 - 2 FresnelMoment1(1 / eta),
# times eta^2 for radiance transport; `sample` draws its directions from
# the cosine hemisphere. The cosine is |cos wi|, the reference's rule
# (pbrt-v4 passes the signed one).


def normfresnel_f(eta, wo, wi, n_lam):
    same = _same_hemisphere(wo, wi)
    c = 1.0 - 2.0 * fresnel_moment1(1.0 / eta)
    fr = sc.fr_dielectric(_abscos(wi), eta)
    val = (1.0 - fr) / (c * math.pi) * (eta * eta)
    val = torch.where(same, val, 0.0)
    return val[..., None].expand(*val.shape, n_lam)



# --- Diffuse transmission (bxdfs.h DiffuseTransmissionBxDF) -----------------


def diffusetrans_f(refl, trans, wo, wi):
    same = _same_hemisphere(wo, wi)
    return torch.where(same[..., None], refl, trans) * INV_PI


def diffusetrans_pdf(wo, wi):
    """The lobe is chosen 50/50, cosine-distributed on each side."""
    return 0.5 * cosine_hemisphere_pdf(_abscos(wi))


def diffusetrans_sample(refl, trans, wo, u2, uc):
    wi = sample_cosine_hemisphere(u2)
    side = torch.where(wo[..., 2] < 0.0, -1.0, 1.0)
    flip = torch.where(uc < 0.5, -side, side)
    wi = torch.cat([wi[..., :2], wi[..., 2:3] * flip[..., None]], dim=-1)
    return wi, diffusetrans_f(refl, trans, wo, wi), diffusetrans_pdf(wo, wi)


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
    wi_s = _mirror(wo)
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


# --- Dielectric (bxdfs.h DielectricBxDF) ------------------------------------


def _dielectric_eta_p(eta, wo_z, reflect):
    """Effective relative IOR of the generalized half-vector."""
    eta_side = torch.where(wo_z > 0.0, eta, 1.0 / eta)
    return torch.where(reflect, 1.0, eta_side)


def _dielectric_half(eta, wo, wi):
    """The generalized half-vector of (wo, wi) and what both dielectric_f
    and dielectric_pdf derive from it."""
    cos_o = _cos(wo)
    cos_i = _cos(wi)
    reflect = cos_o * cos_i > 0.0
    eta_p = _dielectric_eta_p(eta, cos_o, reflect)
    wm_raw = wi * eta_p[..., None] + wo
    wm_ok = (
        (torch.abs(cos_o) > 1e-8)
        & (torch.abs(cos_i) > 1e-8)
        & (torch.sum(wm_raw * wm_raw, dim=-1) > 1e-16)
    )
    wm = normalize(wm_raw)
    wm = torch.where((wm[..., 2] < 0.0)[..., None], -wm, wm)
    backface = (_dot(wm, wi) * cos_i < 0.0) | (_dot(wm, wo) * cos_o < 0.0)
    fr = sc.fr_dielectric(_dot(wo, wm), eta)
    denom = (_dot(wi, wm) + _dot(wo, wm) / torch.clamp(eta_p, min=_EPS)) ** 2
    return cos_o, cos_i, reflect, eta_p, wm, wm_ok & ~backface, fr, denom


def dielectric_f(eta, alpha, wo, wi):
    """Rough dielectric BSDF (radiance transport). eta: (N,) scalar IOR.
    Returns a scalar (N,) density; the caller broadcasts it to (N, S)
    (no dispersion)."""
    rough = ~sc.effectively_smooth(alpha)
    cos_o, cos_i, reflect, eta_p, wm, ok, fr, denom = _dielectric_half(
        eta, wo, wi)
    d = sc.ggx_d(wm, alpha)
    g = sc.ggx_g(wo, wi, alpha)
    f_refl = d * g * fr / torch.clamp(torch.abs(4.0 * cos_o * cos_i), min=_EPS)
    # Transmission (radiance mode: the extra 1 / eta_p^2).
    f_trans = (
        d
        * (1.0 - fr)
        * g
        * torch.abs(
            _dot(wi, wm)
            * _dot(wo, wm)
            / torch.clamp(torch.abs(cos_i * cos_o) * denom, min=_EPS)
        )
        / torch.clamp(eta_p * eta_p, min=_EPS)
    )
    f = torch.where(reflect, f_refl, f_trans)
    return torch.where(rough & ok, f, 0.0)


def dielectric_pdf(eta, alpha, wo, wi):
    rough = ~sc.effectively_smooth(alpha)
    _, _, reflect, _, wm, ok, fr, denom = _dielectric_half(eta, wo, wi)
    pdf_wm = sc.ggx_pdf_wm(wo, wm, alpha)
    pdf_refl = pdf_wm / torch.clamp(4.0 * torch.abs(_dot(wo, wm)), min=_EPS) * fr
    dwm_dwi = torch.abs(_dot(wi, wm)) / torch.clamp(denom, min=_EPS)
    pdf_trans = pdf_wm * dwm_dwi * (1.0 - fr)
    p = torch.where(reflect, pdf_refl, pdf_trans)
    return torch.where(rough & ok, p, 0.0)


def dielectric_sample(eta, alpha, wo, u2, uc):
    """Returns (wi, f, pdf, specular), f a scalar (N,). uc picks reflection
    or transmission; the smooth case is a delta lobe (specular)."""
    smooth = sc.effectively_smooth(alpha)

    # Smooth: Fresnel-weighted reflection and refraction deltas.
    fr_s = sc.fr_dielectric(_cos(wo), eta)
    refl_s = uc < fr_s
    wi_refl = _mirror(wo)
    n_local = torch.zeros_like(wo)
    n_local[..., 2] = 1.0
    valid_t, wi_trans, eta_eff = refract(wo, n_local, eta)
    f_refl_s = fr_s / torch.clamp(_abscos(wi_refl), min=_EPS)
    f_trans_s = (
        (1.0 - fr_s)
        / torch.clamp(_abscos(wi_trans), min=_EPS)
        / torch.clamp(eta_eff * eta_eff, min=_EPS)
    )
    wi_sm = torch.where(refl_s[..., None], wi_refl, wi_trans)
    f_sm = torch.where(refl_s, f_refl_s, torch.where(valid_t, f_trans_s, 0.0))
    pdf_sm = torch.where(refl_s, fr_s, torch.where(valid_t, 1.0 - fr_s, 0.0))

    # Rough: microfacet reflection or transmission.
    wm = sc.ggx_sample_wm(wo, u2, torch.clamp(alpha, min=1e-3))
    fr_r = sc.fr_dielectric(_dot(wo, wm), eta)
    refl_r = uc < fr_r
    wi_r_refl = -wo + 2.0 * _dot(wo, wm)[..., None] * wm
    valid_rt, wi_r_trans, _ = refract(wo, wm, eta)
    wi_r = torch.where(refl_r[..., None], wi_r_refl, wi_r_trans)
    f_r = dielectric_f(eta, alpha, wo, wi_r)
    pdf_r = dielectric_pdf(eta, alpha, wo, wi_r)
    ok_r = torch.where(refl_r, _same_hemisphere(wo, wi_r_refl), valid_rt)

    wi = torch.where(smooth[..., None], wi_sm, wi_r)
    f = torch.where(smooth, f_sm, torch.where(ok_r, f_r, 0.0))
    p = torch.where(smooth, pdf_sm, torch.where(ok_r, pdf_r, 0.0))
    return wi, f, p, smooth


# --- Thin dielectric (bxdfs.h ThinDielectricBxDF) ---------------------------


def thin_dielectric_sample(eta, wo, uc):
    """Thin slab: the inter-reflection-summed R' and the straight-through
    T'. Returns (wi, f, pdf), f a scalar (N,); always a delta lobe."""
    r = sc.fr_dielectric(torch.abs(_cos(wo)), eta)
    r = torch.where(
        r < 1.0, r + (1.0 - r) ** 2 * r / torch.clamp(1.0 - r * r, min=_EPS), r
    )
    t = 1.0 - r
    refl = uc < r
    wi = torch.where(refl[..., None], _mirror(wo), -wo)
    f = torch.where(refl, r, t) / torch.clamp(_abscos(wi), min=_EPS)
    return wi, f, torch.where(refl, r, t)


# --- Coated materials: the two-lobe approximation ---------------------------
# A GGX dielectric coat lobe plus the base lobe attenuated by the Fresnel
# transmission both ways. The coated families take their pdf and sampled
# direction from it; their f comes from the layered walk.

_COAT_ETA = 1.5


def _coat_eta(like):
    return torch.full_like(like, _COAT_ETA)


def _coat_spec_f(alpha_c, wo, wi):
    """GGX reflection lobe with the dielectric Fresnel term (scalar per
    ray)."""
    same = _same_hemisphere(wo, wi)
    wm = normalize(wo + wi)
    wm_ok = torch.sum((wo + wi) ** 2, dim=-1) > 1e-16
    fr = sc.fr_dielectric(_dot(wo, wm), _coat_eta(_cos(wo)))
    d = sc.ggx_d(wm, alpha_c)
    g = sc.ggx_g(wo, wi, alpha_c)
    f = d * g * fr / torch.clamp(4.0 * _abscos(wo) * _abscos(wi), min=_EPS)
    rough = ~sc.effectively_smooth(alpha_c)
    return torch.where(same & wm_ok & rough, f, 0.0)


def coated_f(base_f, alpha_c, wo, wi):
    """base_f: (N, S) base-lobe BSDF. The coupled two-lobe coated BSDF."""
    spec = _coat_spec_f(alpha_c, wo, wi)
    t_o = 1.0 - sc.fr_dielectric(_abscos(wo), _coat_eta(_cos(wo)))
    t_i = 1.0 - sc.fr_dielectric(_abscos(wi), _coat_eta(_cos(wi)))
    return spec[..., None] + (t_o * t_i)[..., None] * base_f


def coated_pdf(base_pdf, alpha_c, wo, wi):
    fr_o = sc.fr_dielectric(_abscos(wo), _coat_eta(_cos(wo)))
    # The coat lobe's pdf is the conductor's visible-NDF reflection pdf.
    return fr_o * conductor_pdf(alpha_c, wo, wi) + (1.0 - fr_o) * base_pdf


def _coated_wi_pdf(base_sample_fn, base_pdf_fn, alpha_c, wo, u2, uc):
    """The two-lobe sample: the lobe picked by Fresnel(wo). Returns (wi,
    pdf, ok, clamped alpha_c)."""
    fr_o = sc.fr_dielectric(_abscos(wo), _coat_eta(_cos(wo)))
    pick_spec = uc < fr_o
    alpha_cr = torch.clamp(alpha_c, min=1e-3)
    wm = sc.ggx_sample_wm(wo, u2, alpha_cr)
    wi_spec = -wo + 2.0 * _dot(wo, wm)[..., None] * wm
    wi_base, _, _ = base_sample_fn(u2)
    wi = torch.where(pick_spec[..., None], wi_spec, wi_base)
    pdf = coated_pdf(base_pdf_fn(wi), alpha_cr, wo, wi)
    ok = _same_hemisphere(wo, wi)
    return wi, torch.where(ok, pdf, 0.0), ok, alpha_cr


def coated_sample(base_sample_fn, base_f_fn, base_pdf_fn, alpha_c, wo, u2,
                  uc):
    """The two-lobe approximation's sample: (wi, f, pdf). `sample` keeps
    its wi and pdf and takes f from the layered walk instead."""
    wi, pdf, ok, alpha_cr = _coated_wi_pdf(base_sample_fn, base_pdf_fn,
                                           alpha_c, wo, u2, uc)
    f = coated_f(base_f_fn(wi), alpha_cr, wo, wi)
    return wi, torch.where(ok[..., None], f, 0.0), pdf


def _gather_spectral_eta_k(params, lam):
    eta = rgb2spec.eval_unbounded(
        params["cond_eta_coeffs"], params["cond_eta_scale"], lam
    )
    k = rgb2spec.eval_unbounded(
        params["cond_k_coeffs"], params["cond_k_scale"], lam
    )
    return eta, k


# --- Retroreflective (the ISET fork's RetroreflectiveBxDF) ------------------


def normalize_half(wo, wi):
    h = wo + wi
    return h / torch.clamp(torch.sqrt(torch.sum(h * h, dim=-1, keepdim=True)),
                           min=1e-9)


def retro_f(eta, k, alpha, wo, wi):
    """RetroreflectiveBxDF::f (the ISET fork, bxdfs.h:104-180): a GGX
    conductor lobe plus a retro lobe whose microfacet normal is wo itself,
    peaked about wi = wo, both weighted by the fork's (1 - (R_i - R_o))
    dielectric-coating factor."""
    same = _same_hemisphere(wo, wi)
    alpha_r = torch.clamp(alpha, min=1e-3)
    standard = conductor_f(eta, k, alpha_r, wo, wi)
    cos_o = torch.clamp(_abscos(wo), min=1e-6)
    cos_i = torch.clamp(_abscos(wi), min=1e-6)
    wm_retro = wo * torch.sign(wo[..., 2:3])
    d_retro = sc.ggx_d(wm_retro, alpha_r)
    g = sc.ggx_g(wo, wi, alpha_r)
    f_retro_fres = sc.fr_complex(torch.abs(_dot(wo, wi))[..., None], eta, k)
    retro = f_retro_fres * (d_retro * g / (4.0 * cos_o * cos_i))[..., None]
    r_i = sc.fr_dielectric(torch.abs(_dot(wi, wm_retro)),
                           torch.full_like(cos_i, 1.59))
    wm = normalize_half(wo, wi)
    r_o = sc.fr_dielectric(torch.abs(_dot(wo, wm)),
                           torch.full_like(cos_o, 1.59))
    w = torch.clamp(1.0 - (r_i - r_o), 0.0, 2.0)[..., None]
    return torch.where(same[..., None], w * (retro + standard), 0.0)


# --- Measured and hair: the per-ray inputs of their modules -----------------


def _measured_f(params, wo, wi, lam):
    """The tabulated BRDF of each ray's table (materials/measured.py)."""
    coeffs = params["measured_coeffs"]
    idx = params["measured_idx"].long()
    if coeffs.shape[0] == 0:  # no table: no row can name one
        return torch.zeros(wo.shape[:-1] + lam.shape[-1:], dtype=wo.dtype,
                           device=wo.device)
    base = torch.clamp(idx, min=0) * (measured.N_TH * measured.N_TD
                                      * measured.N_PD)
    val = measured.lookup(coeffs.reshape(-1, 3),
                          params["measured_scale"].reshape(-1), base, wo, wi,
                          lam)
    return torch.where((idx >= 0)[..., None], val, 0.0)


def _hair_args(params):
    bm = torch.clamp(params["roughness"], 1e-2, 1.0)
    bn = torch.clamp(params["coat_roughness"], 1e-2, 1.0)
    h = params.get("hair_h", torch.zeros_like(bm))
    return h, params["eta"], bm, bn, params["hair_alpha"]


def _hair_sigma_a(params, lam):
    return rgb2spec.eval_unbounded(
        params["hair_sigma_coeffs"], params["hair_sigma_scale"], lam)


# --- Dispatch ---------------------------------------------------------------


def _bits(x):
    """The uint32 bit patterns of float32 values, in int64."""
    return x.detach().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def resolve_mix(materials, mat_idx, p, wo):
    """MixMaterial (materials.h): each lane of a mix row takes one of its
    two sub-materials, the first with probability `amount`, by a pcg4d
    hash of the bit patterns of the hit point and of wo: the same choice
    for the same (point, direction), another across samples through wo
    (pbrt-v4 draws from the sampler; the reference's departure)."""
    kind0 = take(materials.kind, torch.clamp(mat_idx, 0,
                                              materials.kind.shape[0] - 1))
    bits_p = _bits(p)
    bits_w = _bits(wo)
    h, _, _, _ = rng.pcg4d(bits_p[..., 0] ^ bits_p[..., 2], bits_w[..., 0],
                           bits_w[..., 1] ^ bits_p[..., 1], _MIX_SALT)
    u = rng.u32_to_uniform(h)
    row = torch.clamp(mat_idx, min=0)
    pick = torch.where(u < take(materials.mix_amount, row),
                       take(materials.mix_m0, row), take(materials.mix_m1, row))
    return torch.where(kind0 == MAT_MIX, pick, mat_idx)


def surface_params(scene, isect, lam=None):
    """Per-ray material parameters at a surface interaction: the material
    row (a mix row resolved to a sub-material first), with textured albedo
    overlaid (textures/buffers.py), a hair lane's offset h across the
    curve from uv[1], and, on a dielectric, the IOR seen from the ray's
    side; and the `any_*` flags (FAMILY_FLAGS) of the kinds the geometry
    references."""
    kinds = scene.shaded_kinds
    mat_idx = isect.mat
    if MAT_MIX in kinds:
        mat_idx = resolve_mix(scene.materials, mat_idx, isect.p, isect.wo)
    params = scene.materials.gather(mat_idx)
    for flag in FLAGS:
        params[flag] = False
    for kind, flag in FAMILY_FLAGS.items():
        params[flag] = params[flag] or kind in kinds
    # The material-less interface's passthrough link (no BxDF family of
    # the sorted dispatch: it only ends sample's select chain).
    params["any_interface_mat"] = MAT_INTERFACE in kinds
    if lam is not None:
        params["lam"] = lam
    if scene.textures is not None:
        from ..textures.buffers import evaluate_albedo_coeffs

        face = None
        n_tri = scene.geom.num_triangles
        if scene.textures.has_ptex and n_tri > 0:
            # Ptex faceIndex: the triangle's index within its source shape
            # (textures.cpp PtexTexture::Evaluate); analytic hits take 0.
            ti = torch.clamp(isect.prim, 0, n_tri - 1)
            face = torch.where(isect.prim < n_tri,
                               take(scene.geom.tri_face, ti), 0)
        params["albedo_coeffs"] = evaluate_albedo_coeffs(
            scene.textures, params["albedo_tex"], isect.uv, isect.p,
            params["albedo_coeffs"], face=face,
        )
    if params["any_hair"]:
        # pbrt-v4's hair.h: h = -1 + 2 uv[1].
        params["hair_h"] = torch.clamp(2.0 * isect.uv[..., 1] - 1.0,
                                       -0.9995, 0.9995)
    # The integrator shades in a frame flipped toward wo, which erases the
    # inside/outside distinction the dielectric needs to pick eta or 1/eta.
    # isect.n is canonical (outward for quadrics, by winding for meshes),
    # so the side is recovered here: an exiting ray sees the inverted IOR,
    # which in the flipped frame gives the true refraction geometry,
    # Fresnel term, total internal reflection and 1/eta^2 scaling.
    if params["any_dielectric"]:
        entering = torch.sum(isect.n * isect.wo, dim=-1) >= 0.0
        params["eta"] = torch.where(
            (params["kind"] == MAT_DIELECTRIC) & ~entering,
            1.0 / torch.clamp(params["eta"], min=1e-6),
            params["eta"],
        )
    return params


def _alpha(params):
    """The base roughness's alpha, where a referenced family reads it."""
    if (params["any_conductor"] or params["any_dielectric"]
            or params["any_coated_conductor"] or params.get("any_retro")):
        return sc.roughness_to_alpha(params["roughness"])
    return None


def _coat_alpha(params):
    return torch.clamp(sc.roughness_to_alpha(params["coat_roughness"]),
                       min=1e-3)


def _coated_diffuse_walk(params, albedo, wo, wi):
    return layered.layered_walk(
        wo, wi,
        lambda a, b: diffuse_f(albedo, a, b),
        lambda a, u2_, uc_: diffuse_sample(albedo, a, u2_),
        _coat_alpha(params), thickness=params["thickness"],
    )


def _coated_conductor_walk(params, eta_c, k_c, alpha_b, wo, wi):
    return layered.layered_walk(
        wo, wi,
        lambda a, b: conductor_f(eta_c, k_c, alpha_b, a, b),
        lambda a, u2_, uc_: conductor_sample(eta_c, k_c, alpha_b, a, u2_)[:3],
        _coat_alpha(params), thickness=params["thickness"], salt=1,
    )


def evaluate(params, wo, wi, lam):
    """f(wo, wi) for each ray given gathered material params; (N, S).
    Delta lobes (smooth conductors and dielectrics, thin dielectrics)
    return 0 here: their contribution arrives only through sampling."""
    kind = _exit_kind(params)
    albedo = rgb2spec.eval_sigmoid(params["albedo_coeffs"], lam)
    alpha = _alpha(params)
    f = torch.where(
        (kind == MAT_DIFFUSE)[..., None], diffuse_f(albedo, wo, wi), 0.0
    )
    if params.get("any_subsurface"):
        f = torch.where((kind == MAT_NORMFRESNEL)[..., None],
                        normfresnel_f(params["eta"], wo, wi, lam.shape[-1]), f)
    if params["any_conductor"]:
        eta_c, k_c = _gather_spectral_eta_k(params, lam)
        f = torch.where(
            (kind == MAT_CONDUCTOR)[..., None],
            conductor_f(eta_c, k_c, alpha, wo, wi), f,
        )
    if params["any_dielectric"]:
        f_d = dielectric_f(params["eta"], alpha, wo, wi)
        f = torch.where((kind == MAT_DIELECTRIC)[..., None], f_d[..., None], f)
    if params["any_diffusetrans"]:
        trans = rgb2spec.eval_sigmoid(params["trans_coeffs"], lam)
        f = torch.where((kind == MAT_DIFFUSETRANS)[..., None],
                        diffusetrans_f(albedo, trans, wo, wi), f)
    if params["any_coated_diffuse"]:
        f = torch.where((kind == MAT_COATEDDIFFUSE)[..., None],
                        _coated_diffuse_walk(params, albedo, wo, wi), f)
    if params["any_coated_conductor"]:
        eta_c, k_c = _gather_spectral_eta_k(params, lam)
        f_cc = _coated_conductor_walk(params, eta_c, k_c,
                                      torch.clamp(alpha, min=1e-3), wo, wi)
        f = torch.where((kind == MAT_COATEDCONDUCTOR)[..., None], f_cc, f)
    if params.get("any_hair"):
        h, eta_h, bm, bn, tilt = _hair_args(params)
        f_h = hair.hair_f(h, eta_h, _hair_sigma_a(params, lam), bm, bn, tilt,
                          wo, wi)
        f = torch.where((kind == MAT_HAIR)[..., None], f_h, f)
    if params.get("any_measured"):
        f = torch.where((kind == MAT_MEASURED)[..., None],
                        _measured_f(params, wo, wi, lam), f)
    if params.get("any_retro"):
        eta_c, k_c = _gather_spectral_eta_k(params, lam)
        f = torch.where((kind == MAT_RETRO)[..., None],
                        retro_f(eta_c, k_c, alpha, wo, wi), f)
    return f


def _exit_kind(params):
    """The kind each lane shades with: a subsurface lane exits through the
    normalized-Fresnel lobe."""
    kind = params["kind"]
    if params.get("any_subsurface"):
        kind = torch.where(kind == MAT_SUBSURFACE, MAT_NORMFRESNEL, kind)
    return kind


def pdf(params, wo, wi):
    kind = _exit_kind(params)
    if params.get("any_subsurface"):
        # The normalized-Fresnel lobe samples as the diffuse one does.
        kind = torch.where(kind == MAT_NORMFRESNEL, MAT_DIFFUSE, kind)
    alpha = _alpha(params)
    p = torch.where(kind == MAT_DIFFUSE, diffuse_pdf(wo, wi), 0.0)
    if params["any_conductor"]:
        p = torch.where(kind == MAT_CONDUCTOR, conductor_pdf(alpha, wo, wi), p)
    if params["any_dielectric"]:
        p = torch.where(kind == MAT_DIELECTRIC,
                        dielectric_pdf(params["eta"], alpha, wo, wi), p)
    if params["any_diffusetrans"]:
        p = torch.where(kind == MAT_DIFFUSETRANS, diffusetrans_pdf(wo, wi), p)
    if params["any_coated_diffuse"]:
        p_cd = coated_pdf(diffuse_pdf(wo, wi), _coat_alpha(params), wo, wi)
        p = torch.where(kind == MAT_COATEDDIFFUSE, p_cd, p)
    if params["any_coated_conductor"]:
        p_cc = coated_pdf(
            conductor_pdf(torch.clamp(alpha, min=1e-3), wo, wi),
            _coat_alpha(params), wo, wi)
        p = torch.where(kind == MAT_COATEDCONDUCTOR, p_cc, p)
    if params.get("any_hair"):
        h, eta_h, bm, bn, tilt = _hair_args(params)
        p_h = hair.hair_pdf(h, eta_h, _hair_sigma_a(params, params["lam"]),
                            bm, bn, tilt, wo, wi)
        p = torch.where(kind == MAT_HAIR, p_h, p)
    if params.get("any_measured"):
        p = torch.where(kind == MAT_MEASURED, diffuse_pdf(wo, wi), p)
    if params.get("any_retro"):
        p = torch.where(kind == MAT_RETRO,
                        conductor_pdf(torch.clamp(alpha, min=1e-3), wo, wi), p)
    return p


def sample(params, wo, lam, u2, uc):
    """Sample wi for each ray. Returns dict(wi, f, pdf, specular)."""
    kind = _exit_kind(params)
    albedo = rgb2spec.eval_sigmoid(params["albedo_coeffs"], lam)
    alpha = _alpha(params)
    wi, f, p = diffuse_sample(albedo, wo, u2)
    specular = torch.zeros(wo.shape[:-1], dtype=torch.bool, device=wo.device)
    if params.get("any_subsurface"):
        # The diffuse sample's direction and pdf, the lobe's f.
        f = torch.where((kind == MAT_NORMFRESNEL)[..., None],
                        normfresnel_f(params["eta"], wo, wi, lam.shape[-1]), f)

    def put(m, wi_x, f_x, p_x, spec_x):
        nonlocal wi, f, p, specular
        wi = torch.where(m[..., None], wi_x, wi)
        f = torch.where(m[..., None], f_x, f)
        p = torch.where(m, p_x, p)
        specular = torch.where(m, spec_x, specular)

    if params["any_conductor"]:
        eta_c, k_c = _gather_spectral_eta_k(params, lam)
        wi_c, f_c, p_c, spec_c = conductor_sample(eta_c, k_c, alpha, wo, u2)
        put(kind == MAT_CONDUCTOR, wi_c, f_c, p_c, spec_c)
    if params["any_dielectric"]:
        wi_d, f_d, p_d, spec_d = dielectric_sample(
            params["eta"], alpha, wo, u2, uc)
        put(kind == MAT_DIELECTRIC, wi_d, f_d[..., None], p_d, spec_d)
    if params["any_diffusetrans"]:
        trans = rgb2spec.eval_sigmoid(params["trans_coeffs"], lam)
        wi_dt, f_dt, p_dt = diffusetrans_sample(albedo, trans, wo, u2, uc)
        put(kind == MAT_DIFFUSETRANS, wi_dt, f_dt, p_dt, False)
    # The coated families: wi and pdf from the two-lobe approximation, f
    # from the layered walk at that wi.
    if params["any_coated_diffuse"]:
        wi_cd, p_cd, ok, _ = _coated_wi_pdf(
            lambda u: diffuse_sample(albedo, wo, u),
            lambda wi_: diffuse_pdf(wo, wi_),
            _coat_alpha(params), wo, u2, uc)
        f_cd = torch.where((ok & (p_cd > 0.0))[..., None],
                           _coated_diffuse_walk(params, albedo, wo, wi_cd), 0.0)
        put(kind == MAT_COATEDDIFFUSE, wi_cd, f_cd, p_cd, False)
    if params["any_coated_conductor"]:
        eta_c, k_c = _gather_spectral_eta_k(params, lam)
        alpha_b = torch.clamp(alpha, min=1e-3)
        wi_cc, p_cc, ok, _ = _coated_wi_pdf(
            lambda u: conductor_sample(eta_c, k_c, alpha_b, wo, u)[:3],
            lambda wi_: conductor_pdf(alpha_b, wo, wi_),
            _coat_alpha(params), wo, u2, uc)
        f_cc = torch.where(
            (ok & (p_cc > 0.0))[..., None],
            _coated_conductor_walk(params, eta_c, k_c, alpha_b, wo, wi_cc),
            0.0)
        put(kind == MAT_COATEDCONDUCTOR, wi_cc, f_cc, p_cc, False)
    if params.get("any_measured"):
        wi_m, p_m = _cosine_sample(wo, u2)
        put(kind == MAT_MEASURED, wi_m, _measured_f(params, wo, wi_m, lam),
            p_m, False)
    if params.get("any_retro"):
        eta_c, k_c = _gather_spectral_eta_k(params, lam)
        alpha_r = torch.clamp(alpha, min=1e-3)
        wi_r, _, p_r, _ = conductor_sample(eta_c, k_c, alpha_r, wo, u2)
        put(kind == MAT_RETRO, wi_r, retro_f(eta_c, k_c, alpha_r, wo, wi_r),
            p_r, False)
    if params.get("any_hair"):
        h, eta_h, bm, bn, tilt = _hair_args(params)
        wi_h, f_h, p_h = hair.hair_sample(
            h, eta_h, _hair_sigma_a(params, lam), bm, bn, tilt, wo, u2, uc)
        put(kind == MAT_HAIR, wi_h, f_h, p_h, False)
    if params["any_thin"]:
        wi_t, f_t, p_t = thin_dielectric_sample(params["eta"], wo, uc)
        m = kind == MAT_THINDIELECTRIC
        wi = torch.where(m[..., None], wi_t, wi)
        f = torch.where(m[..., None], f_t[..., None], f)
        p = torch.where(m, p_t, p)
        specular = specular | m
    if params.get("any_interface_mat"):
        # A material-less boundary (Material "" / "none" / "interface"):
        # the ray goes straight through, a delta "transmission" with
        # f |cos| / pdf = 1, so media can switch at it.
        m = kind == MAT_INTERFACE
        f_i = 1.0 / torch.clamp(torch.abs(wo[..., 2:3]), min=1e-4)
        wi = torch.where(m[..., None], -wo, wi)
        f = torch.where(m[..., None], f_i, f)
        p = torch.where(m, 1.0, p)
        specular = specular | m
    return {"wi": wi, "f": f, "pdf": p, "specular": specular}
