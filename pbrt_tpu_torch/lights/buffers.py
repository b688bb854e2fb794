"""Area lights + NEE sampling (port of pbrt_tpu/lights/buffers.py).

Only area lights (one emissive triangle each) with uniform or
power-proportional selection are ported. Sphere, point, spot, projection,
goniometric, distant, infinite and environment lights, and the light BVH,
raise NotImplementedError at build (ROADMAP Queue 1 item 11). With no
infinite light, escaped rays carry no radiance and no pdf.

Emission RGBs are sigmoid-polynomial coefficients + scale; each light flags
whether its spectrum is D65-shaped (pbrt's RGBIlluminantSpectrum) or flat.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import cie, rgb2spec
from ..core.sampling import sample_uniform_triangle
from ..core.tensorclass import static_field, tensorclass
from ..core.vecmath import cross, dot, normalize

_EPS = 1e-9

# Light-list prefixes of the reference that are not ported yet.
UNPORTED_LIGHTS = ("sphere_lights", "points", "spots", "projections",
                   "gonios", "distants", "infinite", "envmap")


@tensorclass
class LightLiSample:
    """Result of SampleLi for a batch of reference points (light.h:62)."""

    L: torch.Tensor  # (N, S) incident radiance
    wi: torch.Tensor  # (N, 3)
    pdf: torch.Tensor  # (N,) solid-angle pdf incl. selection pmf
    dist: torch.Tensor  # (N,) distance to the light point
    is_delta: torch.Tensor  # (N,) bool


def eval_emission(coeffs, scale, illum, lam):
    """Emission spectrum: sigmoid poly x scale, D65-shaped where `illum`."""
    base = rgb2spec.eval_unbounded(coeffs, scale, lam)
    d65 = cie.illuminant_d65(lam) * (1.0 / 100.0)
    return torch.where(illum[..., None], base * d65, base)


@tensorclass
class LightBuffers:
    area_verts: torch.Tensor  # (La, 3, 3)
    area_coeffs: torch.Tensor  # (La, 3)
    area_scale: torch.Tensor  # (La,)
    area_illum: torch.Tensor  # (La,) bool: D65-shaped vs flat spectrum
    area_two_sided: torch.Tensor  # (La,) bool
    area_area: torch.Tensor  # (La,) triangle area
    select_cdf: torch.Tensor  # (n_lights,) inclusive cdf
    select_pmf: torch.Tensor  # (n_lights,)
    sampler: str = static_field(default="uniform")

    def __post_init__(self):
        if self.sampler not in ("uniform", "power"):
            raise NotImplementedError(
                f"light sampler {self.sampler!r} is not ported yet (ROADMAP "
                "Queue 1 item 11); only 'uniform' and 'power' are"
            )

    @property
    def n_area(self) -> int:
        return self.area_verts.shape[0]

    @property
    def n_lights(self) -> int:
        return self.n_area

    @staticmethod
    def build(area_tris=None, sampler: str = "uniform",
              **other_lights) -> "LightBuffers":
        """area_tris: dicts with verts (3, 3), rgb, scale, two_sided,
        illuminant. sampler: "uniform" | "power" selection."""
        for name, value in other_lights.items():
            if name not in UNPORTED_LIGHTS:
                raise TypeError(f"unknown light argument {name!r}")
            if value:
                raise NotImplementedError(
                    f"{name} are not ported yet (ROADMAP Queue 1 item 11); "
                    "only area lights are"
                )
        area_tris = area_tris or []
        av = np.asarray([a["verts"] for a in area_tris], np.float32).reshape(
            -1, 3, 3
        )
        if len(area_tris):
            ac, asc = rgb2spec.fit_unbounded(
                [np.asarray(a["rgb"]) * a.get("scale", 1.0) for a in area_tris]
            )
            e1 = av[:, 1] - av[:, 0]
            e2 = av[:, 2] - av[:, 0]
            areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        else:
            ac, asc = torch.zeros((0, 3)), torch.zeros((0,))
            areas = np.zeros((0,), np.float32)

        # Selection distribution (PowerLightSampler, lightsamplers.h:29 —
        # luminance-proportional; uniform otherwise).
        powers = []
        for i, a in enumerate(area_tris):
            lum = float(np.mean(a["rgb"])) * a.get("scale", 1.0)
            two = 2.0 if a.get("two_sided", False) else 1.0
            powers.append(lum * float(areas[i]) * np.pi * two)
        powers = np.asarray(powers, np.float64)
        nl = len(powers)
        if nl == 0:
            pmf = np.zeros((0,))
        elif sampler == "power" and powers.sum() > 0:
            pmf = powers / powers.sum()
        else:
            pmf = np.full(nl, 1.0 / nl)
        cdf = np.cumsum(pmf)

        def flags(key, default):
            return torch.as_tensor(
                np.asarray([bool(a.get(key, default)) for a in area_tris],
                           bool).reshape(-1)
            )

        return LightBuffers(
            area_verts=torch.as_tensor(av),
            area_coeffs=ac,
            area_scale=asc,
            area_illum=flags("illuminant", True),
            area_two_sided=flags("two_sided", False),
            area_area=torch.as_tensor(np.asarray(areas, np.float32)),
            select_cdf=torch.as_tensor(np.asarray(cdf, np.float32)),
            select_pmf=torch.as_tensor(np.asarray(pmf, np.float32)),
            sampler=sampler,
        )

    # -- selection ----------------------------------------------------------

    def select(self, p_ref, n_ref, u_select):
        """Pick a light per shading point from the tabulated cdf:
        (idx (N,) int64, pmf (N,))."""
        idx = torch.clamp(
            torch.sum(self.select_cdf[None, :] <= u_select[..., None], dim=-1),
            max=self.n_lights - 1,
        )
        return idx, self.select_pmf[idx]

    # -- emission queries ---------------------------------------------------

    def emitted(self, light_idx, n_geo, wo, lam):
        """L_e toward wo for rays that hit area light light_idx (>= 0)
        (DiffuseAreaLight::L)."""
        na = self.n_area
        if na == 0:
            return torch.zeros_like(lam)
        front = dot(n_geo, wo) > 0.0
        i = torch.clamp(light_idx, 0, na - 1)
        vis = front | self.area_two_sided[i]
        L_a = eval_emission(
            self.area_coeffs[i], self.area_scale[i], self.area_illum[i], lam
        )
        use = (light_idx >= 0) & (light_idx < na) & vis
        return torch.where(use[..., None], L_a, 0.0)

    def escaped_radiance(self, d, lam, p_ref=None):
        """Radiance for escaping rays: zero, with no infinite light."""
        return torch.zeros_like(lam)

    def pdf_escaped(self, d, p_ref=None):
        """NEE pdf of an escaped direction: zero, with no infinite light."""
        return torch.zeros(d.shape[:-1], dtype=d.dtype, device=d.device)

    # -- NEE sampling -------------------------------------------------------

    def sample_li(self, p_ref, lam, u_select, u_pos, n_ref=None) -> LightLiSample:
        """Select a light and sample a point on it. pdf is with respect to
        solid angle at p_ref and INCLUDES the selection pmf."""
        if self.n_lights == 0:
            raise ValueError("sample_li with no lights")
        idx, sel_pmf = self.select(p_ref, n_ref, u_select)
        ai = torch.clamp(idx, 0, self.n_area - 1)
        verts = self.area_verts[ai]  # (N, 3, 3)
        b = sample_uniform_triangle(u_pos)  # (N, 3)
        p_l = (b[:, 0:1] * verts[:, 0] + b[:, 1:2] * verts[:, 1]
               + b[:, 2:3] * verts[:, 2])
        e1 = verts[:, 1] - verts[:, 0]
        e2 = verts[:, 2] - verts[:, 0]
        n_l = normalize(cross(e1, e2))
        to_l = p_l - p_ref
        d2 = torch.clamp(torch.sum(to_l * to_l, dim=-1), min=_EPS)
        d = torch.sqrt(d2)
        wi = to_l / d[..., None]
        cos_l = dot(n_l, -wi)
        two = self.area_two_sided[ai]
        emit_ok = (cos_l > _EPS) | (two & (torch.abs(cos_l) > _EPS))
        area = torch.clamp(self.area_area[ai], min=_EPS)
        pdf = d2 / (torch.abs(cos_l) * area + _EPS)
        L = eval_emission(
            self.area_coeffs[ai], self.area_scale[ai], self.area_illum[ai], lam
        )
        L = torch.where(emit_ok[..., None], L, 0.0)
        return LightLiSample(
            L=L, wi=wi, pdf=pdf * sel_pmf, dist=d,
            is_delta=torch.zeros_like(emit_ok),
        )

    def pdf_li_area(self, light_idx, dist, cos_l, p_ref=None, n_ref=None):
        """Solid-angle pdf that NEE would have produced the direction that hit
        area light `light_idx`, including the selection pmf (for MIS on
        BSDF-sampled rays; DiffuseAreaLight::PDF_Li)."""
        na = self.n_area
        if na == 0:
            return torch.zeros_like(dist)
        i = torch.clamp(light_idx, 0, na - 1)
        pmf = self.select_pmf[i]
        area = torch.clamp(self.area_area[i], min=_EPS)
        pdf = dist * dist / (torch.abs(cos_l) * area + _EPS)
        return torch.where(light_idx >= 0, pdf * pmf, 0.0)
