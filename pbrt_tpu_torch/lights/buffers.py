"""Flat light tables + NEE sampling (port of pbrt_tpu/lights/buffers.py).

The light list is, in this order, as in the reference:
  [area triangles] ++ [emissive analytic spheres] ++ [point] ++ [spot]
  ++ [projection] ++ [goniometric] ++ [distant] ++ [infinite or image]
so a light's id, `tri_light` / `sph_light` and the selection pmf agree with
the reference's id for id. The infinite slot holds the uniform infinite
light, or an image-based one (lights/envmap.py, EnvironmentMap) or a
portal light (lights/portal.py) that replaces it. Selection is uniform,
power-proportional, by the light BVH's stochastic descent
(lights/bvh.py) or by the exhaustive sampler's importance over every
light (its oracle); the last two hold the positional lights, and the
distant and infinite lights are picked outside them with a count
proportional share. SampleLe's origin sampling for the light-tracing
integrators raises NotImplementedError (ROADMAP Queue 1 item 13). With no
infinite light, escaped rays carry no radiance and no pdf.

Emission RGBs are sigmoid-polynomial coefficients + scale, fitted on the
host; each light flags whether its spectrum is D65-shaped (pbrt's
RGBIlluminantSpectrum) or flat. Delta lights (point, spot, projection,
goniometric, distant) fold 1/d^2 into L and report pdf = the selection
pmf with `is_delta` set.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core import cie, rgb2spec
from ..core.floats import grad_flows
from ..core.sampling import (
    UNIFORM_SPHERE_PDF,
    sample_uniform_sphere,
    sample_uniform_triangle,
)
from ..core.take import take
from ..core.tensorclass import static_field, tensorclass
from ..core.vecmath import (
    coordinate_system,
    cross,
    dot,
    equal_area_sphere_to_square,
    normalize,
)
from . import bvh as light_bvh
from .portal import PortalLight

_EPS = 1e-9


@tensorclass
class LightLiSample:
    """Result of SampleLi for a batch of reference points (light.h:62)."""

    L: torch.Tensor  # (N, S) incident radiance (1/d^2 folded in for delta lights)
    wi: torch.Tensor  # (N, 3)
    pdf: torch.Tensor  # (N,) solid-angle pdf incl. selection pmf (delta: pmf)
    dist: torch.Tensor  # (N,) distance to the light point (inf: distant, env)
    is_delta: torch.Tensor  # (N,) bool


def eval_emission(coeffs, scale, illum, lam):
    """Emission spectrum: sigmoid poly x scale, D65-shaped where `illum`."""
    base = rgb2spec.eval_unbounded(coeffs, scale, lam)
    d65 = cie.illuminant_d65(lam) * (1.0 / 100.0)
    return torch.where(illum[..., None], base * d65, base)


def _image_emission(coeffs, scale_tx, illum, light_idx, u, v, lam):
    """Nearest-texel emission of light `light_idx` from a (L, R, R)
    intensity-image stack (ProjectionLight::I / GoniometricLight::I)."""
    r = coeffs.shape[1]
    xi = torch.clamp((torch.clamp(u, 0.0, 1.0) * r).to(torch.int32), 0, r - 1)
    yi = torch.clamp((torch.clamp(v, 0.0, 1.0) * r).to(torch.int32), 0, r - 1)
    fi = ((light_idx * r + yi) * r + xi).long()
    return eval_emission(take(coeffs.reshape(-1, 3), fi),
                         take(scale_tx.reshape(-1), fi), illum[light_idx], lam)


def _frame(spec):
    """World -> light rotation rows (x, y, z) of a projection or
    goniometric light, z toward spec["to"]."""
    z = np.asarray(spec.get("to", (0, 0, 1)), np.float64) - np.asarray(
        spec["p"], np.float64)
    nz = np.linalg.norm(z)
    z = z / nz if nz > 0 else np.array([0.0, 0.0, 1.0])
    up = np.asarray(spec.get("up", (0, 1, 0)), np.float64)
    x = np.cross(up, z)
    if np.linalg.norm(x) < 1e-8:
        x = np.cross(np.array([1.0, 0.0, 0.0]), z)
    x = x / np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


def _img_grid(specs, res: int = 64):
    """Each light's RGB image (or constant RGB) resampled onto a shared
    res x res grid and fitted per texel: (coeffs, scale, mean per light)."""
    if not specs:
        return (torch.zeros((0, res, res, 3)), torch.zeros((0, res, res)), [])
    grids, means = [], []
    for s in specs:
        if s.get("rgb_image") is not None:
            im = np.asarray(s["rgb_image"], np.float32)
            yy = np.clip(np.arange(res) * im.shape[0] // res, 0, im.shape[0] - 1)
            xx = np.clip(np.arange(res) * im.shape[1] // res, 0, im.shape[1] - 1)
            g = im[yy][:, xx]
        else:
            g = np.broadcast_to(np.asarray(s.get("rgb", (1.0, 1.0, 1.0)),
                                           np.float32), (res, res, 3))
        g = g * float(s.get("scale", 1.0))
        grids.append(g)
        means.append(float(g.mean()))
    c, sc = rgb2spec.fit_unbounded(np.stack(grids))
    return c, sc, means


def _rows(specs, key, width):
    return np.asarray([s[key] for s in specs], np.float32).reshape(-1, width)


def _fit(specs):
    """Unbounded fits of each spec's rgb x scale: ((L, 3), (L,))."""
    if not specs:
        return torch.zeros((0, 3)), torch.zeros((0,))
    return rgb2spec.fit_unbounded(
        [np.asarray(s["rgb"]) * s.get("scale", 1.0) for s in specs])


def _flags(specs, key, default):
    return torch.as_tensor(
        np.asarray([bool(s.get(key, default)) for s in specs], bool).reshape(-1))


def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _in_block(idx, lo: int, count: int):
    """Where light ids idx fall in [lo, lo + count), in the fewest ops."""
    if count == 1:
        return idx == lo
    if lo == 0:
        return idx < count
    return (idx >= lo) & (idx < lo + count)


SAMPLERS = ("uniform", "power", "bvh", "exhaustive")


@tensorclass
class LightBuffers:
    # Area lights: one emissive triangle each.
    area_verts: torch.Tensor  # (La, 3, 3)
    area_coeffs: torch.Tensor  # (La, 3)
    area_scale: torch.Tensor  # (La,)
    area_illum: torch.Tensor  # (La,) bool: D65-shaped vs flat spectrum
    area_two_sided: torch.Tensor  # (La,) bool
    area_area: torch.Tensor  # (La,) triangle area
    # Emissive analytic spheres (DiffuseAreaLight over a Sphere): one-sided
    # along the outward normal unless two-sided; cone-sampled from outside.
    sphl_c: torch.Tensor  # (Lq, 3) centre
    sphl_r: torch.Tensor  # (Lq,) radius
    sphl_coeffs: torch.Tensor  # (Lq, 3)
    sphl_scale: torch.Tensor  # (Lq,)
    sphl_illum: torch.Tensor  # (Lq,) bool
    sphl_two: torch.Tensor  # (Lq,) bool
    # Point lights.
    point_p: torch.Tensor  # (Lp, 3)
    point_coeffs: torch.Tensor  # (Lp, 3)
    point_scale: torch.Tensor  # (Lp,)
    point_illum: torch.Tensor  # (Lp,) bool
    # Spot lights (SpotLight: a delta light with a smoothstep cone falloff).
    spot_p: torch.Tensor  # (Ls, 3)
    spot_dir: torch.Tensor  # (Ls, 3) unit cone axis
    spot_cos_start: torch.Tensor  # (Ls,) cos(falloffStart)
    spot_cos_end: torch.Tensor  # (Ls,) cos(totalWidth)
    spot_coeffs: torch.Tensor  # (Ls, 3)
    spot_scale: torch.Tensor  # (Ls,)
    spot_illum: torch.Tensor  # (Ls,) bool
    # Projection lights (ProjectionLight, lights.h:482): an image projected
    # from a point through a perspective window.
    proj_p: torch.Tensor  # (Lj, 3)
    proj_rot: torch.Tensor  # (Lj, 3, 3) world -> light rotation (rows x, y, z)
    proj_tan: torch.Tensor  # (Lj,) tan(fov / 2)
    proj_coeffs: torch.Tensor  # (Lj, R, R, 3) per-texel unbounded fits
    proj_scale_tx: torch.Tensor  # (Lj, R, R)
    proj_illum: torch.Tensor  # (Lj,) bool
    # Goniometric lights (GoniometricLight, lights.h:584): a point with an
    # equal-area octahedral intensity image over direction.
    gonio_p: torch.Tensor  # (Lg, 3)
    gonio_rot: torch.Tensor  # (Lg, 3, 3)
    gonio_coeffs: torch.Tensor  # (Lg, R, R, 3)
    gonio_scale_tx: torch.Tensor  # (Lg, R, R)
    gonio_illum: torch.Tensor  # (Lg,) bool
    # Distant lights.
    distant_dir: torch.Tensor  # (Ld, 3) direction the light travels
    distant_coeffs: torch.Tensor  # (Ld, 3)
    distant_scale: torch.Tensor  # (Ld,)
    distant_illum: torch.Tensor  # (Ld,) bool
    # Uniform infinite light (0 or 1; zeros when absent).
    infinite_coeffs: torch.Tensor  # (3,)
    infinite_scale: torch.Tensor  # ()
    infinite_illum: torch.Tensor  # () bool
    select_cdf: torch.Tensor  # (n_lights,) inclusive cdf
    select_pmf: torch.Tensor  # (n_lights,)
    # Image-based infinite light replacing the uniform one: an
    # EnvironmentMap or a PortalLight.
    env: object = None
    # The light BVH (lights/bvh.py), set when sampler == "bvh" and the
    # scene has positional lights.
    bvh: Optional[light_bvh.LightBVH] = None
    # The exhaustive sampler's per-light records (L, 16) (lights/bvh.py
    # pack_light_records), set when sampler == "exhaustive".
    exh_recs: Optional[torch.Tensor] = None
    has_infinite: bool = static_field(default=False)
    sampler: str = static_field(default="uniform")

    def __post_init__(self):
        if self.sampler not in SAMPLERS:
            raise ValueError(f"unknown light sampler {self.sampler!r}; "
                             f"one of {SAMPLERS}")

    # -- counts --------------------------------------------------------------

    @property
    def n_area(self) -> int:
        return self.area_verts.shape[0]

    @property
    def n_sphl(self) -> int:
        return self.sphl_c.shape[0]

    @property
    def n_point(self) -> int:
        return self.point_p.shape[0]

    @property
    def n_spot(self) -> int:
        return self.spot_p.shape[0]

    @property
    def n_proj(self) -> int:
        return self.proj_p.shape[0]

    @property
    def n_gonio(self) -> int:
        return self.gonio_p.shape[0]

    @property
    def n_distant(self) -> int:
        return self.distant_dir.shape[0]

    @property
    def has_env(self) -> bool:
        return self.env is not None

    @property
    def _n_finite(self) -> int:
        """Lights before the infinite slot: the infinite light's id."""
        return (self.n_area + self.n_sphl + self.n_point + self.n_spot
                + self.n_proj + self.n_gonio + self.n_distant)

    @property
    def n_lights(self) -> int:
        return self._n_finite + (1 if (self.has_infinite or self.has_env)
                                 else 0)

    @property
    def n_bvh(self) -> int:
        """Positional lights, which a light BVH would hold."""
        return (self.n_area + self.n_sphl + self.n_point + self.n_spot
                + self.n_proj + self.n_gonio)

    @property
    def n_inf_list(self) -> int:
        """Lights sampled outside a light BVH: distant + infinite."""
        return self.n_distant + (1 if (self.has_infinite or self.has_env)
                                 else 0)

    @property
    def _p_infinite(self) -> float:
        """Probability of sampling the non-BVH light list (BVHLightSampler::
        Sample: a count-proportional split)."""
        ni = self.n_inf_list
        if (self.bvh is None and self.exh_recs is None) or ni == 0:
            return 0.0 if self.n_bvh > 0 else 1.0
        return ni / (ni + 1.0)

    @staticmethod
    def build(area_tris=None, sphere_lights=None, points=None, spots=None,
              projections=None, gonios=None, distants=None, infinite=None,
              envmap=None, sampler: str = "uniform") -> "LightBuffers":
        """Host-side build from light specs, as the reference's:
        area_tris: verts (3, 3), rgb, scale, two_sided, illuminant;
        sphere_lights: c (3,), r, rgb, scale, two_sided, illuminant;
        points: p, rgb, scale, illuminant;
        spots: p, to, rgb, scale, coneangle, conedelta, illuminant;
        projections: p, to, fov, rgb | rgb_image, scale, illuminant;
        gonios: p, to, rgb | rgb_image, scale, illuminant;
        distants: dir (travel direction), rgb, scale, illuminant;
        infinite: rgb, scale, illuminant, or None;
        envmap: an EnvironmentMap or PortalLight replacing `infinite`;
        sampler: "uniform" | "power" | "bvh" | "exhaustive" selection."""
        area_tris = area_tris or []
        sphere_lights = sphere_lights or []
        points = points or []
        spots = spots or []
        projections = projections or []
        gonios = gonios or []
        distants = distants or []

        pj_c, pj_s, pj_means = _img_grid(projections)
        gn_c, gn_s, gn_means = _img_grid(gonios)
        pj_rot = (np.stack([_frame(s) for s in projections]) if projections
                  else np.zeros((0, 3, 3)))
        gn_rot = (np.stack([_frame(s) for s in gonios]) if gonios
                  else np.zeros((0, 3, 3)))
        pj_tan = np.asarray([np.tan(np.deg2rad(s.get("fov", 45.0)) / 2.0)
                             for s in projections], np.float32)

        av = _rows(area_tris, "verts", 9).reshape(-1, 3, 3)
        if len(av):
            areas = 0.5 * np.linalg.norm(
                np.cross(av[:, 1] - av[:, 0], av[:, 2] - av[:, 0]), axis=-1)
        else:
            areas = np.zeros((0,), np.float32)

        sp_p = _rows(spots, "p", 3)
        sp_dir = np.asarray([s.get("to", (0, -1, 0)) for s in spots],
                            np.float32).reshape(-1, 3) - sp_p
        if len(sp_dir):
            sp_dir = sp_dir / np.linalg.norm(sp_dir, axis=-1, keepdims=True)
        sp_cone = np.asarray([np.deg2rad(s.get("coneangle", 30.0))
                              for s in spots], np.float32)
        sp_delta = np.asarray([np.deg2rad(s.get("conedelta", 5.0))
                               for s in spots], np.float32)

        dd = _rows(distants, "dir", 3)
        if len(dd):
            dd = dd / np.linalg.norm(dd, axis=-1, keepdims=True)

        if infinite is not None:
            ic, isc = rgb2spec.fit_unbounded(
                np.asarray(infinite["rgb"], np.float32)
                * infinite.get("scale", 1.0))
            isc = isc.reshape(())
            iil = torch.tensor(bool(infinite.get("illuminant", True)))
        else:
            ic, isc, iil = torch.zeros((3,)), torch.zeros(()), torch.tensor(False)

        # Selection distribution (PowerLightSampler, lightsamplers.h:29:
        # proportional to each light's power; uniform otherwise).
        def lum(s):
            return float(np.mean(s["rgb"])) * s.get("scale", 1.0)

        powers = []
        for i, a in enumerate(area_tris):
            two = 2.0 if a.get("two_sided", False) else 1.0
            powers.append(lum(a) * float(areas[i]) * np.pi * two)
        for q in sphere_lights:
            two = 2.0 if q.get("two_sided", False) else 1.0
            powers.append(lum(q) * 4.0 * np.pi * float(q["r"]) ** 2 * np.pi * two)
        for p in points:
            powers.append(lum(p) * 4 * np.pi)
        for s in spots:
            solid = 2 * np.pi * (1 - np.cos(np.deg2rad(s.get("coneangle", 30.0))))
            powers.append(lum(s) * solid)
        for i, s in enumerate(projections):
            half = np.deg2rad(s.get("fov", 45.0)) / 2.0
            powers.append(pj_means[i] * 2 * np.pi
                          * (1 - np.cos(half * np.sqrt(2.0))))
        for i in range(len(gonios)):
            powers.append(gn_means[i] * 4 * np.pi)
        for d in distants:
            powers.append(lum(d) * np.pi)
        if envmap is not None:
            powers.append(float(torch.mean(envmap.luminance) * envmap.strength)
                          * 4 * np.pi)
        elif infinite is not None:
            powers.append(lum(infinite) * 4 * np.pi)
        powers = np.asarray(powers, np.float64)
        nl = len(powers)
        if nl == 0:
            pmf = np.zeros((0,))
        elif sampler == "power" and powers.sum() > 0:
            pmf = powers / powers.sum()
        else:
            pmf = np.full(nl, 1.0 / nl)

        ac, asc = _fit(area_tris)
        qc, qsc = _fit(sphere_lights)
        pc, psc = _fit(points)
        spc, spsc = _fit(spots)
        dc, dsc = _fit(distants)
        lb = LightBuffers(
            area_verts=torch.as_tensor(av),
            area_coeffs=ac,
            area_scale=asc,
            area_illum=_flags(area_tris, "illuminant", True),
            area_two_sided=_flags(area_tris, "two_sided", False),
            area_area=_f32(areas),
            sphl_c=torch.as_tensor(_rows(sphere_lights, "c", 3)),
            sphl_r=torch.as_tensor(_rows(sphere_lights, "r", 1).reshape(-1)),
            sphl_coeffs=qc,
            sphl_scale=qsc,
            sphl_illum=_flags(sphere_lights, "illuminant", True),
            sphl_two=_flags(sphere_lights, "two_sided", False),
            point_p=torch.as_tensor(_rows(points, "p", 3)),
            point_coeffs=pc,
            point_scale=psc,
            point_illum=_flags(points, "illuminant", True),
            spot_p=torch.as_tensor(sp_p),
            spot_dir=_f32(sp_dir.reshape(-1, 3)),
            spot_cos_start=_f32(np.cos(np.maximum(sp_cone - sp_delta, 0.0))),
            spot_cos_end=_f32(np.cos(sp_cone)),
            spot_coeffs=spc,
            spot_scale=spsc,
            spot_illum=_flags(spots, "illuminant", True),
            proj_p=torch.as_tensor(_rows(projections, "p", 3)),
            proj_rot=_f32(pj_rot),
            proj_tan=_f32(pj_tan.reshape(-1)),
            proj_coeffs=pj_c,
            proj_scale_tx=pj_s,
            proj_illum=_flags(projections, "illuminant", True),
            gonio_p=torch.as_tensor(_rows(gonios, "p", 3)),
            gonio_rot=_f32(gn_rot),
            gonio_coeffs=gn_c,
            gonio_scale_tx=gn_s,
            gonio_illum=_flags(gonios, "illuminant", True),
            distant_dir=_f32(dd),
            distant_coeffs=dc,
            distant_scale=dsc,
            distant_illum=_flags(distants, "illuminant", True),
            infinite_coeffs=ic,
            infinite_scale=isc,
            infinite_illum=iil,
            select_cdf=_f32(np.cumsum(pmf)),
            select_pmf=_f32(pmf),
            env=envmap,
            has_infinite=infinite is not None,
            sampler=sampler,
        )
        if sampler == "bvh":
            lb = lb.replace(bvh=light_bvh.LightBVH.build(lb))
        elif sampler == "exhaustive":
            lbs = light_bvh.light_bounds_arrays(lb)
            if lbs:
                lb = lb.replace(exh_recs=torch.from_numpy(
                    light_bvh.pack_light_records(lbs)))
        return lb

    # -- selection ----------------------------------------------------------

    def _split_infinite(self, u_select):
        """The BVH and exhaustive samplers' split: (p_inf, n_inf, pick_inf,
        inf_idx, u remapped for the positional lights)."""
        p_inf = self._p_infinite
        ni = self.n_inf_list
        if ni > 0:
            pick_inf = u_select < p_inf
            inf_off = torch.clamp(
                (u_select / max(p_inf, 1e-9) * ni).to(torch.int32), max=ni - 1)
            inf_idx = self.n_bvh + inf_off.long()
        else:
            pick_inf = torch.zeros(u_select.shape, dtype=torch.bool,
                                   device=u_select.device)
            inf_idx = torch.zeros(u_select.shape, dtype=torch.int64,
                                  device=u_select.device)
        u_pos = torch.clamp((u_select - p_inf) / max(1.0 - p_inf, 1e-9),
                            0.0, 1.0 - 1e-7)
        return p_inf, ni, pick_inf, inf_idx, u_pos

    def select(self, p_ref, n_ref, u_select):
        """Pick a light per shading point: (idx (N,) int64, pmf (N,)). The
        BVH's stochastic descent, the exhaustive sampler's importance over
        every light (the BVH's oracle), or the tabulated power or uniform
        cdf."""
        if self.exh_recs is not None:
            imp = light_bvh.exhaustive_importance(self.exh_recs, p_ref, n_ref)
            tot = torch.sum(imp, dim=-1)
            alive = tot > 0.0
            pmf_l = imp / torch.clamp(tot, min=1e-30)[:, None]
            p_inf, ni, pick_inf, inf_idx, u_b = self._split_infinite(u_select)
            cdf = torch.cumsum(pmf_l, dim=-1)
            bl = torch.clamp(torch.sum(cdf <= u_b[:, None], dim=-1),
                             max=imp.shape[-1] - 1)
            bpmf = torch.gather(pmf_l, -1, bl[:, None])[:, 0]
            idx = torch.where(pick_inf, inf_idx, bl)
            pmf = torch.where(pick_inf, p_inf / max(ni, 1),
                              (1.0 - p_inf) * bpmf * alive)
            return torch.where(pick_inf | alive, idx, -1), pmf
        if self.bvh is not None:
            p_inf, ni, pick_inf, inf_idx, u_b = self._split_infinite(u_select)
            bl, bpmf = light_bvh.sample(self.bvh, p_ref, n_ref, u_b)
            idx = torch.where(pick_inf, inf_idx, torch.clamp(bl, min=0))
            pmf = torch.where(pick_inf, p_inf / max(ni, 1),
                              (1.0 - p_inf) * bpmf * (bl >= 0))
            return idx, pmf
        # The number of cdf entries <= u, as the reference counts them
        # over an (N, L) comparison: the cdf does not decrease, so a
        # binary search gives the same index without the (N, L) tensor
        # (8.6 GB of int64 at the hall's 524,288 rays and 2,048 lights).
        idx = torch.clamp(
            torch.searchsorted(self.select_cdf, u_select, right=True),
            max=self.n_lights - 1,
        )
        return idx, self.select_pmf[idx]

    def selection_pmf(self, light_idx, p_ref=None, n_ref=None):
        """PMF that `select` picks light_idx (>= 0) at p_ref (for MIS when
        a BSDF ray lands on a light; BVHLightSampler::PMF)."""
        if self.exh_recs is not None:
            imp = light_bvh.exhaustive_importance(self.exh_recs, p_ref, n_ref)
            tot = torch.sum(imp, dim=-1)
            p_inf = self._p_infinite
            in_pos = (light_idx >= 0) & (light_idx < self.n_bvh)
            li = torch.clamp(light_idx, 0, imp.shape[-1] - 1).long()
            pm_pos = (1.0 - p_inf) * torch.gather(imp, -1, li[:, None])[:, 0] \
                / torch.clamp(tot, min=1e-30)
            return torch.where(
                in_pos, torch.where(tot > 0.0, pm_pos, 0.0),
                torch.where(light_idx >= 0, p_inf / max(self.n_inf_list, 1),
                            0.0))
        if self.bvh is not None:
            p_inf = self._p_infinite
            in_bvh = (light_idx >= 0) & (light_idx < self.n_bvh)
            pm = (1.0 - p_inf) * light_bvh.pmf(
                self.bvh, p_ref, n_ref, torch.where(in_bvh, light_idx, 0))
            return torch.where(
                in_bvh, pm,
                torch.where(light_idx >= 0, p_inf / max(self.n_inf_list, 1),
                            0.0))
        i = torch.clamp(light_idx, 0, self.n_lights - 1)
        return torch.where(light_idx >= 0, self.select_pmf[i], 0.0)

    # -- emission queries ---------------------------------------------------

    def area_radiance(self, light_idx, lam):
        """Emitted radiance of emissive-geometry light `light_idx` (area
        triangle or analytic sphere) at wavelengths lam."""
        na, nq = self.n_area, self.n_sphl
        out = torch.zeros(light_idx.shape + (lam.shape[-1],), dtype=lam.dtype,
                          device=lam.device)
        if na > 0:
            i = torch.clamp(light_idx, 0, na - 1)
            L_a = eval_emission(take(self.area_coeffs, i),
                                take(self.area_scale, i), self.area_illum[i], lam)
            out = torch.where((light_idx < na)[..., None], L_a, out)
        if nq > 0:
            qi = torch.clamp(light_idx - na, 0, nq - 1)
            L_q = eval_emission(take(self.sphl_coeffs, qi),
                                take(self.sphl_scale, qi),
                                self.sphl_illum[qi], lam)
            out = torch.where((light_idx >= na)[..., None], L_q, out)
        return out

    def emitted(self, light_idx, n_geo, wo, lam):
        """L_e toward wo for rays that hit emissive geometry light_idx
        (>= 0): area triangles (ids < n_area) or analytic spheres
        (DiffuseAreaLight::L)."""
        na, nq = self.n_area, self.n_sphl
        if na + nq == 0:
            return torch.zeros_like(lam)
        front = dot(n_geo, wo) > 0.0
        L = 0.0
        if na > 0:
            i = torch.clamp(light_idx, 0, na - 1)
            vis = front | self.area_two_sided[i]
            L_a = eval_emission(take(self.area_coeffs, i),
                                take(self.area_scale, i), self.area_illum[i], lam)
            use = (light_idx >= 0) & (light_idx < na) & vis
            L = torch.where(use[..., None], L_a, L)
        if nq > 0:
            qi = torch.clamp(light_idx - na, 0, nq - 1)
            vis = front | self.sphl_two[qi]
            L_q = eval_emission(take(self.sphl_coeffs, qi),
                                take(self.sphl_scale, qi),
                                self.sphl_illum[qi], lam)
            use = (light_idx >= na) & vis
            L = torch.where(use[..., None], L_q, L)
        return L

    def _infinite_radiance(self, lam):
        return eval_emission(
            self.infinite_coeffs[None, :], self.infinite_scale[None],
            self.infinite_illum[None], lam,
        )

    def escaped_radiance(self, d, lam, p_ref=None):
        """Radiance for rays escaping in direction d: the image or portal
        light's (a portal windows it by the ray origins p_ref), else the
        uniform infinite light's, else zero."""
        if self.has_env:
            if isinstance(self.env, PortalLight):
                return self.env.radiance(d, lam, p_ref)
            return self.env.radiance(d, lam)
        if not self.has_infinite:
            return torch.zeros_like(lam)
        return self._infinite_radiance(lam)

    def pdf_escaped(self, d, p_ref=None):
        """Solid-angle pdf that NEE produced the escaped direction d,
        including the infinite light's selection pmf; zero without one."""
        if self.bvh is not None:
            pmf = self._p_infinite / max(self.n_inf_list, 1)
        elif self.has_env or self.has_infinite:
            pmf = self.select_pmf[self._n_finite]
        if self.has_env:
            if isinstance(self.env, PortalLight):
                p = p_ref if p_ref is not None else torch.zeros_like(d)
                return self.env.pdf_dir(d, p) * pmf
            return self.env.pdf_dir(d) * pmf
        if not self.has_infinite:
            return torch.zeros(d.shape[:-1], dtype=d.dtype, device=d.device)
        return torch.full(d.shape[:-1], UNIFORM_SPHERE_PDF, dtype=d.dtype,
                          device=d.device) * pmf

    # -- NEE sampling -------------------------------------------------------

    def sample_li(self, p_ref, lam, u_select, u_pos, n_ref=None) -> LightLiSample:
        """Select a light and sample a point or direction on it. pdf is with
        respect to solid angle at p_ref and INCLUDES the selection pmf. A
        light type's branch runs only when the scene holds such lights."""
        if self.n_lights == 0:
            raise ValueError("sample_li with no lights")
        n = p_ref.shape[0]
        dev, f32 = p_ref.device, p_ref.dtype
        idx, sel_pmf = self.select(p_ref, n_ref, u_select)
        L = torch.zeros((n, lam.shape[-1]), dtype=f32, device=dev)
        wi = torch.zeros_like(p_ref)
        pdf = torch.zeros((n,), dtype=f32, device=dev)
        dist = torch.full((n,), float("inf"), dtype=f32, device=dev)
        is_delta = torch.zeros((n,), dtype=torch.bool, device=dev)

        def put(lo, count, L_b, wi_b, pdf_b, dist_b, delta):
            nonlocal L, wi, pdf, dist, is_delta
            use = _in_block(idx, lo, count)
            L = torch.where(use[..., None], L_b, L)
            wi = torch.where(use[..., None], wi_b, wi)
            pdf = torch.where(use, pdf_b, pdf)
            dist = torch.where(use, dist_b, dist)
            if delta:
                is_delta = is_delta | use

        def toward(p_l):
            to_l = p_l - p_ref
            d2 = torch.clamp(torch.sum(to_l * to_l, dim=-1), min=_EPS)
            d = torch.sqrt(d2)
            return to_l / d[..., None], d2, d

        base = 0
        na = self.n_area
        if na > 0:
            ai = torch.clamp(idx, 0, na - 1)
            verts = self.area_verts[ai]  # (N, 3, 3)
            b = sample_uniform_triangle(u_pos)  # (N, 3)
            p_l = (b[:, 0:1] * verts[:, 0] + b[:, 1:2] * verts[:, 1]
                   + b[:, 2:3] * verts[:, 2])
            n_l = normalize(cross(verts[:, 1] - verts[:, 0],
                                  verts[:, 2] - verts[:, 0]))
            wi_a, d2, d = toward(p_l)
            cos_l = dot(n_l, -wi_a)
            two = self.area_two_sided[ai]
            emit_ok = (cos_l > _EPS) | (two & (torch.abs(cos_l) > _EPS))
            area = torch.clamp(self.area_area[ai], min=_EPS)
            pdf_a = d2 / (torch.abs(cos_l) * area + _EPS)
            L_a = eval_emission(take(self.area_coeffs, ai),
                                take(self.area_scale, ai),
                                self.area_illum[ai], lam)
            L_a = torch.where(emit_ok[..., None], L_a, 0.0)
            put(base, na, L_a, wi_a, pdf_a, d, False)
        base += na

        nq = self.n_sphl
        if nq > 0:
            # Cone sampling of the subtended solid angle from outside
            # (Sphere::Sample(ctx, u), shapes.cpp, with the cosAlpha solve
            # for the surface point), uniform area sampling from inside.
            qi = torch.clamp(idx - base, 0, nq - 1)
            c_q = self.sphl_c[qi]
            r_q = self.sphl_r[qi]
            to_c = c_q - p_ref
            dc2 = torch.sum(to_c * to_c, dim=-1)
            inside = dc2 <= r_q * r_q * (1.0 + 1e-6)
            dc = torch.sqrt(torch.clamp(dc2, min=_EPS))
            sin2max = torch.clamp(r_q * r_q / torch.clamp(dc2, min=_EPS),
                                  0.0, 1.0)
            cosmax = torch.sqrt(torch.clamp(1.0 - sin2max, min=0.0))
            # Taylor-stable 1 - cos(thetaMax) for tiny subtended angles.
            one_minus = torch.where(sin2max < 6.85e-4, 0.5 * sin2max,
                                    1.0 - cosmax)
            cos_t = 1.0 - u_pos[..., 0] * one_minus
            sin2_t = torch.clamp(1.0 - cos_t * cos_t, min=0.0)
            sinmax = torch.sqrt(torch.clamp(sin2max, min=_EPS))
            cos_a = sin2_t / sinmax + cos_t * torch.sqrt(torch.clamp(
                1.0 - sin2_t / torch.clamp(sin2max, min=_EPS), min=0.0))
            cos_a = torch.clamp(cos_a, -1.0, 1.0)
            sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
            phi_a = 2.0 * math.pi * u_pos[..., 1]
            zf = (p_ref - c_q) / dc[..., None]
            t1q, t2q = coordinate_system(zf)
            n_out = (t1q * (sin_a * torch.cos(phi_a))[..., None]
                     + t2q * (sin_a * torch.sin(phi_a))[..., None]
                     + zf * cos_a[..., None])
            n_l = torch.where(inside[..., None], sample_uniform_sphere(u_pos),
                              n_out)
            wi_q, d2, d = toward(c_q + r_q[..., None] * n_l)
            cos_l = dot(n_l, -wi_q)
            pdf_in = d2 / (torch.abs(cos_l) * (4.0 * math.pi * r_q * r_q) + _EPS)
            pdf_out = 1.0 / torch.clamp(2.0 * math.pi * one_minus, min=_EPS)
            two_q = self.sphl_two[qi]
            emit_ok = (cos_l > _EPS) | (two_q & (torch.abs(cos_l) > _EPS))
            L_q = eval_emission(take(self.sphl_coeffs, qi),
                                take(self.sphl_scale, qi),
                                self.sphl_illum[qi], lam)
            L_q = torch.where(emit_ok[..., None], L_q, 0.0)
            put(base, nq, L_q, wi_q, torch.where(inside, pdf_in, pdf_out), d,
                False)
        base += nq

        npt = self.n_point
        if npt > 0:
            pi = torch.clamp(idx - base, 0, npt - 1)
            wi_p, d2, d = toward(self.point_p[pi])
            I = eval_emission(take(self.point_coeffs, pi),
                              take(self.point_scale, pi),
                              self.point_illum[pi], lam)
            put(base, npt, I / d2[..., None], wi_p, 1.0, d, True)
        base += npt

        nsp = self.n_spot
        if nsp > 0:
            si = torch.clamp(idx - base, 0, nsp - 1)
            wi_s, d2, d = toward(self.spot_p[si])
            cos_t = torch.sum(-wi_s * self.spot_dir[si], dim=-1)
            c0 = self.spot_cos_start[si]
            c1 = self.spot_cos_end[si]
            # Smoothstep falloff from totalWidth to falloffStart
            # (SpotLight::I), clipped first.
            t_ = torch.clamp((cos_t - c1) / torch.clamp(c0 - c1, min=1e-6),
                             0.0, 1.0)
            falloff = t_ * t_ * (3.0 - 2.0 * t_)
            I = eval_emission(take(self.spot_coeffs, si),
                              take(self.spot_scale, si),
                              self.spot_illum[si], lam)
            put(base, nsp, I * (falloff / d2)[..., None], wi_s, 1.0, d, True)
        base += nsp

        nj = self.n_proj
        if nj > 0:
            ji = torch.clamp(idx - base, 0, nj - 1)
            wi_j, d2, d = toward(self.proj_p[ji])
            # Light-space direction from the light toward the point.
            w_l = torch.einsum("nij,nj->ni", self.proj_rot[ji], -wi_j)
            tanh = self.proj_tan[ji]
            z = torch.clamp(w_l[:, 2], min=1e-6)
            uu = 0.5 * (w_l[:, 0] / (z * tanh) + 1.0)
            vv = 0.5 * (w_l[:, 1] / (z * tanh) + 1.0)
            inside = ((w_l[:, 2] > 0.0) & (uu >= 0.0) & (uu < 1.0)
                      & (vv >= 0.0) & (vv < 1.0))
            I_j = _image_emission(self.proj_coeffs, self.proj_scale_tx,
                                  self.proj_illum, ji, uu, vv, lam)
            L_j = torch.where(inside[..., None], I_j / d2[..., None], 0.0)
            put(base, nj, L_j, wi_j, 1.0, d, True)
        base += nj

        ng = self.n_gonio
        if ng > 0:
            gi = torch.clamp(idx - base, 0, ng - 1)
            wi_g, d2, d = toward(self.gonio_p[gi])
            w_l = torch.einsum("nij,nj->ni", self.gonio_rot[gi], -wi_g)
            uv_g = equal_area_sphere_to_square(w_l)
            I_g = _image_emission(self.gonio_coeffs, self.gonio_scale_tx,
                                  self.gonio_illum, gi, uv_g[..., 0],
                                  uv_g[..., 1], lam)
            put(base, ng, I_g / d2[..., None], wi_g, 1.0, d, True)
        base += ng

        nd = self.n_distant
        if nd > 0:
            di = torch.clamp(idx - base, 0, nd - 1)
            L_d = eval_emission(take(self.distant_coeffs, di),
                                take(self.distant_scale, di),
                                self.distant_illum[di], lam)
            put(base, nd, L_d, -self.distant_dir[di], 1.0, float("inf"), True)
        base += nd

        if self.has_env or self.has_infinite:
            # The infinite slot: a direction at infinite distance
            # (accel.dense.shadow_segment handles it).
            if isinstance(self.env, PortalLight):
                wi_e, L_e, pdf_e = self.env.sample(u_pos, lam, p_ref)
            elif self.has_env:
                wi_e, L_e, pdf_e = self.env.sample(u_pos, lam)
            else:
                wi_e = sample_uniform_sphere(u_pos)
                L_e, pdf_e = self._infinite_radiance(lam), UNIFORM_SPHERE_PDF
            put(base, 1, L_e, wi_e, pdf_e, float("inf"), False)

        return LightLiSample(L=L, wi=wi, pdf=pdf * sel_pmf, dist=dist,
                             is_delta=is_delta)

    def pdf_li_area(self, light_idx, dist, cos_l, p_ref=None, n_ref=None):
        """Solid-angle pdf that NEE would have produced the direction that hit
        emissive-geometry light `light_idx`, including the selection pmf
        (for MIS on BSDF-sampled rays; DiffuseAreaLight::PDF_Li). p_ref is
        the previous path vertex (a sphere light's cone is seen from it)."""
        na, nq = self.n_area, self.n_sphl
        if na + nq == 0:
            return torch.zeros_like(dist)
        ii = torch.clamp(light_idx, 0, na + nq - 1)
        # The BVH's pmf depends on the previous vertex; the exhaustive
        # sampler's MIS takes the table's, as the reference's does.
        if self.bvh is not None and p_ref is not None:
            pmf = self.selection_pmf(light_idx, p_ref, n_ref)
        else:
            pmf = self.select_pmf[ii]
        pdf = 0.0
        if na > 0:
            i = ii if nq == 0 else torch.clamp(light_idx, 0, na - 1)
            area = torch.clamp(self.area_area[i], min=_EPS)
            pdf = dist * dist / (torch.abs(cos_l) * area + _EPS)
        if nq > 0:
            # Sphere::PDF(ctx, wi): the uniform-cone pdf from outside the
            # sphere, the area measure converted from inside (shapes.cpp).
            qi = torch.clamp(light_idx - na, 0, nq - 1)
            c_q = self.sphl_c[qi]
            r_q = self.sphl_r[qi]
            pv = p_ref if p_ref is not None else torch.zeros_like(c_q)
            dc2 = torch.sum((pv - c_q) ** 2, dim=-1)
            inside = dc2 <= r_q * r_q * (1.0 + 1e-6)
            sin2max = torch.clamp(r_q * r_q / torch.clamp(dc2, min=_EPS),
                                  0.0, 1.0)
            cosmax = torch.sqrt(torch.clamp(1.0 - sin2max, min=0.0))
            one_minus = torch.where(sin2max < 6.85e-4, 0.5 * sin2max,
                                    1.0 - cosmax)
            pdf_cone = 1.0 / torch.clamp(2.0 * math.pi * one_minus, min=_EPS)
            pdf_in = dist * dist / (torch.abs(cos_l) * (4.0 * math.pi * r_q * r_q)
                                    + _EPS)
            pdf = torch.where(light_idx >= na,
                              torch.where(inside, pdf_in, pdf_cone), pdf)
        if grad_flows(pmf):
            # A lane that hits no light has t, so pdf, inf: 0 * inf to the
            # pmf's gradient (the reference's reverse mode is NaN there).
            pdf = torch.where(light_idx >= 0, pdf, 0.0)
        return torch.where(light_idx >= 0, pdf * pmf, 0.0)

    def sample_le_origin(self, u_sel, u_pos):
        """SampleLe's origin over ALL emissive geometry (area triangles and
        analytic spheres) with the selection pmf renormalised over those
        lights: the front half shared by the light tracers (LightPath,
        BDPT, SPPM; DiffuseAreaLight::SampleLe's position sample). The
        callers sample the direction (cosine about n). Returns a dict: p
        (N, 3), n (N, 3), area (N,), pmf (N,), coeffs (N, 3), scale (N,),
        illum (N,) for eval_emission, and idx (N,) the light id.

        A scene with lights of another kind raises: its light paths would
        leave those lights out (pbrt-v4 starts them on every light; the
        reference, on emissive geometry only)."""
        na, nq = self.n_area, self.n_sphl
        ne = na + nq
        if self.n_lights > ne:
            raise NotImplementedError(
                "light paths from point, spot, projection, goniometric, "
                "distant and infinite lights (their SampleLe) are not ported "
                "(ROADMAP Queue 1 item 16); light tracing starts on emissive "
                "geometry only")
        if ne == 0:
            raise ValueError("sample_le_origin: the scene has no emissive "
                             "geometry")
        pmf_e = self.select_pmf[:ne]
        pmf_e = pmf_e / torch.clamp(torch.sum(pmf_e), min=1e-12)
        cdf_e = torch.cumsum(pmf_e, dim=0)
        idx = torch.clamp(
            torch.sum((cdf_e[None, :] <= u_sel[..., None]).to(torch.int64),
                      dim=-1), max=ne - 1)
        pmf = pmf_e[idx]
        n = u_sel.shape[0]
        dev = u_sel.device
        p0 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        n0 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        area = torch.ones((n,), dtype=torch.float32, device=dev)
        coeffs = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        scale = torch.zeros((n,), dtype=torch.float32, device=dev)
        illum = torch.zeros((n,), dtype=torch.bool, device=dev)
        if na > 0:
            ai = torch.clamp(idx, 0, na - 1)
            verts = self.area_verts[ai]  # (N, 3, 3)
            b = sample_uniform_triangle(u_pos)
            p_a = torch.einsum("nk,nkj->nj", b, verts)
            n_a = normalize(cross(verts[:, 1] - verts[:, 0],
                                  verts[:, 2] - verts[:, 0]))
            use = idx < na
            p0 = torch.where(use[:, None], p_a, p0)
            n0 = torch.where(use[:, None], n_a, n0)
            area = torch.where(use, self.area_area[ai], area)
            coeffs = torch.where(use[:, None], take(self.area_coeffs, ai),
                                 coeffs)
            scale = torch.where(use, take(self.area_scale, ai), scale)
            illum = torch.where(use, self.area_illum[ai], illum)
        if nq > 0:
            qi = torch.clamp(idx - na, 0, nq - 1)
            r_q = self.sphl_r[qi]
            n_q = sample_uniform_sphere(u_pos)
            use = idx >= na
            p0 = torch.where(use[:, None], self.sphl_c[qi] + r_q[:, None] * n_q,
                             p0)
            n0 = torch.where(use[:, None], n_q, n0)
            area = torch.where(use, 4.0 * math.pi * r_q * r_q, area)
            coeffs = torch.where(use[:, None], take(self.sphl_coeffs, qi),
                                 coeffs)
            scale = torch.where(use, take(self.sphl_scale, qi), scale)
            illum = torch.where(use, self.sphl_illum[qi], illum)
        return {"p": p0, "n": n0, "area": area, "pmf": pmf, "coeffs": coeffs,
                "scale": scale, "illum": illum, "idx": idx}
