"""Bidirectional path tracing over per-vertex tensors and unrolled
strategies (port of pbrt_tpu/models/bdpt.py; BDPTIntegrator,
integrators.h:343 and integrators.cpp:2218-3024 of pbrt-v4).

Both subpaths are lists of per-vertex tensors (N paths each), built by a
Python loop where the reference scans, and every (s, t) connection
strategy is unrolled. MIS weights use the reference's pdfFwd / pdfRev
area-density bookkeeping (MISWeight, integrators.cpp:2541-2613), with the
per-strategy endpoint remaps computed from the stored vertices; a remapped
density is a new tensor, never written into a vertex that a later strategy
reads.

Scope (the reference's): a pinhole perspective camera and emissive
geometry (area triangles, sphere lights); shading normals equal geometric
normals. Strategies with t >= 2 add into the path's own pixel; t == 1
strategies splat onto a shared film normalised by the path count, pbrt's
split between L and the SplatFilm. The splats are index_add_ (atomics on
the card: the last bits vary from run to run).
"""

from __future__ import annotations

import math

import torch

from ..accel import api as accel_api
from ..accel.dense import offset_ray_origin
from ..core import spectrum
from ..core.sampling import sample_cosine_hemisphere
from ..core.tensorclass import static_field, tensorclass
from ..core.vecmath import coordinate_system, dot, from_local, to_local
from ..films.rgb import spectrum_to_rgb
from ..lights.buffers import eval_emission
from ..materials import bxdf
from ..samplers.samplers import Sampler, as_sampler
from .lightpath import require_pinhole, splat_add
from .path import _frame, refuse_gradient

_EPS = 1e-20
_INV_PI = 1.0 / math.pi


def _remap0(x):
    """MIS ratio helper: a zero density counts as 1 (remap0), so delta and
    impossible segments drop out of the ratio products."""
    return torch.where(x > 0.0, x, 1.0)


def _dist2(a, b):
    d = b - a
    return torch.sum(d * d, dim=-1)


def _dir_to(a, b):
    d = b - a
    return d / torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1, keepdim=True),
                                      min=_EPS))


def _to_area(pdf_w, p_from, p_to, n_to):
    """Solid-angle density at p_from -> area density at p_to
    (Vertex::ConvertDensity)."""
    cos_t = torch.abs(dot(n_to, _dir_to(p_from, p_to)))
    return pdf_w * cos_t / torch.clamp(_dist2(p_from, p_to), min=_EPS)


def _bsdf_pdf_area(params, ns, p_self, d_in_world, p_target, n_target):
    """Area density that the vertex (params, ns) scatters the incoming
    direction d_in_world (pointing INTO the vertex) toward p_target."""
    t1, t2 = coordinate_system(ns)
    wo_l = to_local(-d_in_world, t1, t2, ns)
    wi_l = to_local(_dir_to(p_self, p_target), t1, t2, ns)
    return _to_area(bxdf.pdf(params, wo_l, wi_l), p_self, p_target, n_target)


def _scatter_back_area(params, ns, p_self, w_out, p_prev, n_prev):
    """Area density that the vertex at p_self, reached from direction w_out
    (pointing away from it), scatters back toward p_prev."""
    t1, t2 = coordinate_system(ns)
    wo_new = to_local(w_out, t1, t2, ns)
    wi_back = to_local(_dir_to(p_self, p_prev), t1, t2, ns)
    return _to_area(bxdf.pdf(params, wo_new, wi_back), p_self, p_prev, n_prev)


@tensorclass
class BDPTIntegrator:
    max_depth: int = static_field(default=5)
    # Diagnostics: when a dict is given, each (s, t) strategy's
    # contribution (N, S) is stored in it (tests only).
    debug_sink: object = static_field(default=None)
    disable_mis: bool = static_field(default=False)

    # ---- subpath generation ----------------------------------------------

    def _walk(self, scene, o, d, beta, pdf_dir, p_prev, lam, pid, sample_idx,
              sampler, dim_base, n_steps, stop_at_light):
        """Random-walk n_steps surface vertices from an initial ray
        (GenerateCameraSubpath / GenerateLightSubpath + RandomWalk,
        integrators.cpp:2374-2540). Returns a list of per-vertex dicts:
        valid, p, ng, ns, d_in (unit, previous -> this), beta (throughput
        into the vertex), pdf_fwd (area), rev_pdf_w (solid-angle pdf of
        scattering back toward the previous vertex), delta (the sampled
        lobe was specular), light (the area-light id at the hit, or -1),
        params (the material dict) and pdf_rev (area, the next vertex
        scattering back onto this one)."""
        n = o.shape[0]
        active = torch.ones((n,), dtype=torch.bool, device=o.device)
        verts = []
        for k in range(n_steps):
            isect = accel_api.closest(scene, o, d)
            valid = active & isect.valid
            if stop_at_light:
                # Light subpaths stop on a light (lights do not scatter).
                valid = valid & (isect.light < 0)
            t1, t2, ns, wo_l = _frame(isect)
            pdf_fwd = torch.where(valid, _to_area(pdf_dir, p_prev, isect.p, ns),
                                  0.0)
            params = bxdf.surface_params(scene, isect, lam)
            dim0 = dim_base + k * 4
            uc = sampler.get_1d(pid, sample_idx, dim0)
            ub0, ub1 = sampler.get_2d(pid, sample_idx, dim0 + 1)
            bs = bxdf.sample(params, wo_l, lam, torch.stack([ub0, ub1], -1),
                             uc)
            wi_w = from_local(bs["wi"], t1, t2, ns)
            rev_pdf_w = torch.where(bs["specular"], 0.0,
                                    bxdf.pdf(params, bs["wi"], wo_l))
            ok = valid & (bs["pdf"] > 0.0)
            cos_wi = torch.abs(bs["wi"][:, 2])
            beta_next = torch.where(
                ok[:, None],
                beta * bs["f"]
                * (cos_wi / torch.clamp(bs["pdf"], min=_EPS))[:, None],
                0.0)
            pdf_dir_next = torch.where(bs["specular"], 0.0, bs["pdf"])
            o_new = offset_ray_origin(isect.p, isect.n, wi_w)
            verts.append({
                "valid": valid,
                "p": torch.where(valid[:, None], isect.p, 0.0),
                "ng": isect.n, "ns": ns, "d_in": d,
                "beta": torch.where(valid[:, None], beta, 0.0),
                "pdf_fwd": pdf_fwd, "rev_pdf_w": rev_pdf_w,
                "delta": bs["specular"] & valid,
                "light": torch.where(valid, isect.light, -1),
                "params": params,
            })
            o = torch.where(ok[:, None], o_new, o)
            d = torch.where(ok[:, None], wi_w, d)
            beta = beta_next
            pdf_dir = torch.where(ok, pdf_dir_next, 0.0)
            p_prev = torch.where(ok[:, None], isect.p, p_prev)
            active = ok
        # Reverse pdfs in area measure: pdf_rev[i] is the density that
        # vertex i + 1 scatters back onto vertex i.
        for i, v in enumerate(verts):
            if i + 1 < len(verts):
                nxt = verts[i + 1]
                v["pdf_rev"] = torch.where(
                    nxt["valid"],
                    _to_area(nxt["rev_pdf_w"], nxt["p"], v["p"], v["ns"]), 0.0)
            else:
                v["pdf_rev"] = torch.zeros_like(v["pdf_fwd"])
        return verts

    # ---- the estimator -----------------------------------------------------

    def trace(self, scene, camera, wl, pixel, sample_idx, sampler,
              n_paths=None):
        """One BDPT sample per entry of `pixel` (sample_idx an int or (N,)).

        Returns (L (N, S) radiance of the t >= 2 strategies, splat
        (npix, 3) RGB film splats of the t == 1 strategies, normalised by
        N, N). n_paths is taken and, as in the reference, not read: the
        splats are normalised by the N paths of this call."""
        from ..render import camera_rays_full

        refuse_gradient(scene, "BDPTIntegrator")
        sampler = as_sampler(sampler)
        lights = scene.lights
        if lights.n_area + lights.n_sphl == 0:
            raise ValueError("BDPTIntegrator needs emissive geometry")
        lam = wl.lam
        n = pixel.shape[0]
        s_spec = lam.shape[-1]
        dev = lam.device
        nx, ny = camera.resolution
        npix = nx * ny
        d_max = self.max_depth
        # Camera subpath: x0 (the camera) and nt surface vertices; pbrt
        # makes maxDepth + 2 camera vertices, so the s = 0 strategy reaches
        # the unidirectional tracer's path length.
        nt = d_max + 1
        ns_ = d_max  # light vertices past y0: y1 .. y_ns_
        cam_p = camera.position
        a_film = camera.pixel_solid_angle_base() * npix
        false = torch.zeros((n,), dtype=torch.bool, device=dev)
        true = ~false

        # ---- camera subpath.
        o0, d0, _, _ = camera_rays_full(camera, pixel, sample_idx, sampler,
                                        n_spectrum=s_spec)
        cos0 = self._cam_cos(camera, d0)
        pdf_cam_dir = 1.0 / torch.clamp(a_film * cos0 ** 3, min=_EPS)
        X = self._walk(scene, o0, d0,
                       torch.ones((n, s_spec), dtype=torch.float32, device=dev),
                       pdf_cam_dir, cam_p.expand(n, 3), lam, pixel,
                       sample_idx, sampler, dim_base=8, n_steps=nt,
                       stop_at_light=False)

        # ---- light subpath origin y0 (emissive geometry, renormalised pmf).
        u_sel = sampler.get_1d(pixel, sample_idx, 1000)
        up0, up1 = sampler.get_2d(pixel, sample_idx, 1001)
        org = lights.sample_le_origin(u_sel, torch.stack([up0, up1], -1))
        pmf, y0_p, y0_n, area = org["pmf"], org["p"], org["n"], org["area"]
        le = eval_emission(org["coeffs"], org["scale"], org["illum"], lam)
        pdf_pos = pmf / torch.clamp(area, min=_EPS)  # area measure, selection
        beta_y0 = (1.0 / torch.clamp(pdf_pos, min=_EPS))[:, None]  # (n, 1)

        # Emission direction: cosine hemisphere about the light normal.
        ud0, ud1 = sampler.get_2d(pixel, sample_idx, 1002)
        lt1, lt2 = coordinate_system(y0_n)
        d_loc = sample_cosine_hemisphere(torch.stack([ud0, ud1], -1))
        y_d0 = from_local(d_loc, lt1, lt2, y0_n)
        cos_e = torch.abs(d_loc[:, 2])
        pdf_e_dir = cos_e * _INV_PI
        beta_y1 = beta_y0 * le * (cos_e / torch.clamp(pdf_e_dir, min=_EPS))[:, None]
        Y = self._walk(scene, offset_ray_origin(y0_p, y0_n, y_d0), y_d0,
                       beta_y1, pdf_e_dir, y0_p, lam, pixel, sample_idx,
                       sampler, dim_base=1004, n_steps=ns_, stop_at_light=True)
        # pdfRev of y0: y1 scattering back onto y0.
        if ns_ >= 1:
            rev_y0 = torch.where(
                Y[0]["valid"],
                _to_area(Y[0]["rev_pdf_w"], Y[0]["p"], y0_p, y0_n), 0.0)
        else:
            rev_y0 = torch.zeros((n,), dtype=torch.float32, device=dev)
        y0 = {"valid": true, "p": y0_p, "ng": y0_n, "ns": y0_n,
              "beta": beta_y0 * torch.ones((1, s_spec), device=dev),
              "pdf_fwd": pdf_pos, "pdf_rev": rev_y0, "delta": false}

        def xv(i):
            """Camera vertex x_i, i >= 1 (surface vertices)."""
            return X[i - 1]

        def yv(j):
            """Light vertex y_j; y_0 is the origin on the light."""
            return y0 if j == 0 else Y[j - 1]

        # ---- MIS weight (MISWeight, integrators.cpp:2541-2613).
        def mis_weight(s, t, rev_x_t1, rev_x_t2, rev_y_s1, rev_y_s2):
            """rev_*: the strategy's remapped endpoint reverse densities
            (None keeps the stored value)."""
            sum_ri = torch.zeros((n,), dtype=torch.float32, device=dev)
            ri = torch.ones((n,), dtype=torch.float32, device=dev)
            for i in range(t - 1, 0, -1):
                if i == t - 1 and rev_x_t1 is not None:
                    rev = rev_x_t1
                elif i == t - 2 and rev_x_t2 is not None:
                    rev = rev_x_t2
                else:
                    rev = xv(i)["pdf_rev"]
                ri = ri * _remap0(rev) / _remap0(xv(i)["pdf_fwd"])
                d_im1 = xv(i - 1)["delta"] if i - 1 >= 1 else false
                sum_ri = sum_ri + torch.where(~xv(i)["delta"] & ~d_im1, ri, 0.0)
            ri = torch.ones((n,), dtype=torch.float32, device=dev)
            for i in range(s - 1, -1, -1):
                if i == s - 1 and rev_y_s1 is not None:
                    rev = rev_y_s1
                elif i == s - 2 and rev_y_s2 is not None:
                    rev = rev_y_s2
                else:
                    rev = yv(i)["pdf_rev"]
                ri = ri * _remap0(rev) / _remap0(yv(i)["pdf_fwd"])
                # i - 1 == -1 is the light itself: area lights are not
                # delta distributions.
                d_im1 = yv(i - 1)["delta"] if i - 1 >= 0 else false
                sum_ri = sum_ri + torch.where(~yv(i)["delta"] & ~d_im1, ri, 0.0)
            w = 1.0 / (1.0 + sum_ri)
            return torch.ones_like(w) if self.disable_mis else w

        # The emissive-geometry tables (area triangles, then analytic
        # spheres) in light-id order, for PdfLightOrigin.
        ne = lights.n_area + lights.n_sphl
        pmf_e = lights.select_pmf[:ne]
        pmf_e = pmf_e / torch.clamp(torch.sum(pmf_e), min=1e-12)
        areas_e = torch.cat([lights.area_area,
                             4.0 * math.pi * lights.sphl_r ** 2])

        def light_origin_pdf(light_idx):
            """Area density of a light subpath starting on light
            `light_idx` (PdfLightOrigin)."""
            i = torch.clamp(light_idx, 0, ne - 1)
            return torch.where(light_idx >= 0,
                               pmf_e[i] / torch.clamp(areas_e[i], min=_EPS),
                               0.0)

        def record(s, t, term):
            if self.debug_sink is not None:
                self.debug_sink[(s, t)] = term

        L = torch.zeros((n, s_spec), dtype=torch.float32, device=dev)

        # ===== s == 0: the camera path alone hits a light.
        for t in range(2, nt + 2):
            v = t - 1
            xvv = xv(v)
            val = xvv["valid"] & (xvv["light"] >= 0)
            wo = -xvv["d_in"]
            contrib = xvv["beta"] * lights.emitted(xvv["light"], xvv["ng"], wo,
                                                    lam)
            # Remaps: x[t-1].pdfRev <- PdfLightOrigin; x[t-2].pdfRev <- the
            # emission's direction density onto x[t-2].
            rev_t1 = light_origin_pdf(xvv["light"])
            rev_t2 = None
            if t >= 3:
                pdf_dir = torch.abs(dot(xvv["ng"], wo)) * _INV_PI
                rev_t2 = _to_area(pdf_dir, xvv["p"], xv(v - 1)["p"],
                                  xv(v - 1)["ns"])
            w = mis_weight(0, t, rev_t1, rev_t2, None, None)
            term = torch.where(val[:, None], contrib * w[:, None], 0.0)
            record(0, t, term)
            L = L + term

        # ===== t >= 2, s >= 1: surface-to-surface connections.
        for s in range(1, ns_ + 2):
            for t in range(2, nt + 2):
                if s + t > d_max + 2:
                    continue
                vx, vy = t - 1, s - 1
                X_, Y_ = xv(vx), yv(vy)
                val = X_["valid"] & (X_["light"] < 0) & Y_["valid"]
                px_, py_ = X_["p"], Y_["p"]
                d2 = _dist2(px_, py_)
                w_xy = _dir_to(px_, py_)  # x -> y

                # The camera end's BSDF.
                xns = X_["ns"]
                xt1, xt2 = coordinate_system(xns)
                wo_x = to_local(-X_["d_in"], xt1, xt2, xns)
                wi_x = to_local(w_xy, xt1, xt2, xns)
                f_x = bxdf.evaluate(X_["params"], wo_x, wi_x, lam)

                # The light end's factor.
                yns = Y_["ns"]
                if vy == 0:
                    # Emission toward x (one-sided).
                    f_y = torch.where((dot(y0_n, -w_xy) > 0.0)[:, None], le,
                                      0.0)
                else:
                    yt1, yt2 = coordinate_system(yns)
                    wo_y = to_local(-Y_["d_in"], yt1, yt2, yns)
                    wi_y = to_local(-w_xy, yt1, yt2, yns)
                    f_y = bxdf.evaluate(Y_["params"], wo_y, wi_y, lam)

                g = (torch.abs(dot(xns, w_xy)) * torch.abs(dot(yns, w_xy))
                     / torch.clamp(d2, min=_EPS))
                contrib = X_["beta"] * f_x * g[:, None] * f_y * Y_["beta"]
                need = val & torch.any(contrib != 0.0, dim=-1)
                # Two-ended robust segment (SpawnRayTo): each end offset off
                # its own surface, then re-aimed.
                so = offset_ray_origin(px_, X_["ng"], w_xy)
                seg = offset_ray_origin(py_, Y_["ng"], -w_xy) - so
                seg_len = torch.clamp(torch.sqrt(torch.sum(seg * seg, dim=-1)),
                                      min=1e-20)
                occ = accel_api.any_hit(
                    scene,
                    torch.where(need[:, None], so, torch.zeros_like(so) + 1e8),
                    seg / seg_len[:, None],
                    torch.where(need, seg_len * (1.0 - 1e-3), 0.0))
                ok = need & ~occ

                # Endpoint remaps. x[t-1].pdfRev <- the density y[s-1]
                # sends toward x[t-1].
                if vy == 0:
                    rev_x_t1 = _to_area(torch.abs(dot(y0_n, w_xy)) * _INV_PI,
                                        py_, px_, xns)
                else:
                    rev_x_t1 = _bsdf_pdf_area(Y_["params"], yns, py_,
                                              Y_["d_in"], px_, xns)
                # x[t-2].pdfRev <- x[t-1], reached from y, scattering back
                # to x[t-2].
                rev_x_t2 = None
                if t >= 3:
                    rev_x_t2 = _scatter_back_area(
                        X_["params"], xns, px_, w_xy, xv(vx - 1)["p"],
                        xv(vx - 1)["ns"])
                # y[s-1].pdfRev <- the density x[t-1] scatters toward y[s-1].
                rev_y_s1 = _bsdf_pdf_area(X_["params"], xns, px_, X_["d_in"],
                                          py_, yns)
                # y[s-2].pdfRev <- y[s-1], reached from x, scattering toward
                # y[s-2].
                rev_y_s2 = None
                if s >= 2:
                    rev_y_s2 = _scatter_back_area(
                        Y_["params"], yns, py_, -w_xy, yv(vy - 1)["p"],
                        yv(vy - 1)["ns"])
                w = mis_weight(s, t, rev_x_t1, rev_x_t2, rev_y_s1, rev_y_s2)
                term = torch.where(ok[:, None], contrib * w[:, None], 0.0)
                record(s, t, term)
                L = L + term

        # ===== t == 1: light vertices splat onto the camera.
        splat = torch.zeros((npix + 1, 3), dtype=torch.float32, device=dev)
        for s in range(1, ns_ + 2):
            vy = s - 1
            Y_ = yv(vy)
            py_, yns = Y_["p"], Y_["ns"]
            to_c = cam_p[None, :] - py_
            d2 = torch.clamp(torch.sum(to_c * to_c, dim=-1), min=1e-12)
            wi_c = to_c / torch.sqrt(d2)[:, None]
            if vy == 0:
                # s == 1: the light origin seen by the camera: how pbrt's
                # BDPT renders directly visible emitters
                # (integrators.cpp:2680-2720).
                f_y = torch.where((dot(y0_n, wi_c) > 0.0)[:, None], le, 0.0)
            else:
                yt1, yt2 = coordinate_system(yns)
                f_y = bxdf.evaluate(Y_["params"],
                                    to_local(-Y_["d_in"], yt1, yt2, yns),
                                    to_local(wi_c, yt1, yt2, yns), lam)
            radiance = Y_["beta"] * f_y
            cos_p = torch.abs(dot(yns, wi_c))
            occ = accel_api.any_hit(scene, offset_ray_origin(py_, Y_["ng"], wi_c),
                                    wi_c, torch.sqrt(d2) * (1.0 - 1e-3))
            ok = Y_["valid"] & ~occ & torch.any(radiance != 0.0, dim=-1)

            # Remaps: y[s-1].pdfRev <- the camera's direction density;
            # y[s-2].pdfRev <- y[s-1], reached from the camera, backward.
            _, cos_c, _ = camera.project(py_)
            pdf_cam = 1.0 / torch.clamp(
                a_film * torch.clamp(cos_c, min=1e-4) ** 3, min=_EPS)
            rev_y_s1 = _to_area(pdf_cam, cam_p.expand_as(py_), py_, yns)
            rev_y_s2 = None
            if vy >= 1:
                rev_y_s2 = _scatter_back_area(Y_["params"], yns, py_, wi_c,
                                              yv(vy - 1)["p"],
                                              yv(vy - 1)["ns"])
            w_mis = mis_weight(s, 1, None, None, rev_y_s1, rev_y_s2)
            splat = splat_add(splat, camera, py_, spectrum_to_rgb(radiance, wl),
                              cos_p, d2, n, ok, mis=w_mis)
        return L, splat[:npix], n

    @staticmethod
    def _cam_cos(camera, d_world):
        """cos(theta) of world directions against the camera's axis."""
        m = camera.camera_to_world.m
        fwd = camera.camera_to_world.apply_vector(
            torch.tensor([[0.0, 0.0, 1.0]], dtype=m.dtype, device=m.device))[0]
        return torch.clamp(dot(d_world, fwd), min=1e-4)


def render_bdpt(scene, camera, spp: int = 16, max_depth: int = 5,
                seed: int = 0, samples_per_pass: int = 1,
                sampler_kind: str = "independent",
                n_spectrum: int = spectrum.N_SPECTRUM_DEFAULT, *, device):
    """A BDPT render on `device`: per-pixel strategies plus t = 1 splats,
    averaged over spp samples. A pass traces samples_per_pass samples of
    every pixel as one batch; the draws are keyed on (pixel, sample), so
    each sample's values are those of a pass of one sample, and only the
    order of the film's sum changes."""
    from ..render import on_device

    if spp % samples_per_pass != 0:
        raise ValueError("spp must divide by samples_per_pass")
    require_pinhole(camera, "BDPT")
    scene, camera = on_device(scene, camera, device)
    integ = BDPTIntegrator(max_depth=max_depth)
    nx, ny = camera.resolution
    npix = nx * ny
    k = samples_per_pass
    sampler = Sampler(seed=int(seed), kind=sampler_kind, spp=spp, nx=nx)
    dev = scene.geom.tri_verts.device
    pixel = torch.arange(npix, dtype=torch.int64, device=dev).repeat(k)
    acc = None
    for first in range(0, spp, k):
        sample = torch.arange(first, first + k, dtype=torch.int64,
                              device=dev).repeat_interleave(npix)
        wl = spectrum.sample_visible(sampler.get_1d(pixel, sample, 4),
                                     n_spectrum)
        L, splat, _ = integ.trace(scene, camera, wl, pixel, sample, sampler)
        rgb = spectrum_to_rgb(L, wl).reshape(k, ny, nx, 3).sum(dim=0)
        img = rgb + splat.reshape(ny, nx, 3) * k
        acc = img if acc is None else acc + img
    return acc / spp
