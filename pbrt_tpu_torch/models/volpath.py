"""Volumetric path integrator: null-scattering delta tracking + NEE.

Port of pbrt_tpu/models/volpath.py (VolPathIntegrator, pbrt-v4's
cpu/integrators.cpp:953-1250, and the SampleT_maj majorant walk,
media.h:734-800). The bounce loop is a Python loop over the whole ray
batch; the per-ray majorant walk is a masked loop of at most
max_null_steps steps, compacted to the live lanes at the stage
boundaries of ops/compact.py (bit-equal to the lockstep loop,
`compact_walks=False`). Tentative collisions classify into absorb, real
scatter and null by hero-wavelength probabilities, the other wavelengths
reweighted. The majorant is wavelength-independent (the max over the
ray's wavelengths times the max density), or the coarse cell's (the DDA
walk of grid media). Shadow-ray transmittance is ratio tracking with the
same majorants; across material-less interfaces (MAT_INTERFACE) a shadow
ray switches interior media and attenuates in closed form. Homogeneous
interior media (MediumStack) take closed-form free flight. As in the
reference there is no subsurface step: a subsurface surface shades with
the normalized-Fresnel exit lobe at its entry (materials/bxdf.py).

RNG dimension layout (per ray; stateless pcg4d streams, core/rng.py):
  dims 0-7               camera
  dims 8 + 512*depth +   0, 1     light selection and point (medium NEE)
                         2, 3     bsdf lobe and direction
                         4        russian roulette
                         5        phase function direction (2D)
                         6, 7     light selection and point (surface NEE)
                         30, 31   interior-medium free flight and event
                         32+2i, 33+2i  delta-tracking step i
                         200+i    ratio tracking, medium NEE
                         300+i    ratio tracking, surface NEE
  dims 8 + 512*max_depth + i      ratio tracking of the terminal segment
A walk hashes its steps' draws in one batched call per run of steps
(ops/compact.py), bit-equal to one get_1d per step.

Gradients (the reference's differentiable=True): the walks run as
fixed-length masked loops with no compaction; majorants are inflated x1.5
and detached, the absorption event folded into the null weight (pa = 0)
and the scatter probability detached, so gradients reach the medium's
sigma_a_scale and sigma_s_scale through the continuous weights. Those two
are the only trainables; any other gradient request, and any request with
differentiable=False, or on a scene whose geometry references a hair,
subsurface, measured, mix or retroreflective material, raises
NotImplementedError (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import torch

from ..accel import api as accel_api
from ..accel.dense import offset_ray_origin, shadow_segment
from ..core.sampling import power_heuristic
from ..core.tensorclass import static_field, tensorclass
from ..core.vecmath import dot, from_local, shading_frame, to_local
from ..materials import bxdf
from ..materials.buffers import (
    MAT_HAIR,
    MAT_INTERFACE,
    MAT_MEASURED,
    MAT_MIX,
    MAT_RETRO,
    MAT_SUBSURFACE,
)
from ..media import phase as ph
from ..media.medium import MED_KEEP
from ..ops.compact import masked_loop, staged_masked_loop
from .path import _ITEM5, _tensors

_CAM_DIMS = 8
_BOUNCE_DIMS = 512  # wide stride: walk iterations consume many dims
_BIG = 1e30

# The scene leaves a gradient may be asked of, with differentiable=True.
VOLPATH_TRAINABLE = ("medium.sigma_a_scale", "medium.sigma_s_scale")
# Material kinds whose gradients through the volumetric path have no gate
# (ROADMAP Queue 1 item 5e): a request on a scene whose geometry
# references one raises.
_UNGATED_KINDS = frozenset(
    {MAT_HAIR, MAT_SUBSURFACE, MAT_MEASURED, MAT_MIX, MAT_RETRO})


def _run_draws(sampler, dim0: int, stride: int):
    """draws(inputs, it0, m) for a walk whose step `it` reads `stride`
    consecutive dimensions from dim0 + stride * it: (n, m, stride), or
    (n, m) for stride 1."""

    def draws(inp, it0, m):
        u = sampler.get_1d_run(inp["pixel"], inp["sidx"],
                               dim0 + stride * it0, stride * m)
        return u if stride == 1 else u.reshape(u.shape[0], m, stride)

    return draws


@tensorclass
class VolPathIntegrator:
    max_depth: int = static_field(default=8)
    rr_start_depth: int = static_field(default=3)
    use_nee: bool = static_field(default=True)
    use_mis: bool = static_field(default=True)
    max_null_steps: int = static_field(default=64)
    max_tr_steps: int = static_field(default=64)
    # Per-cell DDA majorants for grid media (media.h:136-214) instead of
    # the single global majorant; False forces the global walk.
    use_dda: bool = static_field(default=True)
    # The fixed-length differentiable walks (see the module docstring).
    differentiable: bool = static_field(default=False)
    # Staged compaction of the forward walks; False runs them lockstep.
    # The two are bit-equal.
    compact_walks: bool = static_field(default=True)

    def _walk(self, body, inputs, state, mask_of, max_steps, draws):
        if self.differentiable:
            return masked_loop(body, inputs, state, max_steps, draws)
        return staged_masked_loop(body, inputs, state, mask_of, max_steps,
                                  draws=draws, compact=self.compact_walks)

    def _gradient_requested(self, scene, o, d, wl) -> bool:
        """True when autograd is on and a VOLPATH_TRAINABLE leaf requires
        grad under differentiable=True; any other request raises."""
        if not torch.is_grad_enabled():
            return False
        for name, x in [("o", o), ("d", d), *_tensors(wl, "wl")]:
            if x.is_floating_point() and x.requires_grad:
                raise NotImplementedError(
                    f"{name} requires grad: gradients with respect to rays "
                    f"and wavelengths are not ported ({_ITEM5})")
        asked = False
        for name, x in _tensors(scene, "scene"):
            if not (x.is_floating_point() and x.requires_grad):
                continue
            if not self.differentiable:
                raise NotImplementedError(
                    f"{name} requires grad: VolPathIntegrator differentiates "
                    "only with differentiable=True, as in the reference "
                    f"({_ITEM5})")
            if name.removeprefix("scene.") not in VOLPATH_TRAINABLE:
                raise NotImplementedError(
                    f"{name} requires grad: only {VOLPATH_TRAINABLE} have "
                    f"ported gradients through media ({_ITEM5})")
            asked = True
        kinds = sorted(scene.shaded_kinds & _UNGATED_KINDS)
        if asked and kinds:
            raise NotImplementedError(
                f"the geometry references material kind(s) {kinds} (hair 7, "
                "subsurface 8, measured 9, mix 10, retroreflective 11), "
                "whose gradients through the volumetric path have no gate "
                "(ROADMAP Queue 1 item 5e); render under torch.no_grad()")
        return asked

    def _majorants(self, med, lam):
        """(sigma_maj, sa_u, ss_u, lam_base, use_dda, ctab) of a walk
        through the scene-level medium."""
        sigma_maj = med.sigma_majorant(lam)
        if self.differentiable:
            # A sampling control, not a physical quantity: detached, all
            # parameter dependence goes through the continuous weights;
            # inflated so no wavelength sits at the majorant (a lane with
            # sigma_t == sigma_maj has null weight 0 and no gradient).
            sigma_maj = (1.5 * sigma_maj).detach()
        sa_u, ss_u = med.sigma_base(lam)
        use_dda = self.use_dda and med.kind in ("grid", "rgbgrid")
        if med.kind == "rgbgrid":
            # rgbgrid majorant cells are already in sigma units.
            lam_base = torch.ones(lam.shape[:-1], dtype=torch.float32,
                                  device=lam.device)
        else:
            lam_base = torch.amax(sa_u + ss_u, dim=-1)
        if self.differentiable:
            lam_base = (1.5 * lam_base).detach()
        # One row gather per density lookup (hoisted out of the walks).
        ctab = med.corner_table() if med.kind == "grid" else None
        return sigma_maj, sa_u, ss_u, lam_base, use_dda, ctab

    @staticmethod
    def _free_flight(med, inp, t, u, use_dda):
        """One tracking step's tentative collision: (t_new, crossed,
        majorant here)."""
        o_i, d_i, t1_i = inp["o"], inp["d"], inp["t1"]
        log_u = torch.log(torch.clamp(1.0 - u, min=1e-20))
        if use_dda:
            maj = med.majorant_local(o_i + t[..., None] * d_i, inp["lam_base"])
            t_exit = torch.minimum(med.cell_exit_t(o_i, d_i, t), t1_i)
            t_new = t - log_u / torch.clamp(maj, min=1e-20)
            crossed = (t_new >= t_exit) | (maj <= 0.0)
            return torch.where(crossed, t_exit, t_new), crossed, maj
        maj = inp["sigma_maj"]
        t_new = t - log_u / torch.clamp(maj, min=1e-20)
        return t_new, torch.zeros_like(t_new, dtype=torch.bool), maj

    @staticmethod
    def _sigma(med, inp, p, ctab):
        if ctab is not None:
            dens = med.density_at_fast(p, ctab)[..., None]
            return inp["sa_u"] * dens, inp["ss_u"] * dens
        return med.sigma_at(p, inp["lam"])

    # -- transmittance (ratio tracking; integrators.cpp SampleLd Tr loop) ----

    def _transmittance(self, scene, o, wi, dist, lam, pixel, sample_idx,
                       sampler, dim_base, check_occlusion=True):
        smax = torch.where(torch.isfinite(dist), dist * (1.0 - 1e-3), _BIG)
        if check_occlusion:
            occ = accel_api.any_hit(scene, o, wi, smax)
        else:
            # Occlusion (interface crossings included) is _shadow_tr's;
            # only the scene-level medium's factor is wanted here.
            occ = torch.zeros(o.shape[:-1], dtype=torch.bool, device=o.device)
        med = scene.medium
        tr = torch.ones_like(lam)
        if med is None or med.is_none:
            return torch.where(occ[..., None], 0.0, tr)

        t0, t1 = med.bounds_segment(o, wi, smax)
        sigma_maj, sa_u, ss_u, lam_base, use_dda, ctab = self._majorants(
            med, lam)

        def body(inp, it, st, u):
            t, tr, active = st["t"], st["tr"], st["active"]
            t_new, crossed, maj = self._free_flight(med, inp, t, u, use_dda)
            escaped = t_new >= inp["t1"]
            p = inp["o"] + t_new[..., None] * inp["d"]
            sa_p, ss_p = self._sigma(med, inp, p, ctab)
            sigma_n = torch.clamp(maj[..., None] - sa_p - ss_p, min=0.0)
            ratio = sigma_n / torch.clamp(maj[..., None], min=1e-20)
            step = active & ~escaped & ~crossed
            tr = torch.where(step[..., None], tr * ratio, tr)
            active = active & ~escaped
            return {"t": torch.where(active, t_new, t), "tr": tr,
                    "active": active}

        active0 = (t1 > t0) & ~occ
        if not use_dda:
            active0 = active0 & (sigma_maj > 0.0)
        inputs = {"o": o, "d": wi, "t1": t1, "pixel": pixel, "lam": lam,
                  "lam_base": lam_base, "sigma_maj": sigma_maj,
                  "sidx": sample_idx}
        if ctab is not None:
            inputs["sa_u"], inputs["ss_u"] = sa_u, ss_u
        state = {"t": t0, "tr": tr, "active": active0}
        state = self._walk(body, inputs, state, lambda st: st["active"],
                           self.max_tr_steps, _run_draws(sampler, dim_base, 1))
        return torch.where(occ[..., None], 0.0, state["tr"])

    def _shadow_tr(self, scene, o, wi, dist, med0, lam):
        """Shadow transmittance through material-less interface boundaries
        (VolPathIntegrator::SampleLd's Tr loop, pbrt-v4's shadow_Tr): a
        shadow ray crosses MAT_INTERFACE surfaces, switching its interior
        medium by the side crossed and attenuating each segment in closed
        form; any other material blocks. Four crossings at most, each a
        closest query (done lanes at tmax 0); a ray still walking after
        them counts as blocked. Returns (N, S), zero where blocked."""
        stack = scene.media_stack
        mats = scene.materials
        n = o.shape[0]
        dev = o.device
        remaining = torch.where(torch.isfinite(dist), dist * (1.0 - 1e-3), _BIG)
        o_c, med = o, med0
        tr = torch.ones_like(lam)
        blocked = torch.zeros((n,), dtype=torch.bool, device=dev)
        done = torch.zeros((n,), dtype=torch.bool, device=dev)
        for _ in range(4):
            active = ~done
            isect = accel_api.closest(scene, o_c, wi,
                                      torch.where(active, remaining, 0.0))
            hit = active & isect.valid
            seg = torch.where(hit, isect.t, remaining)
            sa, ss = stack.sigma_at_idx(med, lam)
            att = torch.exp(-(sa + ss) * torch.where(active, seg, 0.0)[..., None])
            tr = tr * torch.where(active[..., None], att, 1.0)
            mat = isect.mat.long()
            is_iface = mats.kind[mat] == MAT_INTERFACE
            blocked = blocked | (hit & ~is_iface)
            entering = torch.sum(wi * isect.n, dim=-1) < 0.0
            tgt = torch.where(entering, mats.med_inside[mat],
                              mats.med_outside[mat])
            crossed = hit & is_iface & ~blocked
            med = torch.where(crossed & (tgt != MED_KEEP), tgt, med)
            o_c = torch.where(hit[..., None],
                              offset_ray_origin(isect.p, isect.n, wi), o_c)
            remaining = torch.where(
                hit, torch.clamp(remaining - seg, min=0.0), 0.0)
            done = done | blocked | ~hit
        return torch.where((blocked | ~done)[..., None], 0.0, tr)

    # -- main loop -----------------------------------------------------------

    def trace(self, scene, o, d, wl, pixel, sample_idx, sampler):
        return self.trace_with_stats(scene, o, d, wl, pixel, sample_idx,
                                     sampler)[0]

    def trace_with_stats(self, scene, o, d, wl, pixel, sample_idx, sampler):
        """Estimate radiance along N camera rays: ((N, S) radiance,
        {"rays": live closest-hit + shadow queries, a 0-d tensor})."""
        from ..samplers.samplers import as_sampler

        self._gradient_requested(scene, o, d, wl)
        sampler = as_sampler(sampler)
        n = o.shape[0]
        s = wl.lam.shape[-1]
        lam = wl.lam
        dev, f32 = o.device, o.dtype
        sidx = torch.as_tensor(sample_idx, device=dev).expand(n)
        med = scene.medium
        stack = scene.media_stack
        have_medium = med is not None and not med.is_none
        have_stack = stack is not None
        have_any_medium = have_medium or have_stack
        lights = scene.lights
        have_lights = lights.n_lights > 0
        mats = scene.materials
        if have_medium:
            sigma_maj, sa_u, ss_u, lam_base, use_dda, ctab = self._majorants(
                med, lam)

        L = torch.zeros((n, s), dtype=f32, device=dev)
        beta = torch.ones((n, s), dtype=f32, device=dev)
        active = torch.ones((n,), dtype=torch.bool, device=dev)
        prev_pdf = torch.ones((n,), dtype=f32, device=dev)
        specular = torch.ones((n,), dtype=torch.bool, device=dev)
        prev_p = o
        prev_ns = torch.zeros((n, 3), dtype=f32, device=dev)
        # Per-ray interior-medium index (MediumStack; -1 = vacuum): rays
        # switch on transmission through interfaced surfaces.
        med_idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
        rays = torch.zeros((), dtype=torch.float32, device=dev)

        def mis(isect, d_cur, o_cur, prev_pdf, specular, prev_p, prev_ns):
            if self.use_mis and self.use_nee:
                light_pdf = lights.pdf_li_area(
                    isect.light, isect.t, dot(isect.n, isect.wo),
                    p_ref=prev_p, n_ref=prev_ns)
                w_l = torch.where(specular, 1.0,
                                  power_heuristic(1, prev_pdf, 1, light_pdf))
                w_esc = torch.where(specular, 1.0, power_heuristic(
                    1, prev_pdf, 1, lights.pdf_escaped(d_cur, o_cur)))
            elif self.use_nee:
                w_l = w_esc = torch.where(specular, 1.0, 0.0)
            else:
                w_l = w_esc = torch.ones_like(isect.t)
            return w_l, w_esc

        for depth in range(self.max_depth):
            dim0 = _CAM_DIMS + depth * _BOUNCE_DIMS
            n_rays = rays + torch.sum(active.to(torch.float32))
            isect = accel_api.closest(
                scene, o, d, tmax=torch.where(active, float("inf"), 0.0))
            t_surf = torch.where(isect.valid, isect.t, _BIG)

            # Medium interaction sampling (delta tracking). status: 0 =
            # passed through, 1 = real scatter, 2 = absorbed.
            if have_medium:
                t0, t1 = med.bounds_segment(o, d, t_surf)

                def wbody(inp, it, st, u):
                    t, beta_w = st["t"], st["beta"]
                    status, walking = st["status"], st["walking"]
                    u_d, u_e = u[:, 0], u[:, 1]
                    t_new, crossed, maj = self._free_flight(
                        med, inp, t, u_d, use_dda)
                    escaped = t_new >= inp["t1"]
                    p = inp["o"] + t_new[..., None] * inp["d"]
                    sa, ss = self._sigma(med, inp, p, ctab)
                    pa = sa[..., 0] / torch.clamp(maj, min=1e-20)
                    ps = ss[..., 0] / torch.clamp(maj, min=1e-20)
                    if self.differentiable:
                        # Absorption folded continuously into the null
                        # weight (a binary absorb event has no pathwise
                        # derivative); choice probabilities detached.
                        pa = torch.zeros_like(pa)
                        ps = ps.detach()
                    absorb = u_e < pa
                    scatter = (u_e >= pa) & (u_e < pa + ps)
                    null = ~absorb & ~scatter
                    # Double-where: the denominators are real only in the
                    # taken lanes, others read 1 (no 0 * inf cotangents).
                    pn = torch.clamp(1.0 - pa - ps, min=1e-20)
                    sigma_n = torch.clamp(maj[..., None] - sa - ss, min=0.0)
                    pn_s = torch.where(null, pn, 1.0)
                    ps_s = torch.where(scatter, torch.clamp(ps, min=1e-20), 1.0)
                    pa_s = torch.where(absorb, torch.clamp(pa, min=1e-20), 1.0)
                    w_null = sigma_n / (maj[..., None] * pn_s[..., None])
                    w_scat = ss / (maj[..., None] * ps_s[..., None])
                    w_abs = sa / (maj[..., None] * pa_s[..., None])
                    step = walking & ~escaped & ~crossed
                    beta_w = torch.where((step & null)[..., None],
                                         beta_w * w_null, beta_w)
                    beta_w = torch.where((step & scatter)[..., None],
                                         beta_w * w_scat, beta_w)
                    beta_w = torch.where((step & absorb)[..., None],
                                         beta_w * w_abs, beta_w)
                    status = torch.where(step & scatter, 1, status)
                    status = torch.where(step & absorb, 2, status)
                    walking = walking & ~escaped & (null | crossed)
                    t = torch.where(walking | step, t_new, t)
                    return {"t": t, "beta": beta_w, "status": status,
                            "walking": walking}

                walking0 = active & (t1 > t0)
                if have_stack:
                    # Rays inside a named interior medium take the
                    # closed-form step below, not the AABB walk.
                    walking0 = walking0 & (med_idx < 0)
                if not use_dda:
                    walking0 = walking0 & (sigma_maj > 0.0)
                winputs = {"o": o, "d": d, "t1": t1, "pixel": pixel,
                           "lam": lam, "lam_base": lam_base,
                           "sigma_maj": sigma_maj, "sidx": sidx}
                if ctab is not None:
                    winputs["sa_u"], winputs["ss_u"] = sa_u, ss_u
                wstate = {"t": t0, "beta": beta,
                          "status": torch.zeros((n,), dtype=torch.int32,
                                                device=dev),
                          "walking": walking0}
                wstate = self._walk(wbody, winputs, wstate,
                                    lambda st: st["walking"],
                                    self.max_null_steps,
                                    _run_draws(sampler, dim0 + 32, 2))
                t_event, beta = wstate["t"], wstate["beta"]
                status = wstate["status"]
                scattered = active & (status == 1)
                absorbed = active & (status == 2)
                p_med = o + t_event[..., None] * d
                # Volumetric emission on absorption (GridMedium Le).
                if med.emissive:
                    L = L + torch.where(absorbed[..., None],
                                        beta * med.le_at(p_med, lam), 0.0)
            else:
                scattered = torch.zeros((n,), dtype=torch.bool, device=dev)
                absorbed = torch.zeros((n,), dtype=torch.bool, device=dev)
                p_med = o

            # Interior media (MediumStack): homogeneous and shape-bounded,
            # so free flight is sampled in closed form on the hero
            # wavelength; the segment ends at the next surface.
            if have_stack:
                in_named = active & (med_idx >= 0)
                sa_nm, ss_nm = stack.sigma_at_idx(med_idx, lam)
                st_nm = sa_nm + ss_nm
                st_hero = st_nm[..., 0]
                u_t = sampler.get_1d(pixel, sample_idx, dim0 + 30)
                u_e = sampler.get_1d(pixel, sample_idx, dim0 + 31)
                dist_seg = torch.where(isect.valid, isect.t, _BIG)
                t_s = -torch.log(torch.clamp(1.0 - u_t, min=1e-20)) / \
                    torch.clamp(st_hero, min=1e-20)
                interact_n = in_named & (st_hero > 0.0) & (t_s < dist_seg)
                # The event by the hero single-scattering albedo.
                p_sc = ss_nm[..., 0] / torch.clamp(st_hero, min=1e-20)
                scatter_n = interact_n & (u_e < p_sc)
                absorb_n = interact_n & ~scatter_n
                # The other wavelengths reweighted against the hero pdf:
                # exp(-sigma_l t) / exp(-sigma_h t), 1 on the hero lane.
                t_used = torch.minimum(t_s, dist_seg)
                atten = torch.exp(-(st_nm - st_hero[..., None])
                                  * t_used[..., None])
                w_scat_n = atten * ss_nm / torch.clamp(ss_nm[..., 0:1],
                                                       min=1e-20)
                beta = torch.where(scatter_n[..., None], beta * w_scat_n, beta)
                passed_n = in_named & ~interact_n
                beta = torch.where(passed_n[..., None], beta * atten, beta)
                scattered = scattered | scatter_n
                absorbed = absorbed | absorb_n
                p_med = torch.where(scatter_n[..., None],
                                    o + t_s[..., None] * d, p_med)
            else:
                in_named = torch.zeros((n,), dtype=torch.bool, device=dev)

            reach_surface = active & ~scattered & ~absorbed

            # Surface emission and escape, as PathIntegrator.
            hit = reach_surface & isect.valid
            if have_lights:
                w_l, w_esc = mis(isect, d, o, prev_pdf, specular, prev_p,
                                 prev_ns)
                le = lights.emitted(isect.light, isect.n, isect.wo, lam)
                emit_mask = hit & (isect.light >= 0)
                L = L + torch.where(emit_mask[..., None],
                                    beta * w_l[..., None] * le, 0.0)
                escaped_rays = reach_surface & ~isect.valid
                L = L + torch.where(
                    escaped_rays[..., None],
                    beta * w_esc[..., None]
                    * lights.escaped_radiance(d, lam, o), 0.0)

            # Per-ray phase asymmetry: an interior medium's g overrides
            # the scene-level medium's.
            if have_any_medium:
                g_eff = (med.g if have_medium
                         else torch.zeros((), dtype=f32, device=dev))
                g_eff = g_eff.expand(n)
                if have_stack:
                    g_eff = torch.where(in_named, stack.g_at(med_idx), g_eff)

            # NEE from medium scatter points.
            if self.use_nee and have_lights and have_any_medium:
                u_sel = sampler.get_1d(pixel, sample_idx, dim0 + 0)
                up0, up1 = sampler.get_2d(pixel, sample_idx, dim0 + 1)
                ls = lights.sample_li(p_med, lam, u_sel,
                                      torch.stack([up0, up1], dim=-1))
                p_phase = ph.hg_pdf(-d, ls.wi, g_eff)
                if have_stack:
                    tr = self._shadow_tr(scene, p_med, ls.wi, ls.dist,
                                         med_idx, lam)
                    if have_medium:
                        tr = tr * self._transmittance(
                            scene, p_med, ls.wi, ls.dist, lam, pixel, sidx,
                            sampler, dim0 + 200, check_occlusion=False)
                else:
                    tr = self._transmittance(scene, p_med, ls.wi, ls.dist,
                                             lam, pixel, sidx, sampler,
                                             dim0 + 200)
                if self.use_mis:
                    w_nee = torch.where(ls.is_delta, 1.0,
                                        power_heuristic(1, ls.pdf, 1, p_phase))
                else:
                    w_nee = torch.ones_like(ls.pdf)
                contrib = (beta * p_phase[..., None] * tr * ls.L
                           * (w_nee / torch.clamp(ls.pdf, min=1e-20))[..., None])
                ok = scattered & (ls.pdf > 0.0)
                L = L + torch.where(ok[..., None], contrib, 0.0)
                n_rays = n_rays + torch.sum(ok.to(torch.float32))

            # Phase-function sampling for scattered rays (f / pdf = 1).
            if have_any_medium:
                u0, u1 = sampler.get_2d(pixel, sample_idx, dim0 + 5)
                wi_med, pdf_ph = ph.hg_sample(-d, torch.stack([u0, u1], -1),
                                              g_eff)
            else:
                wi_med = d
                pdf_ph = torch.ones((n,), dtype=f32, device=dev)

            # Surface shading: the BxDF select chain in lockstep.
            cos_o = dot(isect.n, isect.wo, keepdims=True)
            ns = isect.n * torch.sign(torch.where(cos_o == 0.0, 1.0, cos_o))
            t1f, t2f = shading_frame(ns, isect.dpdu)
            wo_l = to_local(isect.wo, t1f, t2f, ns)
            params = bxdf.surface_params(scene, isect, lam)
            if have_stack:
                mat = isect.mat.long()
                gi_mat, go_mat = mats.med_inside[mat], mats.med_outside[mat]

            if self.use_nee and have_lights:
                u_sel = sampler.get_1d(pixel, sample_idx, dim0 + 6)
                up0, up1 = sampler.get_2d(pixel, sample_idx, dim0 + 7)
                ls = lights.sample_li(isect.p, lam, u_sel,
                                      torch.stack([up0, up1], dim=-1),
                                      n_ref=ns)
                wi_l = to_local(ls.wi, t1f, t2f, ns)
                f_nee = bxdf.evaluate(params, wo_l, wi_l, lam) * torch.abs(
                    wi_l[..., 2:3])
                pdf_b = bxdf.pdf(params, wo_l, wi_l)
                if self.use_mis:
                    w_nee = torch.where(ls.is_delta, 1.0,
                                        power_heuristic(1, ls.pdf, 1, pdf_b))
                else:
                    w_nee = torch.ones_like(ls.pdf)
                so, wi_sh, smax_sh = shadow_segment(isect.p, isect.n, ls.wi,
                                                    ls.dist)
                if have_stack:
                    # The shadow ray starts in the medium on its own side
                    # of the surface (MED_KEEP: the ray's medium), then
                    # _shadow_tr crosses interfaces.
                    side = torch.where(dot(ls.wi, isect.n) < 0.0, gi_mat,
                                       go_mat)
                    side = torch.where(side == MED_KEEP, med_idx, side)
                    tr = self._shadow_tr(scene, so, wi_sh, smax_sh, side, lam)
                    if have_medium:
                        tr = tr * self._transmittance(
                            scene, so, wi_sh, smax_sh, lam, pixel, sidx,
                            sampler, dim0 + 300, check_occlusion=False)
                else:
                    tr = self._transmittance(scene, so, wi_sh, smax_sh, lam,
                                             pixel, sidx, sampler, dim0 + 300)
                contrib = (beta * f_nee * tr * ls.L
                           * (w_nee / torch.clamp(ls.pdf, min=1e-20))[..., None])
                ok = hit & (ls.pdf > 0.0)
                L = L + torch.where(ok[..., None], contrib, 0.0)
                n_rays = n_rays + torch.sum(ok.to(torch.float32))

            uc = sampler.get_1d(pixel, sample_idx, dim0 + 2)
            ub0, ub1 = sampler.get_2d(pixel, sample_idx, dim0 + 3)
            bs = bxdf.sample(params, wo_l, lam, torch.stack([ub0, ub1], -1), uc)
            wi_w = from_local(bs["wi"], t1f, t2f, ns)
            cos_wi = torch.abs(bs["wi"][..., 2])
            surf_ok = hit & (bs["pdf"] > 0.0)
            beta = torch.where(
                surf_ok[..., None],
                beta * bs["f"]
                * (cos_wi / torch.clamp(bs["pdf"], min=1e-20))[..., None],
                beta)

            # The next ray by status.
            o_surf = offset_ray_origin(isect.p, isect.n, wi_w)
            o_new = torch.where(scattered[..., None], p_med, o_surf)
            d_new = torch.where(scattered[..., None], wi_med, wi_w)
            next_active = (surf_ok | scattered) & ~absorbed
            new_pdf = torch.where(scattered, pdf_ph,
                                  torch.where(surf_ok, bs["pdf"], prev_pdf))
            specular = torch.where(scattered, False,
                                   torch.where(surf_ok, bs["specular"],
                                               specular))
            prev_pdf = new_pdf

            # Medium switch on transmission: crossing to the far side of
            # an interfaced surface adopts that side's medium (the shape's
            # outward orientation defines inside).
            if have_stack:
                transmitted = surf_ok & (bs["wi"][..., 2] < 0.0)
                entering = dot(wi_w, isect.n) < 0.0
                tgt_med = torch.where(entering, gi_mat, go_mat)
                med_idx = torch.where(transmitted & (tgt_med != MED_KEEP),
                                      tgt_med, med_idx)

            o = torch.where(next_active[..., None], o_new, o)
            d = torch.where(next_active[..., None], d_new, d)
            prev_p = torch.where(
                next_active[..., None],
                torch.where(scattered[..., None], p_med, isect.p), prev_p)
            prev_ns = torch.where(
                (next_active & ~scattered)[..., None], ns,
                torch.where(next_active[..., None], 0.0, prev_ns))
            active = next_active
            rays = n_rays

            # Russian roulette on the spectral max throughput.
            if depth >= self.rr_start_depth:
                u_rr = sampler.get_1d(pixel, sample_idx, dim0 + 4)
                q = torch.clamp(1.0 - torch.amax(beta.detach(), dim=-1),
                                0.0, 0.95)
                kill = (u_rr < q) & active
                scale = torch.where(active,
                                    1.0 / torch.clamp(1.0 - q, min=0.05), 1.0)
                beta = torch.where(kill[..., None], 0.0,
                                   beta * scale[..., None])
                active = active & ~kill

        # Terminal emission tier (the reference's "Le then break" depth
        # semantics): rays alive after the last bounce add the MIS-weighted
        # emission of what they hit or escape to, times the ratio-tracked
        # transmittance of the last segment (equal in expectation to the
        # in-loop null-collision walk).
        if have_lights:
            isect = accel_api.closest(scene, o, d)
            hit = active & isect.valid
            le = lights.emitted(isect.light, isect.n, isect.wo, lam)
            w_l, w_esc = mis(isect, d, o, prev_pdf, specular, prev_p, prev_ns)
            if have_medium:
                seg = torch.where(isect.valid, isect.t, float("inf"))
                tr = self._transmittance(
                    scene, o, d, seg, lam, pixel, sidx, sampler,
                    _CAM_DIMS + self.max_depth * _BOUNCE_DIMS)
            else:
                tr = torch.ones_like(beta)
            emit_mask = hit & (isect.light >= 0)
            L = L + torch.where(emit_mask[..., None],
                                beta * tr * w_l[..., None] * le, 0.0)
            escaped_rays = active & ~isect.valid
            L = L + torch.where(
                escaped_rays[..., None],
                beta * tr * w_esc[..., None]
                * lights.escaped_radiance(d, lam, o), 0.0)
            rays = rays + torch.sum(active.to(torch.float32))
        return L, {"rays": rays}
