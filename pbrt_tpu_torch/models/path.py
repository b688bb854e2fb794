"""Path integrator: NEE + MIS + Russian roulette over a fixed bounce loop.

Port of pbrt_tpu/models/path.py, the primal transport (`_run` without
record/replay/remat, subsurface, sorted shading or animated instances).
The reference's lax.scan over bounces is a Python loop here; all rays
advance in lockstep and terminated rays are masked, not compacted, so
every bounce issues the same queries as the reference: one closest-hit and
one any-hit per bounce, plus the terminal closest-hit.

RNG dimension layout (per ray; stateless pcg4d streams, core/rng.py):
  dims 0-7            camera: pixel jitter (0,1), lens (2,3), wavelength (4)
  dims 8 + 8*depth +  0      light selection
                      1      light point (2D)
                      2      bsdf lobe selection
                      3      bsdf direction (2D)
                      4      russian roulette
"""

from __future__ import annotations

import torch

from ..accel import api as accel_api
from ..accel.dense import offset_ray_origin, shadow_segment
from ..core.sampling import power_heuristic
from ..core.tensorclass import static_field, tensorclass
from ..core.vecmath import dot, from_local, shading_frame, to_local
from ..materials import bxdf

_CAM_DIMS = 8
_BOUNCE_DIMS = 8


@tensorclass
class PathIntegrator:
    max_depth: int = static_field(default=5)
    rr_start_depth: int = static_field(default=2)
    use_nee: bool = static_field(default=True)
    use_mis: bool = static_field(default=True)

    def trace(self, scene, o, d, wl, pixel, sample_idx, sampler):
        """Estimate radiance along N camera rays. Returns (N, S)."""
        return self.trace_with_stats(
            scene, o, d, wl, pixel, sample_idx, sampler
        )[0]

    def trace_with_stats(self, scene, o, d, wl, pixel, sample_idx, sampler):
        """Estimate radiance along N camera rays.

        o, d: (N, 3); wl: SampledWavelengths (N, S); pixel: (N,) ids;
        sample_idx: (N,) or scalar; sampler: a Sampler or an int seed.
        Returns ((N, S) radiance, stats) where stats["rays"] is the number
        of closest-hit + shadow queries actually alive (a 0-d float32
        tensor, counted as the reference counts it).
        """
        from ..samplers.samplers import as_sampler

        return self._run(scene, o, d, wl, pixel, sample_idx,
                         as_sampler(sampler))

    def _run(self, scene, o, d, wl, pixel, sample_idx, sampler):
        n = o.shape[0]
        s = wl.lam.shape[-1]
        lam = wl.lam
        dev, f32 = o.device, o.dtype
        lights = scene.lights
        have_lights = lights.n_lights > 0
        do_nee = self.use_nee and have_lights

        L = torch.zeros((n, s), dtype=f32, device=dev)
        beta = torch.ones((n, s), dtype=f32, device=dev)
        active = torch.ones((n,), dtype=torch.bool, device=dev)
        prev_pdf = torch.ones((n,), dtype=f32, device=dev)
        specular = torch.ones((n,), dtype=torch.bool, device=dev)
        prev_p = o
        prev_ns = torch.zeros((n, 3), dtype=f32, device=dev)
        rays = torch.zeros((), dtype=torch.float32, device=dev)

        def add_emission(L, isect, active, d_cur, o_cur):
            """Emitted radiance at area-light hits and escaped radiance, MIS
            weighted against NEE from the previous vertex (prev_*)."""
            hit = active & isect.valid
            le = lights.emitted(isect.light, isect.n, isect.wo, lam)
            if self.use_mis and self.use_nee:
                light_pdf = lights.pdf_li_area(
                    isect.light, isect.t, dot(isect.n, isect.wo),
                    p_ref=prev_p, n_ref=prev_ns,
                )
                esc_pdf = lights.pdf_escaped(d_cur, o_cur)
                w_l = torch.where(
                    specular, 1.0, power_heuristic(1, prev_pdf, 1, light_pdf)
                )
                w_esc = torch.where(
                    specular, 1.0, power_heuristic(1, prev_pdf, 1, esc_pdf)
                )
            elif self.use_nee:
                w_l = w_esc = torch.where(specular, 1.0, 0.0)
            else:
                w_l = w_esc = torch.ones_like(isect.t)
            emit_mask = hit & (isect.light >= 0)
            L = L + torch.where(emit_mask[..., None], beta * w_l[..., None] * le, 0.0)
            escaped = active & ~isect.valid
            return L + torch.where(
                escaped[..., None],
                beta * w_esc[..., None] * lights.escaped_radiance(d_cur, lam, o_cur),
                0.0,
            )

        for depth in range(self.max_depth):
            n_rays = rays + torch.sum(active.to(torch.float32))
            # Dead lanes get tmax = 0 and fail every hit gate.
            isect = accel_api.closest(
                scene, o, d, tmax=torch.where(active, float("inf"), 0.0)
            )
            hit = active & isect.valid
            if have_lights:
                L = add_emission(L, isect, active, d, o)
            active = hit

            # Shading frame (shading normal == geometric normal, flipped
            # toward wo).
            cos_o = dot(isect.n, isect.wo, keepdims=True)
            ns = isect.n * torch.sign(torch.where(cos_o == 0.0, 1.0, cos_o))
            t1, t2 = shading_frame(ns, isect.dpdu)
            wo_l = to_local(isect.wo, t1, t2, ns)
            params = bxdf.surface_params(scene, isect, lam)
            dim0 = _CAM_DIMS + depth * _BOUNCE_DIMS

            if do_nee:
                u_sel = sampler.get_1d(pixel, sample_idx, dim0 + 0)
                up0, up1 = sampler.get_2d(pixel, sample_idx, dim0 + 1)
                ls = lights.sample_li(
                    isect.p, lam, u_sel, torch.stack([up0, up1], dim=-1),
                    n_ref=ns,
                )
                wi_l = to_local(ls.wi, t1, t2, ns)
            uc = sampler.get_1d(pixel, sample_idx, dim0 + 2)
            ub0, ub1 = sampler.get_2d(pixel, sample_idx, dim0 + 3)
            bs = bxdf.sample(params, wo_l, lam, torch.stack([ub0, ub1], dim=-1), uc)

            # Next-event estimation (integrators.cpp SampleLd).
            if do_nee:
                f_nee = bxdf.evaluate(params, wo_l, wi_l, lam) * torch.abs(wi_l[..., 2:3])
                pdf_b = bxdf.pdf(params, wo_l, wi_l)
                if self.use_mis:
                    w_nee = torch.where(
                        ls.is_delta, 1.0, power_heuristic(1, ls.pdf, 1, pdf_b)
                    )
                else:
                    w_nee = torch.ones_like(ls.pdf)
                contrib = torch.where(
                    (ls.pdf > 0.0)[..., None],
                    beta * f_nee * ls.L
                    * (w_nee / torch.clamp(ls.pdf, min=1e-20))[..., None],
                    0.0,
                )
                need_shadow = active & (ls.pdf > 0.0) & torch.any(contrib != 0.0, dim=-1)
                so, wi_sh, smax = shadow_segment(isect.p, isect.n, ls.wi, ls.dist)
                occluded = accel_api.any_hit(
                    scene,
                    torch.where(need_shadow[..., None], so, torch.zeros_like(so) + 1e8),
                    wi_sh,
                    torch.where(need_shadow, smax, 0.0),
                )
                L = L + torch.where((need_shadow & ~occluded)[..., None], contrib, 0.0)
                n_rays = n_rays + torch.sum(need_shadow.to(torch.float32))

            # BSDF sampling -> next ray (integrators.cpp:736-758).
            wi_w = from_local(bs["wi"], t1, t2, ns)
            cos_wi = torch.abs(bs["wi"][..., 2])
            ok = active & (bs["pdf"] > 0.0)
            beta = torch.where(
                ok[..., None],
                beta * bs["f"] * (cos_wi / torch.clamp(bs["pdf"], min=1e-20))[..., None],
                beta,
            )
            o_new = offset_ray_origin(isect.p, isect.n, wi_w)
            o = torch.where(ok[..., None], o_new, o)
            d = torch.where(ok[..., None], wi_w, d)
            prev_pdf = torch.where(ok, bs["pdf"], prev_pdf)
            specular = torch.where(ok, bs["specular"], specular)
            prev_p = torch.where(ok[..., None], isect.p, prev_p)
            prev_ns = torch.where(ok[..., None], ns, prev_ns)
            active = ok
            rays = n_rays

            # Russian roulette on spectral max throughput
            # (integrators.cpp:750-758). Below rr_start_depth it is the
            # identity (kill never, scale 1), so it is skipped.
            if depth >= self.rr_start_depth:
                u_rr = sampler.get_1d(pixel, sample_idx, dim0 + 4)
                q = torch.clamp(1.0 - torch.amax(beta, dim=-1), 0.0, 0.95)
                kill = (u_rr < q) & active
                scale = torch.where(active, 1.0 / torch.clamp(1.0 - q, min=0.05), 1.0)
                beta = torch.where(kill[..., None], 0.0, beta * scale[..., None])
                active = active & ~kill

        # Terminal emission tier: the reference's depth loop adds Le at the
        # (max_depth+1)-th vertex before breaking, so BSDF-sampled light
        # hits one segment past the last NEE still contribute their MIS
        # complement (integrators.cpp "if (depth++ == maxDepth) break;").
        if have_lights:
            isect = accel_api.closest(
                scene, o, d, tmax=torch.where(active, float("inf"), 0.0)
            )
            L = add_emission(L, isect, active, d, o)
            rays = rays + torch.sum(active.to(torch.float32))
        return L, {"rays": rays}
