"""Path integrator: NEE + MIS + Russian roulette over a fixed bounce loop.

Port of pbrt_tpu/models/path.py: the primal transport, the subsurface
step, its default gradient path, `grad_mode="remat"`, and tag-sorted
shading (materials/sorted.py, on by the reference's
`sorted_shading="auto"` rule; no record/replay or animated instances).
The reference's lax.scan over bounces is a Python loop here; all rays
advance in lockstep and terminated rays are masked, not compacted, so
every bounce issues the same queries as the reference: one closest-hit
and one any-hit per bounce, plus the terminal closest-hit, and, when the
geometry references a subsurface material, the subsurface probe's
closest-hit on every lane of every bounce (materials/bssrdf.py).

Gradients (the reference's detached-sampling estimator): they flow only
through BSDF values, emission and light radiance at fixed hit points. The
queries carry none (ops/detach.py); frames, sampled directions and pdfs
are detached where the reference stops them. The reference's
`save_only_these_names("trav")` remat becomes `torch.utils.checkpoint`
around the shading between the queries, two segments per bounce split at
the shadow query: the backward pass recomputes shading only and never
re-runs a query. Only the leaves of DEFAULT_TRAINABLE may require grad,
and not on a scene whose geometry references a hair, subsurface,
measured, mix or retroreflective material (FORWARD_ONLY_KINDS); any
other request raises NotImplementedError (ROADMAP Queue 1 item 5).

RNG dimension layout (per ray; stateless pcg4d streams, core/rng.py):
  dims 0-7            camera: pixel jitter (0,1), lens (2,3), wavelength (4)
  dims 8 + 8*depth +  0      light selection
                      1      light point (2D)
                      2      bsdf lobe selection
                      3      bsdf direction (2D)
                      4      russian roulette
                      5, 6   subsurface probe radius and angle
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from ..accel import api as accel_api
from ..accel.dense import offset_ray_origin, shadow_segment
from ..core import rgb2spec
from ..core.sampling import power_heuristic
from ..core.tensorclass import static_field, tensorclass
from ..core.vecmath import dot, from_local, shading_frame, to_local
from ..materials import bxdf
from ..materials import scattering as sc
from ..materials.bssrdf import subsurface_exit
from ..materials.buffers import (
    MAT_HAIR,
    MAT_MEASURED,
    MAT_MIX,
    MAT_NORMFRESNEL,
    MAT_RETRO,
    MAT_SUBSURFACE,
)

_CAM_DIMS = 8
_BOUNCE_DIMS = 8

# Scene leaves a gradient may be asked of (pbrt_tpu/parallel/train.py
# DEFAULT_TRAINABLE): the reference's answer for any other leaf is either
# not finite (conductor roughness) or not the same on every backend.
DEFAULT_TRAINABLE = ("materials.albedo_coeffs", "lights.area_scale")
_ITEM5 = "ROADMAP Queue 1 item 5"
# Material kinds whose gradients are not ported: a gradient request on a
# scene whose geometry references one raises.
FORWARD_ONLY_KINDS = frozenset(
    {MAT_HAIR, MAT_SUBSURFACE, MAT_MEASURED, MAT_MIX, MAT_RETRO})


def refuse_forward_only(scene) -> None:
    """Raise for a gradient request on a scene whose geometry references a
    material kind of FORWARD_ONLY_KINDS."""
    kinds = sorted(scene.shaded_kinds & FORWARD_ONLY_KINDS)
    if kinds:
        raise NotImplementedError(
            f"the geometry references material kind(s) {kinds} (hair 7, "
            "subsurface 8, measured 9, mix 10, retroreflective 11), whose "
            f"gradients are not ported ({_ITEM5}); render under "
            "torch.no_grad()")


def refuse_gradient(scene, integrator: str) -> None:
    """Raise when autograd is on and a floating tensor of the scene
    requires grad: the light-tracing and specialty integrators (light
    path, BDPT, SPPM, MLT, AO, random walk, spectral bands) are forward
    only."""
    if not torch.is_grad_enabled():
        return
    for name, x in _tensors(scene, "scene"):
        if x.is_floating_point() and x.requires_grad:
            raise NotImplementedError(
                f"{name} requires grad: gradients through {integrator} are "
                f"not ported ({_ITEM5}); render under torch.no_grad()")


def _tensors(value, name: str):
    """(path, tensor) of every tensor in a nest of tensorclasses."""
    if isinstance(value, torch.Tensor):
        yield name, value
    elif dataclasses.is_dataclass(value):
        for f in dataclasses.fields(value):
            yield from _tensors(getattr(value, f.name), f"{name}.{f.name}")


def _gradient_requested(scene, o, d, wl) -> bool:
    """True when autograd is on and a DEFAULT_TRAINABLE leaf of the scene
    requires grad. Raises for a request on any other floating tensor of the
    scene, on o, d or the wavelengths: the port has no answer for them
    that is held against the reference."""
    if not torch.is_grad_enabled():
        return False
    for name, x in [("o", o), ("d", d), *_tensors(wl, "wl")]:
        if x.is_floating_point() and x.requires_grad:
            raise NotImplementedError(
                f"{name} requires grad: gradients with respect to rays and "
                f"wavelengths are not ported ({_ITEM5}); trace under "
                "torch.no_grad() or without a grad request"
            )
    asked = False
    for name, x in _tensors(scene, "scene"):
        if x.is_floating_point() and x.requires_grad:
            if name.removeprefix("scene.") not in DEFAULT_TRAINABLE:
                raise NotImplementedError(
                    f"{name} requires grad: only {DEFAULT_TRAINABLE} have "
                    f"ported gradients ({_ITEM5})"
                )
            asked = True
    if asked:
        refuse_forward_only(scene)
    return asked


def _frame(isect):
    """The shading frame (t1, t2, ns, wo_l): the geometric normal flipped
    toward wo (no shading normals), its tangents and wo in it."""
    cos_o = dot(isect.n, isect.wo, keepdims=True)
    ns = isect.n * torch.sign(torch.where(cos_o == 0.0, 1.0, cos_o))
    t1, t2 = shading_frame(ns, isect.dpdu)
    return t1, t2, ns, to_local(isect.wo, t1, t2, ns)


def _subsurface_step(scene, isect, frame, params, hit, beta, lam, u_r, u_phi):
    """SeparableBSSRDF::Sample_S (bssrdf.h, wavefront/subsurface.cpp) at
    the hit lanes of a subsurface material: the Fresnel transmission at
    the entry, the Burley diffusion to a probed exit vertex, and the
    vertex, its frame and its wo (the exit normal) moved there; the
    lane's kind becomes MAT_NORMFRESNEL, the exit lobe that NEE and BSDF
    sampling then shade. Every lane issues the probe. Returns (beta,
    isect, frame, params, subsurface lane count)."""
    t1, t2, ns, wo_l = frame
    is_ss = hit & (params["kind"] == MAT_SUBSURFACE)
    albedo = rgb2spec.eval_sigmoid(params["albedo_coeffs"], lam)
    mfp = rgb2spec.eval_unbounded(params["ss_mfp_coeffs"],
                                  params["ss_mfp_scale"], lam)
    p_exit, n_exit, w_ss, _ = subsurface_exit(
        scene, isect, ns, t1, t2, albedo, mfp[..., 0], u_r, u_phi)
    fr_in = sc.fr_dielectric(torch.abs(wo_l[..., 2]), params["eta"])
    beta = torch.where(is_ss[..., None],
                       beta * w_ss * (1.0 - fr_in)[..., None], beta)
    m = is_ss[:, None]
    new_n = torch.where(m, n_exit, isect.n)
    isect = isect.replace(
        p=torch.where(m, p_exit, isect.p),
        n=new_n,
        wo=torch.where(m, new_n, isect.wo),
        dpdu=torch.where(m, torch.zeros_like(isect.dpdu), isect.dpdu),
    )
    params = dict(params, kind=torch.where(is_ss, MAT_NORMFRESNEL,
                                           params["kind"]))
    return (beta, isect, _frame(isect), params,
            torch.sum(is_ss.to(torch.float32)))


def _remat(fn, *args):
    """Run a shading segment so that its backward recomputes it instead of
    keeping its activations (the reference's remat). A segment draws no
    random numbers (its draws are inputs), so no RNG state is kept and the
    recompute is bit-equal to the forward."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False
    )


def _direct(fn, *args):
    return fn(*args)


def _bsdf_calls(params, ops):
    """The BxDF calls of one shading point: the BSDF sample and, with a
    light sample's direction ops["wi"], NEE's f and pdf."""
    out = {"bs": bxdf.sample(params, ops["wo"], params["lam"], ops["u2"],
                             ops["uc"])}
    if "wi" in ops:
        out["f_nee"] = bxdf.evaluate(params, ops["wo"], ops["wi"],
                                     params["lam"])
        out["pdf_b"] = bxdf.pdf(params, ops["wo"], ops["wi"])
    return out


@tensorclass
class PathIntegrator:
    max_depth: int = static_field(default=5)
    rr_start_depth: int = static_field(default=2)
    use_nee: bool = static_field(default=True)
    use_mis: bool = static_field(default=True)
    # The reference's gradient switches. Only its default gradient path is
    # ported (replay_grad with grad_mode "remat", whose remat is the
    # checkpointing below); another choice raises when a gradient is asked.
    replay_grad: bool = static_field(default=True)
    replay_remat: str = static_field(default="full")
    grad_mode: str = static_field(default="remat")
    # Tag-sorted shading dispatch (materials/sorted.py): True, False or
    # "auto", which sorts when the scene's material list holds a costly
    # family (coated, hair, measured, subsurface), as the reference's rule
    # does; batches of at most sort_tile lanes are never sorted.
    sorted_shading: object = static_field(default="auto")
    sort_tile: int = static_field(default=8192)

    def __post_init__(self):
        if self.grad_mode not in ("remat", "cvjp"):
            raise ValueError(f"unknown grad_mode {self.grad_mode!r}")
        if self.replay_remat not in ("full", "dots", "none"):
            raise ValueError(f"unknown replay_remat {self.replay_remat!r}")
        if self.sorted_shading not in (True, False, "auto"):
            raise ValueError(
                f"unknown sorted_shading {self.sorted_shading!r}")

    def sorts_shading(self, scene) -> bool:
        """Whether the BxDF calls go through the tag-sorted dispatch."""
        if self.sorted_shading != "auto":
            return bool(self.sorted_shading)
        m = scene.materials
        return bool(m.any_coated or m.any_hair or m.any_measured
                    or m.any_subsurface)

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
        tensor, counted as the reference counts it, once per pass also
        when a backward pass follows).
        """
        from ..samplers.samplers import as_sampler

        return self._run(scene, o, d, wl, pixel, sample_idx,
                         as_sampler(sampler))

    def _check_grad_mode(self) -> None:
        if (not self.replay_grad or self.grad_mode != "remat"
                or self.replay_remat != "full"):
            raise NotImplementedError(
                f"gradients with replay_grad={self.replay_grad}, "
                f"grad_mode={self.grad_mode!r}, replay_remat="
                f"{self.replay_remat!r} are not ported ({_ITEM5}); only "
                "the default remat path is"
            )

    def _run(self, scene, o, d, wl, pixel, sample_idx, sampler):
        medium = getattr(scene, "medium", None)
        if ((medium is not None and not medium.is_none)
                or getattr(scene, "media_stack", None) is not None):
            # The reference's path integrator ignores the media silently.
            raise ValueError("the scene has participating media; render it "
                             "with models/volpath.py's VolPathIntegrator")
        grad = _gradient_requested(scene, o, d, wl)
        if grad:
            self._check_grad_mode()
        segment = _remat if grad else _direct
        n = o.shape[0]
        s = wl.lam.shape[-1]
        lam = wl.lam
        dev, f32 = o.device, o.dtype
        lights = scene.lights
        have_lights = lights.n_lights > 0
        do_nee = self.use_nee and have_lights
        subsurface = MAT_SUBSURFACE in scene.shaded_kinds
        if self.sorts_shading(scene):
            from ..materials.sorted import shade_sorted

            def dispatch(params, ops):
                return shade_sorted(params, ops, _bsdf_calls,
                                    tile=self.sort_tile)
        else:
            dispatch = _bsdf_calls

        L = torch.zeros((n, s), dtype=f32, device=dev)
        beta = torch.ones((n, s), dtype=f32, device=dev)
        active = torch.ones((n,), dtype=torch.bool, device=dev)
        # The previous vertex: BSDF pdf, specular flag, point and shading
        # normal (MIS context); all carry no gradient.
        prev = (
            torch.ones((n,), dtype=f32, device=dev),
            torch.ones((n,), dtype=torch.bool, device=dev),
            o,
            torch.zeros((n, 3), dtype=f32, device=dev),
        )
        rays = torch.zeros((), dtype=torch.float32, device=dev)

        def mis_weights(isect, active, d_cur, o_cur, prev):
            """Where emission and escaped radiance count, and their MIS
            weights against NEE from the previous vertex: geometry, which
            the reference saves (its MIS pdfs hold no trainable)."""
            prev_pdf, specular, prev_p, prev_ns = prev
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
            emit_mask = active & isect.valid & (isect.light >= 0)
            return emit_mask, w_l, active & ~isect.valid, w_esc

        def add_emission(L, beta, isect, d_cur, o_cur, weights):
            """Emitted radiance at area-light hits and escaped radiance."""
            emit_mask, w_l, escaped, w_esc = weights
            le = lights.emitted(isect.light, isect.n, isect.wo, lam)
            L = L + torch.where(emit_mask[..., None], beta * w_l[..., None] * le, 0.0)
            return L + torch.where(
                escaped[..., None],
                beta * w_esc[..., None] * lights.escaped_radiance(d_cur, lam, o_cur),
                0.0,
            )

        def shade(L, beta, isect, d, o, weights, frame, u, params=None):
            """First segment of a bounce, between the closest-hit (or the
            subsurface step, which adds the emission and gathers params
            itself) and the shadow query: emission, the light sample, the
            BSDF sample and the NEE contribution. Live outputs: L, contrib
            and bs["f"]. Its inputs and every other output are detached
            geometry (the frame, the draws, the light sample's direction,
            pdf and distance, the sampled direction and pdf), as the
            reference stops them."""
            if weights is not None:
                L = add_emission(L, beta, isect, d, o, weights)
            t1, t2, ns, wo_l = frame
            if params is None:
                params = bxdf.surface_params(scene, isect, lam)
            ops = {"wo": wo_l, "u2": u["bsdf"], "uc": u["lobe"]}
            if do_nee:
                ls = lights.sample_li(isect.p, lam, u["sel"], u["pos"], n_ref=ns)
                ls = ls.replace(wi=ls.wi.detach(), pdf=ls.pdf.detach(),
                                dist=ls.dist.detach())
                wi_l = to_local(ls.wi, t1, t2, ns)
                ops["wi"] = wi_l
            # One shading dispatch for the BSDF sample and NEE's f and pdf.
            sh = dispatch(params, ops)
            bs = sh["bs"]
            bs = dict(bs, wi=bs["wi"].detach(), pdf=bs["pdf"].detach())
            out = {"L": L, "bs": bs}

            # Next-event estimation (integrators.cpp SampleLd).
            if do_nee:
                f_nee = sh["f_nee"] * torch.abs(wi_l[..., 2:3])
                pdf_b = sh["pdf_b"]
                if self.use_mis:
                    w_nee = torch.where(
                        ls.is_delta, 1.0, power_heuristic(1, ls.pdf, 1, pdf_b)
                    )
                else:
                    w_nee = torch.ones_like(ls.pdf)
                out["contrib"] = torch.where(
                    (ls.pdf > 0.0)[..., None],
                    beta * f_nee * ls.L
                    * (w_nee / torch.clamp(ls.pdf, min=1e-20))[..., None],
                    0.0,
                )
                out["ls"] = ls
            return out

        def scatter(L, beta, contrib, f, unoccluded, ok, cos_wi, pdf, rr):
            """Second segment of a bounce, after the shadow query: the NEE
            contribution of unoccluded lanes, the throughput update and
            Russian roulette (its decision on detached throughput)."""
            if contrib is not None:
                L = L + torch.where(unoccluded[..., None], contrib, 0.0)
            beta = torch.where(
                ok[..., None],
                beta * f * (cos_wi / torch.clamp(pdf, min=1e-20))[..., None],
                beta,
            )
            # Russian roulette on spectral max throughput
            # (integrators.cpp:750-758). Below rr_start_depth it is the
            # identity (kill never, scale 1), so it is skipped.
            kill = None
            if rr is not None:
                q = torch.clamp(1.0 - torch.amax(beta.detach(), dim=-1), 0.0, 0.95)
                kill = (rr < q) & ok
                scale = torch.where(ok, 1.0 / torch.clamp(1.0 - q, min=0.05), 1.0)
                beta = torch.where(kill[..., None], 0.0, beta * scale[..., None])
            return L, beta, kill

        for depth in range(self.max_depth):
            n_rays = rays + torch.sum(active.to(torch.float32))
            # Dead lanes get tmax = 0 and fail every hit gate.
            isect = accel_api.closest(
                scene, o, d, tmax=torch.where(active, float("inf"), 0.0)
            )
            weights = mis_weights(isect, active, d, o, prev) if have_lights else None
            hit = active & isect.valid

            # Shading frame and the bounce's draws: no gradient reaches
            # them.
            frame = _frame(isect)
            dim0 = _CAM_DIMS + depth * _BOUNCE_DIMS
            params = None
            if subsurface:
                # The emission at the entry, then the move to the exit;
                # the material row is the entry's. Outside the shading
                # segments, as the queries are (no gradient is asked).
                params = bxdf.surface_params(scene, isect, lam)
                if weights is not None:
                    L = add_emission(L, beta, isect, d, o, weights)
                    weights = None
                beta, isect, frame, params, n_ss = _subsurface_step(
                    scene, isect, frame, params, hit, beta, lam,
                    sampler.get_1d(pixel, sample_idx, dim0 + 5),
                    sampler.get_1d(pixel, sample_idx, dim0 + 6))
                n_rays = n_rays + n_ss
            t1, t2, ns, _ = frame
            u = {}
            if do_nee:
                u["sel"] = sampler.get_1d(pixel, sample_idx, dim0 + 0)
                up0, up1 = sampler.get_2d(pixel, sample_idx, dim0 + 1)
                u["pos"] = torch.stack([up0, up1], dim=-1)
            u["lobe"] = sampler.get_1d(pixel, sample_idx, dim0 + 2)
            ub0, ub1 = sampler.get_2d(pixel, sample_idx, dim0 + 3)
            u["bsdf"] = torch.stack([ub0, ub1], dim=-1)

            sh = segment(shade, L, beta, isect, d, o, weights, frame, u,
                         params)
            bs = sh["bs"]
            unoccluded = contrib = None
            if do_nee:
                ls, contrib = sh["ls"], sh["contrib"]
                need_shadow = hit & (ls.pdf > 0.0) & torch.any(contrib != 0.0, dim=-1)
                so, wi_sh, smax = shadow_segment(isect.p, isect.n, ls.wi, ls.dist)
                occluded = accel_api.any_hit(
                    scene,
                    torch.where(need_shadow[..., None], so, torch.zeros_like(so) + 1e8),
                    wi_sh,
                    torch.where(need_shadow, smax, 0.0),
                )
                unoccluded = need_shadow & ~occluded
                n_rays = n_rays + torch.sum(need_shadow.to(torch.float32))

            # BSDF sampling -> next ray (integrators.cpp:736-758).
            wi_w = from_local(bs["wi"], t1, t2, ns)
            cos_wi = torch.abs(bs["wi"][..., 2])
            ok = hit & (bs["pdf"] > 0.0)
            rr = None
            if depth >= self.rr_start_depth:
                rr = sampler.get_1d(pixel, sample_idx, dim0 + 4)
            L, beta, kill = segment(scatter, sh["L"], beta, contrib, bs["f"],
                                    unoccluded, ok, cos_wi, bs["pdf"], rr)
            o_new = offset_ray_origin(isect.p, isect.n, wi_w)
            o = torch.where(ok[..., None], o_new, o)
            d = torch.where(ok[..., None], wi_w, d)
            prev_pdf, specular, prev_p, prev_ns = prev
            prev = (
                torch.where(ok, bs["pdf"], prev_pdf),
                torch.where(ok, bs["specular"], specular),
                torch.where(ok[..., None], isect.p, prev_p),
                torch.where(ok[..., None], ns, prev_ns),
            )
            active = ok if kill is None else ok & ~kill
            rays = n_rays

        # Terminal emission tier: the reference's depth loop adds Le at the
        # (max_depth+1)-th vertex before breaking, so BSDF-sampled light
        # hits one segment past the last NEE still contribute their MIS
        # complement (integrators.cpp "if (depth++ == maxDepth) break;").
        # Plain autograd, as in the reference.
        if have_lights:
            isect = accel_api.closest(
                scene, o, d, tmax=torch.where(active, float("inf"), 0.0)
            )
            L = add_emission(L, beta, isect, d, o,
                             mis_weights(isect, active, d, o, prev))
            rays = rays + torch.sum(active.to(torch.float32))
        return L, {"rays": rays}
