"""Ambient-occlusion, random-walk and simple-path integrators (port of
pbrt_tpu/models/ao.py; AOIntegrator, integrators.h:296,
RandomWalkIntegrator, :115, and SimplePathIntegrator, :183, of pbrt-v4).
They trace camera rays through render() like PathIntegrator; the
reference's lax.scan over bounces is a Python loop.
"""

from __future__ import annotations

import torch

from ..accel import api as accel_api
from ..accel.dense import offset_ray_origin
from ..core.sampling import (
    UNIFORM_SPHERE_PDF,
    sample_cosine_hemisphere,
    sample_uniform_sphere,
)
from ..core.tensorclass import static_field, tensorclass
from ..core.vecmath import coordinate_system, from_local, to_local
from ..materials import bxdf
from ..samplers.samplers import as_sampler
from .path import PathIntegrator, _frame, refuse_gradient


def SimplePathIntegrator(max_depth: int = 5, sample_lights: bool = True,
                         sample_bsdf: bool = True) -> PathIntegrator:
    """pbrt's SimplePath: path tracing without MIS (integrators.h:183).
    sample_bsdf is taken and, as in the reference, not read: the path
    always continues by sampling the BSDF."""
    return PathIntegrator(max_depth=max_depth, use_nee=sample_lights,
                          use_mis=False, rr_start_depth=10**6)


@tensorclass
class AOIntegrator:
    """Cosine-weighted ambient occlusion (integrators.h:296)."""

    max_distance: float = static_field(default=1e30)
    illuminant_scale: float = static_field(default=1.0)

    def trace(self, scene, o, d, wl, pixel, sample_idx, sampler):
        return self.trace_with_stats(scene, o, d, wl, pixel, sample_idx,
                                     sampler)[0]

    def trace_with_stats(self, scene, o, d, wl, pixel, sample_idx, sampler):
        refuse_gradient(scene, "AOIntegrator")
        sampler = as_sampler(sampler)
        n = o.shape[0]
        s = wl.lam.shape[-1]
        isect = accel_api.closest(scene, o, d)
        _, _, ns, _ = _frame(isect)
        t1, t2 = coordinate_system(ns)
        u0, u1 = sampler.get_2d(pixel, sample_idx, 8)
        wi = from_local(sample_cosine_hemisphere(torch.stack([u0, u1], -1)),
                        t1, t2, ns)
        occluded = accel_api.any_hit(
            scene, offset_ray_origin(isect.p, isect.n, wi), wi,
            torch.full((n,), self.max_distance, dtype=o.dtype,
                       device=o.device))
        # The estimator: (cos / pi) / pdf (= cos / pi) * visibility.
        vis = (~occluded & isect.valid).to(o.dtype)
        L = (vis * self.illuminant_scale)[:, None].expand(n, s)
        return L, {"rays": torch.tensor(2.0 * n, device=o.device)}


@tensorclass
class RandomWalkIntegrator:
    """Uniform-sphere random walk without NEE, the teaching and
    correctness oracle (integrators.h:115)."""

    max_depth: int = static_field(default=5)

    def trace(self, scene, o, d, wl, pixel, sample_idx, sampler):
        return self.trace_with_stats(scene, o, d, wl, pixel, sample_idx,
                                     sampler)[0]

    def trace_with_stats(self, scene, o, d, wl, pixel, sample_idx, sampler):
        refuse_gradient(scene, "RandomWalkIntegrator")
        sampler = as_sampler(sampler)
        n = o.shape[0]
        lam = wl.lam
        lights = scene.lights
        L = torch.zeros((n, lam.shape[-1]), dtype=o.dtype, device=o.device)
        beta = torch.ones_like(L)
        active = torch.ones((n,), dtype=torch.bool, device=o.device)
        for depth in range(self.max_depth):
            isect = accel_api.closest(scene, o, d)
            hit = active & isect.valid
            le = lights.emitted(isect.light, isect.n, isect.wo, lam)
            L = L + torch.where((hit & (isect.light >= 0))[:, None],
                                beta * le, 0.0)
            escaped = active & ~isect.valid
            L = L + torch.where(escaped[:, None],
                                beta * lights.escaped_radiance(d, lam, o), 0.0)
            t1, t2, ns, wo_l = _frame(isect)
            params = bxdf.surface_params(scene, isect, lam)
            u0, u1 = sampler.get_2d(pixel, sample_idx, 8 + depth * 4)
            wi = sample_uniform_sphere(torch.stack([u0, u1], -1))
            wi_l = to_local(wi, t1, t2, ns)
            f = bxdf.evaluate(params, wo_l, wi_l, lam)
            cosw = torch.abs(wi_l[:, 2])
            beta = torch.where(hit[:, None],
                               beta * f * (cosw / UNIFORM_SPHERE_PDF)[:, None],
                               beta)
            o_new = offset_ray_origin(isect.p, isect.n, wi)
            o = torch.where(hit[:, None], o_new, o)
            d = torch.where(hit[:, None], wi, d)
            active = hit
        return L, {"rays": torch.tensor(float(n * self.max_depth),
                                        device=o.device)}
