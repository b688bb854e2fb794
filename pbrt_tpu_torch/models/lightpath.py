"""Light-path (adjoint / particle) integrator: trace from the lights and
splat onto the camera (port of pbrt_tpu/models/lightpath.py;
LightPathIntegrator, integrators.h:322 of pbrt-v4).

Every path starts at an emission sample over the emissive geometry
(LightBuffers.sample_le_origin) and every vertex connects to the pinhole
with a film splat: the adjoint half of BDPT. All paths advance in lockstep;
the reference's lax.scan over bounces is a Python loop. A connection
projects the vertex with PerspectiveCamera.project and adds into a flat
(npix + 1, 3) splat buffer (index_add_; the invalid connections land in
the trash slot npix). The measure:

  pixel_value = (1/Omega_j) * int_{A visible in pixel j} L(p->cam)
                * cos(theta_p) / r^2 dA
  Omega_j = pixel_area(z=1 plane) * cos^3(theta_cam)

so each connection splats beta * f * V * cos_p / (r^2 * Omega_j * N).
On the card index_add_ adds with atomics, so the last bits of a pixel's
sum vary from run to run; card and CPU are held within a tolerance.
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
from .path import _frame, refuse_gradient


def splat_rows(camera, p, rgb, cos_p, r2, n_paths, ok, mis=None):
    """The film rows of connections to the pinhole: (pixel (N,), RGB (N,
    3)) of `rgb` arriving from points p, with the light-tracing measure
    (module docstring) and an optional MIS weight (N,); lanes not `ok` or
    outside the film get the trash row npix and zero."""
    nx, ny = camera.resolution
    npix = nx * ny
    praster, cos_c, inside = camera.project(p)
    ok = ok & inside
    omega = camera.pixel_solid_angle_base() * torch.clamp(cos_c, min=1e-4) ** 3
    w = cos_p / (r2 * omega * n_paths)
    if mis is not None:
        w = w * mis
    contrib = torch.where(ok[:, None], rgb * w[:, None], 0.0)
    pix = (torch.clamp(praster[:, 1].to(torch.int64), 0, ny - 1) * nx
           + torch.clamp(praster[:, 0].to(torch.int64), 0, nx - 1))
    return torch.where(ok, pix, npix), contrib


def splat_add(splat, camera, *args, **kw):
    """splat_rows added into the flat splat buffer (npix + 1, 3)."""
    pix, contrib = splat_rows(camera, *args, **kw)
    return splat.index_add(0, pix, contrib)


@tensorclass
class LightPathIntegrator:
    max_depth: int = static_field(default=5)

    def render_splats(self, scene, camera, n_paths: int, wl, sample_idx,
                      sampler):
        """Trace n_paths light paths; returns the (ny, nx, 3) splat image,
        whose expectation is the forward-rendered image."""
        refuse_gradient(scene, "LightPathIntegrator")
        sampler = as_sampler(sampler)
        lights = scene.lights
        if lights.n_area + lights.n_sphl == 0:
            raise ValueError("LightPathIntegrator needs emissive geometry")
        nx, ny = camera.resolution
        npix = nx * ny
        n = n_paths
        dev = wl.lam.device
        path_id = torch.arange(n, dtype=torch.int64, device=dev)
        lam = wl.lam
        cam_p = camera.position
        splat = torch.zeros((npix + 1, 3), dtype=torch.float32, device=dev)

        def connect(splat, p, n_geo, radiance_fn, active):
            """Splat the radiance leaving p toward the camera."""
            to_c = cam_p[None, :] - p
            r2 = torch.clamp(torch.sum(to_c * to_c, dim=-1), min=1e-12)
            wi_c = to_c / torch.sqrt(r2)[:, None]
            cos_p = torch.abs(dot(n_geo, wi_c))
            rgb = spectrum_to_rgb(radiance_fn(wi_c), wl)
            so = offset_ray_origin(p, n_geo, wi_c)
            occ = accel_api.any_hit(scene, so, wi_c,
                                    torch.sqrt(r2) * (1.0 - 1e-3))
            return splat_add(splat, camera, p, rgb, cos_p, r2, n,
                             active & ~occ)

        # Emission sampling (DiffuseAreaLight::SampleLe).
        u_sel = sampler.get_1d(path_id, sample_idx, 1000)
        up0, up1 = sampler.get_2d(path_id, sample_idx, 1001)
        org = lights.sample_le_origin(u_sel, torch.stack([up0, up1], -1))
        pmf, p0, n_l, area = org["pmf"], org["p"], org["n"], org["area"]
        le = eval_emission(org["coeffs"], org["scale"], org["illum"], lam)

        # Depth 0: the light surface seen directly by the camera; beta of a
        # surface point sampled with pdf pmf / area.
        beta0 = (area / torch.clamp(pmf, min=1e-12))[:, None]
        splat = connect(
            splat, p0, n_l,
            lambda wi: torch.where((dot(n_l, wi) > 0.0)[:, None], le, 0.0)
            * beta0,
            torch.ones((n,), dtype=torch.bool, device=dev))

        # Emission direction: cosine about the light normal; beta = Le cos
        # / (pdf_pos pdf_dir) = Le pi area / pmf.
        ud0, ud1 = sampler.get_2d(path_id, sample_idx, 1002)
        t1, t2 = coordinate_system(n_l)
        d = from_local(sample_cosine_hemisphere(torch.stack([ud0, ud1], -1)),
                       t1, t2, n_l)
        beta = le * (math.pi * area / torch.clamp(pmf, min=1e-12))[:, None]
        o = offset_ray_origin(p0, n_l, d)
        active = torch.ones((n,), dtype=torch.bool, device=dev)

        for depth in range(self.max_depth):
            isect = accel_api.closest(scene, o, d)
            hit = active & isect.valid & (isect.light < 0)
            t1b, t2b, ns, wo_l = _frame(isect)
            params = bxdf.surface_params(scene, isect, lam)

            def radiance_fn(wi_c, beta=beta):
                wi_l = to_local(wi_c, t1b, t2b, ns)
                return beta * bxdf.evaluate(params, wo_l, wi_l, lam)

            splat = connect(splat, isect.p, isect.n, radiance_fn, hit)

            dim0 = 1004 + depth * 4
            uc = sampler.get_1d(path_id, sample_idx, dim0)
            ub0, ub1 = sampler.get_2d(path_id, sample_idx, dim0 + 1)
            bs = bxdf.sample(params, wo_l, lam, torch.stack([ub0, ub1], -1),
                             uc)
            wi_w = from_local(bs["wi"], t1b, t2b, ns)
            ok = hit & (bs["pdf"] > 0.0)
            cos_wi = torch.abs(bs["wi"][:, 2])
            beta = torch.where(
                ok[:, None],
                beta * bs["f"]
                * (cos_wi / torch.clamp(bs["pdf"], min=1e-20))[:, None],
                beta)
            o_new = offset_ray_origin(isect.p, isect.n, wi_w)
            o = torch.where(ok[:, None], o_new, o)
            d = torch.where(ok[:, None], wi_w, d)
            active = ok
        return splat[:npix].reshape(ny, nx, 3)


def render_lightpath(scene, camera, n_paths_total: int = 1 << 20,
                     max_depth: int = 5, seed: int = 0,
                     paths_per_pass: int = 1 << 16,
                     n_spectrum: int = spectrum.N_SPECTRUM_DEFAULT, *,
                     device):
    """Average max(1, n_paths_total // paths_per_pass) splat passes of
    paths_per_pass light paths into an image (ny, nx, 3) on `device`."""
    from ..render import on_device

    scene, camera = on_device(scene, camera, device)
    integ = LightPathIntegrator(max_depth=max_depth)
    sampler = Sampler(seed=int(seed), kind="independent", spp=1)
    n_pass = max(1, n_paths_total // paths_per_pass)
    path_id = torch.arange(paths_per_pass, dtype=torch.int64,
                           device=scene.geom.tri_verts.device)
    acc = None
    for s in range(n_pass):
        wl = spectrum.sample_visible(sampler.get_1d(path_id, s, 5), n_spectrum)
        img = integ.render_splats(scene, camera, paths_per_pass, wl, s,
                                  sampler)
        acc = img if acc is None else acc + img
    return acc / n_pass
