"""SPPM: stochastic progressive photon mapping (port of
pbrt_tpu/models/sppm.py; SPPMIntegrator, integrators.h:472-510 and
integrators.cpp:3292-3740 of pbrt-v4).

Per iteration: (1) a camera pass traces one path per pixel, adding direct
light and emission into Ld and recording a visible point (position, BSDF,
throughput) at the first non-specular vertex; (2) a photon pass traces
paths from the lights and deposits flux on the visible points within each
pixel's search radius; (3) the per-pixel statistics (n, r, tau) contract
the radius (gamma = 2/3). Both passes share one hero-wavelength sample per
iteration, so the flux and the visible points' throughput live in the same
spectral basis.

The range query is the reference's sorted dense table: each visible point
emits up to 8 (cell hash, pixel) entries covering its radius's bounding
box (cell edge 2 x the largest radius, so a box spans at most 2 cells per
axis), the table is sorted by hash (a stable sort, as jnp.argsort is), and
each photon finds its cell's entries with two binary searches
(searchsorted left and right) and scans at most K candidates in table
order. The reference scans the K slots one by one over every photon; here
the (K, photons) slots are laid out k-major, the live ones gathered once,
and their flux added by one index_add_ in the reference's order (on the
CPU; on the card index_add_ adds Phi with atomics, so its last bits vary
from run to run; M is an integer count and exact).

The reference's documented departures stay: visible points at any
non-delta vertex, photons from emissive geometry only, K = 32 candidates a
cell with overflow counted, not hidden.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..accel import api as accel_api
from ..accel.dense import offset_ray_origin, shadow_segment
from ..core import rng, spectrum
from ..core.sampling import power_heuristic, sample_cosine_hemisphere
from ..core.tensorclass import static_field, tensorclass
from ..core.vecmath import coordinate_system, dot, from_local, to_local
from ..films.rgb import spectrum_to_rgb
from ..lights.buffers import eval_emission
from ..materials import bxdf
from .path import _frame, refuse_gradient

# Material tables shared by every ray (not per-ray rows) in the params.
_SHARED = ("measured_coeffs", "measured_scale")


def _rows(params, n):
    """The names of the per-ray rows of a params dict of n rays."""
    return [k for k, v in params.items()
            if isinstance(v, torch.Tensor) and v.dim() >= 1
            and v.shape[0] == n and k not in _SHARED]


def _cell_hash(ix, iy, iz, hash_size: int):
    h, _, _, _ = rng.pcg4d(ix, iy, iz, 0x9E3779B9)
    return h & (hash_size - 1)


@tensorclass
class SPPMIntegrator:
    """Stochastic progressive photon mapping; see the module docstring."""

    max_depth: int = static_field(default=5)
    photons_per_iteration: int = static_field(default=0)  # 0 -> npix
    initial_radius: float = static_field(default=0.0)  # 0 -> from the scene
    k_candidates: int = static_field(default=32)

    # -- camera pass (integrators.cpp:3352-3473) ---------------------------

    def _camera_pass(self, scene, camera, wl, it: int, seed: int):
        nx, ny = camera.resolution
        npix = nx * ny
        lam = wl.lam
        dev = lam.device
        lights = scene.lights
        have_lights = lights.n_lights > 0
        pixel = torch.arange(npix, dtype=torch.int64, device=dev)
        jx = rng.uniform_1d(pixel, it, 0, seed)
        jy = rng.uniform_1d(pixel, it, 1, seed)
        px = (pixel % nx).to(torch.float32) + jx
        py = torch.div(pixel, nx, rounding_mode="floor").to(torch.float32) + jy
        o, d = camera.generate_rays(torch.stack([px, py], dim=-1))

        s = lam.shape[-1]
        beta = torch.ones((npix, s), dtype=torch.float32, device=dev)
        Ld = torch.zeros((npix, s), dtype=torch.float32, device=dev)
        active = torch.ones((npix,), dtype=torch.bool, device=dev)
        specular = torch.ones((npix,), dtype=torch.bool, device=dev)
        prev_pdf = torch.ones((npix,), dtype=torch.float32, device=dev)
        prev_p = o
        prev_ns = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
        vp_set = torch.zeros((npix,), dtype=torch.bool, device=dev)
        vp = None
        for depth in range(self.max_depth):
            isect = accel_api.closest(scene, o, d)
            hit = active & isect.valid
            if have_lights:
                le = lights.emitted(isect.light, isect.n, isect.wo, lam)
                light_pdf = lights.pdf_li_area(
                    isect.light, isect.t, dot(isect.n, isect.wo),
                    p_ref=prev_p, n_ref=prev_ns)
                w_l = torch.where(specular, 1.0,
                                  power_heuristic(1, prev_pdf, 1, light_pdf))
                emit = hit & (isect.light >= 0)
                Ld = Ld + torch.where(emit[:, None], beta * w_l[:, None] * le,
                                      0.0)
                escaped = active & ~isect.valid
                w_esc = torch.where(specular, 1.0, power_heuristic(
                    1, prev_pdf, 1, lights.pdf_escaped(d, o)))
                Ld = Ld + torch.where(
                    escaped[:, None],
                    beta * w_esc[:, None] * lights.escaped_radiance(d, lam, o),
                    0.0)
            active = hit
            t1, t2, ns, wo_l = _frame(isect)
            params = bxdf.surface_params(scene, isect, lam)
            dim0 = 8 + depth * 8
            if have_lights:
                u_sel = rng.uniform_1d(pixel, it, dim0 + 0, seed)
                up0 = rng.uniform_1d(pixel, it, dim0 + 1, seed)
                up1 = rng.uniform_1d(pixel, it, dim0 + 2, seed)
                ls = lights.sample_li(isect.p, lam, u_sel,
                                      torch.stack([up0, up1], -1), n_ref=ns)
                wi_l = to_local(ls.wi, t1, t2, ns)
                f_nee = (bxdf.evaluate(params, wo_l, wi_l, lam)
                         * torch.abs(wi_l[:, 2:3]))
                pdf_b = bxdf.pdf(params, wo_l, wi_l)
                w_nee = torch.where(ls.is_delta, 1.0,
                                    power_heuristic(1, ls.pdf, 1, pdf_b))
                contrib = torch.where(
                    (ls.pdf > 0.0)[:, None],
                    beta * f_nee * ls.L
                    * (w_nee / torch.clamp(ls.pdf, min=1e-20))[:, None], 0.0)
                need = active & (ls.pdf > 0.0) & torch.any(contrib != 0.0, -1)
                so, wi_sh, smax = shadow_segment(isect.p, isect.n, ls.wi,
                                                 ls.dist)
                occ = accel_api.any_hit(
                    scene,
                    torch.where(need[:, None], so, torch.zeros_like(so) + 1e8),
                    wi_sh, torch.where(need, smax, 0.0))
                Ld = Ld + torch.where((need & ~occ)[:, None], contrib, 0.0)

            uc = rng.uniform_1d(pixel, it, dim0 + 3, seed)
            ub0 = rng.uniform_1d(pixel, it, dim0 + 4, seed)
            ub1 = rng.uniform_1d(pixel, it, dim0 + 5, seed)
            bs = bxdf.sample(params, wo_l, lam, torch.stack([ub0, ub1], -1), uc)

            # The visible point: the first non-delta vertex.
            new_vp = active & ~bs["specular"] & ~vp_set
            here = {"p": isect.p, "ns": ns, "t1": t1, "t2": t2,
                    "wo": isect.wo, "beta": beta,
                    **{"params." + k: params[k] for k in _rows(params, npix)}}
            if vp is None:
                vp = {k: torch.zeros_like(v) for k, v in here.items()}
                vp_static = {k: v for k, v in params.items()
                             if "params." + k not in here}
            m = new_vp
            vp = {k: torch.where(m.reshape((-1,) + (1,) * (v.dim() - 1)),
                                 here[k], v) for k, v in vp.items()}
            # Only delta (specular) bounces continue the camera path.
            ok = active & bs["specular"] & (bs["pdf"] > 0.0) & ~vp_set
            vp_set = vp_set | new_vp
            wi_w = from_local(bs["wi"], t1, t2, ns)
            cos_wi = torch.abs(bs["wi"][:, 2])
            beta = torch.where(
                ok[:, None],
                beta * bs["f"]
                * (cos_wi / torch.clamp(bs["pdf"], min=1e-20))[:, None], beta)
            o = torch.where(ok[:, None], offset_ray_origin(isect.p, isect.n,
                                                           wi_w), o)
            d = torch.where(ok[:, None], wi_w, d)
            specular = torch.where(ok, bs["specular"], specular)
            prev_pdf = torch.where(ok, bs["pdf"], prev_pdf)
            prev_p = torch.where(ok[:, None], isect.p, prev_p)
            prev_ns = torch.where(ok[:, None], ns, prev_ns)
            active = ok
        params = dict(vp_static)
        params.update({k[len("params."):]: v for k, v in vp.items()
                       if k.startswith("params.")})
        return {"Ld": Ld, "vp_set": vp_set, "vp_p": vp["p"], "vp_ns": vp["ns"],
                "vp_t1": vp["t1"], "vp_t2": vp["t2"], "vp_wo": vp["wo"],
                "vp_beta": vp["beta"], "vp_params": params}

    # -- the grid: a sorted (hash, pixel) table (integrators.cpp:3477-3536)

    def _build_grid(self, vp_p, radius, vp_set, hash_size: int):
        npix = vp_p.shape[0]
        lo = torch.amin(torch.where(vp_set[:, None], vp_p - radius[:, None],
                                    1e30), dim=0)
        max_r = torch.amax(torch.where(vp_set, radius, 0.0))
        cell = 2.0 * torch.clamp(max_r, min=1e-6)
        cmin = torch.floor((vp_p - radius[:, None] - lo[None]) / cell).to(
            torch.int64)
        cmax = torch.floor((vp_p + radius[:, None] - lo[None]) / cell).to(
            torch.int64)
        pix = torch.arange(npix, dtype=torch.int64, device=vp_p.device)
        entries_h = []
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    off = torch.tensor([dx, dy, dz], dtype=torch.int64,
                                       device=vp_p.device)
                    c = cmin + off[None]
                    ok = vp_set & torch.all(c <= cmax, dim=-1)
                    # A missing entry sorts past every real key.
                    entries_h.append(torch.where(
                        ok, _cell_hash(c[:, 0], c[:, 1], c[:, 2], hash_size),
                        hash_size))
        h = torch.cat(entries_h)
        v = pix.repeat(8)
        order = torch.argsort(h, stable=True)
        return {"hash": h[order], "pix": v[order], "lo": lo, "cell": cell}

    # -- photon pass (integrators.cpp:3540-3660) ---------------------------

    def _photon_pass(self, scene, wl, grid, cam, radius, it: int, seed: int,
                     hash_size: int):
        lights = scene.lights
        npix = cam["vp_p"].shape[0]
        n = self.photons_per_iteration or npix
        lam = wl.lam
        dev = lam.device
        lam_n = lam[:1].expand(n, lam.shape[-1])
        wl_n = spectrum.SampledWavelengths(lam=lam_n,
                                           pdf=wl.pdf[:1].expand_as(lam_n))
        pid = torch.arange(n, dtype=torch.int64, device=dev)
        K = self.k_candidates

        # Photon emission from the emissive geometry (SampleLe).
        u_sel = rng.uniform_1d(pid, it, 2000, seed)
        up0 = rng.uniform_1d(pid, it, 2001, seed)
        up1 = rng.uniform_1d(pid, it, 2002, seed)
        org = lights.sample_le_origin(u_sel, torch.stack([up0, up1], -1))
        pmf, p0, n_l, area = org["pmf"], org["p"], org["n"], org["area"]
        le = eval_emission(org["coeffs"], org["scale"], org["illum"], lam_n)
        ud0 = rng.uniform_1d(pid, it, 2003, seed)
        ud1 = rng.uniform_1d(pid, it, 2004, seed)
        t1, t2 = coordinate_system(n_l)
        d = from_local(sample_cosine_hemisphere(torch.stack([ud0, ud1], -1)),
                       t1, t2, n_l)
        beta = le * (math.pi * area / torch.clamp(pmf, min=1e-12))[:, None]
        o = offset_ray_origin(p0, n_l, d)
        active = torch.ones((n,), dtype=torch.bool, device=dev)

        n_entries = grid["hash"].shape[0]
        phi = torch.zeros((npix + 1, 3), dtype=torch.float32, device=dev)
        m = torch.zeros((npix + 1,), dtype=torch.int64, device=dev)
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
        slot = torch.arange(K, dtype=torch.int64, device=dev)[:, None]
        for depth in range(self.max_depth):
            isect = accel_api.closest(scene, o, d)
            hit = active & isect.valid
            if depth > 0:
                # Deposit on the visible points (the direct-lighting depth
                # is skipped: the camera pass's NEE covers it).
                c = torch.floor((isect.p - grid["lo"][None]) / grid["cell"]).to(
                    torch.int64)
                h = _cell_hash(c[:, 0], c[:, 1], c[:, 2], hash_size)
                start = torch.searchsorted(grid["hash"], h, side="left")
                end = torch.searchsorted(grid["hash"], h, side="right")
                overflow = overflow + torch.sum(hit & (end - start > K))
                phi, m = self._deposit(phi, m, grid, cam, radius, isect.p,
                                       -d, beta, hit, start, end, slot,
                                       n_entries, lam_n, wl_n)

            # Continue the photon path (BSDF sampling; the adjoint walk).
            ft1, ft2, ns, wo_l = _frame(isect)
            params = bxdf.surface_params(scene, isect, lam_n)
            dimp = 2010 + depth * 4
            uc = rng.uniform_1d(pid, it, dimp + 0, seed)
            ub0 = rng.uniform_1d(pid, it, dimp + 1, seed)
            ub1 = rng.uniform_1d(pid, it, dimp + 2, seed)
            bs = bxdf.sample(params, wo_l, lam_n, torch.stack([ub0, ub1], -1),
                             uc)
            ok = hit & (bs["pdf"] > 0.0)
            wi_w = from_local(bs["wi"], ft1, ft2, ns)
            cos_wi = torch.abs(bs["wi"][:, 2])
            beta_new = beta * bs["f"] * (
                cos_wi / torch.clamp(bs["pdf"], min=1e-20))[:, None]
            # Russian roulette on the throughput ratio (betaRatio,
            # integrators.cpp:3646-3652).
            q = torch.clamp(1.0 - torch.amax(beta_new, -1) / torch.clamp(
                torch.amax(beta, -1), min=1e-20), 0.0, 0.95)
            kill = (rng.uniform_1d(pid, it, dimp + 3, seed) < q) & ok
            beta_new = beta_new / torch.clamp(1.0 - q, min=0.05)[:, None]
            ok = ok & ~kill
            o = torch.where(ok[:, None], offset_ray_origin(isect.p, isect.n,
                                                           wi_w), o)
            d = torch.where(ok[:, None], wi_w, d)
            beta = torch.where(ok[:, None], beta_new, beta)
            active = ok
        return phi[:npix], m[:npix], overflow

    @staticmethod
    def _deposit(phi, m, grid, cam, radius, p, wi, beta, dep, start, end,
                 slot, n_entries, lam_n, wl_n):
        """Flux of the photons at p (arriving along -wi) on the visible
        points of their cells' first K table entries within each point's
        radius: the reference's K-slot scan, its live (slot, photon) pairs
        taken k-major, so index_add_ adds them in the reference's order."""
        pos = start[None, :] + slot  # (K, n)
        live = dep[None, :] & (pos < end[None, :])
        k_idx, ph = torch.nonzero(live, as_tuple=True)  # k-major order
        vp = grid["pix"][torch.clamp(pos[k_idx, ph], max=n_entries - 1)]
        p_vp = cam["vp_p"][vp]
        r_vp = radius[vp]
        d2 = torch.sum((p_vp - p[ph]) ** 2, dim=-1)
        ok = (d2 <= r_vp * r_vp) & cam["vp_set"][vp]
        t1v, t2v = cam["vp_t1"][vp], cam["vp_t2"][vp]
        nsv = cam["vp_ns"][vp]
        npix = cam["vp_p"].shape[0]
        pv = {k: (v[vp] if k in _rows(cam["vp_params"], npix) else v)
              for k, v in cam["vp_params"].items()}
        f = bxdf.evaluate(pv, to_local(cam["vp_wo"][vp], t1v, t2v, nsv),
                          to_local(wi[ph], t1v, t2v, nsv), lam_n[ph])
        wl_pair = spectrum.SampledWavelengths(lam=wl_n.lam[ph],
                                              pdf=wl_n.pdf[ph])
        contrib = spectrum_to_rgb(cam["vp_beta"][vp] * beta[ph] * f, wl_pair)
        contrib = torch.where(
            torch.all(torch.isfinite(contrib), -1, keepdim=True), contrib, 0.0)
        tgt = torch.where(ok, vp, npix)
        phi = phi.index_add(0, tgt, torch.where(ok[:, None], contrib, 0.0))
        m = m.index_add(0, tgt, ok.to(torch.int64))
        return phi, m

    # -- the render loop ----------------------------------------------------

    def start(self, scene, camera) -> dict:
        """The per-pixel statistics before the first iteration: the
        initial radius (the file's, or 2 x the triangles' bounding
        diagonal over the larger image side), n = 0, tau = 0, Ld = 0; and
        the hash table's size."""
        if scene.lights.n_area + scene.lights.n_sphl == 0:
            raise ValueError("SPPM's photons need emissive geometry")
        nx, ny = camera.resolution
        npix = nx * ny
        dev = scene.geom.tri_verts.device
        r0 = self.initial_radius
        if r0 <= 0.0:
            tv = scene.geom.tri_verts.reshape(-1, 3).cpu().numpy()
            diag = (float(np.linalg.norm(tv.max(0) - tv.min(0)))
                    if tv.size else 10.0)
            r0 = 2.0 * diag / max(nx, ny)
        return {"radius": torch.full((npix,), r0, dtype=torch.float32,
                                     device=dev),
                "n": torch.zeros((npix,), dtype=torch.float32, device=dev),
                "tau": torch.zeros((npix, 3), dtype=torch.float32, device=dev),
                "Ld": torch.zeros((npix, 3), dtype=torch.float32, device=dev),
                "overflow": torch.zeros((), dtype=torch.int64, device=dev),
                "hash_size": 1 << max(8, int(np.ceil(np.log2(2 * npix))))}

    def iterate(self, scene, camera, state: dict, it: int, seed: int,
                n_spectrum: int) -> dict:
        """One iteration: the camera pass, the grid, the photon pass and
        the radius and flux contraction (integrators.cpp:3664-3690)."""
        npix = state["radius"].shape[0]
        dev = state["radius"].device
        # A golden-ratio rotation stratifies the iteration's shared
        # wavelength (the reference's RadicalInverse(1, iter)).
        u_lam = float(np.float32((0.5 + it * 0.6180339887498949) % 1.0))
        wl = spectrum.sample_visible(
            torch.full((npix,), u_lam, dtype=torch.float32, device=dev),
            n_spectrum)
        cam = self._camera_pass(scene, camera, wl, it, seed)
        Ld_rgb = spectrum_to_rgb(cam["Ld"], wl)
        Ld_rgb = torch.where(
            torch.all(torch.isfinite(Ld_rgb), -1, keepdim=True), Ld_rgb, 0.0)
        radius, n = state["radius"], state["n"]
        grid = self._build_grid(cam["vp_p"], radius, cam["vp_set"],
                                state["hash_size"])
        phi, msum, overflow = self._photon_pass(
            scene, wl, grid, cam, radius, it, seed + 1, state["hash_size"])
        gamma = 2.0 / 3.0
        mf = msum.to(torch.float32)
        has = mf > 0
        n_new = n + gamma * mf
        r_new = radius * torch.sqrt(n_new / torch.clamp(n + mf, min=1e-12))
        ratio = torch.where(has, (r_new / radius) ** 2, 1.0)
        tau = torch.where(has[:, None], (state["tau"] + phi) * ratio[:, None],
                          state["tau"])
        return {"radius": torch.where(has, r_new, radius),
                "n": torch.where(has, n_new, n), "tau": tau,
                "Ld": state["Ld"] + Ld_rgb,
                "overflow": state["overflow"] + overflow,
                "hash_size": state["hash_size"]}

    def image(self, camera, state: dict, n_iterations: int):
        """The (ny, nx, 3) estimate after n_iterations iterations."""
        nx, ny = camera.resolution
        n_photons = self.photons_per_iteration or nx * ny
        L = state["Ld"] / n_iterations + state["tau"] / (
            n_iterations * n_photons * math.pi * state["radius"][:, None] ** 2)
        return L.reshape(ny, nx, 3)

    def render(self, scene, camera, n_iterations: int = 32, seed: int = 0,
               return_stats: bool = False,
               n_spectrum: int = spectrum.N_SPECTRUM_DEFAULT, *, device):
        """Run SPPM on `device`; returns the (ny, nx, 3) linear-RGB image
        (and, with return_stats, the overflow count, radii and n)."""
        from ..render import on_device

        refuse_gradient(scene, "SPPMIntegrator")
        scene, camera = on_device(scene, camera, device)
        state = self.start(scene, camera)
        for it in range(n_iterations):
            state = self.iterate(scene, camera, state, it, seed, n_spectrum)
        img = self.image(camera, state, n_iterations)
        if not return_stats:
            return img
        nx, ny = camera.resolution
        return img, {"overflow": int(state["overflow"]),
                     "radius": state["radius"].reshape(ny, nx),
                     "n": state["n"].reshape(ny, nx)}
