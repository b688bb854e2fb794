"""PSS-MLT, primary-sample-space Metropolis light transport (port of
pbrt_tpu/models/mlt.py; MLTIntegrator and MLTSampler,
integrators.h:411-460 and integrators.cpp:3026-3290 of pbrt-v4).

A bootstrap estimates the normalisation b and draws stationary chain
starts; then n_chains Markov chains advance in lockstep through
[0, 1)^D primary sample space with Kelemen small and large steps,
splatting both the current and the proposed state with their
multiple-importance weights (integrators.cpp:3219-3245). One step
evaluates the contribution function once for every chain as one batched
path trace; the reference's lax.scan over steps is a Python loop.

  * PSSSampler replays a dense (n_chains, D, 2) primary-sample tensor,
    mutated every step, through the sampler protocol (get_1d / get_2d by
    dimension slot).
  * The inner estimator is the port's spectral PathIntegrator (NEE + MIS),
    as in the reference (not pbrt-v4's BDPT with stream splitting).
  * The small step's Gaussian uses core/floats.py's erfinv, XLA's float32
    ErfInv bit for bit: torch.special.erfinv is another approximation,
    and an ulp in a mutated sample can flip an acceptance test and send a
    chain down another path for good.
  * Both splats of a step are index_add_ (atomics on the card; they do not
    feed the chains).

Estimator (balance heuristic over the uniform large step and the
stationary chain, per step):

  splat(u') += rgb(u') * (a + 1{large}) / (p_large + y(u')/b)
  splat(u)  += rgb(u)  * (1 - a)        / (p_large + y(u)/b)
  image      = splat * npix / n_total_steps

with a = min(1, y'/y), y the luminance and b = E_uniform[y].
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import rng, spectrum
from ..core.floats import erfinv
from ..core.tensorclass import static_field, tensorclass
from ..films.rgb import spectrum_to_rgb
from .path import PathIntegrator, refuse_gradient

_LUM = (0.2126729, 0.7151522, 0.0721750)


@tensorclass
class PSSSampler:
    """Replay sampler: serves stored primary-sample-space coordinates
    (MLTSampler::Get1D / Get2D, samplers.h:910-960, without the lazy
    mutation bookkeeping: every slot is already current). u is (N, D, 2),
    one 2-vector per dimension slot, so a get_2d never aliases the next
    slot's get_1d; a dimension past the last slot reads the last."""

    u: torch.Tensor

    def _col(self, dim, j):
        return self.u[:, min(max(int(dim), 0), self.u.shape[1] - 1),
                      j].contiguous()

    def get_1d(self, pixel, sample_idx, dim):
        return self._col(dim, 0)

    def get_2d(self, pixel, sample_idx, dim):
        return self._col(dim, 0), self._col(dim, 1)


def _contribution(scene, camera, integrator, u, n_spectrum: int):
    """The path contribution function at PSS points u (N, D, 2): slot 0 the
    film position over the whole image, slot 2 the lens, slot 4 the hero
    wavelength, slots >= 8 the path's decisions (render.camera_rays_full's
    and PathIntegrator's layout). Returns (pixel ids, (N, 3) RGB, the
    luminance y)."""
    nx, ny = camera.resolution
    pf = u[:, 0, :] * torch.tensor([nx, ny], dtype=torch.float32,
                                   device=u.device)
    o, d = camera.generate_rays(pf, u[:, 2, :])
    wl = spectrum.sample_visible(u[:, 4, 0], n_spectrum)
    pixel = (torch.clamp(pf[:, 1].to(torch.int64), 0, ny - 1) * nx
             + torch.clamp(pf[:, 0].to(torch.int64), 0, nx - 1))
    L = integrator.trace(scene, o, d, wl, pixel, 0, PSSSampler(u=u))
    rgb = spectrum_to_rgb(L, wl)
    rgb = torch.where(torch.all(torch.isfinite(rgb), dim=-1, keepdim=True),
                      rgb, 0.0)
    lum = torch.tensor(_LUM, dtype=torch.float32, device=u.device)
    y = torch.clamp(torch.sum(rgb * lum, dim=-1), min=0.0)
    return pixel, rgb, y


def _uniform_block(chain, step: int, seed: int, n_vals: int):
    """(N, n_vals) decorrelated uniforms keyed by (chain, slot, step,
    seed)."""
    slots = torch.arange(n_vals, dtype=torch.int64, device=chain.device)
    v0, _, _, _ = rng.pcg4d(chain[:, None], slots[None, :], step,
                            seed ^ 0x6D2B79F5)
    return rng.u32_to_uniform(v0)


@tensorclass
class MLTIntegrator:
    """Metropolis over primary sample space; see the module docstring."""

    base: PathIntegrator
    n_chains: int = static_field(default=4096)
    mutations_per_chain: int = static_field(default=256)
    bootstrap_factor: int = static_field(default=4)  # bootstrap = factor*chains
    sigma: float = static_field(default=0.01)
    p_large: float = static_field(default=0.3)

    @property
    def n_dims(self) -> int:
        return 8 + 8 * self.base.max_depth

    # -- bootstrap (integrators.cpp:3094-3132) ------------------------------

    def _bootstrap(self, scene, camera, seed: int, n_spectrum: int):
        """(b = E[y], the stationary chain starts (n_chains, D, 2) ~ y)."""
        d, n = self.n_dims, self.n_chains
        dev = scene.geom.tri_verts.device
        chain = torch.arange(n, dtype=torch.int64, device=dev)
        ys, us = [], []
        for k in range(self.bootstrap_factor):
            u = _uniform_block(chain, -1 - k, seed, d * 2).reshape(n, d, 2)
            ys.append(_contribution(scene, camera, self.base, u,
                                    n_spectrum)[2].cpu().numpy())
            us.append(u)
        y = np.concatenate(ys)
        u_all = torch.cat(us)
        b = float(y.mean())
        if not b > 0.0:
            return 0.0, u_all[:n]
        # Chain starts resampled in proportion to y: the stationary
        # target itself, so no burn-in is needed.
        cdf = np.cumsum(y)
        r = (np.arange(n) + np.random.default_rng(seed).random(n)) / n
        idx = np.clip(np.searchsorted(cdf, r * cdf[-1], side="right"), 0,
                      len(y) - 1)
        return b, u_all[torch.as_tensor(idx, device=dev)]

    # -- mutations (integrators.cpp:3138-3260) -------------------------------

    def step(self, scene, camera, state, t: int, b: float, seed: int,
             n_spectrum: int):
        """One lockstep mutation of every chain: the small or large step,
        the proposal's contribution, both splats and the acceptance test.
        state: u, pix, rgb, y, splat. Returns (the new state, the accepted
        mask)."""
        n, d = self.n_chains, self.n_dims
        chain = torch.arange(n, dtype=torch.int64, device=state["u"].device)
        xi = _uniform_block(chain, t, seed, 2 * d + 2)
        is_large = xi[:, 0] < self.p_large
        # Small step: a wrapped Gaussian, the reference's ErfInv
        # construction (samplers.h:938-947) with n_small = 1, every
        # dimension refreshed every step.
        z = xi[:, 2:].reshape(n, d, 2)
        gauss = math.sqrt(2.0) * erfinv(
            torch.clamp(2.0 * z - 1.0, -0.99999994, 0.99999994))
        u_small = torch.remainder(state["u"] + self.sigma * gauss, 1.0)
        u_prop = torch.where(is_large[:, None, None], z, u_small)
        u_prop = torch.clamp(u_prop, 0.0, 1.0 - 1e-7)
        pix_p, rgb_p, y_p = _contribution(scene, camera, self.base, u_prop,
                                          n_spectrum)
        a = torch.minimum(torch.ones_like(y_p),
                          y_p / torch.clamp(state["y"], min=1e-24))
        a = torch.where(y_p <= 0.0, 0.0, a)
        w_prop = (a + is_large.to(torch.float32)) / (self.p_large + y_p / b)
        w_cur = (1.0 - a) / (self.p_large + state["y"] / b)
        splat = state["splat"].index_add(0, pix_p, rgb_p * w_prop[:, None])
        splat = splat.index_add(0, state["pix"], state["rgb"] * w_cur[:, None])
        acc = xi[:, 1] < a
        return {
            "u": torch.where(acc[:, None, None], u_prop, state["u"]),
            "pix": torch.where(acc, pix_p, state["pix"]),
            "rgb": torch.where(acc[:, None], rgb_p, state["rgb"]),
            "y": torch.where(acc, y_p, state["y"]),
            "splat": splat,
        }, acc

    def start(self, scene, camera, u0, n_spectrum: int):
        """The chains' state at their starts u0."""
        nx, ny = camera.resolution
        pix, rgb, y = _contribution(scene, camera, self.base, u0, n_spectrum)
        return {"u": u0, "pix": pix, "rgb": rgb, "y": y,
                "splat": torch.zeros((nx * ny + 1, 3), dtype=torch.float32,
                                     device=u0.device)}

    def render(self, scene, camera, seed: int = 0,
               n_spectrum: int = spectrum.N_SPECTRUM_DEFAULT, *, device):
        """Run the chains on `device`; returns the (ny, nx, 3) linear-RGB
        image."""
        from ..render import on_device

        refuse_gradient(scene, "MLTIntegrator")
        scene, camera = on_device(scene, camera, device)
        nx, ny = camera.resolution
        npix = nx * ny
        b, u0 = self._bootstrap(scene, camera, seed, n_spectrum)
        if b == 0.0:
            return torch.zeros((ny, nx, 3), dtype=torch.float32,
                               device=u0.device)
        state = self.start(scene, camera, u0, n_spectrum)
        for t in range(self.mutations_per_chain):
            state, _ = self.step(scene, camera, state, t, b, seed, n_spectrum)
        total = self.n_chains * self.mutations_per_chain
        return state["splat"][:npix].reshape(ny, nx, 3) * (npix / total)


def render_mlt(scene, camera, max_depth: int = 5, seed: int = 0,
               mutations_per_pixel: int = 32, n_chains: int = 4096,
               sigma: float = 0.01, p_large: float = 0.3,
               n_spectrum: int = spectrum.N_SPECTRUM_DEFAULT, *, device):
    """MLT sized by the reference's CLI knobs (mutationsperpixel, chains;
    integrators.cpp:3272-3290): n_chains chains of
    max(1, mutations_per_pixel * npix // n_chains) steps."""
    nx, ny = camera.resolution
    mpc = max(1, mutations_per_pixel * nx * ny // n_chains)
    integ = MLTIntegrator(base=PathIntegrator(max_depth=max_depth),
                          n_chains=n_chains, mutations_per_chain=mpc,
                          sigma=sigma, p_large=p_large)
    return integ.render(scene, camera, seed=seed, n_spectrum=n_spectrum,
                        device=device)
