"""LayeredBxDF: the stochastic 1D-transport walk through a coated surface
(port of pbrt_tpu/materials/layered.py).

The coated diffuse and coated conductor (top: a rough dielectric
interface; bottom: an opaque base lobe) take their BSDF value from a
Monte Carlo walk: light enters through the interface, is attenuated by an
absorbing layer, scatters off the base and bounces between base and
interface, with next-event estimation toward the exit direction at every
base vertex. Its random numbers are a pure function of the directions, as
pbrt's `RNG rng(Hash(wo), Hash(wi))` (bxdfs.h:692): pcg4d keyed on the
bit patterns of wo and wi, so the walk is deterministic per (wo, wi).

The reference draws each pair of uniforms with its own pcg4d call as the
walk goes; no draw depends on the walk's state, so the port hashes all of
a sample's draws in one batched call, (N, draws), with the same keys and
the same values. Eager PyTorch pays per launched op, and this cuts the
walk's hash from ~70 chains of int64 ops to two.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.vecmath import normalize, safe_sqrt
from . import scattering as sc

_EPS = 1e-7
_M32 = 0xFFFFFFFF


def _bits(x):
    """The float32 bit pattern of x as a uint32 held in an int64."""
    return x.detach().contiguous().view(torch.int32).to(torch.int64) & _M32


def _walk_keys(wo, wi):
    """(a, b): bits(w.x) ^ (bits(w.z) << 1) of wo and wi, wrapped to 32
    bits as the reference's uint32 shift wraps."""
    a = _bits(wo[..., 0]) ^ ((_bits(wo[..., 2]) << 1) & _M32)
    b = _bits(wi[..., 0]) ^ ((_bits(wi[..., 2]) << 1) & _M32)
    return a, b


def walk_uniforms(wo, wi, stream: int, n_draws: int):
    """The reference's `_walk_rng(wo, wi, stream)(i)` for i in
    [0, n_draws) at once: two (N, n_draws) float32 tensors, the first and
    second uniform of each draw."""
    a, b = _walk_keys(wo, wi)
    i = torch.arange(n_draws, dtype=torch.int64, device=wo.device)
    v0, v1, _, _ = rng.pcg4d(a[:, None], b[:, None], stream, i[None, :])
    return rng.u32_to_uniform(v0), rng.u32_to_uniform(v1)


def _abscos(w):
    return torch.abs(w[..., 2])


def _tr(thickness, w):
    """Beer-Lambert transmittance of one layer crossing (bxdfs.h:556)."""
    return torch.exp(-torch.abs(thickness / torch.clamp(_abscos(w), min=1e-6)))


def _interface_refract(wo, wm, eta):
    """Refract wo about the microfacet normal wm (Snell); (wi, ok)."""
    cos_i = torch.sum(wo * wm, dim=-1)
    wm_f = torch.where((cos_i < 0.0)[..., None], -wm, wm)
    cos_i = torch.abs(cos_i)
    eta_r = torch.where(wo[..., 2] > 0.0, eta, 1.0 / eta)
    sin2_t = torch.clamp(1.0 - cos_i * cos_i, min=0.0) / (eta_r * eta_r)
    tir = sin2_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    wi = -wo / eta_r[..., None] + (cos_i / eta_r - cos_t)[..., None] * wm_f
    return normalize(wi), ~tir


def _top_sample(wo, u2, alpha, eta, mode_transmit: bool,
                radiance: bool = True):
    """Sample one event class of the dielectric interface: (wi, weight,
    ok), weight = f |cos| / pdf of that class (DielectricBxDF::Sample_f
    restricted to it, bxdfs.h:332-420). Radiance-mode transmission carries
    the 1 / eta_rel^2 compression; importance mode (the exit coupling,
    bxdfs.h:758) does not."""
    alpha_r = torch.clamp(alpha, min=1e-4)
    wm = sc.ggx_sample_wm(wo, u2, alpha_r)
    cos_om = torch.sum(wo * wm, dim=-1)
    eta_rel = torch.where(wo[..., 2] > 0.0, eta, 1.0 / eta)
    fr = sc.fr_dielectric(torch.abs(cos_om), eta_rel)
    if mode_transmit:
        wi, ok = _interface_refract(wo, wm, eta)
        # With reflection disabled the class is chosen with probability 1,
        # so the BTDF's (1 - F) does not cancel.
        w = (1.0 - fr) * sc.ggx_g(wo, wi, alpha_r) / torch.clamp(
            sc.ggx_g1(wo, alpha_r), min=1e-6)
        if radiance:
            w = w / (eta_rel * eta_rel)
        ok = ok & (wi[..., 2] * wo[..., 2] < 0.0)
        return wi, torch.where(ok, w, 0.0), ok & (fr < 1.0 - 1e-6)
    wi = -wo + 2.0 * cos_om[..., None] * wm
    ok = wi[..., 2] * wo[..., 2] > 0.0
    w = sc.ggx_g(wo, wi, alpha_r) / torch.clamp(sc.ggx_g1(wo, alpha_r),
                                                 min=1e-6)
    return wi, torch.where(ok, w, 0.0), ok


def layered_walk(wo, wi, base_f_fn, base_sample_fn, alpha_c, eta=1.5,
                 thickness=0.01, n_samples: int = 2, max_depth: int = 10,
                 salt: int = 0):
    """Stochastic estimate of the layered BSDF value f(wo, wi): (N, S).

    base_f_fn(wo_l, wi_l) -> (N, S); base_sample_fn(wo_l, u2, uc) ->
    (wi, f, pdf) of the opaque base lobe. Local directions, z up; wo and
    wi in the upper hemisphere. Sample s_i draws from stream
    salt * 131 + s_i (the coated diffuse uses salt 0, the coated
    conductor salt 1)."""
    n = wo.shape[0]
    dev = wo.device
    alpha_c = torch.broadcast_to(
        torch.as_tensor(alpha_c, dtype=torch.float32, device=dev), (n,))
    eta_v = torch.full((n,), eta, dtype=torch.float32, device=dev)
    thickness = torch.as_tensor(thickness, dtype=torch.float32, device=dev)

    # Direct specular reflection at the entrance interface (bxdfs.h:706).
    wm_ok = torch.sum((wo + wi) ** 2, dim=-1) > 1e-16
    wm = normalize(wo + wi)
    fr_m = sc.fr_dielectric(torch.abs(torch.sum(wo * wm, dim=-1)), eta_v)
    d = sc.ggx_d(wm, alpha_c)
    g = sc.ggx_g(wo, wi, alpha_c)
    spec = torch.where(
        wm_ok & (wi[..., 2] * wo[..., 2] > 0.0),
        d * g * fr_m / torch.clamp(4.0 * _abscos(wo) * _abscos(wi), min=_EPS),
        0.0,
    )

    s_dim = base_f_fn(wo, wi).shape[-1]
    f_acc = torch.zeros((n, s_dim), dtype=torch.float32, device=dev)
    n_draws = 4 + 3 * max_depth
    for s_i in range(n_samples):
        ua, ub = walk_uniforms(wo, wi, salt * 131 + s_i, n_draws)

        def u2_of(i):
            return torch.stack([ua[:, i], ub[:, i]], dim=-1)

        # Enter: transmit wo through the interface (bxdfs.h:747).
        w_in, wt_in, ok_in = _top_sample(wo, u2_of(0), alpha_c, eta_v, True)
        # The exit importance path: wi transmitted inward (bxdfs.h:758),
        # the exit coupling of NEE at interior vertices.
        w_exit, wt_exit, ok_exit = _top_sample(
            wi, u2_of(2), alpha_c, eta_v, True, radiance=False)
        beta = torch.where(ok_in & ok_exit, wt_in, 0.0)[..., None] * torch.ones(
            (n, s_dim), dtype=torch.float32, device=dev)
        beta_exit = torch.where(ok_exit, wt_exit, 0.0)

        w = w_in  # travelling down (z < 0)
        contrib = torch.zeros((n, s_dim), dtype=torch.float32, device=dev)
        for depth in range(max_depth):
            du = 4 + depth * 3
            # Cross the layer down to the base (bxdfs.h:785).
            beta = beta * _tr(thickness, w)[..., None]
            # Base vertex: NEE toward the exit direction -w_exit
            # (bxdfs.h:806-830).
            wo_b = -w
            wi_b = -w_exit
            f_nee = base_f_fn(wo_b, wi_b) * _abscos(wi_b)[..., None]
            contrib = contrib + beta * f_nee * (
                _tr(thickness, wi_b) * beta_exit)[..., None]
            # Sample the base lobe to continue upward (bxdfs.h:838).
            wi_up, f_b, pdf_b = base_sample_fn(wo_b, u2_of(du), ua[:, du + 1])
            ok_b = (pdf_b > 1e-9) & (wi_up[..., 2] > 0.0)
            beta = torch.where(
                ok_b[..., None],
                beta * f_b * (_abscos(wi_up)
                              / torch.clamp(pdf_b, min=1e-9))[..., None],
                0.0,
            )
            w = torch.where(ok_b[..., None], wi_up, w)
            # Back up to the interface. Exit energy is carried only by the
            # NEE above (with an absorbing layer every exiting path's last
            # scatter is at the base); here the walk reflects back down
            # with the Fresnel mass (bxdfs.h:879).
            beta = beta * _tr(thickness, w)[..., None]
            w_dn, wt_r, ok_r = _top_sample(-w, u2_of(du + 2), alpha_c, eta_v,
                                           False)
            # The internal Fresnel term (dense to air side) carries TIR.
            fr_i = sc.fr_dielectric(_abscos(w), 1.0 / eta_v)
            ok_r = ok_r & (w_dn[..., 2] < 0.0)
            beta = torch.where(ok_r[..., None],
                               beta * (fr_i * wt_r)[..., None], 0.0)
            w = torch.where(ok_r[..., None], w_dn, w)
        f_acc = f_acc + contrib
    return spec[..., None] + f_acc / n_samples
