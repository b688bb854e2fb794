"""Analytic clear-sky radiance model (Preetham et al. 1999).

A copy of pbrt_tpu/utils/sky.py (numpy only; the Hosek-Wilkie table is
copied to data/hosek_spectral.npz), so the port needs nothing of the
reference package; the CIE curves are core/cie.py's.

Reference analogue: imgtool's `makesky` (cmd/imgtool.cpp) which uses the
vendored Hosek-Wilkie dataset (pbrt-v4 src/ext/skymodel). The
Hosek-Wilkie model is a large fitted dataset; this implementation uses the
older Preetham analytic model (public formulas: zenith chromaticity
polynomials + the Perez luminance function), which needs no tables and
covers the same use: generating a physically-plausible sun/sky environment
map from (sun elevation, turbidity).
"""

from __future__ import annotations

import numpy as np

# Perez coefficient rows [A..E] as linear functions of turbidity T for
# luminance Y and chromaticities x, y (Preetham Tables A.1-A.3).
_PEREZ_Y = np.asarray([
    [0.1787, -1.4630], [-0.3554, 0.4275], [-0.0227, 5.3251],
    [0.1206, -2.5771], [-0.0670, 0.3703],
])
_PEREZ_X = np.asarray([
    [-0.0193, -0.2592], [-0.0665, 0.0008], [-0.0004, 0.2125],
    [-0.0641, -0.8989], [-0.0033, 0.0452],
])
_PEREZ_YC = np.asarray([
    [-0.0167, -0.2608], [-0.0950, 0.0092], [-0.0079, 0.2102],
    [-0.0441, -1.6537], [-0.0109, 0.0529],
])


def _perez(theta, gamma, c):
    return (1.0 + c[0] * np.exp(c[1] / np.maximum(np.cos(theta), 0.01))) * (
        1.0 + c[2] * np.exp(c[3] * gamma) + c[4] * np.cos(gamma) ** 2
    )


def _zenith(turbidity, theta_s):
    t = turbidity
    chi = (4.0 / 9.0 - t / 120.0) * (np.pi - 2.0 * theta_s)
    yz = (4.0453 * t - 4.9710) * np.tan(chi) - 0.2155 * t + 2.4192  # kcd/m^2
    tv = np.asarray([t * t, t, 1.0])
    sv = np.asarray(
        [theta_s ** 3, theta_s ** 2, theta_s, 1.0]
    )
    mx = np.asarray([
        [0.00166, -0.00375, 0.00209, 0.0],
        [-0.02903, 0.06377, -0.03202, 0.00394],
        [0.11693, -0.21196, 0.06052, 0.25886],
    ])
    my = np.asarray([
        [0.00275, -0.00610, 0.00317, 0.0],
        [-0.04214, 0.08970, -0.04153, 0.00516],
        [0.15346, -0.26756, 0.06670, 0.26688],
    ])
    xz = tv @ mx @ sv
    yz_c = tv @ my @ sv
    return max(yz, 1e-3), xz, yz_c


def sky_radiance_rgb(directions, sun_dir, turbidity: float = 3.0,
                     sun_intensity: float = 0.0, sun_half_angle=0.2665):
    """Linear-RGB sky radiance for unit `directions` (N, 3), z = up.

    sun_intensity > 0 adds a solar disk of that radiance (the model itself
    covers only the sky dome)."""
    d = np.asarray(directions, np.float64)
    s = np.asarray(sun_dir, np.float64)
    s = s / np.linalg.norm(s)
    theta_s = np.arccos(np.clip(s[2], -1.0, 1.0))
    cos_t = np.clip(d[..., 2], 0.01, 1.0)
    theta = np.arccos(cos_t)
    cos_g = np.clip(d @ s, -1.0, 1.0)
    gamma = np.arccos(cos_g)

    t = turbidity
    cy = _PEREZ_Y @ np.asarray([t, 1.0])
    cx = _PEREZ_X @ np.asarray([t, 1.0])
    cyc = _PEREZ_YC @ np.asarray([t, 1.0])
    yz, xz, yzc = _zenith(t, theta_s)

    def channel(zen, c):
        num = _perez(theta, gamma, c)
        den = _perez(0.0, theta_s, c)
        return zen * num / max(den, 1e-9)

    Y = channel(yz, cy)  # luminance
    x = channel(xz, cx)
    y = channel(yzc, cyc)

    # xyY -> XYZ -> linear sRGB.
    y_ = np.maximum(y, 1e-6)
    X = x / y_ * Y
    Z = (1.0 - x - y) / y_ * Y
    m = np.asarray([
        [3.2406, -1.5372, -0.4986],
        [-0.9689, 1.8758, 0.0415],
        [0.0557, -0.2040, 1.0570],
    ])
    rgb = np.einsum("ij,...j->...i", m, np.stack([X, Y, Z], -1))
    rgb = np.clip(rgb, 0.0, None) * 0.025  # kcd/m^2 -> renderer-scale units
    below = d[..., 2] < 0.0
    rgb[below] = 0.0
    if sun_intensity > 0.0:
        disk = gamma < np.deg2rad(sun_half_angle)
        rgb[disk & ~below] += sun_intensity
    return rgb.astype(np.float32)


def make_sky_latlong(res_y: int = 128, sun_elevation_deg: float = 30.0,
                     sun_azimuth_deg: float = 0.0, turbidity: float = 3.0,
                     sun_intensity: float = 100.0,
                     sun_half_angle: float = 0.2665):
    """(res_y, 2*res_y, 3) lat-long environment image of the sky."""
    h, w = res_y, 2 * res_y
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = v * np.pi
    phi = u * 2.0 * np.pi
    tg, pg = np.meshgrid(theta, phi, indexing="ij")
    d = np.stack(
        [np.sin(tg) * np.cos(pg), np.sin(tg) * np.sin(pg), np.cos(tg)], -1
    )
    el = np.deg2rad(sun_elevation_deg)
    az = np.deg2rad(sun_azimuth_deg)
    sun = np.asarray(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)]
    )
    return sky_radiance_rgb(
        d.reshape(-1, 3), sun, turbidity, sun_intensity,
        sun_half_angle=sun_half_angle,
    ).reshape(h, w, 3)


# --- Hosek-Wilkie spectral sky model ----------------------------------------
# "An Analytic Model for Full Spectral Sky-Dome Radiance" (Hosek & Wilkie,
# SIGGRAPH 2012) + the 2013 solar radiance extension — the model the
# reference vendors (pbrt-v4 src/ext/skymodel/ArHosekSkyModel.c).
# Coefficient tables are the authors' published data (3-clause BSD),
# regenerated into .npz by pbrt_tpu/tools/gen_sky_tables.py. Evaluation below
# follows the published sample implementation: quintic Bezier over
# cube-root solar elevation, bilinear turbidity/albedo blend, the
# 9-parameter radiance distribution, piecewise-cubic solar radiance with
# 5th-order limb darkening.

_HOSEK_CACHE = {}


def _hosek_tables():
    if "t" not in _HOSEK_CACHE:
        import os

        path = os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "data",
            "hosek_spectral.npz",
        )
        _HOSEK_CACHE["t"] = dict(np.load(path))
    return _HOSEK_CACHE["t"]


def hosek_configs(turbidity: float, albedo: float, solar_elevation: float):
    """Cook the per-band 9-parameter configurations + radiance scales.

    Returns (configs (11, 9), radiances (11,)). solar_elevation in
    radians above the horizon. (ArHosekSkyModel_CookConfiguration.)"""
    tab = _hosek_tables()
    sky = tab["sky"].astype(np.float64)  # (11, 2, 10, 6, 9)
    rad = tab["rad"].astype(np.float64)  # (11, 2, 10, 6)
    t = float(np.clip(turbidity, 1.0, 10.0))
    a = float(np.clip(albedo, 0.0, 1.0))
    it = min(int(t), 9) if t < 10 else 9  # low turbidity row (1-based 1..9)
    int_turb = int(t)
    rem = t - int_turb
    if int_turb == 10:
        int_turb, rem = 10, 0.0
    x = (max(solar_elevation, 0.0) / (np.pi / 2.0)) ** (1.0 / 3.0)
    # Quintic Bezier weights over the 6 control points.
    w = np.asarray([
        (1 - x) ** 5,
        5 * (1 - x) ** 4 * x,
        10 * (1 - x) ** 3 * x ** 2,
        10 * (1 - x) ** 2 * x ** 3,
        5 * (1 - x) * x ** 4,
        x ** 5,
    ])

    def blend(table):  # table: (11, 2, 10, 6, ...)
        lo = np.tensordot(w, table[:, :, int_turb - 1], axes=(0, 2))
        # tensordot -> (11, 2, ...); albedo blend
        lo = (1 - a) * lo[:, 0] + a * lo[:, 1]
        if int_turb >= 10 or rem == 0.0:
            return lo
        hi = np.tensordot(w, table[:, :, int_turb], axes=(0, 2))
        hi = (1 - a) * hi[:, 0] + a * hi[:, 1]
        return (1 - rem) * lo + rem * hi

    configs = blend(sky)  # (11, 9)
    radiances = blend(rad[..., None])[..., 0]  # (11,)
    return configs, radiances


def _hosek_F(theta, gamma, c):
    """The 9-parameter distribution (GetRadianceInternal); theta/gamma
    arrays broadcast against config vector c (9,)."""
    cg = np.cos(gamma)
    ct = np.maximum(np.cos(theta), 0.0)
    exp_m = np.exp(c[4] * gamma)
    ray_m = cg * cg
    mie_m = (1.0 + cg * cg) / np.power(
        np.maximum(1.0 + c[8] * c[8] - 2.0 * c[8] * cg, 1e-8), 1.5
    )
    zenith = np.sqrt(ct)
    return (1.0 + c[0] * np.exp(c[1] / (ct + 0.01))) * (
        c[2] + c[3] * exp_m + c[5] * ray_m + c[6] * mie_m + c[7] * zenith
    )


def hosek_radiance(theta, gamma, lam_nm, configs, radiances):
    """Spectral sky radiance at wavelengths lam_nm (W m^-2 sr^-1 nm^-1
    model units). theta: angle from zenith; gamma: angle to sun. Shapes
    broadcast; returns (..., len(lam_nm))."""
    bands = _hosek_tables()["bands"]  # 320..720 step 40
    vals = np.stack(
        [_hosek_F(theta, gamma, configs[b]) * radiances[b]
         for b in range(11)], axis=-1,
    )  # (..., 11)
    lam = np.clip(np.asarray(lam_nm, np.float64), 320.0, 720.0)
    pos = (lam - 320.0) / 40.0
    lo = np.clip(pos.astype(int), 0, 10)
    hi = np.minimum(lo + 1, 10)
    frac = pos - lo
    return (1 - frac) * vals[..., lo] + frac * vals[..., hi]


def hosek_solar_radiance(elevation, gamma, lam_nm, turbidity: float):
    """Direct solar-disc radiance with limb darkening
    (arhosekskymodel_solar_radiance_internal2). Zero outside the disc."""
    tab = _hosek_tables()
    solar = tab["solar"].astype(np.float64)  # (11, 10, 45, 4)
    limb = tab["limb"].astype(np.float64)  # (11, 6)
    solar_radius = np.deg2rad(0.51) / 2.0
    sing = np.sin(np.asarray(gamma, np.float64))
    ar2 = 1.0 / np.sin(solar_radius) ** 2
    sc2 = np.maximum(1.0 - ar2 * sing * sing, 0.0)
    cosine = np.sqrt(sc2)

    t = float(np.clip(turbidity, 1.0, 10.0))
    turb_low = min(int(t) - 1, 8)
    turb_frac = t - (turb_low + 1)

    el = np.maximum(np.asarray(elevation, np.float64), 0.0)
    pieces = 45
    pos = np.minimum(
        ((2.0 * el / np.pi) ** (1.0 / 3.0) * pieces).astype(int), 44
    )
    break_x = (pos / pieces) ** 3.0 * (np.pi * 0.5)
    xx = el - break_x

    def sr(tb, wl):
        # coefs stored highest-order-first ending at order*(pos+1)-1;
        # the C code walks backwards: res = sum_i x^i * coefs[end - i].
        c = solar[wl, tb, pos]  # (..., 4) (piece-selected)
        return ((c[..., 0] * xx + c[..., 1]) * xx + c[..., 2]) * xx \
            + c[..., 3]

    lam = np.clip(np.asarray(lam_nm, np.float64), 320.0, 720.0)
    posw = (lam - 320.0) / 40.0
    wl_lo = np.clip(posw.astype(int), 0, 9)
    wl_frac = np.where(posw >= 10, 1.0, posw - wl_lo)
    out = np.zeros(np.broadcast(el, sing).shape + lam.shape)
    for i, (wl, wf) in enumerate(zip(wl_lo.reshape(-1),
                                     wl_frac.reshape(-1))):
        v = (1 - turb_frac) * ((1 - wf) * sr(turb_low, wl)
                               + wf * sr(turb_low, min(wl + 1, 10)))
        v = v + turb_frac * ((1 - wf) * sr(min(turb_low + 1, 9), wl)
                             + wf * sr(min(turb_low + 1, 9),
                                       min(wl + 1, 10)))
        ld = (1 - wf) * limb[wl] + wf * limb[min(wl + 1, 10)]
        dark = sum(ld[k] * cosine ** k for k in range(6))
        out[..., i] = v * dark
    return np.where((sing[..., None] ** 2) * ar2 < 1.0, out, 0.0)


def make_sky_latlong_hosek(res_y: int = 128, sun_elevation_deg: float = 30.0,
                           sun_azimuth_deg: float = 0.0,
                           turbidity: float = 3.0, albedo: float = 0.3,
                           with_sun: bool = True):
    """(res_y, 2*res_y, 3) lat-long RGB environment image via the
    Hosek-Wilkie spectral model: 16 wavelengths -> CIE XYZ -> linear sRGB.
    Replaces the Preetham fallback as imgtool makesky's default."""
    from ..core.cie import cie_xyz_np

    h, w = res_y, 2 * res_y
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = v * np.pi
    phi = u * 2.0 * np.pi
    tg, pg = np.meshgrid(theta, phi, indexing="ij")
    d = np.stack(
        [np.sin(tg) * np.cos(pg), np.sin(tg) * np.sin(pg), np.cos(tg)], -1
    )
    el = np.deg2rad(sun_elevation_deg)
    az = np.deg2rad(sun_azimuth_deg)
    sun = np.asarray(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)]
    )
    # theta from zenith (z up in this map's convention: d[...,2]=cos(theta))
    ct = np.clip(d[..., 2], -1.0, 1.0)
    th = np.arccos(np.clip(ct, 0.0, 1.0))
    sun_z = np.asarray([sun[0], sun[1], sun[2]])
    cg = np.clip(d @ sun_z, -1.0, 1.0)
    gamma = np.arccos(cg)

    lam = np.linspace(380.0, 720.0, 16)
    configs, radiances = hosek_configs(turbidity, albedo, el)
    spec = hosek_radiance(th, gamma, lam, configs, radiances)
    if with_sun:
        spec = spec + hosek_solar_radiance(
            np.pi / 2 - th, gamma, lam, turbidity
        )
    above = (d[..., 2] > 0.0)[..., None]
    spec = np.where(above, spec, 0.0)

    xyz_w = np.asarray(cie_xyz_np(lam))  # (16, 3)
    if xyz_w.shape[0] != 3:
        xyz_w = xyz_w.T
    dl = lam[1] - lam[0]
    xyz = np.einsum("...l,cl->...c", spec, xyz_w) * dl
    m = np.asarray([
        [3.2406, -1.5372, -0.4986],
        [-0.9689, 1.8758, 0.0415],
        [0.0557, -0.2040, 1.0570],
    ])
    rgb = np.einsum("ij,...j->...i", m, xyz)
    return np.clip(rgb, 0.0, None).astype(np.float32) * 0.01
