"""Auxiliary-guided cross-bilateral denoiser.

A copy of pbrt_tpu/utils/denoise.py (numpy only), so the port needs
nothing of the reference package.

Reference analogue: the GPU OptiX denoiser hook (gpu/denoiser.*) and
imgtool's `denoise` command. The reference delegates to a vendor neural
denoiser; this is an open joint-bilateral filter guided by the renderer's
own GBuffer AOVs (albedo + shading normal + depth), the classic
feature-guided reconstruction baseline those denoisers descend from. Pure
vectorized numpy — the filter loops over WINDOW OFFSETS (shifted whole
images), never over pixels.
"""

from __future__ import annotations

import numpy as np


def _shift(img, dy, dx):
    """Edge-padded shift of (H, W, C) by (dy, dx)."""
    h, w = img.shape[:2]
    ys = np.clip(np.arange(h) + dy, 0, h - 1)
    xs = np.clip(np.arange(w) + dx, 0, w - 1)
    return img[ys][:, xs]


def denoise(color, albedo=None, normal=None, depth=None, radius: int = 5,
            sigma_spatial: float = 2.0, sigma_color: float = 0.35,
            sigma_albedo: float = 0.12, sigma_normal: float = 0.25,
            sigma_depth: float = 0.02):
    """Cross-bilateral filtered (H, W, 3) image.

    color: the noisy radiance; albedo/normal (H, W, 3) and depth (H, W)
    are optional guides (pass the GBuffer AOVs — edges present in guides
    are preserved, noise uncorrelated with them is averaged away).
    """
    c = np.asarray(color, np.float64)
    h, w = c.shape[:2]
    # Luminance-normalized color distance tames fireflies.
    lum = c.mean(-1, keepdims=True)
    acc = np.zeros_like(c)
    wacc = np.zeros((h, w, 1))
    dep = None
    if depth is not None:
        d = np.asarray(depth, np.float64)
        dep = d / max(float(np.percentile(d[np.isfinite(d)], 95)), 1e-9)
        dep = np.nan_to_num(dep, posinf=2.0)[..., None]
    alb = None if albedo is None else np.asarray(albedo, np.float64)
    nrm = None if normal is None else np.asarray(normal, np.float64)

    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            wgt = np.exp(
                -(dy * dy + dx * dx) / (2.0 * sigma_spatial ** 2)
            )
            sc = _shift(c, dy, dx)
            dlum = np.abs(_shift(lum, dy, dx) - lum) / (lum + 0.25)
            wgt = wgt * np.exp(
                -(dlum ** 2) / (2.0 * sigma_color ** 2)
            )[..., 0][..., None]
            if alb is not None:
                da = np.abs(_shift(alb, dy, dx) - alb).mean(
                    -1, keepdims=True
                )
                wgt = wgt * np.exp(-(da ** 2) / (2.0 * sigma_albedo ** 2))
            if nrm is not None:
                dn = 1.0 - np.clip(
                    (_shift(nrm, dy, dx) * nrm).sum(-1, keepdims=True),
                    -1.0, 1.0,
                )
                wgt = wgt * np.exp(-(dn ** 2) / (2.0 * sigma_normal ** 2))
            if dep is not None:
                dd = np.abs(_shift(dep, dy, dx) - dep)
                wgt = wgt * np.exp(-(dd ** 2) / (2.0 * sigma_depth ** 2))
            acc += sc * wgt
            wacc += wgt
    return (acc / np.maximum(wacc, 1e-12)).astype(np.float32)
