"""MIP map: an image pyramid with trilinear and EWA filtered lookups
(port of pbrt_tpu/core/mipmap.py; the reference renderer's util/mipmap.h).

The pyramid is one flat (T, C) texel table with per-level (offset, width,
height) tuples, so a lookup at a per-ray level is index arithmetic into
one tensor. Levels are 2x2 box averages of an image padded up to powers
of two by edge replication (the reference renderer resamples with a
windowed sinc where sizes are not powers of two). The pyramid is built on
the host in numpy, bit-equal to the reference's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .take import take
from .tensorclass import static_field, tensorclass


def _pow2_pad(img):
    """Pad (H, W, C) up to power-of-two sizes by edge replication."""
    h, w = img.shape[:2]
    h2 = 1 << (h - 1).bit_length()
    w2 = 1 << (w - 1).bit_length()
    if (h2, w2) != (h, w):
        img = np.pad(img, ((0, h2 - h), (0, w2 - w), (0, 0)), mode="edge")
    return img


def build_pyramid(image) -> list:
    """Every 2x box-filtered level down to 1x1 (numpy, on the host)."""
    img = _pow2_pad(np.asarray(image, np.float32))
    levels = [img]
    while img.shape[0] > 1 or img.shape[1] > 1:
        if img.shape[0] > 1 and img.shape[1] > 1:
            nxt = 0.25 * (
                img[0::2, 0::2] + img[1::2, 0::2]
                + img[0::2, 1::2] + img[1::2, 1::2]
            )
        elif img.shape[0] > 1:
            nxt = 0.5 * (img[0::2] + img[1::2])
        else:
            nxt = 0.5 * (img[:, 0::2] + img[:, 1::2])
        levels.append(nxt.astype(np.float32))
        img = nxt
    return levels


def level_table(offsets, widths, heights, device) -> torch.Tensor:
    """(3, L) int32 rows of per-level offsets, widths and heights, made
    once on the texels' device so a lookup copies nothing from the host."""
    return torch.tensor([offsets, widths, heights], dtype=torch.int32,
                        device=device)


@tensorclass
class MIPMap:
    """Flat-table mip pyramid of one image; see the module docstring."""

    flat: torch.Tensor  # (T, C) every level, row-major, concatenated
    offsets: tuple = static_field()  # per-level texel offset
    widths: tuple = static_field()
    heights: tuple = static_field()
    wrap: str = static_field(default="repeat")  # repeat | clamp
    # level_table(offsets, widths, heights) on flat's device. Derived.
    levels: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "levels", level_table(
            self.offsets, self.widths, self.heights, self.flat.device))

    @staticmethod
    def build(image, wrap: str = "repeat") -> "MIPMap":
        levels = build_pyramid(image)
        offs, ws, hs = [], [], []
        o = 0
        for lv in levels:
            offs.append(o)
            hs.append(lv.shape[0])
            ws.append(lv.shape[1])
            o += lv.shape[0] * lv.shape[1]
        flat = np.concatenate([lv.reshape(-1, lv.shape[-1]) for lv in levels])
        return MIPMap(flat=torch.from_numpy(flat), offsets=tuple(offs),
                      widths=tuple(ws), heights=tuple(hs), wrap=wrap)

    @property
    def n_levels(self) -> int:
        return len(self.offsets)

    def _wrap(self, i, n):
        if self.wrap == "repeat":
            return torch.remainder(i, n)  # floor-mod, as jnp.mod
        return torch.minimum(torch.clamp(i, min=0), n - 1)

    def _level(self, level_idx):
        li = torch.clamp(level_idx, 0, self.n_levels - 1).long()
        off, w, h = self.levels[:, li]
        return off, w, h

    def _texel(self, level_idx, x, y):
        """Texels at per-ray integer levels, through flat index math."""
        off, w, h = self._level(level_idx)
        idx = off + self._wrap(y, h) * w + self._wrap(x, w)
        return take(self.flat, idx.long()), w, h

    def _bilerp_level(self, level_idx, uv):
        """Bilinear lookup at per-ray levels (MIPMap::Bilerp)."""
        off, w, h = self._level(level_idx)
        x = uv[..., 0] * w.to(torch.float32) - 0.5
        y = uv[..., 1] * h.to(torch.float32) - 0.5
        x0 = torch.floor(x).to(torch.int32)
        y0 = torch.floor(y).to(torch.int32)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]

        def tx(xi, yi):
            idx = off + self._wrap(yi, h) * w + self._wrap(xi, w)
            return take(self.flat, idx.long())

        return (
            tx(x0, y0) * (1 - fx) * (1 - fy)
            + tx(x0 + 1, y0) * fx * (1 - fy)
            + tx(x0, y0 + 1) * (1 - fx) * fy
            + tx(x0 + 1, y0 + 1) * fx * fy
        )

    def lookup_trilinear(self, uv, width):
        """Isotropic filtered lookup (MIPMap::Filter, trilinear): width is
        the largest screen-space uv extent; the two levels whose texel
        spacing brackets it are blended."""
        n = self.n_levels
        lod = n - 1 + torch.log2(torch.clamp(width, min=1e-8))
        lod = torch.clamp(lod, 0.0, n - 1 - 1e-4)
        l0 = torch.floor(lod).to(torch.int32)
        f = (lod - l0)[..., None]
        a = self._bilerp_level(l0, uv)
        b = self._bilerp_level(l0 + 1, uv)
        return a * (1 - f) + b * f

    def lookup_ewa(self, uv, duv0, duv1, max_aniso: float = 8.0,
                   window: int = 6):
        """EWA anisotropic lookup (MIPMap::EWA): an elliptical Gaussian in
        uv with the two screen differentials as axes, at the level of the
        minor axis, summed over a fixed window x window texel footprint
        (the reference's static footprint; wider ellipses are cut to it).
        Falls back to the level's bilinear value where no texel weighs."""
        d0 = torch.sqrt(torch.sum(duv0 * duv0, dim=-1))
        d1 = torch.sqrt(torch.sum(duv1 * duv1, dim=-1))
        major = torch.maximum(d0, d1)
        minor = torch.minimum(d0, d1)
        # Eccentricity clamp: major / minor <= max_aniso.
        minor = torch.maximum(minor, major / max_aniso)
        minor = torch.clamp(minor, min=1e-8)

        n = self.n_levels
        lod = torch.clamp(n - 1 + torch.log2(minor), 0.0, n - 1 - 1e-4)
        li = torch.floor(lod).to(torch.int32)
        wf = self.levels[1, li.long()].to(torch.float32)
        hf = self.levels[2, li.long()].to(torch.float32)

        # The ellipse A u^2 + B u v + C v^2 = F in the level's texel space.
        scale = torch.stack([wf, hf], -1)
        d0t = duv0 * scale
        d1t = duv1 * scale
        A = d0t[..., 1] ** 2 + d1t[..., 1] ** 2 + 1.0
        B = -2.0 * (d0t[..., 0] * d0t[..., 1] + d1t[..., 0] * d1t[..., 1])
        C = d0t[..., 0] ** 2 + d1t[..., 0] ** 2 + 1.0
        invF = 1.0 / torch.clamp(A * C - 0.25 * B * B, min=1e-12)
        A, B, C = A * invF, B * invF, C * invF

        cx = uv[..., 0] * wf - 0.5
        cy = uv[..., 1] * hf - 0.5
        x0 = torch.round(cx).to(torch.int32) - window // 2
        y0 = torch.round(cy).to(torch.int32) - window // 2

        acc = torch.zeros(uv.shape[:-1] + (self.flat.shape[-1],),
                          dtype=torch.float32, device=uv.device)
        wsum = torch.zeros(uv.shape[:-1], dtype=torch.float32, device=uv.device)
        floor_w = math.exp(-2.0)
        for dy in range(window):
            for dx in range(window):
                xi = x0 + dx
                yi = y0 + dy
                du = xi.to(torch.float32) - cx
                dv = yi.to(torch.float32) - cy
                r2 = A * du * du + B * du * dv + C * dv * dv
                wgt = torch.where(r2 < 1.0, torch.exp(-2.0 * r2) - floor_w, 0.0)
                tex, _, _ = self._texel(li, xi, yi)
                acc = acc + tex * wgt[..., None]
                wsum = wsum + wgt
        fallback = self._bilerp_level(li, uv)
        ok = wsum > 1e-8
        return torch.where(
            ok[..., None], acc / torch.clamp(wsum, min=1e-8)[..., None],
            fallback)
