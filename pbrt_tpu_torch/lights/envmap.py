"""Image-based infinite light on the equal-area octahedral map (port of
pbrt_tpu/lights/envmap.py; ImageInfiniteLight, lights.h:557-640).

An equal-area octahedral environment image with a PiecewiseConstant2D
importance distribution over its luminance. The map's Jacobian is the
constant 4 pi, so a pdf over the square becomes a solid-angle pdf by one
division. RGB texels are fitted to sigmoid-polynomial spectra at build
time, on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import rgb2spec
from ..core.sampling import PiecewiseConstant2D
from ..core.tensorclass import tensorclass
from ..core.vecmath import (
    equal_area_sphere_to_square,
    equal_area_square_to_sphere,
)

_INV_4PI = 1.0 / (4.0 * math.pi)


def texel_index(uv, h: int, w: int):
    """Nearest texel (row, column) of uv in [0,1]^2 on an h x w image."""
    xi = torch.clamp((uv[..., 0] * w).to(torch.int32), 0, w - 1).long()
    yi = torch.clamp((uv[..., 1] * h).to(torch.int32), 0, h - 1).long()
    return yi, xi


@tensorclass
class EnvironmentMap:
    coeffs: torch.Tensor  # (H, W, 3) sigmoid coefficients per texel
    scale: torch.Tensor  # (H, W) spectrum scale per texel
    dist: PiecewiseConstant2D  # importance distribution over the map
    luminance: torch.Tensor  # (H, W)
    strength: torch.Tensor  # () global scale

    @staticmethod
    def build(rgb_image, strength: float = 1.0) -> "EnvironmentMap":
        """rgb_image: (H, W, 3) linear RGB in the equal-area octahedral
        layout (`from_latlong` resamples an equirectangular image)."""
        img = np.asarray(rgb_image, np.float32)
        coeffs, scale = rgb2spec.fit_unbounded(img)
        # The channel mean as the reference's XLA computes it: the sum
        # times float32(1/3).
        lum = (img[..., 0] + img[..., 1] + img[..., 2]) * np.float32(1.0 / 3.0)
        return EnvironmentMap(
            coeffs=coeffs,
            scale=scale,
            dist=PiecewiseConstant2D.build(np.maximum(lum, np.float32(1e-9))),
            luminance=torch.from_numpy(lum),
            strength=torch.tensor(strength, dtype=torch.float32),
        )

    @staticmethod
    def from_latlong(latlong_rgb, out_res: int = 256, strength: float = 1.0):
        """Resample an equirectangular (lat-long) image onto the octahedral
        layout (imgtool makeequiarea), nearest texel."""
        src = np.asarray(latlong_rgb, np.float32)
        sh, sw, _ = src.shape
        u = (np.arange(out_res) + 0.5) / out_res
        uu, vv = np.meshgrid(u, u, indexing="xy")
        p = np.stack([uu, vv], axis=-1).reshape(-1, 2)
        d = equal_area_square_to_sphere(
            torch.from_numpy(p.astype(np.float32))).numpy()
        theta = np.arccos(np.clip(d[:, 2], -1, 1))
        phi = np.arctan2(d[:, 1], d[:, 0]) % (2 * np.pi)
        x = np.clip((phi / (2 * np.pi) * sw).astype(int), 0, sw - 1)
        y = np.clip((theta / np.pi * sh).astype(int), 0, sh - 1)
        return EnvironmentMap.build(src[y, x].reshape(out_res, out_res, 3),
                                    strength)

    @property
    def resolution(self):
        return tuple(self.luminance.shape)

    def _radiance_at(self, uv, lam):
        yi, xi = texel_index(uv, *self.resolution)
        return rgb2spec.eval_unbounded(self.coeffs[yi, xi],
                                       self.scale[yi, xi], lam) * self.strength

    def radiance(self, directions, lam):
        """L for rays escaping in `directions`: (N, 3) x (N, S) -> (N, S)."""
        return self._radiance_at(equal_area_sphere_to_square(directions), lam)

    def sample(self, u2, lam):
        """Importance-sample a direction: (wi, L, solid-angle pdf)."""
        uv, pdf_uv = self.dist.sample(u2)
        wi = equal_area_square_to_sphere(uv)
        return wi, self._radiance_at(uv, lam), pdf_uv * _INV_4PI

    def pdf_dir(self, directions):
        """Solid-angle pdf that `sample` picks these directions."""
        return self.dist.pdf(equal_area_sphere_to_square(directions)) * _INV_4PI
