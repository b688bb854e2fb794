"""Portal-image infinite light (port of pbrt_tpu/lights/portal.py;
PortalImageInfiniteLight, lights.h:738).

The environment image is resampled into the portal's direction space, the
angles (alpha, beta) = (atan(x/z), atan(y/z)) in the portal's frame, where
the directions from any point through the rectangular portal form an
axis-aligned window of the image. A NEE sample draws from the windowed
luminance distribution (WindowedPiecewiseConstant2D), so every sample goes
through the portal. The portal is 4 corners, counter-clockwise seen from
the lit side; its frame's z points into the lit interior. Escaped rays
see the environment only through their origin's window, as in the
reference's Le.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import rgb2spec
from ..core.sampling import WindowedPiecewiseConstant2D
from ..core.take import take
from ..core.tensorclass import tensorclass
from ..core.vecmath import normalize
from .envmap import texel_flat_index

_PI = math.pi


@tensorclass
class PortalLight:
    corners: torch.Tensor  # (4, 3) portal rectangle, CCW from the lit side
    frame: torch.Tensor  # (3, 3) rows x, y, z (z = normal toward interior)
    coeffs: torch.Tensor  # (H, W, 3) per-texel unbounded spectrum fits
    scale_tx: torch.Tensor  # (H, W)
    dist: WindowedPiecewiseConstant2D
    strength: torch.Tensor  # ()

    @staticmethod
    def build(latlong_rgb, corners, res: int = 128, strength: float = 1.0):
        """latlong_rgb: (h, w, 3) equirectangular environment radiance;
        corners: (4, 3) portal rectangle (CCW from the lit side)."""
        corners = np.asarray(corners, np.float64)
        x = corners[1] - corners[0]
        y = corners[3] - corners[0]
        xh = x / np.linalg.norm(x)
        z = np.cross(x, y)
        zh = z / np.linalg.norm(z)
        yh = np.cross(zh, xh)
        frame = np.stack([xh, yh, zh])  # world -> portal rows

        # Resample the source into portal-direction space.
        u = (np.arange(res) + 0.5) / res
        uu, vv = np.meshgrid(u, u, indexing="xy")
        alpha = (uu - 0.5) * _PI
        beta = (vv - 0.5) * _PI
        wl = np.stack([np.tan(alpha), np.tan(beta), np.ones_like(alpha)], -1)
        wl /= np.linalg.norm(wl, axis=-1, keepdims=True)
        w_world = wl @ frame  # local -> world
        src = np.asarray(latlong_rgb, np.float32)
        sh, sw, _ = src.shape
        theta = np.arccos(np.clip(w_world[..., 2], -1, 1))
        phi = np.arctan2(w_world[..., 1], w_world[..., 0]) % (2 * np.pi)
        xi = np.clip((phi / (2 * np.pi) * sw).astype(int), 0, sw - 1)
        yi = np.clip((theta / np.pi * sh).astype(int), 0, sh - 1)
        img = src[yi, xi]  # (res, res, 3) portal-space radiance

        c, s = rgb2spec.fit_unbounded(img)
        return PortalLight(
            corners=torch.as_tensor(corners, dtype=torch.float32),
            frame=torch.as_tensor(frame, dtype=torch.float32),
            coeffs=c,
            scale_tx=s,
            dist=WindowedPiecewiseConstant2D.build(img.mean(-1)),
            strength=torch.tensor(strength, dtype=torch.float32),
        )

    # -- direction <-> image (lights.cpp ImageFromRender) ---------------------

    def _local(self, w):
        return torch.einsum("ij,...j->...i", self.frame, w)

    def dir_to_uv(self, w):
        wl = self._local(w)
        z = wl[..., 2]
        ok = z > 1e-6
        zs = torch.where(ok, z, 1.0)
        alpha = torch.atan2(wl[..., 0], zs)
        beta = torch.atan2(wl[..., 1], zs)
        return torch.stack([alpha / _PI + 0.5, beta / _PI + 0.5], dim=-1), ok

    def uv_to_dir(self, uv):
        alpha = (uv[..., 0] - 0.5) * _PI
        beta = (uv[..., 1] - 0.5) * _PI
        wl = normalize(torch.stack(
            [torch.tan(alpha), torch.tan(beta), torch.ones_like(alpha)], -1))
        return torch.einsum("ji,...j->...i", self.frame, wl)  # frame^T wl

    def _duv_dw(self, w):
        """d(uv area) / d(solid angle): pdf_dir = pdf_uv / this."""
        wl = self._local(w)
        x, y = wl[..., 0], wl[..., 1]
        z = torch.clamp(wl[..., 2], min=1e-6)
        return (_PI * _PI) * (z * z + x * x) * (z * z + y * y) / z

    def image_bounds(self, p):
        """The portal's uv window seen from points p (lights.cpp
        ImageBounds): ((..., 4) [x0, x1, y0, y1], visible)."""
        uv0, ok0 = self.dir_to_uv(normalize(self.corners[0][None] - p))
        uv2, ok2 = self.dir_to_uv(normalize(self.corners[2][None] - p))
        lo = torch.minimum(uv0, uv2)
        hi = torch.maximum(uv0, uv2)
        ok = ok0 & ok2
        b = torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]], -1)
        return torch.where(ok[..., None], b, 0.0), ok

    def _texel(self, uv, lam):
        i = texel_flat_index(uv, *self.scale_tx.shape)
        return rgb2spec.eval_unbounded(take(self.coeffs.flatten(0, 1), i),
                                       take(self.scale_tx.flatten(), i),
                                       lam) * self.strength

    # -- light interface -------------------------------------------------------

    def sample(self, u2, lam, p_ref):
        """NEE sample: (wi, L, solid-angle pdf); pdf 0 where the point
        cannot see the portal (behind its plane)."""
        b, ok = self.image_bounds(p_ref)
        uv, pdf_uv = self.dist.sample(u2, b)
        wi = self.uv_to_dir(uv)
        pdf = torch.where(ok & (pdf_uv > 0.0), pdf_uv / self._duv_dw(wi), 0.0)
        L = self._texel(uv, lam)
        return wi, torch.where((pdf > 0.0)[..., None], L, 0.0), pdf

    def pdf_dir(self, d, p_ref):
        b, ok = self.image_bounds(p_ref)
        uv, okd = self.dir_to_uv(d)
        pdf_uv = self.dist.pdf(uv, b)
        return torch.where(ok & okd, pdf_uv / self._duv_dw(d), 0.0)

    def radiance(self, d, lam, p_ref=None):
        """Escaped-ray radiance: the environment seen through the portal,
        zero for directions outside the origin's window."""
        uv, okd = self.dir_to_uv(d)
        if p_ref is not None:
            b, okp = self.image_bounds(p_ref)
            inside = ((uv[..., 0] >= b[..., 0]) & (uv[..., 0] <= b[..., 1])
                      & (uv[..., 1] >= b[..., 2]) & (uv[..., 1] <= b[..., 3]))
            okd = okd & okp & inside
        return torch.where(okd[..., None], self._texel(uv, lam), 0.0)

    @property
    def luminance(self):
        """The image's luminance, as EnvironmentMap has it."""
        return self.dist.func
