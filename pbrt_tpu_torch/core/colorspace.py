"""RGB colour spaces (port of pbrt_tpu/core/colorspace.py, sRGB slice).

Matrices are derived on the host with numpy from the published primary
chromaticities, with the reference's exact code, so they are identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _xyy_to_xyz(x: float, y: float, Y: float = 1.0) -> np.ndarray:
    return np.array([x * Y / y, Y, (1.0 - x - y) * Y / y])


def _rgb_to_xyz_matrix(primaries, white_xy) -> np.ndarray:
    """Standard derivation: scale primary XYZ columns to hit the white point."""
    cols = np.stack([_xyy_to_xyz(x, y) for x, y in primaries], axis=1)
    white = _xyy_to_xyz(*white_xy)
    s = np.linalg.solve(cols, white)
    return cols * s[None, :]


@dataclasses.dataclass(frozen=True)
class RGBColorSpace:
    name: str
    primaries: tuple
    white_xy: tuple
    rgb_from_xyz: np.ndarray
    xyz_from_rgb: np.ndarray

    def to_rgb(self, xyz: torch.Tensor) -> torch.Tensor:
        """(..., 3) XYZ -> linear RGB in this space (a float32 matmul)."""
        m = torch.as_tensor(self.rgb_from_xyz, dtype=xyz.dtype,
                            device=xyz.device)
        return xyz @ m.T


def _make(name, primaries, white_xy) -> RGBColorSpace:
    m = _rgb_to_xyz_matrix(primaries, white_xy)
    return RGBColorSpace(
        name=name,
        primaries=tuple(primaries),
        white_xy=tuple(white_xy),
        rgb_from_xyz=np.linalg.inv(m),
        xyz_from_rgb=m,
    )


_D65_XY = (0.3127, 0.3290)

SRGB = _make("srgb", [(0.64, 0.33), (0.30, 0.60), (0.15, 0.06)], _D65_XY)

COLOR_SPACES = {SRGB.name: SRGB}
