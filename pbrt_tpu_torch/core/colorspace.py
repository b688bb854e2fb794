"""RGB colour spaces (port of pbrt_tpu/core/colorspace.py): sRGB,
Rec. 2020, DCI-P3 and ACES2065-1, the sRGB transfer function and white
balancing.

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

    def to_xyz(self, rgb: torch.Tensor) -> torch.Tensor:
        """(..., 3) linear RGB in this space -> XYZ (a float32 matmul)."""
        m = torch.as_tensor(self.xyz_from_rgb, dtype=rgb.dtype,
                            device=rgb.device)
        return rgb @ m.T


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
REC2020 = _make(
    "rec2020", [(0.708, 0.292), (0.170, 0.797), (0.131, 0.046)], _D65_XY
)
DCI_P3 = _make(
    "dci-p3", [(0.680, 0.320), (0.265, 0.690), (0.150, 0.060)], _D65_XY
)
ACES2065_1 = _make(
    "aces2065-1",
    [(0.7347, 0.2653), (0.0, 1.0), (0.0001, -0.077)],
    (0.32168, 0.33767),
)

COLOR_SPACES = {cs.name: cs for cs in (SRGB, REC2020, DCI_P3, ACES2065_1)}


def _on_tensor(fn, x):
    """fn applied to x as a tensor: a tensor stays one (its device and
    dtype); an array or number is computed in float32, as the reference's
    jnp arrays are, and returned as a numpy array."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    return fn(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def srgb_encode(linear):
    """Linear -> sRGB transfer function (IEC 61966-2-1); a tensor on any
    device, or a host array (imgtool's images)."""
    def encode(x):
        x = torch.clamp(x, 0.0, 1.0)
        return torch.where(
            x <= 0.0031308,
            12.92 * x,
            1.055 * torch.pow(torch.clamp(x, min=1e-8), 1.0 / 2.4) - 0.055,
        )

    return _on_tensor(encode, linear)


def srgb_decode(encoded):
    """sRGB -> linear (the inverse of srgb_encode)."""
    def decode(x):
        return torch.where(
            x <= 0.04045,
            x / 12.92,
            torch.pow((x + 0.055) / 1.055, 2.4),
        )

    return _on_tensor(decode, encoded)


def white_balance_matrix(src_xy, dst_xy) -> np.ndarray:
    """Von Kries adaptation in the (linear Bradford) cone space, on the
    host. Reference analogue: WhiteBalance (src/pbrt/util/color.cpp)."""
    bradford = np.array(
        [
            [0.8951, 0.2664, -0.1614],
            [-0.7502, 1.7135, 0.0367],
            [0.0389, -0.0685, 1.0296],
        ]
    )
    src = bradford @ _xyy_to_xyz(*src_xy)
    dst = bradford @ _xyy_to_xyz(*dst_xy)
    scale = np.diag(dst / src)
    return np.linalg.inv(bradford) @ scale @ bradford
