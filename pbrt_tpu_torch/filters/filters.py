"""Pixel reconstruction filters with tabulated importance sampling (port of
pbrt_tpu/filters/filters.py).

A Filter holds its signed values on a table x table grid over
[-rx, rx] x [-ry, ry] and the PiecewiseConstant2D of their magnitudes
(FilterSampler, filters.h:26), both built on the host with the
reference's numpy code. GetCameraSample importance-samples the pixel
offset and weights the sample by sign(f) times int |f| / int f, so a box
or any positive filter carries weight exactly 1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.floats import fma, recip
from ..core.sampling import PiecewiseConstant2D
from ..core.tensorclass import static_field, tensorclass

# The kinds and their default radii (the reference's).
DEFAULT_RADIUS = {
    "box": (0.5, 0.5),
    "triangle": (2.0, 2.0),
    "gaussian": (1.5, 1.5),
    "mitchell": (2.0, 2.0),
    "lanczos": (4.0, 4.0),
}


def _mitchell_1d(x, b=1.0 / 3.0, c=1.0 / 3.0):
    x = np.abs(2.0 * x)
    y = np.where(
        x > 1.0,
        (-b - 6 * c) * x**3 + (6 * b + 30 * c) * x**2
        + (-12 * b - 48 * c) * x + (8 * b + 24 * c),
        (12 - 9 * b - 6 * c) * x**3 + (-18 + 12 * b + 6 * c) * x**2
        + (6 - 2 * b),
    ) * (1.0 / 6.0)
    return np.where(x > 2.0, 0.0, y)


def _sinc(x):
    x = np.abs(x)
    return np.where(x < 1e-5, 1.0, np.sin(np.pi * x) / (np.pi * x + 1e-12))


def _windowed_sinc(x, radius, tau=3.0):
    return np.where(np.abs(x) > radius, 0.0, _sinc(x) * _sinc(x / tau))


def _eval_2d(kind: str, x, y, radius):
    rx, ry = radius
    if kind == "box":
        return np.where((np.abs(x) <= rx) & (np.abs(y) <= ry), 1.0, 0.0)
    if kind == "triangle":
        return np.maximum(rx - np.abs(x), 0.0) * np.maximum(ry - np.abs(y), 0.0)
    if kind == "gaussian":
        def g(v, s):
            return np.exp(-0.5 * (v / s) ** 2) - np.exp(-0.5 * (3.0) ** 2)

        return (np.maximum(g(x, rx / 3.0), 0.0)
                * np.maximum(g(y, ry / 3.0), 0.0))
    if kind == "mitchell":
        return _mitchell_1d(x / rx) * _mitchell_1d(y / ry)
    if kind == "lanczos":
        return _windowed_sinc(x, rx) * _windowed_sinc(y, ry)
    raise ValueError(f"unknown filter kind {kind!r}")


@tensorclass
class FilterSample:
    p: torch.Tensor  # (..., 2) offset from the pixel centre
    weight: torch.Tensor  # (...,) sign(f) * int |f| / int f


@tensorclass
class Filter:
    dist: PiecewiseConstant2D
    values: torch.Tensor  # (ny, nx) signed filter values on the table grid
    kind: str = static_field(default="box")
    radius: tuple = static_field(default=(0.5, 0.5))
    integral_ratio: float = static_field(default=1.0)  # int f / int |f|

    @staticmethod
    def create(kind: str = "box", radius=None, table: int = 32) -> "Filter":
        if kind not in DEFAULT_RADIUS:
            raise ValueError(f"unknown filter kind {kind!r}; the kinds are "
                             f"{sorted(DEFAULT_RADIUS)}")
        radius = tuple(radius) if radius is not None else DEFAULT_RADIUS[kind]
        rx, ry = radius
        xs = (np.arange(table) + 0.5) / table * 2 * rx - rx
        ys = (np.arange(table) + 0.5) / table * 2 * ry - ry
        xg, yg = np.meshgrid(xs, ys, indexing="xy")
        vals = _eval_2d(kind, xg, yg, radius).astype(np.float32)
        ratio = float(vals.sum() / max(np.abs(vals).sum(), 1e-9))
        return Filter(dist=PiecewiseConstant2D.build(np.abs(vals)),
                      values=torch.from_numpy(vals), kind=kind, radius=radius,
                      integral_ratio=ratio)

    def evaluate(self, p):
        """Signed filter value at offsets p (..., 2) (nearest table cell)."""
        ny, nx = self.values.shape
        rx, ry = self.radius
        u = (p[..., 0] + rx) * recip(2 * rx)
        v = (p[..., 1] + ry) * recip(2 * ry)
        xi = torch.clamp((u * nx).to(torch.int32), 0, nx - 1).long()
        yi = torch.clamp((v * ny).to(torch.int32), 0, ny - 1).long()
        inside = (torch.abs(p[..., 0]) <= rx) & (torch.abs(p[..., 1]) <= ry)
        return torch.where(inside, self.values[yi, xi], 0.0)

    def sample(self, u2) -> FilterSample:
        """Importance-sample an offset (FilterSampler::Sample): weight =
        sign(f) * int |f| / int f, exactly 1 for a positive filter."""
        uv, _ = self.dist.sample(u2)
        rx, ry = self.radius
        # uv * 2r - r with one rounding, as the reference's jitted
        # multiply-add.
        p = torch.stack([fma(uv[..., 0], 2 * rx, -rx),
                         fma(uv[..., 1], 2 * ry, -ry)], dim=-1)
        f = self.evaluate(p)
        ratio = self.integral_ratio
        w = (torch.sign(f) / max(abs(ratio), 1e-6)
             * float(np.sign(np.float32(ratio))))
        return FilterSample(p=p, weight=w)
