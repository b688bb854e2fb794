"""Sampling warps and tabulated distributions (port of core/sampling.py:
the warps the path integrator and the lights use, PiecewiseConstant1D/2D
and WindowedPiecewiseConstant2D)."""

from __future__ import annotations

import math

import numpy as np
import torch

from .tensorclass import tensorclass

INV_PI = 1.0 / math.pi


def sample_uniform_disk_concentric(u):
    """Shirley-Chiu concentric map: [0,1]^2 -> unit disk. u: (..., 2)."""
    uo = 2.0 * u - 1.0
    x, y = uo[..., 0], uo[..., 1]
    zero = (x == 0.0) & (y == 0.0)
    use_x = torch.abs(x) > torch.abs(y)
    r = torch.where(use_x, x, y)
    safe = torch.where(r == 0.0, 1.0, r)
    theta = torch.where(
        use_x,
        (math.pi / 4.0) * (y / safe),
        (math.pi / 2.0) - (math.pi / 4.0) * (x / safe),
    )
    p = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    return torch.where(zero[..., None], 0.0, p)


def sample_cosine_hemisphere(u):
    d = sample_uniform_disk_concentric(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    return torch.cat([d, z[..., None]], dim=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def sample_uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


UNIFORM_SPHERE_PDF = 1.0 / (4.0 * math.pi)


def sample_uniform_triangle(u):
    """Low-distortion triangle warp returning barycentrics (b0, b1, b2)
    (the sqrt-free fold: split the square along the diagonal)."""
    u0, u1 = u[..., 0], u[..., 1]
    flip = u0 < u1
    b0 = torch.where(flip, u0 / 2.0, u0 - u1 / 2.0)
    b1 = torch.where(flip, u1 - b0, u1 / 2.0)
    return torch.stack([b0, b1, 1.0 - b0 - b1], dim=-1)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """Veach's beta=2 power heuristic (sampling.h PowerHeuristic)."""
    f = nf * f_pdf
    g = ng * g_pdf
    w = f * f / torch.clamp(f * f + g * g, min=1e-38)
    return torch.where(f_pdf > 0.0, w, 0.0)


def sample_uniform_cone(u, cos_theta_max):
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta],
        dim=-1,
    )


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * math.pi * (1.0 - cos_theta_max))


# --- Piecewise-constant distributions ----------------------------------------
#
# Tables are built on the host in float32 numpy. Their running sums follow
# the reference's: XLA's CPU backend rewrites a cumulative sum into blocks
# of 16 (a serial prefix inside each block, then the blocks' totals
# prefixed the same way and added), so `_cumsum_f32` does the same and the
# port's tables equal the reference's bit for bit.

_SCAN_BLOCK = 16


def _cumsum_f32(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Inclusive float32 prefix sum along `axis`, in XLA's CPU order."""
    x = np.moveaxis(np.asarray(x, np.float32), axis, -1)
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        out = np.cumsum(x, axis=-1, dtype=np.float32)
    else:
        m = -(-n // _SCAN_BLOCK)
        pad = np.zeros(x.shape[:-1] + (m * _SCAN_BLOCK - n,), np.float32)
        blocks = np.concatenate([x, pad], -1).reshape(
            x.shape[:-1] + (m, _SCAN_BLOCK))
        inner = np.cumsum(blocks, axis=-1, dtype=np.float32)
        before = _cumsum_f32(inner[..., -1])[..., :-1]
        before = np.concatenate(
            [np.zeros(before.shape[:-1] + (1,), np.float32), before], -1)
        out = (inner + before[..., None]).reshape(
            x.shape[:-1] + (m * _SCAN_BLOCK,))[..., :n]
    return np.moveaxis(out, -1, axis)


def _gather_last(table, idx):
    """table[..., idx] per batch element: (..., n) x (...) -> (...)."""
    return torch.gather(table, -1, idx[..., None])[..., 0]


@tensorclass
class PiecewiseConstant1D:
    """Tabulated 1D distribution over [lo, hi] (sampling.h
    PiecewiseConstant1D), batched over the table's leading axes.

    func: (..., n) non-negative; cdf: (..., n+1); integral: (...,)."""

    func: torch.Tensor
    cdf: torch.Tensor
    integral: torch.Tensor
    lo: float = 0.0
    hi: float = 1.0

    @staticmethod
    def build(func, lo: float = 0.0, hi: float = 1.0) -> "PiecewiseConstant1D":
        func = np.abs(np.asarray(func, np.float32))
        n = func.shape[-1]
        width = np.float32((hi - lo) / n)
        partial = _cumsum_f32(func * width)
        integral = partial[..., -1]
        cdf_un = np.concatenate([np.zeros_like(partial[..., :1]), partial], -1)
        # A degenerate all-zero function gets the uniform cdf.
        uniform = np.arange(n + 1, dtype=np.float32) / np.float32(n)
        cdf = np.where((integral > 0.0)[..., None],
                       cdf_un / np.maximum(integral[..., None],
                                           np.float32(1e-38)),
                       uniform).astype(np.float32)
        return PiecewiseConstant1D(
            func=torch.from_numpy(func), cdf=torch.from_numpy(cdf),
            integral=torch.from_numpy(np.asarray(integral, np.float32)),
            lo=float(lo), hi=float(hi),
        )

    @property
    def n(self) -> int:
        return self.func.shape[-1]

    def sample(self, u):
        """Returns (x, pdf, bin index), batched over the table's leading
        axes (u broadcasts against them)."""
        n = self.n
        batch = torch.broadcast_shapes(self.cdf.shape[:-1], u.shape)
        u = u.expand(batch)
        cdf = self.cdf.expand(batch + (n + 1,))
        # The number of cdf entries <= u, less one.
        if self.cdf.dim() == 1:
            below = torch.searchsorted(self.cdf[:-1], u.contiguous(),
                                       right=True)
        else:
            below = torch.searchsorted(cdf[..., :-1].contiguous(),
                                       u[..., None].contiguous(),
                                       right=True)[..., 0]
        idx = torch.clamp(below - 1, 0, n - 1)
        c0 = _gather_last(cdf, idx)
        c1 = _gather_last(cdf, idx + 1)
        du = torch.where(c1 > c0, (u - c0) / torch.clamp(c1 - c0, min=1e-38),
                         0.0)
        f = _gather_last(self.func.expand(batch + (n,)), idx)
        integral = self.integral.expand(batch)
        pdf = torch.where(integral > 0.0, f / torch.clamp(integral, min=1e-38),
                          1.0 / (self.hi - self.lo))
        x = self.lo + (idx.to(torch.float32) + du) / n * (self.hi - self.lo)
        return x, pdf, idx

    def pdf(self, x):
        n = self.n
        batch = torch.broadcast_shapes(self.func.shape[:-1], x.shape)
        t = (x.expand(batch) - self.lo) / (self.hi - self.lo)
        idx = torch.clamp((t * n).to(torch.int32), 0, n - 1).long()
        f = _gather_last(self.func.expand(batch + (n,)), idx)
        integral = self.integral.expand(batch)
        return torch.where(integral > 0.0, f / torch.clamp(integral, min=1e-38),
                           1.0 / (self.hi - self.lo))


@tensorclass
class PiecewiseConstant2D:
    """2D tabulated distribution over [0,1]^2: the marginal over rows and
    the conditional over columns (sampling.h PiecewiseConstant2D).
    func: (ny, nx)."""

    conditional: PiecewiseConstant1D  # batched over rows: func (ny, nx)
    marginal: PiecewiseConstant1D  # func (ny,)

    @staticmethod
    def build(func) -> "PiecewiseConstant2D":
        func = np.abs(np.asarray(func, np.float32))
        conditional = PiecewiseConstant1D.build(func)
        marginal = PiecewiseConstant1D.build(conditional.integral.numpy())
        return PiecewiseConstant2D(conditional=conditional, marginal=marginal)

    def sample(self, u):
        """u: (..., 2) -> ((..., 2) point in [0,1]^2, pdf)."""
        v, pdf_v, iy = self.marginal.sample(u[..., 1])
        c = self.conditional
        row = PiecewiseConstant1D(func=c.func[iy], cdf=c.cdf[iy],
                                  integral=c.integral[iy], lo=c.lo, hi=c.hi)
        x, pdf_x, _ = row.sample(u[..., 0])
        return torch.stack([x, v], dim=-1), pdf_v * pdf_x

    def pdf(self, p):
        ny, nx = self.conditional.func.shape
        ix = torch.clamp((p[..., 0] * nx).to(torch.int32), 0, nx - 1).long()
        iy = torch.clamp((p[..., 1] * ny).to(torch.int32), 0, ny - 1).long()
        f = self.conditional.func[iy, ix]
        integral = self.marginal.integral
        return torch.where(integral > 0.0, f / torch.clamp(integral, min=1e-38),
                           1.0)


@tensorclass
class WindowedPiecewiseConstant2D:
    """Piecewise-constant 2D distribution sampled within per-query windows
    (sampling.h WindowedPiecewiseConstant2D): a summed-area table answers
    the integral over any [x0,x1]x[y0,y1] window, and sampling inverts the
    windowed marginal and conditional cdfs by a fixed number of vectorised
    bisection steps."""

    func: torch.Tensor  # (ny, nx)
    sat: torch.Tensor  # (ny + 1, nx + 1) inclusive summed-area table

    @staticmethod
    def build(func) -> "WindowedPiecewiseConstant2D":
        f = np.abs(np.asarray(func, np.float32))
        ny, nx = f.shape
        sat = _cumsum_f32(_cumsum_f32(f, axis=0), axis=1) / np.float32(nx * ny)
        sat = np.pad(sat, ((1, 0), (1, 0))).astype(np.float32)
        return WindowedPiecewiseConstant2D(func=torch.from_numpy(f),
                                           sat=torch.from_numpy(sat))

    def _sat_lookup(self, x, y):
        """The SAT at (x, y) in [0,1]^2, bilinear between its entries (exact
        for the piecewise-constant integrand)."""
        ny, nx = self.func.shape
        fx = torch.clamp(x, 0.0, 1.0) * nx
        fy = torch.clamp(y, 0.0, 1.0) * ny
        x0 = torch.clamp(torch.floor(fx).to(torch.int32), 0, nx - 1)
        y0 = torch.clamp(torch.floor(fy).to(torch.int32), 0, ny - 1)
        tx = fx - x0
        ty = fy - y0
        x0, y0 = x0.long(), y0.long()
        v00 = self.sat[y0, x0]
        v10 = self.sat[y0, x0 + 1]
        v01 = self.sat[y0 + 1, x0]
        v11 = self.sat[y0 + 1, x0 + 1]
        return (v00 * (1 - tx) * (1 - ty) + v10 * tx * (1 - ty)
                + v01 * (1 - tx) * ty + v11 * tx * ty)

    def window_integral(self, b):
        """Integral over windows b = (..., 4) [x0, x1, y0, y1]."""
        return (self._sat_lookup(b[..., 1], b[..., 3])
                - self._sat_lookup(b[..., 0], b[..., 3])
                - self._sat_lookup(b[..., 1], b[..., 2])
                + self._sat_lookup(b[..., 0], b[..., 2]))

    def sample(self, u2, b):
        """Sample within windows b: ((..., 2) point, pdf), the pdf with
        respect to the unit square, normalised over the window."""
        ny, nx = self.func.shape
        n_steps = max(nx, ny).bit_length() + 6
        bint = self.window_integral(b)
        ok = bint > 0.0
        x0, x1 = b[..., 0], b[..., 1]
        y0, y1 = b[..., 2], b[..., 3]
        lookup = self._sat_lookup

        def fx(x):  # integral over [x0, x] x [y0, y1]
            return (lookup(x, y1) - lookup(x, y0) - lookup(x0, y1)
                    + lookup(x0, y0))

        target_x = u2[..., 0] * torch.clamp(bint, min=1e-38)
        lo, hi = x0, x1
        for _ in range(n_steps):
            mid = 0.5 * (lo + hi)
            below = fx(mid) < target_x
            lo = torch.where(below, mid, lo)
            hi = torch.where(below, hi, mid)
        px = 0.5 * (lo + hi)

        # The conditional in y over the sampled x's one-texel column.
        xs = torch.clamp(torch.floor(px * nx), 0.0, nx - 1.0) / nx
        xe = xs + 1.0 / nx

        def fy(y):
            return (lookup(xe, y) - lookup(xs, y) - lookup(xe, y0)
                    + lookup(xs, y0))

        target_y = u2[..., 1] * torch.clamp(fy(y1), min=1e-38)
        lo, hi = y0, y1
        for _ in range(n_steps):
            mid = 0.5 * (lo + hi)
            below = fy(mid) < target_y
            lo = torch.where(below, mid, lo)
            hi = torch.where(below, hi, mid)
        py = 0.5 * (lo + hi)

        p = torch.stack([px, py], dim=-1)
        pdf = self.pdf(p, b)
        return torch.where(ok[..., None], p, 0.5), torch.where(ok, pdf, 0.0)

    def pdf(self, p, b):
        """Window-normalised density at p (0 outside the window)."""
        ny, nx = self.func.shape
        ix = torch.clamp((p[..., 0] * nx).to(torch.int32), 0, nx - 1).long()
        iy = torch.clamp((p[..., 1] * ny).to(torch.int32), 0, ny - 1).long()
        f = self.func[iy, ix]
        bint = self.window_integral(b)
        inside = ((p[..., 0] >= b[..., 0]) & (p[..., 0] <= b[..., 1])
                  & (p[..., 1] >= b[..., 2]) & (p[..., 1] <= b[..., 3]))
        return torch.where(inside & (bint > 0.0),
                           f / torch.clamp(bint, min=1e-38), 0.0)
