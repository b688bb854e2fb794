"""Chebyshev series for smooth spectral curves (port of core/cheb.py).

Coefficients are fitted on the host with numpy (identical code to the
reference, so identical float32 coefficients); evaluation is the same
Clenshaw recurrence on tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def chebfit_fn(fn, lo: float, hi: float, deg: int) -> np.ndarray:
    """Fit fn on [lo, hi] with a degree-`deg` Chebyshev series (host)."""
    k = np.arange(deg + 1)
    # Chebyshev nodes of the first kind.
    xn = np.cos(np.pi * (k + 0.5) / (deg + 1))
    x = 0.5 * (hi - lo) * xn + 0.5 * (hi + lo)
    y = np.asarray(fn(x), np.float64)
    c = np.polynomial.chebyshev.chebfit(xn, y, deg)
    return c.astype(np.float32)


def chebeval(x: torch.Tensor, coeffs: np.ndarray, lo: float, hi: float):
    """Clenshaw evaluation, vectorized over x (any shape)."""
    t = (2.0 * x - (hi + lo)) / (hi - lo)
    t = torch.clamp(t, -1.0, 1.0)
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for c in coeffs[:0:-1]:  # c_deg ... c_1
        b1, b2 = 2.0 * t * b1 - b2 + float(c), b1
    return t * b1 - b2 + float(coeffs[0])


def chebeval_np(x, coeffs: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Host-side Clenshaw mirror of chebeval (float32 arithmetic)."""
    t = (2.0 * np.asarray(x, np.float32) - np.float32(hi + lo)) / np.float32(
        hi - lo
    )
    t = np.clip(t, -1.0, 1.0)
    b1 = np.zeros_like(t)
    b2 = np.zeros_like(t)
    for c in coeffs[:0:-1]:
        b1, b2 = np.float32(2.0) * t * b1 - b2 + np.float32(c), b1
    return t * b1 - b2 + np.float32(coeffs[0])
