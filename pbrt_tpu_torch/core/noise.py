"""Perlin gradient noise, fBm and turbulence (port of
pbrt_tpu/core/noise.py; the reference renderer's util/noise.h).

Lattice gradients come from the pcg4d hash (core/rng.py), not from a
permutation table, so the noise equals the reference's at every point.
"""

from __future__ import annotations

import torch

from . import rng


def _gradient_dot(ix, iy, iz, fx, fy, fz):
    """Dot of a hashed lattice gradient with the offset vector."""
    h, _, _, _ = rng.pcg4d(ix, iy, iz, 0x9E3779B9)
    h = h & 15
    # Perlin's 12 gradient directions, selected branch-free.
    u = torch.where(h < 8, fx, fy)
    v = torch.where(h < 4, fy, torch.where((h == 12) | (h == 14), fx, fz))
    su = torch.where((h & 1) == 0, u, -u)
    sv = torch.where((h & 2) == 0, v, -v)
    return su + sv


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin(p):
    """Perlin noise at points p (..., 3) -> (...,), about [-1, 1]."""
    pi = torch.floor(p)
    pf = p - pi
    # int32 lattice ids, as the reference casts them; the hash reads their
    # two's-complement bits.
    ix = pi[..., 0].to(torch.int32)
    iy = pi[..., 1].to(torch.int32)
    iz = pi[..., 2].to(torch.int32)
    fx, fy, fz = pf[..., 0], pf[..., 1], pf[..., 2]
    u, v, w = _fade(fx), _fade(fy), _fade(fz)

    def g(dx, dy, dz):
        return _gradient_dot(
            ix + dx, iy + dy, iz + dz, fx - dx, fy - dy, fz - dz
        )

    x00 = g(0, 0, 0) + u * (g(1, 0, 0) - g(0, 0, 0))
    x10 = g(0, 1, 0) + u * (g(1, 1, 0) - g(0, 1, 0))
    x01 = g(0, 0, 1) + u * (g(1, 0, 1) - g(0, 0, 1))
    x11 = g(0, 1, 1) + u * (g(1, 1, 1) - g(0, 1, 1))
    y0 = x00 + v * (x10 - x00)
    y1 = x01 + v * (x11 - x01)
    return y0 + w * (y1 - y0)


def fbm(p, octaves: int = 6, omega: float = 0.5):
    """Fractional Brownian motion: noise summed over octaves."""
    total = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    lam = 1.0
    o = 1.0
    for _ in range(octaves):
        total = total + o * perlin(p * lam)
        lam *= 1.99
        o *= omega
    return total


def turbulence(p, octaves: int = 6, omega: float = 0.5):
    """Sum of |noise| over octaves (noise.cpp Turbulence)."""
    total = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    lam = 1.0
    o = 1.0
    for _ in range(octaves):
        total = total + o * torch.abs(perlin(p * lam))
        lam *= 1.99
        o *= omega
    return total
