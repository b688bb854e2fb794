"""Stateless counter-based RNG, bit-exact with pbrt_tpu/core/rng.py.

Every random number is a pure hash of its coordinates (pixel, sample index,
dimension, seed), so a ray can be replayed exactly and the port draws the
very same numbers as the JAX reference. PyTorch has no full uint32
arithmetic, so uint32 values live in int64 tensors kept in [0, 2^32):
every add and multiply is reduced with `& 0xFFFFFFFF`, and right shifts of
such values are logical because the sign bit of the int64 is never set.
A product of two 32-bit values can reach 2^64 and overflow int64, so
`_mul` splits one operand into 16-bit halves (every partial product stays
below 2^49).
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _u32(x):
    if isinstance(x, int):
        return x & _M32
    return torch.as_tensor(x).to(torch.int64) & _M32


def _mul(a, b):
    """(a * b) mod 2^32 for uint32 values held in int64 (or Python ints)."""
    if isinstance(a, int) and isinstance(b, int):
        return (a * b) & _M32
    if isinstance(b, int):
        a, b = b, a
    if isinstance(a, int) and a < (1 << 31):
        return (b * a) & _M32  # < 2^63: no overflow
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_u32(x):
    """lowbias32 finalizer (Wellons): uint32 -> well-mixed uint32 (int64)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul(x, 0x846CA68B)
    return x ^ (x >> 16)


def pcg4d(a, b, c, d):
    """4D -> 4D hash; returns four decorrelated uint32 streams (int64)."""
    v0, v1, v2, v3 = _u32(a), _u32(b), _u32(c), _u32(d)
    mul = 1664525
    inc = 1013904223
    v0 = (_mul(v0, mul) + inc) & _M32
    v1 = (_mul(v1, mul) + inc) & _M32
    v2 = (_mul(v2, mul) + inc) & _M32
    v3 = (_mul(v3, mul) + inc) & _M32
    v0 = (v0 + _mul(v1, v3)) & _M32
    v1 = (v1 + _mul(v2, v0)) & _M32
    v2 = (v2 + _mul(v0, v1)) & _M32
    v3 = (v3 + _mul(v1, v2)) & _M32
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)
    v0 = (v0 + _mul(v1, v3)) & _M32
    v1 = (v1 + _mul(v2, v0)) & _M32
    v2 = (v2 + _mul(v0, v1)) & _M32
    v3 = (v3 + _mul(v1, v2)) & _M32
    return v0, v1, v2, v3


def u32_to_uniform(bits):
    """uint32 -> float32 in [0, 1) using the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def uniform_1d(pixel, sample, dim, seed=0):
    """One uniform float per (pixel, sample, dimension, seed) coordinate."""
    v0, _, _, _ = pcg4d(pixel, sample, dim, seed)
    return u32_to_uniform(v0)


def uniform_2d(pixel, sample, dim, seed=0):
    v0, v1, _, _ = pcg4d(pixel, sample, dim, seed)
    return u32_to_uniform(v0), u32_to_uniform(v1)


def uniform_4d(pixel, sample, dim, seed=0):
    return tuple(u32_to_uniform(v) for v in pcg4d(pixel, sample, dim, seed))
