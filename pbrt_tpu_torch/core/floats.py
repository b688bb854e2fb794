"""ULP stepping of float32 values (port of the NextFloatUp / NextFloatDown
pair of pbrt_tpu/core/floats.py; float.h in the reference renderer).

The step works on the float's bits viewed as int32: for a non-negative
float the next one up is bits + 1, for a negative one bits - 1, which is
the reference's uint32 arithmetic on the same bit patterns.

`sqrt` is the correctly rounded float32 square root, which XLA and CUDA
give and PyTorch's vectorised CPU kernel does not always (about 0.7% of
float32 inputs come out one ulp off): it is taken in float64 and rounded
once, which is exact for float32 (53 >= 2 * 24 + 2 bits).

`atan2` and `sinh` give a lane the same bits wherever it sits in its
tensor. PyTorch's CPU atan2 and sinh round the vector loop's body and its
scalar tail differently, and a tensor's split between threads moves the
tail, so a lane's value depends on its position and on the thread count;
the sorted shading dispatch (materials/sorted.py) moves lanes, and must
give the bits of the lockstep chain. They are built from atan, expm1 and
division, which round the same everywhere.
"""

from __future__ import annotations

import math

import torch


def _f32(f) -> torch.Tensor:
    return torch.as_tensor(f, dtype=torch.float32)


def next_float_up(f) -> torch.Tensor:
    """Smallest float32 strictly greater than f; +inf maps to itself and
    -0 is treated as +0 first."""
    f = _f32(f)
    f0 = torch.where(f == 0.0, 0.0, f)
    b = f0.view(torch.int32)
    up = torch.where(f0 >= 0.0, b + 1, b - 1).view(torch.float32)
    return torch.where(torch.isposinf(f), f, up)


def next_float_down(f) -> torch.Tensor:
    """Largest float32 strictly less than f; -inf maps to itself and +0 is
    treated as -0 first."""
    f = _f32(f)
    f0 = torch.where(f == 0.0, -0.0, f)
    b = f0.view(torch.int32)
    down = torch.where(f0 > 0.0, b - 1, b + 1).view(torch.float32)
    return torch.where(torch.isneginf(f), f, down)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.double()).float()


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The angle of (x, y) in [-pi, pi], signed zeros and the axes as
    torch.atan2 (the value an ulp or so apart), by lane alone."""
    pi = torch.where(torch.signbit(y), -math.pi, math.pi)
    left = torch.signbit(x)
    a = torch.atan(y / x)  # y / +-0 = +-inf: +-pi/2 on the y axis
    a = torch.where(left, a + pi, a)
    origin = (x == 0.0) & (y == 0.0)
    return torch.where(origin, torch.where(left, pi, y), a)


def sinh(x: torch.Tensor) -> torch.Tensor:
    """sinh by lane alone: (expm1(x) - expm1(-x)) / 2."""
    return (torch.expm1(x) - torch.expm1(-x)) * 0.5
