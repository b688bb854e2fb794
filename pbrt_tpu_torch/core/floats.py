"""ULP stepping of float32 values (port of the NextFloatUp / NextFloatDown
pair of pbrt_tpu/core/floats.py; float.h in the reference renderer).

The step works on the float's bits viewed as int32: for a non-negative
float the next one up is bits + 1, for a negative one bits - 1, which is
the reference's uint32 arithmetic on the same bit patterns.

`sqrt` is the correctly rounded float32 square root, which XLA and CUDA
give and PyTorch's vectorised CPU kernel does not always (about 0.7% of
float32 inputs come out one ulp off): it is taken in float64 and rounded
once, which is exact for float32 (53 >= 2 * 24 + 2 bits).
"""

from __future__ import annotations

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
