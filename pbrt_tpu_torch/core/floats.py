"""ULP stepping of float32 values (port of the NextFloatUp / NextFloatDown
pair of pbrt_tpu/core/floats.py; float.h in the reference renderer), and
the error-free product behind the watertight triangle test's edge
functions (`two_prod`, `difference_of_products`).

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

`erfinv` is XLA's float32 ErfInv as the reference's CPU build computes it
(jax.scipy.special.erfinv, the MLT integrator's Gaussian step): Giles'
two polynomials in w = -log1p(-x^2), with XLA's own log1p (a Cephes
rational for |y| < sqrt(2) - 1, else its Cephes log of 1 + y) and the
multiply-adds its compiler fuses done as single roundings (`_fma`).
torch.special.erfinv is another approximation; one ulp in a mutated
sample moves a chain's path, so the port takes the reference's bits.
"""

from __future__ import annotations

import functools
import math

import numpy as np
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


def _dekker_split(a):
    """Veltkamp split: a = hi + lo with hi holding the top 12 bits."""
    c = 4097.0 * a  # 2^12 + 1
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: a * b = p + err (math.h TwoProd), by Dekker's
    split in plain IEEE operations, never the `a * b - p` idiom, whose
    contraction to a fused multiply-add would depend on the compiler.
    Every eager PyTorch op rounds once, on the CPU and on the card."""
    p = a * b
    ah, al = _dekker_split(a)
    bh, bl = _dekker_split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def difference_of_products(a, b, c, d):
    """a * b - c * d with its round-off corrected (math.h:57). Exactly
    antisymmetric: difference_of_products(c, d, a, b) is the exact
    negation, and equal products give exactly zero, which the watertight
    triangle test's shared edges rely on."""
    p1, e1 = two_prod(a, b)
    p2, e2 = two_prod(c, d)
    return (p1 - p2) + (e1 - e2)


def grad_flows(*xs) -> bool:
    """Whether autograd will differentiate through one of the tensors xs:
    the gradient-safe forms (a where in front of a division or a sqrt, so
    that a lane a where drops passes 0 and not 0 * inf) run only then,
    and a render without a gradient launches none of their kernels."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


@functools.cache
def scalar(value: float, device: torch.device) -> torch.Tensor:
    """A float32 0-d tensor of `value` on `device`, made once: an operand
    of torch.maximum / minimum (whose ties pass half the gradient, as
    jnp.maximum's do) without a host copy at every call."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def fma(a, b, c) -> torch.Tensor:
    """a * b + c of float32 tensors with one rounding, as the multiply-adds
    that XLA's CPU compiler contracts: the product is exact in float64,
    and the float64 sum is rounded to float32 (a second rounding that
    changes the result only when the float64 sum lands on a float32
    half-way point)."""
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).float()


def recip(x) -> float:
    """1 / x as the float32 by which the reference's jitted code multiplies
    where it divides by the constant x (XLA's CPU build rewrites a
    division by a constant so)."""
    return float(np.float32(1.0) / np.float32(x))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.double()).float()


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The angle of (x, y) in [-pi, pi], signed zeros and the axes as
    torch.atan2 (the value an ulp or so apart), by lane alone. Its
    gradient is atan2's, (x, -y) / (x^2 + y^2), and 0 at the origin."""
    if torch.is_grad_enabled() and (y.requires_grad or x.requires_grad):
        return _Atan2.apply(y, x)
    return _atan2(y, x)


class _Atan2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, x):
        ctx.save_for_backward(y, x)
        return _atan2(y, x)

    @staticmethod
    def backward(ctx, g):
        y, x = ctx.saved_tensors
        r2 = x * x + y * y
        k = torch.where(r2 > 0.0, g / torch.where(r2 > 0.0, r2, 1.0), 0.0)
        return k * x, -k * y


def _atan2(y, x):
    pi = torch.where(torch.signbit(y), -math.pi, math.pi)
    left = torch.signbit(x)
    a = torch.atan(y / x)  # y / +-0 = +-inf: +-pi/2 on the y axis
    a = torch.where(left, a + pi, a)
    origin = (x == 0.0) & (y == 0.0)
    return torch.where(origin, torch.where(left, pi, y), a)


def sinh(x: torch.Tensor) -> torch.Tensor:
    """sinh by lane alone: (expm1(x) - expm1(-x)) / 2."""
    return (torch.expm1(x) - torch.expm1(-x)) * 0.5


def _r32(x: torch.Tensor) -> torch.Tensor:
    """A float64 tensor rounded to float32 values (kept in float64)."""
    return x.float().double()


def _c32(c: float) -> float:
    """A constant as the float32 XLA holds it."""
    return float(np.float32(c))


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c of float32 values held in float64 tensors, with one
    rounding to float32: the product is exact in float64, and the sum's
    one float64 rounding is then rounded to float32."""
    return _r32(a * b + c)


def _horner(x, coeffs):
    """XLA's EvaluatePolynomial: p = p * x + c from p = 0, fused."""
    p = torch.full_like(x, _c32(coeffs[0]))
    for c in coeffs[1:]:
        p = _fma(p, x, _c32(c))
    return p


# XLA's log1p for |y| < sqrt(2) - 1 (elemental_ir_emitter.cc EmitLog1p).
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# XLA's CPU log (polynomial_approximations.cc, the Cephes logf).
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
# Giles' erfinv polynomials for w < 5 and w >= 5 (math.cc ErfInv32).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _xla_log(v: torch.Tensor) -> torch.Tensor:
    """XLA's float32 CPU log of positive finite v (float32): mantissa in
    [0.5, 1) shifted to [sqrt(1/2) - 1, sqrt(2) - 1), a degree-8
    polynomial, the exponent's log 2 in two parts. Returns float64
    holding float32 values."""
    v = torch.clamp(v, min=1.17549435e-38)
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    low = m < 0.707106781186547524
    x = ((m - 1.0) + torch.where(low, m, 0.0)).double()
    e = (e - torch.where(low, 1.0, 0.0)).double()
    x2 = _r32(x * x)
    x3 = _r32(x2 * x)
    p = [_c32(c) for c in _LOG_P]
    y = _fma(x, p[0], p[1])
    y1 = _fma(x, p[3], p[4])
    y2 = _fma(x, p[6], p[7])
    y = _fma(y, x, p[2])
    y1 = _fma(y1, x, p[5])
    y2 = _fma(y2, x, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _r32(_c32(-2.12194440e-4) * e))
    x = _r32(_r32(x - _r32(0.5 * x2)) + y)
    return _r32(x + _r32(0.693359375 * e))


def _xla_log1p(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 CPU log1p of float32 y; float64 holding float32
    values."""
    yd = y.double()
    y2 = _r32(yd * yd)
    small = _r32(_horner(yd, _LOG1P_NUM) / _horner(yd, _LOG1P_DEN))
    small = _r32(_r32(yd * y2) * small)
    small = _r32(yd + _fma(y2, -0.5, small))
    return torch.where(torch.abs(y) < 0.41421356237309504880, small,
                       _xla_log(1.0 + y))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ErfInv of float32 x (see the module docstring); +-1
    map to +-inf, as XLA's do."""
    w = -_xla_log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, _r32(w - 2.5), _r32(torch.sqrt(w)) - 3.0)
    lt5 = [_c32(c) for c in _ERFINV_LT5]
    ge5 = [_c32(c) for c in _ERFINV_GE5]
    p = torch.where(lt, lt5[0], ge5[0]).double()
    for a, b in zip(lt5[1:], ge5[1:]):
        p = _fma(p, w, torch.where(lt, a, b))
    return torch.where(torch.abs(x) == 1.0, x * float("inf"),
                       (p * x.double()).float())
