"""Interval arithmetic for conservative floating-point error tracking
(port of pbrt_tpu/core/interval.py; util/interval.h in the reference).

An Interval [lo, hi] holds the exact real result of a chain of float32
operations: after each operation the lower bound steps one float down and
the upper one float up (core/floats.py). Vectorised over tensors; used by
the robust ray-sphere quadratic (accel/dense.py).
"""

from __future__ import annotations

import dataclasses

import torch

from .floats import next_float_down, next_float_up, sqrt


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class Interval:
    lo: torch.Tensor
    hi: torch.Tensor

    @staticmethod
    def exact(v) -> "Interval":
        v = _f32(v)
        return Interval(lo=v, hi=v)

    @staticmethod
    def from_value_and_error(v, err) -> "Interval":
        v, err = _f32(v), _f32(err)
        return Interval(lo=next_float_down(v - err),
                        hi=next_float_up(v + err))

    @property
    def midpoint(self):
        return 0.5 * (self.lo + self.hi)

    @property
    def width(self):
        return self.hi - self.lo

    def contains(self, v):
        return (v >= self.lo) & (v <= self.hi)

    def __add__(self, o):
        o = _as_interval(o)
        return Interval(lo=next_float_down(self.lo + o.lo),
                        hi=next_float_up(self.hi + o.hi))

    def __sub__(self, o):
        o = _as_interval(o)
        return Interval(lo=next_float_down(self.lo - o.hi),
                        hi=next_float_up(self.hi - o.lo))

    def __neg__(self):
        return Interval(lo=-self.hi, hi=-self.lo)

    def __mul__(self, o):
        o = _as_interval(o)
        a, b, c, d = (self.lo * o.lo, self.lo * o.hi, self.hi * o.lo,
                      self.hi * o.hi)
        lo = torch.minimum(torch.minimum(a, b), torch.minimum(c, d))
        hi = torch.maximum(torch.maximum(a, b), torch.maximum(c, d))
        return Interval(lo=next_float_down(lo), hi=next_float_up(hi))

    def __truediv__(self, o):
        o = _as_interval(o)
        # Division by an interval containing 0 -> the whole real line
        # (interval.h operator/ semantics).
        straddles = (o.lo <= 0.0) & (o.hi >= 0.0)
        a, b, c, d = (self.lo / o.lo, self.lo / o.hi, self.hi / o.lo,
                      self.hi / o.hi)
        lo = next_float_down(torch.minimum(torch.minimum(a, b),
                                           torch.minimum(c, d)))
        hi = next_float_up(torch.maximum(torch.maximum(a, b),
                                         torch.maximum(c, d)))
        inf = float("inf")
        return Interval(lo=torch.where(straddles, -inf, lo),
                        hi=torch.where(straddles, inf, hi))

    def sqr(self):
        alo = torch.abs(self.lo)
        ahi = torch.abs(self.hi)
        lo = torch.minimum(alo, ahi)
        hi = torch.maximum(alo, ahi)
        spans_zero = (self.lo < 0.0) & (self.hi > 0.0)
        return Interval(
            lo=torch.where(spans_zero, 0.0, next_float_down(lo * lo)),
            hi=next_float_up(hi * hi),
        )

    def sqrt(self):
        return Interval(
            lo=next_float_down(sqrt(torch.clamp(self.lo, min=0.0))),
            hi=next_float_up(sqrt(torch.clamp(self.hi, min=0.0))),
        )


def _as_interval(x) -> Interval:
    return x if isinstance(x, Interval) else Interval.exact(x)


def interval_quadratic(a: Interval, b: Interval, c: Interval):
    """Conservative quadratic roots (interval.h Quadratic): returns
    (t0, t1, has_roots) where t0/t1 are Intervals bounding the true roots."""
    disc = b.sqr() - (a * c) * Interval.exact(4.0)
    has = disc.hi >= 0.0
    root = Interval(lo=torch.clamp(disc.lo, min=0.0),
                    hi=torch.clamp(disc.hi, min=0.0)).sqrt()
    half = Interval.exact(0.5)
    r1 = ((-b) + root) * half / a
    r2 = ((-b) - root) * half / a
    t0 = Interval(lo=torch.minimum(r1.lo, r2.lo),
                  hi=torch.minimum(r1.hi, r2.hi))
    t1 = Interval(lo=torch.maximum(r1.lo, r2.lo),
                  hi=torch.maximum(r1.hi, r2.hi))
    return t0, t1, has
