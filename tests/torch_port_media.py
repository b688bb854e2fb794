"""Shared pieces of the tests that hold the port's volumetric path against
the reference: the inset medium entry of cross-pipeline comparisons.

A ray enters a scene-level medium at t0, the entry into its AABB
(MediumBuffers.bounds_segment), and the delta-tracking walk's first step
looks up the majorant cell of p(t0), a point on the box's face. Where
p(t0) rounds to just outside the box, that step finds a majorant of 0
and only crosses into the grid, so the walk's step index, and with it
every later draw's dimension, moves on by one: another, equally valid
estimate. Two float pipelines (XLA on the CPU and PyTorch, or PyTorch on
the CPU and on the card) round camera and scattered directions otherwise
in the last bit, so a few percent of the lanes that enter the cloud shift
their draws (the cloud at 16x16, 2 spp, depth 6: 94.5% of sample values
agree). Comparisons of whole renders across pipelines therefore move the
entry 1e-5 of the segment into the box, in both packages alike
(`inset_entry`); then the cloud agrees on every sample value. The exact
entry is held by the image mean. This module imports torch only, so
chip_smoke.py can use it.
"""

from __future__ import annotations

import contextlib

import torch

# Fraction of the in-medium segment the entry moves inward.
ENTRY_INSET = 1e-5


@contextlib.contextmanager
def inset_entry(*medium_classes):
    """Within the block, each given MediumBuffers class (the reference's
    or the port's) starts its segments ENTRY_INSET of the segment inside
    the box. A JAX trace must be made inside the block to see it."""
    saved = [(cls, cls.bounds_segment) for cls in medium_classes]

    def inset(segment):
        def bounds_segment(self, o, d, t_max):
            t0, t1 = segment(self, o, d, t_max)
            t_in = t0 + ENTRY_INSET * (t1 - t0)
            if isinstance(t0, torch.Tensor):
                return torch.where(t1 > t0, t_in, t0), t1
            import jax.numpy as jnp

            return jnp.where(t1 > t0, t_in, t0), t1
        return bounds_segment

    try:
        for cls, segment in saved:
            cls.bounds_segment = inset(segment)
        yield
    finally:
        for cls, segment in saved:
            cls.bounds_segment = segment
