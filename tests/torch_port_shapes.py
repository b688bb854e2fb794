"""The shapes box and the moving instanced field of the port's tests, their
golden script and chip_smoke.py: tests/data/torch_port/shapes.pbrt
(every shape family and both kinds of shape alpha; K1 carries its
triangles) and tests/data/torch_port/motion.pbrt (six static and two
moving instances of an object with an alpha-cut fence; K3 walks the
static ones).

`coarse_alpha_keys` keys the stochastic alpha test on rounded ray bits in
both packages, for the render comparisons across float pipelines.
"""

from __future__ import annotations

import os

from .torch_port_families import coarse_mix_keys

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
SHAPES_PBRT = os.path.join(DATA, "shapes.pbrt")
MOTION_PBRT = os.path.join(DATA, "motion.pbrt")


def coarse_alpha_keys(*api_modules):
    """Within the block, each given `accel.api` module (the reference's or
    the port's) hashes the stochastic alpha test's uniform from the ray's
    origin and direction rounded to a grid of 1/256, as
    tests/torch_port_families.py's coarse_mix_keys rounds the mix hash's
    inputs (the same shim: the port's `_bits` wrapped, the reference's
    inline bitcast rounded first).

    The hash reads the bit patterns of o and d. A bounce ray starts at a
    hit point, whose t two float pipelines (the reference's watertight
    tester, the port's Moller-Trumbore in K1 and its twin) round
    differently in the last bit, so the exact keys re-draw the alpha 0.5
    panel's test on such lanes. Rounded to the grid, a lane re-keys only
    where a component lies within a few ulps of a half-step. The exact
    keys are held bit for bit at op level (tests/test_torch_alpha.py). A
    JAX trace must be made inside the block to see it. This module imports
    numpy and torch only, so chip_smoke.py can use it."""
    return coarse_mix_keys(*api_modules)
