"""Zero-gradient wrappers for intersection queries (port of ops/detach.py).

Visibility is discrete: gradients flow through shading, emission and light
radiance at FIXED hit points, while geometry is detached. The reference
gives its Pallas queries a custom VJP with zero cotangents; here the
inputs are detached and the query runs under no_grad, so its outputs carry
no gradient — the same detached-geometry stance.
"""

from __future__ import annotations

import functools

import torch


def detached_query(impl):
    """Wrap impl(accel, o, d, tmax, **kwargs) so no gradient reaches or
    leaves the query."""

    @functools.wraps(impl)
    def wrapper(accel, o, d, tmax, **kwargs):
        with torch.no_grad():
            return impl(accel, o.detach(), d.detach(), tmax.detach(), **kwargs)

    return wrapper
