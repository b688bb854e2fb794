"""Ray-spawning helpers of pbrt_tpu/accel/dense.py.

The dense (watertight, XLA-blocked) testers themselves are not ported: the
small-scene kernel K1 answers every query of this slice.
"""

from __future__ import annotations

import torch

from ..core.vecmath import dot


def offset_ray_origin(p, n, d):
    """Spawn-ray origin offset to avoid self-intersection: a scale-aware
    epsilon along the geometric normal, signed toward the outgoing side."""
    scale = torch.clamp(torch.amax(torch.abs(p), dim=-1, keepdim=True), min=1.0)
    eps = 1e-4 * scale
    sign = torch.where(dot(n, d, keepdims=True) >= 0.0, 1.0, -1.0)
    return p + sign * eps * n


def shadow_segment(p, n, wi, dist):
    """Robust shadow segment from a surface point to a light sample
    (Interaction::SpawnRayTo): both ends are offset off their surfaces and
    t_max is parametric in the re-aimed segment.

    Returns (origin, direction, t_max); infinite dist keeps the original
    direction with a large t_max.
    """
    so = offset_ray_origin(p, n, wi)
    finite = torch.isfinite(dist)
    dist_f = torch.where(finite, dist, 1.0)
    target = p + wi * dist_f[..., None]
    seg = target - so
    seg_len = torch.clamp(torch.sqrt(torch.sum(seg * seg, dim=-1)), min=1e-20)
    wi2 = torch.where(finite[..., None], seg / seg_len[..., None], wi)
    smax = torch.where(finite, seg_len * (1.0 - 1e-3), 1e30)
    return so, wi2, smax
