"""Quaternions for rotation interpolation (port of
pbrt_tpu/core/quaternion.py; quaternion.h in the reference renderer).

Layout (x, y, z, w), w the scalar part, as (..., 4) float32 tensors.
`quat_from_matrix` builds the four Shepperd candidates and keeps the best
conditioned one per matrix, branch free, as the reference does.
"""

from __future__ import annotations

import torch

from .floats import sqrt


def quat_identity() -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32)


def quat_from_axis_angle(axis, theta) -> torch.Tensor:
    axis = torch.as_tensor(axis, dtype=torch.float32)
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    theta = torch.as_tensor(theta, dtype=torch.float32)
    s = torch.sin(theta / 2.0)[..., None]
    w = torch.cos(theta / 2.0)[..., None]
    return torch.cat([axis * s, w.expand(s.shape)], dim=-1)


def quat_mul(a, b) -> torch.Tensor:
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_normalize(q) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_from_matrix(m) -> torch.Tensor:
    """3x3 rotation matrices (..., 3, 3) -> unit quaternions (..., 4)."""
    m = torch.as_tensor(m, dtype=torch.float32)

    def e(i, j):
        return m[..., i, j]

    t = e(0, 0) + e(1, 1) + e(2, 2)
    s0 = sqrt(torch.clamp(1.0 + t, min=1e-12))
    q0 = torch.stack([(e(2, 1) - e(1, 2)) / (2.0 * s0),
                      (e(0, 2) - e(2, 0)) / (2.0 * s0),
                      (e(1, 0) - e(0, 1)) / (2.0 * s0),
                      0.5 * s0], dim=-1)
    s1 = sqrt(torch.clamp(1.0 + e(0, 0) - e(1, 1) - e(2, 2), min=1e-12))
    q1 = torch.stack([0.5 * s1,
                      (e(0, 1) + e(1, 0)) / (2.0 * s1),
                      (e(0, 2) + e(2, 0)) / (2.0 * s1),
                      (e(2, 1) - e(1, 2)) / (2.0 * s1)], dim=-1)
    s2 = sqrt(torch.clamp(1.0 - e(0, 0) + e(1, 1) - e(2, 2), min=1e-12))
    q2 = torch.stack([(e(0, 1) + e(1, 0)) / (2.0 * s2),
                      0.5 * s2,
                      (e(1, 2) + e(2, 1)) / (2.0 * s2),
                      (e(0, 2) - e(2, 0)) / (2.0 * s2)], dim=-1)
    s3 = sqrt(torch.clamp(1.0 - e(0, 0) - e(1, 1) + e(2, 2), min=1e-12))
    q3 = torch.stack([(e(0, 2) + e(2, 0)) / (2.0 * s3),
                      (e(1, 2) + e(2, 1)) / (2.0 * s3),
                      0.5 * s3,
                      (e(1, 0) - e(0, 1)) / (2.0 * s3)], dim=-1)
    d = torch.stack([t, e(0, 0), e(1, 1), e(2, 2)], dim=-1)
    # The first of equal candidates, as jnp.argmax picks.
    best = torch.argmax(d, dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 4))[..., 0, :]
    return quat_normalize(q)


def quat_to_matrix(q) -> torch.Tensor:
    x, y, z, w = q.unbind(-1)
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                        2 * (x * z + y * w)], dim=-1)
    row1 = torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                        2 * (y * z - x * w)], dim=-1)
    row2 = torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                        1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def slerp(q0, q1, t) -> torch.Tensor:
    """Spherical linear interpolation (quaternion.h Slerp), branch free,
    with the lerp of near-parallel quaternions (cos > 0.9995)."""
    t = torch.as_tensor(t, dtype=torch.float32, device=q0.device)
    cos_th = torch.sum(q0 * q1, dim=-1)
    q1 = torch.where(cos_th[..., None] < 0.0, -q1, q1)
    cos_th = torch.abs(cos_th)
    near = cos_th > 0.9995
    theta = torch.arccos(torch.clamp(cos_th, -1.0, 1.0))
    sin_th = torch.clamp(torch.sin(theta), min=1e-9)
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / sin_th)
    w1 = torch.where(near, t, torch.sin(t * theta) / sin_th)
    return quat_normalize(w0[..., None] * q0 + w1[..., None] * q1)
