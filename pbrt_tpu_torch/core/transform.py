"""Homogeneous transforms (port of core/transform.py: Transform, translate,
scale, rotate, look_at).

The builders make their float32 matrices with the reference's numpy code,
so the parser's float64 CTM (io/parser.py) is the same to the bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .tensorclass import tensorclass


@tensorclass
class Transform:
    m: torch.Tensor  # (4, 4)
    m_inv: torch.Tensor  # (4, 4)

    @staticmethod
    def from_matrix(m) -> "Transform":
        m = torch.as_tensor(np.asarray(m, np.float32))
        return Transform(m=m, m_inv=torch.linalg.inv(m))

    def inverse(self) -> "Transform":
        return Transform(m=self.m_inv, m_inv=self.m)

    def apply_point(self, p):
        r = p @ self.m[:3, :3].T + self.m[:3, 3]
        w = p @ self.m[3, :3] + self.m[3, 3]
        return r / w[..., None]

    def apply_vector(self, v):
        return v @ self.m[:3, :3].T


def _pair(m, mi) -> Transform:
    return Transform(m=torch.from_numpy(m), m_inv=torch.from_numpy(mi))


def translate(delta) -> Transform:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = delta
    mi = np.eye(4, dtype=np.float32)
    mi[:3, 3] = -np.asarray(delta)
    return _pair(m, mi)


def scale(s) -> Transform:
    s = np.broadcast_to(np.asarray(s, dtype=np.float32), (3,))
    m = np.diag(np.append(s, 1.0)).astype(np.float32)
    mi = np.diag(np.append(1.0 / s, 1.0)).astype(np.float32)
    return _pair(m, mi)


def rotate(axis, angle_deg: float) -> Transform:
    """Rotation about an arbitrary axis (Rodrigues), matching pbrt Rotate."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    theta = np.deg2rad(angle_deg)
    s, c = np.sin(theta), np.cos(theta)
    K = np.array(
        [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]], dtype=np.float64
    )
    r = np.eye(3) + s * K + (1 - c) * (K @ K)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = r.astype(np.float32)
    mi = np.eye(4, dtype=np.float32)
    mi[:3, :3] = r.T.astype(np.float32)
    return _pair(m, mi)


def look_at(eye, target, up) -> Transform:
    """Camera-to-world transform, pbrt LookAt convention (left-handed:
    camera looks down +z; transform.cpp LookAt)."""
    eye = np.asarray(eye, dtype=np.float64)
    dir_ = np.asarray(target, dtype=np.float64) - eye
    dir_ = dir_ / np.linalg.norm(dir_)
    up_n = np.asarray(up, dtype=np.float64)
    up_n = up_n / np.linalg.norm(up_n)
    right = np.cross(up_n, dir_)
    nr = np.linalg.norm(right)
    if nr < 1e-8:
        raise ValueError("LookAt: up vector parallel to viewing direction")
    right = right / nr
    new_up = np.cross(dir_, right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = dir_
    m[:3, 3] = eye
    return Transform.from_matrix(m)
