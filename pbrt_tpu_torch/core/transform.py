"""Homogeneous transforms (port of core/transform.py: Transform, look_at)."""

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

    def apply_point(self, p):
        r = p @ self.m[:3, :3].T + self.m[:3, 3]
        w = p @ self.m[3, :3] + self.m[3, 3]
        return r / w[..., None]

    def apply_vector(self, v):
        return v @ self.m[:3, :3].T


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
