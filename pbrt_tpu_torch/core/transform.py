"""Homogeneous transforms (port of core/transform.py: Transform, translate,
scale, rotate, rotate_x / _y / _z, look_at, perspective,
AnimatedTransform).

The builders make their float32 matrices with the reference's numpy code,
so the parser's float64 CTM (io/parser.py) is the same to the bit.
An AnimatedTransform's keyframes are decomposed on the host with the
reference's numpy code (polar decomposition of the float32 matrices);
`interpolate_matrices` recomposes them per ray time with torch ops.
"""

from __future__ import annotations

import numpy as np
import torch

from .quaternion import quat_from_matrix, quat_to_matrix, slerp
from .tensorclass import static_field, tensorclass


@tensorclass
class Transform:
    m: torch.Tensor  # (4, 4)
    m_inv: torch.Tensor  # (4, 4)

    @staticmethod
    def identity() -> "Transform":
        eye = torch.eye(4, dtype=torch.float32)
        return Transform(m=eye, m_inv=eye)

    @staticmethod
    def from_matrix(m) -> "Transform":
        m = torch.as_tensor(np.asarray(m, np.float32))
        return Transform(m=m, m_inv=torch.linalg.inv(m))

    def inverse(self) -> "Transform":
        return Transform(m=self.m_inv, m_inv=self.m)

    def __matmul__(self, other: "Transform") -> "Transform":
        return Transform(m=self.m @ other.m, m_inv=other.m_inv @ self.m_inv)

    def apply_point(self, p):
        r = p @ self.m[:3, :3].T + self.m[:3, 3]
        w = p @ self.m[3, :3] + self.m[3, 3]
        return r / w[..., None]

    def apply_vector(self, v):
        return v @ self.m[:3, :3].T

    def apply_normal(self, n):
        # Normals transform by the inverse transpose.
        return n @ self.m_inv[:3, :3]

    def apply_ray(self, o, d):
        return self.apply_point(o), self.apply_vector(d)

    def swaps_handedness(self):
        return torch.linalg.det(self.m[:3, :3]) < 0.0


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


def rotate_x(angle_deg: float) -> Transform:
    return rotate((1.0, 0.0, 0.0), angle_deg)


def rotate_y(angle_deg: float) -> Transform:
    return rotate((0.0, 1.0, 0.0), angle_deg)


def rotate_z(angle_deg: float) -> Transform:
    return rotate((0.0, 0.0, 1.0), angle_deg)


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


def perspective(fov_deg: float, z_near: float = 1e-2,
                z_far: float = 1000.0) -> Transform:
    """Perspective projection, pbrt convention (camera space -> NDC
    depth)."""
    inv_tan = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
    persp = np.array(
        [
            [1, 0, 0, 0],
            [0, 1, 0, 0],
            [0, 0, z_far / (z_far - z_near), -z_far * z_near / (z_far - z_near)],
            [0, 0, 1, 0],
        ],
        dtype=np.float32,
    )
    s = np.diag([inv_tan, inv_tan, 1.0, 1.0]).astype(np.float32)
    return Transform.from_matrix(s @ persp)


def _decompose(m):
    """(translation, rotation, scale) of a 4x4 keyframe: the polar
    decomposition by averaging with the inverse transpose
    (transform.cpp Decompose), in the matrix's own float32, as the
    reference's numpy code runs it."""
    m = np.asarray(m)
    t = m[:3, 3]
    a = m[:3, :3]
    r = a.copy()
    for _ in range(100):
        r_next = 0.5 * (r + np.linalg.inv(r.T))
        if np.abs(r_next - r).max() < 1e-7:
            r = r_next
            break
        r = r_next
    return t, r, np.linalg.inv(r) @ a


@tensorclass
class AnimatedTransform:
    """Two keyframed transforms interpolated over [time0, time1]
    (AnimatedTransform, transform.h:444): each keyframe decomposed into a
    translation T, a rotation quaternion R and a scale / shear S; a time
    recomposes lerp(T), slerp(R) and lerp(S). Fields may carry leading
    batch axes (AnimatedInstances stacks one per instance)."""

    t_start: torch.Tensor  # (3,) translation at time0
    t_end: torch.Tensor  # (3,)
    q_start: torch.Tensor  # (4,) rotation at time0
    q_end: torch.Tensor  # (4,)
    s_start: torch.Tensor  # (3, 3) scale / shear at time0
    s_end: torch.Tensor  # (3, 3)
    time0: float = static_field(default=0.0)
    time1: float = static_field(default=1.0)

    @staticmethod
    def build(start, end, time0: float = 0.0,
              time1: float = 1.0) -> "AnimatedTransform":
        """From two keyframes (Transforms or 4x4 matrices), made float32
        as the reference's Transform.from_matrix makes them."""
        def f32(x):
            x = x.m if isinstance(x, Transform) else x
            if isinstance(x, torch.Tensor):
                x = x.detach().cpu().numpy()
            return np.asarray(x, np.float32)

        t0v, r0, s0 = _decompose(f32(start))
        t1v, r1, s1 = _decompose(f32(end))
        q0 = quat_from_matrix(torch.from_numpy(np.asarray(r0, np.float32)))
        q1 = quat_from_matrix(torch.from_numpy(np.asarray(r1, np.float32)))
        # Keep the short rotation path.
        q1 = torch.where(torch.sum(q0 * q1) < 0.0, -q1, q1)

        def t(x):
            return torch.from_numpy(np.array(x, np.float32))

        return AnimatedTransform(t_start=t(t0v), t_end=t(t1v), q_start=q0,
                                 q_end=q1, s_start=t(s0), s_end=t(s1),
                                 time0=float(time0), time1=float(time1))

    def interpolate_matrices(self, time):
        """(N,) times -> (N, 3, 3) linear parts and (N, 3) translations."""
        dt = torch.clamp((time - self.time0)
                         / max(self.time1 - self.time0, 1e-9), 0.0, 1.0)
        trans = ((1.0 - dt)[..., None] * self.t_start[None]
                 + dt[..., None] * self.t_end[None])
        r = quat_to_matrix(slerp(self.q_start[None], self.q_end[None], dt))
        s = ((1.0 - dt)[..., None, None] * self.s_start[None]
             + dt[..., None, None] * self.s_end[None])
        return torch.einsum("nij,njk->nik", r, s), trans

    def apply_point(self, p, time):
        lin, tr = self.interpolate_matrices(time)
        return torch.einsum("nij,nj->ni", lin, p) + tr

    def apply_vector(self, v, time):
        lin, _ = self.interpolate_matrices(time)
        return torch.einsum("nij,nj->ni", lin, v)
