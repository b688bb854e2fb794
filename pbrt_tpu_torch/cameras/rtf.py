"""RTF camera: polynomial ray-transfer-function optics (port of
pbrt_tpu/cameras/rtf.py; the ISET fork's RTFCamera, cameras.h:1088-1143
and rtf/passnopass.h).

A fitted polynomial maps (film point, pupil sample) to the output ray, in
place of a trace through the lens elements, with a pass / no-pass pupil
predicate for vignetting. The coefficients are dense monomials of the
features (x, y, u, v): the film point in mm and the pupil sample on the
unit disk; the outputs are (ox, oy, oz, dx, dy, dz) at the front vertex
plane. fit_from_camera fits them to a lens camera by tracing a training
batch through its stack and solving least squares on the host (numpy),
as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.floats import recip
from ..core.sampling import sample_uniform_disk_concentric
from ..core.tensorclass import static_field, tensorclass
from ..core.transform import Transform
from ..core.vecmath import normalize


def _monomial_powers(degree: int):
    powers = []
    for total in range(degree + 1):
        for px in range(total + 1):
            for py in range(total - px + 1):
                for pu in range(total - px - py + 1):
                    powers.append((px, py, pu, total - px - py - pu))
    return powers


@tensorclass
class RTFCamera:
    camera_to_world: Transform
    coeffs: torch.Tensor  # (n_terms, 6) output coefficients
    powers: torch.Tensor  # (n_terms, 4) monomial powers
    pupil_radius_mm: torch.Tensor  # ()
    front_z_mm: torch.Tensor  # () plane where output rays originate
    resolution: tuple = static_field()
    film_semi_x_mm: float = static_field(default=12.0)
    film_semi_y_mm: float = static_field(default=12.0)
    degree: int = static_field(default=3)
    # Host copy of the monomial powers, derived.
    host_powers: tuple = static_field(init=False, default=(), repr=False)

    def __post_init__(self):
        object.__setattr__(self, "host_powers", tuple(
            tuple(int(v) for v in row)
            for row in self.powers.detach().cpu().numpy()))

    def _features(self, x, y, u, v):
        feats = [(x ** px) * (y ** py) * (u ** pu) * (v ** pv)
                 for px, py, pu, pv in self.host_powers]
        return torch.stack(feats, dim=-1)  # (..., n_terms)

    def generate_rays(self, p_film, u_lens):
        """Returns (o_world, d_world, weight)."""
        nx, ny = self.resolution
        x = (0.5 - p_film[..., 0] * recip(nx)) * 2.0 * self.film_semi_x_mm
        y = (p_film[..., 1] * recip(ny) - 0.5) * 2.0 * self.film_semi_y_mm
        disk = sample_uniform_disk_concentric(u_lens)
        u, v = disk[..., 0], disk[..., 1]
        out = self._features(x, y, u, v) @ self.coeffs  # (..., 6)
        o = torch.stack([out[..., 0], out[..., 1],
                         self.front_z_mm.expand(x.shape)], dim=-1)
        d = normalize(out[..., 3:6])
        # Pass / no-pass: the unit-disk predicate (passnopass.h's circle
        # intersection for one pupil); a degenerate output does not pass.
        w = ((u * u + v * v) <= 1.0).to(torch.float32)
        w = w * (torch.sum(out[..., 3:6] ** 2, dim=-1) > 1e-8).to(torch.float32)
        o_w = self.camera_to_world.apply_point(o)
        d_w = normalize(self.camera_to_world.apply_vector(d))
        return o_w, d_w, w


def fit_from_camera(lens_camera, degree: int = 3, n_train: int = 4096,
                    seed: int = 0) -> RTFCamera:
    """Fit an RTFCamera to a RealisticCamera or HumanEyeCamera: trace a
    training set through its stack in the camera frame (on the CPU) and
    solve least squares on the host."""
    r = np.random.default_rng(seed)
    nx, ny = lens_camera.resolution
    p_film = np.stack([r.uniform(0, nx, n_train), r.uniform(0, ny, n_train)],
                      axis=-1).astype(np.float32)
    u_lens = r.uniform(0, 1, (n_train, 2)).astype(np.float32)
    cam_local = lens_camera.to("cpu").replace(
        camera_to_world=Transform(m=torch.eye(4), m_inv=torch.eye(4)))
    o_c, d_c, w = cam_local.generate_rays(torch.from_numpy(p_film),
                                          torch.from_numpy(u_lens))
    o_c, d_c = o_c.numpy(), d_c.numpy()
    valid = w.numpy() > 0.5
    if hasattr(lens_camera, "film_diag_mm"):
        aspect = nx / ny
        h = lens_camera.film_diag_mm / np.sqrt(1 + aspect * aspect)
        semi_x, semi_y = aspect * h / 2, h / 2
    else:
        semi_x = semi_y = lens_camera.retina_semi_diam_mm
    x = (0.5 - p_film[:, 0] / nx) * 2 * semi_x
    y = (p_film[:, 1] / ny - 0.5) * 2 * semi_y
    disk = sample_uniform_disk_concentric(torch.from_numpy(u_lens)).numpy()
    u, v = disk[:, 0], disk[:, 1]
    powers = _monomial_powers(degree)
    feats = np.stack([(x ** px) * (y ** py) * (u ** pu) * (v ** pv)
                      for px, py, pu, pv in powers], axis=-1)[valid]
    front_z = float(np.median(o_c[valid, 2]))
    targets = np.concatenate([o_c[valid], d_c[valid]], axis=-1)
    coeffs, *_ = np.linalg.lstsq(feats, targets, rcond=None)
    front_r = float(np.percentile(np.hypot(o_c[valid, 0], o_c[valid, 1]), 99))
    return RTFCamera(
        camera_to_world=lens_camera.camera_to_world,
        coeffs=torch.from_numpy(np.asarray(coeffs, np.float32)),
        powers=torch.from_numpy(np.asarray(powers, np.int32)),
        pupil_radius_mm=torch.tensor(front_r, dtype=torch.float32),
        front_z_mm=torch.tensor(front_z, dtype=torch.float32),
        resolution=lens_camera.resolution, film_semi_x_mm=float(semi_x),
        film_semi_y_mm=float(semi_y), degree=degree)
