"""Perspective camera (port of pbrt_tpu/cameras/perspective.py).

Conventions match pbrt: camera space is left-handed with the view direction
+z; the screen window spans [-1, 1] on the shorter axis scaled by the
aspect ratio; `fov_deg` is the full angle on the shorter image axis.
Thin-lens defocus via lens_radius / focal_distance. Camera motion blur:
`motion`, an AnimatedTransform, replaces camera_to_world at each ray's
shutter time (`sample_time` of the dim-5 draw, render.py; the reference's
parser makes no moving camera, its scenes and convert.py do).
`position`, `pixel_solid_angle_base`
and `project` are the pinhole's importance and raster projection, for the
light tracers' connections to the camera (models/lightpath.py, bdpt.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.sampling import sample_uniform_disk_concentric
from ..core.tensorclass import static_field, tensorclass
from ..core.transform import AnimatedTransform, Transform
from ..core.vecmath import normalize


@tensorclass
class PerspectiveCamera:
    camera_to_world: Transform
    resolution: tuple = static_field()  # (nx, ny)
    fov_deg: float = static_field(default=90.0)
    lens_radius: float = static_field(default=0.0)
    focal_distance: float = static_field(default=1e6)
    shutter_open: float = static_field(default=0.0)
    shutter_close: float = static_field(default=1.0)
    motion: Optional[AnimatedTransform] = None

    def _screen_window(self):
        nx, ny = self.resolution
        aspect = nx / ny
        if aspect > 1.0:
            return (-aspect, aspect, -1.0, 1.0)
        return (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect)

    def sample_time(self, u_time):
        """A uniform sample -> a shutter time (CameraBase::SampleTime)."""
        return self.shutter_open + u_time * (self.shutter_close
                                             - self.shutter_open)

    def generate_rays(self, p_film, u_lens=None, time=None):
        """p_film: (N, 2) continuous raster coords in [0,nx)x[0,ny).

        Returns (o, d) world-space rays with unit directions
        (PerspectiveCamera::GenerateRay); with `motion` and times (N,),
        through the camera's transform at each time.
        """
        nx, ny = self.resolution
        x0, x1, y0, y1 = self._screen_window()
        tan_half = float(np.tan(np.deg2rad(self.fov_deg) / 2.0))
        # Raster -> screen (raster y grows downward).
        sx = x0 + (p_film[..., 0] / nx) * (x1 - x0)
        sy = y1 - (p_film[..., 1] / ny) * (y1 - y0)
        d_cam = torch.stack(
            [sx * tan_half, sy * tan_half, torch.ones_like(sx)], dim=-1
        )
        o_cam = torch.zeros_like(d_cam)
        if self.lens_radius > 0.0 and u_lens is not None:
            p_lens = self.lens_radius * sample_uniform_disk_concentric(u_lens)
            ft = self.focal_distance  # focus plane at z = ft
            p_focus = d_cam * (ft / d_cam[..., 2:3])
            o_cam = torch.cat(
                [p_lens, torch.zeros_like(p_lens[..., :1])], dim=-1
            )
            d_cam = p_focus - o_cam
        d_cam = normalize(d_cam)
        if self.motion is not None and time is not None:
            return (self.motion.apply_point(o_cam, time),
                    normalize(self.motion.apply_vector(d_cam, time)))
        o_w = self.camera_to_world.apply_point(o_cam)
        d_w = self.camera_to_world.apply_vector(d_cam)
        return o_w, d_w

    @property
    def position(self):
        """World-space pinhole position (lens_radius == 0)."""
        zero = torch.zeros((1, 3), dtype=self.camera_to_world.m.dtype,
                           device=self.camera_to_world.m.device)
        return self.camera_to_world.apply_point(zero)[0]

    def pixel_solid_angle_base(self) -> float:
        """Pixel area on the camera-space z = 1 plane; the solid angle of
        pixel j is this times cos^3(theta_j) (PerspectiveCamera::We)."""
        nx, ny = self.resolution
        x0, x1, y0, y1 = self._screen_window()
        tan_half = float(np.tan(np.deg2rad(self.fov_deg) / 2.0))
        return ((x1 - x0) * tan_half) * ((y1 - y0) * tan_half) / (nx * ny)

    def project(self, p_world):
        """World points (N, 3) -> (raster xy (N, 2), cos_theta_cam (N,),
        in-film mask (N,)): generate_rays' raster mapping inverted (the
        pinhole's)."""
        nx, ny = self.resolution
        x0, x1, y0, y1 = self._screen_window()
        tan_half = float(np.tan(np.deg2rad(self.fov_deg) / 2.0))
        p_cam = self.camera_to_world.inverse().apply_point(p_world)
        z = p_cam[..., 2]
        valid = z > 1e-6
        zs = torch.where(valid, z, 1.0)
        sx = p_cam[..., 0] / (zs * tan_half)
        sy = p_cam[..., 1] / (zs * tan_half)
        px = (sx - x0) / (x1 - x0) * nx
        py = (y1 - sy) / (y1 - y0) * ny
        cos_t = zs / torch.sqrt(torch.sum(p_cam * p_cam, dim=-1) + 1e-20)
        inside = valid & (px >= 0) & (px < nx) & (py >= 0) & (py < ny)
        return torch.stack([px, py], dim=-1), cos_t, inside
