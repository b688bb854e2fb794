"""Orthographic and spherical cameras (port of pbrt_tpu/cameras/simple.py;
OrthographicCamera, cameras.h:295, and SphericalCamera, :425, with the
equal-area and equirectangular mappings)."""

from __future__ import annotations

import math

import torch

from ..core.tensorclass import static_field, tensorclass
from ..core.transform import Transform
from ..core.vecmath import equal_area_square_to_sphere, normalize


@tensorclass
class OrthographicCamera:
    camera_to_world: Transform
    resolution: tuple = static_field()
    screen_half_width: float = static_field(default=1.0)

    def generate_rays(self, p_film, u_lens=None):
        """p_film: (N, 2) raster coords -> (o, d): parallel rays along the
        camera's +z from the screen window (half width screen_half_width)."""
        nx, ny = self.resolution
        hw = self.screen_half_width
        hh = hw / (nx / ny)
        sx = (p_film[..., 0] / nx * 2.0 - 1.0) * hw
        sy = (1.0 - p_film[..., 1] / ny * 2.0) * hh
        o = torch.stack([sx, sy, torch.zeros_like(sx)], dim=-1)
        d = torch.tensor([0.0, 0.0, 1.0], dtype=o.dtype,
                         device=o.device).expand(o.shape)
        return (self.camera_to_world.apply_point(o),
                normalize(self.camera_to_world.apply_vector(d)))


@tensorclass
class SphericalCamera:
    camera_to_world: Transform
    resolution: tuple = static_field()
    mapping: str = static_field(default="equalarea")  # or "equirectangular"

    def generate_rays(self, p_film, u_lens=None):
        """p_film: (N, 2) raster coords -> (o, d): the film square mapped to
        the sphere of directions around the camera's origin."""
        nx, ny = self.resolution
        u = p_film[..., 0] / nx
        v = p_film[..., 1] / ny
        if self.mapping == "equalarea":
            d = equal_area_square_to_sphere(torch.stack([u, v], dim=-1))
        else:
            theta = v * math.pi
            phi = u * 2.0 * math.pi
            st = torch.sin(theta)
            d = torch.stack([st * torch.cos(phi), torch.cos(theta),
                             st * torch.sin(phi)], dim=-1)
        o = torch.zeros_like(d)
        return (self.camera_to_world.apply_point(o),
                normalize(self.camera_to_world.apply_vector(d)))
