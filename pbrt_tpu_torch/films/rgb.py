"""RGB film: spectral sample -> sensor RGB -> accumulation buffers.

Port of pbrt_tpu/films/rgb.py (RGBFilm with the default CIE-XYZ sensor,
film.h:234). Accumulation is a pair of (rgb_sum, weight_sum) tensors.
"""

from __future__ import annotations

import torch

from ..core import colorspace, spectrum
from ..core.tensorclass import static_field, tensorclass


def spectrum_to_rgb(values, wl, cs=colorspace.SRGB):
    """Sensor response: sampled spectrum (..., S) -> linear RGB (..., 3)."""
    return cs.to_rgb(spectrum.to_xyz(values, wl))


@tensorclass
class RGBFilm:
    rgb_sum: torch.Tensor  # (ny, nx, 3)
    weight_sum: torch.Tensor  # (ny, nx)
    resolution: tuple = static_field()  # (nx, ny)

    @staticmethod
    def zeros(resolution, device) -> "RGBFilm":
        nx, ny = resolution
        return RGBFilm(
            rgb_sum=torch.zeros((ny, nx, 3), dtype=torch.float32, device=device),
            weight_sum=torch.zeros((ny, nx), dtype=torch.float32, device=device),
            resolution=(nx, ny),
        )

    def add_sample_image(self, rgb, weight) -> "RGBFilm":
        """Accumulate one full-resolution sample wave: rgb (ny, nx, 3)
        per-pixel sample values with weights (ny, nx)."""
        return self.replace(
            rgb_sum=self.rgb_sum + rgb * weight[..., None],
            weight_sum=self.weight_sum + weight,
        )

    def image(self):
        """Developed linear-RGB image (ny, nx, 3)."""
        w = torch.clamp(self.weight_sum, min=1e-12)[..., None]
        return self.rgb_sum / w
