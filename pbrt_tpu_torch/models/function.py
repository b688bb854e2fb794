"""Function integrator: sampler-evaluation renders (port of
pbrt_tpu/models/function.py; FunctionIntegrator of pbrt-v4's
cpu/integrators.cpp).

Every pixel Monte-Carlo-integrates a known 2D test function with the
sampler, so error images compare samplers directly: every kind of
samplers/samplers.py.
"""

from __future__ import annotations

import math

import torch

from ..core.tensorclass import static_field, tensorclass

FUNCTIONS = {
    # name -> (f(u, v), its exact integral over [0, 1]^2)
    "uniform": (lambda u, v: torch.ones_like(u), 1.0),
    "linear": (lambda u, v: u, 0.5),
    "quadratic": (lambda u, v: u * v, 0.25),
    "sin": (lambda u, v: torch.sin(math.pi * u) * torch.sin(math.pi * v),
            (2.0 / math.pi) ** 2),
    "step": (lambda u, v: (u < 0.5).to(torch.float32) * 2.0, 1.0),
    # exp(-50 r^2) about the centre; separable, its integral from erf.
    "gaussian": (
        lambda u, v: torch.exp(-50.0 * ((u - 0.5) ** 2 + (v - 0.5) ** 2)),
        (math.sqrt(math.pi / 50.0) * math.erf(0.5 * math.sqrt(50.0))) ** 2),
}


@tensorclass
class FunctionIntegrator:
    func: str = static_field(default="quadratic")

    def __post_init__(self):
        if self.func not in FUNCTIONS:
            raise ValueError(f"unknown function {self.func!r}; one of "
                             f"{sorted(FUNCTIONS)}")

    def render(self, resolution, spp: int, sampler_kind: str = "independent",
               seed: int = 0, *, device):
        """((ny, nx) per-pixel estimates on `device`, the exact
        integral)."""
        from ..render import check_device
        from ..samplers.samplers import Sampler

        device = check_device(device)
        nx, ny = resolution
        f, exact = FUNCTIONS[self.func]
        sampler = Sampler(seed=int(seed), kind=sampler_kind, spp=spp, nx=nx,
                          log2_res=max(1, (max(nx, ny) - 1).bit_length()))
        npix = nx * ny
        pixel = torch.arange(npix, dtype=torch.int64, device=device).repeat(spp)
        sidx = torch.arange(spp, dtype=torch.int64,
                            device=device).repeat_interleave(npix)
        u, v = sampler.get_2d(pixel, sidx, 0)
        return torch.mean(f(u, v).reshape(spp, ny, nx), dim=0), exact
