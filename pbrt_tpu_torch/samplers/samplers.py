"""Stateless samplers (port of pbrt_tpu/samplers/samplers.py).

Only the `independent` kind is ported: pcg4d hash streams keyed by
(pixel, sample index, dimension, seed), reference IndependentSampler
(samplers.h:442). The other kinds raise NotImplementedError.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.tensorclass import static_field, tensorclass

_KINDS = (
    "independent", "stratified", "sobol", "zsobol", "halton", "padded",
    "pmj02bn",
)


def as_sampler(x, spp: int = 16) -> "Sampler":
    """Coerce a Sampler, or an int / 0-d tensor seed (-> independent)."""
    if isinstance(x, Sampler) or hasattr(x, "get_1d"):
        return x
    return Sampler(seed=int(x), kind="independent", spp=spp)


@tensorclass
class Sampler:
    seed: int = static_field(default=0)
    kind: str = static_field(default="independent")
    spp: int = static_field(default=16)
    nx: int = static_field(default=0)
    log2_res: int = static_field(default=10)

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown sampler kind {self.kind!r}")
        if self.kind != "independent":
            raise NotImplementedError(
                f"sampler kind {self.kind!r} is not ported yet (ROADMAP "
                "Queue 1 item 14); only 'independent' is"
            )

    def get_1d(self, pixel, sample_idx, dim) -> torch.Tensor:
        return rng.uniform_1d(pixel, sample_idx, dim, self.seed)

    def get_2d(self, pixel, sample_idx, dim):
        return rng.uniform_2d(pixel, sample_idx, dim, self.seed)
