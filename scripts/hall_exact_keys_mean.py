#!/usr/bin/env python
"""The reading behind chip_smoke.py's d18 exact-keys gate, and what a
biased layered walk reads there.

Renders the many-light hall at d18's configuration (32x32, 4 spp in one
pass, depth 4 without Russian roulette, 8 lanes, seed 0) with the layered
walk on its exact keys (the port's shipped keying), for the power and the
light-BVH sampler, and prints each image mean's relative error against
the committed JAX golden (tests/data/torch_port/manylight32_*_spp4.npy).
With --walk-scale s, the walk's estimate of the layer under the coat
(all of it but the direct specular reflection at the coat) is multiplied
by s: a walk biased by s - 1, which shows what bias the gate's limit
(chip_smoke.py EXACT_KEYS_MEAN_RTOL) catches.

    python3 scripts/hall_exact_keys_mean.py [--device cpu] [--walk-scale 0.95]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pbrt_tpu_torch.materials import layered  # noqa: E402
from pbrt_tpu_torch.models.path import PathIntegrator  # noqa: E402
from pbrt_tpu_torch.render import render  # noqa: E402
from pbrt_tpu_torch.scenes.manylight import manylight_scene  # noqa: E402


def biased_walk(walk, scale: float):
    """layered_walk with its under-coat estimate scaled by `scale`: the walk
    run again on a black base gives the specular term alone."""
    def scaled(wo, wi, base_f_fn, base_sample_fn, *args, **kwargs):
        full = walk(wo, wi, base_f_fn, base_sample_fn, *args, **kwargs)
        spec = walk(wo, wi, lambda a, b: torch.zeros_like(base_f_fn(a, b)),
                    base_sample_fn, *args, **kwargs)
        return spec + scale * (full - spec)

    return scaled


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--walk-scale", type=float, default=1.0)
    args = ap.parse_args()
    if args.walk_scale != 1.0:
        layered.layered_walk = biased_walk(layered.layered_walk,
                                           args.walk_scale)
    for sampler in ("power", "bvh"):
        scene, camera = manylight_scene(resolution=(32, 32), sampler=sampler)
        golden = np.load(os.path.join(ROOT, "tests", "data", "torch_port",
                                      f"manylight32_{sampler}_spp4.npy"))
        img = render(scene, camera, PathIntegrator(max_depth=4,
                                                   rr_start_depth=4),
                     spp=4, samples_per_pass=4, seed=0, n_spectrum=8,
                     device=args.device).cpu().numpy()
        print(f"sampler={sampler} walk_scale={args.walk_scale} "
              f"mean={float(img.mean())!r} golden_mean={float(golden.mean())!r} "
              f"mean_rel_err={abs(float(img.mean()) / float(golden.mean()) - 1.0)!r}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
