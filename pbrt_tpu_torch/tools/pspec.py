"""pspec: sampler Fourier power-spectrum analysis.

Port of pbrt_tpu/tools/pspec.py: the point sets are drawn through the
port's samplers/samplers.py::Sampler.get_2d on `device` (the card unless
the caller passes cpu); the transform runs on the host in numpy.

Reference analogue: pbrt-v4 src/pbrt/cmd/pspec.cpp — accumulates the
2D Fourier power spectrum of a sampler's point sets (the standard tool for
verifying blue-noise/low-discrepancy structure). Usage:

    python -m pbrt_tpu_torch.tools.pspec --sampler sobol --spp 256 --out ps.png
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def power_spectrum(sampler_kind: str, spp: int, n_sets: int = 64,
                   res: int = 128, seed: int = 0, dim: int = 8, *,
                   device="cuda"):
    """Average |DFT|^2 of n_sets point sets of `spp` points each."""
    import torch

    from ..render import check_device
    from ..samplers.samplers import Sampler

    device = check_device(device)
    acc = np.zeros((res, res))
    s = Sampler.create(sampler_kind, spp=spp, seed=seed)
    sample = torch.arange(spp, dtype=torch.int64, device=device)
    for k in range(n_sets):
        pix = torch.full((spp,), k, dtype=torch.int64, device=device)
        u0, u1 = s.get_2d(pix, sample, dim)
        pts = torch.stack([u0, u1], -1).cpu().numpy()
        # Continuous Fourier transform of the point set, sampled on a grid of
        # integer frequencies (pspec.cpp accumulates the same quantity).
        fx = np.fft.fftfreq(res, d=1.0 / res)
        fy = fx
        phase = -2j * np.pi * (
            pts[:, 0:1, None] * fx[None, :, None]
            + pts[:, 1:2, None].transpose(0, 2, 1) * fy[None, None, :]
        )
        ft = np.exp(phase).sum(axis=0)
        acc += (np.abs(ft) ** 2) / spp
    acc /= n_sets
    return np.fft.fftshift(acc)


def main(argv=None):
    p = argparse.ArgumentParser(prog="pspec")
    p.add_argument("--sampler", default="sobol",
                   choices=["independent", "stratified", "sobol", "halton"])
    p.add_argument("--spp", type=int, default=256)
    p.add_argument("--nsets", type=int, default=32)
    p.add_argument("--res", type=int, default=128)
    p.add_argument("--out", default="pspec.png")
    p.add_argument("--device", default="cuda",
                   help="torch device of the draws (default cuda)")
    args = p.parse_args(argv)
    ps = power_spectrum(args.sampler, args.spp, args.nsets, args.res,
                        device=args.device)
    from ..io.image import write_png

    img = np.log1p(ps)
    img = img / max(img.max(), 1e-9)
    write_png(args.out, np.repeat(img[..., None], 3, axis=-1))
    # Radial summary: low-frequency suppression factor (blue-noise metric).
    r = args.res
    yy, xx = np.mgrid[0:r, 0:r]
    rad = np.hypot(yy - r // 2, xx - r // 2)
    low = ps[(rad > 0) & (rad < r * 0.08)].mean()
    high = ps[(rad > r * 0.3) & (rad < r * 0.45)].mean()
    print(f"low/high frequency power ratio: {low / max(high, 1e-9):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
