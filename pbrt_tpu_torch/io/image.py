"""Image reading (the numpy-only `read_pfm` of pbrt_tpu/io/image.py), for
the reference renderer's golden images (tests/goldens/*_ref.pfm)."""

from __future__ import annotations

import numpy as np


def read_pfm(path: str) -> np.ndarray:
    """A PFM image as (h, w, 3) or (h, w) float32, top row first."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        color = header == b"PF"
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, 3) if color else data.reshape(h, w)
    return np.flipud(img).copy()
