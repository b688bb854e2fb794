"""Image reading (the numpy-only PFM reader of pbrt_tpu/io/image.py), for
the reference renderer's golden images (tests/goldens/*_ref.pfm) and the
images of lights (`read_image_rgb`)."""

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


def read_image_rgb(path: str) -> np.ndarray:
    """A linear-RGB float32 (h, w, 3) image. PFM only: the reference's
    EXR, PNG and QOI readers are not ported (ROADMAP Queue 1 item 15)."""
    if not path.lower().endswith(".pfm"):
        raise NotImplementedError(
            f"reading the image {path!r}: only PFM is ported (ROADMAP Queue "
            "1 item 15)"
        )
    img = np.asarray(read_pfm(path), np.float32)
    return img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
