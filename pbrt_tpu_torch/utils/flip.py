"""FLIP perceptual image-difference metric (compact reimplementation).

A copy of pbrt_tpu/utils/flip.py (numpy only), so the port needs nothing
of the reference package.

Reference analogue: the vendored NVIDIA FLIP evaluator the reference links
into imgtool (pbrt-v4 src/ext/flip, used by cmd/imgtool.cpp and
Image::Error). This is an independent compact implementation of the
published algorithm (Andersson et al., "FLIP: A Difference Evaluator for
Alternating Images", HPG 2020 — public method):

  1. linear RGB -> opponent YCxCz,
  2. per-channel spatial filtering with CSF-derived Gaussians (viewing
     distance expressed as pixels-per-degree),
  3. Hunt-adjusted L*a*b* color difference (HyAB), exponent-remapped,
  4. a feature (edge/point) difference on filtered luminance,
  5. final per-pixel error  dE = dE_color ^ (1 - dE_feature).

Simplifications vs the reference implementation: each CSF is a single
Gaussian (the paper uses sums of two), and the point detector is folded
into the edge detector magnitude. Errors remain in [0, 1] with the same
qualitative ordering; use `mean_flip` for scalar scores.
"""

from __future__ import annotations

import numpy as np

_M_RGB2XYZ = np.asarray(
    [[0.4124, 0.3576, 0.1805],
     [0.2126, 0.7152, 0.0722],
     [0.0193, 0.1192, 0.9505]], np.float64
)
_D65 = np.asarray([0.9505, 1.0, 1.089])


def _gauss_kernel(sigma):
    r = max(1, int(np.ceil(3.0 * sigma)))
    x = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (x / max(sigma, 1e-6)) ** 2)
    return k / k.sum()


def _sep_filter(img, sigma):
    if sigma <= 0.05:
        return img
    k = _gauss_kernel(sigma)
    r = len(k) // 2
    p = np.pad(img, ((r, r), (r, r)), mode="edge")
    tmp = np.apply_along_axis(lambda m: np.convolve(m, k, "valid"), 0, p)
    return np.apply_along_axis(lambda m: np.convolve(m, k, "valid"), 1, tmp)


def _rgb_to_ycxcz(rgb):
    xyz = np.einsum("ij,hwj->hwi", _M_RGB2XYZ, np.clip(rgb, 0.0, None))
    xyz = xyz / _D65
    y = 116.0 * xyz[..., 1] - 16.0
    cx = 500.0 * (xyz[..., 0] - xyz[..., 1])
    cz = 200.0 * (xyz[..., 1] - xyz[..., 2])
    return np.stack([y, cx, cz], -1)


def _ycxcz_to_lab(ycc):
    """Filtered YCxCz back to (Hunt-adjusted) L*a*b*."""
    y = (ycc[..., 0] + 16.0) / 116.0
    x = ycc[..., 1] / 500.0 + y
    z = y - ycc[..., 2] / 200.0
    xyz = np.stack([x, y, z], -1) ** 3 * _D65

    t = xyz / _D65
    f = np.where(t > (6 / 29) ** 3, np.cbrt(np.maximum(t, 1e-9)),
                 t / (3 * (6 / 29) ** 2) + 4 / 29)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    # Hunt adjustment: scale chroma by luminance (paper eq. 9).
    lum = np.clip(L, 0.0, 100.0) * 0.01
    return np.stack([L, a * lum, b * lum], -1)


def flip_error_map(ref_rgb, test_rgb, ppd: float = 67.0):
    """Per-pixel FLIP error in [0, 1]; inputs are LINEAR RGB (H, W, 3)."""
    ref = _rgb_to_ycxcz(np.asarray(ref_rgb, np.float64))
    test = _rgb_to_ycxcz(np.asarray(test_rgb, np.float64))

    # CSF spatial filtering: Gaussian sigmas in pixels per channel
    # (achromatic / red-green / blue-yellow peak frequencies).
    sig = {0: 0.0047 * ppd, 1: 0.0053 * ppd, 2: 0.04 * ppd}
    rf = np.stack(
        [_sep_filter(ref[..., c], sig[c]) for c in range(3)], -1
    )
    tf = np.stack(
        [_sep_filter(test[..., c], sig[c]) for c in range(3)], -1
    )
    lab_r = _ycxcz_to_lab(rf)
    lab_t = _ycxcz_to_lab(tf)

    # HyAB color distance, exponent-remapped (paper sec. 4.1).
    hyab = np.abs(lab_r[..., 0] - lab_t[..., 0]) + np.sqrt(
        (lab_r[..., 1] - lab_t[..., 1]) ** 2
        + (lab_r[..., 2] - lab_t[..., 2]) ** 2
    )
    cmax = 41.2761  # HyAB distance between green and blue primaries
    qc, pc, pt = 0.7, 0.4, 0.95
    e_c = np.power(np.clip(hyab / cmax, 0.0, None), qc)
    # Piecewise remap so errors at pc map to pt.
    e_c = np.where(
        e_c < pc, (pt / pc) * e_c,
        pt + ((e_c - pc) / (1.0 - pc)) * (1.0 - pt),
    )
    e_c = np.clip(e_c, 0.0, 1.0)

    # Feature difference: Sobel gradient magnitude of filtered luminance.
    def grad_mag(y):
        gy, gx = np.gradient(y)
        return np.sqrt(gx * gx + gy * gy)

    yn_r = (rf[..., 0] + 16.0) / 116.0
    yn_t = (tf[..., 0] + 16.0) / 116.0
    qf = 0.5
    e_f = np.clip(
        np.abs(grad_mag(yn_r) - grad_mag(yn_t)) * (ppd / 15.0), 0.0, 1.0
    ) ** qf

    return np.power(e_c, 1.0 - e_f).astype(np.float32)


def mean_flip(ref_rgb, test_rgb, ppd: float = 67.0) -> float:
    return float(flip_error_map(ref_rgb, test_rgb, ppd).mean())
