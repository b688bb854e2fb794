"""PMJ02BN sample tables + blue-noise texture generation (port of
pbrt_tpu/samplers/pmj02.py, numpy only, as there).

The PMJ02BN sampler's point tables and blue-noise texture are committed
under data/ (copies of the reference's). When a file is missing, both
assets are generated as the reference generates them and cached next to
this file:

  * pmj02 point sets: built as Owen-scrambled (0,2) Sobol' sequences — a
    randomized (0,2)-sequence satisfies EVERY elementary-interval
    stratification constraint, which is a superset of the progressive
    multi-jitter (0,2) property the tables need (Christensen et al. 2018,
    sec. 2; the scramble seed plays the role of the per-table jitter).
  * the blue-noise ranking texture: void-and-cluster (Ulichney 1993) over a
    toroidal grid with a Gaussian energy kernel — the same construction
    behind the reference's bluenoise.h tables.
"""

from __future__ import annotations

import os

import numpy as np

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
N_TABLES = 8
TABLE_SIZE = 4096
BN_RES = 64


def _reverse_bits32(v):
    v = np.asarray(v, np.uint32)
    v = (v >> 16) | (v << 16)
    v = ((v & 0x00FF00FF) << 8) | ((v & 0xFF00FF00) >> 8)
    v = ((v & 0x0F0F0F0F) << 4) | ((v & 0xF0F0F0F0) >> 4)
    v = ((v & 0x33333333) << 2) | ((v & 0xCCCCCCCC) >> 2)
    v = ((v & 0x55555555) << 1) | ((v & 0xAAAAAAAA) >> 1)
    return v


def _sobol_dim1(idx):
    """Second Sobol' dimension (the classic m = [1, 3, 5, 15, ...] pattern
    generated from the degree-1 primitive polynomial)."""
    idx = np.asarray(idx, np.uint32)
    v = np.zeros_like(idx)
    directions = np.zeros(32, np.uint32)
    m = np.uint32(1)
    for i in range(32):
        directions[i] = m << np.uint32(31 - i)
        m = m ^ (m << np.uint32(1))  # recurrence for dimension 1
    for bit in range(32):
        mask = ((idx >> np.uint32(bit)) & 1).astype(bool)
        v = np.where(mask, v ^ directions[bit], v)
    return v


def _owen_scramble(v, seed):
    """Laine-Karras-style hash Owen scramble in reversed-bit space."""
    v = _reverse_bits32(v)
    v = v.astype(np.uint64)
    v ^= v * np.uint64(0x3D20ADEA)
    v += np.uint64(seed)
    v *= np.uint64((seed >> 16) | 1)
    v ^= v * np.uint64(0x05526C56)
    v ^= v * np.uint64(0x53A22864)
    return _reverse_bits32((v & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def generate_pmj02_table(n: int, seed: int) -> np.ndarray:
    """(n, 2) randomized (0,2)-sequence points in [0, 1)^2."""
    idx = np.arange(n, dtype=np.uint32)
    x = _owen_scramble(_reverse_bits32(idx), seed * 2 + 1)
    y = _owen_scramble(_sobol_dim1(idx), seed * 2 + 0x9E3779B9)
    pts = np.stack([x, y], -1).astype(np.float64) * (1.0 / 2**32)
    return pts.astype(np.float32)


def generate_bluenoise(res: int, seed: int, sigma: float = 1.9,
                       iters_scale: int = 1) -> np.ndarray:
    """Void-and-cluster ranking texture: (res, res) float32 in [0, 1).

    Rank r of each texel = the order in which void-and-cluster inserted it;
    dividing by res^2 gives the usual blue-noise threshold/offset map."""
    rng = np.random.default_rng(seed)
    n = res * res
    # Toroidal Gaussian energy kernel.
    ax = np.arange(res)
    dx = np.minimum(ax, res - ax)
    k = np.exp(-(dx[:, None] ** 2 + dx[None, :] ** 2) / (2.0 * sigma ** 2))
    kf = np.fft.rfft2(k)

    def energy(mask):
        return np.fft.irfft2(np.fft.rfft2(mask) * kf, s=(res, res))

    # Seed pattern: 10% random points, relaxed to even spacing.
    mask = np.zeros((res, res), bool)
    init = rng.choice(n, n // 10, replace=False)
    mask.flat[init] = True
    for _ in range(30 * iters_scale):
        e = energy(mask.astype(np.float64))
        cluster = np.unravel_index(
            np.argmax(np.where(mask, e, -np.inf)), mask.shape
        )
        mask[cluster] = False
        e = energy(mask.astype(np.float64))
        void = np.unravel_index(
            np.argmin(np.where(mask, np.inf, e)), mask.shape
        )
        if void == cluster:
            mask[cluster] = True
            break
        mask[void] = True

    rank = np.zeros((res, res), np.int64)
    # Phase 1: rank the seed points by serial removal.
    m1 = mask.copy()
    cnt = int(m1.sum())
    for r in range(cnt - 1, -1, -1):
        e = energy(m1.astype(np.float64))
        c = np.unravel_index(np.argmax(np.where(m1, e, -np.inf)), m1.shape)
        m1[c] = False
        rank[c] = r
    # Phase 2: fill the remaining texels by serial insertion at voids.
    m2 = mask.copy()
    for r in range(cnt, n):
        e = energy(m2.astype(np.float64))
        v = np.unravel_index(np.argmin(np.where(m2, np.inf, e)), m2.shape)
        m2[v] = True
        rank[v] = r
    return (rank.astype(np.float32) + 0.5) / n


def load_tables():
    """(N_TABLES, TABLE_SIZE, 2) pmj02 points + (BN_RES, BN_RES) blue
    noise, generated once and cached as .npy."""
    os.makedirs(_DATA, exist_ok=True)
    pt_path = os.path.join(_DATA, "pmj02_tables.npy")
    bn_path = os.path.join(_DATA, "bluenoise.npy")
    if os.path.exists(pt_path):
        pts = np.load(pt_path)
    else:
        pts = np.stack(
            [generate_pmj02_table(TABLE_SIZE, s) for s in range(N_TABLES)]
        )
        np.save(pt_path, pts)
    if os.path.exists(bn_path):
        bn = np.load(bn_path)
    else:
        bn = generate_bluenoise(BN_RES, seed=7)
        np.save(bn_path, bn)
    return pts, bn
