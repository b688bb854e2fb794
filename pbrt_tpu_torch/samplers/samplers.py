"""Stateless samplers (port of pbrt_tpu/samplers/samplers.py).

kinds, each bit-equal to the reference's on the same (pixel, sample,
dimension, seed):
  independent — pcg4d hash streams (IndependentSampler, samplers.h:442)
  stratified  — per-dimension shuffled strata + jitter (StratifiedSampler)
  sobol       — Owen-scrambled exact Joe-Kuo Sobol': one per-pixel shuffled
                sample index through the dim-th generator matrix
                (SobolSampler, samplers.h:353)
  zsobol      — Morton/Z-curve index with hashed base-4 digit permutations
                per dimension (ZSobolSampler, samplers.h:225)
  halton      — per-dimension prime radical inverse with per-digit hash
                permutations (HaltonSampler, samplers.h:53)
  padded      — padded Owen-scrambled dim-0/1 Sobol' pairs
                (PaddedSobolSampler, samplers.h:144)
  pmj02bn     — pmj02 point tables with a blue-noise rotation
                (PMJ02BNSampler, samplers.h:609)

uint32 values live in int64 tensors (core/rng.py): every sum, product and
left shift is reduced to 32 bits before the next `%`, `//` or `>>`.
Dimensions are Python ints (every call site of the port passes one), so
a hash of the dimension and the seed alone is a Python int, folded into
the per-lane ops as a constant. All kinds return float32 in [0, 1).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..core import rng
from ..core.floats import recip
from ..core.rng import _mul
from ..core.tensorclass import static_field, tensorclass
from .sobol import sobol_bits

_M32 = 0xFFFFFFFF

_KINDS = (
    "independent", "stratified", "sobol", "zsobol", "halton", "padded",
    "pmj02bn",
)


def _u32(x):
    if isinstance(x, int):
        return x & _M32
    return torch.as_tensor(x).to(torch.int64) & _M32


def _reverse_bits32(v):
    v = ((v >> 16) | (v << 16)) & _M32
    v = ((v & 0x00FF00FF) << 8) | ((v & 0xFF00FF00) >> 8)
    v = ((v & 0x0F0F0F0F) << 4) | ((v & 0xF0F0F0F0) >> 4)
    v = ((v & 0x33333333) << 2) | ((v & 0xCCCCCCCC) >> 2)
    return ((v & 0x55555555) << 1) | ((v & 0xAAAAAAAA) >> 1)


def _sobol_dim0(idx):
    """First Sobol' dimension: radical inverse base 2 (bit reversal)."""
    return _reverse_bits32(_u32(idx))


_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
           59, 61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113,
           127, 131)
# Digits so that base^digits >= 2^32 for base 3 (base 2 is bit reversal).
_HALTON_DIGITS = 21
_ONE_MINUS = float(np.float32(1.0 - 1e-7))


def _radical_inverse(idx, base: int, perm_seed: int, n_digits: int,
                     inv_base: np.float32):
    """The digit loop of the reference's radical inverses: digit i of idx
    in `base`, shifted by the hash h(perm_seed, i, base) mod base, times
    inv_base^(i+1) (a float32 chain, the same for every lane)."""
    val = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    inv = inv_base
    rest = idx
    for i in range(n_digits):
        h, _, _, _ = rng.pcg4d(perm_seed, i, base, 0x51633E2D)
        digit = (rest % base + h % base) % base
        # val + digit * inv, which XLA's CPU build contracts to one
        # rounding (core/floats.py::fma).
        val = (digit.to(torch.float64) * float(inv) + val.double()).float()
        inv = np.float32(inv * inv_base)
        rest = rest // base
    return torch.clamp(val, max=_ONE_MINUS)


def _scrambled_radical_inverse(idx, base: int, perm_seed: int):
    """Radical inverse in a static `base` with per-digit hash permutations
    (ScrambledRadicalInverse + DigitPermutation, lowdiscrepancy.h:26,115)."""
    n_digits = max(2, int(32 / max(1, (base - 1).bit_length())))
    return _radical_inverse(_u32(idx), base, perm_seed, n_digits,
                            np.float32(1.0 / base))


def _halton_traced_base(idx, dim: int, perm_seed: int):
    """Radical inverse in base PRIMES[dim % 32], 21 digits (every base >= 3
    to the full 2^32 index range; base 2 is the caller's bit reversal)."""
    base = _PRIMES[dim % len(_PRIMES)]
    return _radical_inverse(idx, base, perm_seed, _HALTON_DIGITS,
                            np.float32(1.0) / np.float32(base))


def _fast_owen_scramble(v, scramble_seed):
    """Laine-Karras-style hash acting as an Owen scramble in reversed-bit
    space (FastOwenScrambler, lowdiscrepancy.h:168)."""
    v = _reverse_bits32(v)
    v = v ^ _mul(v, 0x3D20ADEA)
    v = (v + scramble_seed) & _M32
    v = _mul(v, (scramble_seed >> 16) | 1)
    v = v ^ _mul(v, 0x05526C56)
    v = v ^ _mul(v, 0x53A22864)
    return _reverse_bits32(v)


# All 24 permutations of {0,1,2,3}, packed 2 bits per entry (entry j at bit
# 2j), in itertools order, as the reference's.
_PERM4_PACKED = np.asarray(
    [sum(p[j] << (2 * j) for j in range(4))
     for p in itertools.permutations(range(4))],
    np.int64,
)


def _interleave_bits16(x):
    """Spread the low 16 bits of x to even bit positions (Morton helper)."""
    x = x & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    return (x | (x << 1)) & 0x55555555


_DEVICE_TABLES: dict = {}


def _on_device(name: str, device, build):
    """A host-built table moved to `device` once and kept."""
    key = (name, torch.device(device))
    t = _DEVICE_TABLES.get(key)
    if t is None:
        t = build(device)
        _DEVICE_TABLES[key] = t
    return t


def _pmj_tables(device):
    """The pmj02 point tables (flattened to (N_TABLES * TABLE_SIZE, 2)) and
    the blue-noise texture on `device`, with their sizes."""
    def build(dev):
        from .pmj02 import load_tables

        pts, bn = load_tables()
        return (torch.from_numpy(pts.reshape(-1, 2)).to(dev),
                torch.from_numpy(bn).to(dev),
                pts.shape[0], pts.shape[1], bn.shape[0])

    return _on_device("pmj02", device, build)


def _int_dim(dim) -> int:
    if isinstance(dim, torch.Tensor):
        if dim.dim() != 0:
            raise ValueError("the sampler kinds other than 'independent' "
                             "take one dimension for every lane")
        return int(dim)
    return int(dim)


def as_sampler(x, spp: int = 16) -> "Sampler":
    """Coerce a Sampler, or an int / 0-d tensor seed (-> independent). Any
    object with a get_1d attribute passes through (MLT's replay sampler)."""
    if isinstance(x, Sampler) or hasattr(x, "get_1d"):
        return x
    return Sampler(seed=int(x), kind="independent", spp=spp)


@tensorclass
class Sampler:
    seed: int = static_field(default=0)
    kind: str = static_field(default="independent")
    spp: int = static_field(default=16)
    # Image width (pixel ids are y * nx + x); 0 = unknown (zsobol then
    # uses the flat pixel id as its Morton prefix).
    nx: int = static_field(default=0)
    log2_res: int = static_field(default=10)

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown sampler kind {self.kind!r}")

    @staticmethod
    def create(kind: str = "independent", spp: int = 16, seed: int = 0,
               nx: int = 0, log2_res: int = 10) -> "Sampler":
        return Sampler(seed=int(seed), kind=kind, spp=spp, nx=nx,
                       log2_res=log2_res)

    # -- implementation helpers ---------------------------------------------

    def _hash(self, pixel, dim: int):
        """Per-(pixel, dimension, seed) decorrelation key."""
        h, _, _, _ = rng.pcg4d(pixel, dim, self.seed, 0x9E3779B9)
        return h

    def _shuffled_index(self, pixel, sample_idx, dim: int):
        """Per-(pixel, dim) permutation of the sample order: an XOR within
        spp when spp is a power of two, else a hash offset modulo spp."""
        h = self._hash(pixel, dim)
        s = _u32(sample_idx)
        spp = self.spp
        if spp & (spp - 1) == 0:
            return s ^ (h % spp)
        return ((s + h) & _M32) % spp

    def _log2spp(self) -> int:
        return max(1, (self.spp - 1).bit_length())

    def _zsobol_index(self, pixel, sample_idx, dim: int):
        """ZSobolSampler::GetSampleIndex (samplers.h:225-320): the Morton
        (pixel, sample) index with its base-4 digits permuted by a hash of
        the digits above and the dimension."""
        log2spp = self._log2spp()
        pix = _u32(pixel)
        if self.nx > 0:
            morton = (_interleave_bits16(pix % self.nx)
                      | (_interleave_bits16(pix // self.nx) << 1))
        else:
            morton = pix
        mi = ((morton << log2spp) & _M32) | _u32(sample_idx)
        n_index_bits = min(32, 2 * self.log2_res + log2spp)
        pow2_odd = log2spp & 1
        n_base4 = (n_index_bits + 1) // 2
        dim_u = (dim * 0x55555555) & _M32
        perm = _on_device("perm4", mi.device,
                          lambda dev: torch.from_numpy(_PERM4_PACKED).to(dev))
        out = torch.zeros_like(mi)
        last = 1 if pow2_odd else 0
        for i in range(n_base4 - 1, last - 1, -1):
            shift = 2 * i - pow2_odd
            digit = (mi >> shift) & 3
            if shift + 2 < 32:
                h, _, _, _ = rng.pcg4d(mi >> (shift + 2), dim_u, self.seed,
                                       0xA511E9B3)
                packed = perm[(h >> 8) % 24]
            else:  # no digits above: the hash of 0, one permutation
                h, _, _, _ = rng.pcg4d(0, dim_u, self.seed, 0xA511E9B3)
                packed = int(_PERM4_PACKED[(h >> 8) % 24])
            out = out | (((packed >> (2 * digit)) & 3) << shift)
        if pow2_odd:
            h, _, _, _ = rng.pcg4d(mi >> 1, dim_u, self.seed, 0xC2B2AE35)
            out = out | ((mi & 1) ^ (h & 1))
        return out

    def _pmj_sample(self, pixel, sample_idx, dim: int):
        """PMJ02BNSampler sample (samplers.h:609): a pmj02 table chosen by
        dimension, indexed by the pixel's shuffled sample counter, rotated
        by the blue-noise texture keyed by screen position."""
        pts, bn, n_tables, table_size, bres = _pmj_tables(pixel.device)
        h, hx, hy, _ = rng.pcg4d(dim, self.seed, 0x504D4A30, 0)
        tbl = h % n_tables
        idx = self._shuffled_index(pixel, sample_idx, dim) % table_size
        p = pts[tbl * table_size + idx]
        pix = pixel.to(torch.int64)
        w = self.nx if self.nx > 0 else bres
        px, py = pix % w, torch.div(pix, w, rounding_mode="floor")
        sx, sy = hx % bres, hy % bres
        b0 = bn[(py + sy) % bres, (px + sx) % bres]
        b1 = bn[(py + sx + 17) % bres, (px + sy + 41) % bres]
        # Both sums lie in [0, 2): fmod is the reference's remainder there.
        return torch.fmod(p[..., 0] + b0, 1.0), torch.fmod(p[..., 1] + b1, 1.0)

    def _halton(self, pixel, sample_idx, dim: int):
        """One global Halton sequence at per-pixel hash offsets, a pixel's
        samples 65537 apart; base PRIMES[dim % 32]."""
        h_off, _, _, _ = rng.pcg4d(pixel, self.seed, 0x48616C74, 0)
        idx = (h_off + _mul(_u32(sample_idx), 65537)) & _M32
        hd, _, _, _ = rng.pcg4d(dim, self.seed, 0x48616C74, 1)
        if dim % len(_PRIMES) == 0:
            return rng.u32_to_uniform(_fast_owen_scramble(_sobol_dim0(idx), hd))
        return _halton_traced_base(idx, dim, hd)

    # -- public API ----------------------------------------------------------

    def get_1d(self, pixel, sample_idx, dim) -> torch.Tensor:
        if self.kind == "independent":
            return rng.uniform_1d(pixel, sample_idx, dim, self.seed)
        dim = _int_dim(dim)
        if self.kind == "stratified":
            idx = self._shuffled_index(pixel, sample_idx, dim)
            jitter = rng.uniform_1d(pixel, sample_idx, dim, self.seed + 1)
            return (idx.to(torch.float32) + jitter) * recip(self.spp)
        if self.kind == "halton":
            return self._halton(pixel, sample_idx, dim)
        if self.kind == "sobol":
            idx = self._shuffled_index(pixel, sample_idx, 0)
            return rng.u32_to_uniform(_fast_owen_scramble(
                sobol_bits(idx, dim), self._hash(pixel, dim)))
        if self.kind == "zsobol":
            idx = self._zsobol_index(pixel, sample_idx, dim)
            h, _, _, _ = rng.pcg4d(dim, self.seed, 0x6C8E9CF5, 0)
            return rng.u32_to_uniform(_fast_owen_scramble(
                sobol_bits(idx, 0), h))
        if self.kind == "pmj02bn":
            return self._pmj_sample(pixel, sample_idx, dim)[0]
        # padded: a fresh shuffled dim-0 value per slot.
        idx = self._shuffled_index(pixel, sample_idx, dim)
        return rng.u32_to_uniform(_fast_owen_scramble(
            _sobol_dim0(idx), self._hash(pixel, dim)))

    def get_2d(self, pixel, sample_idx, dim):
        if self.kind == "independent":
            return rng.uniform_2d(pixel, sample_idx, dim, self.seed)
        dim = _int_dim(dim)
        if self.kind == "stratified":
            # Stratify over a near-square grid of the spp count.
            nx = 1
            while (nx * 2) * (nx * 2) <= self.spp:
                nx *= 2
            ny = max(self.spp // nx, 1)
            idx = self._shuffled_index(pixel, sample_idx, dim)
            jx = rng.uniform_1d(pixel, sample_idx, dim, self.seed + 1)
            jy = rng.uniform_1d(pixel, sample_idx, dim, self.seed + 2)
            sx = (idx % nx).to(torch.float32)
            sy = ((idx // nx) % ny).to(torch.float32)
            return (sx + jx) * recip(nx), (sy + jy) * recip(ny)
        # The doubled slots of halton and sobol sit 1 << 20 above get_1d's.
        d2 = dim * 2 + (1 << 20)
        if self.kind == "halton":
            return (self._halton(pixel, sample_idx, d2),
                    self._halton(pixel, sample_idx, d2 + 1))
        if self.kind == "sobol":
            idx = self._shuffled_index(pixel, sample_idx, 0)
            return tuple(
                rng.u32_to_uniform(_fast_owen_scramble(
                    sobol_bits(idx, d), self._hash(pixel, d)))
                for d in (d2, d2 + 1))
        if self.kind == "pmj02bn":
            return self._pmj_sample(pixel, sample_idx, dim)
        if self.kind == "zsobol":
            idx = self._zsobol_index(pixel, sample_idx, dim)
            h0, h1, _, _ = rng.pcg4d(dim, self.seed, 0x6C8E9CF5, 1)
            return (rng.u32_to_uniform(_fast_owen_scramble(
                        sobol_bits(idx, 0), h0)),
                    rng.u32_to_uniform(_fast_owen_scramble(
                        sobol_bits(idx, 1), h1)))
        # padded: a fresh scrambled (dim0, dim1) pair per dimension slot.
        idx = self._shuffled_index(pixel, sample_idx, dim)
        h0 = self._hash(pixel, dim)
        h1 = self._hash(pixel, dim + 0x5555)
        return (rng.u32_to_uniform(_fast_owen_scramble(_sobol_dim0(idx), h0)),
                rng.u32_to_uniform(_fast_owen_scramble(sobol_bits(idx, 1),
                                                       h1)))

    def get_1d_run(self, pixel, sample_idx, dim0: int, n: int) -> torch.Tensor:
        """get_1d at dimensions dim0 .. dim0 + n - 1: (N, n), column j
        bit-equal to get_1d(pixel, sample_idx, dim0 + j). pixel and
        sample_idx are (N,) tensors. The independent kind draws them in
        one hash."""
        if self.kind != "independent":
            return torch.stack([self.get_1d(pixel, sample_idx, dim0 + j)
                                for j in range(n)], dim=-1)
        dims = torch.arange(dim0, dim0 + n, dtype=torch.int64,
                            device=pixel.device)
        v0, _, _, _ = rng.pcg4d(pixel[:, None], sample_idx[:, None],
                                dims[None, :], self.seed)
        return rng.u32_to_uniform(v0)
