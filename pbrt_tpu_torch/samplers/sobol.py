"""Exact Sobol' sequence evaluation from Joe-Kuo generator matrices (port
of pbrt_tpu/samplers/sobol.py).

data/sobol_matrices.npy holds the 32-bit generator matrices of the first
256 dimensions of the Joe & Kuo (2008) new-joe-kuo-6 direction numbers
(the reference's table, copied). The reference XOR-accumulates the
direction vector of every set index bit in a 32-step loop. XOR is linear,
so the port folds each byte of the index into one lookup: row d's four
256-entry tables hold the XOR of the direction vectors of every bit
pattern of index byte k, and a value is four lookups XORed, bit for bit
the same as the loop's, in a dozen tensor ops instead of a hundred.
uint32 values live in int64 tensors (core/rng.py).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

N_SOBOL_DIMS = 256


@functools.lru_cache(maxsize=1)
def matrices_np() -> np.ndarray:
    """(256, 32) uint32 direction vectors; row d = dimension d."""
    path = os.path.join(os.path.dirname(__file__), "data", "sobol_matrices.npy")
    arr = np.load(path)
    assert arr.shape == (N_SOBOL_DIMS, 32) and arr.dtype == np.uint32
    return arr


@functools.lru_cache(maxsize=1)
def _byte_tables_np() -> np.ndarray:
    """(256, 4, 256) int64: [d, k, b] = XOR of row d's direction vectors
    8k + j over the set bits j of byte value b."""
    m = matrices_np().astype(np.int64)
    bits = (np.arange(256)[:, None] >> np.arange(8)[None, :]) & 1  # (256, 8)
    out = np.zeros((N_SOBOL_DIMS, 4, 256), np.int64)
    for k in range(4):
        rows = m[:, None, 8 * k:8 * k + 8] * bits[None]  # (256 dims, 256, 8)
        out[:, k] = np.bitwise_xor.reduce(rows, axis=-1)
    return out


_TABLES: dict = {}


def byte_tables(device) -> torch.Tensor:
    """The byte tables on `device` (built once per device)."""
    device = torch.device(device)
    t = _TABLES.get(device)
    if t is None:
        t = torch.from_numpy(_byte_tables_np()).to(device)
        _TABLES[device] = t
    return t


def sobol_bits(idx: torch.Tensor, dim: int) -> torch.Tensor:
    """Sobol' value (a uint32 in an int64 tensor) of sample `idx` (uint32
    values in an int64 tensor) in dimension `dim`, taken mod 256."""
    t = byte_tables(idx.device)[dim % N_SOBOL_DIMS]
    v = t[0][idx & 0xFF]
    for k in (1, 2, 3):
        v = v ^ t[k][(idx >> (8 * k)) & 0xFF]
    return v
