"""Morton ordering of triangle centroids (port of pbrt_tpu/accel/bvh.py's
`morton_order`, the host-side sort the cluster build runs).

The reference may take its native C++ radix sort (native/accel_build.cpp),
which it documents as bit-identical to this numpy path; the port keeps the
numpy rule only. The jnp BVH traversal itself is not ported (ROADMAP Queue
1 item 8).
"""

from __future__ import annotations

import numpy as np


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit coords -> 30-bit Morton codes. x: (n, 3) in [0,1)."""
    q = np.clip((x * 1024.0).astype(np.uint32), 0, 1023).astype(np.uint64)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return (
        spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
        | (spread(q[:, 2]) << np.uint64(2))
    )


def morton_order(cent: np.ndarray) -> np.ndarray:
    """Stable ascending-Morton permutation of (n, 3) float32 centroids."""
    lo = cent.min(axis=0)
    hi = cent.max(axis=0)
    norm = (cent - lo) / np.maximum(hi - lo, 1e-12)
    return np.argsort(_morton3(norm), kind="stable")
