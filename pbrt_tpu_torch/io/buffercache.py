"""Content-addressed mesh-buffer cache.

A copy of pbrt_tpu/io/buffercache.py (numpy only), so the port needs
nothing of the reference package. Reference analogue: BufferCache<T>
(pbrt-v4 src/pbrt/util/buffercache.h) — pbrt hashes every
vertex/index/uv/normal buffer a TriangleMesh hands it and shares one
canonical copy across meshes, reporting the redundant bytes saved. Scene
exporters routinely redeclare the same mesh (or re-reference the same PLY)
under many transforms, so the dedup is large on production scenes.

The cache lives at parse time only (device buffers are fused per-scene
tables, already unique); deduping here shares host numpy arrays and skips
repeated PLY parses. `report_stats` adds the counters to the stats
registry (utils/stats.py) under the reference's names and returns them.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np


class BufferCache:
    """Canonicalizes numpy buffers by content hash; caches PLY reads."""

    def __init__(self):
        self._buffers = {}  # digest -> canonical ndarray
        self._ply = {}  # (abspath, mtime) -> (verts, faces)
        self.lookups = 0
        self.hits = 0
        self.redundant_bytes = 0

    def canonical(self, arr: np.ndarray) -> np.ndarray:
        """One shared, read-only copy per distinct buffer content."""
        arr = np.ascontiguousarray(arr)
        self.lookups += 1
        key = (arr.dtype.str, arr.shape,
               hashlib.blake2b(arr.tobytes(), digest_size=16).digest())
        hit = self._buffers.get(key)
        if hit is not None:
            self.hits += 1
            self.redundant_bytes += arr.nbytes
            return hit
        arr.setflags(write=False)
        self._buffers[key] = arr
        return arr

    def read_ply(self, path: str):
        """PLY vertex/face buffers, parsed once per (path, mtime)."""
        from .ply import read_ply

        ap = os.path.abspath(path)
        try:
            key = (ap, os.stat(ap).st_mtime_ns)
        except OSError:
            key = (ap, 0)
        self.lookups += 1
        hit = self._ply.get(key)
        if hit is not None:
            self.hits += 1
            self.redundant_bytes += hit[0].nbytes + hit[1].nbytes
            return hit
        verts, faces = read_ply(ap)
        verts = self.canonical(np.asarray(verts))
        faces = self.canonical(np.asarray(faces))
        self.lookups -= 2  # canonical() self-lookups aren't user lookups
        self._ply[key] = (verts, faces)
        return verts, faces

    def report_stats(self) -> dict:
        """Add the reference's counters, by the names it gives them, to
        utils.stats.STATS, and return them."""
        from ..utils.stats import STATS

        counters = {
            "buffercache/lookups": self.lookups,
            "buffercache/hits": self.hits,
            "buffercache/redundant MB":
                int(self.redundant_bytes / (1024 * 1024)),
        }
        for name, value in counters.items():
            STATS.add(name, value)
        return counters
