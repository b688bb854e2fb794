"""Native (C++) host code: the scene-file tokenizer and the Morton order of
the acceleration builds (port of pbrt_tpu/native/).

The package keeps its own copies of the reference's two translation units
(`tokenizer.cpp`, `accel_build.cpp`, C ABI `tokenize` and `morton_order`).
On first use they are compiled with `g++ -O3` into
`pbrt_tpu_torch/_build/native-<key>.so`, where the key hashes the sources,
the flags and the compiler path, under the file lock of
`ops/nvcc_build.build_locked`, and bound through ctypes. A failed build
raises: the callers (`io/parser.tokenize`, `accel/bvh.morton_order`) have
no silent fallback. Their plain twins, `io/parser.tokenize_py` and
`accel/bvh.morton_order_np`, give the same answers and are what the
tests hold the native code against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import shutil
from pathlib import Path

import numpy as np

from ..ops import nvcc_build

_DIR = Path(__file__).resolve().parent
SOURCES = ("tokenizer.cpp", "accel_build.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def cxx_path() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the native tokenizer and "
                           "Morton sort cannot be built")
    return found


def build(sources, name: str = "native") -> Path:
    """`_build/<name>-<key>.so` compiled from the C++ `sources` (paths)
    if it is missing; a failed build raises RuntimeError."""
    srcs = [str(s) for s in sources]
    cxx = cxx_path()
    key = hashlib.sha256(
        b"".join(Path(s).read_bytes() for s in srcs)
        + "\0".join((cxx, *CXX_FLAGS)).encode()
    ).hexdigest()[:16]
    return nvcc_build.build_locked(
        name, key, lambda out: [cxx, *CXX_FLAGS, "-o", out, *srcs])


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The compiled native library, built on first use."""
    lib = ctypes.CDLL(str(build(_DIR / s for s in SOURCES)))
    lib.tokenize.restype = ctypes.c_longlong
    lib.tokenize.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_double),
        ctypes.c_longlong,
    ]
    lib.morton_order.restype = None
    lib.morton_order.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def tokenize_native(text: str) -> list[str]:
    """Tokens of .pbrt source by the C++ pass, as `io/parser.tokenize_py`
    gives them: quoted strings keep their quotes, brackets are single
    characters, numbers and identifiers are their source text. A string
    left open at the end of the text raises ValueError, as the Python
    pass's `str.index` does."""
    lib = get_lib()
    raw = text.encode("utf-8", errors="surrogateescape")
    n = len(raw)
    cap = max(256, n // 2 + 16)
    while True:
        starts = np.empty(cap, np.int32)
        ends = np.empty(cap, np.int32)
        kinds = np.empty(cap, np.int8)
        values = np.empty(cap, np.float64)
        count = lib.tokenize(raw, n, _ptr(starts, ctypes.c_int32),
                             _ptr(ends, ctypes.c_int32),
                             _ptr(kinds, ctypes.c_int8),
                             _ptr(values, ctypes.c_double), cap)
        if count >= 0:
            break
        cap = -count
    if count and kinds[count - 1] == 1 and ends[count - 1] > n:
        raise ValueError("unterminated string in the scene text")
    return [raw[s:e].decode("utf-8", errors="surrogateescape")
            for s, e in zip(starts[:count].tolist(), ends[:count].tolist())]


def morton_order_native(centroids) -> np.ndarray:
    """Stable ascending-Morton permutation of (n, 3) float32 centroids
    (the front half of pbrt's HLBVH build, aggregates.cpp:389-505): an
    (n,) int64 array, bit-identical to `accel/bvh.morton_order_np`."""
    lib = get_lib()
    cent = np.ascontiguousarray(centroids, np.float32)
    n = cent.shape[0]
    order = np.empty(n, np.int64)
    if n:
        lib.morton_order(_ptr(cent, ctypes.c_float), n,
                         _ptr(order, ctypes.c_int64))
    return order
