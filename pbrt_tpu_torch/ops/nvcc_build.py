"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each kernel source `pbrt_tpu_torch/csrc/<name>.cu` exposes a plain C
interface (no PyTorch headers, so a build takes seconds). On first use it
is compiled for sm_90a into `pbrt_tpu_torch/_build/<name>-<key>.so`, where
the key hashes the source, the package's shared headers (`csrc/*.cuh`),
the flags and the compiler path, so an edited source, header or flag
rebuilds; a file lock serializes concurrent builders. A build failure
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# --fmad=false with nvcc's default IEEE division and square root keeps each
# float operation one rounding, as in the plain PyTorch twins.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

# name -> (seconds, compiler output) of builds made in this process.
BUILD_LOG: dict[str, tuple[float, str]] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): CUDA kernels cannot be built"
        )
    return found


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu if its build is missing, then load it."""
    src = CSRC_DIR / f"{name}.cu"
    nvcc = nvcc_path()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    key = hashlib.sha256(
        src.read_bytes() + headers + "\0".join((nvcc, *NVCC_FLAGS)).encode()
    ).hexdigest()[:16]
    lib = build_locked(name, key,
                       lambda out: [nvcc, *NVCC_FLAGS, "-o", out, str(src)])
    return ctypes.CDLL(str(lib))


def build_locked(name: str, key: str, command) -> Path:
    """`_build/<name>-<key>.so`, made by `command(output_path)` if it is
    missing, under a file lock so that concurrent builders make it once;
    the output is written to a temporary name and renamed into place. A
    failed build raises with the compiler's output."""
    BUILD_DIR.mkdir(exist_ok=True)
    lib = BUILD_DIR / f"{name}-{key}.so"
    if not lib.exists():
        with open(BUILD_DIR / f"{name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not lib.exists():
                tmp = BUILD_DIR / f"{name}-{key}.{os.getpid()}.tmp"
                cmd = command(str(tmp))
                t0 = time.perf_counter()
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"{os.path.basename(cmd[0])} failed (exit "
                        f"{proc.returncode}): {' '.join(cmd)}\n"
                        f"{proc.stdout}{proc.stderr}"
                    )
                os.replace(tmp, lib)
                BUILD_LOG[name] = (
                    time.perf_counter() - t0, proc.stdout + proc.stderr
                )
    return lib
