"""Card micro-benchmarks: the port of the repository's TPU lowering probes.

Each module ports one probe of `scripts/micro/` (a Pallas kernel whose
ablations time one primitive of the TPU's vector core) to a hand-written
CUDA kernel for sm_90a, with the probe's inputs, constants and modes:

    micro_pairs    live-first compaction of 128 lanes, then a gather loop
    micro_mosaic   loop overhead (empty / reduce / cond) and a dense body
    micro_mosaic2  per-iteration cost against body size, with a cond
    micro_dyn      one dynamic index (global, shared, scalar) per iteration
    micro_entry    K1's entry body: 13 row loads, Moller-Trumbore on
                   (8 rays, 128 triangles), the nearest-hit update

Each module holds its kernel's wrapper (a CPU tensor runs the plain
PyTorch version, a CUDA tensor launches the kernel or raises), the plain
version (`*_ref`, vectorised over the grid), a launch counter, the probe's
inputs, the work one call does (for a bound) and a `main()`:

    python -m pbrt_tpu_torch.micro.<module> [--device cuda|cpu]

prints the card's name and power limit, then the probe's own lines.

A TPU grid runs its programs in order, and every probe but micro_pairs
maps all programs onto one output block, so the last program's store is
the answer. On the card, blocks run in no order: each block stores into
its own slot and the wrapper returns slot `grid - 1`.

This file holds what the modules share: the fixed summation tree that a
kernel and its plain version both follow (so the two are bit-equal), the
comparison with NaN equal, the multiply-add, and the launch and timing
helpers.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import time

import torch

from ..ops.smallscene import LaunchStats  # noqa: F401  (re-exported)

__all__ = ["LaunchStats", "madd", "tree_sum", "bits_equal", "check_input",
           "load", "launch", "time_ms", "device_line", "parse_device"]


def madd(a, b, c):
    """a * b + c, rounded twice, as the kernels compute it (they are built
    with --fmad=false). The plain versions write every multiply-add that
    XLA's CPU backend contracts into an FMA through this function, so that
    the tests can hold them, with an FMA in its place, bit for bit against
    the probes run in interpret mode."""
    return a * b + c


def tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over `dim` (a power-of-two length) by halving: element k adds
    element k + n/2, then k + n/4, ..., down to one. The kernels reduce
    in this order, element for element."""
    n = x.shape[dim]
    if n & (n - 1):
        raise ValueError(f"tree_sum: length {n} is not a power of two")
    while n > 1:
        n //= 2
        x = x.narrow(dim, 0, n) + x.narrow(dim, n, n)
    return x.squeeze(dim)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same shape, NaN where the other is NaN, and the same bits
    everywhere else (the payload of a NaN is not compared)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a[~na], b[~nb])


def load(name: str, entries: tuple[str, ...], argtypes: dict) -> ctypes.CDLL:
    """Build (on first use) and load csrc/<name>.cu; set the argument
    types of each `extern "C"` entry (argtypes[entry], else
    argtypes[None]) and of `<name>_error_string`."""
    from ..ops.nvcc_build import load_library

    lib = load_library(name)
    if not getattr(lib, "_argtypes_set", False):
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = argtypes.get(entry, argtypes[None])
            fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def launch(lib: ctypes.CDLL, name: str, entry: str, stats: LaunchStats,
           device: torch.device, *args) -> None:
    """Call `entry(*args, stream)` on the device's current stream; raise
    if the launch was refused; count it."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        err = getattr(lib, entry)(*args, stream.cuda_stream)
        if err != 0:
            msg = getattr(lib, f"{name}_error_string")(err).decode()
            raise RuntimeError(f"{entry} launch failed: {msg}")
        stats.launches += 1


def check_input(what: str, x: torch.Tensor, shape: tuple,
                dtype=torch.float32) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"{what} must be {dtype} {shape}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def time_ms(fn, reps: int, device: torch.device) -> float:
    """Mean milliseconds of fn() over `reps` calls after one warm-up: CUDA
    events on a card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_line(device: torch.device) -> str:
    """The card's `name, power limit` from nvidia-smi; on the CPU a line
    that says the times are the plain versions' on the host."""
    if device.type != "cuda":
        return "cpu: plain PyTorch versions, host times"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[device.index or 0]


def parse_device(prog: str, argv=None) -> torch.device:
    """`--device cuda` (the default) or `--device cpu`; refuse a machine
    without a card unless the CPU was asked for."""
    ap = argparse.ArgumentParser(prog=prog, description=(
        "Time the probe's modes on the card (CUDA kernels) or, with "
        "--device cpu, the plain PyTorch versions on the host."))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"{prog}: no CUDA device; pass --device cpu to "
                             "run the plain versions on the host")
        return torch.device("cuda", 0)
    return torch.device("cpu")
