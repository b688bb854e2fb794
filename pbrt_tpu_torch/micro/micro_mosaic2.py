"""Per-iteration cost against body size, with and without a branch.

Port of scripts/micro/micro_mosaic2.py: n_it iterations, each a dynamic
row load and body_reps rounds of three min/max/multiply-add steps, with
(`cond`) or without (`nocond`) a branch on two whole-block maxes. The CUDA
kernel is `pbrt_tpu_torch/csrc/micro_mosaic2.cu` (one instance per run
of the probe: nocond at body_reps 12, cond at 1, 4, 12 and 36);
`micro_mosaic2_ref` is its plain PyTorch version, bit-equal with it.

The printed ns/iter is the probe's: milliseconds over grid x n_it. On the
card the blocks run side by side, so it is the card's throughput, not one
iteration's latency as on the TPU.

    python -m pbrt_tpu_torch.micro.micro_mosaic2 [--device cpu]
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import (LaunchStats, check_input, device_line, launch, load, madd,
               parse_device, time_ms)

GRID = 256
BODY_REPS = 12
MODES = ("nocond", "cond")
# The body sizes the kernel is built for, by mode: the probe's own.
REPS_BUILT = {"nocond": (BODY_REPS,), "cond": (1, 4, 12, 36)}
TIMES = 20
# The probe's runs, in its order: (mode, n_it, body_reps).
RUNS = tuple((m, n, BODY_REPS) for m in MODES for n in (256, 1024)) + tuple(
    ("cond", 1024, r) for r in REPS_BUILT["cond"])
# FP32 operations per element: 8 a round (multiply, add, multiply, add,
# min, subtract, multiply, max) and the accumulate; `cond` adds two block
# maxes (127 + 1023 per block), their sum and the compare, every
# iteration.
ROUND_OPS = 8
COND_BLOCK_OPS = 127 + 1023 + 2

STATS = LaunchStats()


def inputs() -> tuple[np.ndarray, np.ndarray]:
    """The probe's x (8,128) of 0.5 and table (2048,128)."""
    x = np.full((8, 128), 0.5, np.float32)
    tab = np.random.default_rng(0).normal(size=(2048, 128)).astype(np.float32)
    return x, tab


def _mt_like(x, row, body_reps):
    for _ in range(body_reps):
        x = madd(x, row, 1.0)
        x = torch.minimum(x, madd(row, x, 0.5))
        x = torch.maximum(x - row, x * 0.3)
    return x


def micro_mosaic2_ref(x: torch.Tensor, tab: torch.Tensor, *, mode: str,
                      n_it: int, body_reps: int = BODY_REPS,
                      grid: int = GRID, return_taken: bool = False):
    """Plain PyTorch version, vectorised over the grid: the (8,128) the
    last program stores; with return_taken, also the number of (program,
    iteration) pairs whose `cond` branch ran (all of them for `nocond`)."""
    pid = torch.arange(grid, dtype=torch.float32, device=x.device)
    xs = x.reshape(1, 1024) + pid[:, None]
    acc = xs * 0.0
    taken = torch.zeros((), dtype=torch.int64, device=x.device)
    for c in range(n_it):
        row = tab[c].repeat(8)[None, :]
        if mode == "nocond":
            acc = acc + _mt_like(xs, row, body_reps)
            continue
        m = torch.amax(tab[c]) + torch.amax(acc, dim=1) > -1.0
        taken = taken + m.sum()
        acc = torch.where(m[:, None], acc + _mt_like(xs, row, body_reps), acc)
    out = acc[grid - 1].reshape(8, 128)
    if not return_taken:
        return out
    return out, (grid * n_it if mode == "nocond" else int(taken))


def _library():
    p, i = ctypes.c_void_p, ctypes.c_int
    entries = tuple(f"micro_mosaic2_{m}_r{r}"
                    for m in MODES for r in REPS_BUILT[m])
    return load("micro_mosaic2", entries, {None: [p, p, i, i, p, p]})


def micro_mosaic2(x: torch.Tensor, tab: torch.Tensor, *, mode: str,
                  n_it: int, body_reps: int = BODY_REPS,
                  grid: int = GRID) -> torch.Tensor:
    """The (8,128) the probe's kern stores; a CPU tensor runs the plain
    version, a CUDA tensor the kernel (or raises)."""
    check_input("micro_mosaic2: x", x, (8, 128))
    check_input("micro_mosaic2: tab", tab, (2048, 128))
    if body_reps not in REPS_BUILT.get(mode, ()):
        raise ValueError(f"micro_mosaic2: mode {mode!r} / body_reps "
                         f"{body_reps}: the kernel is built for {REPS_BUILT}")
    if grid < 1 or not 0 <= n_it <= 2048:
        raise ValueError(f"micro_mosaic2: grid {grid}, n_it {n_it}: need "
                         "grid >= 1 and 0 <= n_it <= 2048 (the table's rows)")
    if x.device.type == "cpu":
        return micro_mosaic2_ref(x, tab, mode=mode, n_it=n_it,
                                 body_reps=body_reps, grid=grid)
    if tab.device != x.device:
        raise ValueError("micro_mosaic2: x and tab on different devices")
    out = torch.empty((grid, 8, 128), dtype=torch.float32, device=x.device)
    launch(_library(), "micro_mosaic2", f"micro_mosaic2_{mode}_r{body_reps}",
           STATS, x.device, x.data_ptr(), tab.data_ptr(), n_it, grid,
           out.data_ptr())
    return out[grid - 1]


def work(mode: str, n_it: int, body_reps: int = BODY_REPS, grid: int = GRID,
         taken: int | None = None) -> tuple[float, float]:
    """(FP32 operations, bytes) of one call; `taken` is the number of
    (program, iteration) pairs whose body ran (all, if None)."""
    taken = grid * n_it if taken is None else taken
    ops = taken * 1024 * (ROUND_OPS * body_reps + 1)
    if mode == "cond":
        ops += grid * n_it * COND_BLOCK_OPS
    nbytes = 4 * (1024 + 2048 * 128 + 1024)
    return float(ops), float(nbytes)


def run(device: torch.device) -> list[dict]:
    """Time the probe's eight runs, in its order."""
    x_np, tab_np = inputs()
    x = torch.from_numpy(x_np).to(device)
    tab = torch.from_numpy(tab_np).to(device)
    rows = []
    for mode, n_it, body_reps in RUNS:
        ms = time_ms(lambda: micro_mosaic2(x, tab, mode=mode, n_it=n_it,
                                           body_reps=body_reps), TIMES, device)
        rows.append({"mode": mode, "n_it": n_it, "body_reps": body_reps,
                     "grid": GRID, "ms": ms,
                     "ns_per_iter": ms * 1e6 / GRID / n_it})
    return rows


def main(argv=None) -> None:
    device = parse_device("micro_mosaic2", argv)
    print(device_line(device), flush=True)
    for r in run(device):
        print(f"{r['mode']} n_it={r['n_it']} reps={r['body_reps']}: "
              f"{r['ms']:.3f} ms -> {r['ns_per_iter']:.1f} ns/iter",
              flush=True)


if __name__ == "__main__":
    main()
