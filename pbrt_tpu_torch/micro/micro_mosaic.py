"""Loop overhead and a dense vector body on one (8,128) block.

Port of scripts/micro/micro_mosaic.py's two kernels: `loop` (its
loop_kernel: 1000 iterations of `empty`, `reduce` or `cond`) and `dense`
(its dense_kernel: 256 bodies of a 21-op fake Moller-Trumbore chain). The
CUDA kernels are in `pbrt_tpu_torch/csrc/micro_mosaic.cu`; `loop_ref` and
`dense_ref` are their plain PyTorch versions, bit-equal with them. The
probe's x is ones and its b is 0.5, so `cond`'s branch is never taken.

The printed ns/iter is the probe's: milliseconds over grid x iterations.
The TPU runs its grid in order, so there it is one iteration's latency; on
the card the blocks run side by side, so it is the card's throughput.

    python -m pbrt_tpu_torch.micro.micro_mosaic [--device cpu]
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import (LaunchStats, check_input, device_line, launch, load, madd,
               parse_device, time_ms, tree_sum)

GRID = 1024
N_IT = 1000
DENSE_N_IT = 256
LOOP_MODES = ("empty", "reduce", "cond")
REPS = 10
# Operations per element (or per block) of one iteration, counted as
# separate FP32 operations. loop: empty adds 1; reduce does the multiply
# and add of v, the block max (1023 per block), the compare and the add;
# cond the same without the add, and on a taken branch the sum of x
# (1023 per block) and the add. dense: x = a (i + 1) (1), five times
# (multiply, add, multiply, add, min, multiply, subtract, compare,
# select), and the accumulate (1).
LOOP_OPS = {"empty": (1, 0), "reduce": (3, 1024), "cond": (2, 1024)}
COND_TAKEN_OPS = (1, 1023)
DENSE_OPS = 47
PROBE_DENSE_VOPS = 21  # the probe's count of vector ops in one body

LOOP_STATS = LaunchStats()
DENSE_STATS = LaunchStats()


def inputs() -> tuple[np.ndarray, np.ndarray]:
    """The probe's x (ones) and b (0.5), both (8,128); dense's a is x."""
    return (np.ones((8, 128), np.float32),
            np.full((8, 128), 0.5, np.float32))


def crossing_inputs(n_it: int = N_IT) -> np.ndarray:
    """An x (8,128) under which loop's block max crosses 1e30 within n_it
    iterations: the probe's ones, with lane 0 raised to 2.5e30 / n_it, so
    that reduce takes its 1.0 and cond its branch from about iteration
    0.4 n_it on. Under the probe's ones neither ever happens."""
    x = np.ones((8, 128), np.float32)
    x[0, 0] = 2.5e30 / n_it
    return x


def loop_ref(x: torch.Tensor, *, mode: str, grid: int = GRID,
             n_it: int = N_IT, return_taken: bool = False):
    """Plain PyTorch version of loop, vectorised over the grid: the (8,128)
    the last program stores; with return_taken, also the number of
    (program, iteration) pairs whose branch (`cond`) or whose 1.0 (`reduce`)
    was taken."""
    xs = x.reshape(1, 1024).expand(grid, 1024)
    acc = torch.zeros((grid, 1024), dtype=torch.float32, device=x.device)
    taken = torch.zeros((), dtype=torch.int64, device=x.device)
    for k in range(n_it):
        i = float(k)
        if mode == "empty":
            acc = acc + 1.0
            continue
        v = madd(xs, 1.0 + i, acc)
        m = torch.amax(v, dim=1) > 1e30
        taken = taken + m.sum()
        if mode == "reduce":
            acc = acc + torch.where(m, 1.0, 0.5)[:, None]
        else:
            acc = torch.where(m[:, None], acc + tree_sum(xs)[:, None], acc)
    out = acc[grid - 1].reshape(8, 128)
    return (out, int(taken)) if return_taken else out


def dense_ref(a: torch.Tensor, b: torch.Tensor, *, grid: int = GRID,
              n_it: int = DENSE_N_IT) -> torch.Tensor:
    """Plain PyTorch version of dense, vectorised over the grid."""
    a = a.reshape(1, 1024).expand(grid, 1024)
    b = b.reshape(1, 1024).expand(grid, 1024)
    acc = torch.zeros((grid, 1024), dtype=torch.float32, device=a.device)
    for k in range(n_it):
        x = a * (float(k) + 1.0)
        for _ in range(5):
            x = madd(x, b, a)
            x = torch.minimum(x * 1.0001, b + x)
            y = madd(x, x, -b)
            x = torch.where(y > 0, x, y)
        acc = acc + x
    return acc[grid - 1].reshape(8, 128)


def _library():
    p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    entries = tuple(f"micro_mosaic_loop_{m}" for m in LOOP_MODES)
    return load("micro_mosaic", entries + ("micro_mosaic_dense",), {
        None: [p, f, i, p, p],
        "micro_mosaic_dense": [p, p, f, i, p, p],
    })


def _check_consts(grid: int, n_it: int) -> None:
    if grid < 1 or n_it < 0 or n_it > 1 << 24:
        raise ValueError(f"grid {grid} and n_it {n_it}: need grid >= 1 and "
                         "0 <= n_it <= 2**24 (a float loop index)")


def loop(x: torch.Tensor, *, mode: str, grid: int = GRID,
         n_it: int = N_IT) -> torch.Tensor:
    """The (8,128) the probe's loop_kernel stores; a CPU tensor runs the
    plain version, a CUDA tensor the kernel (or raises)."""
    check_input("micro_mosaic.loop: x", x, (8, 128))
    if mode not in LOOP_MODES:
        raise ValueError(f"micro_mosaic.loop: mode {mode!r} not in "
                         f"{LOOP_MODES}")
    _check_consts(grid, n_it)
    if x.device.type == "cpu":
        return loop_ref(x, mode=mode, grid=grid, n_it=n_it)
    out = torch.empty((grid, 8, 128), dtype=torch.float32, device=x.device)
    launch(_library(), "micro_mosaic", f"micro_mosaic_loop_{mode}",
           LOOP_STATS, x.device, x.data_ptr(), float(n_it), grid,
           out.data_ptr())
    return out[grid - 1]


def dense(a: torch.Tensor, b: torch.Tensor, *, grid: int = GRID,
          n_it: int = DENSE_N_IT) -> torch.Tensor:
    """The (8,128) the probe's dense_kernel stores; a CPU tensor runs the
    plain version, a CUDA tensor the kernel (or raises)."""
    check_input("micro_mosaic.dense: a", a, (8, 128))
    check_input("micro_mosaic.dense: b", b, (8, 128))
    _check_consts(grid, n_it)
    if a.device.type == "cpu":
        return dense_ref(a, b, grid=grid, n_it=n_it)
    if b.device != a.device:
        raise ValueError("micro_mosaic.dense: a and b on different devices")
    out = torch.empty((grid, 8, 128), dtype=torch.float32, device=a.device)
    launch(_library(), "micro_mosaic", "micro_mosaic_dense", DENSE_STATS,
           a.device, a.data_ptr(), b.data_ptr(), float(n_it), grid,
           out.data_ptr())
    return out[grid - 1]


def loop_work(mode: str, grid: int = GRID, n_it: int = N_IT,
              taken: int = 0) -> tuple[float, float]:
    """(FP32 operations, bytes) of one loop call; `taken` is the number of
    (program, iteration) pairs whose `cond` branch ran."""
    per_elem, per_block = LOOP_OPS[mode]
    ops = grid * n_it * (1024 * per_elem + per_block)
    if mode == "cond":
        ops += taken * (1024 * COND_TAKEN_OPS[0] + COND_TAKEN_OPS[1])
    return float(ops), 4.0 * 2 * 1024


def dense_work(grid: int = GRID,
               n_it: int = DENSE_N_IT) -> tuple[float, float]:
    """(FP32 operations, bytes) of one dense call."""
    return float(grid * n_it * 1024 * DENSE_OPS), 4.0 * 3 * 1024


def run(device: torch.device) -> list[dict]:
    """Time each loop mode, then dense, at the probe's sizes."""
    x_np, y_np = inputs()
    x = torch.from_numpy(x_np).to(device)
    y = torch.from_numpy(y_np).to(device)
    rows = []
    for mode in LOOP_MODES:
        ms = time_ms(lambda: loop(x, mode=mode), REPS, device)
        rows.append({"kernel": "loop", "mode": mode, "grid": GRID,
                     "n_it": N_IT, "ms": ms,
                     "ns_per_iter": ms * 1e6 / GRID / N_IT})
    ms = time_ms(lambda: dense(x, y), REPS, device)
    lane_ops = GRID * DENSE_N_IT * PROBE_DENSE_VOPS * 1024.0
    rows.append({"kernel": "dense", "mode": "dense", "grid": GRID,
                 "n_it": DENSE_N_IT, "ms": ms,
                 "ns_per_iter": ms * 1e6 / GRID / DENSE_N_IT,
                 "tlaneops_per_s": lane_ops / (ms * 1e-3) / 1e12})
    return rows


def main(argv=None) -> None:
    device = parse_device("micro_mosaic", argv)
    print(device_line(device), flush=True)
    for r in run(device):
        if r["kernel"] == "loop":
            print(f"loop[{r['mode']}]: {r['ms']:.2f} ms for {r['grid']}x"
                  f"{r['n_it']} iters = {r['ns_per_iter']:.0f} ns/iter",
                  flush=True)
        else:
            print(f"dense: {r['ms']:.2f} ms for {r['grid']}x{r['n_it']} "
                  f"bodies = {r['tlaneops_per_s']:.2f} Tlaneops/s, "
                  f"{r['ns_per_iter']:.0f} ns/body", flush=True)


if __name__ == "__main__":
    main()
