"""The cost of one dynamic index inside a 2048-iteration loop.

Port of scripts/micro/micro_dyn.py: nine modes, each one primitive per
iteration (a static or dynamic row load, eight dynamic loads, a dynamic
row store, a scalar read or write, a row-to-column relayout, a (1,128) @
(128,128) product, a 33-operation chain). The CUDA kernel is
`pbrt_tpu_torch/csrc/micro_dyn.cu`; `micro_dyn_ref` is its plain PyTorch
version, bit-equal with it (sums by the halving tree of `tree_sum`).

The probe's scalar scratch is read before it is written under
`smemread`, so its answer there is undefined; here the scratch starts at
zero and the answer is 128 * (grid - 1).

The printed ns/iter is the probe's: milliseconds over grid x n_it. On the
card the 64 blocks run side by side, so it is one iteration's latency
divided by 64.

    python -m pbrt_tpu_torch.micro.micro_dyn [--device cpu]
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import (LaunchStats, check_input, device_line, launch, load, madd,
               parse_device, time_ms, tree_sum)

GRID = 64
N_IT = 2048
# The probe's modes in its order, with the rows of acc: (1,128) or (8,128).
MODES = {"staticload": 1, "dynload": 1, "dynload8": 1, "dynstore": 1,
         "smemread": 1, "smemwrite": 1, "reshape18": 8, "mt35": 8,
         "matmul_small": 1}
REPS = 10
# FP32 operations per element of acc and iteration: staticload a multiply
# and an add; dynload an add; dynload8 eight adds; dynstore and smemwrite
# an add; smemread a conversion and an add; reshape18 an add; mt35 11
# rounds of 8 (multiply, add, multiply, add, min, subtract, multiply,
# max); matmul_small 128 multiplies, 127 adds and the add to acc per
# output column. The final sum adds rows x 128 - 1 per program.
OPS = {"staticload": 2, "dynload": 1, "dynload8": 8, "dynstore": 1,
       "smemread": 2, "smemwrite": 1, "reshape18": 1, "mt35": 88,
       "matmul_small": 256}

STATS = LaunchStats()


def inputs() -> np.ndarray:
    """The probe's table (1024,128)."""
    return np.random.default_rng(0).normal(size=(1024, 128)).astype(np.float32)


def _mt35(x, row):
    for _ in range(11):
        x = madd(x, row, 1.0)
        x = torch.minimum(x, madd(row, x, 0.5))
        x = torch.maximum(x - row, x * 0.3)
    return x


def micro_dyn_ref(tab: torch.Tensor, *, mode: str, grid: int = GRID,
                  n_it: int = N_IT) -> torch.Tensor:
    """Plain PyTorch version, vectorised over the grid: the (1,1) sum the
    last program stores."""
    dev = tab.device
    rows = MODES[mode]
    prog = torch.arange(grid, device=dev)
    acc = torch.zeros((grid, rows, 128), dtype=torch.float32,
                      device=dev) + prog.float()[:, None, None]
    j_all = (torch.arange(n_it, device=dev)[:, None] * 7 + prog) % 900
    sm = torch.zeros((grid, 1024), dtype=torch.int32, device=dev)
    scr = (torch.zeros((grid, 1024, 128), dtype=torch.float32, device=dev)
           if mode == "dynstore" else None)
    m = tab[0:128]
    for i in range(n_it):
        j = j_all[i]
        if mode == "staticload":
            acc = madd(tab[0], float(i), acc)
        elif mode == "dynload":
            acc = acc + tab[j][:, None, :]
        elif mode == "dynload8":
            r = tab[j]
            for k in range(7):
                r = r + tab[j + k + 1]
            acc = acc + r[:, None, :]
        elif mode == "dynstore":
            scr[prog, j] = acc[:, 0]
            acc = acc + 1.0
        elif mode == "smemread":
            acc = acc + sm[prog, j].float()[:, None, None]
        elif mode == "smemwrite":
            sm[prog, j] = i
            acc = acc + 1.0
        elif mode == "reshape18":
            acc = acc + tab[j, 0:8][:, :, None]
        elif mode == "matmul_small":
            acc = acc + tree_sum(acc[:, 0, :, None] * m[None], dim=1)[:, None]
        else:
            acc = _mt35(acc, tab[j][:, None, :])
    return tree_sum(acc.reshape(grid, rows * 128))[grid - 1].reshape(1, 1)


def _library():
    p, i = ctypes.c_void_p, ctypes.c_int
    return load("micro_dyn", tuple(f"micro_dyn_{m}" for m in MODES),
                {None: [p, i, i, p, p, p]})


def micro_dyn(tab: torch.Tensor, *, mode: str, grid: int = GRID,
              n_it: int = N_IT) -> torch.Tensor:
    """The (1,1) the probe's kern stores; a CPU tensor runs the plain
    version, a CUDA tensor the kernel (or raises)."""
    check_input("micro_dyn: tab", tab, (1024, 128))
    if mode not in MODES:
        raise ValueError(f"micro_dyn: mode {mode!r} not in {tuple(MODES)}")
    if grid < 1 or n_it < 0 or 7 * (n_it - 1) + grid - 1 >= 1 << 31:
        raise ValueError(f"micro_dyn: grid {grid}, n_it {n_it} out of range")
    if tab.device.type == "cpu":
        return micro_dyn_ref(tab, mode=mode, grid=grid, n_it=n_it)
    dev = tab.device
    out = torch.empty((grid,), dtype=torch.float32, device=dev)
    # dynstore's slabs are written and never read: no need to clear them.
    scr = (torch.empty((grid, 1024, 128), dtype=torch.float32, device=dev)
           if mode == "dynstore" else None)
    launch(_library(), "micro_dyn", f"micro_dyn_{mode}", STATS, dev,
           tab.data_ptr(), n_it, grid, out.data_ptr(),
           None if scr is None else scr.data_ptr())
    return out[grid - 1:].reshape(1, 1)


def work(mode: str, grid: int = GRID, n_it: int = N_IT) -> tuple[float, float]:
    """(FP32 operations, bytes) of one call: the table read once, the
    output written once; the stores to scratch are not counted."""
    elems = MODES[mode] * 128
    ops = grid * (n_it * elems * OPS[mode] + elems - 1)
    return float(ops), float(4 * (1024 * 128 + 1))


def run(device: torch.device) -> list[dict]:
    """Time the probe's nine modes, in its order."""
    tab = torch.from_numpy(inputs()).to(device)
    rows = []
    for mode in MODES:
        ms = time_ms(lambda: micro_dyn(tab, mode=mode), REPS, device)
        rows.append({"mode": mode, "grid": GRID, "n_it": N_IT, "ms": ms,
                     "ns_per_iter": ms * 1e6 / GRID / N_IT})
    return rows


def main(argv=None) -> None:
    device = parse_device("micro_dyn", argv)
    print(device_line(device), flush=True)
    for r in run(device):
        print(f"{r['mode']:14s}: {r['ms']:8.3f} ms -> "
              f"{r['ns_per_iter']:7.1f} ns/iter", flush=True)


if __name__ == "__main__":
    main()
