"""Live-first compaction of 128 lanes, then a gather loop over the live ids.

Port of scripts/micro/micro_pairs.py (the probe of the primitives a
pair-list intersector needs: a lane prefix sum, a permutation, a loop with
a dynamic bound, dynamic row reads and a dynamic row store). The CUDA
kernel is `pbrt_tpu_torch/csrc/micro_pairs.cu`; `micro_pairs_ref` is its
plain PyTorch version. Both are exact: the sums are of 0/1 values, and
the gather loop runs its ids in order with one rounding per operation.

What the probe leaves unwritten (o_list's columns 1-127, o_gather's other
entries) is 0 here; the probe's own values there are undefined.

    python -m pbrt_tpu_torch.micro.micro_pairs [--device cpu]
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import (LaunchStats, check_input, device_line, launch, load, madd,
               parse_device, time_ms)

STATS = LaunchStats()
REPS = 10


def inputs() -> tuple[np.ndarray, np.ndarray]:
    """The probe's inputs: live (1,128) of 0/1 and rays (128,8)."""
    rng = np.random.default_rng(0)
    live = (rng.random((1, 128)) < 0.3).astype(np.float32)
    rays = rng.normal(size=(128, 8)).astype(np.float32)
    return live, rays


def micro_pairs_ref(live: torch.Tensor, rays: torch.Tensor):
    """Plain PyTorch version: (o_list (128,128), o_gather (8,128),
    o_meta (1,1))."""
    live = live[0]
    cum = torch.cumsum(live, 0)
    count = cum[127]
    idx = torch.arange(128, dtype=torch.float32, device=live.device)
    pos = torch.where(live > 0, cum - 1.0, count + idx - cum)
    ids = torch.zeros(128, dtype=torch.float32, device=live.device)
    ids[pos.long()] = idx
    o_list = torch.zeros((128, 128), dtype=torch.float32, device=live.device)
    o_list[:, 0] = ids
    n = int(count)
    acc = torch.zeros(8, dtype=torch.float32, device=live.device)
    for j, g in enumerate(ids[:n].long().tolist()):
        acc = madd(rays[g], j + 1.0, acc)
    o_gather = torch.zeros((8, 128), dtype=torch.float32, device=live.device)
    o_gather[:, 0] = acc
    o_gather[n % 8, 1] = 123.0
    return o_list, o_gather, count.reshape(1, 1)


def _library():
    p = ctypes.c_void_p
    return load("micro_pairs", ("micro_pairs_launch",), {None: [p] * 6})


def micro_pairs(live: torch.Tensor, rays: torch.Tensor):
    """(o_list, o_gather, o_meta) of the probe's kernel; a CPU tensor runs
    the plain version, a CUDA tensor the kernel (or raises)."""
    check_input("micro_pairs: live", live, (1, 128))
    check_input("micro_pairs: rays", rays, (128, 8))
    if live.device.type == "cpu":
        return micro_pairs_ref(live, rays)
    if rays.device != live.device:
        raise ValueError("micro_pairs: live and rays on different devices")
    lib = _library()
    dev = live.device
    o_list = torch.empty((128, 128), dtype=torch.float32, device=dev)
    o_gather = torch.empty((8, 128), dtype=torch.float32, device=dev)
    o_meta = torch.empty((1, 1), dtype=torch.float32, device=dev)
    launch(lib, "micro_pairs", "micro_pairs_launch", STATS, dev,
           live.data_ptr(), rays.data_ptr(), o_list.data_ptr(),
           o_gather.data_ptr(), o_meta.data_ptr())
    return o_list, o_gather, o_meta


def work(count: int) -> tuple[float, float]:
    """(FP32 operations, bytes) of one call with `count` live lanes: the
    prefix sum and positions (about 4 per lane), the gather loop's
    multiply, add and index per live id and ray column; the inputs read
    once and the three outputs written once."""
    ops = 4 * 128 + count * 8 * 3
    nbytes = 4 * (128 + 128 * 8) + 4 * (128 * 128 + 8 * 128 + 1)
    return float(ops), float(nbytes)


def run(device: torch.device) -> list[dict]:
    """Check the kernel's answer as the probe does, then time it."""
    live_np, rays_np = inputs()
    live = torch.from_numpy(live_np).to(device)
    rays = torch.from_numpy(rays_np).to(device)
    lst, gat, meta = micro_pairs(live, rays)
    n = int(live_np.sum())
    ids = lst[:n, 0].long().cpu().numpy()
    if int(meta[0, 0]) != n or set(ids) != set(np.nonzero(live_np[0])[0]):
        raise AssertionError("micro_pairs: live-first ids wrong")
    exp = np.zeros(8)
    for j, g in enumerate(ids):
        exp += rays_np[g] * (j + 1.0)
    np.testing.assert_allclose(gat[:, 0].cpu().numpy(), exp, rtol=1e-5)
    ms = time_ms(lambda: micro_pairs(live, rays), REPS, device)
    return [{"mode": "pairs", "count": n, "ms": ms}]


def main(argv=None) -> None:
    device = parse_device("micro_pairs", argv)
    print(device_line(device), flush=True)
    for r in run(device):
        print(f"device={device.type}: OK count={r['count']}", flush=True)
        print(f"{r['mode']:12s}: {r['ms']:8.3f} ms", flush=True)


if __name__ == "__main__":
    main()
