"""K1's entry body in isolation, with ablations.

Port of scripts/micro/micro_entry.py: n_ent entries per program, each 13
row loads of a triangle table, Moller-Trumbore on (8 rays, 128
triangles), the nearest hit per ray and a 9-column accumulator update.
Six modes cut the body at each stage: loads_only, blocks_only, mt_only,
no_write, full and while. The CUDA kernel is
`pbrt_tpu_torch/csrc/micro_entry.cu`; `micro_entry_ref` is its plain
PyTorch version, bit-equal with it.

The probe returns only (8,1): its acc plus group 0's t. In the four
modes that never write the accumulator that t stays 1e30, so the output
is 1e30 or inf and keeps none of acc's bits; in full and while acc stays
0. With `with_scratch=True` both functions also return the last
program's (128,8,16) accumulator, which holds every entry's update, and
its loop's own (8,1) acc before group 0's t is added; the tests and
chip_smoke.py compare both. The probe's table gives its rays no hit at
all, so mt_only's and no_write's acc overflow and full's accumulator
keeps its initial values; `hits_inputs` is a table whose triangles they
hit in every entry.

The printed ns/entry is the probe's: milliseconds over grid x n_ent. On
the card the 64 blocks run side by side, so it is one entry's latency
divided by 64.

    python -m pbrt_tpu_torch.micro.micro_entry [--device cpu]
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import (LaunchStats, check_input, device_line, launch, load, madd,
               parse_device, time_ms, tree_sum)

GRID = 64
N_ENT = 2000
MODES = ("loads_only", "blocks_only", "mt_only", "no_write", "full", "while")
REPS = 10
# FP32 operations of one Moller-Trumbore test as K1 writes it (the count
# chip_smoke.py's MT_OPS explains).
MT_OPS = 53
# FP32 operations of one entry of each mode (8 rays x 128 lanes = 1024
# pairs): loads_only two 128-lane sums (127 adds each) and 2 adds per
# ray; blocks_only 8 multiplies, a 7-add sum and 8 adds; mt_only the
# test per pair, a min per ray (127) and an add; full adds to mt_only per
# pair the hit compare, the pid select, the pid compare and 7 selects,
# per ray the pid max (127) and 7 sums (127 each) and 9 column selects;
# no_write adds 3 per ray instead of the store.
_FULL = 1024 * (MT_OPS + 10) + 8 * (127 * 9 + 1 + 9)
OPS_PER_ENTRY = {"loads_only": 2 * 127 + 16, "blocks_only": 23,
                 "mt_only": 1024 * MT_OPS + 8 * 128, "no_write": _FULL + 24,
                 "full": _FULL, "while": _FULL}

STATS = LaunchStats()


def inputs() -> np.ndarray:
    """The probe's triangle table (1024,128)."""
    return np.random.default_rng(0).normal(size=(1024, 128)).astype(np.float32)


# The 13 rows of a triangle that every ray of every program crosses: the
# cut of the plane x + y + z = 3000 by the positive octant (v0, e1, e2),
# then pid and the normal.
_CROSSED = (3000.0, 0.0, 0.0, -3000.0, 3000.0, 0.0, -3000.0, 0.0, 3000.0,
            1000.0, 0.5, 0.6, 0.7)


def hits_inputs() -> np.ndarray:
    """A (1024,128) table whose triangles the probe's rays hit in every
    entry, at any grid up to 64. Lane l < 13 holds, from row l on, the
    rows of _CROSSED repeated with period 13 (pid 1000 + l), so entry j's
    rows c..c+12 hold that triangle whole in lane c % 13. The other lanes
    are normal values around 300 (spread 300); each is hit by about one
    ray in twenty and is then often nearer, so the nearest hit depends on
    the data."""
    tri = np.random.default_rng(1).normal(size=(1024, 128)) * 300 + 300
    rows = np.arange(1024)
    for lane in range(13):
        block = np.asarray(_CROSSED)
        block[9] += lane
        tri[lane:, lane] = block[(rows[lane:] - lane) % 13]
    return tri.astype(np.float32)


def _dot3(a, b, c, d, e, f):
    """a * b + c * d + e * f, rounded as (a * b + c * d) + e * f."""
    return madd(e, f, madd(a, b, c * d))


def micro_entry_ref(tri: torch.Tensor, *, mode: str, grid: int = GRID,
                    n_ent: int = N_ENT, with_scratch: bool = False):
    """Plain PyTorch version, vectorised over the grid: the (8,1) the last
    program stores (and, with_scratch, its (128,8,16) accumulator and its
    loop's (8,1) acc)."""
    dev = tri.device
    base = 0.5 + torch.arange(grid, dtype=torch.float32, device=dev)
    rays = torch.zeros((grid, 128, 8, 8), dtype=torch.float32, device=dev)
    for c in range(6):
        rays[..., c] = (base * (c + 1.0))[:, None, None]
    accs = torch.zeros((grid, 128, 8, 16), dtype=torch.float32, device=dev)
    accs[..., 0] = 1e30
    acc = torch.zeros((grid, 8, 1), dtype=torch.float32, device=dev)
    for j in range(n_ent):
        g = (j * 13) % 128
        c = (j * 7) % 900
        rows = tri[c:c + 13]
        if mode == "loads_only":
            acc = acc + tree_sum(rows[0]) + tree_sum(rows[9])
            continue
        (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, pid, anx, any_,
         anz) = rows[:, None, None, :]
        blk = rays[:, g]
        ox, oy, oz = blk[..., 0:1], blk[..., 1:2], blk[..., 2:3]
        dx, dy, dz = blk[..., 3:4], blk[..., 4:5], blk[..., 5:6]
        if mode == "blocks_only":
            acc = acc + tree_sum((ox * dz)[..., 0])[:, None, None]
            continue
        ab = accs[:, g]
        tb = ab[..., 0:1]
        # a * b - c * d and a * b + c * d + e * f, as madd writes them.
        px = madd(dy, e2z, -(dz * e2y))
        py = madd(dz, e2x, -(dx * e2z))
        pz = madd(dx, e2y, -(dy * e2x))
        det = _dot3(e1x, px, e1y, py, e1z, pz)
        ok = torch.abs(det) > 1e-12
        inv_det = torch.where(ok, 1.0 / det, 0.0)
        tvx = ox - v0x
        tvy = oy - v0y
        tvz = oz - v0z
        uk = _dot3(tvx, px, tvy, py, tvz, pz) * inv_det
        qx = madd(tvy, e1z, -(tvz * e1y))
        qy = madd(tvz, e1x, -(tvx * e1z))
        qz = madd(tvx, e1y, -(tvy * e1x))
        vk = _dot3(dx, qx, dy, qy, dz, qz) * inv_det
        tk = _dot3(e2x, qx, e2y, qy, e2z, qz) * inv_det
        hit = (ok & (uk >= 0.0) & (vk >= 0.0) & (uk + vk <= 1.0) & (tk > 0.0)
               & (tk < tb))
        tkh = torch.where(hit, tk, 3e38)
        tmin = torch.amin(tkh, dim=-1, keepdim=True)
        if mode == "mt_only":
            acc = acc + tmin
            continue
        better = tmin < tb
        eq = hit & (tkh == tmin)
        pid_sel = torch.amax(torch.where(eq, pid, 0.0), dim=-1, keepdim=True)
        eq1 = eq & (pid == pid_sel)
        # The seven lane sums side by side: the same tree for each.
        picked = torch.stack(torch.broadcast_tensors(uk, vk, anx, any_, anz,
                                                     anx, any_))
        sel = tree_sum(torch.where(eq1, picked, 0.0)).permute(1, 2, 0)
        cols = [torch.where(better, tmin, tb),
                torch.where(better, pid_sel, ab[..., 1:2]),
                torch.where(better, sel, ab[..., 2:9])]
        if mode == "no_write":
            acc = acc + cols[0] * 0.0 + tmin
            continue
        accs[:, g, :, 0:9] = torch.cat(cols, dim=-1)
    out = (acc + accs[:, 0, :, 0:1])[grid - 1]
    return (out, accs[grid - 1], acc[grid - 1]) if with_scratch else out


def _library():
    p, i = ctypes.c_void_p, ctypes.c_int
    return load("micro_entry", tuple(f"micro_entry_{m}" for m in MODES),
                {None: [p, i, i, p, p, p, p]})


def micro_entry(tri: torch.Tensor, *, mode: str, grid: int = GRID,
                n_ent: int = N_ENT, with_scratch: bool = False):
    """The (8,1) the probe's kern stores (and, with_scratch, the last
    program's accumulator and its loop's acc); a CPU tensor runs the plain
    version, a CUDA tensor the kernel (or raises)."""
    check_input("micro_entry: tri", tri, (1024, 128))
    if mode not in MODES:
        raise ValueError(f"micro_entry: mode {mode!r} not in {MODES}")
    if grid < 1 or not 0 <= n_ent < 1 << 27:
        raise ValueError(f"micro_entry: grid {grid}, n_ent {n_ent} out of "
                         "range")
    if tri.device.type == "cpu":
        return micro_entry_ref(tri, mode=mode, grid=grid, n_ent=n_ent,
                               with_scratch=with_scratch)
    dev = tri.device
    out = torch.empty((grid, 8), dtype=torch.float32, device=dev)
    scratch = acc = None
    if with_scratch:
        scratch = torch.empty((128, 8, 16), dtype=torch.float32, device=dev)
        acc = torch.empty((8, 1), dtype=torch.float32, device=dev)
    launch(_library(), "micro_entry", f"micro_entry_{mode}", STATS, dev,
           tri.data_ptr(), n_ent, grid, out.data_ptr(),
           None if scratch is None else scratch.data_ptr(),
           None if acc is None else acc.data_ptr())
    res = out[grid - 1].reshape(8, 1)
    return (res, scratch, acc) if with_scratch else res


def work(mode: str, grid: int = GRID,
         n_ent: int = N_ENT) -> tuple[float, float]:
    """(FP32 operations, bytes) of one call: the table read once, the
    output written once."""
    return (float(grid * n_ent * OPS_PER_ENTRY[mode]),
            float(4 * (1024 * 128 + 8)))


def run(device: torch.device) -> list[dict]:
    """Time the probe's six modes, in its order."""
    tri = torch.from_numpy(inputs()).to(device)
    rows = []
    for mode in MODES:
        ms = time_ms(lambda: micro_entry(tri, mode=mode), REPS, device)
        rows.append({"mode": mode, "grid": GRID, "n_ent": N_ENT, "ms": ms,
                     "ns_per_entry": ms * 1e6 / GRID / N_ENT})
    return rows


def main(argv=None) -> None:
    device = parse_device("micro_entry", argv)
    print(device_line(device), flush=True)
    for r in run(device):
        print(f"{r['mode']:12s}: {r['ms']:8.3f} ms -> "
              f"{r['ns_per_entry']:7.1f} ns/entry", flush=True)


if __name__ == "__main__":
    main()
