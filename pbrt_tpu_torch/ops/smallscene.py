"""K1: brute-force intersection for small scenes (<= 1024 triangles).

Port of pbrt_tpu/ops/smallscene.py. The Hopper kernel is
`pbrt_tpu_torch/csrc/smallscene.cu`; `smallscene_intersect_ref` is its plain
PyTorch twin, with the kernel's exact operation order and tie rule.

Dispatch is by the device of the rays: CPU tensors take the twin; CUDA
tensors launch the kernel, and a failed build or launch raises. Nothing
falls back and nothing moves to another device.

Output contract (the reference wrapper's dict): t f32 (inf on miss), prim
i32 (-1), u, v f32 (0), n (N, 3) f32 (0), mat i32 (0), light i32 (-1);
any-hit mode returns t (0 on hit, inf on miss) and prim only.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.tensorclass import static_field, tensorclass
from .detach import detached_query

_DET_EPS = 1e-12
_INF = float("inf")


@tensorclass
class SmallTriAccel:
    # Packed rows, one per triangle: 0:3 v0 | 3:6 e1 | 6:9 e2 | 9:12 unit
    # geometric normal | 12 pid+1 | 13 mat+1 | 14 light+1 | 15 pad. The
    # reference's layout, kept so a converted scene's table is bit-equal;
    # the ids are exact in float32 for the <= 1024 rows this tier holds.
    table: torch.Tensor  # (T, 16) float32
    n_tris: int = static_field(default=0)


def build_smallscene(tri_verts, tri_mat=None, tri_light=None) -> SmallTriAccel:
    """Host-side table build, same numpy code as the reference."""
    tri_verts = np.asarray(tri_verts, np.float32)
    t = tri_verts.shape[0]
    if tri_mat is None:
        tri_mat = np.zeros((t,), np.int64)
    if tri_light is None:
        tri_light = np.full((t,), -1, np.int64)
    e1 = tri_verts[:, 1] - tri_verts[:, 0]
    e2 = tri_verts[:, 2] - tri_verts[:, 0]
    n = np.cross(e1, e2)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(ln > 1e-30, n / np.maximum(ln, 1e-30), 0.0)
    tab = np.zeros((t, 16), np.float32)
    tab[:, 0:3] = tri_verts[:, 0]
    tab[:, 3:6] = e1
    tab[:, 6:9] = e2
    tab[:, 9:12] = n
    tab[:, 12] = np.arange(1, t + 1, dtype=np.float32)
    tab[:, 13] = np.asarray(tri_mat, np.float32) + 1.0
    tab[:, 14] = np.asarray(tri_light, np.float32) + 1.0
    return SmallTriAccel(table=torch.from_numpy(tab), n_tris=t)


def _finish(t, prim_f, u, v, n, mat_f, light_f, any_hit):
    """Float ids (id+1, 0 = miss) -> the int32 output contract."""
    miss = prim_f <= 0.0
    prim = torch.where(miss, -1, prim_f.to(torch.int32) - 1).to(torch.int32)
    t = torch.where(miss, _INF, t)
    if any_hit:
        return {"t": t, "prim": prim}
    return {
        "t": t,
        "prim": prim,
        "u": torch.where(miss, 0.0, u),
        "v": torch.where(miss, 0.0, v),
        "n": n,
        "mat": torch.where(miss, 0, mat_f.to(torch.int32) - 1).to(torch.int32),
        "light": torch.where(miss, -1, light_f.to(torch.int32) - 1).to(torch.int32),
    }


def smallscene_intersect_ref(accel: SmallTriAccel, o, d, tmax,
                             any_hit: bool = False):
    """Plain PyTorch twin of K1: a Python loop over the table rows on (N,)
    tensors, in the kernel's operation order, strict '<' updates."""
    tab = [row.tolist() for row in accel.table.detach().cpu()]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    zero = torch.zeros_like(tmax)
    tb, pb, ub, vb = tmax, zero, zero, zero
    nxb, nyb, nzb, mb, lb = zero, zero, zero, zero, zero
    for row in tab:
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = row[:9]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        ok = torch.abs(det) > _DET_EPS
        inv_det = torch.where(ok, 1.0 / det, 0.0)
        tvx = ox - v0x
        tvy = oy - v0y
        tvz = oz - v0z
        u = (tvx * px + tvy * py + tvz * pz) * inv_det
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        tk = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tk > 0.0) & (tk < tb)
        if any_hit:
            # A hit ends the ray: t collapses so later rows fail tk < tb.
            tb = torch.where(hit, 0.0, tb)
            pb = torch.where(hit, row[12], pb)
            continue
        tb = torch.where(hit, tk, tb)
        pb = torch.where(hit, row[12], pb)
        ub = torch.where(hit, u, ub)
        vb = torch.where(hit, v, vb)
        nxb = torch.where(hit, row[9], nxb)
        nyb = torch.where(hit, row[10], nyb)
        nzb = torch.where(hit, row[11], nzb)
        mb = torch.where(hit, row[13], mb)
        lb = torch.where(hit, row[14], lb)
    n = torch.stack([nxb, nyb, nzb], dim=-1)
    return _finish(tb, pb, ub, vb, n, mb, lb, any_hit)


class LaunchStats:
    """Launch count of the kernel, and optional CUDA-event timing.

    `launches` goes up by one at each kernel launch and nowhere else (the
    CPU twin does not count). With `reset(timed=True)`, each launch is
    bracketed by CUDA events whose total `elapsed_ms()` reads after a
    synchronize.
    """

    def __init__(self):
        self.launches = 0
        self.events = None

    def reset(self, timed: bool = False):
        self.launches = 0
        self.events = [] if timed else None

    def elapsed_ms(self) -> float:
        return sum(s.elapsed_time(e) for s, e in self.events or ())


STATS = LaunchStats()


def _library():
    from .nvcc_build import load_library

    lib = load_library("smallscene")
    if not getattr(lib, "_argtypes_set", False):
        p = ctypes.c_void_p
        lib.smallscene_launch.argtypes = [
            p, ctypes.c_int, p, p, p, ctypes.c_longlong, ctypes.c_int,
            p, p, p, p, p, p, p, p,
        ]
        lib.smallscene_launch.restype = ctypes.c_int
        lib.smallscene_error_string.argtypes = [ctypes.c_int]
        lib.smallscene_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(name, x, shape, dtype, device):
    if x.dtype != dtype or tuple(x.shape) != shape or x.device != device:
        raise ValueError(
            f"smallscene_intersect: {name} must be {dtype} {shape} on "
            f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"smallscene_intersect: {name} must be contiguous")


def _launch(accel: SmallTriAccel, o, d, tmax, any_hit: bool):
    """Run K1 on the rays' CUDA device; raises on any build/launch error."""
    n = o.shape[0]
    dev = o.device
    table = accel.table
    _check("table", table, (accel.n_tris, 16), torch.float32, dev)
    _check("o", o, (n, 3), torch.float32, dev)
    _check("d", d, (n, 3), torch.float32, dev)
    _check("tmax", tmax, (n,), torch.float32, dev)
    lib = _library()
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    out = {"t": t, "prim": prim}
    if not any_hit:
        out.update(
            u=torch.empty((n,), dtype=torch.float32, device=dev),
            v=torch.empty((n,), dtype=torch.float32, device=dev),
            n=torch.empty((n, 3), dtype=torch.float32, device=dev),
            mat=torch.empty((n,), dtype=torch.int32, device=dev),
            light=torch.empty((n,), dtype=torch.int32, device=dev),
        )
    if n == 0:
        return out

    def ptr(key):
        return out[key].data_ptr() if key in out else None

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        events = None
        if STATS.events is not None:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(stream)
        err = lib.smallscene_launch(
            table.data_ptr(), accel.n_tris, o.data_ptr(), d.data_ptr(),
            tmax.data_ptr(), n, int(any_hit), t.data_ptr(), prim.data_ptr(),
            ptr("u"), ptr("v"), ptr("n"), ptr("mat"), ptr("light"),
            stream.cuda_stream,
        )
        if err != 0:
            raise RuntimeError(
                "smallscene kernel launch failed: "
                + lib.smallscene_error_string(err).decode()
            )
        STATS.launches += 1
        if events is not None:
            events[1].record(stream)
            STATS.events.append(events)
    return out


def _smallscene_intersect_impl(accel: SmallTriAccel, o, d, tmax,
                               any_hit: bool = False):
    """Closest or any hit of N rays against the small-scene table."""
    if o.device.type == "cpu":
        return smallscene_intersect_ref(accel, o, d, tmax, any_hit=any_hit)
    if o.device.type == "cuda":
        return _launch(accel, o, d, tmax, any_hit)
    raise ValueError(f"smallscene_intersect: unsupported device {o.device}")


# Geometry detached under autograd (ops/detach.py).
smallscene_intersect = detached_query(_smallscene_intersect_impl)
