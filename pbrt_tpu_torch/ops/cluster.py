"""K2: closest / any-hit queries over Morton-sorted triangle clusters.

Port of pbrt_tpu/ops/cluster.py. The Hopper kernel is
`pbrt_tpu_torch/csrc/cluster.cu`; `cluster_intersect_ref` is its plain
PyTorch twin, with the kernel's operation order and tie rules, so the two
agree bit for bit.

Contract (read per ray from the reference kernel, `_cluster_kernel`):
  - Walk the supers (32 clusters of 128 triangles each) in order; a ray
    walks a super's clusters in order when its own slab test of the super
    box passes at super entry, and tests a cluster when its own slab test
    of the cluster box passes. The slab test is the reference's
    (`inv_d = 1 / where(|d| < 1e-12, 1e-12, d)`, only the z interval
    clamped at 0, pass when `tmax >= tmin and tmin < t_best`).
  - Closest mode: a triangle hits when |det| > 1e-12, u >= 0, v >= 0,
    u + v <= 1 and 0 < t < t_best at cluster entry. The cluster's smallest
    hit t (3e38 when it has none) is committed when it is < t_best, with
    the largest prim id among exact ties; across clusters the earlier
    cluster keeps a tie.
  - Any-hit mode: in the first cluster where the ray hits, prim is the
    largest prim id among that cluster's hits, and t_best becomes 0, so no
    later gate passes.
The reference gates per tile of 1024 rays instead of per ray; the two
differ only where a slab test's rounding and the triangle test disagree
at a box face (tests/test_torch_cluster.py counts it). The kernel walks
per warp of 32 rays (csrc/cluster_walk.cuh): the twin's `counts` say how
its work falls into 128-ray blocks, 32-ray warps and the warp visits it
tests triangle-parallel (LONE_MAX).

Dispatch is by the device of the rays: CPU tensors take the twin; CUDA
tensors launch the kernel, and a failed build or launch raises. Nothing
falls back and nothing moves to another device.

Output: t f32 (inf on miss) and prim i32 (-1); with defer_attrs=False in
closest mode also u, v f32 (0), n (N, 3) f32 (0), mat i32 (0) and light
i32 (-1) of the hit triangle.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.tensorclass import static_field, tensorclass
from .detach import detached_query
from .smallscene import LaunchStats

_CLUSTER = 128  # triangles per cluster
_SUPER = 32  # clusters per super-cluster (4096 triangles)
_BIG = 3e38
_EPS = 1e-12
_INF = float("inf")
_WARP = 32  # rays per warp of the kernel's walk
_BLOCK = 128  # rays per block: the unit of the block-staged walk it replaced
# The kernel's switch-over: a (warp, cluster) visit with at most this many
# needing rays is tested triangle-parallel (kLoneMax in
# csrc/cluster_walk.cuh; tests/test_torch_cluster.py holds the two equal).
LONE_MAX = 16
# Triangle rows the test reads, in the kernel's staging order.
_TRI_KEYS = ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z",
             "pid")
_ATTR_KEYS = ("nx", "ny", "nz", "matf", "lightf")


@tensorclass
class ClusterAccel:
    # The reference's layout, kept so a converted scene's tables are
    # bit-equal. Triangle components, cluster-major: (C, 128) each.
    v0x: torch.Tensor
    v0y: torch.Tensor
    v0z: torch.Tensor
    e1x: torch.Tensor
    e1y: torch.Tensor
    e1z: torch.Tensor
    e2x: torch.Tensor
    e2y: torch.Tensor
    e2z: torch.Tensor
    pid: torch.Tensor  # (C, 128) float32 prim id + 1 (0.0 = pad slot)
    # Hit attributes (C, 128): unit geometric normal, material id + 1 and
    # light id + 1 as floats (exact below 2^24).
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    matf: torch.Tensor
    lightf: torch.Tensor
    # Cluster AABB rows (C, 8) = [lox loy loz hix hiy hiz 0 0].
    boxes: torch.Tensor
    # Super-cluster AABB rows (S, 8); pad supers hold a far point box at
    # 2e30 (their cluster range is empty anyway).
    sboxes: torch.Tensor
    n_clusters: int = static_field(default=0)
    n_supers: int = static_field(default=0)


def build_clusters(tri_verts, tri_mat=None, tri_light=None) -> ClusterAccel:
    """Morton-sort triangles; pack 128-triangle clusters + AABBs + attrs,
    then 32-cluster super-AABBs. Same numpy code as the reference."""
    from ..accel.bvh import morton_order

    tri_verts = np.asarray(tri_verts, np.float32)
    t = tri_verts.shape[0]
    if t >= 1 << 24:
        raise ValueError(f"{t} triangles: float ids are exact below 2^24")
    if tri_mat is None:
        tri_mat = np.zeros((t,), np.int32)
    if tri_light is None:
        tri_light = np.full((t,), -1, np.int32)
    cent = tri_verts.mean(axis=1)
    order = morton_order(cent)
    v = tri_verts[order]

    c = -(-t // _CLUSTER)
    p = c * _CLUSTER
    vp = np.full((p, 3, 3), 1e30, np.float32)
    vp[:t] = v
    pid = np.full((p,), -1, np.int64)
    pid[:t] = order
    vp = vp.reshape(c, _CLUSTER, 3, 3)
    real = (pid.reshape(c, _CLUSTER) >= 0)[..., None, None]
    cl_lo = np.where(real, vp, np.inf).min(axis=(1, 2)).astype(np.float32)
    cl_hi = np.where(real, vp, -np.inf).max(axis=(1, 2)).astype(np.float32)
    boxes = np.concatenate([cl_lo, cl_hi, np.zeros((c, 2), np.float32)], axis=1)

    s = -(-c // _SUPER)
    sp = s * _SUPER
    slo = np.full((sp, 3), np.inf, np.float32)
    shi = np.full((sp, 3), -np.inf, np.float32)
    slo[:c] = cl_lo
    shi[:c] = cl_hi
    slo = slo.reshape(s, _SUPER, 3).min(axis=1)
    shi = shi.reshape(s, _SUPER, 3).max(axis=1)
    pad_s = ~np.isfinite(slo[:, 0])
    slo[pad_s] = 2e30
    shi[pad_s] = 2e30
    sboxes = np.concatenate([slo, shi, np.zeros((s, 2), np.float32)], axis=1)

    e1 = vp[:, :, 1] - vp[:, :, 0]
    e2 = vp[:, :, 2] - vp[:, :, 0]
    nrm = np.cross(e1.reshape(p, 3), e2.reshape(p, 3))
    nlen = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = np.where(nlen > 1e-30, nrm / np.maximum(nlen, 1e-30), 0.0)
    nrm = np.where((pid >= 0)[:, None], nrm, 0.0).astype(np.float32)
    nrm = nrm.reshape(c, _CLUSTER, 3)
    pid_f = (pid + 1).astype(np.float32).reshape(c, _CLUSTER)
    matp = np.zeros((p,), np.int64)
    matp[:t] = np.asarray(tri_mat, np.int64)[order]
    lightp = np.full((p,), -1, np.int64)
    lightp[:t] = np.asarray(tri_light, np.int64)[order]

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    return ClusterAccel(
        v0x=f32(vp[:, :, 0, 0]), v0y=f32(vp[:, :, 0, 1]), v0z=f32(vp[:, :, 0, 2]),
        e1x=f32(e1[..., 0]), e1y=f32(e1[..., 1]), e1z=f32(e1[..., 2]),
        e2x=f32(e2[..., 0]), e2y=f32(e2[..., 1]), e2z=f32(e2[..., 2]),
        pid=f32(pid_f),
        nx=f32(nrm[..., 0]), ny=f32(nrm[..., 1]), nz=f32(nrm[..., 2]),
        matf=f32((matp + 1).reshape(c, _CLUSTER)),
        lightf=f32((lightp + 1).reshape(c, _CLUSTER)),
        boxes=f32(boxes), sboxes=f32(sboxes),
        n_clusters=c, n_supers=s,
    )


def slab(box, ox, oy, oz, ix, iy, iz, t_best):
    """Per-ray AABB test of box = (lox, loy, loz, hix, hiy, hiz), including
    the closer-hit prune (tmin < t_best); the reference's op order."""
    lox, loy, loz, hix, hiy, hiz = box[:6]
    tx0 = (lox - ox) * ix
    tx1 = (hix - ox) * ix
    ty0 = (loy - oy) * iy
    ty1 = (hiy - oy) * iy
    tz0 = (loz - oz) * iz
    tz1 = (hiz - oz) * iz
    tmin = torch.maximum(
        torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
        torch.clamp(torch.minimum(tz0, tz1), min=0.0),
    )
    tmx = torch.minimum(
        torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
        torch.maximum(tz0, tz1),
    )
    return (tmx >= tmin) & (tmin < t_best)


def inv_dir(x):
    return 1.0 / torch.where(torch.abs(x) < _EPS, _EPS, x)


def mt_rows(tri: dict, c: int, rox, roy, roz, rdx, rdy, rdz, tb):
    """Moller-Trumbore of k rays (columns (k, 1)) against the 128 rows of
    cluster c in the kernels' operation order. A row hits when |det| >
    1e-12, u >= 0, v >= 0, u + v <= 1 and 0 < t < tb. Returns (hit, t, u,
    v) as (k, 128) and the rows' pid + 1 as (1, 128)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, pid = (
        tri[key][c][None, :] for key in _TRI_KEYS
    )
    px = rdy * e2z - rdz * e2y
    py = rdz * e2x - rdx * e2z
    pz = rdx * e2y - rdy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > _EPS
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    tvx = rox - v0x
    tvy = roy - v0y
    tvz = roz - v0z
    uk = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    vk = (rdx * qx + rdy * qy + rdz * qz) * inv_det
    tk = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (ok & (uk >= 0.0) & (vk >= 0.0) & (uk + vk <= 1.0)
           & (tk > 0.0) & (tk < tb[:, None]))
    return hit, tk, uk, vk, pid


def closest_of_rows(hit, tk, pid):
    """Each ray's smallest hit t over its 128 rows (3e38 without a hit),
    the rows at that t, and the largest pid + 1 among them (0 without)."""
    tkh = torch.where(hit, tk, _BIG)
    tmin = torch.amin(tkh, dim=1)
    eq = hit & (tkh == tmin[:, None])
    return tmin, eq, torch.amax(torch.where(eq, pid, 0.0), dim=1)


VISIT_KEYS = ("pairs", "block_visits", "warp_visits", "lone_visits")


def count_visits(counts: dict | None, idx) -> None:
    """Add one cluster's tested rays (sorted indices `idx` into the batch
    the kernel sees) to `counts`: "pairs" (ray, cluster) tests, the work
    for the kernel's bound; "block_visits" and "warp_visits", the distinct
    128-ray and 32-ray groups among them; "lone_visits", the warp visits
    with at most LONE_MAX rays, which the kernel tests triangle-parallel."""
    if counts is None:
        return
    _, per_warp = torch.unique_consecutive(idx // _WARP, return_counts=True)
    add = {"pairs": idx.numel(),
           "block_visits": torch.unique_consecutive(idx // _BLOCK).numel(),
           "warp_visits": per_warp.numel(),
           "lone_visits": int((per_warp <= LONE_MAX).sum())}
    for key, value in add.items():
        counts[key] += value


def cluster_intersect_ref(accel: ClusterAccel, o, d, tmax,
                          any_hit: bool = False, defer_attrs: bool = True,
                          counts: dict | None = None):
    """Plain PyTorch twin of K2: the supers and clusters in order, each
    cluster's Moller-Trumbore test vectorised over the rays whose own slab
    tests pass, (k rays x 128 triangles). Its cost follows the passing
    (ray, cluster) pairs; `counts`, when given, accumulates them and the
    kernel's block and warp visits (count_visits)."""
    n = o.shape[0]
    dev = o.device
    ox, oy, oz = (o[:, i].contiguous() for i in range(3))
    dx, dy, dz = (d[:, i].contiguous() for i in range(3))
    ix, iy, iz = inv_dir(dx), inv_dir(dy), inv_dir(dz)
    t_best = tmax.clone()
    prim_f = torch.zeros((n,), dtype=torch.float32, device=dev)
    attrs = not (any_hit or defer_attrs)
    if attrs:
        ub = torch.zeros_like(prim_f)
        vb = torch.zeros_like(prim_f)
        slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    sboxes = accel.sboxes.detach().cpu().tolist()
    boxes = accel.boxes.detach().cpu().tolist()
    tri = {k: getattr(accel, k) for k in _TRI_KEYS}
    for key in VISIT_KEYS if counts is not None else ():
        counts.setdefault(key, 0)
    for s in range(accel.n_supers):
        live_s = slab(sboxes[s], ox, oy, oz, ix, iy, iz, t_best)
        idx_s = torch.nonzero(live_s).squeeze(1)
        if idx_s.numel() == 0:
            continue
        ray_s = [x[idx_s] for x in (ox, oy, oz, ix, iy, iz)]
        for c in range(s * _SUPER, min((s + 1) * _SUPER, accel.n_clusters)):
            live_c = slab(boxes[c], *ray_s, t_best[idx_s])
            idx = idx_s[live_c]
            k = idx.numel()
            if k == 0:
                continue
            count_visits(counts, idx)
            rox, roy, roz, rdx, rdy, rdz = (
                x[idx][:, None] for x in (ox, oy, oz, dx, dy, dz))
            tb = t_best[idx]
            hit, tk, uk, vk, pid = mt_rows(tri, c, rox, roy, roz, rdx, rdy,
                                           rdz, tb)
            if any_hit:
                got = torch.any(hit, dim=1)
                pid_max = torch.amax(torch.where(hit, pid, 0.0), dim=1)
                t_best[idx] = torch.where(got, 0.0, tb)
                prim_f[idx] = torch.where(got, pid_max, prim_f[idx])
                continue
            tmin, eq, pid_sel = closest_of_rows(hit, tk, pid)
            better = tmin < tb
            t_best[idx] = torch.where(better, tmin, tb)
            prim_f[idx] = torch.where(better, pid_sel, prim_f[idx])
            if attrs:
                one = eq & (pid == pid_sel[:, None])
                found = torch.any(one, dim=1)
                j = torch.argmax(one.to(torch.uint8), dim=1)
                u_sel = torch.where(found, uk.gather(1, j[:, None])[:, 0], 0.0)
                v_sel = torch.where(found, vk.gather(1, j[:, None])[:, 0], 0.0)
                s_sel = torch.where(found, c * _CLUSTER + j, -1)
                ub[idx] = torch.where(better, u_sel, ub[idx])
                vb[idx] = torch.where(better, v_sel, vb[idx])
                slot[idx] = torch.where(better, s_sel, slot[idx])
    miss = prim_f <= 0.0
    out = {
        "t": torch.where(miss, _INF, t_best),
        "prim": torch.where(miss, -1, prim_f.to(torch.int32) - 1).to(torch.int32),
    }
    if not attrs:
        return out
    at = torch.clamp(slot, min=0)
    nx, ny, nz, matf, lightf = (
        getattr(accel, k).reshape(-1)[at] for k in _ATTR_KEYS
    )
    out.update(
        u=torch.where(miss, 0.0, ub),
        v=torch.where(miss, 0.0, vb),
        n=torch.where(miss[:, None], 0.0, torch.stack([nx, ny, nz], dim=-1)),
        mat=torch.where(miss, 0, matf.to(torch.int32) - 1).to(torch.int32),
        light=torch.where(miss, -1, lightf.to(torch.int32) - 1).to(torch.int32),
    )
    return out


STATS = LaunchStats()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a built cluster.cu library (once)."""
    if getattr(lib, "_argtypes_set", False):
        return lib
    p = ctypes.c_void_p
    lib.cluster_launch.argtypes = (
        [p] * 17 + [ctypes.c_int, ctypes.c_int, p, p, p, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int] + [p] * 7 + [p]
    )
    lib.cluster_launch.restype = ctypes.c_int
    lib.cluster_error_string.argtypes = [ctypes.c_int]
    lib.cluster_error_string.restype = ctypes.c_char_p
    lib._argtypes_set = True
    return lib


def _library():
    from .nvcc_build import load_library

    return bind(load_library("cluster"))


def _check(name, x, shape, dtype, device, align: int = 1):
    if x.dtype != dtype or tuple(x.shape) != shape or x.device != device:
        raise ValueError(
            f"cluster_intersect: {name} must be {dtype} {shape} on "
            f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"cluster_intersect: {name} must be contiguous")
    if x.data_ptr() % align:
        raise ValueError(f"cluster_intersect: {name} must be {align}-byte "
                         "aligned")


def _launch(accel: ClusterAccel, o, d, tmax, any_hit: bool, defer_attrs: bool):
    """Run K2 on the rays' CUDA device; raises on any build/launch error."""
    n = o.shape[0]
    dev = o.device
    c, s = accel.n_clusters, accel.n_supers
    tables = [getattr(accel, k) for k in _TRI_KEYS + _ATTR_KEYS]
    for key, x in zip(_TRI_KEYS + _ATTR_KEYS, tables):
        # The kernel stages triangle rows 16 B per lane (cp.async).
        _check(key, x, (c, _CLUSTER), torch.float32, dev,
               align=16 if key in _TRI_KEYS else 1)
    _check("boxes", accel.boxes, (c, 8), torch.float32, dev)
    _check("sboxes", accel.sboxes, (s, 8), torch.float32, dev)
    _check("o", o, (n, 3), torch.float32, dev)
    _check("d", d, (n, 3), torch.float32, dev)
    _check("tmax", tmax, (n,), torch.float32, dev)
    lib = _library()
    attrs = not (any_hit or defer_attrs)
    out = {
        "t": torch.empty((n,), dtype=torch.float32, device=dev),
        "prim": torch.empty((n,), dtype=torch.int32, device=dev),
    }
    if attrs:
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
        err = lib.cluster_launch(
            accel.sboxes.data_ptr(), accel.boxes.data_ptr(),
            *(x.data_ptr() for x in tables), c, s,
            o.data_ptr(), d.data_ptr(), tmax.data_ptr(), n,
            int(any_hit), int(defer_attrs),
            *(ptr(k) for k in ("t", "prim", "u", "v", "n", "mat", "light")),
            stream.cuda_stream,
        )
        if err != 0:
            raise RuntimeError(
                "cluster kernel launch failed: "
                + lib.cluster_error_string(err).decode()
            )
        STATS.launches += 1
        if events is not None:
            events[1].record(stream)
            STATS.events.append(events)
    return out


def _cluster_intersect_impl(accel: ClusterAccel, o, d, tmax,
                            any_hit: bool = False, defer_attrs: bool = True):
    """Closest or any hit of N rays against the cluster accelerator."""
    if o.device.type == "cpu":
        return cluster_intersect_ref(accel, o, d, tmax, any_hit=any_hit,
                                     defer_attrs=defer_attrs)
    if o.device.type == "cuda":
        return _launch(accel, o, d, tmax, any_hit, defer_attrs)
    raise ValueError(f"cluster_intersect: unsupported device {o.device}")


# Geometry detached under autograd (ops/detach.py).
cluster_intersect = detached_query(_cluster_intersect_impl)
