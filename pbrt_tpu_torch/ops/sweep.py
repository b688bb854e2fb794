"""K3: closest / any-hit queries over instanced triangle clusters.

Port of pbrt_tpu/ops/sweep.py. The Hopper kernel is
`pbrt_tpu_torch/csrc/sweep.cu`; `sweep_intersect_ref` is its plain
PyTorch twin, with the kernel's operation order and tie rules, so the two
agree bit for bit.

Prototype triangles are stored once, in object space, as clusters of 128
Morton-adjacent triangles (the reference's table layout); an instance is a
prototype under a 3x4 affine. The reference's XLA pre-pass (`_candidates`,
a per-tile interval bundle against every (cluster, instance) entry, sorted
by entry t) works around the TPU's scalar core and is not ported: the port
keeps its output contract and gates per ray instead.

Contract, per ray (the reference kernel's rules, with the order stated):
  - Walk the instances in order. An instance is entered when the ray's
    slab test of the instance's world box (the union of its entries'
    world boxes) passes. The slab test is the reference's
    (`inv_d = 1 / where(|d| < 1e-12, 1e-12, d)`, only the z interval
    clamped at 0, pass when `tmax >= tmin and tmin < t_best`).
  - Entering instance i moves the ray into object space with its
    world-to-object row: `a00*ox + a01*oy + a02*oz + b0`, left to right,
    and the direction unnormalised, so object t equals world t. A scene
    without instances (`instanced == False`) keeps the world ray.
  - Walk the prototype's clusters in order; test a cluster's 128 rows when
    the object-space ray's slab test of the object box passes.
  - Closest mode: a row hits when |det| > 1e-12, u >= 0, v >= 0,
    u + v <= 1 and 0 < t < t_best at cluster entry. The cluster's smallest
    hit t (3e38 when it has none) is committed, with the instance, when it
    is < t_best; the largest prim id wins an exact tie within a cluster,
    and the earlier (instance, cluster) keeps a tie across clusters.
  - Any-hit mode: in the first cluster where the ray hits, prim is the
    largest prim id among that cluster's hits, and t_best becomes 0, so no
    later gate passes.
The reference walks per tile of 1024 rays, in the tile's order of entry t,
testing every ray of a 64-ray block some ray needs; the two differ only
where a slab test's rounding and the triangle test disagree at a box face,
or on an exact t tie between two clusters (tests/test_torch_sweep.py
counts such rays).

Dispatch is by the device of the rays: CPU tensors take the twin; CUDA
tensors launch the kernel, and a failed build or launch raises. Nothing
falls back and nothing moves to another device.

Output: t f32 (inf on miss), prim i32 (global triangle id, -1 on miss),
inst i32 (-1 on miss).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..core.tensorclass import static_field, tensorclass
from .cluster import _TRI_KEYS, closest_of_rows, inv_dir, mt_rows, slab
from .detach import detached_query
from .smallscene import LaunchStats

_CLUSTER = 128  # triangles per cluster
_INF = float("inf")
# Rays x clusters of one slab-matrix chunk in the twin's pre-filter.
_PREFILTER_CHUNK = 1 << 22


@tensorclass
class SweepAccel:
    # The reference's layout, kept so a converted scene's tables are
    # bit-equal. Prototype triangle components, cluster-major: (C, 128)
    # each, in OBJECT space (world space when not instanced).
    v0x: torch.Tensor
    v0y: torch.Tensor
    v0z: torch.Tensor
    e1x: torch.Tensor
    e1y: torch.Tensor
    e1z: torch.Tensor
    e2x: torch.Tensor
    e2y: torch.Tensor
    e2z: torch.Tensor
    pid: torch.Tensor  # (C, 128) float32 global prim id + 1 (0.0 = pad)
    # Object-space cluster AABB rows: (C, 8) = [lo(3) hi(3) 0 0].
    boxes: torch.Tensor
    # Entries, one per (cluster, instance) pair, instance-major with each
    # instance's prototype clusters in order: world AABB rows (E, 8), and
    # cluster and instance ids (E,) int32.
    wboxes: torch.Tensor
    ecluster: torch.Tensor
    einst: torch.Tensor
    # Instance transforms, row-major 3x4 affines: (I, 12).
    w2o: torch.Tensor  # world -> object
    o2w: torch.Tensor  # object -> world
    # Derived from the entries when not given: each instance's world box
    # (I, 8), the union of its entries' wboxes, and its prototype's
    # cluster range (I, 2) int32 = [first cluster, cluster count].
    ibox: Optional[torch.Tensor] = None
    irange: Optional[torch.Tensor] = None
    n_clusters: int = static_field(default=0)
    n_entries: int = static_field(default=0)
    instanced: bool = static_field(default=False)

    def __post_init__(self):
        if self.ibox is not None and self.irange is not None:
            return
        n_inst = self.w2o.shape[0]
        einst = self.einst.long()
        first = torch.full((n_inst,), self.n_clusters, dtype=torch.int64,
                           device=einst.device)
        first = first.scatter_reduce(0, einst, self.ecluster.long(), "amin")
        count = torch.bincount(einst, minlength=n_inst)
        # Entries of instance i must be its prototype's clusters in order.
        start = torch.cumsum(count, 0) - count
        pos = torch.arange(einst.shape[0], device=einst.device) - start[einst]
        if not torch.equal(self.ecluster.long(), first[einst] + pos):
            raise ValueError("sweep entries are not grouped by instance")
        idx = einst[:, None].expand(-1, 3)
        lo = torch.full((n_inst, 3), _INF, device=einst.device).scatter_reduce(
            0, idx, self.wboxes[:, 0:3], "amin")
        hi = torch.full((n_inst, 3), -_INF, device=einst.device).scatter_reduce(
            0, idx, self.wboxes[:, 3:6], "amax")
        object.__setattr__(self, "ibox", torch.cat(
            [lo, hi, torch.zeros((n_inst, 2), device=einst.device)], dim=1))
        object.__setattr__(self, "irange", torch.stack(
            [first, count], dim=1).to(torch.int32))

    @property
    def n_instances(self) -> int:
        return self.w2o.shape[0]


def _affine_rows(m):
    m = np.asarray(m, np.float64)
    return np.ascontiguousarray(m[:3, :4]).reshape(12).astype(np.float32)


def _cluster_pack(tri_verts, order):
    """Pack Morton-ordered triangles into (c, 128) component planes +
    cluster AABBs (the reference's numpy code)."""
    v = np.asarray(tri_verts, np.float32)[order]
    t = v.shape[0]
    c = -(-t // _CLUSTER)
    p = c * _CLUSTER
    vp = np.full((p, 3, 3), 1e30, np.float32)
    vp[:t] = v
    pid = np.full((p,), -1, np.int64)
    pid[:t] = order
    vp4 = vp.reshape(c, _CLUSTER, 3, 3)
    real = (pid.reshape(c, _CLUSTER) >= 0)[..., None, None]
    lo = np.where(real, vp4, np.inf).min(axis=(1, 2)).astype(np.float32)
    hi = np.where(real, vp4, -np.inf).max(axis=(1, 2)).astype(np.float32)
    deg = ~np.isfinite(lo[:, 0])
    lo[deg] = 2e30
    hi[deg] = 2e30
    e1 = vp4[:, :, 1] - vp4[:, :, 0]
    e2 = vp4[:, :, 2] - vp4[:, :, 0]
    return {
        "v0": vp4[:, :, 0], "e1": e1, "e2": e2,
        "pid": pid.reshape(c, _CLUSTER),
        "lo": lo, "hi": hi, "n_clusters": c,
    }


def build_sweep(tri_verts, proto_ranges=None, instances=None) -> SweepAccel:
    """Build the sweep tables (the reference's numpy code).

    tri_verts: (T, 3, 3), all unique triangles, prototypes concatenated
        (object space for instanced prototypes, world space otherwise);
        prim ids index this array.
    proto_ranges: (start, count) triangle ranges, one per prototype; None
        is one prototype of everything.
    instances: None (one identity instance of prototype 0), or
        (proto_id (I,) int, obj_to_world (I, 4, 4)).
    """
    from ..accel.bvh import morton_order

    tri_verts = np.asarray(tri_verts, np.float32)
    t_all = tri_verts.shape[0]
    if t_all >= 1 << 24:
        raise ValueError(f"{t_all} triangles: float ids are exact below 2^24")
    if proto_ranges is None:
        proto_ranges = [(0, t_all)]

    planes = {k: [] for k in ("v0", "e1", "e2", "pid")}
    boxes_lo, boxes_hi = [], []
    proto_cranges = []
    cbase = 0
    for start, count in proto_ranges:
        sub = tri_verts[start:start + count]
        order = morton_order(sub.mean(axis=1)) + start
        packed = _cluster_pack(tri_verts, order)
        for k in planes:
            planes[k].append(packed[k])
        boxes_lo.append(packed["lo"])
        boxes_hi.append(packed["hi"])
        proto_cranges.append((cbase, packed["n_clusters"]))
        cbase += packed["n_clusters"]
    v0, e1, e2, pid = (np.concatenate(planes[k])
                       for k in ("v0", "e1", "e2", "pid"))
    lo = np.concatenate(boxes_lo)
    hi = np.concatenate(boxes_hi)
    c_tot = v0.shape[0]
    boxes = np.concatenate([lo, hi, np.zeros((c_tot, 2), np.float32)], axis=1)

    if instances is None:
        proto_id = np.zeros((1,), np.int32)
        o2w = np.tile(np.eye(4, dtype=np.float32), (1, 1, 1))
    else:
        proto_id, o2w = instances
        proto_id = np.asarray(proto_id, np.int32)
        o2w = np.asarray(o2w, np.float32)
    n_inst = proto_id.shape[0]
    instanced = instances is not None

    # Entries: (instance, cluster of its prototype) pairs with world AABBs
    # (the 8 object-box corners transformed).
    ecluster, einst, wlo, whi = [], [], [], []
    for i in range(n_inst):
        cs, cc = proto_cranges[proto_id[i]]
        ecluster.append(np.arange(cs, cs + cc, dtype=np.int32))
        einst.append(np.full((cc,), i, np.int32))
        l, h = lo[cs:cs + cc], hi[cs:cs + cc]
        if instanced:
            m = o2w[i]
            corners = np.stack(
                [
                    np.stack(
                        [
                            np.where(np.array([cx, cy, cz], bool), h, l)[:, k]
                            for k in range(3)
                        ],
                        axis=1,
                    )
                    for cx in (0, 1) for cy in (0, 1) for cz in (0, 1)
                ],
                axis=1,
            )  # (cc, 8, 3)
            wc = corners @ m[:3, :3].T + m[:3, 3]
            wlo.append(wc.min(axis=1).astype(np.float32))
            whi.append(wc.max(axis=1).astype(np.float32))
        else:
            wlo.append(l)
            whi.append(h)
    ecluster = np.concatenate(ecluster)
    einst = np.concatenate(einst)
    wlo = np.concatenate(wlo)
    whi = np.concatenate(whi)
    n_e = ecluster.shape[0]
    wboxes = np.concatenate([wlo, whi, np.zeros((n_e, 2), np.float32)], axis=1)
    w2o_rows = np.stack(
        [_affine_rows(np.linalg.inv(o2w[i].astype(np.float64)))
         for i in range(n_inst)]
    )
    o2w_rows = np.stack([_affine_rows(o2w[i]) for i in range(n_inst)])

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype))

    return SweepAccel(
        v0x=t(v0[..., 0]), v0y=t(v0[..., 1]), v0z=t(v0[..., 2]),
        e1x=t(e1[..., 0]), e1y=t(e1[..., 1]), e1z=t(e1[..., 2]),
        e2x=t(e2[..., 0]), e2y=t(e2[..., 1]), e2z=t(e2[..., 2]),
        pid=t(pid + 1), boxes=t(boxes), wboxes=t(wboxes),
        ecluster=t(ecluster, np.int32), einst=t(einst, np.int32),
        w2o=t(w2o_rows), o2w=t(o2w_rows),
        n_clusters=c_tot, n_entries=n_e, instanced=instanced,
    )


def _box_rows(boxes):
    """(n, 8) box rows -> six (1, n) rows lox..hiz for a slab matrix."""
    return [boxes[:, j][None, :] for j in range(6)]


def sweep_intersect_ref(accel: SweepAccel, o, d, tmax, any_hit: bool = False,
                        counts: dict | None = None):
    """Plain PyTorch twin of K3: the instances and their clusters in order,
    each cluster's Moller-Trumbore test vectorised over the rays whose own
    gates pass, (k rays x 128 triangles).

    Within an instance a ray's t_best only falls, so a cluster whose slab
    test no ray passes at instance entry is passed by none later: a slab
    matrix over (rays, clusters) at instance entry picks the clusters to
    walk. Its cost follows the passing pairs; `counts`, when given,
    accumulates the (ray, cluster) pairs under "pairs" and the (ray,
    instance) entries under "instances" (the kernel's work, for its
    bound)."""
    n = o.shape[0]
    dev = o.device
    ox, oy, oz = (o[:, i].contiguous() for i in range(3))
    dx, dy, dz = (d[:, i].contiguous() for i in range(3))
    wix, wiy, wiz = inv_dir(dx), inv_dir(dy), inv_dir(dz)
    t_best = tmax.clone()
    prim_f = torch.zeros((n,), dtype=torch.float32, device=dev)
    inst_f = torch.zeros((n,), dtype=torch.float32, device=dev)
    ibox = accel.ibox.detach().cpu().tolist()
    irange = accel.irange.detach().cpu().tolist()
    w2o = accel.w2o.detach().cpu().tolist()
    box_list = accel.boxes.detach().cpu().tolist()
    tri = {k: getattr(accel, k) for k in _TRI_KEYS}
    pairs = entered = 0
    for i in range(accel.n_instances):
        live_i = slab(ibox[i], ox, oy, oz, wix, wiy, wiz, t_best)
        idx_i = torch.nonzero(live_i).squeeze(1)
        k_i = idx_i.numel()
        cs, cc = irange[i]
        if k_i == 0 or cc == 0:
            continue
        entered += k_i
        wo = [x[idx_i] for x in (ox, oy, oz, dx, dy, dz)]
        if accel.instanced:
            a = w2o[i]
            lo = [a[4 * r] * wo[0] + a[4 * r + 1] * wo[1] + a[4 * r + 2] * wo[2]
                  + a[4 * r + 3] for r in range(3)]
            ld = [a[4 * r] * wo[3] + a[4 * r + 1] * wo[4] + a[4 * r + 2] * wo[5]
                  for r in range(3)]
        else:
            lo, ld = wo[:3], wo[3:]
        ray_i = [*lo, *(inv_dir(x) for x in ld)]
        # Clusters some ray passes at instance entry, in order.
        rows = _box_rows(accel.boxes[cs:cs + cc])
        need = torch.zeros((cc,), dtype=torch.bool, device=dev)
        step = max(1, _PREFILTER_CHUNK // cc)
        for j in range(0, k_i, step):
            cols = [x[j:j + step, None] for x in ray_i]
            tb = t_best[idx_i[j:j + step], None]
            need |= torch.any(slab(rows, *cols, tb), dim=0)
        for c in (torch.nonzero(need).squeeze(1) + cs).tolist():
            live_c = slab(box_list[c], *ray_i, t_best[idx_i])
            sel = torch.nonzero(live_c).squeeze(1)
            k = sel.numel()
            if k == 0:
                continue
            pairs += k
            idx = idx_i[sel]
            rox, roy, roz, rdx, rdy, rdz = (
                x[sel][:, None] for x in (*lo, *ld))
            tb = t_best[idx]
            hit, tk, _, _, pid = mt_rows(tri, c, rox, roy, roz, rdx, rdy, rdz,
                                         tb)
            if any_hit:
                got = torch.any(hit, dim=1)
                pid_max = torch.amax(torch.where(hit, pid, 0.0), dim=1)
                t_best[idx] = torch.where(got, 0.0, tb)
                prim_f[idx] = torch.where(got, pid_max, prim_f[idx])
                inst_f[idx] = torch.where(got, float(i + 1), inst_f[idx])
                continue
            tmin, _, pid_sel = closest_of_rows(hit, tk, pid)
            better = tmin < tb
            t_best[idx] = torch.where(better, tmin, tb)
            prim_f[idx] = torch.where(better, pid_sel, prim_f[idx])
            inst_f[idx] = torch.where(better, float(i + 1), inst_f[idx])
    if counts is not None:
        counts["pairs"] = counts.get("pairs", 0) + pairs
        counts["instances"] = counts.get("instances", 0) + entered
    miss = prim_f <= 0.0
    return {
        "t": torch.where(miss, _INF, t_best),
        "prim": torch.where(miss, -1, prim_f.to(torch.int32) - 1).to(torch.int32),
        "inst": torch.where(miss, -1, inst_f.to(torch.int32) - 1).to(torch.int32),
    }


STATS = LaunchStats()


def _library():
    from .nvcc_build import load_library

    lib = load_library("sweep")
    if not getattr(lib, "_argtypes_set", False):
        p = ctypes.c_void_p
        lib.sweep_launch.argtypes = (
            [p] * 14 + [ctypes.c_int, ctypes.c_int, p, p, p, ctypes.c_longlong,
                        ctypes.c_int, p, p, p, p]
        )
        lib.sweep_launch.restype = ctypes.c_int
        lib.sweep_error_string.argtypes = [ctypes.c_int]
        lib.sweep_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(name, x, shape, dtype, device):
    if x.dtype != dtype or tuple(x.shape) != shape or x.device != device:
        raise ValueError(
            f"sweep_intersect: {name} must be {dtype} {shape} on {device}, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"sweep_intersect: {name} must be contiguous")


def _launch(accel: SweepAccel, o, d, tmax, any_hit: bool):
    """Run K3 on the rays' CUDA device; raises on any build/launch error."""
    n = o.shape[0]
    dev = o.device
    c, n_inst = accel.n_clusters, accel.n_instances
    tables = [getattr(accel, k) for k in _TRI_KEYS]
    for key, x in zip(_TRI_KEYS, tables):
        _check(key, x, (c, _CLUSTER), torch.float32, dev)
    _check("boxes", accel.boxes, (c, 8), torch.float32, dev)
    _check("ibox", accel.ibox, (n_inst, 8), torch.float32, dev)
    _check("irange", accel.irange, (n_inst, 2), torch.int32, dev)
    _check("w2o", accel.w2o, (n_inst, 12), torch.float32, dev)
    _check("o", o, (n, 3), torch.float32, dev)
    _check("d", d, (n, 3), torch.float32, dev)
    _check("tmax", tmax, (n,), torch.float32, dev)
    lib = _library()
    out = {
        "t": torch.empty((n,), dtype=torch.float32, device=dev),
        "prim": torch.empty((n,), dtype=torch.int32, device=dev),
        "inst": torch.empty((n,), dtype=torch.int32, device=dev),
    }
    if n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        events = None
        if STATS.events is not None:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(stream)
        err = lib.sweep_launch(
            accel.boxes.data_ptr(), accel.ibox.data_ptr(),
            accel.irange.data_ptr(), accel.w2o.data_ptr(),
            *(x.data_ptr() for x in tables), n_inst, int(accel.instanced),
            o.data_ptr(), d.data_ptr(), tmax.data_ptr(), n, int(any_hit),
            out["t"].data_ptr(), out["prim"].data_ptr(), out["inst"].data_ptr(),
            stream.cuda_stream,
        )
        if err != 0:
            raise RuntimeError(
                "sweep kernel launch failed: "
                + lib.sweep_error_string(err).decode()
            )
        STATS.launches += 1
        if events is not None:
            events[1].record(stream)
            STATS.events.append(events)
    return out


def _sweep_intersect_impl(accel: SweepAccel, o, d, tmax, any_hit: bool = False):
    """Closest or any hit of N rays against the sweep accelerator."""
    if o.device.type == "cpu":
        return sweep_intersect_ref(accel, o, d, tmax, any_hit=any_hit)
    if o.device.type == "cuda":
        return _launch(accel, o, d, tmax, any_hit)
    raise ValueError(f"sweep_intersect: unsupported device {o.device}")


# Geometry detached under autograd (ops/detach.py).
sweep_intersect = detached_query(_sweep_intersect_impl)
