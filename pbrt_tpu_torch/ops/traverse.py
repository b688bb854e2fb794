"""K4: closest / any-hit queries over the implicit-heap BVH.

Port of pbrt_tpu/ops/traverse.py, whose Pallas kernel states its contract
as that of pbrt_tpu/accel/bvh.py::bvh_intersect. The Hopper kernel is
`pbrt_tpu_torch/csrc/traverse.cu`, one thread and one (node, tmin) stack
per ray, which culls children when it pushes them and reads the packed
rows `BVH.nodes` and `BVH.tris`;
`accel/bvh.py::bvh_intersect_ref` is its plain PyTorch twin, with the
kernel's operation order, so the two agree bit for bit (the traversal
rules are stated there).

Dispatch is by the device of the rays: CPU tensors take the twin; CUDA
tensors launch the kernel, and a failed build or launch raises. Nothing
falls back and nothing moves to another device.

Output: (t, prim, u, v) as in the reference: t is t_best (tmax on a miss),
prim int32 (-1 on a miss), u, v float32 (0 on a miss). In any-hit mode
only prim >= 0 is the result; t, u and v are those of the hit that ended
the walk.
"""

from __future__ import annotations

import ctypes

import torch

from ..accel.bvh import BVH, bvh_intersect_ref
from .detach import detached_query
from .smallscene import LaunchStats

STATS = LaunchStats()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a built traverse.cu library (once)."""
    if getattr(lib, "_argtypes_set", False):
        return lib
    p = ctypes.c_void_p
    lib.traverse_launch.argtypes = (
        [p] * 2 + [ctypes.c_int, ctypes.c_int, p, p, p, ctypes.c_longlong,
                   ctypes.c_int] + [p] * 4 + [p]
    )
    lib.traverse_launch.restype = ctypes.c_int
    lib.traverse_constants.argtypes = [ctypes.c_int, p]
    lib.traverse_constants.restype = None
    lib.traverse_error_string.argtypes = [ctypes.c_int]
    lib.traverse_error_string.restype = ctypes.c_char_p
    lib._argtypes_set = True
    return lib


def _library():
    from .nvcc_build import load_library

    return bind(load_library("traverse"))


def _check(name, x, shape, dtype, device, align: int = 4):
    if x is None:
        raise ValueError(f"bvh_intersect: the BVH has no {name} table")
    if x.dtype != dtype or tuple(x.shape) != shape or x.device != device:
        raise ValueError(
            f"bvh_intersect: {name} must be {dtype} {shape} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"bvh_intersect: {name} must be contiguous")
    if x.data_ptr() % align:
        raise ValueError(f"bvh_intersect: {name} must be {align}-B aligned")


def constants(depth: int, lib: ctypes.CDLL | None = None) -> dict:
    """The design constants of the built K4 (or of `lib`, another build of
    traverse.cu) and the stack entries of a launch on a tree of `depth`."""
    lib = bind(lib) if lib is not None else _library()
    keys = ("threads", "max_depth", "stack_entries")
    out = (ctypes.c_longlong * len(keys))()
    lib.traverse_constants(depth, out)
    return dict(zip(keys, out))


def _launch(bvh: BVH, o, d, tmax, any_hit: bool,
            lib: ctypes.CDLL | None = None):
    """Run K4 (or `lib`, another build of traverse.cu) on the rays' CUDA
    device; raises on any build/launch error."""
    n = o.shape[0]
    dev = o.device
    n_nodes = (2 << bvh.depth) - 1
    n_slots = (1 << bvh.depth) * bvh.leaf_size
    # The packed rows BVH derives once (never packed per launch), read as
    # float4.
    _check("nodes", bvh.nodes, (n_nodes, 8), torch.float32, dev, align=16)
    _check("tris", bvh.tris, (n_slots, 12), torch.float32, dev, align=16)
    _check("o", o, (n, 3), torch.float32, dev)
    _check("d", d, (n, 3), torch.float32, dev)
    _check("tmax", tmax, (n,), torch.float32, dev)
    lib = bind(lib) if lib is not None else _library()
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return t, prim, u, v
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        events = None
        if STATS.events is not None:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(stream)
        err = lib.traverse_launch(
            bvh.nodes.data_ptr(), bvh.tris.data_ptr(), bvh.depth,
            bvh.leaf_size,
            o.data_ptr(), d.data_ptr(), tmax.data_ptr(), n, int(any_hit),
            t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
            stream.cuda_stream,
        )
        if err != 0:
            raise RuntimeError(
                "traverse kernel launch failed: "
                + lib.traverse_error_string(err).decode()
            )
        STATS.launches += 1
        if events is not None:
            events[1].record(stream)
            STATS.events.append(events)
    return t, prim, u, v


def _bvh_intersect_impl(bvh: BVH, o, d, tmax, any_hit: bool = False):
    """Closest or any hit of N rays against the BVH."""
    if o.device.type == "cpu":
        return bvh_intersect_ref(bvh, o, d, tmax, any_hit=any_hit)
    if o.device.type == "cuda":
        return _launch(bvh, o, d, tmax, any_hit)
    raise ValueError(f"bvh_intersect: unsupported device {o.device}")


# Geometry detached under autograd (ops/detach.py).
bvh_intersect = detached_query(_bvh_intersect_impl)
