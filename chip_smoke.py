#!/usr/bin/env python3
"""Chip smoke test of pbrt_tpu_torch, the PyTorch + CUDA port, on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from the sources in the checkout,
checks each against its plain PyTorch twin, renders the Cornell box, the
killeroo-class mesh scene and the instanced field (a .pbrt file through the
port's parser) on the card against the committed JAX goldens, and times
the forward render of each at its benchmark configuration. Each phase
prints one JSON line; any failure raises, so the script exits non-zero and
never prints the final line. Without a CUDA device it exits non-zero at
once. It never imports JAX.

Phases:
  a   device: name, nvidia-smi name and power limit, torch/CUDA versions
  b   build: nvcc builds of K1 (csrc/smallscene.cu), K2 (csrc/cluster.cu)
      and K3 (csrc/sweep.cu), started together, with their ptxas summaries
  c   K1 vs its twin on 4,194,304 rays (the Cornell pass's query shape):
      camera rays, random rays inside the box, dead lanes (tmax = 0),
      axis-parallel rays and NEE shadow segments; closest and any-hit
      modes must be bit-equal; kernel and twin times
  c2  K2 vs its twin on the killeroo-class scene (122,244 triangles):
      65,536 rays of each kind the path sends (camera, cosine rays from the
      mesh, axis-parallel, dead lanes, area-light and infinite-light shadow
      rays) in closest, any-hit and non-deferred closest modes, bit-equal;
      K2, its twin, ray_sort_perm and resolve_tri_attrs timed at the main
      path's shape (1,048,576 sorted rays)
  c3  K3 vs its twin on every query of a 32x32, 4 spp pass (camera, four
      bounces and the terminal query in closest mode, five shadow queries
      with the path's dead lanes in any-hit mode), for the instanced field
      (tests/data/torch_port/instanced_field.pbrt: 37 instances, 17,191
      entries) and for with_accel(kind="sweep") on the killeroo-class
      scene, bit-equal; then K3 and its twin at the main path's shape (the
      1,048,576 camera rays of one instanced-field pass and their shadow
      rays), bit-equal key by key, timed
  d   Cornell 32x32, 16 spp, 32 lanes, depth 5 (default Russian roulette)
      against tests/data/torch_port/cornell32_spp16.npy: >= 99% of pixel
      values within rtol 1e-3 / atol 1e-5, and 11 K1 launches per pass
  d2  killeroo-class 64x64, 4 spp, 8 lanes, depth 5 against
      tests/data/torch_port/killeroo64_spp4.npy: the same gate, 11 K2 and
      0 K1 launches per pass
  d3  the instanced field, 64x64, 4 spp, 8 lanes, the file's integrator
      against tests/data/torch_port/instanced64_spp4.npy: the same gate, 11
      K3 and no K1 or K2 launches per pass
  e   timed Cornell forward at its benchmark configuration (256x256, 128
      spp in passes of 64, depth 5, no Russian roulette) at 8 and 32 lanes
  e2  timed killeroo-class forward at its benchmark configuration (512x512,
      8 spp in passes of 4, depth 5, no Russian roulette, 8 lanes): Mrays/s,
      first-pass seconds, peak memory, K2's and the ray sorts' shares
  e3  timed instanced-field forward (the file's 512x512 and 8 spp, in passes
      of 4, depth 5, no Russian roulette, 8 lanes): Mrays/s, peak memory,
      K3's launches and share, and the first image's seconds from the parse
      on (PLY reads, sweep build and upload included)
  f   the kernels line, the nvidia-smi line and the final result line
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port", "cornell32_spp16.npy")
GOLDEN_KILLEROO = os.path.join(ROOT, "tests", "data", "torch_port",
                               "killeroo64_spp4.npy")
K1_SOURCE = "pbrt_tpu_torch/csrc/smallscene.cu"
K1_REPLACES = "pbrt_tpu/ops/smallscene.py:73"
K2_SOURCE = "pbrt_tpu_torch/csrc/cluster.cu"
K2_REPLACES = "pbrt_tpu/ops/cluster.py:177"
K3_SOURCE = "pbrt_tpu_torch/csrc/sweep.cu"
K3_REPLACES = "pbrt_tpu/ops/sweep.py:308"
GOLDEN_INSTANCED = os.path.join(ROOT, "tests", "data", "torch_port",
                                "instanced64_spp4.npy")
MAIN_PATH_RAYS = 256 * 256 * 64  # one forward pass of the bench config
# The killeroo and instanced-field passes: 512x512 at 4 samples per pixel.
PASS_RES, PASS_SPP = 512, 4
PASS_RAYS = PASS_RES * PASS_RES * PASS_SPP
K2_SAMPLE = 65536  # rays of each kind held against the twin

# The card's limits for the kernels' bounds (NVIDIA's data sheet, H100 SXM
# at 700 W): 3.35 TB/s of HBM, and 67 TFLOP/s of FP32 outside the tensor
# cores, which counts an FMA as two operations, so 33.5e12 of the kernels'
# separate (un-fused) FP32 operations per second.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12
# FP32 operations of one Moller-Trumbore ray/triangle test as K1 and K2
# write it: 9 (p = d x e2) + 5 (det) + 1 (|det| > eps) + 1 (1/det) + 3 (tv)
# + 6 (u) + 9 (q = tv x e1) + 6 (v) + 6 (t) + 7 (the hit and best-t
# comparisons, with u + v).
MT_OPS = 53


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls (after a warm-up)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got: dict, want: dict) -> float:
    """Largest absolute difference of a kernel's float outputs (t where the
    twin's is finite; u, v, n where present) from its twin's."""
    import torch

    finite = torch.isfinite(want["t"])
    err = (float(torch.abs(got["t"][finite] - want["t"][finite]).max())
           if bool(finite.any()) else 0.0)
    for k in ("u", "v", "n"):
        if k in want:
            err = max(err, float(torch.max(torch.abs(got[k] - want[k]))))
    return err


def phase_device():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit("a_device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return smi


def phase_build():
    """Build every kernel source, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from pbrt_tpu_torch.ops import nvcc_build

    names = ("smallscene", "cluster", "sweep")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(nvcc_build.load_library, names))
    wall = time.perf_counter() - t0
    result = {}
    for name in names:
        seconds, log = nvcc_build.BUILD_LOG.get(name, (0.0, ""))
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "Used" in ln or "spill" in ln]
        result[name] = {"seconds": seconds, "ptxas": ptxas, "cached": not log}
    emit("b_build", wall_seconds=wall, **result)
    return result


def _k1_rays(scene, camera, dev):
    """4,194,304 rays of the kinds the forward pass sends to K1."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.accel.dense import shadow_segment
    from pbrt_tpu_torch.ops.smallscene import smallscene_intersect_ref
    from pbrt_tpu_torch.render import camera_rays_full

    rng = np.random.default_rng(0)
    nx, ny = camera.resolution
    n_cam = nx * ny
    n_axis = 65536
    n_rand = (MAIN_PATH_RAYS - n_cam - n_axis) // 2
    n_shadow = MAIN_PATH_RAYS - n_cam - n_axis - n_rand

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    pixel = torch.arange(n_cam, device=dev)
    o_cam, d_cam, _, _ = camera_rays_full(camera, pixel, 0, 0)
    o_rand = t(rng.uniform(0.02, 0.98, (n_rand, 3)))
    d_rand = t(rng.normal(size=(n_rand, 3)))
    d_rand = d_rand / torch.linalg.norm(d_rand, dim=-1, keepdim=True)
    axes = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n_axis)]
    d_axis = t(axes * rng.choice([-1.0, 1.0], (n_axis, 1)))
    o_axis = t(rng.uniform(0.02, 0.98, (n_axis, 3)))
    # Shadow segments: hit points of the random rays (from the twin) to
    # light samples, offset and re-aimed as the integrator does.
    hits = smallscene_intersect_ref(
        scene.small, o_rand[:n_shadow], d_rand[:n_shadow],
        torch.full((n_shadow,), float("inf"), device=dev),
    )
    p = torch.where(
        (hits["prim"] >= 0)[:, None],
        o_rand[:n_shadow] + hits["t"][:, None] * d_rand[:n_shadow], 0.5,
    )
    lam = torch.full((n_shadow, 1), 550.0, device=dev)
    ls = scene.lights.sample_li(
        p, lam, t(rng.uniform(0, 1, n_shadow)), t(rng.uniform(0, 1, (n_shadow, 2)))
    )
    so, wi_sh, smax = shadow_segment(p, hits["n"], ls.wi, ls.dist)
    o = torch.cat([o_cam, o_rand, o_axis, so]).contiguous()
    d = torch.cat([d_cam, d_rand, d_axis, wi_sh]).contiguous()
    tmax = torch.cat([
        torch.full((n_cam + n_rand + n_axis,), float("inf"), device=dev), smax,
    ])
    tmax[n_cam::5] = 0.0  # dead lanes, as the integrator masks them
    return o, d, tmax.contiguous()


def phase_kernel_vs_twin(dev):
    import torch

    from pbrt_tpu_torch.ops.smallscene import (
        STATS, smallscene_intersect, smallscene_intersect_ref,
    )
    from pbrt_tpu_torch.scenes.cornell import cornell_box

    scene, camera = cornell_box(resolution=(256, 256))
    scene = scene.with_accel().to(dev)
    camera = camera.to(dev)
    o, d, tmax = _k1_rays(scene, camera, dev)
    result = {}
    for any_hit in (False, True):
        got = smallscene_intersect(scene.small, o, d, tmax, any_hit=any_hit)
        want = smallscene_intersect_ref(scene.small, o, d, tmax, any_hit=any_hit)
        torch.cuda.synchronize()
        mode = "any_hit" if any_hit else "closest"
        diff = {k: int((got[k] != want[k]).sum()) for k in want}
        err = max_abs_err(got, want)
        if any(diff.values()):
            raise AssertionError(f"K1 {mode} differs from its twin: {diff}")
        result[mode] = {"rays": int(o.shape[0]), "hits": int((want["prim"] >= 0).sum()),
                        "mismatches": diff, "max_abs_err": err}
    STATS.reset()
    ms = cuda_ms(lambda: smallscene_intersect(scene.small, o, d, tmax), reps=20)
    ms_any = cuda_ms(
        lambda: smallscene_intersect(scene.small, o, d, tmax, any_hit=True), reps=20
    )
    plain_ms = cuda_ms(lambda: smallscene_intersect_ref(scene.small, o, d, tmax), reps=3)
    STATS.reset()
    # Bound of the timed closest call: every ray tests every row (K1 has
    # no culling); 28 B of ray in, 36 B of hit out, the table once.
    n, rows = int(o.shape[0]), scene.small.n_tris
    bound = _bound(n * rows * MT_OPS, n * (28 + 36) + rows * 64)
    emit("c_kernel_vs_twin", **result, ms_closest=ms, ms_any_hit=ms_any,
         plain_ms_closest=plain_ms, tests=n * rows, **bound)
    err = max(r["max_abs_err"] for r in result.values())
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound}


def _bound(ops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the FP32 rate and the bytes over the HBM rate."""
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms}


def killeroo_on(dev):
    """The killeroo-class scene (clusters attached) and its 512x512 camera
    on the card: (scene, camera, build seconds)."""
    from pbrt_tpu_torch.scenes.meshes import killeroo_class_scene

    t0 = time.perf_counter()
    scene, camera = killeroo_class_scene(resolution=(PASS_RES, PASS_RES))
    scene, camera = scene.to(dev), camera.to(dev)
    return scene, camera, time.perf_counter() - t0


def _k2_ray_kinds(scene, camera, dev, n):
    """n rays of each kind the killeroo path sends to K2, as (o, d, tmax)."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.accel.dense import offset_ray_origin, shadow_segment
    from pbrt_tpu_torch.core.sampling import sample_cosine_hemisphere
    from pbrt_tpu_torch.core.vecmath import coordinate_system, from_local
    from pbrt_tpu_torch.render import camera_rays_full

    rng = np.random.default_rng(1)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    inf = torch.full((n,), float("inf"), device=dev)
    kinds = {}
    npix = camera.resolution[0] * camera.resolution[1]
    pixel = t(rng.integers(0, npix, n)).long()
    o_cam, d_cam, _, _ = camera_rays_full(camera, pixel, 0, 0)
    kinds["camera"] = (o_cam, d_cam, inf)

    # Points on the mesh, with their winding normals.
    verts = scene.geom.tri_verts
    tri = t(rng.integers(0, verts.shape[0], n)).long()
    b = t(rng.dirichlet((1.0, 1.0, 1.0), n))
    tv = verts[tri]
    p = (b[:, 0:1] * tv[:, 0] + b[:, 1:2] * tv[:, 1] + b[:, 2:3] * tv[:, 2])
    ng = torch.linalg.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    ng = ng / torch.linalg.norm(ng, dim=-1, keepdim=True)
    side = t(rng.choice([-1.0, 1.0], (n, 1)))
    ns = ng * side
    t1, t2 = coordinate_system(ns)
    wi = from_local(sample_cosine_hemisphere(t(rng.uniform(0, 1, (n, 2)))),
                    t1, t2, ns)
    kinds["cosine"] = (offset_ray_origin(p, ng, wi), wi, inf)

    lo = torch.amin(verts.reshape(-1, 3), dim=0)
    hi = torch.amax(verts.reshape(-1, 3), dim=0)
    o_box = lo + (hi - lo) * t(rng.uniform(0, 1, (n, 3)))
    axes = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    kinds["axis"] = (o_box, t(axes * rng.choice([-1.0, 1.0], (n, 1))), inf)

    d_dead = t(rng.normal(size=(n, 3)))
    d_dead = d_dead / torch.linalg.norm(d_dead, dim=-1, keepdim=True)
    kinds["dead"] = (o_box.flip(0).contiguous(), d_dead, torch.zeros_like(inf))

    # NEE shadow segments from the mesh points: light selection is
    # uniform over [area, area, infinite], so u < 0.66 picks an area
    # triangle and u > 0.67 the infinite light.
    lam = torch.full((n, 1), 550.0, device=dev)
    u_pos = t(rng.uniform(0, 1, (n, 2)))
    for name, u_sel in (("shadow_area", rng.uniform(0.0, 0.66, n)),
                        ("shadow_infinite", rng.uniform(0.67, 1.0, n))):
        ls = scene.lights.sample_li(p, lam, t(u_sel), u_pos)
        so, wi_sh, smax = shadow_segment(p, ng, ls.wi, ls.dist)
        kinds[name] = (so, wi_sh, smax)
    # dist = inf rides through shadow_segment as a 1e30 segment.
    assert bool((kinds["shadow_infinite"][2] == 1e30).all())
    assert bool(torch.isfinite(kinds["shadow_area"][2]).all())
    return {k: tuple(x.contiguous() for x in v) for k, v in kinds.items()}


def phase_k2_vs_twin(dev, killeroo):
    """K2 against its twin on every ray kind, then timed at the main path's
    shape (1,048,576 sorted rays)."""
    import torch

    from pbrt_tpu_torch.accel.api import ray_sort_perm
    from pbrt_tpu_torch.ops.cluster import (
        cluster_intersect, cluster_intersect_ref,
    )

    scene, camera, build_s = killeroo
    acc = scene.clusters
    kinds = _k2_ray_kinds(scene, camera, dev, K2_SAMPLE)
    names = list(kinds)
    o = torch.cat([kinds[k][0] for k in names])
    d = torch.cat([kinds[k][1] for k in names])
    tmax = torch.cat([kinds[k][2] for k in names])
    perm, inv = ray_sort_perm(o, d, tmax)
    o, d, tmax = o[perm], d[perm], tmax[perm]
    kind_of = torch.arange(len(names), device=dev).repeat_interleave(
        K2_SAMPLE)[perm]
    modes = {"closest": dict(any_hit=False),
             "any_hit": dict(any_hit=True),
             "closest_attrs": dict(any_hit=False, defer_attrs=False)}
    result, err = {}, 0.0
    for mode, kw in modes.items():
        got = cluster_intersect(acc, o, d, tmax, **kw)
        torch.cuda.synchronize()
        counts = {}
        t0 = time.perf_counter()
        want = cluster_intersect_ref(acc, o, d, tmax, counts=counts, **kw)
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t0
        if set(got) != set(want):
            raise AssertionError(f"K2 {mode}: keys {set(got)} vs {set(want)}")
        per_kind = {}
        for i, name in enumerate(names):
            sel = kind_of == i
            per_kind[name] = {
                "mismatches": {k: int((got[k][sel] != want[k][sel]).sum())
                               for k in want},
                "hits": int((want["prim"][sel] >= 0).sum()),
            }
        bad = {n: pk["mismatches"] for n, pk in per_kind.items()
               if any(pk["mismatches"].values())}
        err = max(err, max_abs_err(got, want))
        result[mode] = {"rays": int(o.shape[0]), "per_kind": per_kind,
                        "twin_seconds": twin_s, "pairs": counts["pairs"]}
        if bad:
            raise AssertionError(f"K2 {mode} differs from its twin: {bad}")
    emit("c2_k2_vs_twin", scene_build_seconds=build_s,
         n_clusters=acc.n_clusters, n_supers=acc.n_supers, max_abs_err=err,
         **result)
    return _k2_timed(scene, camera, dev)


def _pass_batches(scene, camera, dev):
    """The query batches of one 512x512, 4 spp pass at the main path's
    shape: its 1,048,576 camera rays (closest) and their NEE shadow rays
    (any-hit, with the path's dead lanes: origin 1e8, tmax 0), each sorted
    as the path sorts them. Returns ({mode: (o, d, tmax)}, the unsorted
    camera (o, d, tmax), the camera rays' hit prims)."""
    import torch

    from pbrt_tpu_torch.accel.api import closest, ray_sort_perm
    from pbrt_tpu_torch.accel.dense import shadow_segment
    from pbrt_tpu_torch.render import camera_rays_full

    n = PASS_RAYS
    npix = PASS_RES * PASS_RES
    pixel = torch.arange(npix, device=dev).repeat(PASS_SPP)
    sample = torch.arange(PASS_SPP, device=dev).repeat_interleave(npix)
    o, d, _, _ = camera_rays_full(camera, pixel, sample, 0)
    tmax = torch.full((n,), float("inf"), device=dev)
    perm, _ = ray_sort_perm(o, d, tmax)
    rays = {"closest": (o[perm], d[perm], tmax[perm])}
    isect = closest(scene, o, d, tmax)
    gen = torch.Generator(device=dev).manual_seed(0)
    ls = scene.lights.sample_li(
        isect.p, torch.full((n, 1), 550.0, device=dev),
        torch.rand(n, device=dev, generator=gen),
        torch.rand((n, 2), device=dev, generator=gen),
    )
    so, wi, smax = shadow_segment(isect.p, isect.n, ls.wi, ls.dist)
    smax = torch.where(isect.valid, smax, 0.0)  # dead lanes, as the path sends
    so = torch.where(isect.valid[:, None], so, 1e8)
    perm_s, _ = ray_sort_perm(so, wi, smax)
    rays["any_hit"] = (so[perm_s], wi[perm_s], smax[perm_s])
    return rays, (o, d, tmax), isect.prim


def _timed_vs_twin(name, module, acc, rays, cost) -> dict:
    """Time the kernel of `module` (its intersect function is `name`) and
    its twin on each batch of `rays`; the kernel must equal the twin on
    every output. cost(counts) gives the batch's (operations, bytes) from
    the twin's work counts, for the bound."""
    import torch

    intersect = getattr(module, name)
    intersect_ref = getattr(module, name + "_ref")
    out = {}
    for mode, (ro, rd, rt) in rays.items():
        any_hit = mode == "any_hit"
        module.STATS.reset()
        ms = cuda_ms(lambda: intersect(acc, ro, rd, rt, any_hit=any_hit),
                     reps=10)
        got = intersect(acc, ro, rd, rt, any_hit=any_hit)
        counts = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = intersect_ref(acc, ro, rd, rt, any_hit=any_hit, counts=counts)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        if set(got) != set(want) or bad:
            raise AssertionError(f"{name} {mode} at {ro.shape[0]} rays differs "
                                 f"from its twin in "
                                 f"{bad or sorted(set(got) ^ set(want))}")
        ops, nbytes = cost(counts)
        out[mode] = {"ms": ms, "plain_ms": plain_ms, **counts,
                     "tests": counts["pairs"] * 128,
                     "hits": int((want["prim"] >= 0).sum()),
                     "live": int((rt > 0).sum()), "mismatched_keys": bad,
                     "max_abs_err": max_abs_err(got, want),
                     **_bound(ops, nbytes)}
    module.STATS.reset()
    return out


def _k2_timed(scene, camera, dev):
    """K2, its twin, ray_sort_perm and resolve_tri_attrs at the main path's
    shape (_pass_batches)."""
    from pbrt_tpu_torch.accel.api import ray_sort_perm, resolve_tri_attrs
    from pbrt_tpu_torch.ops import cluster

    acc = scene.clusters
    rays, (o, d, tmax), prim = _pass_batches(scene, camera, dev)
    out = {"rays": PASS_RAYS,
           "ray_sort_perm_ms": cuda_ms(lambda: ray_sort_perm(o, d, tmax), reps=10),
           "resolve_tri_attrs_ms": cuda_ms(
               lambda: resolve_tri_attrs(scene.geom, o, d, prim), reps=10)}

    def cost(counts):
        # 128 triangle tests per (ray, cluster) pair left after per-ray
        # culling; 28 B of ray in, 8 B of (t, prim) out, and the ten
        # triangle planes and the boxes read once.
        return (counts["pairs"] * 128 * MT_OPS,
                PASS_RAYS * (28 + 8) + acc.n_clusters * 128 * 10 * 4
                + (acc.n_clusters + acc.n_supers) * 32)

    out.update(_timed_vs_twin("cluster_intersect", cluster, acc, rays, cost))
    emit("c2_k2_timed", **out)
    return out


# FP32 operations of K3's world-to-object move per (ray, entered instance):
# the origin's 9 multiplies and 9 adds (the direction's 15 operations are
# left out, so the bound stays a lower bound).
XFORM_OPS = 18
K3_SAMPLE_RES = 32  # the pass whose every K3 query is held against the twin


def field_on(dev):
    """The instanced field on the card: its PLY prototypes written into a
    temporary directory, then the file parsed there by the port's parser.
    Returns (scene, camera, settings, mesh seconds, load seconds)."""
    import tempfile

    import torch

    from pbrt_tpu_torch.io.parser import load_pbrt_string
    from tests.torch_port_instanced import field_text, write_field_meshes

    with tempfile.TemporaryDirectory(prefix="instanced_field_") as tmp:
        t0 = time.perf_counter()
        write_field_meshes("pbrt_tpu_torch", tmp)
        t1 = time.perf_counter()
        scene, camera, settings = load_pbrt_string(field_text(), tmp,
                                                   device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return scene, camera, settings, t1 - t0, t2 - t1


def _k3_queries(scene, camera, res: int, k: int):
    """Every K3 query of one res x res, k spp forward pass (8 lanes), as the
    path sends it: sorted rays, tmax and mode, in the order sent (camera,
    then per bounce a shadow and a bounce query, then the terminal one)."""
    from pbrt_tpu_torch.accel import api

    queries = []
    launch = api.sweep_intersect

    def capture(acc, o, d, tmax, any_hit=False):
        queries.append((o.clone(), d.clone(), tmax.clone(), any_hit))
        return launch(acc, o, d, tmax, any_hit=any_hit)

    api.sweep_intersect = capture
    try:
        make_pass(scene, camera.replace(resolution=(res, res)), res, k, 8)(0)
    finally:
        api.sweep_intersect = launch
    names, bounce = [], 0
    for _, _, _, any_hit in queries:
        if any_hit:
            bounce += 1
            names.append(f"shadow{bounce}")
        else:
            names.append("camera" if not names else f"bounce{bounce}")
    names[-1] = "terminal"
    return dict(zip(names, queries))


def phase_k3_vs_twin(dev, field, killeroo):
    """K3 against its twin on every query of a small pass, for the
    instanced field and for the killeroo-class scene under
    with_accel(kind="sweep"); then at the main path's shape."""
    import torch

    from pbrt_tpu_torch.ops.sweep import sweep_intersect, sweep_intersect_ref

    result, err = {}, 0.0
    scenes = {"instanced_field": (field[0], field[1]),
              "killeroo_sweep": (killeroo[0].with_accel(kind="sweep"),
                                 killeroo[1])}
    for label, (scene, camera) in scenes.items():
        acc = scene.sweep
        per_query = {}
        for name, (o, d, tmax, any_hit) in _k3_queries(
                scene, camera, K3_SAMPLE_RES, 4).items():
            got = sweep_intersect(acc, o, d, tmax, any_hit=any_hit)
            counts = {}
            want = sweep_intersect_ref(acc, o, d, tmax, any_hit=any_hit,
                                       counts=counts)
            torch.cuda.synchronize()
            bad = [k for k in want if not torch.equal(got[k], want[k])]
            if set(got) != set(want) or bad:
                raise AssertionError(f"K3 {label} {name} differs from its "
                                     f"twin in {bad}")
            err = max(err, max_abs_err(got, want))
            per_query[name] = {"rays": int(o.shape[0]),
                               "live": int((tmax > 0).sum()),
                               "hits": int((want["prim"] >= 0).sum()),
                               "pairs": counts["pairs"]}
        result[label] = {"instances": acc.n_instances,
                         "entries": acc.n_entries, "queries": per_query}
    emit("c3_k3_vs_twin", max_abs_err=err, **result)
    return _k3_timed(field[0], field[1], dev)


def _k3_timed(scene, camera, dev):
    """K3 and its twin at the main path's shape (_pass_batches) on the
    instanced field."""
    from pbrt_tpu_torch.ops import sweep

    acc = scene.sweep
    rays, _, _ = _pass_batches(scene, camera, dev)

    def cost(counts):
        # 128 triangle tests per (ray, cluster) pair and one move into
        # object space per (ray, instance) entered, after per-ray culling;
        # 28 B of ray in, 12 B of (t, prim, inst) out, and the ten triangle
        # planes, the boxes and the instance rows read once.
        return (counts["pairs"] * 128 * MT_OPS + counts["instances"] * XFORM_OPS,
                PASS_RAYS * (28 + 12) + acc.n_clusters * (128 * 10 * 4 + 32)
                + acc.n_instances * (12 + 8 + 2) * 4)

    out = {"rays": PASS_RAYS,
           **_timed_vs_twin("sweep_intersect", sweep, acc, rays, cost)}
    emit("c3_k3_timed", **out)
    return out


def phase_golden(dev):
    import numpy as np
    import torch

    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.ops.smallscene import STATS
    from pbrt_tpu_torch.render import render
    from pbrt_tpu_torch.scenes.cornell import cornell_box

    golden = np.load(GOLDEN)
    scene, camera = cornell_box(resolution=(32, 32))
    spp, per_pass = 16, 4
    STATS.reset()
    img = render(scene.with_accel(), camera, PathIntegrator(max_depth=5),
                 spp=spp, seed=0, samples_per_pass=per_pass, n_spectrum=32,
                 device=dev)
    torch.cuda.synchronize()
    launches = STATS.launches
    img = img.cpu().numpy()
    if img.shape != golden.shape or not np.all(np.isfinite(img)):
        raise AssertionError(f"bad render: shape {img.shape}, finite "
                             f"{bool(np.all(np.isfinite(img)))}")
    diff = np.abs(img - golden)
    ok = diff <= 1e-5 + 1e-3 * np.abs(golden)
    share = float(np.mean(ok))
    emit("d_golden", share_within=share, outliers=int(np.sum(~ok)),
         largest_abs_diff=sorted(diff.ravel().tolist())[-5:],
         mean=float(img.mean()), golden_mean=float(golden.mean()),
         launches=launches, passes=spp // per_pass)
    if share < 0.99:
        raise AssertionError(f"only {share:.4f} of pixel values match the golden")
    if launches != 11 * (spp // per_pass):
        raise AssertionError(f"{launches} K1 launches for {spp // per_pass} passes")


def phase_golden_killeroo(dev, killeroo):
    import numpy as np
    import torch

    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.ops import cluster, smallscene
    from pbrt_tpu_torch.render import render

    golden = np.load(GOLDEN_KILLEROO)
    scene, camera, _ = killeroo
    spp = per_pass = 4
    smallscene.STATS.reset()
    cluster.STATS.reset()
    img = render(scene, camera.replace(resolution=(64, 64)),
                 PathIntegrator(max_depth=5), spp=spp, seed=0,
                 samples_per_pass=per_pass, n_spectrum=8, device=dev)
    torch.cuda.synchronize()
    k1, k2 = smallscene.STATS.launches, cluster.STATS.launches
    img = img.cpu().numpy()
    if img.shape != golden.shape or not np.all(np.isfinite(img)):
        raise AssertionError(f"bad render: shape {img.shape}, finite "
                             f"{bool(np.all(np.isfinite(img)))}")
    diff = np.abs(img - golden)
    ok = diff <= 1e-5 + 1e-3 * np.abs(golden)
    share = float(np.mean(ok))
    emit("d2_golden_killeroo", share_within=share, outliers=int(np.sum(~ok)),
         values=int(ok.size), largest_abs_diff=sorted(diff.ravel().tolist())[-5:],
         mean=float(img.mean()), golden_mean=float(golden.mean()),
         k2_launches=k2, k1_launches=k1, passes=spp // per_pass)
    if share < 0.99:
        raise AssertionError(f"only {share:.4f} of pixel values match the golden")
    if k2 != 11 * (spp // per_pass) or k1 != 0:
        raise AssertionError(f"{k2} K2 and {k1} K1 launches for "
                             f"{spp // per_pass} passes")


def phase_golden_instanced(dev, field):
    import numpy as np
    import torch

    from pbrt_tpu_torch.ops import cluster, smallscene, sweep
    from pbrt_tpu_torch.render import render

    golden = np.load(GOLDEN_INSTANCED)
    scene, camera, settings = field[:3]
    spp = per_pass = 4
    for counter in (smallscene.STATS, cluster.STATS, sweep.STATS):
        counter.reset()
    img = render(scene, camera.replace(resolution=(64, 64)),
                 settings["integrator"], spp=spp, seed=0,
                 samples_per_pass=per_pass, n_spectrum=8, device=dev)
    torch.cuda.synchronize()
    k1, k2, k3 = (c.STATS.launches for c in (smallscene, cluster, sweep))
    img = img.cpu().numpy()
    if img.shape != golden.shape or not np.all(np.isfinite(img)):
        raise AssertionError(f"bad render: shape {img.shape}, finite "
                             f"{bool(np.all(np.isfinite(img)))}")
    diff = np.abs(img - golden)
    ok = diff <= 1e-5 + 1e-3 * np.abs(golden)
    share = float(np.mean(ok))
    emit("d3_golden_instanced", share_within=share, outliers=int(np.sum(~ok)),
         values=int(ok.size), largest_abs_diff=sorted(diff.ravel().tolist())[-5:],
         mean=float(img.mean()), golden_mean=float(golden.mean()),
         k3_launches=k3, k2_launches=k2, k1_launches=k1,
         passes=spp // per_pass)
    if share < 0.99:
        raise AssertionError(f"only {share:.4f} of pixel values match the golden")
    if k3 != 11 * (spp // per_pass) or k1 or k2:
        raise AssertionError(f"{k3} K3, {k2} K2 and {k1} K1 launches for "
                             f"{spp // per_pass} passes")


def make_pass(scene, camera, res: int, k: int, lanes: int, depth: int = 5):
    """One forward pass at a bench configuration: k samples per pixel over
    res x res, `lanes` wavelengths, depth `depth`, no Russian roulette.
    Returns render_pass(pass_idx) -> (mean RGB image, traced rays)."""
    import torch

    # Module attributes are looked up at each call, so a profiler that
    # wraps them (scripts/profile_torch_pass.py) sees the camera and film.
    from pbrt_tpu_torch import render as render_mod
    from pbrt_tpu_torch.films import rgb as film_mod
    from pbrt_tpu_torch.models.path import PathIntegrator

    dev = scene.geom.tri_verts.device
    integrator = PathIntegrator(max_depth=depth, rr_start_depth=depth)
    npix = res * res
    pixel_b = torch.arange(npix, device=dev).repeat(k)

    def render_pass(pass_idx: int = 0):
        sample_b = torch.arange(
            pass_idx * k, (pass_idx + 1) * k, device=dev
        ).repeat_interleave(npix)
        o, d, wl, _ = render_mod.camera_rays_full(camera, pixel_b, sample_b, 0,
                                                  n_spectrum=lanes)
        radiance, stats = integrator.trace_with_stats(
            scene, o, d, wl, pixel_b, sample_b, 0
        )
        rgb = film_mod.spectrum_to_rgb(radiance, wl)
        return torch.mean(rgb.reshape(k, res, res, 3), dim=0), stats["rays"]

    return render_pass


def timed_forward(render_pass, n_passes: int, stats: dict) -> dict:
    """Time n_passes calls of an already warmed-up render_pass. `stats`
    maps a kernel name to its launch counter, whose launches and CUDA-event
    milliseconds over the timed passes are read back. Raises on a
    non-finite image."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counter in stats.values():
        counter.reset(timed=True)
    t0 = time.perf_counter()
    acc, rays = None, None
    for p in range(n_passes):
        img, r = render_pass(p)
        acc = img if acc is None else acc + img
        rays = r if rays is None else rays + r
    total_rays = float(rays)  # synchronizes
    seconds = time.perf_counter() - t0
    out = {"passes": n_passes, "rays": total_rays, "seconds": seconds,
           "mrays_per_s": total_rays / seconds / 1e6,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "image_mean": float(acc.mean() / n_passes)}
    for name, counter in stats.items():
        ms = counter.elapsed_ms()
        out.update({f"{name}_launches": counter.launches, f"{name}_ms": ms,
                    f"{name}_share": ms / (seconds * 1e3)})
        counter.reset()
    if not bool(torch.isfinite(acc).all()):
        raise AssertionError(f"timed forward: non-finite image, {out}")
    return out


def phase_timed_killeroo(dev, build_seconds: float):
    """The killeroo-class forward render at its benchmark configuration
    (bench.py killeroo_fwd: 512x512, 8 spp in passes of 4, depth 5, no
    Russian roulette, 8 lanes), timed on the card, with the first pass's
    seconds from the scene build on and the ray sorts' share."""
    import torch

    from pbrt_tpu_torch.accel import api
    from pbrt_tpu_torch.ops import cluster, smallscene
    from pbrt_tpu_torch.scenes.meshes import killeroo_class_scene

    res, spp, k, lanes = PASS_RES, 8, PASS_SPP, 8

    # First pass, from the scene build on (Morton sort and cluster build
    # included; the kernel was built in phase b). It is the warm-up.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene, camera = killeroo_class_scene(resolution=(res, res))
    scene, camera = scene.to(dev), camera.to(dev)
    render_pass = make_pass(scene, camera, res, k, lanes)
    render_pass(0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    # Time the ray sorts with CUDA events around each call.
    sort_events = []
    ray_sort_perm = api.ray_sort_perm

    def timed_sort(*args, **kwargs):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = ray_sort_perm(*args, **kwargs)
        ev[1].record()
        sort_events.append(ev)
        return out

    api.ray_sort_perm = timed_sort
    try:
        out = timed_forward(render_pass, spp // k,
                            {"k1": smallscene.STATS, "k2": cluster.STATS})
    finally:
        api.ray_sort_perm = ray_sort_perm
    k1, k2 = out["k1_launches"], out["k2_launches"]
    if k2 == 0 or k1 != 0:
        raise AssertionError(f"timed killeroo: K2 launches={k2} K1 launches={k1}")
    sort_ms = sum(a.elapsed_time(b) for a, b in sort_events)
    emit("e2_timed_killeroo", lanes=lanes, resolution=res, spp=spp,
         samples_per_pass=k, max_depth=5, **out,
         first_pass_seconds=first_s,
         first_pass_with_build_seconds=first_s + build_seconds,
         k2_ms_per_launch=out["k2_ms"] / k2, sorts=len(sort_events),
         sort_ms=sort_ms, sort_share=sort_ms / (out["seconds"] * 1e3))
    return k2


def phase_timed_instanced(dev, mesh_seconds: float):
    """The instanced-field forward render at its file's configuration
    (512x512, 8 spp) in passes of 4, depth 5 without Russian roulette, 8
    lanes, timed on the card, with the first image's seconds from the parse
    on (the kernels were built in phase b)."""
    import tempfile

    import torch

    from pbrt_tpu_torch.io.parser import load_pbrt_string
    from pbrt_tpu_torch.ops import cluster, smallscene, sweep
    from tests.torch_port_instanced import field_text, write_field_meshes

    k, lanes = PASS_SPP, 8
    with tempfile.TemporaryDirectory(prefix="instanced_field_") as tmp:
        write_field_meshes("pbrt_tpu_torch", tmp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scene, camera, settings = load_pbrt_string(field_text(), tmp,
                                                   device=dev)
        res, _ = camera.resolution
        spp = settings["spp"]
        render_pass = make_pass(scene, camera, res, k, lanes,
                                depth=settings["integrator"].max_depth)
        render_pass(0)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    out = timed_forward(render_pass, spp // k,
                        {"k1": smallscene.STATS, "k2": cluster.STATS,
                         "k3": sweep.STATS})
    k1, k2, k3 = out["k1_launches"], out["k2_launches"], out["k3_launches"]
    if k3 == 0 or k1 or k2:
        raise AssertionError(f"timed instanced field: K3 launches={k3} K2 "
                             f"launches={k2} K1 launches={k1}")
    emit("e3_timed_instanced", lanes=lanes, resolution=res, spp=spp,
         samples_per_pass=k, max_depth=settings["integrator"].max_depth,
         **out, first_image_seconds=first_s,
         first_image_with_meshes_seconds=first_s + mesh_seconds,
         k3_ms_per_launch=out["k3_ms"] / k3,
         instances=scene.sweep.n_instances, entries=scene.sweep.n_entries)
    return k3


def phase_timed(dev, lanes: int):
    """The Cornell forward render at its benchmark configuration (bench.py
    cornell_fwd: 256x256, 128 spp in passes of 64, depth 5, no Russian
    roulette), timed on the card."""
    from pbrt_tpu_torch.ops.smallscene import STATS
    from pbrt_tpu_torch.scenes.cornell import cornell_box

    res, spp, k = 256, 128, 64
    scene, camera = cornell_box(resolution=(res, res))
    render_pass = make_pass(scene.with_accel().to(dev), camera.to(dev),
                            res, k, lanes)
    render_pass(0)  # warm-up
    out = timed_forward(render_pass, spp // k, {"k1": STATS})
    if out["k1_launches"] == 0:
        raise AssertionError(f"timed Cornell forward launched no K1: {out}")
    emit("e_timed_forward", lanes=lanes, resolution=res, spp=spp,
         samples_per_pass=k, max_depth=5, **out)
    return out["k1_launches"]


def _kernel_entry(name, source, replaces, launches, k):
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            **{key: k[key] for key in keys}, "library_ms": None}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import pbrt_tpu_torch  # noqa: F401  (fails outside a checkout)

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    dev = torch.device("cuda", 0)
    smi = phase_device()
    builds = phase_build()
    k1 = phase_kernel_vs_twin(dev)
    killeroo = killeroo_on(dev)
    k2 = phase_k2_vs_twin(dev, killeroo)
    field = field_on(dev)
    k3 = phase_k3_vs_twin(dev, field, killeroo)
    phase_golden(dev)
    phase_golden_killeroo(dev, killeroo)
    phase_golden_instanced(dev, field)
    k1_launches = phase_timed(dev, 8)
    phase_timed(dev, 32)
    k2_launches = phase_timed_killeroo(dev, builds["cluster"]["seconds"])
    k3_launches = phase_timed_instanced(dev, field[3])
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    # No single PyTorch call computes a ray/triangle intersection, so no
    # kernel has a library yardstick. K2's and K3's errors are those of the
    # 1,048,576-ray comparisons, both modes.
    lines = {}
    for name, res in (("cluster", k2), ("sweep", k3)):
        lines[name] = {**res["closest"], "max_abs_err": max(
            res["closest"]["max_abs_err"], res["any_hit"]["max_abs_err"])}
    print(json.dumps({"kernels": [
        _kernel_entry("smallscene", K1_SOURCE, K1_REPLACES, k1_launches, k1),
        _kernel_entry("cluster", K2_SOURCE, K2_REPLACES, k2_launches,
                      lines["cluster"]),
        _kernel_entry("sweep", K3_SOURCE, K3_REPLACES, k3_launches,
                      lines["sweep"]),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
