#!/usr/bin/env python3
"""K4 on one CUDA device: the shipped BVH walk against the design it
replaced, and the sweep of its design constants.

Builds, with nvcc_build's flags, one nvcc per library, all started
together:
  - new        K4 (csrc/traverse.cu) as shipped;
  - variants   the same source with `constexpr` design constants
               rewritten, one build per point of --grid (kThreads);
  - old        with --old DIR: DIR/traverse.cu, the binary walk over the
               split reference tables (the csrc directory of the commit
               before the redesign, unpacked with git archive).
Then times each on the main path's batches (chip_smoke._pass_batches,
unsorted as the BVH tier sends them: the 1,048,576 camera rays of one
512x512, 4 spp pass of the killeroo-class scene on its BVH, closest, and
their NEE shadow rays with the path's dead lanes, any-hit). The shipped
kernel must equal the twin on both batches, and every build the shipped
kernel, key by key. The old design and the new one run in turns, old,
new, new, old; each variant twice, in forward then reverse order. Each
batch reports the twin's work counts per live ray.

Prints one JSON line per build log, per batch, and the nvidia-smi line,
and with --out writes them all to that file. Exits non-zero if any build
disagrees.

Usage (from the repository root, on a machine with a CUDA device):
    python3 scripts/bench_torch_traverse.py [--old DIR]
        [--grid "kThreads=64,128,256"] [--out PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT, HERE]

from bench_torch_cluster_walk import _grid, _nvcc  # noqa: E402


def _variant_csrc(csrc, dest, values: dict) -> None:
    """Copy csrc into dest with each `constexpr <type> <name> = ...;` of
    `values` rewritten in traverse.cu (each defined there once)."""
    shutil.copytree(csrc, dest)
    path = os.path.join(dest, "traverse.cu")
    with open(path) as f:
        src = f.read()
    for name, value in values.items():
        src, hits = re.subn(rf"(constexpr \w+ {name} = )[^;]+;",
                            rf"\g<1>{value};", src)
        if hits != 1:
            raise RuntimeError(f"{name} is defined {hits} times in {path}")
    with open(path, "w") as f:
        f.write(src)


def build_all(old_dir, grid, work):
    """{name: ctypes library} and {name: build log}."""
    from pbrt_tpu_torch.ops import nvcc_build, traverse

    shipped = str(nvcc_build.CSRC_DIR)
    src_dirs = {"new": shipped}
    for values in grid:
        name = ",".join(f"{k}={v}" for k, v in values.items())
        src_dirs[name] = os.path.join(work, f"v{len(src_dirs)}")
        _variant_csrc(shipped, src_dirs[name], values)
    if old_dir:
        src_dirs["old"] = old_dir
    jobs = {name: (os.path.join(d, "traverse.cu"),
                   os.path.join(work, f"lib{i}-traverse.so"))
            for i, (name, d) in enumerate(src_dirs.items())}
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        done = dict(zip(jobs, pool.map(lambda j: _nvcc(*j), jobs.values())))
    libs, logs = {}, {}
    for name, (path, seconds, log) in done.items():
        lib = ctypes.CDLL(path)
        # The old entry point takes the split tables (old_launch).
        libs[name] = lib if name == "old" else traverse.bind(lib)
        logs[name] = {
            "seconds": seconds,
            "ptxas": [ln.strip() for ln in log.splitlines()
                      if "Used" in ln or "spill" in ln
                      or "Compiling entry" in ln]}
    return libs, logs


def old_launch(lib, bvh, o, d, tmax, any_hit: bool):
    """K4 through the old design's entry point, which takes the split
    reference tables (node_lo, node_hi, v0, e1, e2, prim_id)."""
    import torch

    p = ctypes.c_void_p
    lib.traverse_launch.argtypes = (
        [p] * 6 + [ctypes.c_int, ctypes.c_int, p, p, p, ctypes.c_longlong,
                   ctypes.c_int] + [p] * 4 + [p])
    lib.traverse_launch.restype = ctypes.c_int
    n = o.shape[0]
    out = [torch.empty((n,), dtype=dt, device=o.device)
           for dt in (torch.float32, torch.int32, torch.float32,
                      torch.float32)]
    err = lib.traverse_launch(
        bvh.node_lo.data_ptr(), bvh.node_hi.data_ptr(), bvh.v0.data_ptr(),
        bvh.e1.data_ptr(), bvh.e2.data_ptr(), bvh.prim_id.data_ptr(),
        bvh.depth, bvh.leaf_size, o.data_ptr(), d.data_ptr(),
        tmax.data_ptr(), n, int(any_hit), *(x.data_ptr() for x in out),
        torch.cuda.current_stream(o.device).cuda_stream)
    if err:
        raise RuntimeError(f"old traverse kernel launch failed: {err}")
    return tuple(out)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--old", default=None,
                        help="directory with the old traverse.cu and "
                             "triangle.cuh")
    parser.add_argument("--grid", default="kThreads=64,128,256")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_traverse: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from pbrt_tpu_torch.ops import nvcc_build, traverse
    from pbrt_tpu_torch.scenes.meshes import killeroo_class_scene

    lines = []

    def emit(**fields):
        lines.append(fields)
        print(json.dumps(fields), flush=True)

    dev = torch.device("cuda", 0)
    emit(device=torch.cuda.get_device_name(0),
         nvidia_smi=chip_smoke.nvidia_smi())
    work = os.path.join(str(nvcc_build.BUILD_DIR), "traverse_variants")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    libs, logs = build_all(args.old, _grid(args.grid), work)
    emit(build_wall_seconds=time.perf_counter() - t0, builds=logs)
    emit(constants={name: traverse.constants(15, lib=lib)
                    for name, lib in libs.items() if name != "old"})

    killeroo = killeroo_class_scene(
        resolution=(chip_smoke.PASS_RES, chip_smoke.PASS_RES))
    scene, _ = chip_smoke.bvh_scene_of(killeroo, dev)
    bvh = scene.bvh
    rays, _, _ = chip_smoke._pass_batches(scene, killeroo[1].to(dev), dev,
                                          sort=False)

    def run(name, batch, any_hit):
        lib = libs[name]
        if name == "old":
            return old_launch(lib, bvh, *batch, any_hit)
        return traverse._launch(bvh, *batch, any_hit, lib=lib)

    def ms(name, batch, any_hit):
        return chip_smoke.cuda_ms(lambda: run(name, batch, any_hit), reps=10)

    failed = []
    for label, batch in rays.items():
        any_hit = label == "any_hit"
        want = run("new", batch, any_hit)
        counts = {}
        twin = traverse.bvh_intersect_ref(bvh, *batch, any_hit=any_hit,
                                          counts=counts)
        if not all(torch.equal(g, w) for g, w in zip(want, twin)):
            failed.append(("new vs twin", label))
        agree = {}
        for name in libs:
            got = run(name, batch, any_hit)
            agree[name] = all(torch.equal(g, w) for g, w in zip(got, want))
            if not agree[name]:
                failed.append((name, label))
        torch.cuda.synchronize()
        live = int((batch[2] > 0).sum())
        row = {"batch": label, "rays": int(batch[0].shape[0]), "live": live,
               "disagree": sorted(n for n, ok in agree.items() if not ok),
               "twin_per_live_ray": {k: v / max(live, 1)
                                     for k, v in counts.items()}}
        if "old" in libs:
            turns = [ms(n, batch, any_hit)
                     for n in ("old", "new", "new", "old")]
            row.update(old_ms=[turns[0], turns[3]],
                       new_ms=[turns[1], turns[2]],
                       speedup=(turns[0] + turns[3])
                       / (turns[1] + turns[2]))
        names = [n for n in libs if n not in ("old", "new")]
        first = {n: ms(n, batch, any_hit) for n in names}
        second = {n: ms(n, batch, any_hit) for n in reversed(names)}
        row["variants_ms"] = {n: [first[n], second[n]] for n in names}
        emit(**row)
    emit(nvidia_smi_end=chip_smoke.nvidia_smi(), failed=failed)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
