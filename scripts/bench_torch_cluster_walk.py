#!/usr/bin/env python3
"""K2 and K3 on one CUDA device: the shipped warp-level walk against the
block-staged design it replaced, and the sweep of its design constants.

Builds, with nvcc_build's flags, one nvcc per library, all started
together:
  - new        K2 (csrc/cluster.cu) and K3 (csrc/sweep.cu) as shipped;
  - variants   the same sources with `constexpr` design constants
               rewritten, one build per point of --grid (kLoneMax, the
               triangle-parallel switch-over of csrc/cluster_walk.cuh);
  - old        with --old DIR: DIR/cluster.cu and DIR/sweep.cu, the
               block-staged design (the csrc directory of the commit
               before the warp-level walk, unpacked with git archive).
Then times each on the main path's batches (chip_smoke._pass_batches: the
1,048,576 camera rays of one 512x512, 4 spp pass, closest, and their NEE
shadow rays with the path's dead lanes, any-hit; the killeroo-class scene
for K2, the instanced field for K3), and the shadow rays again in
chip_smoke.live_lane_order. Every build's answers must equal the shipped
kernel's key by key (and the shipped kernel equals its twin: chip_smoke
c2, c3). The old design and the new one run in turns, old, new, new, old;
each variant twice, in forward then reverse order.

Prints one JSON line per build log, per kernel and batch, and the
nvidia-smi line, and with --out writes them all to that file. Exits
non-zero if any build disagrees with the shipped kernel.

Usage (from the repository root, on a machine with a CUDA device):
    python3 scripts/bench_torch_cluster_walk.py [--old DIR]
        [--grid "kLoneMax=0,1,2,4,8,16,32"]
        [--out PATH]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("cluster", "sweep")


def _variant_csrc(csrc, dest, values: dict) -> None:
    """Copy csrc into dest with each `constexpr <type> <name> = ...;` of
    `values` rewritten (each name must be defined once in csrc)."""
    shutil.copytree(csrc, dest)
    for name, value in values.items():
        hits = 0
        for fname in sorted(os.listdir(dest)):
            path = os.path.join(dest, fname)
            with open(path) as f:
                src = f.read()
            src, n = re.subn(rf"(constexpr \w+ {name} = )[^;]+;",
                             rf"\g<1>{value};", src)
            if n:
                hits += n
                with open(path, "w") as f:
                    f.write(src)
        if hits != 1:
            raise RuntimeError(f"{name} is defined {hits} times in {csrc}")


def _grid(spec: str) -> list[dict]:
    """"a=1,2;b=true,false" -> [{a: 1, b: true}, {a: 1, b: false}, ...]."""
    axes = [(name, values.split(",")) for name, values in
            (part.split("=") for part in spec.split(";") if part)]
    return [dict(zip([a for a, _ in axes], point))
            for point in itertools.product(*(v for _, v in axes))]


def _nvcc(src: str, out: str) -> tuple[str, float, str]:
    from pbrt_tpu_torch.ops import nvcc_build

    cmd = [nvcc_build.nvcc_path(), *nvcc_build.NVCC_FLAGS, "-o", out, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stderr}")
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


def build_all(old_dir, grid, work):
    """{name: {kernel: ctypes library}} and {name: {kernel: ptxas lines}}."""
    import ctypes

    from pbrt_tpu_torch.ops import cluster, nvcc_build, sweep

    shipped = str(nvcc_build.CSRC_DIR)
    src_dirs = {"new": shipped}
    for values in grid:
        name = ",".join(f"{k}={v}" for k, v in values.items())
        src_dirs[name] = os.path.join(work, f"v{len(src_dirs)}")
        _variant_csrc(shipped, src_dirs[name], values)
    if old_dir:
        src_dirs["old"] = old_dir
    jobs = {(name, k): (os.path.join(d, f"{k}.cu"),
                        os.path.join(work, f"lib{i}-{k}.so"))
            for i, (name, d) in enumerate(src_dirs.items()) for k in KERNELS}
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        done = dict(zip(jobs, pool.map(lambda j: _nvcc(*j), jobs.values())))
    bind = {"cluster": cluster.bind, "sweep": sweep.bind}
    libs, logs = {}, {}
    for (name, k), (path, seconds, log) in done.items():
        lib = ctypes.CDLL(path)
        # The old K3 entry point takes no group boxes (old_sweep_launch).
        libs.setdefault(name, {})[k] = (lib if (name, k) == ("old", "sweep")
                                        else bind[k](lib))
        logs.setdefault(name, {})[k] = {
            "seconds": seconds,
            "ptxas": [ln.strip() for ln in log.splitlines()
                      if "Used" in ln or "spill" in ln
                      or "Compiling entry" in ln]}
    return libs, logs


def old_sweep_launch(lib, acc, o, d, tmax, any_hit: bool) -> dict:
    """K3 through the block-staged design's entry point, which takes the
    tables without gbox; the wrapper's checks are the shipped kernel's."""
    import ctypes

    import torch

    from pbrt_tpu_torch.ops.sweep import _TRI_KEYS

    p = ctypes.c_void_p
    lib.sweep_launch.argtypes = (
        [p] * 14 + [ctypes.c_int, ctypes.c_int, p, p, p, ctypes.c_longlong,
                    ctypes.c_int, p, p, p, p])
    lib.sweep_launch.restype = ctypes.c_int
    n = o.shape[0]
    out = {"t": torch.empty((n,), dtype=torch.float32, device=o.device),
           "prim": torch.empty((n,), dtype=torch.int32, device=o.device),
           "inst": torch.empty((n,), dtype=torch.int32, device=o.device)}
    err = lib.sweep_launch(
        acc.boxes.data_ptr(), acc.ibox.data_ptr(), acc.irange.data_ptr(),
        acc.w2o.data_ptr(), *(getattr(acc, k).data_ptr() for k in _TRI_KEYS),
        acc.n_instances, int(acc.instanced), o.data_ptr(), d.data_ptr(),
        tmax.data_ptr(), n, int(any_hit), out["t"].data_ptr(),
        out["prim"].data_ptr(), out["inst"].data_ptr(),
        torch.cuda.current_stream(o.device).cuda_stream)
    if err:
        raise RuntimeError(f"old sweep kernel launch failed: {err}")
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--old", default=None,
                        help="directory with the block-staged cluster.cu, "
                             "sweep.cu and triangle.cuh")
    parser.add_argument("--grid",
                        default="kLoneMax=0,1,2,4,8,16,32")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_cluster_walk: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from pbrt_tpu_torch.ops import cluster, nvcc_build, sweep

    lines = []

    def emit(**fields):
        lines.append(fields)
        print(json.dumps(fields), flush=True)

    dev = torch.device("cuda", 0)
    smi = chip_smoke.nvidia_smi()
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    work = os.path.join(str(nvcc_build.BUILD_DIR), "walk_variants")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    libs, logs = build_all(args.old, _grid(args.grid), work)
    emit(build_wall_seconds=time.perf_counter() - t0, builds=logs)

    killeroo = chip_smoke.killeroo_on(dev)
    field = chip_smoke.field_on(dev)
    cases = {"cluster": (cluster, cluster.cluster_intersect,
                         killeroo[0].clusters, killeroo[:2]),
             "sweep": (sweep, sweep.sweep_intersect, field[0].sweep,
                       field[:2])}
    failed = []
    for kernel, (mod, intersect, acc, (scene, camera)) in cases.items():
        rays, _, _ = chip_smoke._pass_batches(scene, camera, dev)
        rays["any_hit_live_order"] = chip_smoke.live_lane_order(
            *rays["any_hit"])[:3]
        shipped = mod._library

        def run(name, batch, any_hit):
            lib = libs[name][kernel]
            if (name, kernel) == ("old", "sweep"):
                return old_sweep_launch(lib, acc, *batch, any_hit)
            mod._library = lambda: lib
            try:
                return intersect(acc, *batch, any_hit=any_hit)
            finally:
                mod._library = shipped

        def ms(name, batch, any_hit):
            return chip_smoke.cuda_ms(lambda: run(name, batch, any_hit),
                                      reps=10)

        for label, batch in rays.items():
            any_hit = label != "closest"
            want = run("new", batch, any_hit)
            torch.cuda.synchronize()
            agree = {}
            for name in libs:
                got = run(name, batch, any_hit)
                agree[name] = all(torch.equal(got[k], want[k]) for k in want)
                if not agree[name]:
                    failed.append((kernel, label, name))
            row = {"kernel": kernel, "batch": label,
                   "rays": int(batch[0].shape[0]),
                   "live": int((batch[2] > 0).sum()),
                   "disagree": sorted(n for n, ok in agree.items() if not ok)}
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
