#!/usr/bin/env python3
"""Where one forward+backward pass of the PyTorch port spends its time.

The pass is chip_smoke.make_grad_pass, the one chip_smoke.py times as
e_timed_fwdbwd: bench.py's cornell_fwdbwd_8lane (Cornell 256x256, 2 samples
per pixel a pass, depth 5, no Russian roulette, 8 lanes; the loss is the
mean squared error of spectrum_to_rgb against 0.25, differentiated with
respect to materials.albedo_coeffs and lights.area_scale). It runs in two
gradient modes on one CUDA device, in turns (remat, plain, plain, remat):

  remat  the port's path: the shading between the queries checkpointed
         (models/path.py `_remat`), recomputed in the backward pass;
  plain  the same pass with `_remat` replaced by a direct call, so
         autograd keeps every activation (a diagnostic, not a path).

For each mode: the wall of `--passes` passes (host clock around work that
ends in a synchronize), the forward's and the backward's device time
(CUDA events around each), peak memory, and from torch.profiler over one
more pass the device kernel time, the busy share, the kernel launches of
the forward and of the backward, and the operators with the most host
time. A forward pass under torch.no_grad() at the same shape is timed
beside them. Prints one JSON line per mode; the profiler tables go to
chiprun_out/profile_fwdbwd_<mode>.txt.

Usage (from the repository root, on a machine with a CUDA device):
    python3 scripts/profile_torch_fwdbwd.py [--passes N]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_passes(res=256, k=2, lanes=8):
    """chip_smoke.make_grad_pass on the bench configuration's Cornell box."""
    import torch

    from chip_smoke import make_grad_pass
    from pbrt_tpu_torch.scenes.cornell import cornell_box

    dev = torch.device("cuda", 0)
    scene, camera = cornell_box(resolution=(res, res))
    return make_grad_pass(scene.with_accel().to(dev), camera.to(dev), res, k,
                          lanes)


def timed(grad_pass, passes: int) -> dict:
    import torch

    grad_pass(0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = []
    t0 = time.perf_counter()
    for p in range(passes):
        grad_pass(p, events)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    fwd = sum(a.elapsed_time(b) for a, b, _ in events)
    bwd = sum(b.elapsed_time(c) for _, b, c in events)
    return {"passes": passes, "wall_ms_per_pass": wall / passes,
            "forward_ms_per_pass": fwd / passes,
            "backward_ms_per_pass": bwd / passes,
            "backward_share": bwd / wall,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def profiled(grad_pass, mode: str, out_dir: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grad_pass(0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    spans = {e.name: (e.time_range.start, e.time_range.end)
             for e in events if e.name in ("forward", "backward")
             and str(e.device_type).endswith("CPU")}
    kernels = [e for e in events
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and e.name not in ("forward", "backward")]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3

    def launches_in(span):
        lo, hi = spans.get(span, (0, -1))
        # A kernel belongs to the span of the host call that launched it.
        return sum(1 for e in events if e.name in (
            "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")
            and lo <= e.time_range.start <= hi)

    ops = prof.key_averages()
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in ops), key=lambda x: -x[1])
    # Operators (aten::...) by the device time of the kernels they launch.
    device = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                     for e in ops if e.key.startswith("aten::")),
                    key=lambda x: -x[1])
    with open(os.path.join(out_dir, f"profile_fwdbwd_{mode}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                          row_limit=80))
    return {"wall_ms": wall_ms,
            "device_kernel_ms": device_ms if kernels else "not measured",
            "device_busy_share":
                device_ms / wall_ms if kernels else "not measured",
            "kernel_launches": len(kernels),
            "forward_launches": launches_in("forward"),
            "backward_launches": launches_in("backward"),
            "top_host_ops": [[n[:60], round(ms, 3), c]
                             for n, ms, c in host[:15]],
            "top_device_ops": [[n[:60], round(ms, 3), c]
                               for n, ms, c in device[:10]]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_fwdbwd: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from pbrt_tpu_torch.models import path as path_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    grad_pass, forward_pass = make_passes()
    remat = path_mod._remat
    for mode in ("remat", "plain", "plain", "remat"):
        path_mod._remat = remat if mode == "remat" else path_mod._direct
        try:
            out = {"mode": mode, **timed(grad_pass, args.passes)}
            out.update(profiled(grad_pass, mode, out_dir))
        finally:
            path_mod._remat = remat
        print(json.dumps(out), flush=True)
    forward_pass(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rays = float(sum(forward_pass(p)[1] for p in range(args.passes)))
    wall = (time.perf_counter() - t0) * 1e3  # float() synchronized
    print(json.dumps({"mode": "forward_no_grad",
                      "wall_ms_per_pass": wall / args.passes,
                      "rays_per_pass": rays / args.passes}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
