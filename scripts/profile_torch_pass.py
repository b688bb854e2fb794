#!/usr/bin/env python3
"""Where one forward pass of the PyTorch port spends its device time.

Profiles one pass of the benchmark configuration (Cornell 256x256, 64
samples per pixel in the pass, depth 5, no Russian roulette) on one CUDA
device, after a warm-up pass, at each lane count given (default 8 and 32).
Two views, each from its own pass:

  kernels  torch.profiler: summed device kernel time, the device busy share
           (kernel time / wall time), kernel launches and the top kernels;
           the full table goes to chiprun_out/profile_pass_<lanes>.txt.
  layers   CUDA events around each top-level call of the port's layers
           (camera, RNG draws, K1 closest / any-hit, lights, BxDF, frames
           and ray spawning, film), found by wrapping the module and class
           attributes the integrator calls through. Device work is queued
           in order and the device stays busy, so an event pair measures
           the layer's device time; "other" is the pass's remainder.

Prints one JSON line per lane count and view.

Usage (from the repository root, on a machine with a CUDA device):
    python3 scripts/profile_torch_pass.py [lanes ...]
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_pass(lanes: int):
    import torch

    from pbrt_tpu_torch import render as render_mod
    from pbrt_tpu_torch.films import rgb as film_mod
    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.scenes.cornell import cornell_box

    dev = torch.device("cuda", 0)
    res, k, depth = 256, 64, 5
    scene, camera = cornell_box(resolution=(res, res))
    scene = scene.with_accel().to(dev)
    camera = camera.to(dev)
    integrator = PathIntegrator(max_depth=depth, rr_start_depth=depth)
    npix = res * res
    pixel_b = torch.arange(npix, device=dev).repeat(k)
    sample_b = torch.arange(k, device=dev).repeat_interleave(npix)

    def render_pass():
        o, d, wl, _ = render_mod.camera_rays_full(
            camera, pixel_b, sample_b, 0, n_spectrum=lanes
        )
        radiance, stats = integrator.trace_with_stats(
            scene, o, d, wl, pixel_b, sample_b, 0
        )
        rgb = film_mod.spectrum_to_rgb(radiance, wl)
        return torch.mean(rgb.reshape(k, res, res, 3), dim=0), stats["rays"]

    return render_pass


def kernel_totals(prof) -> list:
    """[name, device ms, launches] of each kernel (and copy) a finished
    torch.profiler session holds, the longest first. Sums the session's raw
    kineto events: key_averages() first builds a Python event, and its
    tree, for every event, which takes tens of seconds for a pass of 1e5
    launches."""
    totals = defaultdict(lambda: [0.0, 0])
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        return sorted(
            ([e.key, e.self_device_time_total / 1e3, e.count]
             for e in prof.key_averages()
             if str(getattr(e, "device_type", "")).endswith("CUDA")),
            key=lambda x: -x[1])
    for e in events:
        if str(e.device_type()).endswith("CUDA"):
            t = totals[e.name()]
            t[0] += e.duration_ns() / 1e6
            t[1] += 1
    return sorted(([name, ms, n] for name, (ms, n) in totals.items()),
                  key=lambda x: -x[1])


def kernel_view(lanes: int, render_pass, out_dir: str,
                warm: bool = True) -> dict:
    """The kernels view of one pass; a warm-up pass first unless the caller
    has just run render_pass (warm=False)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        render_pass()
    torch.cuda.synchronize()
    # Device activity only: the view reads kernel events.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, rays = render_pass()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = kernel_totals(prof)
    device_ms = sum(ms for _, ms, _ in kern)
    k1_ms = sum(ms for name, ms, _ in kern if "smallscene_kernel" in name)
    with open(os.path.join(out_dir, f"profile_pass_{lanes}.txt"), "w") as f:
        f.write(f"{'device ms':>12} {'launches':>9}  kernel\n")
        for name, ms, n in kern[:80]:
            f.write(f"{ms:12.3f} {n:9d}  {name}\n")
    return {
        "view": "kernels", "lanes": lanes, "rays": float(rays),
        "wall_ms": wall_ms,
        "device_kernel_ms": device_ms if kern else "not measured",
        "device_busy_share": device_ms / wall_ms if kern else "not measured",
        "k1_ms": k1_ms, "kernel_launches": sum(c for _, _, c in kern),
        "top": [[name[:80], round(ms, 3), c] for name, ms, c in kern[:12]],
    }


class LayerTimer:
    """CUDA-event timing of the outermost wrapped call in flight."""

    def __init__(self):
        self.events = defaultdict(list)
        self.depth = 0

    def wrap(self, name, fn):
        import torch

        def timed(*args, **kwargs):
            if self.depth:
                return fn(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            self.depth += 1
            start.record()
            try:
                return fn(*args, **kwargs)
            finally:
                end.record()
                self.depth -= 1
                self.events[name].append((start, end))

        return timed

    def totals_ms(self) -> dict:
        return {name: sum(s.elapsed_time(e) for s, e in pairs)
                for name, pairs in self.events.items()}


@contextlib.contextmanager
def wrapped_layers(timer: LayerTimer):
    from pbrt_tpu_torch import render as render_mod
    from pbrt_tpu_torch.accel import api as accel_api
    from pbrt_tpu_torch.films import rgb as film_mod
    from pbrt_tpu_torch.lights.buffers import LightBuffers
    from pbrt_tpu_torch.materials import bxdf
    from pbrt_tpu_torch.models import path as path_mod
    from pbrt_tpu_torch.samplers.samplers import Sampler

    layers = {
        "camera": [(render_mod, "camera_rays_full")],
        "rng": [(Sampler, "get_1d"), (Sampler, "get_2d")],
        "k1_closest": [(accel_api, "closest")],
        "k1_any_hit": [(accel_api, "any_hit")],
        "lights": [(LightBuffers, a) for a in (
            "emitted", "pdf_li_area", "sample_li", "pdf_escaped",
            "escaped_radiance")],
        "bxdf": [(bxdf, a) for a in ("surface_params", "sample", "evaluate", "pdf")],
        "frames_spawn": [(path_mod, a) for a in (
            "shading_frame", "to_local", "from_local", "shadow_segment",
            "offset_ray_origin")],
        "film": [(film_mod, "spectrum_to_rgb")],
    }
    saved = []
    for name, targets in layers.items():
        for owner, attr in targets:
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, timer.wrap(name, fn))
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def layer_view(lanes: int, render_pass) -> dict:
    import torch

    timer = LayerTimer()
    with wrapped_layers(timer):
        render_pass()  # warm-up
        torch.cuda.synchronize()
        timer.events.clear()
        t0 = time.perf_counter()
        render_pass()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    layers = timer.totals_ms()
    layers["other"] = wall_ms - sum(layers.values())
    return {"view": "layers", "lanes": lanes, "wall_ms": wall_ms,
            "layers_ms": dict(sorted(layers.items(), key=lambda kv: -kv[1]))}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_pass: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    for lanes in [int(a) for a in sys.argv[1:]] or [8, 32]:
        render_pass = make_pass(lanes)
        print(json.dumps(kernel_view(lanes, render_pass, out_dir)), flush=True)
        print(json.dumps(layer_view(lanes, render_pass)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
