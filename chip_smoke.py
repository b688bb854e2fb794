#!/usr/bin/env python3
"""Chip smoke test of pbrt_tpu_torch, the PyTorch + CUDA port, on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from the sources in the checkout,
checks each against its plain PyTorch twin, renders the Cornell box on the
card against the committed JAX golden, and times the forward render at the
benchmark configuration. Each phase prints one JSON line; any failure
raises, so the script exits non-zero and never prints the final line.
Without a CUDA device it exits non-zero at once. It never imports JAX.

Phases:
  a  device: name, nvidia-smi name and power limit, torch/CUDA versions
  b  build: nvcc build of K1 (csrc/smallscene.cu) and its ptxas summary
  c  K1 vs its twin on 4,194,304 rays (the forward pass's query shape):
     camera rays, random rays inside the box, dead lanes (tmax = 0),
     axis-parallel rays and NEE shadow segments; closest and any-hit
     modes must be bit-equal; kernel and twin times
  d  Cornell 32x32, 16 spp, 32 lanes, depth 5 (default Russian roulette)
     against tests/data/torch_port/cornell32_spp16.npy: >= 99% of pixel
     values within rtol 1e-3 / atol 1e-5, and 11 K1 launches per pass
  e  timed forward at the benchmark configuration (Cornell 256x256, 128
     spp in passes of 64, depth 5, no Russian roulette) at 8 and 32 lanes
  f  the kernels line, the nvidia-smi line and the final result line
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port", "cornell32_spp16.npy")
K1_SOURCE = "pbrt_tpu_torch/csrc/smallscene.cu"
K1_REPLACES = "pbrt_tpu/ops/smallscene.py:73"
MAIN_PATH_RAYS = 256 * 256 * 64  # one forward pass of the bench config


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
    from pbrt_tpu_torch.ops import nvcc_build

    t0 = time.perf_counter()
    nvcc_build.load_library("smallscene")
    seconds = time.perf_counter() - t0
    _, log = nvcc_build.BUILD_LOG.get("smallscene", (0.0, ""))
    ptxas = [ln.strip() for ln in log.splitlines() if "Used" in ln]
    emit("b_build", kernel="smallscene", seconds=seconds, ptxas=ptxas,
         cached=not log)


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
        finite = torch.isfinite(want["t"])
        err = float(torch.max(torch.abs(got["t"][finite] - want["t"][finite])))
        for k in ("u", "v", "n"):
            if k in want:
                err = max(err, float(torch.max(torch.abs(got[k] - want[k]))))
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
    emit("c_kernel_vs_twin", **result, ms_closest=ms, ms_any_hit=ms_any,
         plain_ms_closest=plain_ms)
    err = max(r["max_abs_err"] for r in result.values())
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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


def phase_timed(dev, lanes: int):
    """The bench configuration's forward render, timed on the card."""
    import torch

    from pbrt_tpu_torch.films.rgb import spectrum_to_rgb
    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.ops.smallscene import STATS
    from pbrt_tpu_torch.render import camera_rays_full
    from pbrt_tpu_torch.scenes.cornell import cornell_box

    res, spp, k, depth = 256, 128, 64, 5
    scene, camera = cornell_box(resolution=(res, res))
    scene = scene.with_accel().to(dev)
    camera = camera.to(dev)
    integrator = PathIntegrator(max_depth=depth, rr_start_depth=depth)
    npix = res * res
    pixel_b = torch.arange(npix, device=dev).repeat(k)

    def render_pass(pass_idx):
        sample_b = torch.arange(
            pass_idx * k, (pass_idx + 1) * k, device=dev
        ).repeat_interleave(npix)
        o, d, wl, _ = camera_rays_full(camera, pixel_b, sample_b, 0,
                                       n_spectrum=lanes)
        radiance, stats = integrator.trace_with_stats(
            scene, o, d, wl, pixel_b, sample_b, 0
        )
        rgb = spectrum_to_rgb(radiance, wl)
        return torch.mean(rgb.reshape(k, res, res, 3), dim=0), stats["rays"]

    img, _ = render_pass(0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    STATS.reset(timed=True)
    n_passes = spp // k
    t0 = time.perf_counter()
    acc, rays = None, None
    for p in range(n_passes):
        img, r = render_pass(p)
        acc = img if acc is None else acc + img
        rays = r if rays is None else rays + r
    total_rays = float(rays)  # synchronizes
    seconds = time.perf_counter() - t0
    launches = STATS.launches
    k1_ms = STATS.elapsed_ms()
    STATS.reset()
    peak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(acc).all()) or launches == 0:
        raise AssertionError(f"timed pass: finite={bool(torch.isfinite(acc).all())} "
                             f"launches={launches}")
    emit("e_timed_forward", lanes=lanes, resolution=res, spp=spp,
         samples_per_pass=k, max_depth=depth, passes=n_passes,
         rays=total_rays, seconds=seconds, mrays_per_s=total_rays / seconds / 1e6,
         peak_bytes=peak, k1_launches=launches, k1_ms=k1_ms,
         k1_share=k1_ms / (seconds * 1e3), image_mean=float(acc.mean() / n_passes))
    return launches


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
    phase_build()
    k1 = phase_kernel_vs_twin(dev)
    phase_golden(dev)
    launches = phase_timed(dev, 8)
    phase_timed(dev, 32)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps({"kernels": [{
        "name": "smallscene", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
