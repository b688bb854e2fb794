#!/usr/bin/env python3
"""Where one killeroo-class forward pass of the PyTorch port spends its
device time, and two diagnostics of what costs more than it must.

The pass is the killeroo benchmark configuration (killeroo_class_scene,
122,244 triangles, K2; 512x512, 4 samples per pixel in the pass, depth 5,
no Russian roulette, 8 lanes) on one CUDA device, after a warm-up pass.

  kernels      torch.profiler over one pass: summed device kernel time, the
               device busy share, kernel launches, K2's kernel time and the
               top kernels (full table: chiprun_out/profile_killeroo.txt)
  layers       CUDA events around each top-level call of the port's layers
               (scripts/profile_torch_pass.py's wrappers; "intersect_*" is
               accel.api.closest / any_hit: the ray sort, K2 and, for
               closest, resolve_tri_attrs)
  shadow_sort  K2 any-hit on the first bounce's real shadow query, sorted by
               ray_sort_perm as the path sorts it (dead lanes' origins at
               1e8 are inside the origin box) and with the origin box taken
               over live lanes only; the answers are the same, as K2 culls
               per ray
  cornell_conductor_link
               the Cornell 8-lane pass (256x256, 64 spp) as the port runs it
               (the BxDF select chain runs the links of the material kinds
               the geometry references: diffuse only) and with the links
               keyed on the material list as the reference keys them (its
               unreferenced copper row then runs the conductor link on every
               lane), in turns A B B A

The passes are chip_smoke.make_pass, the one chip_smoke.py times.

Prints one JSON line per view.

Usage (from the repository root, on a machine with a CUDA device):
    python3 scripts/profile_torch_killeroo.py
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_view(render_pass, out_dir: str, kernel: str = "cluster_kernel",
                key: str = "k2_ms", table: str = "profile_killeroo.txt") -> dict:
    """torch.profiler over one pass after a warm-up; `kernel` names the
    intersection kernel whose device time is reported under `key`, and
    the full table goes to out_dir/`table`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    render_pass()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, rays = render_pass()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if str(getattr(e, "device_type", "")).endswith("CUDA")),
        key=lambda x: -x[1],
    )
    device_ms = sum(ms for _, ms, _ in kern)
    with open(os.path.join(out_dir, table), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=80))
    return {
        "view": "kernels", "rays": float(rays), "wall_ms": wall_ms,
        "device_kernel_ms": device_ms if kern else "not measured",
        "device_busy_share": device_ms / wall_ms if kern else "not measured",
        key: sum(ms for n, ms, _ in kern if kernel in n),
        "kernel_launches": sum(c for _, _, c in kern),
        "top": [[name[:80], round(ms, 3), c] for name, ms, c in kern[:12]],
    }


def layer_view(render_pass) -> dict:
    import profile_torch_pass as ptp

    view = ptp.layer_view(8, render_pass)
    view["layers_ms"] = {k.replace("k1_", "intersect_"): v
                         for k, v in view["layers_ms"].items()}
    return view


def shadow_sort_view(scene, render_pass) -> dict:
    import torch

    from pbrt_tpu_torch.accel import api
    from pbrt_tpu_torch.ops.cluster import cluster_intersect

    captured = []
    any_hit = api.any_hit

    def capture(scene_, o, d, tmax):
        if not captured:
            captured.append((o.clone(), d.clone(), tmax.clone()))
        return any_hit(scene_, o, d, tmax)

    api.any_hit = capture
    try:
        render_pass()
    finally:
        api.any_hit = any_hit
    o, d, tmax = captured[0]
    live = tmax > 0
    o_key = torch.where(live[:, None], o, o[live][:1])  # dead: any live origin
    out = {"view": "shadow_sort", "rays": int(o.shape[0]),
           "live": int(live.sum())}
    for name, key in (("as_path", o), ("live_box", o_key)):
        perm, inv = api.ray_sort_perm(key, d, tmax)
        args = (scene.clusters, o[perm], d[perm], tmax[perm])
        occ = (cluster_intersect(*args, any_hit=True)["prim"] >= 0)[inv]
        for _ in range(2):
            cluster_intersect(*args, any_hit=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            cluster_intersect(*args, any_hit=True)
        end.record()
        torch.cuda.synchronize()
        out[f"k2_any_hit_ms_{name}"] = start.elapsed_time(end) / 5
        out[f"occluded_{name}"] = int(occ.sum())
    return out


def conductor_link_view() -> dict:
    import torch

    from chip_smoke import make_pass
    from pbrt_tpu_torch.materials import bxdf
    from pbrt_tpu_torch.scenes.cornell import cornell_box

    dev = torch.device("cuda", 0)
    scene, camera = cornell_box(resolution=(256, 256))
    scene, camera = scene.with_accel().to(dev), camera.to(dev)
    render_pass = make_pass(scene, camera, 256, 64, 8)
    surface_params = bxdf.surface_params

    def list_keyed(scene_, isect, lam=None):
        params = surface_params(scene_, isect, lam)
        params["any_conductor"] = scene_.materials.any_conductor
        return params

    keyed = {"as_ported": surface_params, "list_keyed": list_keyed}
    times = {name: [] for name in keyed}
    rays, imgs = {}, {}
    for name in ("as_ported", "list_keyed", "list_keyed", "as_ported"):
        bxdf.surface_params = keyed[name]
        try:
            render_pass()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            imgs[name], r = render_pass()
            rays[name] = float(r)  # synchronizes
        finally:
            bxdf.surface_params = surface_params
        times[name].append(time.perf_counter() - t0)
    return {"view": "cornell_conductor_link", "lanes": 8, "rays": rays,
            "seconds": times,
            "mrays_per_s": {n: rays[n] / min(t) / 1e6 for n, t in times.items()},
            "images_equal": bool(torch.equal(imgs["as_ported"],
                                              imgs["list_keyed"]))}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_killeroo: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from chip_smoke import make_pass
    from pbrt_tpu_torch.scenes.meshes import killeroo_class_scene

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda", 0)
    scene, camera = killeroo_class_scene(resolution=(512, 512))
    scene, camera = scene.to(dev), camera.to(dev)
    render_pass = make_pass(scene, camera, 512, 4, 8)
    print(json.dumps(kernel_view(render_pass, out_dir)), flush=True)
    print(json.dumps(layer_view(render_pass)), flush=True)
    print(json.dumps(shadow_sort_view(scene, render_pass)), flush=True)
    print(json.dumps(conductor_link_view()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
