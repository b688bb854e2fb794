#!/usr/bin/env python3
"""Time two configurations of chip_smoke.py's timed phases on the port of
each checkout given, in the order given, on one CUDA device: the
many-light hall with the power sampler (e8's: 256x256, 16 spp in passes
of 8, depth 4, 8 lanes) and texture.pbrt (e7's: 512x512, 8 spp in passes
of 4, the file's depth 4, 8 lanes). Each checkout runs in a process of
its own; each configuration is timed three times after a warm-up pass
(chip_smoke.timed_forward). Prints the card's name and power limit, then
one JSON line per checkout.

Usage (from the repository root, on a machine with a CUDA device; the
parent commit unpacked into a directory .gitignore lists):
    mkdir -p _chip_local/parent && git archive <commit> | tar -x -C _chip_local/parent
    python3 scripts/time_torch_ab.py _chip_local/parent . . _chip_local/parent
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPS = 3


def _one(root: str) -> dict:
    import torch

    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from pbrt_tpu_torch.io.parser import load_pbrt
    from pbrt_tpu_torch.ops import cluster, smallscene

    dev = torch.device("cuda", 0)
    out = {"checkout": root}
    scene, camera, _ = cs.hall_scenes()["power"]
    rp = cs.make_pass(scene.to(dev), camera.to(dev), 256, 8, 8, depth=4)
    rp(0)
    out["hall_power_mrays_per_s"] = [
        cs.timed_forward(rp, 2, {"k2": cluster.STATS})["mrays_per_s"]
        for _ in range(REPS)]
    scene, camera, settings = load_pbrt(
        os.path.join(root, "tests", "goldens", "texture.pbrt"), device=dev)
    rp = cs.make_pass(scene, camera.replace(resolution=(512, 512)), 512, 4, 8,
                      depth=settings["integrator"].max_depth)
    rp(0)
    out["texture_mrays_per_s"] = [
        cs.timed_forward(rp, 2, {"k1": smallscene.STATS})["mrays_per_s"]
        for _ in range(REPS)]
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(_one(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for root in sys.argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode or not lines:
            print(proc.stderr[-2000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
