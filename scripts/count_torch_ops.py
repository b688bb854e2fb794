#!/usr/bin/env python3
"""Count the aten ops one forward pass of the port dispatches, on the CPU:
a stand-in for the card's kernel launches before a chip run (views are
left out; on the CPU the queries run their plain twins, whose ops are
one kernel launch each on the card).

  families  tests/data/torch_port/families.pbrt at 96x96, 1 spp, depth 5,
            8 lanes (the sorted dispatch on), the ops split by layer and
            by the family segment the BxDF calls run on
  texture   tests/goldens/texture.pbrt at 32x32, 2 spp, depth 4, 8 lanes
  hall      the many-light hall cut to 16 lights, 24x24, 2 spp, depth 4

Usage (from the repository root; --root runs another checkout's port,
e.g. the parent commit unpacked into an ignored directory):
    python3 scripts/count_torch_ops.py [--root DIR] [families|texture|hall ...]
Prints one JSON line per scene: the total, and the pass's rays and mean.
"""

from __future__ import annotations

import collections
import json
import os
import sys

VIEWS = {"aten.view", "aten._unsafe_view", "aten.slice", "aten.select",
         "aten.unsqueeze", "aten.expand", "aten.t", "aten.transpose",
         "aten.permute", "aten.alias", "aten.detach", "aten.squeeze",
         "aten.as_strided", "aten.unbind", "aten.split", "aten.lift_fresh"}


def _pass(name: str, root: str):
    import chip_smoke as cs
    from pbrt_tpu_torch.io.parser import load_pbrt

    if name == "families":
        scene, camera, _ = load_pbrt(
            os.path.join(root, "tests/data/torch_port/families.pbrt"),
            device="cpu")
        return cs.make_pass(scene, camera.replace(resolution=(96, 96)), 96,
                            1, 8, depth=5)
    if name == "texture":
        scene, camera, _ = load_pbrt(
            os.path.join(root, "tests/goldens/texture.pbrt"), device="cpu")
        return cs.make_pass(scene, camera.replace(resolution=(32, 32)), 32,
                            2, 8, depth=4)
    from pbrt_tpu_torch.scenes.manylight import manylight_scene

    scene, camera = manylight_scene(resolution=(24, 24), n_lights=16,
                                    sampler="power")
    return cs.make_pass(scene, camera, 24, 2, 8, depth=4)


def _layers(name: str):
    """(owner, attribute, layer) of the calls whose ops are split out."""
    if name != "families":
        return []
    from pbrt_tpu_torch.accel import api
    from pbrt_tpu_torch.lights.buffers import LightBuffers
    from pbrt_tpu_torch.materials import bxdf
    from pbrt_tpu_torch.models import path
    from pbrt_tpu_torch.samplers.samplers import Sampler

    return ([(api, "closest", "queries"), (api, "any_hit", "queries"),
             (path, "_subsurface_step", "subsurface_step"),
             (path, "_bsdf_calls", "bxdf"),
             (bxdf, "surface_params", "surface_params"),
             (Sampler, "get_1d", "rng"), (Sampler, "get_2d", "rng")]
            + [(LightBuffers, a, "lights") for a in (
                "emitted", "pdf_li_area", "sample_li", "pdf_escaped",
                "escaped_radiance")])


def count(name: str, root: str) -> dict:
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from pbrt_tpu_torch.materials import bxdf

    render_pass = _pass(name, root)
    stack = []
    counts = collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if str(func.overloadpacket) not in VIEWS:
                counts[stack[0] if stack else "other"] += 1
            return func(*args, **(kwargs or {}))

    def wrap(layer, fn):
        def inner(*args, **kw):
            if layer == "bxdf":  # by the segment's one link flag
                on = [f for f in bxdf.FLAGS if args[0].get(f)]
                tag = on[0] if len(on) == 1 else ("diffuse" if not on
                                                  else "chain")
                layer_ = "bxdf:" + tag.removeprefix("any_")
            else:
                layer_ = layer
            stack.append(layer_)
            try:
                return fn(*args, **kw)
            finally:
                stack.pop()
        return inner

    saved = [(o, a, getattr(o, a)) for o, a, _ in _layers(name)]
    with torch.no_grad():
        render_pass(0)  # warm-up
        for (o, a, fn), (_, _, layer) in zip(saved, _layers(name)):
            setattr(o, a, wrap(layer, fn))
        try:
            with Count():
                img, rays = render_pass(0)
        finally:
            for o, a, fn in saved:
                setattr(o, a, fn)
    out = {"scene": name, "non_view_ops": sum(counts.values()),
           "rays": float(rays), "image_mean": float(img.mean())}
    if len(counts) > 1:
        out["by_layer"] = dict(counts.most_common())
    return out


def main() -> int:
    args = sys.argv[1:]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if args[:1] == ["--root"]:
        root = os.path.abspath(args[1])
        args = args[2:]
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    torch.set_num_threads(4)
    for name in args or ["families"]:
        print(json.dumps({"root": root, **count(name, root)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
