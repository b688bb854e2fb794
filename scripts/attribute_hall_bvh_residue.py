#!/usr/bin/env python
"""Attribute the many-light hall's light-BVH residue against its JAX
golden: which pixel values disagree, and whether the light BVH chose
another light there.

chip_smoke.py phase d18 renders the hall (scenes/manylight.py, 2,048 area
lights) with the light-BVH sampler at 32x32, 4 spp, depth 4, 8 lanes, the
layered walk on coarse keys, against
tests/data/torch_port/manylight32_bvh_spp4.npy; a few pixel values fall
outside rtol 1e-3 / atol 1e-5 where the power sampler's render has none.
This script makes the same render with the port on the CPU, records every
light selection of its NEE (LightBuffers.select: the shading point, its
normal, the selection uniform and the light chosen), hands the same
inputs to the reference's LightBuffers.select, and reports:

- the pixel values outside the gate, and their pixels;
- per bounce, the lanes whose chosen light differs between the packages
  (and the largest relative difference of the pmf where the same light is
  chosen);
- which outlier pixels hold such a lane, and which do not;
- the pixels whose samples key a layered walk (materials/layered.py) of a
  coated lane on a fragile coarse key: a direction component (x or z) of
  wo or wi within FRAGILE_ABS of a value where its kept top 16 bits
  change (small components have fine quanta), so that a
  last-bit difference between the pipelines re-keys the walk (the
  coarse keys' residue, tests/torch_port_coated.py), and which outlier
  pixels are among them.

An outlier pixel explained by neither points at a fault elsewhere. The
render runs the lockstep shading chain (bit-equal to the sorted dispatch,
tests/test_torch_manylight.py), so a walk's lanes are the bounce's rays
in order. Usage (from the repository root, ~1-2 minutes on the CPU):

    JAX_PLATFORMS=cpu python scripts/attribute_hall_bvh_residue.py [--res 32]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# A coarse key component is fragile within this distance of a value
# where its kept bits change: a few ulps of a unit-length component, the
# size of the pipelines' rounding differences in a shading-frame
# direction (dot products of unit vectors).
FRAGILE_ABS = 4.0 * 2.0 ** -24


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=32)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from pbrt_tpu.scenes.manylight import manylight_scene as jax_hall
    from pbrt_tpu_torch.lights.buffers import LightBuffers
    from pbrt_tpu_torch.materials import bxdf, layered
    from pbrt_tpu_torch.materials.buffers import (MAT_COATEDCONDUCTOR,
                                                  MAT_COATEDDIFFUSE)
    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.render import render
    from pbrt_tpu_torch.scenes.manylight import manylight_scene
    from tests.torch_port_coated import coarse_walk_keys

    res, spp, depth = args.res, 4, 4
    golden = np.load(os.path.join(ROOT, "tests", "data", "torch_port",
                                  "manylight32_bvh_spp4.npy"))
    scene, camera = manylight_scene(resolution=(res, res), sampler="bvh")
    jscene, _ = jax_hall(resolution=(res, res), sampler="bvh")

    calls = []
    select = LightBuffers.select

    def recording(self, p_ref, n_ref, u_select):
        idx, pmf = select(self, p_ref, n_ref, u_select)
        calls.append((p_ref.clone(), n_ref.clone(), u_select.clone(),
                      idx.clone(), pmf.clone()))
        return idx, pmf

    fragile = []
    walks = {name: getattr(bxdf, name) for name in
             ("_coated_diffuse_walk", "_coated_conductor_walk")}

    def recording_walk(walk, kind):
        def run(params, *args):
            wo, wi = args[-2:]
            comps = torch.stack([w[..., c] for w in (wo, wi) for c in (0, 2)],
                                dim=-1)
            # The raw bit pattern (layered._bits is the coarse one here);
            # the two values where the kept bits change around x.
            bits = comps.contiguous().view(torch.int32).to(torch.int64)
            lo = (bits & ~0xFFFF).to(torch.int32).view(torch.float32)
            hi = ((bits & ~0xFFFF) + 0x10000).to(torch.int32).view(
                torch.float32)
            dist = torch.minimum(torch.abs(comps - lo), torch.abs(hi - comps))
            # An exact zero (a miss's degenerate frame) rounds alike.
            near = (dist < FRAGILE_ABS) & (comps != 0.0)
            live = (torch.sum(wo * wo, dim=-1) > 0.5) \
                & (torch.sum(wi * wi, dim=-1) > 0.5)
            fragile.append(torch.any(near, dim=-1) & live
                           & (params["kind"] == kind))
            return walk(params, *args)
        return run

    pmf_calls = []
    selection_pmf = LightBuffers.selection_pmf

    def recording_pmf(self, light_idx, p_ref=None, n_ref=None):
        pm = selection_pmf(self, light_idx, p_ref, n_ref)
        pmf_calls.append((light_idx.clone(), p_ref.clone(), n_ref.clone(),
                          pm.clone()))
        return pm

    LightBuffers.select = recording
    LightBuffers.selection_pmf = recording_pmf
    for name, kind in (("_coated_diffuse_walk", MAT_COATEDDIFFUSE),
                       ("_coated_conductor_walk", MAT_COATEDCONDUCTOR)):
        setattr(bxdf, name, recording_walk(walks[name], kind))
    try:
        with coarse_walk_keys(layered):
            img = render(scene, camera,
                         PathIntegrator(max_depth=depth, rr_start_depth=depth,
                                        sorted_shading=False),
                         spp=spp, samples_per_pass=spp, seed=0, n_spectrum=8,
                         device="cpu").numpy()
    finally:
        LightBuffers.select = select
        LightBuffers.selection_pmf = selection_pmf
        for name, walk in walks.items():
            setattr(bxdf, name, walk)

    npix = res * res
    bad = ~(np.abs(img - golden) <= 1e-5 + 1e-3 * np.abs(golden))
    bad_pixels = sorted(set(np.nonzero(bad.any(-1).ravel())[0].tolist()))
    report = {"resolution": res, "spp": spp, "max_depth": depth,
              "values": int(bad.size), "outlier_values": int(bad.sum()),
              "share_within": float(1.0 - bad.mean()),
              "outlier_pixels": bad_pixels, "bounces": []}
    differing_pixels = set()
    for bounce, (p, n, u, idx, pmf) in enumerate(calls):
        jidx, jpmf = jscene.lights.select(jnp.asarray(p.numpy()),
                                          jnp.asarray(n.numpy()),
                                          jnp.asarray(u.numpy()))
        jidx, jpmf = np.asarray(jidx), np.asarray(jpmf)
        diff = idx.numpy() != jidx
        same = ~diff & (jpmf > 0)
        rel = np.abs(pmf.numpy()[same] - jpmf[same]) / jpmf[same]
        lanes = np.nonzero(diff)[0]
        pixels = sorted(set((lanes % npix).tolist()))
        differing_pixels.update(pixels)
        report["bounces"].append({
            "bounce": bounce, "lanes": int(idx.shape[0]),
            "differing_choices": int(diff.sum()),
            "pixels": pixels,
            "pmf_rel_diff_max_same_light": float(rel.max()) if rel.size else 0.0,
        })
    # The pmf of a light that a BSDF-sampled ray hit (MIS), replayed down
    # the BVH: the packages' answers for the same light and point.
    report["mis_pmf"] = []
    for light, p, n, pm in pmf_calls:
        jpm = np.asarray(jscene.lights.selection_pmf(
            jnp.asarray(light.numpy()), jnp.asarray(p.numpy()),
            jnp.asarray(n.numpy())))
        pm = pm.numpy()
        off = np.abs(pm - jpm) > 1e-4 * np.maximum(np.abs(jpm), 1e-30)
        lanes = np.nonzero(off & (light.numpy() >= 0))[0]
        pixels = sorted(set((lanes % npix).tolist()))
        differing_pixels.update(pixels)
        report["mis_pmf"].append({"lanes_off": int(lanes.size),
                                  "pixels": pixels})
    report["outlier_pixels_with_a_differing_choice"] = sorted(
        set(bad_pixels) & differing_pixels)
    report["outlier_pixels_without_a_differing_choice"] = sorted(
        set(bad_pixels) - differing_pixels)
    report["differing_choice_pixels_within_gate"] = sorted(
        differing_pixels - set(bad_pixels))
    n = npix * spp
    lanes = torch.zeros(n, dtype=torch.bool)
    for f in fragile:
        if f.shape[0] == n:  # every walk runs on the bounce's whole batch
            lanes |= f
    fragile_pixels = set((torch.nonzero(lanes).squeeze(1) % npix).tolist())
    report["walk_calls"] = len(fragile)
    report["fragile_key_pixels"] = len(fragile_pixels)
    report["fragile_key_pixel_share"] = len(fragile_pixels) / npix
    report["outlier_pixels_with_a_fragile_walk_key"] = sorted(
        set(bad_pixels) & fragile_pixels)
    report["outlier_pixels_explained_by_neither"] = sorted(
        set(bad_pixels) - fragile_pixels - differing_pixels)
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
