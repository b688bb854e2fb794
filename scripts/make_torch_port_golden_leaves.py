#!/usr/bin/env python
"""Compute the JAX reference's gradients with respect to the scene leaves
that ROADMAP item 5e ports: the material, texture-table, light and medium
leaves (5e.1-5e.4), the surface and light leaves through the volumetric
path, the interior media and the sampling tables (5e.5-5e.8). The
PyTorch port is held against them (tests/test_torch_grad_leaves.py and
chip_smoke.py phase g12; tests/test_torch_grad_leaves_rest.py and g13).

The cases, their scenes (built by each package from the same file or
recipe) and their leaves are tests/torch_port_leaves.py's CASES; each
--which is one group and writes its file of GOLDEN_FILES:
- "materials": the families box under the attached estimator (op by op,
  as the families goldens are made) and the coated Cornell box with a
  diffuse-transmission block under remat, cvjp and attached (op by op);
- "textures": texture.pbrt, leaf_textures.pbrt and io_surfaces' Ptex
  scene under remat and cvjp;
- "lights": spot.pbrt, plymesh.pbrt, envmap.pbrt, leaf_portal.pbrt and
  leaf_lights.pbrt (the last also under attached);
- "media": the fog box's slab, an 8^3 density grid and an 8^3 RGB grid
  under VolPathIntegrator(differentiable=True);
- "volpath": through the same walk, the fog box's slab with the albedo
  and the area light's scale, the families box inside a homogeneous
  medium with every family's leaves (op by op), fog.pbrt's interior
  medium and the density grid's majorants;
- "sampling": envmap.pbrt's importance tables and leaf_lights.pbrt's
  selection pmf and cdf under remat and cvjp, and the hall cut to 16
  lights with its light BVH's node table.

The loss is the bench loss of one pass: the mean squared error of
spectrum_to_rgb against 0.25, 16x16 (media and volpath 8x8, 32-step
walks), 2 spp, 8 wavelength
lanes, seed 0, depth 5 without Russian roulette. Every case runs on the
coarse hash keys of tests/torch_port_leaves.py `keys`. Under the attached
estimator and the volumetric path the gradient follows the sampled
directions into the next hit point, so the reference's CPU triangle query
is wrapped in stop_gradient, as its accelerator answers
(make_torch_port_golden_grad.py `detached_queries`).

Each leaf's golden is the reverse-mode gradient where it is finite. Where
it is not (0 * inf through a where on dropped lanes; conductor roughness,
ROADMAP Queue 3), a leaf of at most SMALL_LEAF entries takes the
forward-mode Jacobian (jax.jacfwd), and a table the forward-mode
derivative along N_DIRS seeded directions (`directions`); cvjp, a custom
VJP, has no forward mode, so such a leaf has no cvjp golden and the port
refuses it there. Each entry records "reverse_finite_<leaf>" and, where
the forward mode ran, "forward_finite_<leaf>"; a leaf whose forward mode
is NaN too has no golden, and the port refuses it.

Usage (from the repository root; on an 8-core CPU the materials take
~40 min, the coated box's three estimators op by op, run side by side
with --only coated:remat etc., 11 / 6 / 22 min; textures ~9 min, lights
~10 min, media ~3 min; volpath ~7 min, the families box op by op ~4.5
of them; sampling ~4 min, the hall ~2.7 of them):
    JAX_PLATFORMS=cpu PBRT_TPU_NSPECTRUM=8 python scripts/make_torch_port_golden_leaves.py --which materials|textures|lights|media|volpath|sampling
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Cases made op by op (jax.disable_jit), as their earlier goldens were.
OP_BY_OP = ("families", "coated", "volfamilies")


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pbrt_tpu.core.spectrum import N_SPECTRUM

    if N_SPECTRUM != 8:
        raise SystemExit(f"set PBRT_TPU_NSPECTRUM=8 (got {N_SPECTRUM})")
    return jax


def _get(obj, path):
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _set(obj, updates):
    """obj with the leaves at dotted paths replaced (any depth)."""
    by_child = {}
    for path, value in updates.items():
        child, _, rest = path.partition(".")
        by_child.setdefault(child, {})[rest] = value
    reps = {}
    for child, leaves in by_child.items():
        reps[child] = (leaves[""] if "" in leaves
                       else _set(getattr(obj, child), leaves))
    return obj.replace(**reps)


def _loss_fn(scene, camera, integ, g):
    import jax.numpy as jnp

    from pbrt_tpu.films.rgb import spectrum_to_rgb
    from pbrt_tpu.render import camera_rays

    res, spp = g["resolution"], g["spp"]
    npix = res * res
    pixel = jnp.tile(jnp.arange(npix, dtype=jnp.int32), (spp,))
    sample = jnp.repeat(jnp.arange(spp, dtype=jnp.int32), npix)
    target = jnp.full((npix * spp, 3), g["target"], jnp.float32)
    seed = jnp.int32(g["seed"])

    def loss(params):
        s = _set(scene, params)
        o, d, wl = camera_rays(camera, pixel, sample, seed)
        radiance = integ.trace(s, o, d, wl, pixel, sample, seed)
        return jnp.mean((spectrum_to_rgb(radiance, wl) - target) ** 2)

    return loss


def case_golden(group, name, est, leaves) -> dict:
    """The entries "<name>_<est>_*" of one case."""
    jax = _jax()
    import jax.numpy as jnp

    from make_torch_port_golden_grad import detached_queries
    from tests import torch_port_leaves as TL

    g = TL.settings_of(group)
    scene, camera = TL.leaf_scene("pbrt_tpu", name, g["resolution"])
    integ = TL.integrator("pbrt_tpu", est)
    prefix = f"{name}_{est}"
    op_by_op = name in OP_BY_OP
    wrap = (lambda f: f) if op_by_op else jax.jit
    t0 = time.perf_counter()
    out = {}
    with contextlib.ExitStack() as stack:
        stack.enter_context(TL.keys("pbrt_tpu", name))
        if op_by_op:
            stack.enter_context(jax.disable_jit())
        if est in ("attached", "volpath"):
            stack.enter_context(detached_queries())
        loss = _loss_fn(scene, camera, integ, g)
        params = {p: jnp.asarray(_get(scene, p), jnp.float32) for p in leaves}
        value, rev = wrap(jax.value_and_grad(loss))(params)
        out[f"{prefix}_loss"] = np.float32(value)
        # The tangents of the leaves whose reverse mode is not finite:
        # one per entry of a small leaf, N_DIRS per table.
        basis, slots = [], []
        for p in leaves:
            k = TL.key_of(p)
            r = np.asarray(rev[p], np.float32)
            finite = bool(np.isfinite(r).all())
            out[f"{prefix}_reverse_finite_{k}"] = np.bool_(finite)
            if finite:
                out[f"{prefix}_grad_{k}"] = r
                continue
            if est == "cvjp":
                continue
            shape = params[p].shape
            if r.size <= TL.SMALL_LEAF:
                dirs = np.eye(r.size).reshape(r.size, *shape)
                slots.append((p, "grad", shape))
            else:
                dirs = TL.directions(p, shape)
                slots.append((p, "jvp", shape))
            for d in dirs:
                basis.append({q: (np.asarray(d, np.float32) if q == p else
                                  np.zeros(params[q].shape, np.float32))
                              for q in leaves})
        if basis:
            tangents = {q: jnp.asarray(np.stack([b[q] for b in basis]))
                        for q in leaves}

            def jvp(t):
                return jax.jvp(loss, (params,), (t,))[1]

            col = np.asarray(wrap(jax.vmap(jvp))(tangents), np.float32)
            at = 0
            for p, what, shape in slots:
                k = TL.key_of(p)
                n = (int(np.prod(shape)) if what == "grad" else TL.N_DIRS)
                vals = col[at:at + n]
                at += n
                finite = bool(np.isfinite(vals).all())
                out[f"{prefix}_forward_finite_{k}"] = np.bool_(finite)
                if finite:
                    out[f"{prefix}_{what}_{k}"] = (vals.reshape(shape)
                                                   if what == "grad"
                                                   else vals)

    def finite(mode):
        return [p.split(".")[-1] for p in leaves
                if out.get(f"{prefix}_{mode}_finite_{TL.key_of(p)}")]

    print(f"{prefix}: loss {float(value):.6f}, "
          f"{time.perf_counter() - t0:.1f} s, reverse finite "
          f"{finite('reverse')}, forward finite {finite('forward')}",
          flush=True)
    return out


def main() -> None:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from tests import torch_port_leaves as TL

    ap = argparse.ArgumentParser()
    ap.add_argument("--which", required=True, choices=sorted(TL.GOLDEN_FILES))
    ap.add_argument("--only", default=None,
                    help="comma-separated scene names or scene:estimator "
                         "pairs (a partial run, merged into the file)")
    a = ap.parse_args()
    path = TL.GOLDEN_FILES[a.which]
    only = a.only.split(",") if a.only else None
    out = {k: np.asarray(v) for k, v in TL.settings_of(a.which).items()}
    ran = []
    for group, name, est, leaves in TL.cases(a.which):
        if only and name not in only and f"{name}:{est}" not in only:
            continue
        out.update(case_golden(group, name, est, leaves))
        ran.append(f"{name}_{est}_")
    for key, v in out.items():
        if ("_grad_" in key or "_jvp_" in key or key.endswith("loss")) \
                and not np.all(np.isfinite(v)):
            raise SystemExit(f"golden {key} is not finite")
    if only and os.path.exists(path):
        # A partial run replaces its cases' entries. The file is read only
        # now, so partial runs of other cases may run beside it.
        out = {**{k: v for k, v in np.load(path).items()
                  if not k.startswith(tuple(ran))}, **out}
    np.savez_compressed(path, **out)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
