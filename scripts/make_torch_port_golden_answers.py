#!/usr/bin/env python
"""Compute the reference's answers to the costliest live calls of the
port's CPU tests, from the tests' own inputs, and commit them.

Each answer is stored under "<key>/<name>" beside "<key>/digest", a
digest of the inputs it was computed from; the test rebuilds those inputs
live and checks the digest before it compares
(tests/torch_port_helpers.py::reference_answers). The keys:

- "k1/<mode>", "k2/<mode>", "k3/<kind>-<mode>": the Pallas intersection
  kernels in interpret mode (ops/smallscene.py, ops/cluster.py's
  non-deferred call, ops/sweep.py instanced and flat), closest and
  any-hit, on the inputs of tests/test_torch_smallscene.py,
  test_torch_cluster.py and test_torch_sweep.py;
- "trace/<scene>": the jitted trace_with_stats of
  tests/torch_port_helpers.py::jax_trace on the scenes of
  tests/test_torch_dielectric.py and test_torch_textures.py (16x16, 2
  spp), test_torch_killeroo.py and test_torch_instanced.py (12x12, 2 spp)
  and test_torch_slice.py (16x16, 2 spp);
- "render/<scene>": render() of spot.pbrt and envmap.pbrt (16x16, 4 spp;
  tests/test_torch_envmap.py), conductor.pbrt (12x12, 2 spp;
  tests/test_torch_spheres.py) and the Cornell box (16x16, 4 spp;
  tests/test_torch_slice.py);
- "grad/cornell8": the bench loss's jitted value_and_grad on Cornell
  8x8 (tests/test_torch_grad.py::jax_loss_and_grads).

It writes tests/data/torch_port/reference_answers.npz. Run it as the tests
run the reference: on the CPU, PBRT_TPU_NSPECTRUM unset (32 lanes).

Usage (from the repository root, ~6 min):
    JAX_PLATFORMS=cpu python scripts/make_torch_port_golden_answers.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    if "PBRT_TPU_NSPECTRUM" in os.environ:
        raise SystemExit("unset PBRT_TPU_NSPECTRUM: the tests run the "
                         "reference at its default lane count")
    os.chdir(ROOT)  # the tests name their files from the root
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pbrt_tpu.models.path import PathIntegrator as JPathIntegrator
    from pbrt_tpu.ops.cluster import _cluster_intersect_impl
    from pbrt_tpu.ops.smallscene import _smallscene_intersect_impl
    from pbrt_tpu.ops.sweep import _sweep_intersect_impl
    from pbrt_tpu.render import render as jax_render
    from tests import test_torch_cluster as t2
    from tests import test_torch_dielectric as tdiel
    from tests import test_torch_envmap as tenv
    from tests import test_torch_grad as tgrad
    from tests import test_torch_instanced as tinst
    from tests import test_torch_killeroo as tkill
    from tests import test_torch_smallscene as t1
    from tests import test_torch_spheres as tsph
    from tests import test_torch_sweep as t3
    from tests import test_torch_slice as tslice
    from tests import test_torch_textures as ttex
    from tests.torch_port_helpers import (
        ANSWERS,
        jax_trace,
        render_digest,
        trace_digest,
    )

    out = {}

    def put(key, digest, answers):
        out[f"{key}/digest"] = np.asarray(digest)
        for name, value in answers.items():
            out[f"{key}/{name}"] = np.asarray(value)

    def timed(label, fn):
        t0 = time.perf_counter()
        fn()
        print(f"{label} {time.perf_counter() - t0:.1f} s", flush=True)

    modes = (("closest", False), ("any_hit", True))

    def k1():
        _, jaccel, o, d, tmax = t1.build_case()
        for case, any_hit in modes:
            put(f"k1/{case}", t1.pallas_inputs_digest(jaccel, o, d, tmax),
                _smallscene_intersect_impl(
                    jaccel, jnp.asarray(o), jnp.asarray(d),
                    jnp.asarray(tmax), any_hit=any_hit, interpret=True))

    def k2():
        jacc = t2.jax_build_clusters(*t2.build_mesh())
        o, d, tmax = t2._rays()
        for case, any_hit in modes:
            put(f"k2/{case}", t2.pallas_inputs_digest(jacc, o, d, tmax),
                _cluster_intersect_impl(
                    jacc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
                    any_hit=any_hit, interpret=True, defer_attrs=False))

    def k3():
        o, d, tmax = t3._rays()
        for kind, (_, jacc, _) in t3.build_sweeps().items():
            for case, any_hit in modes:
                put(f"k3/{kind}-{case}", t3.pallas_inputs_digest(
                    jacc, o, d, tmax), _sweep_intersect_impl(
                        jacc, jnp.asarray(o), jnp.asarray(d),
                        jnp.asarray(tmax), any_hit=any_hit, interpret=True))

    def traces():
        path = JPathIntegrator
        scenes = {}
        for name in ("spheres.pbrt", "dielectric.pbrt"):
            js, jc, _, _, depth = tdiel._file_pair(name)
            scenes[name] = (js, jc, path(max_depth=depth), 16, 2)
        js, jc = tdiel.gallery_reference_inputs()
        scenes["mesh_gallery"] = (js, jc, path(max_depth=5), 16, 2)
        for name in ("texture.pbrt", "imagetex.pbrt"):
            js, jc, depth = ttex.file_reference_inputs(name)
            scenes[name] = (js, jc, path(max_depth=depth), 16, 2)
        scenes["killeroo12"] = (*tkill.reference_inputs(), tkill.RES,
                                tkill.SPP)
        scenes["instanced12"] = (*tinst.load_pair()[0], tinst.RES, tinst.SPP)
        scenes["cornell16"] = (*tslice.reference_inputs(), path(max_depth=5),
                               16, 2)
        for name, args in scenes.items():
            put(f"trace/{name}", trace_digest(*args), jax_trace(*args))

    def renders():
        cases = {name: (*tenv.render_reference_inputs(name), tenv.RENDER_KW)
                 for name in ("spot.pbrt", "envmap.pbrt")}
        cases["conductor.pbrt"] = (*tsph.conductor_reference_inputs(),
                                   tsph.CONDUCTOR_KW)
        cases["cornell16"] = (*tslice.reference_inputs(),
                              JPathIntegrator(max_depth=5), tslice.RENDER_KW)
        for name, (js, jc, integ, kw) in cases.items():
            put(f"render/{name}", render_digest(js, jc, integ, **kw),
                {"img": jax_render(js, jc, integ, **kw)})

    def grad():
        js, jc = tgrad.reference_inputs()
        put("grad/cornell8", tgrad.reference_digest(js, jc),
            tgrad.jax_loss_and_grads(js, jc))

    for label, fn in (("k1", k1), ("k2", k2), ("k3", k3), ("traces", traces),
                      ("renders", renders), ("grad", grad)):
        timed(label, fn)
    np.savez_compressed(ANSWERS, **out)
    print(len(out), "arrays ->", ANSWERS)


if __name__ == "__main__":
    main()
