"""The port's large-mesh forward slice against the JAX reference on the CPU:
a killeroo-class scene (the materials, lights and camera of
killeroo_class_scene around meshes of 2,724 triangles), built by each
package from its own builders, through the cluster accelerator (K2's twin)
on the port's side, the conductor BxDF and the uniform infinite light. The
reference answers its queries with its dense tester, its CPU path for a
scene without an accelerator: jit-compiling its path integrator around
the Pallas cluster kernel in interpret mode took most of this file's time,
and the twin is held against that kernel in tests/test_torch_cluster.py.

The same samples also go through the BVH tier (K4's twin, the cluster
tier dropped), against the same reference answers.

The full 122,244-triangle scene is rendered against the committed JAX
golden on the card only (chip_smoke.py phases d2 and d4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core.spectrum import N_SPECTRUM
from pbrt_tpu.films.rgb import spectrum_to_rgb as jax_spectrum_to_rgb
from pbrt_tpu.models.path import PathIntegrator as JPathIntegrator
from pbrt_tpu.render import camera_rays_full as jax_camera_rays
from pbrt_tpu_torch.accel.bvh import build_bvh
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.ops import cluster, traverse
from pbrt_tpu_torch.render import camera_rays_full, render

from .torch_port_helpers import share_close
from .torch_port_killeroo import small_killeroo_class_scene

torch.set_num_threads(2)
RES, SPP = 12, 2


@pytest.fixture(scope="module")
def traced():
    """The reference's and the port's per-sample radiance and ray counts on
    the same pixels and samples (one pass of SPP samples)."""
    js, jc = small_killeroo_class_scene("pbrt_tpu", (RES, RES))
    js = js.replace(clusters=None)
    ps, pc = small_killeroo_class_scene("pbrt_tpu_torch", (RES, RES))
    assert ps.clusters is not None
    assert ps.small is None and ps.lights.has_infinite
    npix = RES * RES
    pixel = np.tile(np.arange(npix, dtype=np.int32), SPP)
    sample = np.repeat(np.arange(SPP, dtype=np.int32), npix)
    jpix, jsam = jnp.asarray(pixel), jnp.asarray(sample)
    o, d, wl, _ = jax_camera_rays(jc, jpix, jsam, 0)
    j_integ = JPathIntegrator(max_depth=5)
    trace = jax.jit(lambda s, o, d, wl: j_integ.trace_with_stats(
        s, o, d, wl, jpix, jsam, 0))
    jL, jstats = trace(js, o, d, wl)
    jrgb = np.asarray(jax_spectrum_to_rgb(jL, wl))

    tpix, tsam = torch.from_numpy(pixel), torch.from_numpy(sample)
    po, pd, pwl, _ = camera_rays_full(pc, tpix, tsam, 0, n_spectrum=N_SPECTRUM)
    cluster.STATS.reset()
    pL, pstats = PathIntegrator(max_depth=5).trace_with_stats(
        ps, po, pd, pwl, tpix, tsam, 0
    )
    assert cluster.STATS.launches == 0  # the CPU path takes the twin
    return (np.asarray(jL), float(jstats["rays"]), jrgb), (pL, float(pstats["rays"])), (ps, pc)


def _pixels_and_samples():
    npix = RES * RES
    return (torch.arange(npix).repeat(SPP),
            torch.arange(SPP).repeat_interleave(npix))


def _assert_samples_match(pL, p_rays, jL, j_rays):
    assert pL.shape == (SPP * RES * RES, N_SPECTRUM)
    assert torch.isfinite(pL).all()
    assert abs(p_rays - j_rays) <= 0.005 * j_rays, (p_rays, j_rays)
    sample_ok = np.all(np.abs(pL.numpy() - jL) <= 1e-5 + 1e-3 * np.abs(jL), axis=-1)
    n_bad = int(np.sum(~sample_ok))
    print(f"samples disagreeing with the reference: {n_bad} of {len(sample_ok)}")
    assert np.mean(sample_ok) >= 0.99, n_bad
    # The scene's escaped rays see the infinite light: radiance everywhere.
    assert np.mean(jL.max(axis=-1) > 0.0) > 0.9


def test_trace_with_stats_per_sample(traced):
    (jL, j_rays, _), (pL, p_rays), _ = traced
    _assert_samples_match(pL, p_rays, jL, j_rays)


def test_bvh_tier_trace_per_sample(traced):
    """The BVH tier answers every query of the pass (K4's twin on the
    CPU): the same closest surfaces, so the same samples."""
    (jL, j_rays, _), _, (ps, pc) = traced
    scene = ps.replace(clusters=None,
                       bvh=build_bvh(ps.geom.tri_verts.numpy()))
    assert scene.bvh.depth == 10  # 2,724 triangles in 681 leaves
    tpix, tsam = _pixels_and_samples()
    po, pd, pwl, _ = camera_rays_full(pc, tpix, tsam, 0, n_spectrum=N_SPECTRUM)
    traverse.STATS.reset()
    cluster.STATS.reset()
    pL, pstats = PathIntegrator(max_depth=5).trace_with_stats(
        scene, po, pd, pwl, tpix, tsam, 0)
    assert traverse.STATS.launches == 0 and cluster.STATS.launches == 0
    _assert_samples_match(pL, float(pstats["rays"]), jL, j_rays)


def test_render_image(traced):
    """The port's render against the reference's samples developed as the
    reference's render develops one pass of finite samples: its film's
    spectrum_to_rgb, averaged per pixel."""
    (_, _, jrgb), _, (ps, pc) = traced
    assert np.all(np.isfinite(jrgb))
    want = jrgb.reshape(SPP, RES, RES, 3).mean(axis=0)
    got = render(ps, pc, PathIntegrator(max_depth=5), spp=SPP,
                 samples_per_pass=SPP, seed=0, n_spectrum=N_SPECTRUM,
                 device="cpu").numpy()
    assert got.shape == want.shape == (RES, RES, 3)
    share, n_bad = share_close(got, want, rtol=1e-3, atol=1e-5)
    print(f"pixel values disagreeing with the reference: {n_bad}")
    assert share >= 0.99, n_bad
