"""Analytic spheres in the port against the reference on the CPU: the ULP
stepping and interval arithmetic bit for bit, the interval-arithmetic
sphere test, the sphere merges of closest / any-hit, and the golden scene
file conductor.pbrt (two conductor spheres over a diffuse floor under a
triangle area light) built and rendered. chip_smoke.py phase d5 renders
that file on the card against the pbrt-v4 C++ golden. The reference's renders are committed
(tests/data/torch_port/reference_answers.npz, made by
scripts/make_torch_port_golden_answers.py from this file's inputs; the
test checks a digest of the reference's scene, camera and settings,
built live here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.accel import api as jax_api
from pbrt_tpu.accel import dense as jax_dense
from pbrt_tpu.core import floats as jax_floats
from pbrt_tpu.core import interval as jax_interval
from pbrt_tpu.core.spectrum import N_SPECTRUM
from pbrt_tpu.io.parser import load_pbrt as jax_load_pbrt
from pbrt_tpu.lights.buffers import LightBuffers as JLightBuffers
from pbrt_tpu.materials.buffers import MaterialBuffers as JMaterialBuffers
from pbrt_tpu.scene import Scene as JScene
from pbrt_tpu.shapes.geometry import GeometryBuffers as JGeometryBuffers
from pbrt_tpu_torch.accel import api, dense
from pbrt_tpu_torch.core import floats, interval
from pbrt_tpu_torch.io.image import read_pfm
from pbrt_tpu_torch.io.parser import load_pbrt
from pbrt_tpu_torch.lights.buffers import LightBuffers
from pbrt_tpu_torch.materials.buffers import MaterialBuffers
from pbrt_tpu_torch.render import render
from pbrt_tpu_torch.scene import Scene
from pbrt_tpu_torch.shapes.geometry import GeometryBuffers, make_quad

from .torch_port_helpers import reference_answers, render_digest, share_close

torch.set_num_threads(2)
CONDUCTOR = "tests/goldens/conductor.pbrt"
# conductor.pbrt's render against the reference (at 12x12).
CONDUCTOR_KW = dict(spp=2, samples_per_pass=2, seed=0)
# Two spheres and a floor, the conductor scene's layout.
SPHERES = np.array([[-0.8, 0.6, 0.0, 0.6], [0.8, 0.6, 0.0, 0.6]], np.float32)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _same_bits(got, want, what):
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want), what)


def test_next_float_bit_equal():
    r = np.random.default_rng(0)
    x = np.concatenate([
        np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, 3.4028235e38,
                  -3.4028235e38, 1.1754944e-38, -1.1754944e-38], np.float32),
        (r.normal(size=512) * 10.0 ** r.integers(-30, 30, 512)).astype(np.float32),
    ])
    for name in ("next_float_up", "next_float_down"):
        got = getattr(floats, name)(torch.from_numpy(x))
        _same_bits(got, np.asarray(getattr(jax_floats, name)(jnp.asarray(x))),
                   name)


def _intervals(r, n):
    """n random intervals, some straddling or touching 0, some exact."""
    a = r.normal(size=n).astype(np.float32) * 3
    w = np.abs(r.normal(size=n)).astype(np.float32)
    w[::5] = 0.0
    lo, hi = a - w, a + w
    lo[::7], hi[::7] = 0.0, w[::7]
    return lo.astype(np.float32), hi.astype(np.float32)


def test_interval_ops_bit_equal():
    r = np.random.default_rng(1)
    n = 1024
    (alo, ahi), (blo, bhi) = _intervals(r, n), _intervals(r, n)
    ja = jax_interval.Interval(lo=jnp.asarray(alo), hi=jnp.asarray(ahi))
    jb = jax_interval.Interval(lo=jnp.asarray(blo), hi=jnp.asarray(bhi))
    pa = interval.Interval(lo=torch.from_numpy(alo), hi=torch.from_numpy(ahi))
    pb = interval.Interval(lo=torch.from_numpy(blo), hi=torch.from_numpy(bhi))
    cases = {
        "add": (pa + pb, ja + jb), "sub": (pa - pb, ja - jb),
        "mul": (pa * pb, ja * jb), "div": (pa / pb, ja / jb),
        "neg": (-pa, -ja), "sqr": (pa.sqr(), ja.sqr()),
        "sqrt": (pa.sqrt(), ja.sqrt()), "scalar": (pa * 2.0, ja * 2.0),
        "error": (interval.Interval.from_value_and_error(pa.lo, pb.hi.abs()),
                  jax_interval.Interval.from_value_and_error(ja.lo,
                                                             jnp.abs(jb.hi))),
    }
    for name, (got, want) in cases.items():
        _same_bits(got.lo, want.lo, name + " lo")
        _same_bits(got.hi, want.hi, name + " hi")
    got = interval.interval_quadratic(pa, pb, pa * pb)
    want = jax_interval.interval_quadratic(ja, jb, ja * jb)
    for k in range(2):
        _same_bits(got[k].lo, want[k].lo, f"t{k} lo")
        _same_bits(got[k].hi, want[k].hi, f"t{k} hi")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < int(got[2].sum()) < n


def _sphere_rays(n=1024, seed=2):
    """Rays from around the sphere pair: aimed at points near the spheres
    (hits, grazing misses), random directions, finite segments, rays from
    inside a sphere and dead lanes (tmax = 0)."""
    r = np.random.default_rng(seed)
    o = r.uniform(-3.0, 3.0, (n, 3)) + np.array([0.0, 1.5, -2.0])
    target = SPHERES[r.integers(0, 2, n), :3] + r.normal(scale=0.5, size=(n, 3))
    d = target - o
    d[::4] = r.normal(size=(len(d[::4]), 3))
    o[::6] = SPHERES[0, :3] + r.normal(scale=0.2, size=(len(o[::6]), 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n, np.inf)
    tmax[::5] = r.uniform(0.5, 4.0, len(tmax[::5]))
    tmax[::9] = 0.0
    return (o.astype(np.float32), d.astype(np.float32),
            tmax.astype(np.float32))


def test_sphere_block_matches():
    o, d, tmax = _sphere_rays()
    jblk, _ = jax_dense._sph_soa(jnp.asarray(SPHERES))
    want = np.asarray(jax_dense._intersect_sph_block(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jblk))[:, :2]
    blk, s = dense._sph_soa(torch.from_numpy(SPHERES))
    got = dense._intersect_sph_block(torch.from_numpy(o), torch.from_numpy(d),
                                     torch.from_numpy(tmax), blk).numpy()
    assert s == 2 and got.shape == (len(o), 2)
    hit = np.isfinite(want)
    assert 0.2 < hit.any(axis=1).mean() < 0.9
    np.testing.assert_array_equal(np.isfinite(got), hit)
    # The Newton steps' multiply-adds may fuse in XLA: rtol 1e-6.
    np.testing.assert_allclose(got[hit], want[hit], rtol=1e-6)


def _scenes():
    """The floor quad and the sphere pair, diffuse floor and two
    conductors, in both packages, with the small tier (K1) attached."""
    floor = make_quad((-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8))
    geo = dict(tri_verts=floor, tri_mat=np.zeros(2, np.int32),
               spheres=SPHERES, sph_mat=np.array([1, 2], np.int32))
    mats = [{"kind": 0}, {"kind": 1, "roughness": 0.15},
            {"kind": 1, "roughness": 0.004}]
    js = JScene(geom=JGeometryBuffers.build(**geo),
                materials=JMaterialBuffers.build(mats),
                lights=JLightBuffers.build()).with_accel()
    ps = Scene(geom=GeometryBuffers.build(**geo),
               materials=MaterialBuffers.build(mats),
               lights=LightBuffers.build()).with_accel()
    assert ps.small is not None and ps.geom.num_spheres == 2
    assert ps.shaded_kinds == {0, 1}
    return js, ps


def test_closest_and_any_hit_merge_spheres():
    js, ps = _scenes()
    o, d, tmax = _sphere_rays(seed=4)
    want = jax_api.closest(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    got = api.closest(ps, torch.from_numpy(o), torch.from_numpy(d),
                      torch.from_numpy(tmax))
    prim = np.asarray(want.prim)
    np.testing.assert_array_equal(got.prim.numpy(), prim)
    sph = prim >= 2
    assert 0.1 < sph.mean() and np.any(prim == 3) and np.any(prim < 2)
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(want.mat))
    np.testing.assert_array_equal(got.light.numpy(), np.asarray(want.light))
    np.testing.assert_allclose(got.t.numpy()[sph], np.asarray(want.t)[sph],
                               rtol=1e-6)
    # The reference answers the floor with its watertight tester on the
    # CPU, the port with Moller-Trumbore (K1's twin): t agrees to 1e-6 (at
    # most 8.5e-7 here, on hits at t < 0.2).
    floor = (prim >= 0) & ~sph
    np.testing.assert_allclose(got.t.numpy()[floor], np.asarray(want.t)[floor],
                               rtol=2e-6, atol=1e-6)
    valid = prim >= 0
    # Unit normals and the spherical uv go through sqrt, atan2 and acos.
    np.testing.assert_allclose(got.n.numpy()[valid], np.asarray(want.n)[valid],
                               atol=2e-6)
    np.testing.assert_allclose(got.uv.numpy()[sph], np.asarray(want.uv)[sph],
                               atol=2e-6)
    occ = api.any_hit(ps, torch.from_numpy(o), torch.from_numpy(d),
                      torch.from_numpy(tmax)).numpy()
    np.testing.assert_array_equal(occ, np.asarray(jax_api.any_hit(
        js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))))


def conductor_reference_inputs(loaded=None):
    """The reference's conductor.pbrt scene, camera at 12x12 and
    integrator (render() with CONDUCTOR_KW renders them)."""
    js, jc, jset = loaded or jax_load_pbrt(CONDUCTOR)
    return js, jc.replace(resolution=(12, 12)), jset["integrator"]


@pytest.fixture(scope="module")
def conductor():
    return jax_load_pbrt(CONDUCTOR), load_pbrt(CONDUCTOR, device="cpu")


def test_conductor_file_renders_like_jax(conductor):
    """12x12, 2 spp of conductor.pbrt in both packages (the build itself is
    held bit for bit by tests/test_torch_parser.py)."""
    (js, jc, jset), (ps, pc, pset) = conductor
    assert ps.geom.num_spheres == 2 and ps.small is not None
    want = reference_answers("render/conductor.pbrt", render_digest(
        *conductor_reference_inputs((js, jc, jset)), **CONDUCTOR_KW))["img"]
    got = render(ps, pc.replace(resolution=(12, 12)), pset["integrator"],
                 n_spectrum=N_SPECTRUM, device="cpu", **CONDUCTOR_KW).numpy()
    assert got.shape == want.shape == (12, 12, 3) and np.isfinite(got).all()
    share, n_bad = share_close(got, want, rtol=1e-3, atol=1e-5)
    print(f"pixel values disagreeing with the reference: {n_bad}")
    assert share >= 0.99, n_bad


def test_read_pfm_matches():
    from pbrt_tpu.io.image import read_pfm as jax_read_pfm

    path = "tests/goldens/conductor_ref.pfm"
    got = read_pfm(path)
    assert got.shape == (64, 64, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_read_pfm(path))
