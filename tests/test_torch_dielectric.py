"""The dielectric and thin-dielectric BxDFs of the port against the
reference on the CPU, on the same numpy-seeded inputs: the Fresnel term,
refraction, f, pdf and sampling (smooth and rough, wo on both sides, eta
below and above 1, total internal reflection), the side-dependent IOR of
surface_params with the exit hits of rays inside a sphere, and per-sample
renders of spheres.pbrt, dielectric.pbrt and the mesh gallery (subdiv 1)
at 16x16, 2 spp. The reference's per-sample traces are committed
(tests/data/torch_port/reference_answers.npz, made by
scripts/make_torch_port_golden_answers.py from this file's inputs; the
test checks a digest of the reference's scene, camera and settings,
built live here).

Tolerances: the Fresnel term, refraction and the thin slab within rtol
1e-5 / atol 1e-6. The rough f and pdf at given directions within rtol
1e-5 / atol 1e-6 on >= 99.5% of the lanes and 1e-3 on all: where the
generalized half-vector cancels (wi.wm + wo.wm / eta near 0) one ulp of
wm grows past 1e-5. Sampled directions within 5e-6 absolute off the
disk's rim (as the conductor's, tests/test_torch_conductor.py); the
sampled f and pdf within rtol 5e-3 and their ratio, the path's
throughput weight, within 1e-4: at alpha ~0.01 the lobe turns the
direction's 1e-6 into 3.5e-3 of f and of pdf alike. Renders: the same ray
count and >= 99% of per-sample values within rtol 1e-3 / atol 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.accel import api as jax_api
from pbrt_tpu.core import spectrum as jspec
from pbrt_tpu.core import vecmath as jvm
from pbrt_tpu.io.parser import load_pbrt as jax_load_pbrt
from pbrt_tpu.lights.buffers import LightBuffers as JLightBuffers
from pbrt_tpu.materials import bxdf as jbxdf
from pbrt_tpu.materials import scattering as jsc
from pbrt_tpu.materials.buffers import MaterialBuffers as JMaterialBuffers
from pbrt_tpu.scene import Scene as JScene
from pbrt_tpu.scenes.meshes import mesh_gallery_scene as jax_mesh_gallery
from pbrt_tpu.shapes.geometry import GeometryBuffers as JGeometryBuffers
from pbrt_tpu_torch.accel import api
from pbrt_tpu_torch.core import spectrum, vecmath
from pbrt_tpu_torch.core.sampling import sample_uniform_disk_concentric
from pbrt_tpu_torch.io.parser import load_pbrt
from pbrt_tpu_torch.lights.buffers import LightBuffers
from pbrt_tpu_torch.materials import bxdf
from pbrt_tpu_torch.materials import scattering as sc
from pbrt_tpu_torch.materials.buffers import MaterialBuffers
from pbrt_tpu_torch.scene import Scene
from pbrt_tpu_torch.scenes.meshes import mesh_gallery_scene
from pbrt_tpu_torch.shapes.geometry import GeometryBuffers, make_quad

from .torch_port_helpers import assert_samples_match, share_close, trace_pair

torch.set_num_threads(2)
N = 4096
S = jspec.N_SPECTRUM
COS_MIN = 0.1
GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def _unit(r, n, cos_min=COS_MIN):
    v = r.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    bad = np.abs(v[:, 2]) < cos_min
    v[bad, 2] = np.sign(v[bad, 2] + 1e-9) * cos_min * 2
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _inputs(seed):
    """wo and wi on both sides of the surface, eta in [0.5, 2.5] (below 1:
    the denser medium on the normal's side), a third of the lanes smooth."""
    r = np.random.default_rng(seed)
    eta = r.uniform(0.5, 2.5, N).astype(np.float32)
    alpha = r.uniform(0.01, 0.9, N).astype(np.float32)
    alpha[::3] = 0.0
    return r, eta, alpha, _unit(r, N), _unit(r, N)


def test_fresnel_and_refraction_match():
    r = np.random.default_rng(0)
    cos = r.uniform(-1, 1, N).astype(np.float32)
    eta = r.uniform(0.5, 2.5, N).astype(np.float32)
    _close(sc.fr_dielectric(_t(cos), _t(eta)),
           jsc.fr_dielectric(jnp.asarray(cos), jnp.asarray(eta)))
    wi, n = _unit(r, N, 0.0), _unit(r, N, 0.0)
    got = vecmath.refract(_t(wi), _t(n), _t(eta))
    want = jvm.refract(jnp.asarray(wi), jnp.asarray(n), jnp.asarray(eta))
    valid = np.asarray(want[0])
    assert 0.3 < valid.mean() < 0.9  # total internal reflection on the rest
    np.testing.assert_array_equal(got[0].numpy(), valid)
    _close(got[1].numpy()[valid], np.asarray(want[1])[valid])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_dielectric_f_and_pdf_match():
    _, eta, alpha, wo, wi = _inputs(1)
    args = (eta, alpha, wo, wi)
    got_f = bxdf.dielectric_f(*map(_t, args)).numpy()
    want_f = np.asarray(jbxdf.dielectric_f(*map(jnp.asarray, args)))
    got_p = bxdf.dielectric_pdf(*map(_t, args)).numpy()
    want_p = np.asarray(jbxdf.dielectric_pdf(*map(jnp.asarray, args)))
    assert got_f.shape == (N,)  # a scalar f: the select chain broadcasts it
    transmit = (wo[:, 2] * wi[:, 2] < 0) & (want_f > 0)
    assert transmit.sum() > 200 and ((want_f > 0) & ~transmit).sum() > 200
    np.testing.assert_array_equal(want_f[alpha == 0], 0.0)
    np.testing.assert_array_equal(got_f[alpha == 0], 0.0)
    for got, want in ((got_f, want_f), (got_p, want_p)):
        assert share_close(got, want, rtol=1e-5, atol=1e-6)[0] >= 0.995
        _close(got, want, rtol=1e-3)


def test_dielectric_sample_matches():
    r, eta, alpha, wo, _ = _inputs(2)
    u2 = r.uniform(0, 1, (N, 2)).astype(np.float32)
    uc = r.uniform(0, 1, N).astype(np.float32)
    args = (eta, alpha, wo, u2, uc)
    got = [x.numpy() for x in bxdf.dielectric_sample(*map(_t, args))]
    want = [np.asarray(x) for x in jbxdf.dielectric_sample(*map(jnp.asarray, args))]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[3], alpha == 0)
    # Smooth lanes: both deltas are taken, and total internal reflection
    # (eta < 1 seen from the normal's side) reflects every time.
    smooth = alpha == 0
    refl = want[0][:, 2] * wo[:, 2] > 0
    assert (smooth & refl).sum() > 50 and (smooth & ~refl).sum() > 300
    _close(got[0][smooth], want[0][smooth])
    _close(got[1][smooth], want[1][smooth])
    _close(got[2][smooth], want[2][smooth])
    rim = (sample_uniform_disk_concentric(_t(u2)) ** 2).sum(-1).numpy() > 0.99
    ok = (np.abs(want[0][:, 2]) >= COS_MIN) & ~rim & ~smooth
    assert ok.mean() > 0.6
    _close(got[0][~rim], want[0][~rim], rtol=0, atol=5e-6)
    _close(got[1][ok], want[1][ok], rtol=5e-3)
    _close(got[2][ok], want[2][ok], rtol=5e-3)
    live = ok & (want[2] > 0)
    _close(got[1][live] / got[2][live], want[1][live] / want[2][live],
           rtol=1e-4)


def test_thin_dielectric_sample_matches():
    r, eta, _, wo, _ = _inputs(3)
    uc = r.uniform(0, 1, N).astype(np.float32)
    got = bxdf.thin_dielectric_sample(_t(eta), _t(wo), _t(uc))
    want = jbxdf.thin_dielectric_sample(jnp.asarray(eta), jnp.asarray(wo),
                                        jnp.asarray(uc))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1].shape == (N,)
    _close(got[1], want[1])
    _close(got[2], want[2])


# A diffuse floor, a smooth glass sphere, a thin pane and a rough glass
# sphere; the mesh part is a box of glass whose winding says its outside.
SPHERES = np.array([[-0.8, 0.7, 0.0, 0.65], [0.9, 0.7, 0.0, 0.65],
                    [0.0, 0.5, 1.5, 0.4]], np.float32)
MATS = [{"kind": 0}, {"kind": 2, "eta": 1.5}, {"kind": 3, "eta": 1.5},
        {"kind": 2, "eta": 1.33, "roughness": 0.1}]


def _glass_scenes():
    floor = make_quad((-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8))
    geo = dict(tri_verts=floor, tri_mat=np.zeros(2, np.int32),
               spheres=SPHERES, sph_mat=np.array([1, 2, 3], np.int32))
    js = JScene(geom=JGeometryBuffers.build(**geo),
                materials=JMaterialBuffers.build(MATS),
                lights=JLightBuffers.build())
    ps = Scene(geom=GeometryBuffers.build(**geo),
               materials=MaterialBuffers.build(MATS),
               lights=LightBuffers.build()).with_accel()
    assert ps.shaded_kinds == {0, 2, 3}
    return js, ps


def test_surface_params_and_exit_hits_match():
    """Rays from outside and from inside the spheres (the far root of the
    sphere test): the same hits, a sphere's t within rtol 1e-6, and the IOR each side
    sees: eta entering a dielectric, 1 / eta leaving it, the thin pane's
    eta either way."""
    js, ps = _glass_scenes()
    r = np.random.default_rng(4)
    n = 2048
    idx = r.integers(0, 3, n)
    c, rad = SPHERES[idx, :3], SPHERES[idx, 3:]
    d = _unit(r, n, 0.0)
    inside = np.arange(n) % 2 == 0
    o = np.where(inside[:, None],
                 c + d * rad * r.uniform(-0.9, 0.9, (n, 1)),
                 c - 3.0 * d + r.normal(scale=0.3, size=(n, 3)))
    o = o.astype(np.float32)
    tmax = np.full(n, np.inf, np.float32)
    lam = spectrum.sample_visible(_t(r.uniform(0, 1, n).astype(np.float32)), S).lam

    @jax.jit
    def reference(o, d, tmax, lam):
        isect = jax_api.closest(js, o, d, tmax)
        return isect, jbxdf.surface_params(js, isect, lam)

    want, jp = reference(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
                         jnp.asarray(lam.numpy()))
    got = api.closest(ps, _t(o), _t(d), _t(tmax))
    prim = np.asarray(want.prim)
    np.testing.assert_array_equal(got.prim.numpy(), prim)
    exit_hits = inside & (prim >= 2)
    assert exit_hits.mean() > 0.45  # every inside ray leaves its sphere
    sph = prim >= 2
    np.testing.assert_allclose(got.t.numpy()[sph], np.asarray(want.t)[sph],
                               rtol=1e-6)
    # The floor: the reference's watertight tester against Moller-Trumbore
    # (K1's twin), as in tests/test_torch_spheres.py.
    floor = (prim >= 0) & ~sph
    np.testing.assert_allclose(got.t.numpy()[floor], np.asarray(want.t)[floor],
                               rtol=2e-6, atol=1e-6)
    pp = bxdf.surface_params(ps, got, lam)
    assert pp["any_dielectric"] and pp["any_thin"] and not pp["any_conductor"]
    np.testing.assert_array_equal(pp["kind"].numpy(), np.asarray(jp["kind"]))
    eta = pp["eta"].numpy()
    np.testing.assert_array_equal(eta, np.asarray(jp["eta"]))
    kind = pp["kind"].numpy()
    # An outside ray enters the sphere it hits; an inside one leaves its own.
    base = np.array([1.5, 1.5, 1.33], np.float32)[np.clip(prim - 2, 0, 2)]
    glass = sph & (kind == 2)
    assert (glass & inside).sum() > 200 and (glass & ~inside).sum() > 200
    np.testing.assert_allclose(eta[glass],
                               np.where(inside, 1.0 / base, base)[glass],
                               rtol=1e-6)
    np.testing.assert_array_equal(eta[kind == 3], 1.5)


def test_dispatch_broadcasts_the_scalar_lobes():
    """evaluate / pdf / sample through the select chain against the
    reference's, on rows of every shaded kind (f is (N, S))."""
    r = np.random.default_rng(5)
    mat = r.integers(0, len(MATS), N).astype(np.int32)
    u_wl = r.uniform(0, 1, N).astype(np.float32)
    jwl = jspec.sample_visible(jnp.asarray(u_wl))
    pwl = spectrum.sample_visible(_t(u_wl), S)
    jp = JMaterialBuffers.build(MATS).gather(jnp.asarray(mat))
    jp["lam"] = jwl.lam
    pp = MaterialBuffers.build(MATS).gather(_t(mat))
    pp.update(lam=pwl.lam, any_conductor=False, any_dielectric=True,
              any_thin=True, any_diffusetrans=False,
              any_coated_diffuse=False, any_coated_conductor=False)
    wo, wi = _unit(r, N), _unit(r, N)
    u2 = r.uniform(0, 1, (N, 2)).astype(np.float32)
    uc = r.uniform(0, 1, N).astype(np.float32)
    jwo, jwi = jnp.asarray(wo), jnp.asarray(wi)
    f = bxdf.evaluate(pp, _t(wo), _t(wi), pwl.lam).numpy()
    want_f = np.asarray(jbxdf.evaluate(jp, jwo, jwi, jwl.lam))
    assert f.shape == (N, S)
    assert share_close(f, want_f, rtol=1e-5, atol=1e-6)[0] >= 0.995
    p = bxdf.pdf(pp, _t(wo), _t(wi)).numpy()
    assert share_close(p, np.asarray(jbxdf.pdf(jp, jwo, jwi)), 1e-5, 1e-6)[0] >= 0.995
    got = bxdf.sample(pp, _t(wo), pwl.lam, _t(u2), _t(uc))
    want = jbxdf.sample(jp, jwo, jwl.lam, jnp.asarray(u2), jnp.asarray(uc))
    spec = np.asarray(want["specular"])
    np.testing.assert_array_equal(got["specular"].numpy(), spec)
    # Rows 1 (smooth glass) and 2 (thin) are delta lobes; 0 and 3 are not.
    assert spec[(mat == 1) | (mat == 2)].all()
    assert not spec[(mat == 0) | (mat == 3)].any()
    smooth = (mat == 1) | (mat == 2)
    _close(got["f"].numpy()[smooth], np.asarray(want["f"])[smooth])
    _close(got["pdf"].numpy()[smooth], np.asarray(want["pdf"])[smooth])


def _file_pair(name):
    path = os.path.join(GOLDENS, name)
    js, jc, jset = jax_load_pbrt(path)
    ps, pc, pset = load_pbrt(path, device="cpu")
    depth = pset["integrator"].max_depth
    assert depth == jset["integrator"].max_depth
    return js.replace(small=None), jc, ps, pc, depth


@pytest.mark.parametrize("name", ["spheres.pbrt", "dielectric.pbrt"])
def test_golden_file_traces_like_jax(name):
    """16x16, 2 spp per sample: smooth glass (spheres.pbrt), rough glass
    and a thin-dielectric sphere (dielectric.pbrt); rays cross the spheres
    and leave them through the far root."""
    js, jc, ps, pc, depth = _file_pair(name)
    assert ps.small is not None and ps.geom.num_spheres == 2
    assert_samples_match(*trace_pair(f"trace/{name}", js, jc, ps, pc, depth,
                                     res=16, spp=2))


def test_mesh_gallery_traces_like_jax():
    """The glass torus: the dielectric's side from the triangles' winding,
    on the cluster tier (K2's twin); the reference with its dense tester."""
    js, jc = gallery_reference_inputs()
    ps, pc = mesh_gallery_scene(resolution=(16, 16), subdiv=1)
    assert ps.clusters is not None and ps.shaded_kinds == {0, 1, 2}
    assert_samples_match(*trace_pair("trace/mesh_gallery", js, jc, ps, pc,
                                     5, res=16, spp=2))


def gallery_reference_inputs():
    """The reference's mesh gallery at 16x16, subdiv 1, without its
    clusters (its dense tester answers)."""
    js, jc = jax_mesh_gallery(resolution=(16, 16), subdiv=1)
    return js.replace(clusters=None), jc
