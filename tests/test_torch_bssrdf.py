"""The port's Burley BSSRDF (pbrt_tpu_torch/materials/bssrdf.py) against
the reference's on the CPU, on the same numpy-seeded inputs: the shaping
distance, the profile, its polar pdf and cdf, the Newton radius sampler,
the Fresnel moment, and the subsurface probe on a plane
(tests/test_bssrdf.py's geometry; the port's probe is a closest-hit query
with a per-ray tmax through the small-scene tier, the reference's its
dense tester), with the port's own gates of that test (the exits stay on
the plane, the weight's mean reproduces the albedo).

Tolerances: the closed forms within rtol 2e-6 / atol 1e-7
(transcendentals an ulp apart), the sampler's radius within rtol 5e-5
(its ten Newton steps carry the ulp: 3.2e-5 at most); the probe's exit points within 2e-6
absolute, its normals equal, its weights within rtol 1e-4 (the probe's
t, and so the exit radius, differ by an ulp between the two testers; the
profile is steep at small radii).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.materials import bssrdf as jbssrdf
from pbrt_tpu_torch.materials import bssrdf

torch.set_num_threads(2)
N = 8192


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=2e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _draws(seed):
    r = np.random.default_rng(seed)
    f32 = np.float32
    return dict(albedo=r.uniform(0.0, 1.0, N).astype(f32),
                mfp=r.uniform(0.01, 3.0, N).astype(f32),
                r=r.uniform(0.0, 4.0, N).astype(f32),
                u=r.uniform(0.0, 1.0, N).astype(f32),
                eta=r.uniform(0.5, 2.5, N).astype(f32))


@pytest.mark.parametrize("fn", ["burley_profile", "burley_cdf",
                                "burley_pdf_r", "burley_sample_r"])
def test_profile_matches_jax(fn):
    x = _draws(0)
    d_j = jbssrdf.burley_d(jnp.asarray(x["albedo"]), jnp.asarray(x["mfp"]))
    d_p = bssrdf.burley_d(_t(x["albedo"]), _t(x["mfp"]))
    _close(d_p, d_j)
    arg = "u" if fn == "burley_sample_r" else "r"
    want = getattr(jbssrdf, fn)(jnp.asarray(x[arg]), d_j)
    got = getattr(bssrdf, fn)(_t(x[arg]), _t(np.asarray(d_j)))
    assert torch.isfinite(got).all()
    _close(got, want, rtol=5e-5 if fn == "burley_sample_r" else 2e-6)


def test_fresnel_moment1_matches_jax():
    eta = _draws(1)["eta"]
    _close(bssrdf.fresnel_moment1(_t(eta)),
           jbssrdf.fresnel_moment1(jnp.asarray(eta)))


def _plane(pkg):
    """tests/test_bssrdf.py's floor: one large triangle at y = 0, built by
    `pkg`'s builders."""
    tri = np.asarray([[[-50, 0, -50], [50, 0, -50], [0, 0, 80]]], np.float32)
    kw = dict(tri_verts=tri, tri_mat=np.zeros(1, np.int32),
              tri_light=np.full(1, -1, np.int32))
    if pkg == "jax":
        from pbrt_tpu.lights.buffers import LightBuffers
        from pbrt_tpu.materials.buffers import MaterialBuffers
        from pbrt_tpu.scene import Scene
        from pbrt_tpu.shapes.geometry import GeometryBuffers
    else:
        from pbrt_tpu_torch.lights.buffers import LightBuffers
        from pbrt_tpu_torch.materials.buffers import MaterialBuffers
        from pbrt_tpu_torch.scene import Scene
        from pbrt_tpu_torch.shapes.geometry import GeometryBuffers
    scene = Scene(geom=GeometryBuffers.build(**kw),
                  materials=MaterialBuffers.build([{"kind": 0}]),
                  lights=LightBuffers.build())
    return scene if pkg == "jax" else scene.with_accel()


def test_subsurface_exit_on_plane_matches_jax():
    from pbrt_tpu.accel import api as jax_api
    from pbrt_tpu.core.vecmath import coordinate_system as jcs
    from pbrt_tpu_torch.accel import api
    from pbrt_tpu_torch.core.vecmath import coordinate_system

    r = np.random.default_rng(1)
    o = np.tile(np.asarray([[0.0, 3.0, 0.0]], np.float32), (N, 1))
    o[:, [0, 2]] += r.uniform(-2, 2, (N, 2)).astype(np.float32)
    d = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (N, 1))
    alb = r.uniform(0.3, 0.95, (N, 4)).astype(np.float32)
    mfp = r.uniform(0.05, 0.5, N).astype(np.float32)
    u_r, u_phi = (r.random(N).astype(np.float32) for _ in range(2))

    js = _plane("jax")

    def probe(o, d, alb, mfp, u_r, u_phi):
        ji = jax_api.closest(js, o, d)
        jt1, jt2 = jcs(ji.n)
        return jbssrdf.subsurface_exit(js, ji, ji.n, jt1, jt2, alb, mfp, u_r,
                                       u_phi)

    want = jax.jit(probe)(*(jnp.asarray(x) for x in (o, d, alb, mfp, u_r,
                                                      u_phi)))
    ps = _plane("torch")
    pi = api.closest(ps, _t(o), _t(d))
    t1, t2 = coordinate_system(pi.n)
    got = bssrdf.subsurface_exit(ps, pi, pi.n, t1, t2, _t(alb), _t(mfp),
                                 _t(u_r), _t(u_phi))
    p_exit, n_exit, w, ok = (x.numpy() for x in got)
    np.testing.assert_array_equal(ok, np.asarray(want[3]))
    _close(p_exit, want[0], rtol=0, atol=2e-6)
    np.testing.assert_array_equal(n_exit, np.asarray(want[1]))
    _close(w, want[2], rtol=1e-4, atol=1e-6)
    # The reference's gates: the probes land, the exits stay on the
    # plane, and the weight's mean reproduces the albedo.
    assert ok.mean() > 0.95
    assert np.abs(p_exit[ok][:, 1]).max() < 1e-3
    assert np.isfinite(w).all() and 0.5 < w[ok].mean() < 0.9
