"""The conductor BxDF, its microfacet and Fresnel terms, and the uniform
infinite light of the port against the reference on the CPU, on the same
numpy-seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import spectrum as jspec
from pbrt_tpu.lights.buffers import LightBuffers as JLightBuffers
from pbrt_tpu.materials import bxdf as jbxdf
from pbrt_tpu.materials import scattering as jsc
from pbrt_tpu.materials.buffers import MaterialBuffers as JMaterialBuffers
from pbrt_tpu_torch.core import spectrum
from pbrt_tpu_torch.core.sampling import sample_uniform_disk_concentric
from pbrt_tpu_torch.lights.buffers import LightBuffers
from pbrt_tpu_torch.materials import bxdf
from pbrt_tpu_torch.materials import scattering as sc
from pbrt_tpu_torch.materials.buffers import MaterialBuffers

torch.set_num_threads(2)
N = 4096
S = jspec.N_SPECTRUM
# Away from grazing angles: |cos theta| >= COS_MIN for wo and wi. Below it
# 1 / cos and the Smith tan^2 term amplify one-ulp differences of the
# inputs past rtol 1e-5.
COS_MIN = 0.1
MATERIALS = [
    {"kind": 0, "albedo": (0.55, 0.52, 0.48)},
    {"kind": 1, "conductor": "Cu", "roughness": 0.08},
    {"kind": 1, "conductor": "Au", "roughness": 0.0},  # smooth: a mirror
    {"kind": 1, "conductor": "Al", "roughness": 0.5},
]


def _unit(r, n, cos_min=COS_MIN):
    v = r.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    bad = np.abs(v[:, 2]) < cos_min
    v[bad, 2] = np.sign(v[bad, 2] + 1e-9) * cos_min * 2
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v.astype(np.float32)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_scattering_terms_match():
    r = np.random.default_rng(0)
    cos = r.uniform(-1, 1, (N, 1)).astype(np.float32)
    eta = r.uniform(0.1, 4.0, (N, S)).astype(np.float32)
    k = r.uniform(0.5, 8.0, (N, S)).astype(np.float32)
    _close(sc.fr_complex(_t(cos), _t(eta), _t(k)),
           jsc.fr_complex(jnp.asarray(cos), jnp.asarray(eta), jnp.asarray(k)))
    wo, wm = _unit(r, N), _unit(r, N)
    wm[:, 2] = np.abs(wm[:, 2])
    alpha = r.uniform(1e-3, 1.0, N).astype(np.float32)
    u2 = r.uniform(0, 1, (N, 2)).astype(np.float32)
    jwo, jwm, ja = jnp.asarray(wo), jnp.asarray(wm), jnp.asarray(alpha)
    two, twm, ta = _t(wo), _t(wm), _t(alpha)
    _close(sc.ggx_d(twm, ta), jsc.ggx_d(jwm, ja))
    _close(sc.ggx_lambda(two, ta), jsc.ggx_lambda(jwo, ja))
    _close(sc.ggx_g1(two, ta), jsc.ggx_g1(jwo, ja))
    _close(sc.ggx_g(two, twm, ta), jsc.ggx_g(jwo, jwm, ja))
    _close(sc.ggx_pdf_wm(two, twm, ta), jsc.ggx_pdf_wm(jwo, jwm, ja))
    # Sampled half-vectors go through cos/sin of the disk warp and the lift
    # sqrt(1 - |p|^2), which grows one ulp of cos/sin toward the disk's rim:
    # 5e-6 absolute, on disk samples with |p|^2 <= 0.99.
    rim = (sample_uniform_disk_concentric(_t(u2)) ** 2).sum(-1).numpy() > 0.99
    _close(sc.ggx_sample_wm(two, _t(u2), ta).numpy()[~rim],
           np.asarray(jsc.ggx_sample_wm(jwo, jnp.asarray(u2), ja))[~rim],
           rtol=0, atol=5e-6)
    rough = r.uniform(0, 1, N).astype(np.float32)
    _close(sc.roughness_to_alpha(_t(rough)), jsc.roughness_to_alpha(jnp.asarray(rough)))
    a = np.array([0.0, 5e-4, 1e-3, 0.2], np.float32)
    np.testing.assert_array_equal(sc.effectively_smooth(_t(a)).numpy(),
                                  np.asarray(jsc.effectively_smooth(jnp.asarray(a))))


@pytest.fixture(scope="module")
def params():
    r = np.random.default_rng(1)
    mat = r.integers(0, len(MATERIALS), N).astype(np.int32)
    u_wl = r.uniform(0, 1, N).astype(np.float32)
    jwl = jspec.sample_visible(jnp.asarray(u_wl))
    pwl = spectrum.sample_visible(_t(u_wl), S)
    jp = JMaterialBuffers.build(MATERIALS).gather(jnp.asarray(mat))
    jp["lam"] = jwl.lam
    pp = MaterialBuffers.build(MATERIALS).gather(_t(mat))
    pp["lam"] = pwl.lam
    assert pp["any_conductor"] and jp["any_conductor"]
    # The links of the families the table does not hold (surface_params
    # sets them from the referenced kinds).
    pp.update(any_diffusetrans=False, any_coated_diffuse=False,
              any_coated_conductor=False)
    return jp, pp, jwl, pwl, r


def test_conductor_bxdf_matches(params):
    jp, pp, jwl, pwl, r = params
    wo, wi = _unit(r, N), _unit(r, N)
    u2 = r.uniform(0, 1, (N, 2)).astype(np.float32)
    uc = r.uniform(0, 1, N).astype(np.float32)
    jwo, jwi = jnp.asarray(wo), jnp.asarray(wi)
    _close(bxdf.evaluate(pp, _t(wo), _t(wi), pwl.lam),
           jbxdf.evaluate(jp, jwo, jwi, jwl.lam))
    _close(bxdf.pdf(pp, _t(wo), _t(wi)), jbxdf.pdf(jp, jwo, jwi))
    got = bxdf.sample(pp, _t(wo), pwl.lam, _t(u2), _t(uc))
    want = jbxdf.sample(jp, jwo, jwl.lam, jnp.asarray(u2), jnp.asarray(uc))
    np.testing.assert_array_equal(got["specular"].numpy(), np.asarray(want["specular"]))
    kind = pp["kind"].numpy()
    assert got["specular"].numpy().sum() == np.sum(kind == 1) - np.sum(
        (kind == 1) & (pp["roughness"].numpy() > 0))  # the smooth rows only
    # Sampled directions: the half-vector's 5e-6 on disk samples away from
    # the rim (see test_scattering_terms_match), through a reflection.
    # f and pdf of a sampled direction: lanes whose sampled wi is itself
    # grazing (|cos| < COS_MIN) are left out too, for the reason above.
    rim = (sample_uniform_disk_concentric(_t(u2)) ** 2).sum(-1).numpy() > 0.99
    ok = (np.abs(np.asarray(want["wi"])[:, 2]) >= COS_MIN) & ~rim
    assert ok.mean() > 0.8
    _close(got["wi"].numpy()[~rim], np.asarray(want["wi"])[~rim], rtol=0, atol=5e-6)
    _close(got["f"].numpy()[ok], np.asarray(want["f"])[ok])
    _close(got["pdf"].numpy()[ok], np.asarray(want["pdf"])[ok], atol=2e-6)


@pytest.fixture(scope="module")
def lights():
    specs = dict(
        area_tris=[{"verts": [[-0.8, 2.6, -0.8], [0.8, 2.6, -0.8], [0.8, 2.6, 0.8]],
                    "rgb": (1, 0.95, 0.9), "scale": 14.0},
                   {"verts": [[-0.8, 2.6, -0.8], [0.8, 2.6, 0.8], [-0.8, 2.6, 0.8]],
                    "rgb": (1, 0.95, 0.9), "scale": 14.0}],
        infinite={"rgb": (0.35, 0.45, 0.7), "scale": 0.25},
    )
    out = {}
    for sampler in ("uniform", "power"):
        out[sampler] = (JLightBuffers.build(sampler=sampler, **specs),
                        LightBuffers.build(sampler=sampler, **specs))
    return out


@pytest.mark.parametrize("sampler", ["uniform", "power"])
def test_infinite_light_queries_match(lights, sampler):
    jl, pl = lights[sampler]
    assert pl.has_infinite and pl.n_lights == jl.n_lights == 3
    assert pl.n_inf_list == jl.n_inf_list and pl._p_infinite == jl._p_infinite
    _close(pl.select_pmf, jl.select_pmf, rtol=1e-6, atol=0)
    r = np.random.default_rng(2)
    p = r.uniform(-1, 1, (N, 3)).astype(np.float32)
    n = _unit(r, N, 0.0)
    u_sel = r.uniform(0, 1, N).astype(np.float32)
    u_pos = r.uniform(0, 1, (N, 2)).astype(np.float32)
    u_wl = r.uniform(0, 1, N).astype(np.float32)
    jwl = jspec.sample_visible(jnp.asarray(u_wl))
    pwl = spectrum.sample_visible(_t(u_wl), S)
    got = pl.sample_li(_t(p), pwl.lam, _t(u_sel), _t(u_pos), n_ref=_t(n))
    want = jl.sample_li(jnp.asarray(p), jwl.lam, jnp.asarray(u_sel),
                        jnp.asarray(u_pos), n_ref=jnp.asarray(n))
    inf_lane = np.isinf(np.asarray(want.dist))
    assert 0.0 < inf_lane.mean() < 0.5  # both kinds of light are sampled
    np.testing.assert_array_equal(np.isinf(got.dist.numpy()), inf_lane)
    for k in ("L", "pdf", "dist"):
        _close(getattr(got, k), getattr(want, k))
    # Directions on the sphere go through cos/sin: 2e-6 absolute.
    _close(got.wi, want.wi, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(got.is_delta.numpy(), np.asarray(want.is_delta))
    d = _unit(r, N, 0.0)
    _close(pl.escaped_radiance(_t(d), pwl.lam), jl.escaped_radiance(jnp.asarray(d), jwl.lam))
    _close(pl.pdf_escaped(_t(d)), jl.pdf_escaped(jnp.asarray(d)))
    idx = r.integers(-1, 3, N).astype(np.int32)
    _close(pl.selection_pmf(_t(idx)), jl.selection_pmf(jnp.asarray(idx)))
    light = r.integers(-1, 2, N).astype(np.int32)
    dist = r.uniform(0.1, 3.0, N).astype(np.float32)
    cos_l = r.uniform(-1, 1, N).astype(np.float32)
    _close(pl.pdf_li_area(_t(light), _t(dist), _t(cos_l)),
           jl.pdf_li_area(jnp.asarray(light), jnp.asarray(dist), jnp.asarray(cos_l)))
