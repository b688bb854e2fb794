"""The port's coated materials, diffuse transmission and tag-sorted
shading against the reference on the CPU, on the same numpy-seeded
inputs.

- The layered walk's RNG: the direction keys and every pcg4d draw of a
  walk, bit for bit, on 4,096 lanes with grazing directions, both
  hemispheres and signed zeros.
- layered_walk over the diffuse and the conductor base at salts 0 and 1 on
  the same directions: rtol 2e-4 / atol 1e-6 (measured: 1.2e-4 relative
  at most, the walk's chain of ~30 float32 factors rounded by XLA's fused
  loops against the port's op by op).
- The two-lobe coated_f and coated_pdf: rtol 1e-4 / atol 1e-6 (measured
  3.7e-5 where the GGX lobe is grazing); coated_sample: directions within
  atol 5e-6 as the conductor's (tests/test_torch_conductor.py), f and pdf
  within rtol 1e-3 on >= 99.5% of values and their ratio within 1e-4 (a
  coat lobe of alpha ~1e-3 turns the direction's 1e-6 into up to 25% of
  f and pdf alike, as the dielectric's in tests/test_torch_dielectric.py);
  diffusetrans_f / _pdf / _sample: rtol 1e-5 / atol 5e-6.
- The select chain over a table with a coated diffuse, a coated conductor
  and a diffuse-transmission row: evaluate within rtol 2e-4 on >= 99.9%
  of values and 1e-3 on all (the walk's), pdf within rtol 1e-4; sample
  with the walk on coarse keys (tests/torch_port_coated.py: a sampled
  direction one ulp off would re-key its walk).
- Sorted dispatch: bit-equal to the lockstep chain on 20,000 lanes of
  seven kinds, and the reference's unit round trip; under the remat
  gradient path the same loss bit for bit and the same gradients within
  rtol 1e-5 (the gathers' backward sums duplicate rows in another order).
- The coated Cornell box (16x16, 2 spp, depth 3, 8 lanes) per sample
  against the reference's jitted trace with its dense tester
  (tests/data/torch_port/coated_cornell16_samples.npz, from
  scripts/make_torch_port_golden_manylight.py: its compile of the four
  walks takes over a minute), both on coarse walk keys: the same ray
  count, >= 99% of per-sample values within rtol 1e-3 / atol 1e-5, the
  image mean within rtol 1e-3; and with the exact keys (the port's
  shipped keying) the image mean within 0.3%.
- The coated Cornell gradients (32x32, 4 spp, depth 5) against the JAX
  golden tests/data/torch_port/coated_cornell32_grad.npz
  (scripts/make_torch_port_golden_manylight.py): each within 1e-3 of its
  tensor's largest magnitude.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import rng as jrng
from pbrt_tpu.materials import bxdf as jbxdf
from pbrt_tpu.materials import layered as jlayered
from pbrt_tpu.materials.buffers import MaterialBuffers as JMaterialBuffers
from pbrt_tpu_torch.core import spectrum
from pbrt_tpu_torch.materials import bxdf
from pbrt_tpu_torch.materials import layered
from pbrt_tpu_torch.materials.buffers import (
    MAT_COATEDCONDUCTOR,
    MAT_COATEDDIFFUSE,
    MAT_CONDUCTOR,
    MAT_DIELECTRIC,
    MAT_DIFFUSE,
    MAT_DIFFUSETRANS,
    MAT_THINDIELECTRIC,
    MaterialBuffers,
)
from pbrt_tpu_torch.materials.sorted import possible_families, shade_sorted
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.parallel.train import render_loss_and_grad
from pbrt_tpu_torch.render import camera_rays_full

from .torch_port_coated import coarse_walk_keys, coated_cornell
from .torch_port_helpers import share_close

torch.set_num_threads(2)
N = 4096
S = 8
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
GOLDEN_GRAD = os.path.join(DATA, "coated_cornell32_grad.npz")
GOLDEN_SAMPLES = os.path.join(DATA, "coated_cornell16_samples.npz")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, rtol=1e-5, atol=1e-6, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=err_msg)


def _directions(seed, n=N):
    """wo and wi: random directions on both hemispheres, grazing ones
    (|z| ~ 1e-4), the poles and signed zeros in x and z."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        v = r.normal(size=(n, 3))
        v[: n // 8, 2] = r.uniform(-1e-4, 1e-4, n // 8)
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        v = v.astype(np.float32)
        v[-4:] = [[0.0, 0.0, 1.0], [-0.0, 0.0, 1.0], [0.6, 0.8, -0.0],
                  [0.6, 0.8, 0.0]]
        out.append(v)
    return out


def _wavelengths(r, n):
    u = r.uniform(0, 1, n).astype(np.float32)
    wl = spectrum.sample_visible(_t(u), S)
    return wl.lam, jnp.asarray(wl.lam.numpy())


def test_walk_keys_and_draws_are_bit_equal():
    wo, wi = _directions(0)
    a, b = layered._walk_keys(_t(wo), _t(wi))
    jo, ji = jnp.asarray(wo), jnp.asarray(wi)
    ja = jlayered._bits(jo[:, 0]) ^ (jlayered._bits(jo[:, 2]) << 1)
    jb = jlayered._bits(ji[:, 0]) ^ (jlayered._bits(ji[:, 2]) << 1)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja).astype(np.int64))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb).astype(np.int64))
    # A signed zero in x re-keys; one in z does not: its sign bit is
    # shifted out of the 32 bits, as in the reference's uint32 shift.
    assert a[-4] != a[-3] and b[-2] == b[-1]
    n_draws = 34  # 4 + 3 per depth of the 10-deep walk
    for stream in (0, 1, 131, 132):
        ua, ub = layered.walk_uniforms(_t(wo), _t(wi), stream, n_draws)
        uni = jlayered._walk_rng(jo, ji, stream)
        for i in range(n_draws):
            va, vb = uni(i)
            np.testing.assert_array_equal(ua[:, i].numpy(), np.asarray(va))
            np.testing.assert_array_equal(ub[:, i].numpy(), np.asarray(vb))
    # The keys feed pcg4d as the reference's uint32s.
    v = jrng.pcg4d(ja, jb, jnp.uint32(131), jnp.uint32(7))
    from pbrt_tpu_torch.core import rng

    for got, want in zip(rng.pcg4d(a, b, 131, 7), v):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def _bases(r, n):
    """(port, reference) base-lobe callables of the walk: a diffuse albedo
    and a rough gold conductor."""
    albedo = r.uniform(0.05, 0.95, (n, S)).astype(np.float32)
    eta = r.uniform(0.2, 1.5, (n, S)).astype(np.float32)
    k = r.uniform(1.5, 4.0, (n, S)).astype(np.float32)
    alpha = r.uniform(0.05, 0.5, n).astype(np.float32)
    pa, ja = _t(albedo), jnp.asarray(albedo)
    pe, pk, pal = _t(eta), _t(k), _t(alpha)
    je, jk, jal = jnp.asarray(eta), jnp.asarray(k), jnp.asarray(alpha)
    return {
        "diffuse": (
            (lambda a, b: bxdf.diffuse_f(pa, a, b),
             lambda a, u2, uc: bxdf.diffuse_sample(pa, a, u2)),
            (lambda a, b: jbxdf.diffuse_f(ja, a, b),
             lambda a, u2, uc: jbxdf.diffuse_sample(ja, a, u2)),
        ),
        "conductor": (
            (lambda a, b: bxdf.conductor_f(pe, pk, pal, a, b),
             lambda a, u2, uc: bxdf.conductor_sample(pe, pk, pal, a, u2)[:3]),
            (lambda a, b: jbxdf.conductor_f(je, jk, jal, a, b),
             lambda a, u2, uc: jbxdf.conductor_sample(je, jk, jal, a, u2)[:3]),
        ),
    }


@pytest.mark.parametrize("base", ["diffuse", "conductor"])
@pytest.mark.parametrize("salt", [0, 1])
def test_layered_walk_matches(base, salt):
    r = np.random.default_rng(10 + salt)
    wo, wi = _directions(1 + salt)
    (pf, ps), (jf, js) = _bases(r, N)[base]
    alpha_c = r.uniform(1e-3, 0.4, N).astype(np.float32)
    thick = r.uniform(0.0, 0.1, N).astype(np.float32)
    got = layered.layered_walk(_t(wo), _t(wi), pf, ps, _t(alpha_c),
                               thickness=_t(thick), salt=salt)
    want = jlayered.layered_walk(jnp.asarray(wo), jnp.asarray(wi), jf, js,
                                 jnp.asarray(alpha_c),
                                 thickness=jnp.asarray(thick), salt=salt)
    assert got.shape == (N, S) and torch.isfinite(got).all()
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    _close(got, want, rtol=2e-4, atol=1e-6)


def test_two_lobe_and_diffuse_transmission_match():
    r = np.random.default_rng(3)
    wo, wi = _directions(4)
    lam, jlam = _wavelengths(r, N)
    refl = r.uniform(0.05, 0.95, (N, S)).astype(np.float32)
    trans = r.uniform(0.05, 0.95, (N, S)).astype(np.float32)
    alpha_c = r.uniform(1e-4, 0.4, N).astype(np.float32)
    u2 = r.uniform(0, 1, (N, 2)).astype(np.float32)
    uc = r.uniform(0, 1, N).astype(np.float32)
    P = dict(wo=_t(wo), wi=_t(wi), refl=_t(refl), trans=_t(trans),
             a=_t(alpha_c), u2=_t(u2), uc=_t(uc))
    J = {k: jnp.asarray(v.numpy()) for k, v in P.items()}
    base_f = bxdf.diffuse_f(P["refl"], P["wo"], P["wi"])
    _close(bxdf.coated_f(base_f, P["a"], P["wo"], P["wi"]),
           jbxdf.coated_f(jbxdf.diffuse_f(J["refl"], J["wo"], J["wi"]),
                          J["a"], J["wo"], J["wi"]), rtol=1e-4,
           err_msg="coated_f")
    _close(bxdf.coated_pdf(bxdf.diffuse_pdf(P["wo"], P["wi"]), P["a"],
                           P["wo"], P["wi"]),
           jbxdf.coated_pdf(jbxdf.diffuse_pdf(J["wo"], J["wi"]), J["a"],
                            J["wo"], J["wi"]), rtol=1e-4,
           err_msg="coated_pdf")

    def sample_of(mod, X):
        return mod.coated_sample(
            lambda u: mod.diffuse_sample(X["refl"], X["wo"], u),
            lambda w: mod.diffuse_f(X["refl"], X["wo"], w),
            lambda w: mod.diffuse_pdf(X["wo"], w),
            X["a"], X["wo"], X["u2"], X["uc"])

    got, want = sample_of(bxdf, P), sample_of(jbxdf, J)
    _close(got[0], want[0], rtol=0, atol=5e-6, err_msg="coated wi")
    # f and pdf at the sampled direction move together: a coat lobe of
    # alpha ~1e-3 turns the direction's 1e-6 into up to 25% of both, and
    # their ratio, the path's throughput weight, stays within 1e-4.
    f, p = got[1].numpy(), got[2].numpy()
    want_f, want_p = np.asarray(want[1]), np.asarray(want[2])
    for name, g, w in (("f", f, want_f), ("pdf", p, want_p)):
        share = share_close(g, w, rtol=1e-3, atol=1e-5)[0]
        assert share >= 0.995, (name, share)
    live = want_p > 0
    np.testing.assert_array_equal(p > 0, live)
    _close(f[live] / p[live, None], want_f[live] / want_p[live, None],
           rtol=1e-4, atol=0, err_msg="f / pdf")

    _close(bxdf.diffusetrans_f(P["refl"], P["trans"], P["wo"], P["wi"]),
           jbxdf.diffusetrans_f(J["refl"], J["trans"], J["wo"], J["wi"]))
    _close(bxdf.diffusetrans_pdf(P["wo"], P["wi"]),
           jbxdf.diffusetrans_pdf(J["wo"], J["wi"]))
    got = bxdf.diffusetrans_sample(P["refl"], P["trans"], P["wo"], P["u2"],
                                   P["uc"])
    want = jbxdf.diffusetrans_sample(J["refl"], J["trans"], J["wo"], J["u2"],
                                     J["uc"])
    for g, w in zip(got, want):
        _close(g, w, atol=5e-6)
    # Both sides of the surface are sampled.
    below = got[0][:, 2] * P["wo"][:, 2] < 0
    assert 0.4 < float(below.float().mean()) < 0.6


MATS = [
    {"kind": MAT_DIFFUSE, "albedo": (0.6, 0.4, 0.3)},
    {"kind": MAT_CONDUCTOR, "conductor": "Cu", "roughness": 0.2},
    {"kind": MAT_COATEDDIFFUSE, "albedo": (0.35, 0.35, 0.4),
     "coat_roughness": 0.08, "thickness": 0.05},
    {"kind": MAT_COATEDCONDUCTOR, "conductor": "Au", "roughness": 0.1,
     "coat_roughness": 0.2},
    {"kind": MAT_DIFFUSETRANS, "albedo": (0.5, 0.3, 0.2),
     "transmittance": (0.2, 0.4, 0.6)},
]


def _table_inputs(mats, n, seed):
    r = np.random.default_rng(seed)
    mat = r.integers(0, len(mats), n).astype(np.int32)
    lam, jlam = _wavelengths(r, n)
    pp = MaterialBuffers.build(mats).gather(_t(mat).long())
    pp.update({flag: False for flag in bxdf.FLAGS})
    pp.update({bxdf.FAMILY_FLAGS[k]: True for k in {m["kind"] for m in mats}
               if k in bxdf.FAMILY_FLAGS})
    pp["lam"] = lam
    jp = JMaterialBuffers.build(mats).gather(jnp.asarray(mat))
    jp["lam"] = jlam
    wo, wi = _directions(seed + 1, n)
    wo[:, 2] = np.abs(wo[:, 2])  # the integrator's frame faces wo
    ops = {"wo": wo, "wi": wi,
           "u2": r.uniform(0, 1, (n, 2)).astype(np.float32),
           "uc": r.uniform(0, 1, n).astype(np.float32)}
    return pp, jp, ops


def test_dispatch_matches_with_coated_and_transmissive_rows():
    pp, jp, ops = _table_inputs(MATS, N, 20)
    assert jp["any_coated"] and jp["any_conductor"] and jp["any_diffusetrans"]
    P = {k: _t(v) for k, v in ops.items()}
    J = {k: jnp.asarray(v) for k, v in ops.items()}
    kind = pp["kind"].numpy()
    f = bxdf.evaluate(pp, P["wo"], P["wi"], pp["lam"]).numpy()
    want_f = np.asarray(jbxdf.evaluate(jp, J["wo"], J["wi"], jp["lam"]))
    assert f.shape == (N, S) and np.abs(f[kind >= 2]).max() > 0.1
    # The walk's values as layered_walk's, on >= 99.9% of the values; a
    # few lanes of the walk's longest chains reach 6e-4.
    assert share_close(f, want_f, rtol=2e-4, atol=1e-6)[0] >= 0.999
    _close(f, want_f, rtol=1e-3, atol=1e-6, err_msg="evaluate")
    _close(bxdf.pdf(pp, P["wo"], P["wi"]), jbxdf.pdf(jp, J["wo"], J["wi"]),
           rtol=1e-4, atol=1e-6, err_msg="pdf")
    with coarse_walk_keys(layered, jlayered):
        got = bxdf.sample(pp, P["wo"], pp["lam"], P["u2"], P["uc"])
        want = jbxdf.sample(jp, J["wo"], jp["lam"], J["u2"], J["uc"])
    _close(got["wi"], want["wi"], rtol=0, atol=5e-6, err_msg="wi")
    np.testing.assert_array_equal(got["specular"].numpy(),
                                  np.asarray(want["specular"]))
    for name in ("f", "pdf"):
        share = share_close(got[name].numpy(), np.asarray(want[name]),
                            rtol=1e-3, atol=1e-5)[0]
        assert share >= 0.999, (name, share)


def _bsdf_calls(params, ops):
    return {"bs": bxdf.sample(params, ops["wo"], params["lam"], ops["u2"],
                              ops["uc"]),
            "f_nee": bxdf.evaluate(params, ops["wo"], ops["wi"],
                                   params["lam"]),
            "pdf_b": bxdf.pdf(params, ops["wo"], ops["wi"])}


def test_shade_sorted_is_bit_equal_to_lockstep():
    """20,000 lanes of seven kinds (above one 8,192-lane tile): every
    output of the sorted dispatch equals the lockstep chain's bit for
    bit."""
    mats = MATS + [{"kind": MAT_DIELECTRIC, "eta": 1.5, "roughness": 0.1},
                   {"kind": MAT_THINDIELECTRIC, "eta": 1.5}]
    n = 20_000
    pp, _, ops = _table_inputs(mats, n, 30)
    # The links of the seven kinds the lanes hold (_table_inputs; the
    # families of the hair / subsurface / measured / retroreflective slice
    # are held by tests/test_torch_families.py's sorted render).
    assert len(possible_families(pp)) == 7
    ops = {k: _t(v) for k, v in ops.items()}
    want = _bsdf_calls(pp, ops)
    got = shade_sorted(pp, ops, _bsdf_calls)
    for name in ("f_nee", "pdf_b"):
        assert torch.equal(got[name], want[name]), name
    for name in ("wi", "f", "pdf", "specular"):
        assert torch.equal(got["bs"][name], want["bs"][name]), name


def test_shade_sorted_unit_roundtrip():
    """shade_sorted returns fn's outputs in the original ray order for an
    arbitrary per-ray function (tests/test_sorted_shading.py's check)."""
    n = 1000
    r = np.random.default_rng(3)
    kind = torch.from_numpy(
        r.choice([0, 1, 2], size=n, p=[0.6, 0.3, 0.1]).astype(np.int32))
    x = torch.from_numpy(r.standard_normal((n, 4)).astype(np.float32))
    params = {"kind": kind, **{f: False for f in bxdf.FAMILY_FLAGS.values()},
              "any_conductor": True, "any_dielectric": True}

    def fn(pp, oo):
        k = pp["kind"].to(torch.float32)
        return {"y": oo["x"] * (k[:, None] + 1.0), "z": k * 2.0}

    out = shade_sorted(params, {"x": x}, fn, tile=128)
    ref = fn(params, {"x": x})
    assert torch.equal(out["y"], ref["y"]) and torch.equal(out["z"], ref["z"])


RES, SPP, DEPTH = 16, 2, 3


@pytest.fixture(scope="module")
def cornell_traced():
    """The port's trace of the coated Cornell box (K1's twin) with the
    walk on coarse keys and on the exact keys, and the reference's
    (tests/data/torch_port/coated_cornell16_samples.npz: its jitted
    trace with its dense tester, coarse keys)."""
    golden = np.load(GOLDEN_SAMPLES)
    assert (int(golden["resolution"]), int(golden["spp"]),
            int(golden["max_depth"]), int(golden["n_spectrum"])) == (
                RES, SPP, DEPTH, S)
    ps, pc = coated_cornell("pbrt_tpu_torch", (RES, RES))
    ps = ps.with_accel()
    npix = RES * RES
    pixel = torch.arange(npix).repeat(SPP)
    sample = torch.arange(SPP).repeat_interleave(npix)
    po, pd, pwl, _ = camera_rays_full(pc, pixel, sample, 0, n_spectrum=S)
    integ = dict(max_depth=DEPTH, rr_start_depth=DEPTH)
    with coarse_walk_keys(layered):
        pL, pst = PathIntegrator(**integ).trace_with_stats(
            ps, po, pd, pwl, pixel, sample, 0)
    exact = PathIntegrator(**integ).trace(ps, po, pd, pwl, pixel, sample, 0)
    return (golden["radiance"], float(golden["rays"]), pL.numpy(),
            float(pst["rays"]), exact.numpy(), ps)


def test_coated_cornell_per_sample(cornell_traced):
    jL, j_rays, pL, p_rays, exact, ps = cornell_traced
    assert ps.shaded_kinds == {MAT_DIFFUSE, MAT_COATEDDIFFUSE,
                               MAT_COATEDCONDUCTOR}
    assert pL.shape == jL.shape == (SPP * RES * RES, S)
    assert np.isfinite(pL).all() and p_rays == j_rays
    share, n_bad = share_close(pL, jL, rtol=1e-3, atol=1e-5)
    print(f"coated Cornell: {n_bad} of {jL.size} sample values disagree "
          f"(share {share:.5f})")
    assert share >= 0.99
    assert abs(pL.mean() - jL.mean()) <= 1e-3 * abs(jL.mean())
    # The exact keys draw other walk numbers on many lanes: the same
    # estimator, so the same image within the walk's noise.
    print(f"exact keys: share {share_close(exact, jL, 1e-3, 1e-5)[0]:.4f}, "
          f"mean {exact.mean():.6f} against {jL.mean():.6f}")
    assert abs(exact.mean() - jL.mean()) <= 3e-3 * abs(jL.mean())


def test_coated_cornell_gradients_match_golden():
    """The bench's loss and its gradients (albedo, area-light scale)
    through the coated walk under the remat path, on the CPU, against the
    JAX golden (both on coarse walk keys)."""
    z = np.load(GOLDEN_GRAD)
    res, k = int(z["resolution"]), int(z["samples_per_pass"])
    passes, depth = int(z["spp"]) // k, int(z["max_depth"])
    scene, camera = coated_cornell("pbrt_tpu_torch", (res, res))
    scene = scene.with_accel()
    integrator = PathIntegrator(max_depth=depth,
                                rr_start_depth=int(z["rr_start_depth"]))
    npix = res * res
    pixel = torch.arange(npix).repeat(k)
    target = torch.full((npix * k, 3), float(z["target"]))
    loss, grads = 0.0, {}
    with coarse_walk_keys(layered):
        for p in range(passes):
            sample = torch.arange(p * k, (p + 1) * k).repeat_interleave(npix)
            pl, pg = render_loss_and_grad(scene, camera, integrator, pixel,
                                          target, sample, int(z["seed"]),
                                          n_spectrum=int(z["n_spectrum"]))
            loss += float(pl) / passes
            for name, g in pg.items():
                grads[name] = grads.get(name, 0.0) + g.numpy() / passes
    assert loss == pytest.approx(float(z["loss"]), rel=1e-4)
    for name, key in (("materials.albedo_coeffs", "grad_albedo_coeffs"),
                      ("lights.area_scale", "grad_area_scale")):
        want = z[key]
        got = grads[name]
        assert got.shape == want.shape and np.all(np.isfinite(got))
        err = np.abs(got - want).max() / np.abs(want).max()
        print(f"{name}: max error {err:.2e} of the largest entry")
        assert err <= 1e-3, name
    # The coated diffuse (row 0: the white walls, boxes and light) carries
    # albedo gradient through the walk; the coated conductor's base (row
    # 3) reads no albedo, so its gradient is exactly 0, as the golden's.
    g_albedo = grads["materials.albedo_coeffs"]
    assert np.all(np.abs(g_albedo[0]) > 0.0)
    assert np.all(g_albedo[3] == 0.0)
    assert np.all(z["grad_albedo_coeffs"][3] == 0.0)


_MATERIALS_TEXT = """
LookAt 0 2 -6  0 0.5 0  0 1 0
Camera "perspective" "float fov" 40
WorldBegin
LightSource "point" "point3 from" [0 4 0] "rgb I" [5 5 5]
Material "coateddiffuse" "rgb reflectance" [0.3 0.4 0.5]
  "float roughness" 0.2 "float interface.roughness" 0.1
Shape "trianglemesh" "point3 P" [-2 0 -2 2 0 -2 2 0 2] "integer indices" [0 1 2]
Material "coatedconductor" "float conductor.roughness" 0.2
  "float interface.roughness" 0.3
Shape "trianglemesh" "point3 P" [-2 0 2 2 0 2 -2 1 2] "integer indices" [0 1 2]
Material "diffusetransmission" "rgb reflectance" [0.5 0.5 0.2]
  "rgb transmittance" [0.1 0.6 0.3]
Shape "trianglemesh" "point3 P" [-2 0 -2 -2 1 2 -2 0 2] "integer indices" [0 1 2]
Material "diffusetransmission"
Shape "trianglemesh" "point3 P" [2 0 -2 2 1 2 2 0 2] "integer indices" [0 1 2]
"""


def test_parser_builds_coated_and_transmissive_materials():
    """coateddiffuse, coatedconductor and diffusetransmission parse to the
    reference's tables; a texture-typed coat roughness raises, as the
    reference's float() of the texture's name does."""
    from pbrt_tpu.io.parser import load_pbrt_string as jax_load_pbrt_string
    from pbrt_tpu_torch.io.parser import load_pbrt_string

    from .test_torch_parser import _assert_same_build

    built = load_pbrt_string(_MATERIALS_TEXT, device="cpu")
    _assert_same_build(jax_load_pbrt_string(_MATERIALS_TEXT), built)
    assert built[0].shaded_kinds == {MAT_COATEDDIFFUSE, MAT_COATEDCONDUCTOR,
                                     MAT_DIFFUSETRANS}
    with pytest.raises(ValueError, match="no texture-typed roughness"):
        load_pbrt_string('Texture "r" "float" "constant" "float value" 0.2 '
                         'Material "coateddiffuse" '
                         '"texture interface.roughness" "r"', device="cpu")


def test_diffuse_transmission_torus_renders():
    """The mesh gallery with its glass torus made diffuse-transmissive: the
    scene builds and a pass of its 8x8 camera rays is finite, with light
    through the torus (both lobes of the family sampled)."""
    from pbrt_tpu_torch.render import render
    from pbrt_tpu_torch.scenes.meshes import mesh_gallery_scene

    scene, camera = mesh_gallery_scene(resolution=(8, 8), subdiv=1)
    kinds = scene.materials.kind.clone()
    assert kinds[2] == MAT_DIELECTRIC
    kinds[2] = MAT_DIFFUSETRANS
    scene = scene.replace(materials=scene.materials.replace(kind=kinds))
    assert MAT_DIFFUSETRANS in scene.shaded_kinds
    img = render(scene, camera, PathIntegrator(max_depth=3), spp=2,
                 samples_per_pass=2, n_spectrum=S, device="cpu")
    assert torch.isfinite(img).all() and float(img.mean()) > 0.0


def test_sorted_dispatch_gradients_match_lockstep():
    """The loss and its gradients through the sorted dispatch (sort_tile
    64: the 512 lanes sort) under the remat path equal the lockstep
    chain's: the loss bit for bit, the gradients within rtol 1e-5 (the
    gathers' backward sums duplicate rows in another order)."""
    scene, camera = coated_cornell("pbrt_tpu_torch", (16, 16))
    scene = scene.with_accel()
    pixel = torch.arange(256).repeat(2)
    sample = torch.arange(2).repeat_interleave(256)
    target = torch.full((512, 3), 0.25)
    out = {}
    for sort in (True, False):
        integ = PathIntegrator(max_depth=3, rr_start_depth=3,
                               sorted_shading=sort, sort_tile=64)
        out[sort] = render_loss_and_grad(scene, camera, integ, pixel, target,
                                         sample, 0, n_spectrum=S)
    assert torch.equal(out[True][0], out[False][0])
    for name, g in out[True][1].items():
        want = out[False][1][name]
        assert torch.isfinite(g).all() and bool((want != 0).any())
        torch.testing.assert_close(g, want, rtol=1e-5,
                                   atol=1e-7 * float(want.abs().max()))
