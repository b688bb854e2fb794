"""The port's measured, RGL, retroreflective and mix pieces against the
reference's on the CPU, on the same numpy-seeded inputs.

- bake_measured of one numpy BRDF, and bake_rgl of the families box's
  synthetic .bsdf: numpy on both sides, bit for bit; that file is
  tests/torch_port_families.py write_bsdf's output.
- The RGL tensor file: written by either package, read by the other, bit
  for bit; Marginal2D's evaluate, invert and sample bit for bit.
- The measured lookup (materials/bxdf.py _measured_f) over a stack of two
  random tables, per-ray table ids (-1 included) and directions on both
  sides: within rtol 1e-5 / atol 1e-7 on >= 99.5% of the values (a
  direction an ulp apart can fall into the next cell's taps).
- retro_f within rtol 1e-5 / atol 1e-6 on >= 99.5% of the lanes.
- The mix hash: the sub-material each lane takes, bit for bit on the same
  hit points and directions, and the share of lanes that take the first
  sub-material within 0.03 of its amount (0.3), the reference's gate.
- The parser's .npy table: the same table as the reference's parser
  binds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.materials import bxdf as jbxdf
from pbrt_tpu.materials import measured as jmeasured
from pbrt_tpu.materials import rgl as jrgl
from pbrt_tpu_torch.materials import bxdf, measured, rgl

from .torch_port_families import FAMILIES_BSDF, write_bsdf
from .torch_port_helpers import share_close

torch.set_num_threads(2)
N = 4096
S = 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _unit(r, n, both_sides=True):
    v = r.normal(size=(n, 3))
    if not both_sides:
        v[:, 2] = np.abs(v[:, 2]) + 0.05
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _numpy_brdf(wo, wi):
    """A smooth anisotropic-free lobe in numpy, (N, 3)."""
    wo, wi = np.asarray(wo, np.float64), np.asarray(wi, np.float64)
    h = wo + wi
    h /= np.linalg.norm(h, axis=-1, keepdims=True)
    lobe = np.exp(-8.0 * (1.0 - h[:, 2]))
    return np.stack([0.1 + 2.0 * lobe, 0.2 + lobe, 0.3 + 0.5 * lobe], -1)


def test_bake_measured_is_bit_equal():
    want = jmeasured.bake_measured(_numpy_brdf)
    got = measured.bake_measured(_numpy_brdf)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_families_bsdf_is_its_writer_output(tmp_path):
    """The committed families.bsdf is write_bsdf's output, byte for byte,
    with either package's writer."""
    with open(FAMILIES_BSDF, "rb") as f:
        want = f.read()
    for write in (rgl.write_tensor_file, jrgl.write_tensor_file):
        path = str(tmp_path / "f.bsdf")
        write_bsdf(path, write)
        with open(path, "rb") as f:
            assert f.read() == want


def test_bake_rgl_is_bit_equal():
    np.testing.assert_array_equal(rgl.bake_rgl(FAMILIES_BSDF),
                                  jrgl.bake_rgl(FAMILIES_BSDF))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tensor_file_round_trip(tmp_path, writer):
    r = np.random.default_rng(0)
    fields = {
        "theta_i": r.uniform(0, 1.5, 8).astype(np.float32),
        "ndf": r.uniform(size=(16, 32)).astype(np.float32),
        "counts": r.integers(0, 9, (3, 4)).astype(np.int64),
        "description": np.frombuffer(b"synthetic", np.uint8),
    }
    path = str(tmp_path / "t.bsdf")
    write, read = ((jrgl.write_tensor_file, rgl.read_tensor_file)
                   if writer == "jax" else
                   (rgl.write_tensor_file, jrgl.read_tensor_file))
    write(path, fields)
    back = read(path)
    assert list(back) == list(fields)
    for k, v in fields.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
    with open(path, "rb") as f:
        raw = f.read()
    other = str(tmp_path / "u.bsdf")
    (rgl.write_tensor_file if writer == "jax" else jrgl.write_tensor_file)(
        other, fields)
    with open(other, "rb") as f:
        assert f.read() == raw


def test_marginal2d_is_bit_equal():
    r = np.random.default_rng(1)
    grid = r.uniform(0.2, 3.0, size=(3, 4, 12, 20))
    nodes = (np.linspace(0, 1, 3), np.linspace(0, 2, 4))
    params = (r.uniform(0, 1, 500), r.uniform(0, 2, 500))
    u1, u2 = r.uniform(0.01, 0.99, 500), r.uniform(0.01, 0.99, 500)
    mj, mp = jrgl.Marginal2D(grid, nodes), rgl.Marginal2D(grid, nodes)
    for name, args in (("sample", (u1, u2)), ("invert", (u1, u2)),
                       ("evaluate", (u1, u2))):
        want = getattr(mj, name)(*args, params)
        got = getattr(mp, name)(*args, params)
        for a, b in zip(np.atleast_2d(got), np.atleast_2d(want)):
            np.testing.assert_array_equal(a, b)


def _lam(r, n):
    return (360.0 + 470.0 * r.uniform(size=(n, S))).astype(np.float32)


def test_measured_lookup_matches_jax():
    r = np.random.default_rng(2)
    shape = (2, measured.N_TH, measured.N_TD, measured.N_PD)
    coeffs = r.normal(0.0, 2.0, shape + (3,)).astype(np.float32)
    scale = r.uniform(0.0, 3.0, shape).astype(np.float32)
    idx = r.integers(-1, 2, N).astype(np.int32)
    wo, wi, lam = _unit(r, N), _unit(r, N), _lam(r, N)
    want = np.asarray(jbxdf._measured_f(
        {"measured_coeffs": jnp.asarray(coeffs),
         "measured_scale": jnp.asarray(scale),
         "measured_idx": jnp.asarray(idx)},
        jnp.asarray(wo), jnp.asarray(wi), jnp.asarray(lam)))
    got = bxdf._measured_f(
        {"measured_coeffs": _t(coeffs), "measured_scale": _t(scale),
         "measured_idx": _t(idx)}, _t(wo), _t(wi), _t(lam)).numpy()
    assert (got[idx < 0] == 0).all() and (got[wo[:, 2] * wi[:, 2] <= 0] == 0).all()
    share, n_bad = share_close(got, want, rtol=1e-5, atol=1e-7)
    assert share >= 0.995, n_bad
    # A table's own f: MeasuredBRDF over the first table.
    m = measured.MeasuredBRDF(coeffs=_t(coeffs[0]), scale=_t(scale[0]))
    mj = jmeasured.MeasuredBRDF(coeffs=jnp.asarray(coeffs[0]),
                                scale=jnp.asarray(scale[0]))
    share, n_bad = share_close(
        m.f(_t(wo), _t(wi), _t(lam)).numpy(),
        np.asarray(mj.f(jnp.asarray(wo), jnp.asarray(wi), jnp.asarray(lam))),
        rtol=1e-5, atol=1e-7)
    assert share >= 0.995, n_bad


def test_retro_f_matches_jax():
    r = np.random.default_rng(3)
    wo, wi = _unit(r, N, both_sides=False), _unit(r, N)
    # wi near wo: the retro lobe's peak.
    near = r.random(N) < 0.3
    wi[near] = wo[near] + 0.05 * r.normal(size=(int(near.sum()), 3))
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    eta = r.uniform(0.1, 1.5, (N, S)).astype(np.float32)
    k = r.uniform(1.0, 8.0, (N, S)).astype(np.float32)
    alpha = r.uniform(0.0, 0.6, N).astype(np.float32)
    want = np.asarray(jax.jit(jbxdf.retro_f)(*(jnp.asarray(x) for x in
                                               (eta, k, alpha, wo, wi))))
    got = bxdf.retro_f(*(_t(x) for x in (eta, k, alpha, wo, wi))).numpy()
    assert np.isfinite(got).all()
    share, n_bad = share_close(got, want, rtol=1e-5, atol=1e-6)
    assert share >= 0.995, n_bad


def _mix_scenes():
    """tests/test_measured.py's mix configuration: one triangle whose
    material mixes a red and a blue diffuse with amount 0.3, in both
    packages."""
    from pbrt_tpu.lights.buffers import LightBuffers as JL
    from pbrt_tpu.materials.buffers import MaterialBuffers as JM
    from pbrt_tpu.scene import Scene as JS
    from pbrt_tpu.shapes.geometry import GeometryBuffers as JG
    from pbrt_tpu_torch.lights.buffers import LightBuffers
    from pbrt_tpu_torch.materials.buffers import MAT_MIX, MaterialBuffers
    from pbrt_tpu_torch.scene import Scene
    from pbrt_tpu_torch.shapes.geometry import GeometryBuffers

    tri = np.asarray([[[-50, 0, -50], [50, 0, -50], [0, 0, 80]]], np.float32)
    mats = [{"kind": 0, "albedo": (0.9, 0.1, 0.1)},
            {"kind": 0, "albedo": (0.1, 0.1, 0.9)},
            {"kind": MAT_MIX, "mix_m0": 0, "mix_m1": 1, "mix_amount": 0.3}]
    kw = dict(tri_verts=tri, tri_mat=np.asarray([2], np.int32),
              tri_light=np.asarray([-1], np.int32))
    js = JS(geom=JG.build(**kw), materials=JM.build(mats), lights=JL.build())
    ps = Scene(geom=GeometryBuffers.build(**kw),
               materials=MaterialBuffers.build(mats),
               lights=LightBuffers.build())
    return js, ps


def test_mix_hash_matches_jax():
    """The reference's surface_params resolution against the port's on the
    same hit points and directions (both taken from the reference's
    query): the same sub-material on every lane; about `amount` of the
    lanes take the first."""
    from pbrt_tpu.accel import api as jax_api
    from pbrt_tpu_torch.shapes.geometry import Interaction

    js, ps = _mix_scenes()
    r = np.random.default_rng(0)
    n = 8192
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = r.uniform(-20, 20, n)
    o[:, 2] = r.uniform(-20, 20, n)
    o[:, 1] = 5.0
    d = r.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1]) - 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lam = jnp.full((n, S), 550.0)
    fields = ("valid", "t", "p", "n", "uv", "wo", "mat", "light", "prim",
              "dpdu")

    def reference(o, d):
        ji = jax_api.closest(js, o, d)
        return ([getattr(ji, f) for f in fields],
                jbxdf.surface_params(js, ji, lam)["albedo_coeffs"])

    ji, want = jax.jit(reference)(jnp.asarray(o), jnp.asarray(d))
    pi = Interaction(**{f: _t(v) for f, v in zip(fields, ji)})
    got = bxdf.surface_params(ps, pi, _t(lam))
    np.testing.assert_array_equal(got["albedo_coeffs"].numpy(),
                                  np.asarray(want))
    first = bxdf.resolve_mix(ps.materials, pi.mat, pi.p, pi.wo) == 0
    hit = pi.valid
    assert hit.float().mean() > 0.9
    assert abs(float(first[hit].float().mean()) - 0.3) < 0.03


def test_parser_binds_the_reference_table(tmp_path):
    """A baked .npy table (the .bsdf file: bake_rgl above, and the
    families box's build in tests/test_torch_families.py)."""
    from pbrt_tpu.io.parser import PbrtParser as JParser
    from pbrt_tpu_torch.io.parser import PbrtParser

    table = np.random.default_rng(4).uniform(
        0, 1, (measured.N_TH, measured.N_TD, measured.N_PD, 3)
    ).astype(np.float32)
    np.save(tmp_path / "t.npy", table)
    text = 'Material "measured" "string filename" "t.npy"\n'
    tables = []
    for cls in (JParser, PbrtParser):
        parser = cls(str(tmp_path))
        parser.parse_string(text)
        tables.append(parser.materials[-1]["measured_table"])
        assert parser.materials[-1]["kind"] == 9
    np.testing.assert_array_equal(np.asarray(tables[1]),
                                  np.asarray(tables[0]))
