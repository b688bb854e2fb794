"""The port's light BVH and exhaustive light sampler against the reference
on the CPU.

- The host build (lights/bvh.py, copied from the reference): nodes, paths
  and path lengths bit-equal to LightBVH.build's for 64 and 1,024 lights
  (the many-light hall's panels), and the exhaustive sampler's records
  equal to pack_light_records'.
- `sample` and `pmf` on 4,096 shading points (positions, normals, u):
  the chosen light equal on >= 99.9% of points (a u within an ulp of a
  branch's probability may go either way) and the pmf within rtol 5e-5
  there; `pmf` of those lights within rtol 5e-5 everywhere (a product of
  up to 15 branch probabilities: measured 1.6e-5).
- The port's sample frequencies against its own pmf at three shading
  points (tests/test_lightbvh.py's method, 20,000 stratified u).
- The exhaustive sampler's selection and pmf against the reference's on
  4,096 points (the same light on >= 99.9%, pmf within rtol 1e-5), and the
  light-BVH LightBuffers' select / selection_pmf with an infinite light
  in the list (the count-proportional split).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.lights import bvh as jbvh
from pbrt_tpu.lights.buffers import LightBuffers as JLightBuffers
from pbrt_tpu_torch.lights import bvh
from pbrt_tpu_torch.lights.buffers import LightBuffers

torch.set_num_threads(2)
N = 4096


def _hall_panels(n_side, seed=7):
    """The many-light hall's ceiling panels (scenes/manylight.py): two area
    triangles per panel, power-law scales."""
    r = np.random.default_rng(seed)
    pitch = 40.0 / n_side
    specs = []
    for i in range(n_side):
        for j in range(n_side):
            x = -20.0 + (i + 0.5) * pitch
            z = -20.0 + (j + 0.5) * pitch
            s = pitch * 0.3
            q = np.asarray([[x - s, 6.0, z - s], [x + s, 6.0, z - s],
                            [x + s, 6.0, z + s], [x - s, 6.0, z + s]],
                           np.float32)
            scale = float(10.0 * r.pareto(1.5) + 0.2)
            hue = tuple(r.uniform(0.6, 1.0, 3))
            for tri in (q[[0, 1, 2]], q[[0, 2, 3]]):
                specs.append({"verts": tri, "rgb": hue, "scale": scale})
    return specs


@pytest.fixture(scope="module")
def built():
    """(port, reference) LightBuffers with the BVH sampler over the first
    64 area triangles of an 8 x 8 panel grid and the first 1,024 of the
    hall's 32 x 32 grid, and the light specs."""
    out = {}
    for n_lights, n_side in ((64, 8), (1024, 32)):
        specs = _hall_panels(n_side)[:n_lights]
        out[n_lights] = (LightBuffers.build(area_tris=specs, sampler="bvh"),
                         JLightBuffers.build(area_tris=specs, sampler="bvh"),
                         specs)
    return out


@pytest.mark.parametrize("n_lights", [64, 1024])
def test_tables_are_bit_equal(built, n_lights):
    pl, jl, _ = built[n_lights]
    assert pl.bvh.n_lights == jl.bvh.n_lights == n_lights
    assert pl.bvh.max_depth == jl.bvh.max_depth
    for name in ("nodes", "paths", "path_len"):
        got, want = getattr(pl.bvh, name).numpy(), np.asarray(
            getattr(jl.bvh, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_exhaustive_records_are_bit_equal(built):
    _, _, specs = built[64]
    pl = LightBuffers.build(area_tris=specs, sampler="exhaustive")
    jl = JLightBuffers.build(area_tris=specs, sampler="exhaustive")
    np.testing.assert_array_equal(pl.exh_recs.numpy(), np.asarray(jl.exh_recs))
    assert pl.bvh is None and pl._p_infinite == 0.0


def _points(seed, n=N):
    """Shading points under and beside the panels, with unit normals (an
    eighth of them zero: no surface orientation) and u in [0, 1)."""
    r = np.random.default_rng(seed)
    p = np.stack([r.uniform(-25, 25, n), r.uniform(-1, 7, n),
                  r.uniform(-25, 25, n)], -1).astype(np.float32)
    nrm = r.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[: n // 8] = 0.0
    u = r.uniform(0, 1, n).astype(np.float32)
    return p, nrm.astype(np.float32), u


@pytest.mark.parametrize("n_lights", [64, 1024])
def test_sample_and_pmf_match(built, n_lights):
    pl, jl, _ = built[n_lights]
    p, nrm, u = _points(n_lights)
    li, pm = bvh.sample(pl.bvh, torch.from_numpy(p), torch.from_numpy(nrm),
                        torch.from_numpy(u))
    jli, jpm = jbvh.sample(jl.bvh, jnp.asarray(p), jnp.asarray(nrm),
                           jnp.asarray(u))
    li, pm, jli, jpm = li.numpy(), pm.numpy(), np.array(jli), np.asarray(jpm)
    same = li == jli
    print(f"{n_lights} lights: {np.sum(~same)} of {N} picks differ")
    assert same.mean() >= 0.999 and (li >= 0).mean() > 0.9
    np.testing.assert_allclose(pm[same], jpm[same], rtol=5e-5, atol=1e-12)
    # The replayed path's pmf of the chosen light is the sampled pmf.
    q = bvh.pmf(pl.bvh, torch.from_numpy(p), torch.from_numpy(nrm),
                torch.from_numpy(jli)).numpy()
    jq = np.asarray(jbvh.pmf(jl.bvh, jnp.asarray(p), jnp.asarray(nrm),
                             jnp.asarray(jli)))
    np.testing.assert_allclose(q, jq, rtol=5e-5, atol=1e-12)
    np.testing.assert_allclose(q[li >= 0], pm[li >= 0], rtol=5e-5)


def test_sample_frequencies_match_pmf(built):
    pl, _, _ = built[64]
    nl = pl.bvh.n_lights
    m = 20000
    u = (torch.arange(m, dtype=torch.float32) + 0.5) / m
    for pt in ([0.0, 0.0, 0.0], [15.0, 1.0, -10.0], [-18.0, 3.0, 18.0]):
        p0 = torch.tensor(pt)
        n0 = torch.tensor([0.0, 1.0, 0.0])
        li, pm = bvh.sample(pl.bvh, p0.expand(m, 3), n0.expand(m, 3), u)
        assert bool((li >= 0).all())
        freq = np.bincount(li.numpy(), minlength=nl) / m
        q = bvh.pmf(pl.bvh, p0.expand(nl, 3), n0.expand(nl, 3),
                    torch.arange(nl)).numpy()
        np.testing.assert_allclose(q.sum(), 1.0, atol=1e-4)
        np.testing.assert_allclose(freq, q, atol=2e-3)
        np.testing.assert_allclose(pm.numpy(), q[li.numpy()], rtol=1e-5)


def test_exhaustive_sampler_matches(built):
    _, _, specs = built[64]
    pl = LightBuffers.build(area_tris=specs, sampler="exhaustive")
    jl = JLightBuffers.build(area_tris=specs, sampler="exhaustive")
    p, nrm, u = _points(5)
    tp, tn, tu = (torch.from_numpy(x) for x in (p, nrm, u))
    imp = bvh.exhaustive_importance(pl.exh_recs, tp, tn).numpy()
    jimp = np.asarray(jbvh.exhaustive_importance(jl.exh_recs, jnp.asarray(p),
                                                 jnp.asarray(nrm)))
    np.testing.assert_allclose(imp, jimp, rtol=1e-5, atol=1e-12)
    li, pm = pl.select(tp, tn, tu)
    jli, jpm = jl.select(jnp.asarray(p), jnp.asarray(nrm), jnp.asarray(u))
    same = li.numpy() == np.asarray(jli)
    assert same.mean() >= 0.999
    np.testing.assert_allclose(pm.numpy()[same], np.asarray(jpm)[same],
                               rtol=1e-5, atol=1e-12)
    idx = np.random.default_rng(6).integers(0, 64, N)
    q = pl.selection_pmf(torch.from_numpy(idx), tp, tn).numpy()
    jq = np.asarray(jl.selection_pmf(jnp.asarray(idx, jnp.int32),
                                     jnp.asarray(p), jnp.asarray(nrm)))
    np.testing.assert_allclose(q, jq, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("sampler", ["bvh", "exhaustive"])
def test_infinite_light_split_matches(built, sampler):
    """With a uniform infinite light beside the panels, u below
    p_inf = 1/2 picks it (pmf 1/2), the rest descends the positional
    lights; pdf_escaped carries the split in BVH mode."""
    _, _, specs = built[64]
    inf = {"rgb": (0.3, 0.4, 0.5), "scale": 0.5}
    pl = LightBuffers.build(area_tris=specs, infinite=inf, sampler=sampler)
    jl = JLightBuffers.build(area_tris=specs, infinite=inf, sampler=sampler)
    assert pl._p_infinite == jl._p_infinite == 0.5
    p, nrm, u = _points(9)
    tp, tn, tu = (torch.from_numpy(x) for x in (p, nrm, u))
    li, pm = pl.select(tp, tn, tu)
    jli, jpm = jl.select(jnp.asarray(p), jnp.asarray(nrm), jnp.asarray(u))
    same = li.numpy() == np.asarray(jli)
    assert same.mean() >= 0.999
    assert np.all(li.numpy()[u < 0.5] == 64) and np.all(pm.numpy()[u < 0.5] == 0.5)
    np.testing.assert_allclose(pm.numpy()[same], np.asarray(jpm)[same],
                               rtol=1e-5, atol=1e-12)
    idx = np.random.default_rng(6).integers(-1, 65, N)
    q = pl.selection_pmf(torch.from_numpy(idx), tp, tn).numpy()
    jq = np.asarray(jl.selection_pmf(jnp.asarray(idx, jnp.int32),
                                     jnp.asarray(p), jnp.asarray(nrm)))
    np.testing.assert_allclose(q, jq, rtol=1e-5, atol=1e-12)
    d = torch.nn.functional.normalize(tn + 0.1, dim=-1)
    np.testing.assert_allclose(
        pl.pdf_escaped(d, tp).numpy(),
        np.asarray(jl.pdf_escaped(jnp.asarray(d.numpy()), jnp.asarray(p))),
        rtol=1e-6)
