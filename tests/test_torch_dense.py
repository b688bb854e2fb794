"""The port's dense tester (pbrt_tpu_torch/accel/dense.py) against the JAX
reference's (pbrt_tpu/accel/dense.py) on the CPU, on seeded random
scenes and rays aimed at them.

- The watertight triangle test: t, u and v bit-equal to the reference's
  jitted block, and the blocked closest and any-hit queries bit-equal
  (the reference's CPU build fuses the shear and the t numerator into
  multiply-adds; the port computes them so).
- difference_of_products: equal products give exactly 0 and swapped
  arguments the exact negation; a ray through a shared edge hits.
- Spheres, curve segments, disks, cylinders and bilinear patches: the
  same prim on every ray, t within rtol 1e-5 and uv within 1e-4.
- The ray chunks change nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.accel import dense as jdense
from pbrt_tpu.core.floats import difference_of_products as jdop
from pbrt_tpu.shapes.geometry import GeometryBuffers as JGeometryBuffers
from pbrt_tpu_torch.accel import dense
from pbrt_tpu_torch.core.floats import difference_of_products
from pbrt_tpu_torch.shapes.geometry import GeometryBuffers

torch.set_num_threads(2)
RTOL = 1e-5


def _rays(rng, n, targets, spread=0.2):
    """n rays from a box around the scene toward jittered target points."""
    o = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    tgt = targets[rng.integers(0, len(targets), n)] + rng.normal(
        scale=spread, size=(n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _shapes(rng):
    """A few of every family, as build() arguments (numpy)."""
    tv = rng.normal(scale=0.8, size=(2100, 3, 3)).astype(np.float32)
    sph = np.concatenate([rng.normal(size=(5, 3)),
                          rng.uniform(0.1, 0.4, (5, 1))], 1)
    p0 = rng.normal(size=(40, 3))
    p1 = p0 + rng.normal(scale=0.3, size=(40, 3))
    r = rng.uniform(0.01, 0.05, (40, 2))
    crv = np.concatenate([p0, p1, r], 1)
    crv_u = np.sort(rng.uniform(size=(40, 2)), axis=1)
    nrm = rng.normal(size=(6, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    disk = np.concatenate([rng.normal(size=(6, 3)), nrm,
                           rng.uniform(0.3, 0.6, (6, 1)),
                           rng.uniform(0.0, 0.2, (6, 1))], 1)
    ax = rng.normal(size=(4, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    cyl = np.concatenate([rng.normal(size=(4, 3)), ax,
                          rng.uniform(0.1, 0.3, (4, 1)),
                          rng.uniform(0.2, 0.6, (4, 1))], 1)
    base = rng.normal(size=(5, 1, 3))
    blp = (base + rng.normal(scale=0.5, size=(5, 4, 3))).reshape(5, 12)
    f = np.float32
    return dict(tri_verts=tv, spheres=sph.astype(f), crv=crv.astype(f),
                crv_u=crv_u.astype(f), crv_mat=np.arange(40) % 3,
                disk=disk.astype(f), cyl=cyl.astype(f), blp=blp.astype(f))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    args = _shapes(rng)
    targets = np.concatenate([
        args["tri_verts"].mean(1), args["spheres"][:, :3],
        args["crv"][:, :3], args["disk"][:, :3], args["cyl"][:, :3],
        args["blp"].reshape(-1, 4, 3).mean(1)])
    o, d = _rays(rng, 1500, targets)
    tmax = np.where(rng.uniform(size=1500) < 0.2, 2.0, np.inf).astype(
        np.float32)
    return args, (o, d, tmax)


def _both(args, **only):
    a = {k: v for k, v in args.items() if not only or k in only}
    return JGeometryBuffers.build(**a), GeometryBuffers.build(**a)


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def test_difference_of_products_exact():
    rng = np.random.default_rng(1)
    a, b, c, d = (torch.from_numpy((rng.normal(size=4096)
                                    * 10.0 ** rng.integers(-6, 6, 4096))
                                   .astype(np.float32)) for _ in range(4))
    assert torch.all(difference_of_products(a, b, a, b) == 0.0)
    assert torch.equal(difference_of_products(c, d, a, b),
                       -difference_of_products(a, b, c, d))
    want = np.asarray(jax.jit(jdop)(*_j(a, b, c, d)))
    np.testing.assert_array_equal(difference_of_products(a, b, c, d).numpy(),
                                  want)


def test_watertight_block_bit_equal(scene):
    args, (o, d, tmax) = scene
    tv = args["tri_verts"][:300]
    soa, _ = jdense._tri_soa(jnp.asarray(tv))
    want = jax.jit(jdense._intersect_tri_block_wt)(*_j(o, d, tmax), soa)
    got = dense._intersect_tri_block_wt(*_t(o, d, tmax),
                                        dense._tri_soa(torch.from_numpy(tv)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:, :300])
    assert np.isfinite(got[0].numpy()).sum() > 100


def test_closest_tri_and_any_bit_equal(scene):
    args, (o, d, tmax) = scene
    jg, pg = _both(args, tri_verts=1)
    want = jax.jit(lambda o, d, t: jdense.intersect_closest_tri(jg, o, d, t))(
        *_j(o, d, tmax))
    got = dense.intersect_closest_tri(pg, *_t(o, d, tmax))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[1].numpy() >= 2048).any()  # the second block answers
    occ = jax.jit(lambda o, d, t: jdense.intersect_any(jg, o, d, t))(
        *_j(o, d, tmax))
    np.testing.assert_array_equal(dense.intersect_any(pg, *_t(o, d, tmax)).numpy(),
                                  np.asarray(occ))


def test_shared_edge_is_watertight():
    """Rays aimed at the shared diagonal of a quad's two triangles (away
    from the quad's corners, where a rounded ray may pass outside) hit
    one of them."""
    quad = np.asarray([[[0, 0, 0], [1, 0, 0], [1, 1, 0]],
                       [[0, 0, 0], [1, 1, 0], [0, 1, 0]]], np.float32)
    s = np.linspace(0.01, 0.99, 257, dtype=np.float32)
    tgt = np.stack([s, s, np.zeros_like(s)], 1)
    rng = np.random.default_rng(2)
    o = (tgt + rng.normal(size=tgt.shape) * [0.3, 0.3, 0]
         + [0, 0, 2]).astype(np.float32)
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    g = GeometryBuffers.build(tri_verts=quad)
    t, prim, _, _ = dense.intersect_closest_tri(g, *_t(o, d))
    assert torch.all(prim >= 0) and torch.all(torch.isfinite(t))


def _hold(want, got, n_check_uv=True):
    """The same index on every ray; t within RTOL; u, v within 1e-4."""
    w = [np.asarray(x) for x in want]
    g = [x.numpy() for x in got]
    np.testing.assert_array_equal(g[1], w[1])
    hit = w[1] >= 0
    assert hit.sum() > 20
    np.testing.assert_allclose(g[0][hit], w[0][hit], rtol=RTOL)
    assert np.all(np.isinf(g[0][~hit]))
    if n_check_uv:
        np.testing.assert_allclose(g[2][hit], w[2][hit], atol=1e-4)
        np.testing.assert_allclose(g[3][hit], w[3][hit], atol=1e-4)


def _normals(dmod, geom, o, d, best, family):
    """The geometric normals of a family's best hits (dmod: either
    package's dense module)."""
    if family == "blp":
        return dmod.blp_normal(geom, *best[1:])
    flag = best[1] * 0 + (1 if family == "disk" else 0) > 0
    return dmod.disk_cyl_normals(geom, o, d, best[0], flag, best[1])


@pytest.mark.parametrize("family", ["disk", "cyl", "blp", "curve"])
def test_analytic_family_matches_jax(scene, family):
    """The nearest hit of each family and its normal (the curves' frame
    is checked through intersect_closest)."""
    args, (o, d, tmax) = scene
    key = {"curve": "crv"}.get(family, family)
    only = {key: 1, "crv_u": 1} if family == "curve" else {key: 1}
    jg, pg = _both(args, **only)
    fn = {"disk": "disk_best", "cyl": "cyl_best", "blp": "blp_best",
          "curve": "curve_best"}[family]

    def jax_fn(o, d, t):
        best = getattr(jdense, fn)(jg, o, d, t)
        if family == "curve":
            return best, None
        return best, _normals(jdense, jg, o, d, best, family)

    want, want_n = jax.jit(jax_fn)(*_j(o, d, tmax))
    got = getattr(dense, fn)(pg, *_t(o, d, tmax))
    _hold(want, got)
    if family != "curve":
        hit = np.asarray(want[1]) >= 0
        n = _normals(dense, pg, *_t(o, d), got, family)
        np.testing.assert_allclose(n.numpy()[hit], np.asarray(want_n)[hit],
                                   atol=1e-4)


def test_closest_all_families_matches_jax(scene):
    """intersect_closest (triangles, spheres, curves: t, prim, normals,
    uv, the curves' tangents, materials) and intersect_any."""
    args, (o, d, tmax) = scene
    jg, pg = _both(dict(args, tri_verts=args["tri_verts"][:300]))
    want = jax.jit(lambda o, d, t: jdense.intersect_closest(jg, o, d, t))(
        *_j(o, d, tmax))
    got = dense.intersect_closest(pg, *_t(o, d, tmax))
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want.prim))
    hit = np.asarray(want.valid)
    assert (got.prim.numpy() >= 300 + 5).any()  # curve hits
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=RTOL)
    for name in ("n", "uv", "dpdu"):
        np.testing.assert_allclose(getattr(got, name).numpy()[hit],
                                   np.asarray(getattr(want, name))[hit],
                                   atol=2e-4, err_msg=name)
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(want.mat))
    occ = jax.jit(lambda o, d, t: jdense.intersect_any(jg, o, d, t))(
        *_j(o, d, tmax))
    np.testing.assert_array_equal(
        dense.intersect_any(pg, *_t(o, d, tmax)).numpy(), np.asarray(occ))


def test_ray_chunks_change_nothing(scene, monkeypatch):
    args, (o, d, tmax) = scene
    _, pg = _both(args)
    whole = dense.intersect_closest(pg, *_t(o, d, tmax))
    whole_b = dense.blp_best(pg, *_t(o, d, tmax))
    monkeypatch.setattr(dense, "_CHUNK_ELEMS", 2048 * 64)
    assert len(dense._ray_chunks(o.shape[0], 2048)) == 24
    cut = dense.intersect_closest(pg, *_t(o, d, tmax))
    for name in ("t", "prim", "uv", "n"):
        assert torch.equal(getattr(cut, name), getattr(whole, name)), name
    for a, b in zip(dense.blp_best(pg, *_t(o, d, tmax)), whole_b):
        assert torch.equal(a, b)
