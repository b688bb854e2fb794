"""The SAH kd-tree in the port against the reference on the CPU: the build
(the reference's host code) gives the same node arrays, a converted JAX
kd-tree equals the port's, and the lockstep walk answers as the
reference's per-ray walk on the Cornell box. chip_smoke.py phase d6
renders the Cornell box on the card with only the kd-tree attached.

Tolerances: prim and occlusion must agree on every ray; t, u and v carry
the multiply-add residue of XLA's CPU backend (rtol 2e-6 for t, atol 3e-5
for u and v, as tests/test_torch_cluster.py states them).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.accel.kdtree import kdtree_intersect as jax_kdtree_intersect
from pbrt_tpu.scenes.cornell import cornell_box as jax_cornell_box
from pbrt_tpu_torch.accel import api
from pbrt_tpu_torch.accel.kdtree import build_kdtree, kdtree_intersect
from pbrt_tpu_torch.convert import scene_from_arrays
from pbrt_tpu_torch.render import camera_rays_full
from pbrt_tpu_torch.scenes.cornell import cornell_box

from .torch_port_helpers import flatten_jax

torch.set_num_threads(2)
_KEYS = ("axis", "split", "above", "prim_off", "prim_cnt", "prim_indices",
         "tri_verts", "bounds_lo", "bounds_hi")


@pytest.fixture(scope="module")
def trees():
    js, _ = jax_cornell_box(resolution=(8, 8))
    js = js.replace(small=None).with_kdtree()
    scene, camera = cornell_box(resolution=(16, 16))
    return js, scene.with_kdtree(), camera


def _rays(camera):
    """1,024 rays: the camera's, rays from inside the box in random and
    axis-parallel directions, and finite segments; every ninth lane dead
    (tmax = 0)."""
    r = np.random.default_rng(6)
    pixel = torch.from_numpy(r.integers(0, 256, 256))
    o_cam, d_cam, _, _ = camera_rays_full(camera, pixel, 0, 0)
    o = r.uniform(0.02, 0.98, (768, 3))
    d = r.normal(size=(768, 3))
    d[::3] = np.eye(3)[r.integers(0, 3, 256)] * r.choice([-1.0, 1.0], (256, 1))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.concatenate([o_cam.numpy(), o]).astype(np.float32)
    d = np.concatenate([d_cam.numpy(), d]).astype(np.float32)
    tmax = np.full(1024, np.inf, np.float32)
    tmax[512:] = r.uniform(0.05, 1.0, 512)
    tmax[::9] = 0.0
    return o, d, tmax


def test_build_and_convert_equal(trees):
    js, ps, _ = trees
    jk, kd = js.kdtree, ps.kdtree
    assert kd.n_nodes == jk.n_nodes > 8
    for key in _KEYS:
        np.testing.assert_array_equal(getattr(kd, key).numpy(),
                                      np.asarray(getattr(jk, key)), key)
    conv = scene_from_arrays(*flatten_jax(js))
    assert conv.small is None and conv.kdtree.n_nodes == jk.n_nodes
    for key in _KEYS:
        assert torch.equal(getattr(conv.kdtree, key), getattr(kd, key)), key
    # A direct build from the triangles is the same tree.
    direct = build_kdtree(ps.geom.tri_verts.numpy())
    assert torch.equal(direct.split, kd.split)


def test_walk_matches_reference(trees):
    js, ps, camera = trees
    o, d, tmax = _rays(camera)
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax)
    want = [np.asarray(x) for x in jax_kdtree_intersect(js.kdtree, jo, jd, jt)]
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax))
    t, prim, u, v = (x.numpy() for x in kdtree_intersect(ps.kdtree, *args))
    hits = want[1] >= 0
    assert 0.5 < hits.mean() < 1.0 and not np.any(hits[::9])
    np.testing.assert_array_equal(prim, want[1])
    assert np.all(np.isinf(t[~hits]))
    np.testing.assert_allclose(t[hits], want[0][hits], rtol=2e-6)
    for got, ref in ((u, want[2]), (v, want[3])):
        np.testing.assert_allclose(got[hits], ref[hits], rtol=1e-5, atol=3e-5)
    occ = kdtree_intersect(ps.kdtree, *args, any_hit=True).numpy()
    np.testing.assert_array_equal(
        occ, np.asarray(jax_kdtree_intersect(js.kdtree, jo, jd, jt,
                                             any_hit=True)))


def test_kdtree_tier_answers_the_queries(trees):
    """With only the kd-tree attached, closest and any-hit go through it,
    with the reference's attributes; the small tier, when also attached,
    keeps precedence in closest and the kd-tree in any-hit."""
    _, ps, camera = trees
    o, d, tmax = (torch.from_numpy(x) for x in _rays(camera))
    kd_only = ps.replace(small=None)
    t, prim, u, v = kdtree_intersect(ps.kdtree, o, d, tmax)
    isect = api.closest(kd_only, o, d, tmax)
    assert torch.equal(isect.prim, prim) and torch.equal(isect.t, t)
    assert torch.equal(isect.uv, torch.stack([u, v], dim=-1))
    hit = prim >= 0
    geom = ps.geom
    assert torch.equal(isect.mat[hit], geom.tri_mat[prim[hit].long()])
    assert torch.equal(isect.light[hit], geom.tri_light[prim[hit].long()])
    occ = kdtree_intersect(ps.kdtree, o, d, tmax, any_hit=True)
    assert torch.equal(api.any_hit(kd_only, o, d, tmax), occ)
    both = ps.with_accel().replace(kdtree=ps.kdtree)
    assert both.small is not None
    small_only = ps.with_accel()
    assert torch.equal(api.closest(both, o, d, tmax).t,
                       api.closest(small_only, o, d, tmax).t)
    assert torch.equal(api.any_hit(both, o, d, tmax), occ)
