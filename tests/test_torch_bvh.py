"""The BVH tier's build and K4's plain twin against the reference on the
CPU: the implicit-heap tables bit for bit (built and converted), the twin
against the jnp traversal `bvh_intersect` and against the Pallas kernel K4
(`pallas_bvh_intersect`) in interpret mode, and the BVH branches of the
port's closest / any-hit. The kernel itself is held against the twin on a
card by tests/test_torch_cuda.py; the BVH tier in a path-traced pass is in
tests/test_torch_killeroo.py.

Tolerances: prim (or occlusion) must agree on every ray. t, u and v carry
the fused-multiply-add residue of XLA's CPU backend, which the twin does
not have (ROADMAP Queue 3): t at rtol 2e-6 and u, v at rtol 1e-5 / atol
3e-5, as tests/test_torch_cluster.py states them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.accel.bvh import _aabb_hit as jax_aabb_hit
from pbrt_tpu.accel.bvh import build_bvh as jax_build_bvh
from pbrt_tpu.accel.bvh import bvh_intersect as jax_bvh_intersect
from pbrt_tpu.ops.traverse import pallas_bvh_intersect
from pbrt_tpu_torch.accel import api
from pbrt_tpu_torch.accel.bvh import build_bvh, bvh_intersect_ref
from pbrt_tpu_torch.convert import scene_from_arrays
from pbrt_tpu_torch.lights.buffers import LightBuffers
from pbrt_tpu_torch.materials.buffers import MaterialBuffers
from pbrt_tpu_torch.ops import traverse
from pbrt_tpu_torch.scene import Scene
from pbrt_tpu_torch.scenes.meshes import fbm_blob
from pbrt_tpu_torch.shapes.geometry import GeometryBuffers

from .test_torch_cluster import _rays
from .torch_port_helpers import flatten_jax
from .torch_port_killeroo import small_killeroo_class_scene

torch.set_num_threads(2)
_KEYS = ("node_lo", "node_hi", "v0", "e1", "e2", "prim_id")


@pytest.fixture(scope="module")
def bvhs():
    """fbm_blob(3): 1,280 triangles in 320 leaves of a depth-9 tree, so 192
    of its 512 leaves are padding."""
    tris = fbm_blob(3)
    return tris, jax_build_bvh(tris), build_bvh(tris)


@pytest.fixture(scope="module")
def reference(bvhs):
    """The reference's answers on _rays(), each JAX call compiled once:
    {(engine, any_hit): (t, prim, u, v)} as numpy."""
    _, jb, _ = bvhs
    o, d, tmax = (jnp.asarray(x) for x in _rays())
    out = {}
    for any_hit in (False, True):
        out["jnp", any_hit] = jax_bvh_intersect(jb, o, d, tmax, any_hit=any_hit)
        out["pallas", any_hit] = pallas_bvh_intersect(
            jb, o, d, tmax, any_hit=any_hit, interpret=True)
    return {k: tuple(np.asarray(x) for x in v) for k, v in out.items()}


def _twin(bvh, any_hit, counts=None):
    o, d, tmax = (torch.from_numpy(x) for x in _rays())
    return tuple(x.numpy() for x in bvh_intersect_ref(
        bvh, o, d, tmax, any_hit=any_hit, counts=counts))


def test_build_and_convert_bit_equal(bvhs):
    tris, jb, b = bvhs
    assert (b.depth, b.leaf_size) == (jb.depth, jb.leaf_size) == (9, 4)
    for key in _KEYS:
        assert getattr(b, key).dtype == (torch.int32 if key == "prim_id"
                                         else torch.float32)
        np.testing.assert_array_equal(getattr(b, key).numpy(),
                                      np.asarray(getattr(jb, key)), key)
    js, _ = small_killeroo_class_scene("pbrt_tpu", (8, 8))
    js = js.replace(clusters=None, bvh=jb)
    conv = scene_from_arrays(*flatten_jax(js))
    assert conv.clusters is None and conv.bvh.depth == jb.depth
    for key in _KEYS:
        assert torch.equal(getattr(conv.bvh, key), getattr(b, key)), key


@pytest.mark.parametrize("any_hit", [False, True])
def test_twin_matches_jnp_traversal(bvhs, reference, any_hit):
    _, _, b = bvhs
    jt, jp, ju, jv = reference["jnp", any_hit]
    tmax = _rays()[2]
    t, prim, u, v = _twin(b, any_hit)
    hits = jp >= 0
    assert 0.1 < hits.mean() < 0.9  # hits and misses both exercised
    assert not np.any(hits[::9])  # dead lanes never hit
    # The same walk in both modes: the same prim on every ray.
    np.testing.assert_array_equal(prim, jp)
    assert prim.dtype == np.int32
    np.testing.assert_array_equal(t[~hits], tmax[~hits])  # tmax on a miss
    assert not np.any(u[~hits]) and not np.any(v[~hits])
    np.testing.assert_allclose(t[hits], jt[hits], rtol=2e-6)
    for got, want in ((u, ju), (v, jv)):
        np.testing.assert_allclose(got[hits], want[hits], rtol=1e-5, atol=3e-5)


@pytest.mark.parametrize("any_hit", [False, True])
def test_twin_matches_pallas_interpret(bvhs, reference, any_hit):
    _, _, b = bvhs
    jt, jp, _, _ = reference["pallas", any_hit]
    t, prim, _, _ = _twin(b, any_hit)
    if any_hit:
        # Only occlusion is a result: the Pallas tile keeps shrinking t
        # after a lane's first hit, the walk stops there.
        np.testing.assert_array_equal(prim >= 0, jp >= 0)
        return
    np.testing.assert_array_equal(prim, jp)
    hits = jp >= 0
    np.testing.assert_allclose(t[hits], jt[hits], rtol=2e-6)


def test_padding_subtree_is_skipped(bvhs):
    """The reference's padding boxes (+inf lo, -inf hi) pass its slab test
    for every ray (each axis spans (-inf, inf)); the twin's empty-box rule
    fails them, so rays that miss the mesh's box test the root alone."""
    _, jb, b = bvhs
    r = np.random.default_rng(3)
    n = 256
    lo = np.asarray(jb.node_lo[0])
    hi = np.asarray(jb.node_hi[0])
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = ((lo + hi) / 2 + 10.0 * d).astype(np.float32)  # away from the mesh
    inv_d = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
    tmax = np.full(n, np.inf, np.float32)
    pad = jax_aabb_hit(jnp.full((n, 3), jnp.inf), jnp.full((n, 3), -jnp.inf),
                       jnp.asarray(o), jnp.asarray(inv_d), jnp.asarray(tmax))
    assert np.all(np.asarray(pad))
    counts = {}
    t, prim, _, _ = bvh_intersect_ref(b, torch.from_numpy(o), torch.from_numpy(d),
                                      torch.from_numpy(tmax), counts=counts)
    assert not torch.any(prim >= 0)
    assert counts == {"nodes": n, "entries": 0, "tris": 0}
    # The reference walks the whole padding subtree (192 leaves, 768
    # triangle slots) for every ray; the twin's rays test far fewer.
    counts = {}
    _twin(b, False, counts)
    live = int(np.sum(_rays()[2] > 0))
    assert 0 < counts["tris"] < 64 * live


def test_cpu_tensors_take_the_twin_and_count_no_launch(bvhs):
    _, _, b = bvhs
    o, d, tmax = (torch.from_numpy(x) for x in _rays())
    traverse.STATS.reset()
    for any_hit in (False, True):
        got = traverse.bvh_intersect(b, o, d, tmax, any_hit=any_hit)
        want = bvh_intersect_ref(b, o, d, tmax, any_hit=any_hit)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert traverse.STATS.launches == 0
    out = traverse.bvh_intersect(b, o.clone().requires_grad_(), d, tmax)
    assert not any(x.requires_grad for x in out)


def test_closest_and_any_hit_through_the_bvh(bvhs):
    """The BVH branches of accel.api: t = inf and the attributes of a miss
    as the reference's closest gives them, the unit winding normal, and
    the material and light of the hit triangle."""
    tris, _, b = bvhs
    mat = np.arange(len(tris), dtype=np.int32) % 2
    scene = Scene(geom=GeometryBuffers.build(tri_verts=tris, tri_mat=mat),
                  materials=MaterialBuffers.build([{"kind": 0}, {"kind": 0}]),
                  lights=LightBuffers.build(), bvh=b)
    o, d, tmax = (torch.from_numpy(x) for x in _rays())
    t, prim, u, v = bvh_intersect_ref(b, o, d, tmax)
    isect = api.closest(scene, o, d, tmax)
    assert torch.equal(isect.prim, prim) and torch.equal(isect.valid, prim >= 0)
    assert torch.equal(isect.t, torch.where(prim >= 0, t, float("inf")))
    assert torch.equal(isect.uv, torch.stack([u, v], dim=-1))
    hit = prim >= 0
    tv = torch.from_numpy(tris)[prim[hit].long()]
    ng = torch.linalg.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    torch.testing.assert_close(isect.n[hit], ng / ng.norm(dim=-1, keepdim=True),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(isect.mat[hit], torch.from_numpy(mat)[prim[hit].long()])
    assert torch.equal(isect.light, torch.full_like(prim, -1))
    occ = api.any_hit(scene, o, d, tmax)
    assert torch.equal(occ, bvh_intersect_ref(b, o, d, tmax, any_hit=True)[1] >= 0)
