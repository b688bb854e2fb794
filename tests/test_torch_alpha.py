"""Shape alpha in the port (pbrt_tpu_torch/accel/api.py) against the JAX
reference on the CPU: the stochastic test's hash, the alpha of a hit
(constant times texture) and the restart loop of the closest and any-hit
queries, on the exact ray bits. The shapes box
(tests/data/torch_port/shapes.pbrt: a checkerboard-alpha screen and a
constant alpha 0.5 panel) on the dense tester in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.accel import api as japi
from pbrt_tpu.io.parser import load_pbrt as jax_load_pbrt
from pbrt_tpu_torch.accel import api
from pbrt_tpu_torch.io.parser import load_pbrt

from .torch_port_shapes import SHAPES_PBRT

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def box():
    """Both packages' shapes box without a tier, and 2,048 rays: half from
    the camera toward the two alpha quads, half from inside the room."""
    js, _, _ = jax_load_pbrt(SHAPES_PBRT)
    ps, _, _ = load_pbrt(SHAPES_PBRT, device="cpu")
    js, ps = js.replace(small=None), ps.replace(small=None)
    rng = np.random.default_rng(3)
    n = 1024
    tgt = np.concatenate([
        rng.uniform([-0.9, 0.2, -0.55], [-0.2, 1.6, -0.55], (n // 2, 3)),
        rng.uniform([0.25, 0.9, 0.3], [0.85, 1.5, 0.3], (n // 2, 3))])
    o = np.concatenate([np.tile([[0.0, 1.0, 3.2]], (n, 1)),
                        rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n, 3))])
    tgt = np.concatenate([tgt, tgt[rng.permutation(n)]])
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.uniform(size=2 * n) < 0.1, 1.5, np.inf)
    rays = [x.astype(np.float32) for x in (o, d, tmax)]
    return js, ps, rays


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def test_alpha_hash_bit_equal(box):
    _, _, (o, d, _) = box
    for k in range(3):
        np.testing.assert_array_equal(
            api._alpha_rand(*_t(o, d), k).numpy(),
            np.asarray(japi._alpha_rand(*_j(o, d), k)))


def test_alpha_of_hits_bit_equal(box):
    """The alpha of each first hit (constant x checkerboard texture), so
    the cut mask, on the same hits."""
    js, ps, (o, d, tmax) = box
    t, prim, u, v = [x for x in api._tri_closest_once(ps, *_t(o, d, tmax))[:4]]
    a = api._alpha_at(ps, *_t(o, d), t, prim, u, v)
    res = {"t": jnp.asarray(t.numpy()), "prim": jnp.asarray(prim.numpy()),
           "u": jnp.asarray(u.numpy()), "v": jnp.asarray(v.numpy())}
    want = np.asarray(japi._alpha_at(js, *_j(o, d), res))
    np.testing.assert_array_equal(a.numpy(), want)
    # Both kinds of alpha and both checker values are hit.
    assert {0.0, 0.5, 1.0} <= set(np.unique(a.numpy()).tolist())


def test_restart_loop_matches_jax(box):
    """The closest-hit restart loop and the any-hit queries (which run
    it): the same prims and occlusion as the reference's jitted loop, t
    within rtol 1e-6 (the shifted origins o + s d are fused multiply-adds
    in the reference's CPU build)."""
    js, ps, (o, d, tmax) = box
    want = jax.jit(lambda o, d, t: japi._tri_closest(js, o, d, t))(
        *_j(o, d, tmax))
    got = api._tri_closest(ps, *_t(o, d, tmax))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want["prim"]))
    hit = np.asarray(want["prim"]) >= 0
    np.testing.assert_allclose(got[0].numpy()[hit], np.asarray(want["t"])[hit],
                               rtol=1e-6)
    # Restarts happened: some hits lie behind a cut surface.
    first = api._tri_closest_once(ps, *_t(o, d, tmax))[1].numpy()
    assert np.sum(first != got[1].numpy()) > 100
    occ = jax.jit(lambda o, d, t: japi.any_hit(js, o, d, t))(*_j(o, d, tmax))
    np.testing.assert_array_equal(api.any_hit(ps, *_t(o, d, tmax)).numpy(),
                                  np.asarray(occ))


def test_opaque_scene_makes_one_query(box, monkeypatch):
    """Without alpha the loop is skipped: one triangle query."""
    _, ps, (o, d, tmax) = box
    geom = ps.geom.replace(has_alpha=False)
    calls = []
    once = api._tri_closest_once
    monkeypatch.setattr(api, "_tri_closest_once",
                        lambda *a: calls.append(1) or once(*a))
    api._tri_closest(ps.replace(geom=geom), *_t(o, d, tmax))
    assert len(calls) == 1
    api._tri_closest(ps, *_t(o, d, tmax))
    assert len(calls) == 1 + api._ALPHA_ROUNDS
