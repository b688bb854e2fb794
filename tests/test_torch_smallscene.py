"""K1's plain twin against the Pallas kernel (interpret mode on the CPU), and
the wrapper's dispatch by device. The kernel itself is held against the
twin on a card by tests/test_torch_cuda.py.

The Pallas kernel's answers in interpret mode are committed
(tests/data/torch_port/reference_answers.npz, made from this file's inputs by
scripts/make_torch_port_golden_answers.py): a digest of the rays and of
the reference's triangle table, both built live here, must equal the one
stored beside them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.render import camera_rays_full as jax_camera_rays
from pbrt_tpu.scenes.cornell import cornell_box as jax_cornell_box
from pbrt_tpu_torch.ops.smallscene import (
    STATS,
    SmallTriAccel,
    smallscene_intersect,
    smallscene_intersect_ref,
)

from .torch_port_helpers import inputs_digest, reference_answers

torch.set_num_threads(2)


def _rays(jcam, n_each=128):
    """512 rays: inside the box, camera, dead (tmax = 0), axis-parallel."""
    r = np.random.default_rng(3)
    o_in = r.uniform(0.02, 0.98, (n_each, 3))
    d_in = r.normal(size=(n_each, 3))
    pixel = jnp.asarray(r.integers(0, 16 * 16, n_each), jnp.int32)
    o_cam, d_cam, _, _ = jax_camera_rays(jcam, pixel, jnp.int32(0), 0)
    o_dead = r.uniform(0.02, 0.98, (n_each, 3))
    d_dead = r.normal(size=(n_each, 3))
    o_ax = r.uniform(0.02, 0.98, (n_each, 3))
    d_ax = np.eye(3)[r.integers(0, 3, n_each)] * r.choice([-1.0, 1.0], (n_each, 1))
    o = np.concatenate([o_in, np.asarray(o_cam), o_dead, o_ax]).astype(np.float32)
    d = np.concatenate([d_in, np.asarray(d_cam), d_dead, d_ax]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(4 * n_each, np.inf, np.float32)
    tmax[2 * n_each:3 * n_each] = 0.0
    tmax[:n_each:4] = 0.5  # some finite segments too
    return o, d, tmax


def build_case():
    scene, cam = jax_cornell_box(resolution=(16, 16))
    table = np.array(scene.with_accel().small.table)
    accel = SmallTriAccel(table=torch.from_numpy(table), n_tris=table.shape[0])
    o, d, tmax = _rays(cam)
    jaccel = scene.with_accel().small
    return accel, jaccel, o, d, tmax


@pytest.fixture(scope="module")
def case():
    return build_case()


def pallas_inputs_digest(jaccel, o, d, tmax):
    """The digest of the reference's triangle table and the rays that the
    committed Pallas answers were computed from."""
    return inputs_digest(dict(table=np.asarray(jaccel.table)),
                         dict(o=o, d=d, tmax=tmax))


@pytest.mark.parametrize("any_hit", [False, True])
def test_twin_matches_pallas_interpret(case, any_hit):
    accel, jaccel, o, d, tmax = case
    mode = "any_hit" if any_hit else "closest"
    want = reference_answers(f"k1/{mode}",
                             pallas_inputs_digest(jaccel, o, d, tmax))
    got = smallscene_intersect_ref(
        accel, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax),
        any_hit=any_hit,
    )
    assert set(got) == set(want)
    hits = np.asarray(want["prim"]) >= 0
    assert 0 < hits.sum() < len(hits)  # both hits and misses exercised
    assert not np.any(hits[256:384])  # dead lanes never hit
    for k in ("prim", "mat", "light"):
        if k in want:
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # u, v in [0, 1] come from cancelling sums of O(1) products: their
    # error is absolute (XLA's CPU backend may fuse multiply-adds where the
    # twin rounds every op), hence the atol.
    for k in ("t", "u", "v", "n"):
        if k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)


def test_cpu_tensors_take_the_twin_and_count_no_launch(case):
    accel, _, o, d, tmax = case
    STATS.reset()
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax))
    got = smallscene_intersect(accel, *args)
    want = smallscene_intersect_ref(accel, *args)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert STATS.launches == 0


def test_query_is_detached(case):
    accel, _, o, d, tmax = case
    o_t = torch.from_numpy(o).requires_grad_()
    out = smallscene_intersect(accel, o_t, torch.from_numpy(d), torch.from_numpy(tmax))
    assert not any(v.requires_grad for v in out.values())

