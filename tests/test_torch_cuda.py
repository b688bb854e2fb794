"""K1 on the card: the CUDA kernel against its plain twin, and a render on
the card against the same render on the CPU.

These tests need a CUDA device and skip without one. They import neither
jax nor pbrt_tpu, so they run on a machine that has only the port's
dependencies. From the repository root on such a machine (the root
conftest.py imports jax, hence --noconftest):

    python3 -m pytest -o addopts="" --noconftest -p no:cacheprovider -q \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.ops.smallscene import (
    STATS,
    build_smallscene,
    smallscene_intersect,
    smallscene_intersect_ref,
)
from pbrt_tpu_torch.render import camera_rays_full, render
from pbrt_tpu_torch.scenes.cornell import cornell_box

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel runs only on the card")
    return torch.device("cuda", 0)


def _box_rays(n, seed, dev):
    """n rays from points inside the unit box: random directions, every
    seventh lane dead (tmax = 0), every eleventh axis-parallel, every
    thirteenth a finite segment."""
    r = np.random.default_rng(seed)
    o = r.uniform(0.02, 0.98, (n, 3))
    d = r.normal(size=(n, 3))
    d[::11] = np.eye(3)[r.integers(0, 3, len(d[::11]))] * r.choice(
        [-1.0, 1.0], (len(d[::11]), 1))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n, np.inf)
    tmax[::13] = r.uniform(0.0, 1.0, len(tmax[::13]))
    tmax[::7] = 0.0
    return tuple(torch.tensor(a, dtype=torch.float32, device=dev)
                 for a in (o, d, tmax))


def _assert_kernel_equals_twin(accel, o, d, tmax):
    for any_hit in (False, True):
        STATS.reset()
        got = smallscene_intersect(accel, o, d, tmax, any_hit=any_hit)
        torch.cuda.synchronize()
        assert STATS.launches == 1
        want = smallscene_intersect_ref(accel, o, d, tmax, any_hit=any_hit)
        assert set(got) == set(want)
        assert 0 < int((want["prim"] >= 0).sum()) < o.shape[0]
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), (any_hit, k)


def test_kernel_matches_twin_on_cornell(card):
    scene, camera = cornell_box(resolution=(64, 64))
    accel = scene.with_accel().small.to(card)
    o_box, d_box, t_box = _box_rays(1 << 20, 5, card)
    pixel = torch.arange(64 * 64, device=card)
    o_cam, d_cam, _, _ = camera_rays_full(camera.to(card), pixel, 0, 0)
    t_cam = torch.full((pixel.shape[0],), float("inf"), device=card)
    _assert_kernel_equals_twin(
        accel, torch.cat([o_box, o_cam]), torch.cat([d_box, d_cam]),
        torch.cat([t_box, t_cam]),
    )


def test_kernel_matches_twin_on_a_full_table(card):
    """1024 triangles fill the tier: a 64 KB table, above the 48 KB of
    static shared memory, so the launch opts in to more."""
    r = np.random.default_rng(7)
    centers = r.uniform(0.1, 0.9, (1024, 1, 3))
    verts = centers + r.normal(scale=0.05, size=(1024, 3, 3))
    accel = build_smallscene(
        verts, r.integers(0, 5, 1024), np.where(r.random(1024) < 0.1, 3, -1),
    ).to(card)
    assert accel.n_tris == 1024
    _assert_kernel_equals_twin(accel, *_box_rays(1 << 16, 9, card))


def test_kernel_checks_its_inputs(card):
    scene, _ = cornell_box(resolution=(8, 8))
    accel = scene.with_accel().small.to(card)
    o, d, tmax = _box_rays(64, 1, card)
    with pytest.raises(ValueError, match="float32"):
        smallscene_intersect(accel, o.double(), d, tmax)
    with pytest.raises(ValueError, match="contiguous"):
        smallscene_intersect(accel, o, d.t().contiguous().t(), tmax)
    with pytest.raises(ValueError, match="on cuda"):
        smallscene_intersect(accel, o, d, tmax.cpu())
    STATS.reset()
    empty = smallscene_intersect(accel, o[:0], d[:0], tmax[:0])
    assert empty["t"].shape == (0,) and empty["n"].shape == (0, 3)
    assert STATS.launches == 0


def test_render_on_card_matches_cpu(card):
    scene, camera = cornell_box(resolution=(16, 16))
    scene = scene.with_accel()
    kw = dict(spp=4, seed=1, samples_per_pass=2, n_spectrum=8)
    STATS.reset()
    got = render(scene, camera, PathIntegrator(max_depth=5), device=card, **kw)
    torch.cuda.synchronize()
    assert STATS.launches == 11 * 2
    want = render(scene, camera, PathIntegrator(max_depth=5), device="cpu",
                  **kw)
    got = got.cpu().numpy()
    want = want.numpy()
    assert np.all(np.isfinite(got))
    ok = np.abs(got - want) <= 1e-5 + 1e-3 * np.abs(want)
    assert np.mean(ok) >= 0.99, int(np.sum(~ok))
