"""K1, K2 and K3 on the card: each CUDA kernel against its plain twin, and
renders on the card against the same renders on the CPU.

These tests need a CUDA device and skip without one. They import neither
jax nor pbrt_tpu, so they run on a machine that has only the port's
dependencies. From the repository root on such a machine (the root
conftest.py imports jax, hence --noconftest):

    python3 -m pytest -o addopts="" --noconftest -p no:cacheprovider -q \
        tests/test_torch_cuda.py
"""

import tempfile

import numpy as np
import pytest
import torch

from pbrt_tpu_torch.accel.api import ray_sort_perm
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.io.parser import load_pbrt_string
from pbrt_tpu_torch.ops import cluster, sweep
from pbrt_tpu_torch.ops.smallscene import (
    STATS,
    build_smallscene,
    smallscene_intersect,
    smallscene_intersect_ref,
)
from pbrt_tpu_torch.render import camera_rays_full, render
from pbrt_tpu_torch.scenes.cornell import cornell_box
from pbrt_tpu_torch.scenes.meshes import killeroo_class_scene

from .torch_port_instanced import FULL, SMALL, field_text, write_field_meshes
from .torch_port_killeroo import small_killeroo_class_scene

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1, K2 and K3 kernels run "
                    "only on the card")
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


def test_k2_matches_twin_on_killeroo(card):
    """All three modes on the full killeroo-class scene, on rays from the
    scene's box (random, axis-parallel, dead, finite segments) and its
    camera, sorted as the path sorts them."""
    scene, camera = killeroo_class_scene(resolution=(128, 128))
    acc = scene.clusters.to(card)
    lo = scene.geom.tri_verts.reshape(-1, 3).amin(0).to(card)
    hi = scene.geom.tri_verts.reshape(-1, 3).amax(0).to(card)
    o_box, d_box, t_box = _box_rays(1 << 16, 3, card)
    pixel = torch.arange(128 * 128, device=card)
    o_cam, d_cam, _, _ = camera_rays_full(camera.to(card), pixel, 0, 0)
    o = torch.cat([lo + (hi - lo) * o_box, o_cam])
    d = torch.cat([d_box, d_cam])
    tmax = torch.cat([t_box * 3.0, torch.full((pixel.shape[0],), float("inf"),
                                              device=card)])
    perm, _ = ray_sort_perm(o, d, tmax)
    o, d, tmax = o[perm], d[perm], tmax[perm]
    for kw in ({}, {"any_hit": True}, {"defer_attrs": False}):
        cluster.STATS.reset()
        got = cluster.cluster_intersect(acc, o, d, tmax, **kw)
        torch.cuda.synchronize()
        assert cluster.STATS.launches == 1
        want = cluster.cluster_intersect_ref(acc, o, d, tmax, **kw)
        assert set(got) == set(want)
        assert 0 < int((want["prim"] >= 0).sum()) < o.shape[0]
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), (kw, k)


def test_k2_checks_its_inputs(card):
    scene, _ = small_killeroo_class_scene("pbrt_tpu_torch", (8, 8))
    acc = scene.clusters.to(card)
    o, d, tmax = _box_rays(64, 1, card)
    with pytest.raises(ValueError, match="float32"):
        cluster.cluster_intersect(acc, o.double(), d, tmax)
    with pytest.raises(ValueError, match="contiguous"):
        cluster.cluster_intersect(acc, o, d.t().contiguous().t(), tmax)
    with pytest.raises(ValueError, match="on cuda"):
        cluster.cluster_intersect(acc, o, d, tmax.cpu())
    with pytest.raises(ValueError, match="v0x"):
        cluster.cluster_intersect(scene.clusters, o, d, tmax)  # tables on the CPU
    cluster.STATS.reset()
    empty = cluster.cluster_intersect(acc, o[:0], d[:0], tmax[:0],
                                      defer_attrs=False)
    assert empty["t"].shape == (0,) and empty["n"].shape == (0, 3)
    assert cluster.STATS.launches == 0


def test_killeroo_render_on_card_matches_cpu(card):
    scene, camera = small_killeroo_class_scene("pbrt_tpu_torch", (16, 16))
    kw = dict(spp=4, seed=1, samples_per_pass=2, n_spectrum=8)
    STATS.reset()
    cluster.STATS.reset()
    got = render(scene, camera, PathIntegrator(max_depth=5), device=card, **kw)
    torch.cuda.synchronize()
    assert cluster.STATS.launches == 11 * 2 and STATS.launches == 0
    want = render(scene, camera, PathIntegrator(max_depth=5), device="cpu",
                  **kw)
    got = got.cpu().numpy()
    want = want.numpy()
    assert np.all(np.isfinite(got))
    ok = np.abs(got - want) <= 1e-5 + 1e-3 * np.abs(want)
    assert np.mean(ok) >= 0.99, int(np.sum(~ok))


def _field(size, dev, resolution):
    with tempfile.TemporaryDirectory() as tmp:
        write_field_meshes("pbrt_tpu_torch", tmp, size)
        scene, camera, settings = load_pbrt_string(field_text(), tmp,
                                                   device=dev)
    return scene, camera.replace(resolution=resolution), settings


def _assert_k3_equals_twin(acc, scene, camera, dev):
    """Both modes on rays from the scene's box (random, axis-parallel,
    dead, finite segments) and the camera's, sorted as the path sorts."""
    lo = scene.geom.tri_verts.reshape(-1, 3).amin(0)
    hi = scene.geom.tri_verts.reshape(-1, 3).amax(0)
    if acc.instanced:
        lo, hi = acc.ibox[:, :3].amin(0), acc.ibox[:, 3:6].amax(0)
    o_box, d_box, t_box = _box_rays(1 << 16, 3, dev)
    nx, ny = camera.resolution
    pixel = torch.arange(nx * ny, device=dev)
    o_cam, d_cam, _, _ = camera_rays_full(camera, pixel, 0, 0)
    o = torch.cat([lo + (hi - lo) * o_box, o_cam])
    d = torch.cat([d_box, d_cam])
    tmax = torch.cat([t_box * 3.0, torch.full((pixel.shape[0],), float("inf"),
                                              device=dev)])
    perm, _ = ray_sort_perm(o, d, tmax)
    o, d, tmax = o[perm], d[perm], tmax[perm]
    for any_hit in (False, True):
        sweep.STATS.reset()
        got = sweep.sweep_intersect(acc, o, d, tmax, any_hit=any_hit)
        torch.cuda.synchronize()
        assert sweep.STATS.launches == 1
        want = sweep.sweep_intersect_ref(acc, o, d, tmax, any_hit=any_hit)
        assert set(got) == set(want) == {"t", "prim", "inst"}
        assert 0 < int((want["prim"] >= 0).sum()) < o.shape[0]
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), (any_hit, k)


def test_k3_matches_twin_on_instanced_field(card):
    """The full-size instanced field: 37 instances, 17,191 entries."""
    scene, camera, _ = _field(FULL, card, (128, 128))
    assert scene.sweep.instanced and scene.sweep.n_entries == 17_191
    _assert_k3_equals_twin(scene.sweep, scene, camera, card)


def test_k3_matches_twin_without_instances(card):
    """with_accel(kind="sweep") on the killeroo-class scene: one identity
    instance, the world rays used as they are."""
    scene, camera = killeroo_class_scene(resolution=(128, 128))
    scene = scene.with_accel(kind="sweep").to(card)
    assert not scene.sweep.instanced and scene.clusters is None
    _assert_k3_equals_twin(scene.sweep, scene, camera.to(card), card)


def test_k3_checks_its_inputs(card):
    scene, _, _ = _field(SMALL, "cpu", (8, 8))
    acc = scene.sweep.to(card)
    o, d, tmax = _box_rays(64, 1, card)
    with pytest.raises(ValueError, match="float32"):
        sweep.sweep_intersect(acc, o.double(), d, tmax)
    with pytest.raises(ValueError, match="contiguous"):
        sweep.sweep_intersect(acc, o, d.t().contiguous().t(), tmax)
    with pytest.raises(ValueError, match="on cuda"):
        sweep.sweep_intersect(acc, o, d, tmax.cpu())
    with pytest.raises(ValueError, match="v0x"):
        sweep.sweep_intersect(scene.sweep, o, d, tmax)  # tables on the CPU
    sweep.STATS.reset()
    empty = sweep.sweep_intersect(acc, o[:0], d[:0], tmax[:0])
    assert empty["inst"].shape == (0,)
    assert sweep.STATS.launches == 0


def test_instanced_render_on_card_matches_cpu(card):
    scene, camera, settings = _field(SMALL, "cpu", (16, 16))
    kw = dict(spp=4, seed=1, samples_per_pass=2, n_spectrum=8)
    sweep.STATS.reset()
    cluster.STATS.reset()
    got = render(scene, camera, settings["integrator"], device=card, **kw)
    torch.cuda.synchronize()
    assert sweep.STATS.launches == 11 * 2 and cluster.STATS.launches == 0
    want = render(scene, camera, settings["integrator"], device="cpu", **kw)
    got = got.cpu().numpy()
    want = want.numpy()
    assert np.all(np.isfinite(got))
    ok = np.abs(got - want) <= 1e-5 + 1e-3 * np.abs(want)
    assert np.mean(ok) >= 0.99, int(np.sum(~ok))
