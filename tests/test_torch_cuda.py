"""K1, K2, K3 and K4 on the card: each CUDA kernel against its plain twin
(the subsurface probe's query among K1's), and renders on the card (the
lights, the dielectric BxDFs, the textures, the coated materials, the
many-light hall, the families box and the light tracers (BDPT, the
light path, SPPM, MLT's first steps) among them) against the same
renders on the CPU, the sorted shading dispatch against the lockstep
chain on the card, each gradient estimator's gradients against the
CPU's, and the texel gathers' take against plain indexing.

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

from pbrt_tpu_torch.accel import api
from pbrt_tpu_torch.accel.api import ray_sort_perm
from pbrt_tpu_torch.accel.bvh import build_bvh
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.io.parser import load_pbrt, load_pbrt_string
from pbrt_tpu_torch.ops import cluster, nvcc_build, sweep, traverse
from pbrt_tpu_torch.ops.cluster import build_clusters
from pbrt_tpu_torch.ops.sweep import build_sweep
from pbrt_tpu_torch.ops.smallscene import (
    STATS,
    build_smallscene,
    smallscene_intersect,
    smallscene_intersect_ref,
)
from pbrt_tpu_torch.render import camera_rays_full, render
from pbrt_tpu_torch.scenes.cornell import cornell_box
from pbrt_tpu_torch.scenes.meshes import killeroo_class_scene

from .torch_port_bvh_walk import CASES, stack_entries, walk_case
from .torch_port_coated import coarse_walk_keys, coated_cornell
from .torch_port_instanced import FULL, SMALL, field_text, write_field_meshes
from .torch_port_killeroo import small_killeroo_class_scene

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1, K2, K3 and K4 kernels run "
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


def _scene_rays(scene, camera, dev, sweep_acc=None):
    """Rays from the scene's box (random, axis-parallel, dead, finite
    segments) and the camera's; the box of an instanced sweep is that of
    its instances."""
    lo = scene.geom.tri_verts.reshape(-1, 3).amin(0).to(dev)
    hi = scene.geom.tri_verts.reshape(-1, 3).amax(0).to(dev)
    if sweep_acc is not None and sweep_acc.instanced:
        lo, hi = sweep_acc.ibox[:, :3].amin(0), sweep_acc.ibox[:, 3:6].amax(0)
    o_box, d_box, t_box = _box_rays(1 << 16, 3, dev)
    nx, ny = camera.resolution
    pixel = torch.arange(nx * ny, device=dev)
    o_cam, d_cam, _, _ = camera_rays_full(camera, pixel, 0, 0)
    o = torch.cat([lo + (hi - lo) * o_box, o_cam])
    d = torch.cat([d_box, d_cam])
    tmax = torch.cat([t_box * 3.0, torch.full((pixel.shape[0],), float("inf"),
                                              device=dev)])
    return o, d, tmax


def _assert_k3_equals_twin(acc, scene, camera, dev):
    """Both modes on _scene_rays, sorted as the path sorts."""
    o, d, tmax = _scene_rays(scene, camera, dev, acc)
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


def _one_live_lane_per_warp(o, d, tmax):
    """The same rays with every lane but one of each 32-ray warp dead
    (tmax = 0, origin 1e8, as the path masks shadow rays): the lane
    w % 32 of warp w stays."""
    n = o.shape[0]
    keep = torch.arange(n, device=o.device)
    keep = (keep % 32) == (keep // 32) % 32
    return (torch.where(keep[:, None], o, 1e8).contiguous(), d,
            torch.where(keep, tmax, 0.0).contiguous())


def _assert_equal(got, want, label):
    assert set(got) == set(want), label
    for k in want:
        assert got[k].dtype == want[k].dtype, (label, k)
        assert torch.equal(got[k], want[k]), (label, k)


def _walk_batches(o, d, tmax):
    """A sorted batch and its one-live-lane-per-warp form, whose every
    (warp, cluster) visit the kernels test triangle-parallel."""
    perm, _ = ray_sort_perm(o, d, tmax)
    o, d, tmax = o[perm].contiguous(), d[perm].contiguous(), tmax[perm]
    return {"sorted": (o, d, tmax.contiguous()),
            "one_lane": _one_live_lane_per_warp(o, d, tmax)}


def _check_k2(acc, batches):
    for label, (o, d, tmax) in batches.items():
        for kw in ({}, {"any_hit": True}, {"defer_attrs": False}):
            counts = {}
            got = cluster.cluster_intersect(acc, o, d, tmax, **kw)
            want = cluster.cluster_intersect_ref(acc, o, d, tmax,
                                                 counts=counts, **kw)
            _assert_equal(got, want, ("K2", label, kw))
            assert counts["pairs"] > 0, (label, kw)
            if label == "one_lane":
                assert counts["lone_visits"] == counts["warp_visits"]


def _check_k3(acc, batches):
    for label, (o, d, tmax) in batches.items():
        for any_hit in (False, True):
            counts = {}
            got = sweep.sweep_intersect(acc, o, d, tmax, any_hit=any_hit)
            want = sweep.sweep_intersect_ref(acc, o, d, tmax, any_hit=any_hit,
                                             counts=counts)
            _assert_equal(got, want, ("K3", label, any_hit))
            assert counts["pairs"] > 0, (label, any_hit)
            if label == "one_lane":
                assert counts["lone_visits"] == counts["warp_visits"]


def test_k2_k3_one_live_lane_per_warp(card):
    """K2 on the killeroo-class scene and K3 on the small instanced field,
    both modes (and K2's attributes), on camera and box rays with one live
    lane per warp: the triangle-parallel mapping alone."""
    scene, camera = killeroo_class_scene(resolution=(128, 128))
    o, d, tmax = _scene_rays(scene, camera.to(card), card)
    _check_k2(scene.clusters.to(card), _walk_batches(o, d, tmax))
    scene, camera, _ = _field(SMALL, card, (128, 128))
    o, d, tmax = _scene_rays(scene, camera, card, scene.sweep)
    _check_k3(scene.sweep, _walk_batches(o, d, tmax))


def test_k2_k3_exact_ties_in_both_mappings(card):
    """Two coplanar copies of every triangle (pids 2i and 2i + 1, other
    materials), hit at bit-equal t: the larger pid wins in both mappings
    (sorted coherent rays: mostly ray-parallel; one live lane per warp:
    triangle-parallel), for K2 with its attributes and for K3."""
    r = np.random.default_rng(12)
    g = np.linspace(-1.0, 1.0, 17, dtype=np.float32)
    x0, y0 = np.meshgrid(g[:-1], g[:-1])
    x0, y0 = x0.ravel(), y0.ravel()
    h = g[1] - g[0]
    z = r.uniform(-0.05, 0.05, x0.shape)
    quad = [np.stack([x0, y0, z], 1), np.stack([x0 + h, y0, z], 1),
            np.stack([x0 + h, y0 + h, z], 1), np.stack([x0, y0 + h, z], 1)]
    tris = np.concatenate([np.stack([quad[0], quad[1], quad[2]], 1),
                           np.stack([quad[0], quad[2], quad[3]], 1)])
    tris = np.repeat(tris, 2, axis=0).astype(np.float32)  # pairs 2i, 2i + 1
    mat = np.tile([1, 2], len(tris) // 2).astype(np.int32)
    n = 1 << 15
    o = np.concatenate([r.uniform(-0.95, 0.95, (n, 2)), np.full((n, 1), -2.0)], 1)
    d = np.concatenate([r.normal(scale=0.05, size=(n, 2)), np.ones((n, 1))], 1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = [torch.tensor(a, dtype=torch.float32, device=card) for a in (o, d)]
    tmax = torch.full((n,), float("inf"), device=card)
    batches = _walk_batches(*rays, tmax)
    acc2 = build_clusters(tris, mat).to(card)
    acc3 = build_sweep(tris).to(card)
    _check_k2(acc2, batches)
    _check_k3(acc3, batches)
    counts = {}
    cluster.cluster_intersect_ref(acc2, *batches["sorted"], counts=counts)
    assert counts["lone_visits"] < counts["warp_visits"] // 2  # ray-parallel
    for label, (o, d, tmax) in batches.items():
        hit = cluster.cluster_intersect(acc2, o, d, tmax, defer_attrs=False)
        found = hit["prim"] >= 0
        assert int(found.sum()) > 0.5 * int((tmax > 0).sum()), label
        assert bool((hit["prim"][found] % 2 == 1).all()), label
        assert bool((hit["mat"][found] == 2).all()), label
        prim3 = sweep.sweep_intersect(acc3, o, d, tmax)["prim"]
        assert torch.equal(prim3, hit["prim"]), label


def _killeroo_bvh(card):
    scene, camera = killeroo_class_scene(resolution=(128, 128))
    bvh = build_bvh(scene.geom.tri_verts.numpy())
    return scene.replace(clusters=None, bvh=bvh).to(card), camera.to(card)


def test_k4_matches_twin_on_killeroo(card):
    """Both modes on the full killeroo-class BVH (depth 15), on rays from
    the scene's box (random, axis-parallel, dead, finite segments) and the
    camera's, in their own order (the BVH tier sorts no rays)."""
    scene, camera = _killeroo_bvh(card)
    assert scene.bvh.depth == 15
    lo = scene.geom.tri_verts.reshape(-1, 3).amin(0)
    hi = scene.geom.tri_verts.reshape(-1, 3).amax(0)
    o_box, d_box, t_box = _box_rays(1 << 16, 3, card)
    pixel = torch.arange(128 * 128, device=card)
    o_cam, d_cam, _, _ = camera_rays_full(camera, pixel, 0, 0)
    o = torch.cat([lo + (hi - lo) * o_box, o_cam])
    d = torch.cat([d_box, d_cam])
    tmax = torch.cat([t_box * 3.0, torch.full((pixel.shape[0],), float("inf"),
                                              device=card)])
    for any_hit in (False, True):
        traverse.STATS.reset()
        got = traverse.bvh_intersect(scene.bvh, o, d, tmax, any_hit=any_hit)
        torch.cuda.synchronize()
        assert traverse.STATS.launches == 1
        want = traverse.bvh_intersect_ref(scene.bvh, o, d, tmax,
                                          any_hit=any_hit)
        assert 0 < int((want[1] >= 0).sum()) < o.shape[0]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            assert torch.equal(g, w), any_hit


def test_bvh_tier_launches_k4_without_the_twin(card, monkeypatch):
    """closest / any_hit on card tensors through the BVH tier: one K4
    launch each, the twin never called."""
    scene, camera = _killeroo_bvh(card)
    pixel = torch.arange(64 * 64, device=card)
    o, d, _, _ = camera_rays_full(camera, pixel, 0, 0)
    tmax = torch.full((o.shape[0],), float("inf"), device=card)
    want = traverse.bvh_intersect_ref(scene.bvh, o, d, tmax)

    def no_twin(*args, **kwargs):
        raise AssertionError("the twin ran on card tensors")

    monkeypatch.setattr(traverse, "bvh_intersect_ref", no_twin)
    traverse.STATS.reset()
    cluster.STATS.reset()
    isect = api.closest(scene, o, d, tmax)
    occ = api.any_hit(scene, o, d, tmax)
    torch.cuda.synchronize()
    assert traverse.STATS.launches == 2 and cluster.STATS.launches == 0
    assert torch.equal(isect.prim, want[1])
    assert torch.equal(occ, want[1] >= 0)


def test_k4_build_failure_raises(card, monkeypatch, tmp_path):
    """A source nvcc refuses raises at the launch; nothing falls back."""
    scene, _ = small_killeroo_class_scene("pbrt_tpu_torch", (8, 8))
    bvh = build_bvh(scene.geom.tri_verts.numpy()).to(card)
    o, d, tmax = _box_rays(64, 1, card)
    for header in nvcc_build.CSRC_DIR.glob("*.cuh"):
        (tmp_path / header.name).write_bytes(header.read_bytes())
    (tmp_path / "traverse.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(nvcc_build, "CSRC_DIR", tmp_path)
    nvcc_build.load_library.cache_clear()
    traverse.STATS.reset()
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            traverse.bvh_intersect(bvh, o, d, tmax)
    finally:
        nvcc_build.load_library.cache_clear()
    assert traverse.STATS.launches == 0


@pytest.mark.parametrize("name", CASES)
def test_k4_matches_twin_on_walk_cases(card, name):
    """Both modes on trees of depth 0, 1, 4 and 5, on bit-equal coplanar
    copies straddling leaves (exact t ties: the order decides prim), on
    rays lying in box faces and on dead lanes: K4 equals the twin in t,
    prim, u and v (tests/torch_port_bvh_walk.py builds the cases)."""
    tris, rays = walk_case(name)
    bvh = build_bvh(tris).to(card)
    o, d, tmax = (torch.tensor(np.asarray(x), dtype=torch.float32,
                               device=card) for x in rays)
    for any_hit in (False, True):
        traverse.STATS.reset()
        got = traverse.bvh_intersect(bvh, o, d, tmax, any_hit=any_hit)
        torch.cuda.synchronize()
        assert traverse.STATS.launches == 1
        want = traverse.bvh_intersect_ref(bvh, o, d, tmax, any_hit=any_hit)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            assert torch.equal(g, w), (name, any_hit)


def test_k4_stack_is_sized_for_its_walk(card):
    """The built kernel sizes its stack as the CPU model bounds the walk
    (tests/test_torch_bvh_walk.py checks the model's occupancy against
    it), for every depth it takes."""
    for depth in range(31):
        c = traverse.constants(depth)
        assert c["max_depth"] == 30
        assert c["stack_entries"] == stack_entries(depth)


def _cornell_loss_and_grad(dev, res=16, k=2, lanes=8):
    """The bench's loss and its gradients on Cornell res x res, k spp,
    depth 5 without Russian roulette, through render_loss_and_grad."""
    from pbrt_tpu_torch.parallel.train import render_loss_and_grad

    scene, camera = cornell_box(resolution=(res, res))
    scene = scene.with_accel().to(dev)
    npix = res * res
    pixel = torch.arange(npix, device=dev).repeat(k)
    sample = torch.arange(k, device=dev).repeat_interleave(npix)
    target = torch.full((npix * k, 3), 0.25, device=dev)
    return render_loss_and_grad(
        scene, camera.to(dev), PathIntegrator(max_depth=5, rr_start_depth=5),
        pixel, target, sample, 0, n_spectrum=lanes)


def test_gradient_on_card_matches_cpu(card):
    """Cornell 16x16: the card's loss and gradients against the same pass
    on the CPU, each gradient within 1e-3 of its tensor's largest
    magnitude; the unhit materials' rows exactly 0 on both."""
    loss, grads = _cornell_loss_and_grad(card)
    want_loss, want = _cornell_loss_and_grad("cpu")
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-4)
    for name, g in grads.items():
        assert g.device.type == "cuda"
        g, w = g.cpu().numpy(), want[name].numpy()
        assert np.all(np.isfinite(g))
        assert np.max(np.abs(g - w)) <= 1e-3 * np.max(np.abs(w)), name
        assert np.all(g[w == 0.0] == 0.0), name


def test_gradient_lands_on_a_cpu_leaf(card):
    """A leaf made on the CPU and moved with Scene.to receives its
    gradient on the CPU, through the card's pass."""
    scene, camera = cornell_box(resolution=(8, 8))
    x = scene.materials.albedo_coeffs.clone().requires_grad_(True)
    scene = scene.replace(materials=scene.materials.replace(albedo_coeffs=x))
    scene = scene.with_accel().to(card)
    pixel = torch.arange(64, device=card)
    o, d, wl, _ = camera_rays_full(camera.to(card), pixel, 0, 0,
                                   n_spectrum=8)
    L = PathIntegrator(max_depth=3).trace(scene, o, d, wl, pixel, 0, 0)
    torch.mean(L).backward()
    assert x.grad is not None and x.grad.device.type == "cpu"
    assert torch.isfinite(x.grad).all() and bool((x.grad != 0).any())


def test_backward_pass_launches_no_k1(card):
    """A forward+backward pass makes 11 K1 launches, as a forward does:
    the backward recomputes shading only."""
    STATS.reset()
    loss, grads = _cornell_loss_and_grad(card)
    torch.cuda.synchronize()
    assert STATS.launches == 11
    STATS.reset()
    with torch.no_grad():
        scene, camera = cornell_box(resolution=(16, 16))
        render(scene.with_accel(), camera,
               PathIntegrator(max_depth=5, rr_start_depth=5), spp=2,
               samples_per_pass=2, n_spectrum=8, device=card)
    torch.cuda.synchronize()
    assert STATS.launches == 11


# Every light type of the port in one small scene: point, spot, distant,
# projection, goniometric, an emissive sphere and the uniform infinite
# light over a floor and a conductor sphere.
_LIGHTS_TEXT = """
LookAt 0 2 -5  0 0.5 0  0 1 0
Camera "perspective" "float fov" 40
Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
Integrator "path" "integer maxdepth" 4
WorldBegin
LightSource "point" "point3 from" [2 4 -3] "rgb I" [10 10 10]
LightSource "spot" "point3 from" [0 4 -1] "point3 to" [0 0 0]
  "rgb I" [30 28 25] "float coneangle" 35 "float conedeltaangle" 10
LightSource "distant" "point3 from" [-1 2 -1] "point3 to" [0 0 0]
  "rgb L" [0.8 0.8 0.7]
LightSource "projection" "float fov" 50 "rgb I" [3 3 3]
LightSource "goniometric" "point3 from" [1 3 1] "rgb I" [2 2 2]
LightSource "infinite" "rgb L" [0.1 0.1 0.12]
Material "diffuse" "rgb reflectance" [0.6 0.6 0.6]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [-6 0 -6  6 0 -6  6 0 6  -6 0 6]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [4 3 2]
  Translate -1 1.5 0.5
  Shape "sphere" "float radius" 0.3
AttributeEnd
AttributeBegin
  Material "conductor" "float roughness" 0.15
  Translate 0 0.5 0
  Shape "sphere" "float radius" 0.5
AttributeEnd
"""


@pytest.mark.parametrize("source", ["spot.pbrt", "every_light"])
def test_light_file_render_on_card_matches_cpu(card, source):
    """tests/goldens/spot.pbrt, and a scene holding every light type, at
    16x16 on the card (K1) against the same render on the CPU."""
    if source == "every_light":
        scene, camera, settings = load_pbrt_string(_LIGHTS_TEXT, device="cpu")
    else:
        scene, camera, settings = load_pbrt("tests/goldens/" + source,
                                            device="cpu")
        camera = camera.replace(resolution=(16, 16))
    kw = dict(spp=4, seed=1, samples_per_pass=2, n_spectrum=8)
    STATS.reset()
    got = render(scene, camera, settings["integrator"], device=card, **kw)
    torch.cuda.synchronize()
    assert STATS.launches == 9 * 2
    want = render(scene, camera, settings["integrator"], device="cpu", **kw)
    got = got.cpu().numpy()
    want = want.numpy()
    assert np.all(np.isfinite(got)) and want.mean() > 0.01
    ok = np.abs(got - want) <= 1e-5 + 1e-3 * np.abs(want)
    assert np.mean(ok) >= 0.99, int(np.sum(~ok))


@pytest.mark.parametrize("name", ["dielectric.pbrt", "spheres.pbrt",
                                  "texture.pbrt", "imagetex.pbrt"])
def test_material_file_render_on_card_matches_cpu(card, name):
    """The golden files of the dielectric BxDFs and the textures at 16x16
    on the card (K1; the per-ray albedo fit on the card) against the same
    render on the CPU."""
    scene, camera, settings = load_pbrt("tests/goldens/" + name, device="cpu")
    camera = camera.replace(resolution=(16, 16))
    depth = settings["integrator"].max_depth
    kw = dict(spp=4, seed=1, samples_per_pass=2, n_spectrum=8)
    STATS.reset()
    got = render(scene, camera, settings["integrator"], device=card, **kw)
    torch.cuda.synchronize()
    assert STATS.launches == (2 * depth + 1) * 2
    want = render(scene, camera, settings["integrator"], device="cpu", **kw)
    got = got.cpu().numpy()
    want = want.numpy()
    assert np.all(np.isfinite(got)) and want.mean() > 0.01
    ok = np.abs(got - want) <= 1e-5 + 1e-3 * np.abs(want)
    assert np.mean(ok) >= 0.99, int(np.sum(~ok))


def test_any_hit_accepts_infinite_tmax(card):
    """A shadow ray toward a distant or infinite light may carry an
    infinite tmax into any-hit: K1 (Cornell), K2, K3 and K4 (the small
    killeroo-class scene) answer it as their twins do on the CPU."""
    cornell, cam_c = cornell_box(resolution=(32, 32))
    killeroo, cam_k = small_killeroo_class_scene("pbrt_tpu_torch", (32, 32))
    cases = [
        (cornell.with_accel(), cam_c, STATS),
        (killeroo, cam_k, cluster.STATS),
        (killeroo.with_accel(kind="sweep"), cam_k, sweep.STATS),
        (killeroo.replace(clusters=None, bvh=build_bvh(
            killeroo.geom.tri_verts.numpy())), cam_k, traverse.STATS),
    ]
    for scene, camera, counter in cases:
        pixel = torch.arange(32 * 32)
        o, d, _, _ = camera_rays_full(camera, pixel, 0, 0, n_spectrum=8)
        # From the first hits, straight up and along the camera ray.
        hit = api.closest(scene, o, d)
        p = torch.where(hit.valid[:, None], hit.p + 1e-3 * hit.n, o)
        dirs = torch.where(torch.arange(32 * 32)[:, None] % 2 == 0,
                           torch.tensor([0.0, 1.0, 0.0]), d)
        tmax = torch.full((32 * 32,), float("inf"))
        want = api.any_hit(scene, p, dirs, tmax)
        counter.reset()
        got = api.any_hit(scene.to(card), p.to(card), dirs.to(card),
                          tmax.to(card))
        torch.cuda.synchronize()
        assert counter.launches == 1
        assert torch.equal(got.cpu(), want) and 0 < int(want.sum()) < len(want)


def _share_close(got, want):
    ok = np.abs(got - want) <= 1e-5 + 1e-3 * np.abs(want)
    return float(np.mean(ok)), int(np.sum(~ok))


@pytest.mark.parametrize("sampler", ["power", "bvh"])
def test_hall_render_on_card_matches_cpu(card, sampler):
    """The full many-light hall (1,024 panels, K2) at 16x16, 2 spp, depth 4
    without Russian roulette, on the card against the CPU, the walk on
    coarse keys (tests/torch_port_coated.py)."""
    from pbrt_tpu_torch.materials import layered
    from pbrt_tpu_torch.scenes.manylight import manylight_scene

    scene, camera = manylight_scene(resolution=(16, 16), sampler=sampler)
    integ = PathIntegrator(max_depth=4, rr_start_depth=4)
    kw = dict(spp=2, seed=1, samples_per_pass=2, n_spectrum=8)
    with coarse_walk_keys(layered):
        cluster.STATS.reset()
        got = render(scene, camera, integ, device=card, **kw)
        torch.cuda.synchronize()
        assert cluster.STATS.launches == 9
        want = render(scene, camera, integ, device="cpu", **kw)
    got, want = got.cpu().numpy(), want.numpy()
    assert np.all(np.isfinite(got)) and want.mean() > 0.1
    share, n_bad = _share_close(got, want)
    assert share >= 0.99, n_bad


def test_coated_cornell_render_on_card_matches_cpu(card):
    """The coated Cornell box (coated diffuse, coated conductor; K1) at
    16x16, 4 spp in passes of 2, depth 5, on the card against the CPU,
    the walk on coarse keys."""
    from pbrt_tpu_torch.materials import layered

    scene, camera = coated_cornell("pbrt_tpu_torch", (16, 16))
    scene = scene.with_accel()
    kw = dict(spp=4, seed=1, samples_per_pass=2, n_spectrum=8)
    with coarse_walk_keys(layered):
        STATS.reset()
        got = render(scene, camera, PathIntegrator(max_depth=5), device=card,
                     **kw)
        torch.cuda.synchronize()
        assert STATS.launches == 11 * 2
        want = render(scene, camera, PathIntegrator(max_depth=5),
                      device="cpu", **kw)
    got, want = got.cpu().numpy(), want.numpy()
    assert np.all(np.isfinite(got)) and want.mean() > 0.01
    share, n_bad = _share_close(got, want)
    assert share >= 0.99, n_bad


def test_sorted_dispatch_is_bit_equal_on_card(card):
    """The sorted dispatch against the lockstep chain on the card: 20,000
    lanes of seven kinds, every output bit for bit."""
    from pbrt_tpu_torch.core import spectrum
    from pbrt_tpu_torch.materials import bxdf
    from pbrt_tpu_torch.materials.buffers import MaterialBuffers
    from pbrt_tpu_torch.materials.sorted import shade_sorted
    from pbrt_tpu_torch.models.path import _bsdf_calls

    mats = [{"kind": 0, "albedo": (0.6, 0.4, 0.3)},
            {"kind": 1, "conductor": "Cu", "roughness": 0.2},
            {"kind": 2, "eta": 1.5, "roughness": 0.1},
            {"kind": 3, "eta": 1.5},
            {"kind": 4, "albedo": (0.35, 0.35, 0.4), "coat_roughness": 0.08},
            {"kind": 5, "conductor": "Au", "roughness": 0.1},
            {"kind": 6, "transmittance": (0.2, 0.4, 0.6)}]
    n = 20_000
    r = np.random.default_rng(30)
    mat = torch.from_numpy(r.integers(0, len(mats), n)).to(card)
    params = MaterialBuffers.build(mats).to(card).gather(mat)
    params.update({flag: False for flag in bxdf.FLAGS})
    params.update({bxdf.FAMILY_FLAGS[m["kind"]]: True for m in mats[1:]})
    params["lam"] = spectrum.sample_visible(
        torch.from_numpy(r.uniform(0, 1, n).astype(np.float32)).to(card), 8).lam
    wo = r.normal(size=(n, 3))
    wo[:, 2] = np.abs(wo[:, 2])
    wi = r.normal(size=(n, 3))
    ops = {"wo": wo / np.linalg.norm(wo, axis=-1, keepdims=True),
           "wi": wi / np.linalg.norm(wi, axis=-1, keepdims=True),
           "u2": r.uniform(0, 1, (n, 2)), "uc": r.uniform(0, 1, n)}
    ops = {k: torch.tensor(v, dtype=torch.float32, device=card)
           for k, v in ops.items()}
    want = _bsdf_calls(params, ops)
    got = shade_sorted(params, ops, _bsdf_calls)
    for name in ("f_nee", "pdf_b"):
        assert torch.equal(got[name], want[name]), name
    for name in ("wi", "f", "pdf", "specular"):
        assert torch.equal(got["bs"][name], want["bs"][name]), name


@pytest.mark.parametrize("name", ["cloud", "fog.pbrt"])
def test_volpath_render_on_card_matches_cpu(card, name):
    """The volumetric path on the card against the CPU: the bench cloud
    (grid medium, DDA walk, K1 for the floor) and fog.pbrt (interior
    medium, four-crossing shadow walks) at 16x16, 4 spp in passes of 2, the
    medium entry inset (tests/torch_port_media.py) as the goldens are."""
    from pbrt_tpu_torch.media.medium import MediumBuffers
    from pbrt_tpu_torch.models.volpath import VolPathIntegrator
    from pbrt_tpu_torch.scenes.cloud import cloud_scene

    from .torch_port_media import inset_entry

    if name == "cloud":
        scene, camera = cloud_scene(resolution=(16, 16))
        integ, per_pass = VolPathIntegrator(max_depth=6), 3 * 6 + 2
    else:
        scene, camera, settings = load_pbrt("tests/goldens/" + name,
                                            device="cpu")
        camera = camera.replace(resolution=(16, 16))
        integ = settings["integrator"]
        per_pass = 9 * integ.max_depth + 1
    kw = dict(spp=4, seed=1, samples_per_pass=2, n_spectrum=8)
    with inset_entry(MediumBuffers):
        STATS.reset()
        got = render(scene, camera, integ, device=card, **kw)
        torch.cuda.synchronize()
        assert STATS.launches == per_pass * 2
        want = render(scene, camera, integ, device="cpu", **kw)
    got, want = got.cpu().numpy(), want.numpy()
    assert np.all(np.isfinite(got)) and want.mean() > 0.01
    share, n_bad = _share_close(got, want)
    assert share >= 0.99, n_bad


def test_volpath_compacted_walks_equal_lockstep_on_card(card):
    """The staged compaction of the walks against the lockstep walks on
    the card: the cloud's samples and ray count bit for bit."""
    from pbrt_tpu_torch.models.volpath import VolPathIntegrator
    from pbrt_tpu_torch.scenes.cloud import cloud_scene

    scene, camera = cloud_scene(resolution=(32, 32))
    scene, camera = scene.to(card), camera.to(card)
    pixel = torch.arange(1024, device=card).repeat(4)
    sample = torch.arange(4, device=card).repeat_interleave(1024)
    o, d, wl, _ = camera_rays_full(camera, pixel, sample, 0, n_spectrum=8)
    args = (scene, o, d, wl, pixel, sample, 0)
    a, sa = VolPathIntegrator(max_depth=6).trace_with_stats(*args)
    b, sb = VolPathIntegrator(max_depth=6,
                              compact_walks=False).trace_with_stats(*args)
    assert torch.equal(a, b) and bool(sa["rays"] == sb["rays"])
    assert float(a.mean()) > 0.05


def test_families_render_on_card_matches_cpu(card):
    """The families box (hair, subsurface, measured, mix, retroreflective)
    on the card against the CPU: 16x16, 4 spp in passes of 2, the mix hash
    on coarse keys (tests/torch_port_families.py); 16 K1 launches a pass
    (a closest query, the subsurface probe and a shadow query per bounce,
    the terminal closest)."""
    from pbrt_tpu_torch.materials import bxdf

    from .torch_port_families import FAMILIES_PBRT, coarse_mix_keys

    scene, camera, settings = load_pbrt(FAMILIES_PBRT, device="cpu")
    camera = camera.replace(resolution=(16, 16))
    integ = settings["integrator"]
    kw = dict(spp=4, seed=1, samples_per_pass=2, n_spectrum=8)
    with coarse_mix_keys(bxdf):
        STATS.reset()
        got = render(scene, camera, integ, device=card, **kw)
        torch.cuda.synchronize()
        assert STATS.launches == (3 * integ.max_depth + 1) * 2
        want = render(scene, camera, integ, device="cpu", **kw)
    got, want = got.cpu().numpy(), want.numpy()
    assert np.all(np.isfinite(got)) and want.mean() > 0.01
    share, n_bad = _share_close(got, want)
    assert share >= 0.99, n_bad


def test_k1_subsurface_probe_matches_twin(card):
    """The subsurface probe's query (closest, a per-ray finite tmax of
    twice the chord, from above the surface along -n) on the families box:
    K1 against its twin, bit for bit."""
    from pbrt_tpu_torch.core.vecmath import coordinate_system
    from pbrt_tpu_torch.materials import bssrdf

    from .torch_port_families import FAMILIES_PBRT

    scene, camera, _ = load_pbrt(FAMILIES_PBRT, device=card)
    n = 65_536
    pixel = torch.arange(n, device=card) % 1024
    o, d, wl, _ = camera_rays_full(camera, pixel, 0, 0, n_spectrum=8)
    isect = api.closest(scene, o, d)
    t1, t2 = coordinate_system(isect.n)
    queries = []
    closest = api.closest

    def capture(scene_, o_, d_, tmax=None):
        queries.append((o_, d_, tmax))
        return closest(scene_, o_, d_, tmax=tmax)

    api.closest = capture
    try:
        r = torch.rand(2, n, device=card, generator=torch.Generator(
            device=card).manual_seed(0))
        bssrdf.subsurface_exit(scene, isect, isect.n, t1, t2,
                               torch.full((n, 8), 0.9, device=card),
                               torch.full((n,), 0.3, device=card), r[0], r[1])
    finally:
        api.closest = closest
    (po, pd, tmax), = queries
    assert bool(torch.isfinite(tmax).all()) and bool((tmax > 0).any())
    got = smallscene_intersect(scene.small, po, pd, tmax)
    want = smallscene_intersect_ref(scene.small, po, pd, tmax)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def _golden_file(name, res):
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "goldens", name + ".pbrt")
    scene, camera, settings = load_pbrt(path, device="cpu")
    return scene, camera.replace(resolution=(res, res)), settings["integrator"]


def test_bdpt_and_lightpath_on_card_match_cpu(card):
    """BDPT's radiance and splats and the light path's splats on
    bdpt.pbrt's room on the card against the CPU, 16x16: the splats add
    with atomics on the card (last bits only), so >= 99% of the values
    within rtol 1e-3 / atol 1e-5; 32 K1 launches a BDPT pass, 11 a
    light-path pass."""
    from pbrt_tpu_torch.models.bdpt import render_bdpt
    from pbrt_tpu_torch.models.lightpath import render_lightpath

    scene, camera, integ = _golden_file("bdpt", 16)
    STATS.reset()
    got = render_bdpt(scene, camera, spp=2, samples_per_pass=2, n_spectrum=8,
                      device=card)
    torch.cuda.synchronize()
    assert STATS.launches == 32
    want = render_bdpt(scene, camera, spp=2, samples_per_pass=2,
                       n_spectrum=8, device="cpu")
    share, n_bad = _share_close(got.cpu().numpy(), want.numpy())
    assert share >= 0.99 and want.mean() > 0.01, n_bad
    STATS.reset()
    got = render_lightpath(scene, camera, n_paths_total=512,
                           paths_per_pass=256, n_spectrum=8, device=card)
    torch.cuda.synchronize()
    assert STATS.launches == 22
    want = render_lightpath(scene, camera, n_paths_total=512,
                            paths_per_pass=256, n_spectrum=8, device="cpu")
    share, n_bad = _share_close(got.cpu().numpy(), want.numpy())
    assert share >= 0.99, n_bad


def test_sppm_on_card_matches_cpu(card):
    """Two SPPM iterations of sppm.pbrt at 16x16 (4,096 photons an
    iteration) on the card against the CPU: the radii (from the integer
    photon counts M) and the image (Phi added with atomics on the card)
    each on >= 99% of their values within rtol 1e-3 / atol 1e-5 (a photon
    that rounds into another cell moves a pixel's count)."""
    scene, camera, integ = _golden_file("sppm", 16)
    integ = integ.replace(photons_per_iteration=4096)
    kw = dict(n_iterations=2, return_stats=True, n_spectrum=8)
    got, got_stats = integ.render(scene, camera, device=card, **kw)
    want, want_stats = integ.render(scene, camera, device="cpu", **kw)
    share, n_bad = _share_close(got_stats["radius"].cpu().numpy(),
                                want_stats["radius"].numpy())
    assert share >= 0.99, n_bad
    share, n_bad = _share_close(got.cpu().numpy(), want.numpy())
    assert share >= 0.99 and want.mean() > 0.01, n_bad


def test_mlt_on_card_matches_cpu(card):
    """mlt.pbrt's bootstrap and first steps, 64 chains at 16x16, on the
    card against the CPU: b within rtol 1e-5, the chain starts equal, each
    of 4 steps' acceptance equal on >= 99% of the chains."""
    from pbrt_tpu_torch.models.mlt import MLTIntegrator

    scene, camera, integ = _golden_file("mlt", 16)
    integ = MLTIntegrator(base=integ.base, n_chains=64, mutations_per_chain=4)
    runs = {}
    for dev in (card, torch.device("cpu")):
        s, c = scene.to(dev), camera.to(dev)
        b, u0 = integ._bootstrap(s, c, 0, 8)
        state = integ.start(s, c, u0, 8)
        acc = []
        for t in range(4):
            state, a = integ.step(s, c, state, t, b, 0, 8)
            acc.append(a.cpu())
        runs[dev.type] = (b, u0.cpu(), torch.stack(acc))
    (b1, u1, a1), (b2, u2, a2) = runs["cuda"], runs["cpu"]
    assert b1 == pytest.approx(b2, rel=1e-5)
    assert torch.equal(u1, u2)
    assert float((a1 == a2).float().mean(dim=1).min()) >= 0.99


@pytest.mark.parametrize("kind", ["independent", "stratified", "sobol",
                                  "zsobol", "halton", "padded", "pmj02bn"])
def test_sampler_draws_on_card_equal_cpu(card, kind):
    """Every sampler kind's get_1d, get_2d and get_1d_run on the card, bit
    for bit the CPU's (uint32 arithmetic in int64, the byte-table Sobol'
    matrices, the pmj02 tables)."""
    from pbrt_tpu_torch.samplers.samplers import Sampler

    from .torch_port_cameras import SAMPLER_CFGS, draw_lanes, draws

    cfg = SAMPLER_CFGS["c"]
    s = Sampler.create(kind, spp=cfg["spp"], seed=cfg["seed"], nx=cfg["nx"],
                       log2_res=cfg["log2_res"])
    pixel, sample = (torch.from_numpy(a.astype(np.int64))
                     for a in draw_lanes(1 << 16, cfg))
    cpu = draws(s, pixel, sample, 12)
    gpu = draws(s, pixel.to(card), sample.to(card), 12)
    for i, (a, b) in enumerate(zip(cpu, gpu)):
        assert torch.equal(a, b.cpu()), divmod(i, 3)
    assert torch.equal(s.get_1d_run(pixel, sample, 3, 6),
                       s.get_1d_run(pixel.to(card), sample.to(card), 3,
                                    6).cpu())


@pytest.mark.parametrize("name", ["lens", "omni", "ortho", "spherical",
                                  "rtf"])
def test_camera_render_on_card_matches_cpu(card, name):
    """The Cornell box through each camera (tests/torch_port_cameras.py) on
    the card against the same render on the CPU: >= 99% of the values
    within rtol 1e-3 / atol 1e-5, K1 answering every query."""
    import os

    from .torch_port_cameras import CFG, GOLDEN, RENDERS, port_camera
    from .torch_port_helpers import share_close

    golden = np.load(GOLDEN)
    scene, _ = cornell_box(resolution=(32, 32))
    cam = port_camera(name, golden)
    kind, filt = RENDERS[name]
    kw = dict(spp=CFG["spp"], samples_per_pass=CFG["spp"], sampler_kind=kind,
              filter_kind=filt, n_spectrum=CFG["n_spectrum"])
    integ = PathIntegrator(max_depth=CFG["max_depth"])
    STATS.reset()
    gpu = render(scene.with_accel(), cam, integ, device=card, **kw).cpu()
    assert STATS.launches == 11
    cpu = render(scene.with_accel(), cam, integ, device="cpu", **kw)
    share, _ = share_close(gpu.numpy(), cpu.numpy(), rtol=1e-3, atol=1e-5)
    assert share >= 0.99 and float(gpu.mean()) > 0.0
    assert os.path.exists(GOLDEN)


def test_gbuffer_on_card_matches_cpu(card):
    """render_aovs on the card (its first-hit query K1) against the CPU's."""
    from pbrt_tpu_torch.films.gbuffer import render_aovs

    from .torch_port_helpers import share_close

    scene, camera = cornell_box(resolution=(16, 16))
    kw = dict(spp=2, spectral_buckets=4, n_spectrum=8)
    gpu = render_aovs(scene.with_accel(), camera, PathIntegrator(), device=card,
                      **kw)
    cpu = render_aovs(scene.with_accel(), camera, PathIntegrator(),
                      device="cpu", **kw)
    for k in cpu:
        share, _ = share_close(gpu[k].cpu().numpy(), cpu[k].numpy(),
                               rtol=1e-3, atol=1e-5)
        assert share >= 0.99, k


@pytest.mark.parametrize("mode", ["remat", "cvjp_full", "cvjp_dots",
                                  "cvjp_none", "attached", "families"])
def test_grad_estimator_on_card_matches_cpu(card, mode):
    """Each gradient estimator on the card against the same pass on the
    CPU (the goldens' scenes, 16x16, 2 spp, depth 5): every gradient
    within 1e-3 of the CPU's largest entry, and no K1 launch in the
    backward (the forward's as many as the primal's)."""
    from .torch_port_families import coarse_mix_keys
    from .torch_port_grad import (
        ATTACHED_LEAVES,
        DEFAULT_LEAVES,
        TEXEL_LEAVES,
        TEXEL_MODES,
        dielectric_cornell,
        families_box,
        grad_errors,
        pass_loss_and_grads,
        texel_cornell,
    )
    from pbrt_tpu_torch.materials import bxdf

    res, spp = 16, 2
    if mode == "families":
        scene, camera, integ = families_box(res)
        leaves = DEFAULT_LEAVES
    else:
        if mode == "attached":
            scene, camera = dielectric_cornell(res)
            kw, leaves = {"replay_grad": False}, ATTACHED_LEAVES
        else:
            scene, camera = texel_cornell(res)
            kw, leaves = dict(TEXEL_MODES)[mode], TEXEL_LEAVES
        scene = scene.with_accel()
        integ = PathIntegrator(max_depth=5, rr_start_depth=5, **kw)
    with coarse_mix_keys(bxdf):
        cpu = pass_loss_and_grads(scene, camera, integ, leaves, res, spp)
        on_card = scene.to(card)
        with torch.no_grad():
            STATS.reset()
            pixel = torch.arange(res * res, device=card).repeat(spp)
            sample = torch.arange(spp, device=card).repeat_interleave(res * res)
            o, d, wl, _ = camera_rays_full(camera.to(card), pixel, sample, 0,
                                           n_spectrum=8)
            integ.trace(on_card, o, d, wl, pixel, sample, 0)
            primal = STATS.launches
        STATS.reset()
        gpu = pass_loss_and_grads(on_card, camera, integ, leaves, res, spp)
        torch.cuda.synchronize()
    errs = grad_errors(*gpu, *cpu)
    assert errs["ok"], errs
    assert STATS.launches == primal > 0


def test_take_on_card_equals_indexing(card):
    """The texel gathers' take (core/take.py) on the card: the rows of
    table[idx] bit for bit, and its backward the indexing's sums."""
    from pbrt_tpu_torch.core.take import take

    rng = np.random.default_rng(0)
    table = torch.tensor(rng.normal(size=(21, 3)), dtype=torch.float32,
                         device=card, requires_grad=True)
    idx = torch.from_numpy(rng.integers(0, 20, 131072)).to(card)
    w = torch.tensor(rng.normal(size=(131072, 3)), dtype=torch.float32,
                     device=card)
    got, want = take(table, idx), table[idx]
    assert torch.equal(got, want)
    g_got, = torch.autograd.grad(torch.sum(got * w), table)
    g_want, = torch.autograd.grad(torch.sum(want * w), table)
    torch.testing.assert_close(g_got, g_want, rtol=1e-5, atol=1e-3)
    assert torch.all(g_got[-1] == 0.0)
