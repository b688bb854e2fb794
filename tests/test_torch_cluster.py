"""K2's builders and plain twin against the reference on the CPU: the Morton
order and cluster tables bit for bit, the twin against the Pallas kernel in
interpret mode, and the ray sort and attribute resolution of the cluster
path; and the premises of the kernel's warp-level walk (csrc/
cluster_walk.cuh), in plain PyTorch: answers that follow their rays
through any permutation, and a model of its triangle-parallel reduction.
The kernel itself is held against the twin on a card by
tests/test_torch_cuda.py.

The Pallas kernel's answers in interpret mode are committed
(tests/data/torch_port/reference_answers.npz, made from this file's inputs by
scripts/make_torch_port_golden_answers.py): a digest of the rays and of
the reference's cluster tables, both built live here, must equal the one
stored beside them.

The reference gates clusters per tile of 1024 rays and the port per ray;
the two can differ only where a slab test's rounding and the triangle test
disagree at a box face. The gates below count such rays (>= 99.9% must
agree; none did when they were written).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.accel.api import ray_sort_perm as jax_ray_sort_perm
from pbrt_tpu.accel.api import resolve_tri_attrs as jax_resolve_tri_attrs
from pbrt_tpu.accel.bvh import morton_order as jax_morton_order
from pbrt_tpu.ops.cluster import build_clusters as jax_build_clusters
from pbrt_tpu.shapes.geometry import GeometryBuffers as JGeometryBuffers
from pbrt_tpu_torch.accel.api import ray_sort_perm, resolve_tri_attrs
from pbrt_tpu_torch.accel.bvh import morton_order
from pbrt_tpu_torch.ops import nvcc_build
from pbrt_tpu_torch.ops.cluster import (
    LONE_MAX,
    STATS,
    build_clusters,
    closest_of_rows,
    cluster_intersect,
    cluster_intersect_ref,
)
from pbrt_tpu_torch.scenes.meshes import fbm_blob
from pbrt_tpu_torch.shapes.geometry import GeometryBuffers

from .torch_port_helpers import flatten_jax, inputs_digest, reference_answers

torch.set_num_threads(2)
N_KIND = 256  # rays of each kind; 4 kinds -> 1024 rays
MODES = {"closest": {}, "any_hit": {"any_hit": True},
         "closest_attrs": {"defer_attrs": False}}


def build_mesh():
    """fbm_blob(5): 20,480 triangles -> 160 clusters in 5 supers, so the
    super-level culling runs; mixed material and light ids."""
    tris = fbm_blob(5)
    r = np.random.default_rng(5)
    mat = r.integers(0, 4, len(tris)).astype(np.int32)
    light = np.where(r.random(len(tris)) < 0.05, r.integers(0, 3, len(tris)),
                     -1).astype(np.int32)
    return tris, mat, light


@pytest.fixture(scope="module")
def mesh():
    return build_mesh()


@pytest.fixture(scope="module")
def accels(mesh):
    jacc = jax_build_clusters(*mesh)
    return jacc, build_clusters(*mesh)


def pallas_inputs_digest(jacc, o, d, tmax):
    """The digest of the reference's cluster tables and the rays that the
    committed Pallas answers were computed from."""
    return inputs_digest(flatten_jax(jacc)[0], dict(o=o, d=d, tmax=tmax))


def _rays():
    """1024 rays: camera-style (shared origin, coherent), shuffled random,
    axis-parallel, and finite-tmax shadow segments; every ninth lane dead
    (tmax = 0)."""
    r = np.random.default_rng(11)
    n = N_KIND
    o_cam = np.tile([[0.0, 0.2, -3.0]], (n, 1))
    d_cam = np.concatenate([r.uniform(-0.35, 0.35, (n, 2)), np.ones((n, 1))], 1)
    o_shuf = r.uniform(-1.3, 1.3, (n, 3))
    d_shuf = r.normal(size=(n, 3))
    o_ax = r.uniform(-1.0, 1.0, (n, 3))
    d_ax = np.eye(3)[r.integers(0, 3, n)] * r.choice([-1.0, 1.0], (n, 1))
    o_sh = r.uniform(-1.3, 1.3, (n, 3))
    d_sh = r.normal(size=(n, 3))
    o = np.concatenate([o_cam, o_shuf, o_ax, o_sh]).astype(np.float32)
    d = np.concatenate([d_cam, d_shuf, d_ax, d_sh]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(4 * n, np.inf, np.float32)
    tmax[3 * n:] = r.uniform(0.05, 2.0, n)
    tmax[::9] = 0.0
    return o, d, tmax


def test_morton_order_and_tables_bit_equal(mesh, accels):
    tris = mesh[0]
    cent = tris.mean(axis=1)
    np.testing.assert_array_equal(morton_order(cent), jax_morton_order(cent))
    jacc, acc = accels
    assert (acc.n_clusters, acc.n_supers) == (jacc.n_clusters, jacc.n_supers)
    assert acc.n_supers >= 3
    for key in ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z",
                "pid", "nx", "ny", "nz", "matf", "lightf", "boxes", "sboxes"):
        np.testing.assert_array_equal(getattr(acc, key).numpy(),
                                      np.asarray(getattr(jacc, key)), key)


@pytest.mark.parametrize("any_hit", [False, True])
def test_twin_matches_pallas_interpret(accels, any_hit):
    jacc, acc = accels
    o, d, tmax = _rays()
    # Closest mode: the reference's non-deferred call gives t and prim (the
    # same as the deferred call's) and the in-kernel attributes at once.
    mode = "any_hit" if any_hit else "closest"
    want = reference_answers(f"k2/{mode}",
                             pallas_inputs_digest(jacc, o, d, tmax))
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax))
    jp = np.asarray(want["prim"])
    hits = jp >= 0
    assert 0.2 < hits.mean() < 0.9  # hits and misses both exercised
    assert not np.any(hits[::9])  # dead lanes never hit
    lean = cluster_intersect_ref(acc, *args, any_hit=any_hit)
    assert set(lean) == {"t", "prim"} and lean["prim"].dtype == torch.int32
    same = lean["prim"].numpy() == jp
    print(f"any_hit={any_hit}: {int(np.sum(~same))} of {len(jp)} rays "
          "disagree on prim")
    if any_hit:
        # Occlusion is the contract; which occluder is the first cluster's.
        np.testing.assert_array_equal(lean["prim"].numpy() >= 0, hits)
        assert np.mean(same) >= 0.999
        return
    assert np.mean(same) >= 0.999
    # t = (e2 . q) / det rounds once per op here; XLA's CPU backend may fuse
    # multiply-adds, which moved one ray's t by 1.06e-6 relative (ROADMAP
    # Queue 3), hence 2e-6.
    np.testing.assert_allclose(lean["t"].numpy()[same], np.asarray(want["t"])[same],
                               rtol=2e-6)
    full = cluster_intersect_ref(acc, *args, defer_attrs=False)
    assert set(full) == set(want)
    for k in ("t", "prim"):
        assert torch.equal(full[k], lean[k]), k
    for k in ("mat", "light"):
        np.testing.assert_array_equal(full[k].numpy()[same], np.asarray(want[k])[same])
    np.testing.assert_allclose(full["n"].numpy()[same], np.asarray(want["n"])[same],
                               rtol=1e-5, atol=1e-7)
    # u, v in [0, 1] come from sums of products of size |o - v0| |d x e2|
    # that cancel to u det: at this scene's scale (rays from 3 units away,
    # triangles ~0.03 across, det ~1e-3) one rounding of a 0.1-sized term
    # moves u by ~1e-5, and XLA's CPU backend fuses multiply-adds where the
    # twin rounds every op. The absolute residue is recorded in ROADMAP
    # Queue 3.
    for k in ("u", "v"):
        np.testing.assert_allclose(full[k].numpy()[same], np.asarray(want[k])[same],
                                   rtol=1e-5, atol=3e-5, err_msg=k)


def test_ray_sort_perm_matches():
    r = np.random.default_rng(2)
    n = 10_000
    o = r.normal(size=(n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:50] = np.eye(3)[r.integers(0, 3, 50)]  # axis-parallel
    tmax = np.where(r.random(n) < 0.2, 0.0, np.inf).astype(np.float32)
    jperm, jinv = jax_ray_sort_perm(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    perm, inv = ray_sort_perm(torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(tmax))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    # Dead lanes sort after every live one.
    assert np.all(tmax[perm.numpy()][-int(np.sum(tmax <= 0)):] == 0.0)


def test_resolve_tri_attrs_matches(mesh):
    tris, mat, light = mesh
    r = np.random.default_rng(4)
    n = 2048
    prim = r.integers(-1, len(tris), n).astype(np.int32)
    b = r.dirichlet((1.0, 1.0, 1.0), n)
    tv = tris[np.maximum(prim, 0)]
    target = np.einsum("nk,nkj->nj", b, tv)
    o = (target + r.normal(size=(n, 3))).astype(np.float32)
    d = (target - o) / np.linalg.norm(target - o, axis=-1, keepdims=True)
    d = d.astype(np.float32)
    jgeom = JGeometryBuffers.build(tri_verts=tris, tri_mat=mat, tri_light=light)
    geom = GeometryBuffers.build(tri_verts=tris, tri_mat=mat, tri_light=light)
    want = jax_resolve_tri_attrs(jgeom, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(prim))
    got = resolve_tri_attrs(geom, torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(prim))
    for g, w, name in zip(got, want, ("u", "v", "ng", "mat", "light")):
        if name in ("mat", "light"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6, err_msg=name)


def test_cpu_tensors_take_the_twin_and_count_no_launch(accels):
    _, acc = accels
    o, d, tmax = (torch.from_numpy(x) for x in _rays())
    STATS.reset()
    for kw in ({}, {"any_hit": True}, {"defer_attrs": False}):
        got = cluster_intersect(acc, o, d, tmax, **kw)
        want = cluster_intersect_ref(acc, o, d, tmax, **kw)
        for k in want:
            assert torch.equal(got[k], want[k]), (kw, k)
    assert STATS.launches == 0
    o_t = o.clone().requires_grad_()
    out = cluster_intersect(acc, o_t, d, tmax)
    assert not any(v.requires_grad for v in out.values())


def test_twin_counts_its_work(accels):
    """The passing (ray, cluster) pairs the twin counts are the kernel's
    work for its bound: culling leaves a small share of all pairs. Its
    visits nest: a 128-ray block holds four warps, a warp visit at least
    one pair, and the lone (triangle-parallel) visits are warp visits."""
    _, acc = accels
    o, d, tmax = (torch.from_numpy(x) for x in _rays())
    counts = {}
    cluster_intersect_ref(acc, o, d, tmax, counts=counts)
    live = int((tmax > 0).sum())
    pairs = counts["pairs"]
    assert 0 < pairs < 0.25 * live * acc.n_clusters
    assert pairs / 128 <= counts["block_visits"] <= counts["warp_visits"] <= pairs
    assert 0 < counts["lone_visits"] <= counts["warp_visits"]


def test_switch_over_is_a_source_constant():
    """The twin counts lone visits with the kernel's own switch-over: the
    constexpr of csrc/cluster_walk.cuh, read by no flag or environment."""
    src = (nvcc_build.CSRC_DIR / "cluster_walk.cuh").read_text()
    found = re.findall(r"constexpr int kLoneMax = (\d+);", src)
    assert found == [str(LONE_MAX)]
    for path in nvcc_build.CSRC_DIR.iterdir():
        assert "getenv" not in path.read_text(), path.name


@pytest.mark.parametrize("mode", list(MODES))
def test_permuted_rays_permute_the_answers(accels, mode):
    """Each ray's answer depends on that ray alone: the twin on permuted
    rays gives the permuted answers and the same pairs, so the kernel's
    grouping of rays into warps cannot change a result."""
    _, acc = accels
    o, d, tmax = (torch.from_numpy(x) for x in _rays())
    perm = torch.from_numpy(np.random.default_rng(3).permutation(len(o)))
    counts, counts_p = {}, {}
    want = cluster_intersect_ref(acc, o, d, tmax, counts=counts, **MODES[mode])
    got = cluster_intersect_ref(acc, o[perm], d[perm], tmax[perm],
                                counts=counts_p, **MODES[mode])
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k][perm]), k
    assert counts_p["pairs"] == counts["pairs"]


def _triangle_parallel(hit, tk, pid):
    """Plain model of the kernel's triangle-parallel mapping of k rays x
    128 rows: row j on lane j % 32; each lane scans its 4 rows from (3e38,
    0, -1) keeping the lexicographic minimum of (t ascending, pid
    descending, row ascending) among hits, then a 5-step butterfly keeps
    the preferred of each lane pair. Any-hit: OR of the lanes' hits and the
    largest pid. Returns (t, pid, row) of closest and (got, pid) of
    any-hit, as lane 0 holds them."""
    k = hit.shape[0]
    big = torch.tensor(3e38, dtype=torch.float32)
    rows = torch.arange(128).reshape(4, 32)  # [slot, lane] -> row
    bt = big.expand(k, 32).clone()
    bp = torch.zeros((k, 32))
    bj = torch.full((k, 32), -1)

    def before(ta, pa, ja, tb, pb, jb):
        return (ta < tb) | ((ta == tb) & ((pa > pb) | ((pa == pb) & (ja < jb))))

    for m in range(4):
        j = rows[m]
        ct, cp, cj = tk[:, j], pid[:, j], j.expand(k, 32)
        take = hit[:, j] & before(ct, cp, cj, bt, bp, bj)
        bt, bp, bj = (torch.where(take, a, b) for a, b in
                      ((ct, bt), (cp, bp), (cj, bj)))
    lane_got = hit[:, rows.T].any(dim=2)
    lane_pid = torch.where(hit, pid, 0.0)[:, rows.T].amax(dim=2)
    got, pmax = lane_got, lane_pid
    for off in (16, 8, 4, 2, 1):
        partner = torch.arange(32) ^ off
        ot, op, oj = bt[:, partner], bp[:, partner], bj[:, partner]
        take = before(ot, op, oj, bt, bp, bj)
        bt, bp, bj = (torch.where(take, a, b) for a, b in
                      ((ot, bt), (op, bp), (oj, bj)))
        got = got | got[:, partner]
        pmax = torch.maximum(pmax, pmax[:, partner])
    assert all(torch.equal(x, x[:, :1].expand(-1, 32))
               for x in (bt, bp, bj, got, pmax))  # every lane agrees
    return (bt[:, 0], bp[:, 0], bj[:, 0]), (got[:, 0], pmax[:, 0])


@pytest.mark.parametrize("rows", ["random", "ties"])
def test_triangle_parallel_reduction_is_the_scan(rows):
    """The triangle-parallel reduction gives the twin's closest_of_rows
    (smallest t, largest pid among exact ties, the first such row for u
    and v) and its any-hit rule (any hit, largest pid), on random rows and
    on rows whose t and pid repeat (t = 3e38 included)."""
    r = np.random.default_rng(7)
    k = 512
    if rows == "random":
        tk = r.uniform(0.1, 10.0, (k, 128))
        pid = np.stack([r.permutation(128) + 1.0 for _ in range(k)])
        pid[:, ::17] = 0.0  # pad slots
        hit = (r.random((k, 128)) < 0.05) & (pid > 0)
    else:
        tk = r.choice([0.5, 1.0, 3e38], (k, 128))
        pid = r.integers(1, 9, (k, 128)).astype(np.float64)
        hit = r.random((k, 128)) < r.choice([0.0, 0.02, 0.5], (k, 1))
    tk, pid = (torch.tensor(x, dtype=torch.float32) for x in (tk, pid))
    hit = torch.from_numpy(hit)
    (t, p, j), (got, pmax) = _triangle_parallel(hit, tk, pid)
    # closest_of_rows takes one pid row for every ray; here each ray has
    # its own, so it runs ray by ray.
    row_ties = 0
    for i in range(k):
        tmin, eq, pid_sel = closest_of_rows(hit[i:i + 1], tk[i:i + 1],
                                            pid[i:i + 1])
        one = eq[0] & (pid[i] == pid_sel[0])
        row_ties += int(one.sum()) > 1
        row = int(torch.nonzero(one)[0]) if bool(one.any()) else -1
        assert (float(t[i]), float(p[i]), int(j[i])) == (
            float(tmin[0]), float(pid_sel[0]), row), i
    assert torch.equal(got, hit.any(dim=1))
    assert torch.equal(pmax, torch.where(hit, pid, 0.0).amax(dim=1))
    if rows == "ties":  # hits at 3e38 win, and (t, pid) repeat in rows
        assert bool(((t == 3e38) & (p > 0)).any()) and row_ties > 0
