"""K3's builder and plain twin against the reference on the CPU: the sweep
tables bit for bit, the twin against the Pallas kernel in interpret mode
(instanced and not, closest and any-hit, dead lanes included), the
instanced attribute resolution, and answers that follow their rays through
any permutation (the premise of the kernel's warp-level walk). The kernel itself is held against the twin
on a card by tests/test_torch_cuda.py.

The reference walks (cluster, instance) entries per tile of 1024 rays in
the tile's order of entry t; the port gates per ray and walks instances
and clusters in order. The two can differ only where a slab test's
rounding and the triangle test disagree at a box face, or on an exact t
tie between two clusters: the gates count such rays (none, when they were
written).

The Pallas kernel's answers in interpret mode are committed
(tests/data/torch_port/reference_answers.npz, made from this file's inputs by
scripts/make_torch_port_golden_answers.py): a digest of the rays and of
the reference's sweep tables, both built live here, must equal the one
stored beside them.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.accel.api import resolve_tri_attrs_inst as jax_resolve_inst
from pbrt_tpu.ops.sweep import build_sweep as jax_build_sweep
from pbrt_tpu.shapes.geometry import GeometryBuffers as JGeometryBuffers
from pbrt_tpu_torch.accel.api import resolve_tri_attrs_inst
from pbrt_tpu_torch.core import transform as tfm
from pbrt_tpu_torch.ops import nvcc_build
from pbrt_tpu_torch.ops.sweep import (
    _GROUP,
    STATS,
    build_sweep,
    sweep_intersect,
    sweep_intersect_ref,
)
from pbrt_tpu_torch.scenes.meshes import fbm_blob
from pbrt_tpu_torch.shapes.geometry import GeometryBuffers, make_quad

from .torch_port_helpers import flatten_jax, inputs_digest, reference_answers

torch.set_num_threads(2)
N_KIND = 256  # rays of each kind; 4 kinds -> 1024 rays
# Rays where the port's per-ray order and the reference's per-tile order
# give another prim (closest mode), as counted when the gate was written.
PRIM_DIFFERENCES = 0


def _o2w(delta, angle, s):
    m = (tfm.translate(delta).m @ tfm.rotate((0.0, 1.0, 0.0), angle).m
         @ tfm.scale(s).m)
    return m.numpy()


def build_sweeps():
    """Two sweep builds of a floor quad and fbm_blob(3) (1,280 triangles,
    10 clusters): instanced (the floor as the identity root instance, four
    blob instances, one under a non-uniform scale) and not (everything in
    world space, one identity instance)."""
    floor = make_quad((-4, -1, -4), (4, -1, -4), (4, -1, 4), (-4, -1, 4))
    blob = fbm_blob(3)
    tris = np.concatenate([floor, blob]).astype(np.float32)
    o2w = np.stack([
        np.eye(4, dtype=np.float32),
        _o2w((-1.2, 0.0, 0.0), 0.0, 1.0),
        _o2w((1.2, 0.0, 0.0), 40.0, (1.6, 0.6, 1.0)),
        _o2w((0.0, 0.0, 1.5), 90.0, 1.0),
        _o2w((0.0, 1.2, -1.0), 10.0, 0.7),
    ])
    inst = dict(proto_ranges=[(0, 2), (2, len(blob))],
                instances=(np.array([0, 1, 1, 1, 1], np.int32), o2w))
    return {
        "instanced": (tris, jax_build_sweep(tris, **inst),
                      build_sweep(tris, **inst)),
        "flat": (tris, jax_build_sweep(tris), build_sweep(tris)),
    }


@pytest.fixture(scope="module")
def builds():
    return build_sweeps()


def pallas_inputs_digest(jacc, o, d, tmax):
    """The digest of the reference's sweep tables and the rays that the
    committed Pallas answers were computed from."""
    return inputs_digest(flatten_jax(jacc)[0], dict(o=o, d=d, tmax=tmax))


def _rays():
    """1024 rays: camera-style (shared origin, coherent), random, axis-
    parallel, and finite-tmax shadow segments; every ninth lane dead (tmax
    = 0), and every 31st a dead lane as the path sends it (origin 1e8)."""
    r = np.random.default_rng(11)
    n = N_KIND
    o_cam = np.tile([[0.0, 0.5, -5.0]], (n, 1))
    d_cam = np.concatenate([r.uniform(-0.4, 0.4, (n, 2)), np.ones((n, 1))], 1)
    o_rand = r.uniform(-2.5, 2.5, (n, 3))
    d_rand = r.normal(size=(n, 3))
    o_ax = r.uniform(-2.0, 2.0, (n, 3))
    d_ax = np.eye(3)[r.integers(0, 3, n)] * r.choice([-1.0, 1.0], (n, 1))
    o_sh = r.uniform(-2.5, 2.5, (n, 3))
    d_sh = r.normal(size=(n, 3))
    o = np.concatenate([o_cam, o_rand, o_ax, o_sh]).astype(np.float32)
    d = np.concatenate([d_cam, d_rand, d_ax, d_sh]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(4 * n, np.inf, np.float32)
    tmax[3 * n:] = r.uniform(0.05, 3.0, n)
    tmax[::9] = 0.0
    o[::31] = 1e8
    tmax[::31] = 0.0
    return o, d, tmax


@pytest.mark.parametrize("kind", ["instanced", "flat"])
def test_tables_bit_equal(builds, kind):
    _, jacc, acc = builds[kind]
    arrays, static = flatten_jax(jacc)
    for path, value in arrays.items():
        np.testing.assert_array_equal(getattr(acc, path).numpy(), value, path)
    for path, value in static.items():
        assert getattr(acc, path) == value, path
    # The instance tables the port derives: each instance's cluster range
    # and the union of its entries' world boxes.
    n_inst = acc.n_instances
    want_range = [[0, 1]] + [[1, 10]] * 4 if kind == "instanced" else [[0, 11]]
    assert acc.irange.tolist() == want_range
    for i in range(n_inst):
        rows = acc.wboxes[acc.einst == i]
        np.testing.assert_array_equal(acc.ibox[i, :3].numpy(),
                                      rows[:, :3].amin(0).numpy())
        np.testing.assert_array_equal(acc.ibox[i, 3:6].numpy(),
                                      rows[:, 3:6].amax(0).numpy())


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kind", ["instanced", "flat"])
def test_twin_matches_pallas_interpret(builds, kind, any_hit):
    _, jacc, acc = builds[kind]
    o, d, tmax = _rays()
    mode = "any_hit" if any_hit else "closest"
    want = reference_answers(f"k3/{kind}-{mode}",
                             pallas_inputs_digest(jacc, o, d, tmax))
    got = sweep_intersect_ref(acc, torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(tmax), any_hit=any_hit)
    assert set(got) == set(want) == {"t", "prim", "inst"}
    jp = np.asarray(want["prim"])
    hits = jp >= 0
    assert 0.2 < hits.mean() < 0.9  # hits and misses both exercised
    assert not np.any(hits[tmax <= 0])  # dead lanes never hit
    # Occlusion is the any-hit contract (accel/api.py reads prim >= 0).
    np.testing.assert_array_equal(got["prim"].numpy() >= 0, hits)
    if any_hit:
        return
    same = got["prim"].numpy() == jp
    print(f"{kind}: {int(np.sum(~same))} of {len(jp)} rays disagree on prim")
    assert int(np.sum(~same)) == PRIM_DIFFERENCES
    np.testing.assert_array_equal(got["inst"].numpy(), np.asarray(want["inst"]))
    if kind == "instanced":
        assert set(np.unique(got["inst"].numpy())) == {-1, 0, 1, 2, 3, 4}
    # t rounds once per op here; XLA's CPU backend may fuse multiply-adds,
    # in Moller-Trumbore (K2's 2e-6 relative residue) and in the
    # world-to-object transform of the origin, where one ulp of an object
    # coordinate (|x| <= 2.5: 2.4e-7) moves t by as much absolutely: it
    # dominates for origins a few hundredths from the surface.
    np.testing.assert_allclose(got["t"].numpy()[hits], np.asarray(want["t"])[hits],
                               rtol=2e-6, atol=3e-7)


def test_resolve_tri_attrs_inst_matches(builds):
    tris, jacc, acc = builds["instanced"]
    r = np.random.default_rng(4)
    n = 2048
    prim = r.integers(-1, len(tris), n).astype(np.int32)
    inst = np.where(prim < 2, 0, r.integers(1, 5, n)).astype(np.int32)
    inst[prim < 0] = -1
    # Rays aimed at a random point of the instanced (world) triangle from
    # its normal side, well away from grazing (where u = (tvec . p) / det
    # is ill-conditioned: one ulp of a world vertex moves u by ulp / det).
    m = acc.o2w.numpy()[np.maximum(inst, 0)].reshape(-1, 3, 4)
    tv = tris[np.maximum(prim, 0)]
    tvw = np.einsum("nij,nkj->nki", m[:, :, :3], tv) + m[:, None, :, 3]
    target = np.einsum("nk,nkj->nj", r.dirichlet((1.0, 1.0, 1.0), n), tvw)
    nrm = np.cross(tvw[:, 1] - tvw[:, 0], tvw[:, 2] - tvw[:, 0])
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    o = (target + nrm * r.uniform(0.3, 1.5, (n, 1))
         + 0.2 * r.normal(size=(n, 3))).astype(np.float32)
    d = ((target - o) / np.linalg.norm(target - o, axis=-1, keepdims=True)
         ).astype(np.float32)
    mat = r.integers(0, 3, len(tris)).astype(np.int32)
    light = np.where(np.arange(len(tris)) < 2, 0, -1).astype(np.int32)
    jgeom = JGeometryBuffers.build(tri_verts=tris, tri_mat=mat, tri_light=light)
    geom = GeometryBuffers.build(tri_verts=tris, tri_mat=mat, tri_light=light)
    want = jax_resolve_inst(jgeom, jacc, jnp.asarray(o), jnp.asarray(d),
                            jnp.asarray(prim), jnp.asarray(inst))
    got = resolve_tri_attrs_inst(geom, acc, torch.from_numpy(o),
                                 torch.from_numpy(d), torch.from_numpy(prim),
                                 torch.from_numpy(inst))
    # The world vertices are o2w sums whose order and fused multiply-adds
    # differ between torch.einsum and XLA: u, v (cancelling sums, as for
    # K2) are held to atol 3e-5; the unit normal of triangles ~0.01 across
    # to 5e-6 (one ulp of a vertex is ~1e-5 of an edge).
    for g, w, name in zip(got, want, ("u", "v", "ng", "mat", "light")):
        if name in ("mat", "light"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=5e-6 if name == "ng" else 3e-5,
                                       err_msg=name)
    # The non-uniformly scaled instance shades with its world-space normal.
    sel = (inst == 2) & (prim >= 2)
    assert not np.allclose(got[2].numpy()[sel], np.cross(
        tv[sel, 1] - tv[sel, 0], tv[sel, 2] - tv[sel, 0]), atol=1e-3)


def test_cpu_tensors_take_the_twin_and_count_no_launch(builds):
    _, _, acc = builds["instanced"]
    o, d, tmax = (torch.from_numpy(x) for x in _rays())
    STATS.reset()
    for any_hit in (False, True):
        got = sweep_intersect(acc, o, d, tmax, any_hit=any_hit)
        want = sweep_intersect_ref(acc, o, d, tmax, any_hit=any_hit)
        for k in want:
            assert torch.equal(got[k], want[k]), (any_hit, k)
    assert STATS.launches == 0
    out = sweep_intersect(acc, o.clone().requires_grad_(), d, tmax)
    assert not any(v.requires_grad for v in out.values())


def test_twin_counts_its_work(builds):
    """The (ray, cluster) pairs and (ray, instance) entries the twin counts
    are the kernel's work for its bound: culling leaves a small share. Its
    visits nest: a 128-ray block holds four warps, a warp visit at least
    one pair, and the lone (triangle-parallel) visits are warp visits."""
    _, _, acc = builds["instanced"]
    o, d, tmax = (torch.from_numpy(x) for x in _rays())
    counts = {}
    sweep_intersect_ref(acc, o, d, tmax, counts=counts)
    live = int((tmax > 0).sum())
    pairs = counts["pairs"]
    assert 0 < counts["instances"] < live * acc.n_instances
    assert 0 < pairs < 0.5 * live * acc.n_entries
    assert pairs / 128 <= counts["block_visits"] <= counts["warp_visits"] <= pairs
    assert 0 < counts["lone_visits"] <= counts["warp_visits"]


@pytest.mark.parametrize("kind", ["instanced", "flat"])
def test_group_boxes_cover_their_clusters(builds, kind):
    """The kernel's group gate reads gbox at each 32-cluster group's first
    row of a prototype's range: the tight union of the group's cluster
    boxes. A box that holds another passes every ray the other passes (the
    slab test's rounding is monotone), so the gate changes no result."""
    _, _, acc = builds[kind]
    src = (nvcc_build.CSRC_DIR / "sweep.cu").read_text()
    assert re.findall(r"constexpr int kGroup = (\d+);", src) == [str(_GROUP)]
    read = set()
    for first, count in acc.irange.tolist():
        for g in range(first, first + count, _GROUP):
            rows = acc.boxes[g:min(g + _GROUP, first + count)]
            assert torch.equal(acc.gbox[g, :3], rows[:, :3].amin(0))
            assert torch.equal(acc.gbox[g, 3:6], rows[:, 3:6].amax(0))
            read.add(g)
    assert read and not bool(acc.gbox[[g for g in range(acc.n_clusters)
                                       if g not in read]].any())


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kind", ["instanced", "flat"])
def test_permuted_rays_permute_the_answers(builds, kind, any_hit):
    """Each ray's answer depends on that ray alone: the twin on permuted
    rays gives the permuted answers, pairs and instance entries, so the
    kernel's grouping of rays into warps cannot change a result."""
    _, _, acc = builds[kind]
    o, d, tmax = (torch.from_numpy(x) for x in _rays())
    perm = torch.from_numpy(np.random.default_rng(3).permutation(len(o)))
    counts, counts_p = {}, {}
    want = sweep_intersect_ref(acc, o, d, tmax, any_hit=any_hit,
                               counts=counts)
    got = sweep_intersect_ref(acc, o[perm], d[perm], tmax[perm],
                              any_hit=any_hit, counts=counts_p)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k][perm]), k
    for k in ("pairs", "instances"):
        assert counts_p[k] == counts[k], k
