"""K4's packed rows and its walk on the CPU: the rows BVH derives
(`BVH.nodes`, `BVH.tris`) unpack bit for bit to the reference tables, for
build_bvh and for the convert.py path, and a plain model of the kernel's
walk (tests/torch_port_bvh_walk.py: push-time culling with a stored tmin)
is bit-equal to the twin
`bvh_intersect_ref` in both modes, in all four outputs, on trees of depth
0, 1, even and odd, on exact t ties across leaves, on rays lying in box
faces and on dead lanes. The kernel itself is held to the twin on a card
by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from pbrt_tpu.accel.bvh import build_bvh as jax_build_bvh
from pbrt_tpu_torch.accel.bvh import build_bvh, bvh_intersect_ref
from pbrt_tpu_torch.convert import scene_from_arrays
from pbrt_tpu_torch.ops import traverse
from pbrt_tpu_torch.scenes.meshes import fbm_blob

from .test_torch_cluster import _rays
from .torch_port_bvh_walk import (CASES, DEPTHS, stack_entries, unpack,
                                  walk, walk_case)
from .torch_port_helpers import flatten_jax
from .torch_port_killeroo import small_killeroo_class_scene

torch.set_num_threads(2)
_CASES = ("rays",) + CASES
_KEYS = ("node_lo", "node_hi", "v0", "e1", "e2", "prim_id")


def _assert_rows_unpack(bvh):
    rows = unpack(bvh)
    assert bvh.nodes.shape == (bvh.node_lo.shape[0], 8)
    assert bvh.tris.shape == (bvh.prim_id.shape[0], 12)
    for key in _KEYS:
        assert torch.equal(rows[key], getattr(bvh, key)), key
    assert not torch.any(bvh.nodes[:, 3]) and not torch.any(bvh.nodes[:, 7])
    assert not torch.any(bvh.tris[:, 10:])
    # Padding slots carry prim id -1 through the float column bit for bit.
    assert int((rows["prim_id"] < 0).sum()) > 0


def test_packed_rows_unpack_from_build_bvh():
    b = build_bvh(fbm_blob(3))
    _assert_rows_unpack(b)
    moved = b.to("cpu")
    assert moved is b  # a move that moves nothing repacks nothing


def test_packed_rows_unpack_through_convert():
    tris = fbm_blob(3)
    js, _ = small_killeroo_class_scene("pbrt_tpu", (8, 8))
    js = js.replace(clusters=None, bvh=jax_build_bvh(tris))
    conv = scene_from_arrays(*flatten_jax(js)).bvh
    _assert_rows_unpack(conv)
    b = build_bvh(tris)
    # Bits, not values: a padding slot's prim id -1 reads as a NaN float.
    for key in ("nodes", "tris"):
        assert torch.equal(getattr(conv, key).view(torch.int32),
                           getattr(b, key).view(torch.int32)), key


@pytest.mark.parametrize("key", _KEYS)
def test_packed_rows_follow_replace(key):
    """The rows are derived, never passed: replacing a reference table
    repacks them, so K4 and the twin always read the same tree."""
    b = build_bvh(fbm_blob(3))
    old = getattr(b, key)
    new = (old.flip(0) if key == "prim_id"
           else old + torch.tensor(0.5, dtype=old.dtype))
    r = b.replace(**{key: new})
    _assert_rows_unpack(r)
    assert torch.equal(unpack(r)[key], new)
    assert not torch.equal(unpack(r)[key], old)
    with pytest.raises(ValueError, match="init=False"):
        b.replace(nodes=b.nodes)


def _with_rows(b, **rows):
    """A copy of `b` whose packed rows are forced to `rows` (a corrupt
    BVH, for the wrapper's checks)."""
    bad = b.replace()
    for name, value in rows.items():
        object.__setattr__(bad, name, value)
    return bad


def test_wrapper_refuses_rows_it_cannot_read():
    """The kernel reads the rows as float4: a table of the wrong shape or
    off 16-B alignment raises before any launch."""
    b = build_bvh(fbm_blob(3))
    o, d, tmax = (torch.from_numpy(x) for x in _rays())
    shifted = torch.empty(b.nodes.numel() + 1)[1:].view(b.nodes.shape)
    for bad, match in ((_with_rows(b, nodes=shifted), "aligned"),
                       (_with_rows(b, tris=b.tris[:-4]), "tris must be")):
        with pytest.raises(ValueError, match=match):
            traverse._launch(bad, o, d, tmax, any_hit=False)


@pytest.fixture(scope="module")
def cases():
    out = {}
    for name in _CASES:
        tris, rays = ((fbm_blob(3), _rays()) if name == "rays"
                      else walk_case(name))
        out[name] = (build_bvh(tris),
                     tuple(torch.tensor(np.asarray(x), dtype=torch.float32)
                           for x in rays))
    return out


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("name", _CASES)
def test_walk_model_matches_twin(cases, name, any_hit):
    bvh, (o, d, tmax) = cases[name]
    if name in DEPTHS:
        assert bvh.depth == DEPTHS[name]
    stats = {}
    got = walk(bvh, o, d, tmax, any_hit=any_hit, stats=stats)
    counts = {}
    want = bvh_intersect_ref(bvh, o, d, tmax, any_hit=any_hit, counts=counts)
    for key, g, w in zip(("t", "prim", "u", "v"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), key
    hits = int((want[1] >= 0).sum())
    if name == "dead_lanes":
        assert hits == 0 and stats["steps"] > 0  # walked, never hit
    else:
        assert 0 < hits < o.shape[0]
    if name == "coplanar_ties":
        # Some copies of one triangle lie in different leaves.
        real = bvh.prim_id >= 0
        leaf_of = torch.empty(int(real.sum()), dtype=torch.int64)
        leaf_of[bvh.prim_id[real].long()] = (torch.nonzero(real)[:, 0]
                                             // bvh.leaf_size)
        split = leaf_of[0::3] != leaf_of[2::3]
        assert 0 < int(split.sum()) < split.shape[0]
    assert stats["max_stack"] <= stack_entries(bvh.depth)
    # Every pop the walk makes is one the twin makes too, and its steps
    # are the twin's inner visits (entries / 2).
    assert stats["pops"] <= counts["nodes"]
    assert stats["steps"] == counts["entries"] // 2
