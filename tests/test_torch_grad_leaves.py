"""The scene-leaf gradients of ROADMAP item 5e.1-5e.4 against the JAX
reference's: the material leaves (the conductors' spectra, roughness, the
coat, diffuse transmission, hair, subsurface, measured and mix leaves),
the texture tables, every light kind's emission tables and the media's
spectra and grids (tests/torch_port_leaves.py CASES; goldens of
scripts/make_torch_port_golden_leaves.py, 16x16 or 8x8 for the media, 2
spp, depth 5, the bench loss).

Each case is one scene under one estimator. Every leaf with a golden
trains: its gradient within 1e-3 of the golden's largest entry, or, for
a table whose reference reverse mode is NaN, its dot products with the
golden's probe directions within 1e-3 of the largest; the loss within a
relative 1e-4; every entry finite. cvjp's gradients equal remat's on the
CPU. The leaves that are zero by construction are exactly zero in both
packages, and a leaf whose golden the reference could not give (NaN in
both modes, or cvjp's NaN reverse mode) is refused with its reason."""

import numpy as np
import pytest
import torch

from pbrt_tpu_torch.models.path import TRAINABLE
from pbrt_tpu_torch.models.volpath import VOLPATH_TRAINABLE

from . import torch_port_leaves as TL
from .torch_port_grad import GRAD_RTOL_OF_MAX, LOSS_RTOL, pass_loss_and_grads

torch.set_num_threads(1)

# Item 5e.1-5e.4's groups (5e.5-5e.8's: test_torch_grad_leaves_rest.py).
GROUPS = ("materials", "textures", "lights", "media")
_golden, _run = TL.golden, TL.port_run


@pytest.mark.parametrize("group, name, est", [
    (g, s, e) for g, s, e, _ in TL.cases(GROUPS)])
def test_leaf_gradients_match_golden(group, name, est):
    want_loss, want, loss, grads = _run(group, name, est)
    assert want, (name, est)
    trainable = VOLPATH_TRAINABLE if est == "volpath" else TRAINABLE[est]
    assert set(want) <= set(trainable)
    errs = TL.leaf_errors(want, grads)
    print(name, est, loss, want_loss, errs)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert errs.pop("finite")
    assert all(e <= GRAD_RTOL_OF_MAX for e in errs.values()), errs
    # Every golden has a nonzero entry, but where zero by construction.
    for p, (_, w) in want.items():
        if (name, p) not in TL.ZERO_BY_CONSTRUCTION:
            assert np.any(w != 0.0), (p, "golden is zero")


@pytest.mark.parametrize("group, name", [
    (g, s) for g, s, ests, _ in TL.CASES
    if "cvjp" in ests and g in GROUPS])
def test_cvjp_equals_remat(group, name):
    """cvjp replays the shading from recorded hits: on the CPU its
    gradients equal remat's within 1e-5 of the largest entry."""
    _, want, _, remat = _run(group, name, "remat")
    _, _, _, cvjp = _run(group, name, "cvjp")
    assert set(cvjp) <= set(remat)
    for p, g in cvjp.items():
        scale = float(np.max(np.abs(remat[p])))
        assert np.max(np.abs(g - remat[p])) <= 1e-5 * scale, p


@pytest.mark.parametrize("name, leaf", [
    k for k in sorted(TL.ZERO_BY_CONSTRUCTION)
    if TL.group_of(k[0]) in GROUPS])
def test_zero_by_construction(name, leaf):
    """The mix amount picks a sub-material by a step (u < amount) and the
    bilerp, constant and checkerboard rows read no f0: their gradients
    are exactly zero in both packages."""
    rows = TL.ZERO_BY_CONSTRUCTION[name, leaf]
    group, est = next((g, e) for g, s, e, _ in TL.cases(GROUPS)
                      if s == name)
    _, want, _, grads = _run(group, name, est)
    sel = slice(None) if rows is None else list(rows)
    assert np.all(want[leaf][1][sel] == 0.0)
    assert np.all(grads[leaf][sel] == 0.0)
    if rows is not None:
        assert np.any(grads[leaf] != 0.0)


def _refused():
    """(group, scene, estimator, leaf) of every leaf a case asked for that
    has no golden."""
    out = []
    for g, s, e, leaves in TL.cases(GROUPS):
        z = _golden(g)
        have = TL.answered(z, f"{s}_{e}", leaves)
        out += [(g, s, e, p) for p in leaves if p not in have]
    return out


def test_leaves_without_a_golden_are_refused():
    """Conductor roughness under cvjp (its reverse mode is NaN in the
    reference, and a custom VJP has no forward mode) and the media's g
    (NaN in both modes) have no golden: each is refused with its reason,
    and every other leaf of a case has one."""
    refused = _refused()
    assert {(s, e, p) for _, s, e, p in refused} >= {
        ("spot", "cvjp", "materials.roughness"),
        ("fog", "volpath", "medium.g")}
    for g, s, e, p in refused:
        trainable = VOLPATH_TRAINABLE if e == "volpath" else TRAINABLE[e]
        assert p not in trainable, (s, e, p)
    scene, camera = TL.leaf_scene("pbrt_tpu_torch", "fog", 4)
    integ = TL.integrator("pbrt_tpu_torch", "volpath")
    with pytest.raises(NotImplementedError, match="g is NaN.*Queue 3"):
        pass_loss_and_grads(scene, camera, integ, ("medium.g",), 4, 1)
    # The selection pmf trains under remat and cvjp
    # (tests/test_torch_grad_leaves_rest.py); under the attached
    # estimator, which has no golden of it, a request is refused.
    scene, camera = TL.leaf_scene("pbrt_tpu_torch", "spot", 4)
    with pytest.raises(NotImplementedError, match="select_pmf.*no golden"):
        pass_loss_and_grads(scene, camera, TL.integrator(
            "pbrt_tpu_torch", "attached"), ("lights.select_pmf",), 4, 1)
