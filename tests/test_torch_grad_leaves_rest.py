"""The rest of ROADMAP item 5e against the JAX reference's gradients
(tests/torch_port_leaves.py CASES, groups "volpath" and "sampling";
goldens of scripts/make_torch_port_golden_leaves.py, the bench loss, 2
spp, depth 5):
- 5e.5: the surface and light leaves through the differentiable
  volumetric path, on the fog box's slab and on the families box inside
  a homogeneous medium (every family's leaves and the medium's spectra);
- 5e.7: the interior media's spectra, scales and g (fog.pbrt's sphere);
- 5e.8: the density grid's majorants, the image light's importance
  tables (envmap.pbrt) and the light selection's pmf and cdf
  (leaf_lights.pbrt), under remat and cvjp;
- 5e.6: the light BVH's node table (the hall cut to 16 lights).

Every leaf with a golden trains: within 1e-3 of the golden's largest
entry, the loss within a relative 1e-4, every entry finite, and every
golden nonzero but where zero by construction, where the port's
gradient is exactly zero too. A leaf whose golden the reference could
not give (NaN in both modes) is refused with its reason."""

import numpy as np
import pytest
import torch

from pbrt_tpu_torch.models.path import TRAINABLE
from pbrt_tpu_torch.models.volpath import VOLPATH_TRAINABLE
from pbrt_tpu_torch.scenes.manylight import manylight_scene

from . import torch_port_leaves as TL
from .torch_port_grad import GRAD_RTOL_OF_MAX, LOSS_RTOL, pass_loss_and_grads

torch.set_num_threads(1)

GROUPS = ("volpath", "sampling")


def _answered(group, name, est, leaves):
    return TL.answered(TL.golden(group), f"{name}_{est}", leaves)


# The cases with a golden (the hall's remat has none: NaN in both modes).
_HELD = [(g, s, e) for g, s, e, lv in TL.cases(GROUPS)
         if _answered(g, s, e, lv)]


def _trainable(est):
    return VOLPATH_TRAINABLE if est == "volpath" else TRAINABLE[est]


@pytest.mark.parametrize("group, name, est", _HELD)
def test_leaf_gradients_match_golden(group, name, est):
    want_loss, want, loss, grads = TL.port_run(group, name, est)
    assert set(want) <= set(_trainable(est))
    errs = TL.leaf_errors(want, grads)
    print(name, est, loss, want_loss, errs)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert errs.pop("finite")
    assert all(e <= GRAD_RTOL_OF_MAX for e in errs.values()), errs
    for p, (_, w) in want.items():
        if TL.zero_rows(name, est, p) is False:
            assert np.any(w != 0.0), (p, "golden is zero")


@pytest.mark.parametrize("group, name, est, leaf", [
    (g, s, e, p) for g, s, e, lv in TL.cases(GROUPS) for p in lv
    if TL.zero_rows(s, e, p) is not False and (g, s, e) in _HELD])
def test_zero_by_construction(group, name, est, leaf):
    """Exactly zero in both packages: the mix amount (a step), the mean
    free path through the volumetric path (no subsurface step there), the
    grid's max_density (read only through the detached majorants), the
    image light's cdfs, row integrals, marginal func and luminance and
    the selection cdf under remat (sampling decisions and detached
    pdfs), and every sampling table under cvjp, whose replay reads the
    recorded MIS pdfs: the light BVH's index columns among them."""
    _, want, _, grads = TL.port_run(group, name, est)
    assert np.all(want[leaf][1] == 0.0)
    assert np.all(grads[leaf] == 0.0)


def _refused():
    """(group, scene, estimator, leaf) of every leaf a case asked for that
    has no golden."""
    return [(g, s, e, p) for g, s, e, lv in TL.cases(GROUPS) for p in lv
            if p not in _answered(g, s, e, lv)]


def test_leaves_without_a_golden_are_refused():
    """The density grid's coarse majorants (the reference's gradient is
    NaN in both modes) and the light BVH's node table under remat (NaN in
    both modes through the BVH's pmf) have no golden, and every other leaf
    of a case has one: each is refused with its reason, and so is a
    sampling table under the attached estimator, which has no golden."""
    refused = _refused()
    assert {(s, e, p) for _, s, e, p in refused} == {
        ("majorants", "volpath", "medium.maj_grid"),
        ("lightbvh", "remat", "lights.bvh.nodes")}
    for _, s, e, p in refused:
        assert p not in _trainable(e), (s, e, p)
    scene, camera = TL.port_scene("majorants")
    with pytest.raises(NotImplementedError,
                       match="maj_grid.*majorants is NaN.*Queue 3"):
        pass_loss_and_grads(scene, camera, TL.integrator(
            "pbrt_tpu_torch", "volpath"), ("medium.maj_grid",), 4, 1)
    scene, camera = manylight_scene(resolution=(2, 2), n_lights=4,
                                    sampler="bvh")
    with pytest.raises(NotImplementedError,
                       match="remat.*light BVH's pmf.*NaN in both modes"):
        pass_loss_and_grads(scene, camera, TL.integrator(
            "pbrt_tpu_torch", "remat"), ("lights.bvh.nodes",), 2, 1)
    scene, camera = TL.port_scene("envdist")
    with pytest.raises(NotImplementedError,
                       match="marginal.func.*attached.*no golden"):
        pass_loss_and_grads(scene, camera, TL.integrator(
            "pbrt_tpu_torch", "attached"),
            ("lights.env.dist.marginal.func",), 2, 1)
