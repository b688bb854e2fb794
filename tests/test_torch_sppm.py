"""The port's SPPM (pbrt_tpu_torch/models/sppm.py) against the reference
on the CPU.

- The sorted hash table: tests/test_sppm.py's brute-force gate on the port
  (every (photon, visible point) pair within the radius is found through
  the table's entry ranges), and the table equal to the reference's, entry
  for entry (the stable sort keeps pixels in the reference's order inside
  a cell, which decides which K candidates a photon scans).
- tests/goldens/sppm.pbrt (a glass sphere's caustic; radius 0.08) at
  16x16, 4,096 photons an iteration, against the reference (committed by
  scripts/make_torch_port_golden_lighttransport.py): iteration 0's visible
  points (set mask equal, points and throughput within rtol 1e-5), its
  direct light Ld within rtol 1e-3 / atol 1e-5 on >= 99% of values, its
  photon deposits M equal and flux Phi within rtol 1e-4; after 4
  iterations the radii and n within rtol 1e-5 and the image on >= 99% of
  its values within rtol 1e-3 / atol 1e-5.
- tests/test_sppm.py's gate on the port: SPPM converges toward the
  port's path trace of the Cornell box (the mean within 15%, the images'
  correlation above 0.85, the radii contracted), up to the blur of a
  finite radius.
- A gradient request through SPPM raises (item 5).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.models.sppm import SPPMIntegrator as JSPPMIntegrator
from pbrt_tpu.models.sppm import _cell_hash as jax_cell_hash
from pbrt_tpu_torch.core import spectrum
from pbrt_tpu_torch.io.parser import load_pbrt
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.models.sppm import SPPMIntegrator, _cell_hash
from pbrt_tpu_torch.render import render
from pbrt_tpu_torch.scenes.cornell import cornell_box

from .torch_port_helpers import share_close

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "torch_port")
CAUSTIC = os.path.join(ROOT, "tests", "goldens", "sppm.pbrt")


def _points():
    """tests/test_sppm.py's visible points and photons."""
    rng = np.random.default_rng(7)
    nvp, nph = 64, 128
    vp_p = rng.uniform(0, 4, (nvp, 3)).astype(np.float32)
    radius = rng.uniform(0.1, 0.4, (nvp,)).astype(np.float32)
    vp_set = rng.random(nvp) < 0.9
    ph_p = rng.uniform(0, 4, (nph, 3)).astype(np.float32)
    return vp_p, radius, vp_set, ph_p


def test_grid_range_query_matches_brute_force():
    vp_p, radius, vp_set, ph_p = _points()
    hash_size = 256
    grid = SPPMIntegrator()._build_grid(torch.from_numpy(vp_p),
                                        torch.from_numpy(radius),
                                        torch.from_numpy(vp_set), hash_size)
    c = torch.floor((torch.from_numpy(ph_p) - grid["lo"][None])
                    / grid["cell"]).to(torch.int64)
    h = _cell_hash(c[:, 0], c[:, 1], c[:, 2], hash_size)
    start = torch.searchsorted(grid["hash"], h, side="left")
    end = torch.searchsorted(grid["hash"], h, side="right")
    found = np.zeros((len(ph_p), len(vp_p)), bool)
    for j in range(len(ph_p)):
        for k in range(int(start[j]), int(end[j])):
            vp = int(grid["pix"][k])
            if (np.sum((vp_p[vp] - ph_p[j]) ** 2) <= radius[vp] ** 2
                    and vp_set[vp]):
                found[j, vp] = True
    d2 = np.sum((ph_p[:, None] - vp_p[None]) ** 2, -1)
    want = (d2 <= radius[None] ** 2) & vp_set[None]
    assert want.sum() > 0
    assert (found == want).all(), (found.sum(), want.sum())


def test_grid_table_matches_reference():
    vp_p, radius, vp_set, _ = _points()
    want = JSPPMIntegrator()._build_grid(jnp.asarray(vp_p),
                                         jnp.asarray(radius),
                                         jnp.asarray(vp_set), 256)
    got = SPPMIntegrator()._build_grid(torch.from_numpy(vp_p),
                                       torch.from_numpy(radius),
                                       torch.from_numpy(vp_set), 256)
    for key in ("hash", "pix", "lo", "cell"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    # Cells holding several entries: the order inside them is the stable
    # sort's.
    assert len(np.unique(got["hash"].numpy())) < len(got["hash"])
    ix = np.asarray([3, -2, 7, 2**20], np.int64)
    np.testing.assert_array_equal(
        _cell_hash(torch.from_numpy(ix), torch.from_numpy(ix[::-1].copy()),
                   torch.from_numpy(ix), 1 << 12).numpy(),
        np.asarray(jax_cell_hash(jnp.asarray(ix, jnp.int32),
                                 jnp.asarray(ix[::-1], jnp.int32),
                                 jnp.asarray(ix, jnp.int32), 1 << 12)))


def _caustic(z):
    res = int(z["cfg_resolution"])
    scene, camera, settings = load_pbrt(CAUSTIC, device="cpu")
    integ = settings["integrator"]
    assert isinstance(integ, SPPMIntegrator) and integ.initial_radius == 0.08
    return (scene, camera.replace(resolution=(res, res)),
            integ.replace(photons_per_iteration=int(z["photons"])))


def test_first_iteration_matches_reference():
    z = np.load(os.path.join(DATA, "sppm16.npz"))
    scene, camera, integ = _caustic(z)
    seed = int(z["cfg_seed"])
    state = integ.start(scene, camera)
    npix = state["radius"].shape[0]
    wl = spectrum.sample_visible(torch.full((npix,), 0.5),
                                 int(z["cfg_n_spectrum"]))
    cam = integ._camera_pass(scene, camera, wl, 0, seed)
    np.testing.assert_array_equal(cam["vp_set"].numpy(), z["vp_set"])
    assert 0.3 < z["vp_set"].mean() < 1.0
    np.testing.assert_allclose(cam["vp_p"].numpy(), z["vp_p"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(cam["vp_beta"].numpy(), z["vp_beta"],
                               rtol=1e-5, atol=1e-7)
    share, n_bad = share_close(cam["Ld"].numpy(), z["Ld"], 1e-3, 1e-5)
    assert share >= 0.99, n_bad
    grid = integ._build_grid(cam["vp_p"], state["radius"], cam["vp_set"],
                             state["hash_size"])
    phi, m, overflow = integ._photon_pass(scene, wl, grid, cam,
                                          state["radius"], 0, seed + 1,
                                          state["hash_size"])
    np.testing.assert_array_equal(m.numpy(), z["m"])
    assert int(overflow) == int(z["overflow"])
    assert z["m"].sum() > 10
    np.testing.assert_allclose(phi.numpy(), z["phi"], rtol=1e-4, atol=1e-7)


def test_four_iterations_match_reference():
    z = np.load(os.path.join(DATA, "sppm16.npz"))
    scene, camera, integ = _caustic(z)
    img, stats = integ.render(scene, camera, n_iterations=int(z["iterations"]),
                              seed=int(z["cfg_seed"]), return_stats=True,
                              n_spectrum=int(z["cfg_n_spectrum"]),
                              device="cpu")
    np.testing.assert_allclose(stats["radius"].numpy(), z["radius4"],
                               rtol=1e-5)
    np.testing.assert_allclose(stats["n"].numpy(), z["n4"], rtol=1e-5)
    assert (z["radius4"] < 0.08).any()  # the radii contracted
    share, n_bad = share_close(img.numpy(), z["image4"], 1e-3, 1e-5)
    assert share >= 0.99, n_bad
    assert z["image4"].mean() > 0.01


def test_sppm_converges_to_path_cornell():
    scene, camera = cornell_box(resolution=(16, 16))
    scene = scene.with_accel()
    img_p = render(scene, camera, PathIntegrator(max_depth=4), spp=64,
                   samples_per_pass=32, seed=1, n_spectrum=8,
                   device="cpu").numpy()
    integ = SPPMIntegrator(max_depth=4, photons_per_iteration=4096)
    img_s, stats = integ.render(scene, camera, n_iterations=12, seed=2,
                                return_stats=True, n_spectrum=8,
                                device="cpu")
    img_s = img_s.numpy()
    assert np.isfinite(img_s).all()
    mp, ms = img_p.mean(), img_s.mean()
    assert abs(mp - ms) < 0.15 * mp, (mp, ms)
    corr = np.corrcoef(img_p.mean(-1).ravel(), img_s.mean(-1).ravel())[0, 1]
    assert corr > 0.85, corr
    tv = scene.geom.tri_verts.reshape(-1, 3).numpy()
    r0 = 2.0 * float(np.linalg.norm(tv.max(0) - tv.min(0))) / 16
    assert float(stats["radius"].mean()) < r0


def test_sppm_refuses_gradient():
    scene, camera, integ = _caustic({"cfg_resolution": 8, "photons": 64})
    scene.lights.area_scale.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        integ.render(scene, camera, n_iterations=1, n_spectrum=4,
                     device="cpu")
