"""The port's renders of the io scenes (tests/data/torch_port/io: EXR,
PNG and QOI imagemaps, an EXR environment map, Ptex textures and a
NanoVDB medium) against the reference on the CPU.

Per sample against the reference's jitted trace (committed goldens of
scripts/make_torch_port_golden_io.py, 16x16, 2 spp, 8 lanes, seed 0):
io_surfaces.pbrt (the path tracer) and io_smoke.pbrt (the volumetric
path, the medium entry inset in both packages, tests/torch_port_media.py)
on K1's twin. Gate: >= 99% of sample values within rtol 1e-3 / atol 1e-5
(both read 100%), the mean within rtol 1e-3, and the ray count within
RAYS_SLACK of the reference's.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from pbrt_tpu_torch.io.parser import load_pbrt
from pbrt_tpu_torch.media.medium import MediumBuffers
from pbrt_tpu_torch.render import camera_rays_full

from . import torch_port_io as io
from .torch_port_helpers import share_close
from .torch_port_media import inset_entry

torch.set_num_threads(2)
DATA = os.path.join(io.ROOT, "tests", "data", "torch_port")
# io_surfaces' pass sends one shadow ray fewer than the reference's jitted
# pass (2,244 against 2,245) while every sample value agrees: one lane's
# light sample lands where its contribution rounds to zero in one
# pipeline only (ROADMAP Queue 3).
RAYS_SLACK = 1


@pytest.mark.parametrize("name", io.SCENES)
def test_io_scene_per_sample_matches_reference(name):
    z = np.load(os.path.join(DATA, f"{name}16_samples.npz"))
    res, spp, lanes = int(z["resolution"]), int(z["spp"]), int(z["n_spectrum"])
    scene, camera, settings = load_pbrt(os.path.join(io.IO_DIR, name + ".pbrt"),
                                        device="cpu")
    assert scene.small is not None and scene.textures.has_ptex
    integ = settings["integrator"]
    assert integ.max_depth == int(z["max_depth"])
    npix = res * res
    pixel = torch.arange(npix).repeat(spp)
    sample = torch.arange(spp).repeat_interleave(npix)
    o, d, wl, _ = camera_rays_full(camera.replace(resolution=(res, res)),
                                   pixel, sample, int(z["seed"]),
                                   n_spectrum=lanes)
    inset = (inset_entry(MediumBuffers) if io.INSET[name]
             else contextlib.nullcontext())
    with inset:
        L, stats = integ.trace_with_stats(scene, o, d, wl, pixel, sample,
                                          int(z["seed"]))
    pL, jL = L.numpy(), z["radiance"]
    assert pL.shape == jL.shape and np.isfinite(pL).all()
    share, n_bad = share_close(pL, jL, rtol=1e-3, atol=1e-5)
    print(f"{name}: {n_bad} of {jL.size} sample values disagree; rays "
          f"{float(stats['rays'])} / {float(z['rays'])}")
    assert share >= 0.99
    assert abs(pL.mean() - jL.mean()) <= 1e-3 * jL.mean() and jL.mean() > 0.1
    assert abs(float(stats["rays"]) - float(z["rays"])) <= RAYS_SLACK
