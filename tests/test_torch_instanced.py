"""The port's instanced scene-file slice against the JAX reference on the
CPU: tests/data/torch_port/instanced_field.pbrt (36 instances of two PLY
prototypes, every third non-uniformly scaled) through each package's
parser; on the port's side the sweep accelerator (K3's twin), instanced
shading normals, the conductor and the infinite light. The reference
answers its queries with its dense tester over the same instances
flattened into world space (its CPU path without an accelerator):
jit-compiling its path integrator around the Pallas sweep kernel in
interpret mode took most of this file's time, and the twin and
resolve_tri_attrs_inst are held against that kernel and the reference's
instanced resolution in tests/test_torch_sweep.py. The reference's pass
is committed (tests/data/torch_port/reference_answers.npz,
scripts/make_torch_port_golden_answers.py); the fixture checks a digest
of its flattened scene, camera and integrator, built live here. Then a
window of the
committed JAX golden of the full-size field (rendered by the reference
through its sweep kernel), rendered by the port.

The whole 64x64 golden is compared on the card (chip_smoke.py phase d3).
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from pbrt_tpu.core.spectrum import N_SPECTRUM
from pbrt_tpu.io.parser import load_pbrt_string as jax_load_pbrt_string
from pbrt_tpu.shapes.geometry import GeometryBuffers as JGeometryBuffers
from pbrt_tpu_torch.films.rgb import spectrum_to_rgb
from pbrt_tpu_torch.io.parser import load_pbrt_string
from pbrt_tpu_torch.ops import sweep
from pbrt_tpu_torch.render import camera_rays_full, render

from .torch_port_helpers import reference_trace, share_close
from .torch_port_instanced import (
    FULL,
    SMALL,
    field_text,
    write_field_meshes,
)

torch.set_num_threads(2)
RES, SPP = 12, 2
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_port", "instanced64_spp4.npy")
# The golden's settings (scripts/make_torch_port_golden_instanced.py) and
# the window of it rendered here: 16 x 8 pixels about the image centre.
GOLDEN_RES, GOLDEN_SPP, GOLDEN_LANES = 64, 4, 8
WINDOW = (24, 28, 16, 8)  # x0, y0, width, height


def _flattened(js):
    """The reference scene with every sweep instance's prototype triangles
    moved into world space by its object-to-world row, and no
    accelerator."""
    sw = js.sweep
    pid = np.asarray(sw.pid).astype(np.int64) - 1  # (C, 128), -1 = pad
    ecluster, einst = np.asarray(sw.ecluster), np.asarray(sw.einst)
    o2w = np.asarray(sw.o2w, np.float64).reshape(-1, 3, 4)
    tv = np.asarray(js.geom.tri_verts, np.float64)
    mat, light = np.asarray(js.geom.tri_mat), np.asarray(js.geom.tri_light)
    verts, mats, lights = [], [], []
    for i in range(o2w.shape[0]):
        ids = pid[ecluster[einst == i]].reshape(-1)
        ids = np.sort(ids[ids >= 0])
        verts.append(tv[ids] @ o2w[i, :, :3].T + o2w[i, :, 3])
        mats.append(mat[ids])
        lights.append(light[ids])
    geom = JGeometryBuffers.build(
        tri_verts=np.concatenate(verts).astype(np.float32),
        tri_mat=np.concatenate(mats), tri_light=np.concatenate(lights))
    return js.replace(geom=geom, sweep=None)


@pytest.fixture(scope="module")
def traced():
    """The reference's and the port's per-sample radiance and ray counts on
    the same pixels and samples (one pass of SPP samples), with the small
    prototypes."""
    (js, jc, j_integ), (ps, pc, pset) = load_pair()
    assert ps.sweep.instanced
    assert ps.small is None and ps.clusters is None
    assert js.geom.num_triangles == 4 + 18 * (1280 + 720)
    want = reference_trace("trace/instanced12", js, jc, j_integ, RES, SPP)
    jL, jrgb = want["L"], want["rgb"]
    pc = pc.replace(resolution=(RES, RES))
    npix = RES * RES
    pixel = np.tile(np.arange(npix, dtype=np.int32), SPP)
    sample = np.repeat(np.arange(SPP, dtype=np.int32), npix)
    tpix, tsam = torch.from_numpy(pixel), torch.from_numpy(sample)
    po, pd, pwl, _ = camera_rays_full(pc, tpix, tsam, 0, n_spectrum=N_SPECTRUM)
    sweep.STATS.reset()
    pL, pstats = pset["integrator"].trace_with_stats(ps, po, pd, pwl, tpix,
                                                     tsam, 0)
    assert sweep.STATS.launches == 0  # the CPU path takes the twin
    return ((jL, float(want["rays"]), jrgb),
            (pL, float(pstats["rays"])), (ps, pc, pset))


def load_pair():
    """The field with the small prototypes through both parsers: the
    reference's scene flattened (its dense tester answers), its camera at
    RES and its integrator; the port's scene, camera and settings."""
    with tempfile.TemporaryDirectory() as tmp:
        write_field_meshes("pbrt_tpu_torch", tmp, SMALL)
        js, jc, jset = jax_load_pbrt_string(field_text(), tmp)
        ps, pc, pset = load_pbrt_string(field_text(), tmp, device="cpu")
    assert js.sweep.instanced
    return ((_flattened(js), jc.replace(resolution=(RES, RES)),
             jset["integrator"]), (ps, pc, pset))


def test_trace_with_stats_per_sample(traced):
    (jL, j_rays, _), (pL, p_rays), (_, _, pset) = traced
    assert pset["integrator"].max_depth == 5
    assert pL.shape == (SPP * RES * RES, N_SPECTRUM)
    assert torch.isfinite(pL).all()
    assert abs(p_rays - j_rays) <= 0.005 * j_rays, (p_rays, j_rays)
    sample_ok = np.all(np.abs(pL.numpy() - jL) <= 1e-5 + 1e-3 * np.abs(jL), axis=-1)
    n_bad = int(np.sum(~sample_ok))
    print(f"samples disagreeing with the reference: {n_bad} of {len(sample_ok)}")
    assert np.mean(sample_ok) >= 0.99, n_bad
    assert np.mean(jL.max(axis=-1) > 0.0) > 0.9


def test_render_image(traced):
    """The port's render against the reference's samples developed as the
    reference's render develops one pass of finite samples."""
    (_, _, jrgb), _, (ps, pc, pset) = traced
    assert np.all(np.isfinite(jrgb))
    want = jrgb.reshape(SPP, RES, RES, 3).mean(axis=0)
    got = render(ps, pc, pset["integrator"], spp=SPP, samples_per_pass=SPP,
                 seed=0, n_spectrum=N_SPECTRUM, device="cpu").numpy()
    assert got.shape == want.shape == (RES, RES, 3)
    share, n_bad = share_close(got, want, rtol=1e-3, atol=1e-5)
    print(f"pixel values disagreeing with the reference: {n_bad}")
    assert share >= 0.99, n_bad


def test_golden_window():
    """A 16 x 8 window of the JAX golden of the full-size field (122,244
    unique triangles, 17,191 entries), rendered by the port through its
    parser and K3's twin, developed as render() develops a pass: the mean
    of each pixel's finite samples."""
    golden = np.load(GOLDEN)
    with tempfile.TemporaryDirectory() as tmp:
        write_field_meshes("pbrt_tpu_torch", tmp, FULL)
        scene, camera, settings = load_pbrt_string(field_text(), tmp,
                                                   device="cpu")
    assert scene.geom.num_triangles == 122_244
    assert scene.sweep.n_entries == 17_191
    camera = camera.replace(resolution=(GOLDEN_RES, GOLDEN_RES))
    x0, y0, w, h = WINDOW
    ys, xs = np.meshgrid(np.arange(y0, y0 + h), np.arange(x0, x0 + w),
                         indexing="ij")
    pix = torch.from_numpy((ys * GOLDEN_RES + xs).reshape(-1))
    pixel = pix.repeat(GOLDEN_SPP)
    sample = torch.arange(GOLDEN_SPP).repeat_interleave(pix.shape[0])
    o, d, wl, _ = camera_rays_full(camera, pixel, sample, 0,
                                   n_spectrum=GOLDEN_LANES)
    L = settings["integrator"].trace(scene, o, d, wl, pixel, sample, 0)
    rgb = spectrum_to_rgb(L, wl).reshape(GOLDEN_SPP, h, w, 3)
    finite = torch.isfinite(rgb).all(dim=-1, keepdim=True)
    got = (torch.where(finite, rgb, 0.0).sum(0)
           / finite.sum(0).clamp(min=1)).numpy()
    want = golden[y0:y0 + h, x0:x0 + w]
    share, n_bad = share_close(got, want, rtol=1e-3, atol=1e-5)
    print(f"window values disagreeing with the golden: {n_bad} of {want.size}")
    assert share >= 0.99, n_bad
