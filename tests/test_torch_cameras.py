"""The port's cameras (pbrt_tpu_torch/cameras/) against the reference on
the CPU, from numpy-seeded film and pupil samples (8,192 rays at 32 x 32).

- generate_rays of the orthographic and spherical cameras (both
  mappings), the doublet (tests/data/torch_port/doublet.dat) with its
  exit pupil, on its full rear disk and with HURB diffraction, an omni
  aspheric .json lens with and without its microlens array, the Navarro
  eye with and without diffraction (per-ray wavelengths) and the RTF
  camera fitted to the doublet, against the reference's jitted ones: the
  weight > 0 mask agrees on >= 99.9% of the rays, and on the rays valid
  in both o within 1e-5 mm-scaled units, d within 1e-5, the weight
  within 1e-6. HURB's deflected d: the bulk within 1e-6 at the 99th
  percentile (a few ulps; the deflections it checks are ~4e-5 (doublet)
  and ~9e-5 (eye) at the median, 1e-5 to 2e-4 between the 10th and
  90th percentiles), and the tail within 2e-3 at the 99.9th (rays at an
  aperture edge, whose Gaussian angles take log, sin and cos, may be
  deflected on another side of the edge). The lens's reference-side
  exit-pupil bounds are carried across, as the renders do.
- The .dat and .json loaders build the reference's stacks bit for bit;
  the exit-pupil bounds of the doublet and of a biconvex singlet: the
  number of differing cells (0 on this CPU) stays 0; the RTF fit's
  coefficients within 1e-4 of the largest.
- convert.camera_from_arrays carries every camera class: its rays equal
  the natively built port camera's.
- The Cornell box through each camera (tests/torch_port_cameras.py)
  against scripts/make_torch_port_golden_cameras.py's JAX renders:
  >= 99% of the values within rtol 1e-3 / atol 1e-5, the share of rays
  with weight > 0 within 1e-3 of the reference's, a lit image; the eye
  through render_spectral's bands the same way.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.cameras import humaneye as jh
from pbrt_tpu.cameras import lens as jl
from pbrt_tpu.cameras import realistic as jr
from pbrt_tpu.cameras import rtf as jrtf
from pbrt_tpu.cameras import simple as js
from pbrt_tpu_torch.cameras import humaneye as th
from pbrt_tpu_torch.cameras import lens as tl
from pbrt_tpu_torch.cameras import realistic as tr
from pbrt_tpu_torch.cameras import rtf as trtf
from pbrt_tpu_torch.cameras import simple as ts
from pbrt_tpu_torch.convert import camera_from_arrays
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.models.spectralpath import render_spectral
from pbrt_tpu_torch.render import camera_rays_full, render
from pbrt_tpu_torch.samplers.samplers import Sampler
from pbrt_tpu_torch.scenes.cornell import cornell_box

from . import torch_port_cameras as C
from .torch_port_helpers import flatten_jax, share_close

torch.set_num_threads(2)
N = 8192
RES = 32
_R = np.random.default_rng(0)
P_FILM = _R.uniform(0, RES, (N, 2)).astype(np.float32)
U_LENS = _R.uniform(0, 1, (N, 2)).astype(np.float32)
WL = _R.uniform(400, 700, N).astype(np.float32)
STACK_FIELDS = ("vertex_z", "radius", "conic", "aperture2", "eta_after",
                "eta_before")
_GOLDEN = np.load(C.GOLDEN)


def _omni_json(tmp_path, micro: bool):
    spec = json.load(open(C.OMNI_JSON))
    if not micro:
        del spec["microlens"]
    path = tmp_path / "lens.json"
    path.write_text(json.dumps(spec))
    return str(path)


def _pair(name, tmp_path):
    """(reference camera, port camera, generate_rays kwargs) of a case."""
    if name in ("ortho", "spherical", "lens_full", "rtf"):
        key = {"lens_full": "lens"}.get(name, name)
        jc = C.CAMERAS[key]("pbrt_tpu", RES)
        tc = C.CAMERAS[key]("pbrt_tpu_torch", RES)
        if name == "lens_full":
            jc, tc = jc.replace(pupil_bounds=None), tc.replace(pupil_bounds=None)
        if name == "rtf":
            tc = C.port_camera("rtf", {
                "rtf_coeffs": np.asarray(jc.coeffs),
                "rtf_front_z_mm": np.asarray(jc.front_z_mm),
                "rtf_pupil_radius_mm": np.asarray(jc.pupil_radius_mm)}, RES)
        return jc, tc, {}
    if name == "equirect":
        return (js.SphericalCamera(camera_to_world=C._c2w("pbrt_tpu"),
                                   resolution=(RES, RES),
                                   mapping="equirectangular"),
                ts.SphericalCamera(camera_to_world=C._c2w("pbrt_tpu_torch"),
                                   resolution=(RES, RES),
                                   mapping="equirectangular"), {})
    if name in ("lens_pupil", "lens_hurb"):
        jc = C.lens_camera("pbrt_tpu", RES)
        tc = C.lens_camera("pbrt_tpu_torch", RES, exit_pupil=False).replace(
            pupil_bounds=torch.from_numpy(np.array(jc.pupil_bounds)))
        if name == "lens_hurb":
            return (jc.replace(diffraction=True), tc.replace(diffraction=True),
                    {"wavelength_nm": WL})
        return jc, tc, {}
    if name in ("omni_aspheric", "omni_microlens"):
        path = _omni_json(tmp_path, name == "omni_microlens")
        jlens, jm = jr.load_lens_json(path, microlens_sensor_offset_mm=2.0)
        tlens, tm = tr.load_lens_json(path, microlens_sensor_offset_mm=2.0)
        return (jr.omni_camera(C._c2w("pbrt_tpu", scale=C.MM), (RES, RES),
                               jlens, microlens=jm),
                tr.omni_camera(C._c2w("pbrt_tpu_torch", scale=C.MM),
                               (RES, RES), tlens, microlens=tm), {})
    diff = name == "eye_hurb"
    jc = C.eye_factory("pbrt_tpu", RES)(550.0).replace(diffraction=diff)
    tc = C.eye_factory("pbrt_tpu_torch", RES)(550.0).replace(diffraction=diff)
    return jc, tc, {"wavelength_nm": WL} if diff else {}


def _rays(jc, tc, kw):
    jo = jax.jit(lambda a, b, c: jc.generate_rays(a, b, **c))(
        jnp.asarray(P_FILM), jnp.asarray(U_LENS),
        {k: jnp.asarray(v) for k, v in kw.items()})
    to = tc.generate_rays(torch.from_numpy(P_FILM), torch.from_numpy(U_LENS),
                          **{k: torch.from_numpy(v) for k, v in kw.items()})
    return [np.asarray(x) for x in jo], [x.numpy() for x in to]


CASES = ["ortho", "spherical", "equirect", "lens_pupil", "lens_full",
         "lens_hurb", "omni_aspheric", "omni_microlens", "eye", "eye_hurb",
         "rtf"]


@pytest.mark.parametrize("name", CASES)
def test_generate_rays_match_reference(name, tmp_path):
    jc, tc, kw = _pair(name, tmp_path)
    jo, to = _rays(jc, tc, kw)
    if len(jo) == 3:
        wj, wt = jo[2], to[2]
        assert np.mean((wj > 0) == (wt > 0)) >= 0.999
        both = (wj > 0) & (wt > 0)
        assert both.any()
        np.testing.assert_allclose(wt[both], wj[both], rtol=1e-6, atol=0)
    else:
        both = np.ones(N, bool)
    np.testing.assert_allclose(to[0][both], jo[0][both], rtol=0, atol=1e-5)
    derr = np.abs(to[1][both] - jo[1][both]).max(axis=-1)
    if name.endswith("hurb"):
        assert np.quantile(derr, 0.99) < 1e-6, np.quantile(derr, 0.99)
        assert np.quantile(derr, 0.999) < 2e-3, np.quantile(derr, 0.999)
    else:
        assert derr.max() < 1e-5, derr.max()
    conv = camera_from_arrays(*flatten_jax(jc), kind=type(jc).__name__)
    co = conv.generate_rays(torch.from_numpy(P_FILM), torch.from_numpy(U_LENS),
                            **{k: torch.from_numpy(v) for k, v in kw.items()})
    if name != "rtf":  # the native port camera fits its own RTF
        for a, b in zip(co, to):
            assert torch.equal(a, torch.from_numpy(b))


def test_lens_loaders_match_reference(tmp_path):
    pairs = [(jl.load_lens_file(C.DOUBLET), tl.load_lens_file(C.DOUBLET))]
    path = _omni_json(tmp_path, True)
    (jlens, jm), (tlens, tm) = (jr.load_lens_json(path, 600.0, 2.0, 1),
                                tr.load_lens_json(path, 600.0, 2.0, 1))
    pairs += [(jlens, tlens), (jm.stack, tm.stack),
              (jh.navarro_eye_stack(3.0, 480.0), th.navarro_eye_stack(3.0, 480.0)),
              (jr.biconvex_singlet(40.0, 9.0), tr.biconvex_singlet(40.0, 9.0))]
    for j, t in pairs:
        for f in STACK_FIELDS:
            assert np.array_equal(np.asarray(getattr(j, f)),
                                  getattr(t, f).numpy()), f
        assert j.has_aspheric == t.has_aspheric
        if j.has_aspheric:
            assert np.array_equal(np.asarray(j.aspheric), t.aspheric.numpy())
    assert (jm.dims, jm.sim_radius, jm.offset_from_sensor) == (
        tm.dims, tm.sim_radius, tm.offset_from_sensor)
    with pytest.raises(ValueError, match="bad lens row"):
        bad = tmp_path / "bad.dat"
        bad.write_text("50 2 1.5\n")
        tl.load_lens_file(str(bad))


@pytest.mark.parametrize("lens", ["doublet", "singlet"])
def test_exit_pupil_bounds_match_reference(lens):
    if lens == "doublet":
        jb = jr.compute_exit_pupil_bounds(jl.load_lens_file(C.DOUBLET), 35.0)
        tb = tr.compute_exit_pupil_bounds(tl.load_lens_file(C.DOUBLET), 35.0)
    else:
        jb = jr.compute_exit_pupil_bounds(jr.biconvex_singlet(50.0, 10.0), 16.0)
        tb = tr.compute_exit_pupil_bounds(tr.biconvex_singlet(50.0, 10.0), 16.0)
    differ = int(np.sum(np.asarray(jb) != tb.numpy()))
    assert differ == 0, f"{differ} of {tb.numel()} bound values differ"
    assert bool((tb[:, 1] > tb[:, 0]).any())


def test_rtf_fit_matches_reference():
    jc = jrtf.fit_from_camera(C.lens_camera("pbrt_tpu", RES, exit_pupil=False))
    tc = trtf.fit_from_camera(C.lens_camera("pbrt_tpu_torch", RES,
                                            exit_pupil=False))
    jco = np.asarray(jc.coeffs)
    assert np.abs(tc.coeffs.numpy() - jco).max() <= 1e-4 * np.abs(jco).max()
    assert np.array_equal(np.asarray(jc.powers), tc.powers.numpy())
    assert abs(float(tc.front_z_mm) - float(jc.front_z_mm)) <= 1e-5
    assert abs(float(tc.pupil_radius_mm) - float(jc.pupil_radius_mm)) <= 1e-4


def _gate(got, want):
    share, n_off = share_close(got, want, rtol=1e-3, atol=1e-5)
    assert share >= 0.99, (share, n_off)
    assert float(np.mean(got)) > 0.0 and np.isfinite(got).all()


@pytest.mark.parametrize("name", sorted(C.RENDERS))
def test_camera_render_matches_golden(name):
    scene, _ = cornell_box(resolution=(RES, RES))
    cam = C.port_camera(name, _GOLDEN, RES)
    kind, filt = C.RENDERS[name]
    img = render(scene.with_accel(), cam, PathIntegrator(max_depth=C.CFG["max_depth"]),
                 spp=C.CFG["spp"], seed=C.CFG["seed"],
                 samples_per_pass=C.CFG["spp"], sampler_kind=kind,
                 filter_kind=filt, n_spectrum=C.CFG["n_spectrum"],
                 device="cpu")
    _gate(img.numpy(), _GOLDEN[name])
    sampler = Sampler.create(kind, spp=C.CFG["spp"], nx=RES, log2_res=5)
    pixel = torch.arange(RES * RES).repeat(C.CFG["spp"])
    sample = torch.arange(C.CFG["spp"]).repeat_interleave(RES * RES)
    _, _, _, w = camera_rays_full(cam, pixel, sample, sampler)
    share = float((w > 0).float().mean())
    assert abs(share - float(_GOLDEN[name + "_share"])) <= 1e-3, share


def test_eye_bands_match_golden():
    scene, _ = cornell_box(resolution=(RES, RES))
    rgb, bands = render_spectral(scene.with_accel(),
                                 C.eye_factory("pbrt_tpu_torch", RES),
                                 seed=C.CFG["seed"],
                                 n_spectrum=C.CFG["n_spectrum"], device="cpu",
                                 **C.EYE_CFG)
    _gate(rgb.numpy(), _GOLDEN["eye_rgb"])
    _gate(bands.numpy(), _GOLDEN["eye_bands"])
