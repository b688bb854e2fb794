"""The cameras' scenes of the port's tests, their golden script and
chip_smoke.py: the Cornell box (scenes/cornell.py) seen through each
camera family, built the same way in the reference (`pkg="pbrt_tpu"`)
and in the port (`pkg="pbrt_tpu_torch"`).

- lens: the two-group doublet tests/data/torch_port/doublet.dat (a copy
  of examples/lenses/doublet.dat) with its exit-pupil bounds, zsobol and
  a gaussian filter;
- omni: tests/data/torch_port/omni_microlens.json (a 50 mm aspheric
  singlet over a 32 x 32 microlens array at 2 mm), sobol and a triangle
  filter;
- eye: the Navarro eye (3 mm pupil) with HURB diffraction, rebuilt at
  each band's centre by render_spectral;
- ortho: the orthographic camera (half width 0.45) with halton and a
  mitchell filter;
- spherical: the spherical camera at the box's centre with pmj02bn;
- rtf: an RTF camera fitted to the doublet (full rear disk), stratified
  and a lanczos filter;
- sppm_ortho: SPPM through the orthographic camera (SPPM makes its camera
  rays from film points alone, so it takes the cameras without a lens).

Lens math is in millimetres: a lens camera's camera_to_world is the
Cornell camera's look-at times a 1e-3 scale. This module imports numpy
only at import time, so chip_smoke.py can use it.
"""

from __future__ import annotations

import importlib
import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
DOUBLET = os.path.join(DATA, "doublet.dat")
OMNI_JSON = os.path.join(DATA, "omni_microlens.json")
GOLDEN = os.path.join(DATA, "cameras32.npz")
SPPM_GOLDEN = os.path.join(DATA, "sppm_ortho16.npz")

EYE = (0.5, 0.5, -1.45)
TARGET = (0.5, 0.5, 0.5)
UP = (0.0, 1.0, 0.0)
MM = 1e-3
# The renders: camera, sampler kind, filter kind. Each is 32 x 32, 4 spp in
# one pass, depth 5, 8 wavelength lanes, seed 0; the eye renders 4 bands of
# 2 spp through render_spectral.
RENDERS = {
    "lens": ("zsobol", "gaussian"),
    "omni": ("sobol", "triangle"),
    "ortho": ("halton", "mitchell"),
    "spherical": ("pmj02bn", "box"),
    "rtf": ("stratified", "lanczos"),
}
CFG = dict(res=32, spp=4, max_depth=5, n_spectrum=8, seed=0)
EYE_CFG = dict(n_bands=4, spp_per_band=2, max_depth=5)
AOV_CFG = dict(spp=4, spectral_buckets=8)
SPPM_CFG = dict(res=16, iterations=2, photons=4096, max_depth=5, seed=0)


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _c2w(pkg: str, eye=EYE, target=TARGET, scale: float = 1.0):
    tfm = _mod(pkg, "core.transform")
    m = np.asarray(tfm.look_at(eye, target, UP).m, np.float32)
    m = (m @ np.diag([scale, scale, scale, 1.0])).astype(np.float32)
    return tfm.Transform.from_matrix(m)


def lens_camera(pkg: str, res: int = 32, exit_pupil: bool = True):
    cams = _mod(pkg, "cameras.realistic")
    lens = _mod(pkg, "cameras.lens").load_lens_file(DOUBLET)
    return cams.RealisticCamera.create(_c2w(pkg, scale=MM), lens, (res, res),
                                       exit_pupil=exit_pupil)


def omni_camera(pkg: str, res: int = 32):
    cams = _mod(pkg, "cameras.realistic")
    lens, micro = cams.load_lens_json(OMNI_JSON, microlens_sensor_offset_mm=2.0)
    return cams.omni_camera(_c2w(pkg, scale=MM), (res, res), lens,
                            microlens=micro)


def eye_factory(pkg: str, res: int = 32):
    eye = _mod(pkg, "cameras.humaneye").HumanEyeCamera
    c2w = _c2w(pkg, scale=MM)

    def factory(band_centre_nm):
        return eye.navarro(c2w, (res, res), pupil_diameter_mm=3.0,
                           wavelength_nm=band_centre_nm).replace(
                               diffraction=True)

    return factory


def ortho_camera(pkg: str, res: int = 32):
    simple = _mod(pkg, "cameras.simple")
    return simple.OrthographicCamera(camera_to_world=_c2w(pkg),
                                     resolution=(res, res),
                                     screen_half_width=0.45)


def spherical_camera(pkg: str, res: int = 32):
    simple = _mod(pkg, "cameras.simple")
    return simple.SphericalCamera(
        camera_to_world=_c2w(pkg, eye=(0.5, 0.5, 0.5), target=(0.5, 0.5, 1.0)),
        resolution=(res, res))


def rtf_camera(pkg: str, res: int = 32):
    return _mod(pkg, "cameras.rtf").fit_from_camera(
        lens_camera(pkg, res, exit_pupil=False))


CAMERAS = {"lens": lens_camera, "omni": omni_camera, "ortho": ortho_camera,
           "spherical": spherical_camera, "rtf": rtf_camera}


def port_camera(name: str, golden, res: int = 32):
    """The port's camera `name`, with the reference's host-computed data
    (the exit-pupil bounds, the RTF fit) carried across from the golden
    file, so both packages sample the same window."""
    import torch

    cam = CAMERAS[name]("pbrt_tpu_torch", res)
    if name == "lens":
        cam = cam.replace(pupil_bounds=torch.from_numpy(
            np.array(golden["lens_pupil_bounds"])))
    if name == "rtf":
        cam = cam.replace(
            coeffs=torch.from_numpy(np.array(golden["rtf_coeffs"])),
            front_z_mm=torch.tensor(float(golden["rtf_front_z_mm"])),
            pupil_radius_mm=torch.tensor(float(golden["rtf_pupil_radius_mm"])))
    return cam


# -- sampler draws --------------------------------------------------------

SAMPLER_KINDS = ("independent", "stratified", "sobol", "zsobol", "halton",
                 "padded", "pmj02bn")
# Sampler settings of the draws: a 32 x 32 image at 16 spp, and a flat
# pixel id (no width) at 12 spp (the non-power-of-two shuffles) with
# another seed; d27 draws c (a 256 x 256 image, 16 spp) at 1,048,576 lanes.
SAMPLER_CFGS = {
    "a": dict(spp=16, nx=32, log2_res=5, seed=0, npix=1024),
    "b": dict(spp=12, nx=0, log2_res=10, seed=7, npix=3000),
    "c": dict(spp=16, nx=256, log2_res=8, seed=0, npix=65536),
}
DRAW_DIMS = 41  # dimensions 0 .. 40
DRAW_LANES = 4096
SAMPLER_GOLDEN = os.path.join(DATA, "sampler_draws.npz")
DRAW_KEEP = 64  # lanes kept whole in the golden, beside every digest


def draw_lanes(n: int, cfg: dict):
    """(pixel, sample) int arrays of n lanes: pixels cycle fastest."""
    lane = np.arange(n)
    return ((lane % cfg["npix"]).astype(np.int32),
            ((lane // cfg["npix"]) % cfg["spp"]).astype(np.int32))


def draws(sampler, pixel, sample, n_dims: int = DRAW_DIMS):
    """get_1d(d) and both components of get_2d(d) for d < n_dims, in either
    package: a list of 3 * n_dims arrays, dimension-major."""
    out = []
    for d in range(n_dims):
        out.append(sampler.get_1d(pixel, sample, d))
        out.extend(sampler.get_2d(pixel, sample, d))
    return out


def digests(values) -> np.ndarray:
    """(3 * n_dims,) sha256 prefixes of each draw's float32 bits."""
    import hashlib

    return np.asarray([hashlib.sha256(np.ascontiguousarray(
        np.asarray(v, np.float32)).view(np.uint32).tobytes()).hexdigest()[:16]
        for v in values])
