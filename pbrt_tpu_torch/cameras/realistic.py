"""Realistic (lens-stack) and omni cameras (port of
pbrt_tpu/cameras/realistic.py; RealisticCamera, cameras.h:485, with its
exit-pupil bounds, and the ISET fork's OmniCamera, :853-1086: conic and
aspheric surfaces, microlens arrays, cameras.cpp:3153-3330, and HURB
diffraction at the stop, cameras.cpp:2742).

generate_rays samples a point on the rear element (inside the film
radius's exit-pupil rectangle when the bounds are computed, or in the
film point's microlens window), builds the film -> rear ray and traces
the batch through the stack(s) (cameras/lens.py). A ray an aperture clips
returns weight 0 (vignetting) instead of being resampled; the pupil
window's area over the rear disk's weights the others, so the estimator
keeps full-disk sampling's expectation. HURB's normals are hashed from
the bit patterns of the film and pupil samples, so a render replays.
Lens math is in millimetres in the camera frame (film at z = 0, scene
toward +z); camera_to_world carries the mm -> scene-unit scale.
"""

from __future__ import annotations

import json
import math
from typing import Optional

import numpy as np
import torch

from ..core.floats import recip
from ..core.rng import pcg4d
from ..core.sampling import sample_uniform_disk_concentric
from ..core.tensorclass import static_field, tensorclass
from ..core.transform import Transform
from ..core.vecmath import normalize
from .lens import LensStack, trace_through_stack

_F32 = np.float32


@tensorclass
class MicrolensArray:
    """A dims[0] x dims[1] grid of identical small lens stacks over the
    film at offset_from_sensor mm (OmniCamera::MicrolensData,
    cameras.h:880). `stack` holds one microlens with its vertex z measured
    from the sensor plane; `offsets` optionally decentres each lens (mm)."""

    stack: LensStack
    dims: tuple = static_field()  # (mx, my)
    offset_from_sensor: float = static_field(default=0.001)
    offsets: Optional[torch.Tensor] = None  # (mx * my, 2)
    sim_radius: int = static_field(default=0)


def hurb_noise(p_film, u_lens):
    """(N, 2) standard normals for HURB, hashed from the bit patterns of
    the film and pupil samples (Box-Muller of two pcg4d streams)."""
    def bits(x):
        return x.to(torch.float32).contiguous().view(torch.int32).to(
            torch.int64) & 0xFFFFFFFF

    h0, h1, _, _ = pcg4d(bits(p_film[..., 0]), bits(p_film[..., 1]),
                         bits(u_lens[..., 0]), bits(u_lens[..., 1]))
    u0 = (h0 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    u1 = (h1 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(u0, min=1e-12)))
    ang = 2.0 * math.pi * u1
    return torch.stack([r * torch.cos(ang), r * torch.sin(ang)], dim=-1)


@tensorclass
class RealisticCamera:
    camera_to_world: Transform
    lens: LensStack
    resolution: tuple = static_field()
    film_diag_mm: float = static_field(default=35.0)
    # The rear aperture's radius scale bounds the sampled pupil disk.
    rear_radius_scale: float = static_field(default=1.0)
    shutter_open: float = static_field(default=0.0)
    shutter_close: float = static_field(default=1.0)
    # Exit-pupil bounds per film-radius segment: (S, 4) [x0, x1, y0, y1]
    # on the rear element plane (ComputeExitPupilBounds, cameras.h:544).
    # None: sample the full rear disk.
    pupil_bounds: Optional[torch.Tensor] = None
    microlens: Optional[MicrolensArray] = None
    # HURB diffraction at the aperture stop (OmniCamera diffractionEnabled).
    diffraction: bool = static_field(default=False)

    @staticmethod
    def create(camera_to_world, lens, resolution, film_diag_mm=35.0,
               exit_pupil=True, n_pupil_segments=32) -> "RealisticCamera":
        cam = RealisticCamera(camera_to_world=camera_to_world, lens=lens,
                              resolution=resolution, film_diag_mm=film_diag_mm)
        if exit_pupil:
            cam = cam.replace(pupil_bounds=compute_exit_pupil_bounds(
                lens, film_diag_mm, n_segments=n_pupil_segments))
        return cam

    def _film_extent(self):
        nx, ny = self.resolution
        aspect = nx / ny
        h = self.film_diag_mm / np.sqrt(1.0 + aspect * aspect)
        return float(aspect * h), float(h)

    def generate_rays(self, p_film, u_lens, wavelength_nm=None):
        """p_film: (N, 2) raster coords; u_lens: (N, 2) pupil samples.

        Returns (o_world, d_world, weight), weight 0 where vignetted.
        wavelength_nm (a scalar or (N,)) feeds HURB when `diffraction`."""
        nx, ny = self.resolution
        w, h = self._film_extent()
        # The image is inverted through the lens: flip to keep it upright.
        fx = (0.5 - p_film[..., 0] * recip(nx)) * w
        fy = (p_film[..., 1] * recip(ny) - 0.5) * h
        o = torch.stack([fx, fy, torch.zeros_like(fx)], dim=-1)
        vz0, _, _, ap2_0, _, _, _ = self.lens.host[0]
        rear_r = _F32(np.sqrt(ap2_0)) * _F32(self.rear_radius_scale)
        hurb = hurb_noise(p_film, u_lens) if self.diffraction else None
        wl = 550.0 if wavelength_nm is None else wavelength_nm
        if self.microlens is not None:
            return self._generate_rays_microlens(o, fx, fy, u_lens, w, h,
                                                 rear_r, hurb, wl)
        disk_area = float(max(_F32(np.pi) * rear_r * rear_r, _F32(1e-12)))
        if self.pupil_bounds is None:
            # Full rear-disk sampling.
            p_disk = sample_uniform_disk_concentric(u_lens) * float(rear_r)
            px, py = p_disk[..., 0], p_disk[..., 1]
            w_pupil = torch.ones_like(fx)
        else:
            # SampleExitPupil (cameras.h:551): the film radius's pupil
            # rectangle, sampled uniformly and rotated into the film
            # point's azimuth; its area over the rear disk's weights it.
            nseg = self.pupil_bounds.shape[0]
            r_film = torch.sqrt(fx * fx + fy * fy)
            r_max = 0.5 * self.film_diag_mm
            seg = torch.clamp((r_film * recip(r_max) * nseg).to(torch.int32),
                              0, nseg - 1).long()
            b = self.pupil_bounds[seg]  # (N, 4)
            bx = b[..., 0] + u_lens[..., 0] * (b[..., 1] - b[..., 0])
            by = b[..., 2] + u_lens[..., 1] * (b[..., 3] - b[..., 2])
            area = torch.clamp((b[..., 1] - b[..., 0]) * (b[..., 3] - b[..., 2]),
                               min=0.0)
            safe_r = torch.clamp(r_film, min=1e-8)
            far = r_film > 1e-8
            cos_p = torch.where(far, fx / safe_r, 1.0)
            sin_p = torch.where(far, fy / safe_r, 0.0)
            px = cos_p * bx - sin_p * by
            py = sin_p * bx + cos_p * by
            w_pupil = area / disk_area
        target = torch.stack([px, py, torch.full_like(fx, float(vz0))], dim=-1)
        d = normalize(target - o)
        o_out, d_out, valid = trace_through_stack(
            self.lens, o, d, hurb_noise=hurb, wavelength_nm=wl)
        o_w = self.camera_to_world.apply_point(o_out)
        d_w = normalize(self.camera_to_world.apply_vector(d_out))
        return o_w, d_w, valid.to(torch.float32) * w_pupil

    def _generate_rays_microlens(self, o, fx, fy, u_lens, w, h, rear_r,
                                 hurb, wl):
        """Film -> the sampled point's microlens -> the main stack
        (OmniCamera::SampleMicrolensPupil + TraceFullLensSystemFromFilm,
        cameras.cpp:3167/3296): a target uniform over the film point's
        (2R+1)-cell microlens window, traced through the lens covering it
        (decentred by its offset) in that lens' frame, then the main
        stack."""
        ml = self.microlens
        mx, my = ml.dims
        # The film point's cell in lens-grid space (MicrolensIndex).
        gx = (fx + 0.5 * w) * recip(w) * mx
        gy = (fy + 0.5 * h) * recip(h) * my
        r_sim = float(ml.sim_radius)
        diam = 2.0 * r_sim + 1.0
        sx_cell = torch.floor(gx) - r_sim + u_lens[..., 0] * diam
        sy_cell = torch.floor(gy) - r_sim + u_lens[..., 1] * diam
        # The sample point on the microlens plane.
        sx = sx_cell * recip(mx) * w - 0.5 * w
        sy = sy_cell * recip(my) * h - 0.5 * h
        # The lens covering the sampled point.
        cx_i = torch.clamp(torch.floor(sx_cell).to(torch.int32), 0, mx - 1)
        cy_i = torch.clamp(torch.floor(sy_cell).to(torch.int32), 0, my - 1)
        cx = (cx_i.to(torch.float32) + 0.5) * recip(mx) * w - 0.5 * w
        cy = (cy_i.to(torch.float32) + 0.5) * recip(my) * h - 0.5 * h
        if ml.offsets is not None:
            off = ml.offsets[(cy_i * mx + cx_i).long()]
            cx = cx + off[..., 0]
            cy = cy + off[..., 1]
        target = torch.stack(
            [sx, sy, torch.full_like(sx, float(ml.offset_from_sensor))], dim=-1)
        d = normalize(target - o)
        center = torch.stack([cx, cy, torch.zeros_like(cx)], dim=-1)
        o1, d1, v1 = trace_through_stack(ml.stack, o - center, d)
        o2, d2, v2 = trace_through_stack(self.lens, o1 + center, d1,
                                         hurb_noise=hurb, wavelength_nm=wl)
        window_area = (diam / mx * w) * (diam / my * h)
        w_pupil = float(_F32(window_area) / max(_F32(np.pi) * rear_r * rear_r,
                                                _F32(1e-12)))
        o_w = self.camera_to_world.apply_point(o2)
        d_w = normalize(self.camera_to_world.apply_vector(d2))
        return o_w, d_w, (v1 & v2).to(torch.float32) * w_pupil


def compute_exit_pupil_bounds(lens: LensStack, film_diag_mm: float,
                              n_segments: int = 32, n_grid: int = 48):
    """Per-film-radius-segment rectangles of the non-vignetted rear-element
    window (ComputeExitPupilBounds, cameras.h:544): an n_grid^2 grid of
    candidate pupil points traced from each segment's outer radius, the
    survivors' bounding box padded by one grid cell. On the host, one
    trace of every segment's grid on the CPU. Returns (S, 4) float32."""
    host = lens.to("cpu")
    rear_z = float(host.host[0][0])
    rear_r = float(np.sqrt(host.host[0][3]))
    r_max = 0.5 * film_diag_mm
    s = np.arange(n_segments)
    film_x = (s + 1.0) / n_segments * r_max
    g = (np.arange(n_grid) + 0.5) / n_grid * 2.0 - 1.0
    px, py = np.meshgrid(g * rear_r, g * rear_r, indexing="ij")
    o = np.zeros((n_segments, n_grid, n_grid, 3), np.float32)
    o[..., 0] = film_x[:, None, None]
    tgt = np.zeros_like(o)
    tgt[..., 0] = px[None]
    tgt[..., 1] = py[None]
    tgt[..., 2] = rear_z
    o_t = torch.from_numpy(o.reshape(-1, 3))
    d_t = normalize(torch.from_numpy(tgt.reshape(-1, 3)) - o_t)
    _, _, valid = trace_through_stack(host, o_t, d_t)
    valid = valid.numpy().reshape(n_segments, n_grid, n_grid)
    pad = 2.0 * rear_r / n_grid
    bounds = np.zeros((n_segments, 4), np.float32)
    for i in range(n_segments):
        m = valid[i]
        if not m.any():  # a fully vignetted segment: a degenerate box
            continue
        xs, ys = px[m], py[m]
        bounds[i] = (xs.min() - pad, xs.max() + pad, ys.min() - pad,
                     ys.max() + pad)
    return torch.from_numpy(bounds)


def _scalar(v, default=0.0):
    """JSON scalar-or-[x, y] field -> float (its x component, as
    OmniCamera's toVec2 path for the isotropic case)."""
    if v is None:
        return default
    if isinstance(v, (list, tuple)):
        return float(v[0]) if v else default
    return float(v)


def _ior_at(v, wavelength_nm=550.0):
    """JSON ior field: a number, or a spectral table [[wavelengths],
    [values]] (OmniCamera's toIORSpectrum), at wavelength_nm."""
    if v is None:
        return 1.0
    if isinstance(v, (int, float)):
        return float(v) if v != 0 else 1.0
    out = float(np.interp(wavelength_nm, np.asarray(v[0], np.float64),
                          np.asarray(v[1], np.float64)))
    return out if out != 0 else 1.0


def _rows_from_json_surfaces(surfaces, wavelength_nm=550.0):
    rows, conics, asps = [], [], []
    max_k = 1
    for s in surfaces:
        rows.append([_scalar(s.get("radius")), _scalar(s.get("thickness")),
                     _ior_at(s.get("ior"), wavelength_nm),
                     2.0 * _scalar(s.get("semi_aperture"))])
        conics.append(_scalar(s.get("conic_constant")))
        a = s.get("aspheric_coefficients") or []
        asps.append([float(x) for x in a])
        max_k = max(max_k, len(a))
    asp_arr = np.zeros((len(asps), max_k))
    for i, a in enumerate(asps):
        asp_arr[i, :len(a)] = a
    return (np.asarray(rows, np.float64), np.asarray(conics, np.float64),
            asp_arr)


def load_lens_json(path: str, wavelength_nm: float = 550.0,
                   microlens_sensor_offset_mm: float = 1.0,
                   sim_radius: int = 0):
    """Parse an omni .json lens description (OmniCamera::Create: surfaces
    with radius / thickness / ior / semi_aperture / conic_constant /
    aspheric_coefficients, and an optional microlens block). Units stay
    in mm; spectral IOR tables are read at wavelength_nm. Returns
    (LensStack, MicrolensArray or None); a microlens stack's rear vertex
    sits at the sensor-offset plane."""
    with open(path) as f:
        j = json.load(f)
    surfaces = j.get("surfaces")
    if not surfaces:
        raise ValueError(f"no surfaces in lens json: {path}")
    rows, conics, asp = _rows_from_json_surfaces(surfaces, wavelength_nm)
    stack = LensStack.from_pbrt_elements(rows, conic=conics, aspheric=asp)
    micro = None
    mj = j.get("microlens")
    if mj:
        mdims = mj.get("dimensions")
        mrows, mconics, masp = _rows_from_json_surfaces(mj["surfaces"],
                                                        wavelength_nm)
        mstack = LensStack.from_pbrt_elements(mrows, conic=mconics,
                                              aspheric=masp)
        vz = mstack.vertex_z
        mstack = mstack.replace(
            vertex_z=vz - vz.min() + microlens_sensor_offset_mm)
        offsets = mj.get("offsets") or None
        if offsets:
            offsets = torch.from_numpy(np.asarray(offsets, np.float32))
        micro = MicrolensArray(stack=mstack, dims=(int(mdims[0]), int(mdims[1])),
                               offset_from_sensor=float(microlens_sensor_offset_mm),
                               offsets=offsets, sim_radius=int(sim_radius))
    return stack, micro


def biconvex_singlet(focal_mm: float = 50.0, aperture_mm: float = 12.5,
                     eta: float = 1.5,
                     film_distance_mm: float | None = None) -> LensStack:
    """A symmetric thin biconvex lens of the given focal length
    (lensmaker's equation: R = 2 (n - 1) f), for tests and as a default
    lens. R > 0 is convex toward the film (cameras/lens.py)."""
    r = 2.0 * (eta - 1.0) * focal_mm
    fd = film_distance_mm if film_distance_mm is not None else focal_mm
    thick = 2.0
    return LensStack.build([
        {"z": fd, "radius": r, "conic": 0.0, "aperture": aperture_mm,
         "eta_before": 1.0, "eta_after": eta},
        {"z": fd + thick, "radius": -r, "conic": 0.0, "aperture": aperture_mm,
         "eta_before": eta, "eta_after": 1.0},
    ])


def omni_camera(camera_to_world, resolution, lens: LensStack,
                film_diag_mm: float = 35.0,
                microlens: MicrolensArray | None = None,
                diffraction: bool = False) -> RealisticCamera:
    """OmniCamera: a RealisticCamera over a conic / aspheric stack, with
    the ISET extensions (microlens arrays, HURB diffraction)."""
    return RealisticCamera(camera_to_world=camera_to_world, lens=lens,
                           resolution=resolution, film_diag_mm=film_diag_mm,
                           microlens=microlens, diffraction=diffraction)
