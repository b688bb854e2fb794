"""Human eye camera: the Navarro schematic eye with a curved retina (port
of pbrt_tpu/cameras/humaneye.py; the ISET fork's HumanEyeCamera,
cameras.h:607-852).

The Navarro (1985) relaxed eye as conic surfaces on the shared LensStack
tracer (cameras/lens.py), traced retina -> cornea; a spherical retina
(mapToSphere, cameras.h:700-726); IORs at one wavelength through a
Cauchy-model dispersion, so a per-band factory (models/spectralpath.py)
gives longitudinal chromatic aberration; optional HURB diffraction at the
iris stop.

Navarro relaxed-eye parameters (public data):
  cornea anterior:  R = 7.72 mm,  Q = -0.26
  cornea posterior: R = 6.50 mm,  Q = 0
  lens anterior:    R = 10.2 mm,  Q = -3.1316
  lens posterior:   R = -6.0 mm,  Q = -1.0
  axial distances: cornea 0.55, aqueous 3.05, lens 4.0, vitreous 16.3203 mm
  IORs (~589 nm): cornea 1.367, aqueous 1.3374, lens 1.42, vitreous 1.336
  retina: a sphere of radius 12 mm.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.floats import recip
from ..core.sampling import sample_uniform_disk_concentric
from ..core.tensorclass import static_field, tensorclass
from ..core.transform import Transform
from ..core.vecmath import normalize
from .lens import LensStack, trace_through_stack
from .realistic import hurb_noise

_VITREOUS_LEN = 16.3203
_LENS_T = 4.0
_AQUEOUS_T = 3.05
_CORNEA_T = 0.55


def _disperse(n589: float, wavelength_nm: float) -> float:
    """Cauchy-model ocular dispersion: a refractivity-scaled water-like
    coefficient giving ~2 diopters of LCA across the visible range."""
    b_water = 3000.0  # nm^2, fitted to water's n(400) - n(700)
    scale = (n589 - 1.0) / 0.333
    return n589 + b_water * scale * (1.0 / wavelength_nm**2
                                     - 1.0 / 589.0**2)


def navarro_eye_stack(pupil_diameter_mm: float = 4.0,
                      wavelength_nm: float = 589.0) -> LensStack:
    """The Navarro relaxed eye as a retina -> scene LensStack (mm). R > 0
    is convex toward the retina here; ophthalmic tables quote the other
    sign."""
    z_lens_back = _VITREOUS_LEN
    z_lens_front = z_lens_back + _LENS_T
    z_cornea_back = z_lens_front + _AQUEOUS_T
    z_cornea_front = z_cornea_back + _CORNEA_T
    n_vit = _disperse(1.336, wavelength_nm)
    n_lens = _disperse(1.42, wavelength_nm)
    n_aq = _disperse(1.3374, wavelength_nm)
    n_cor = _disperse(1.367, wavelength_nm)
    return LensStack.build([
        {"z": z_lens_back, "radius": 6.0, "conic": -1.0, "aperture": 5.0,
         "eta_before": n_vit, "eta_after": n_lens},
        # The iris stop just behind the lens front vertex (offset so the
        # stop plane and the lens surface do not alias at t ~ 0).
        {"z": z_lens_front - 0.05, "radius": 0.0, "conic": 0.0,
         "aperture": pupil_diameter_mm / 2.0, "eta_before": n_lens,
         "eta_after": n_lens},
        {"z": z_lens_front, "radius": -10.2, "conic": -3.1316,
         "aperture": 5.0, "eta_before": n_lens, "eta_after": n_aq},
        {"z": z_cornea_back, "radius": -6.5, "conic": 0.0, "aperture": 5.5,
         "eta_before": n_aq, "eta_after": n_cor},
        {"z": z_cornea_front, "radius": -7.72, "conic": -0.26,
         "aperture": 5.75, "eta_before": n_cor, "eta_after": 1.0},
    ])


@tensorclass
class HumanEyeCamera:
    camera_to_world: Transform
    lens: LensStack
    resolution: tuple = static_field()
    retina_radius_mm: float = static_field(default=12.0)
    retina_semi_diam_mm: float = static_field(default=6.0)
    # HURB diffraction at the iris stop (diffractHURB, cameras.cpp:2092).
    diffraction: bool = static_field(default=False)

    @staticmethod
    def navarro(camera_to_world, resolution, pupil_diameter_mm=4.0,
                retina_semi_diam_mm=6.0,
                wavelength_nm: float = 589.0) -> "HumanEyeCamera":
        return HumanEyeCamera(
            camera_to_world=camera_to_world,
            lens=navarro_eye_stack(pupil_diameter_mm, wavelength_nm),
            resolution=resolution, retina_semi_diam_mm=retina_semi_diam_mm)

    def _retina_point(self, p_film):
        """Raster -> point on the spherical retina: the film square maps to
        a cap of radius retina_radius on the axis. Returns (p, inside)."""
        nx, ny = self.resolution
        semi = self.retina_semi_diam_mm
        sx = (0.5 - p_film[..., 0] * recip(nx)) * 2.0 * semi
        sy = (p_film[..., 1] * recip(ny) - 0.5) * 2.0 * semi
        r = self.retina_radius_mm
        rho2 = sx * sx + sy * sy
        inside = rho2 < (r * r)
        zcap = r - torch.sqrt(torch.clamp((r * r) - rho2, min=1e-6))
        return torch.stack([sx, sy, zcap], dim=-1), inside

    def generate_rays(self, p_film, u_lens, wavelength_nm=None):
        """Returns (o_world, d_world, weight): rays from the retina aimed
        at the iris stop's disk, traced out through the eye."""
        o, inside = self._retina_point(p_film)
        pupil_z, _, _, pupil_ap2, _, _, _ = self.lens.host[1]
        p_disk = (sample_uniform_disk_concentric(u_lens)
                  * float(np.sqrt(pupil_ap2)))
        target = torch.stack([p_disk[..., 0], p_disk[..., 1],
                              torch.full_like(p_disk[..., 0], float(pupil_z))],
                             dim=-1)
        d = normalize(target - o)
        hurb = hurb_noise(p_film, u_lens) if self.diffraction else None
        o_out, d_out, valid = trace_through_stack(
            self.lens, o, d, hurb_noise=hurb,
            wavelength_nm=550.0 if wavelength_nm is None else wavelength_nm)
        o_w = self.camera_to_world.apply_point(o_out)
        d_w = normalize(self.camera_to_world.apply_vector(d_out))
        return o_w, d_w, (valid & inside).to(torch.float32)
