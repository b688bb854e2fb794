"""Flat material parameter tables (port of pbrt_tpu/materials/buffers.py).

Every field of the reference is carried, so a converted JAX scene maps 1:1.
Every family of the reference is shaded (materials/bxdf.py): a mix row
resolves to one of its two sub-materials per ray before the gather, and
the subsurface step of models/path.py moves a subsurface lane's vertex
before it shades with the normalized-Fresnel lobe. RGB parameters are
stored as sigmoid-polynomial coefficients fitted on the host
(core/rgb2spec.py); a row's `albedo_tex` binds a texture
(textures/buffers.py) that overrides them per ray. The measured rows'
tables (materials/measured.py) are stacked, fitted per cell, and a row's
`measured_idx` names its table.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import rgb2spec
from ..core.take import take
from ..core.tensorclass import static_field, tensorclass

MAT_DIFFUSE = 0
MAT_CONDUCTOR = 1
MAT_DIELECTRIC = 2
MAT_THINDIELECTRIC = 3
MAT_COATEDDIFFUSE = 4
MAT_COATEDCONDUCTOR = 5
MAT_DIFFUSETRANS = 6
MAT_HAIR = 7
MAT_SUBSURFACE = 8
MAT_MEASURED = 9
MAT_MIX = 10
MAT_RETRO = 11
MAT_INTERFACE = 12
MAT_NORMFRESNEL = 13

# RGB projections of measured metal IOR spectra (eta, k).
CONDUCTOR_PRESETS = {
    "Cu": ((0.2004, 0.9240, 1.1022), (3.9129, 2.4476, 2.1422)),
    "Au": ((0.1431, 0.3749, 1.4424), (3.9831, 2.3857, 1.6032)),
    "Ag": ((0.1553, 0.1163, 0.1381), (4.8284, 3.1222, 2.1469)),
    "Al": ((1.3450, 0.9650, 0.6170), (7.4746, 6.3995, 5.3031)),
}


def _measured_stack(tables):
    """The stacked per-cell fits of the measured rows' tables."""
    from .measured import N_PD, N_TD, N_TH, MeasuredBRDF

    if not tables:
        return dict(
            measured_coeffs=torch.zeros((0, N_TH, N_TD, N_PD, 3)),
            measured_scale=torch.zeros((0, N_TH, N_TD, N_PD)),
        )
    ms = [MeasuredBRDF.from_table(t) for t in tables]
    return dict(
        measured_coeffs=torch.stack([m.coeffs for m in ms]),
        measured_scale=torch.stack([m.scale for m in ms]),
    )


@tensorclass
class MaterialBuffers:
    kind: torch.Tensor  # (M,) int32 dispatch tag
    albedo_coeffs: torch.Tensor  # (M, 3) sigmoid coeffs of reflectance
    roughness: torch.Tensor  # (M,)
    eta: torch.Tensor  # (M,)
    cond_eta_coeffs: torch.Tensor  # (M, 3)
    cond_eta_scale: torch.Tensor  # (M,)
    cond_k_coeffs: torch.Tensor  # (M, 3)
    cond_k_scale: torch.Tensor  # (M,)
    albedo_tex: torch.Tensor  # (M,) int32, -1 = constant
    coat_roughness: torch.Tensor  # (M,)
    trans_coeffs: torch.Tensor  # (M, 3)
    hair_sigma_coeffs: torch.Tensor  # (M, 3)
    hair_sigma_scale: torch.Tensor  # (M,)
    hair_alpha: torch.Tensor  # (M,)
    thickness: torch.Tensor  # (M,)
    ss_mfp_coeffs: torch.Tensor  # (M, 3)
    ss_mfp_scale: torch.Tensor  # (M,)
    measured_idx: torch.Tensor  # (M,) int32, -1 = none
    mix_m0: torch.Tensor  # (M,) int32
    mix_m1: torch.Tensor  # (M,) int32
    mix_amount: torch.Tensor  # (M,)
    measured_coeffs: torch.Tensor  # (Mm, 32, 32, 16, 3)
    measured_scale: torch.Tensor  # (Mm, 32, 32, 16)
    med_inside: torch.Tensor  # (M,) int32
    med_outside: torch.Tensor  # (M,) int32
    any_conductor: bool = static_field(default=False)
    any_dielectric: bool = static_field(default=False)
    any_thin: bool = static_field(default=False)
    any_coated: bool = static_field(default=False)
    any_diffusetrans: bool = static_field(default=False)
    any_hair: bool = static_field(default=False)
    any_subsurface: bool = static_field(default=False)
    any_measured: bool = static_field(default=False)
    any_mix: bool = static_field(default=False)
    any_retro: bool = static_field(default=False)
    any_interface_mat: bool = static_field(default=False)

    @staticmethod
    def build(materials) -> "MaterialBuffers":
        """materials: list of dicts with keys kind, albedo (rgb), roughness,
        eta, conductor ("Cu"/"Au"/"Ag"/"Al" or (eta_rgb, k_rgb) pair)."""
        tables = [m["measured_table"] for m in materials
                  if m.get("measured_table") is not None]
        meas_idx, n_tab = [], 0
        for m in materials:
            has = m.get("measured_table") is not None
            meas_idx.append(n_tab if has else -1)
            n_tab += has
        kinds = [m.get("kind", MAT_DIFFUSE) for m in materials]
        conds = []
        for m in materials:
            cond = m.get("conductor", "Cu")
            conds.append(CONDUCTOR_PRESETS[cond] if isinstance(cond, str) else cond)

        def col(key, default):
            return [m.get(key, default) for m in materials]

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32))

        def i32(x):
            return torch.as_tensor(np.asarray(x, np.int32))

        ce, ces = rgb2spec.fit_unbounded([c[0] for c in conds])
        ck, cks = rgb2spec.fit_unbounded([c[1] for c in conds])
        hs, hss = rgb2spec.fit_unbounded(col("hair_sigma_a", (0.5447, 0.9061, 1.781)))
        ms, mss = rgb2spec.fit_unbounded(col("mfp", (1.0, 1.0, 1.0)))
        return MaterialBuffers(
            kind=i32(kinds),
            albedo_coeffs=rgb2spec.fit_albedo(col("albedo", (0.5, 0.5, 0.5))),
            roughness=f32(col("roughness", 0.0)),
            eta=f32(col("eta", 1.5)),
            cond_eta_coeffs=ce,
            cond_eta_scale=ces,
            cond_k_coeffs=ck,
            cond_k_scale=cks,
            albedo_tex=i32(col("albedo_texture", -1)),
            coat_roughness=f32(col("coat_roughness", 0.05)),
            trans_coeffs=rgb2spec.fit_albedo(col("transmittance", (0.25, 0.25, 0.25))),
            hair_sigma_coeffs=hs,
            hair_sigma_scale=hss,
            hair_alpha=f32(col("hair_alpha", 2.0)),
            thickness=f32(col("thickness", 0.01)),
            ss_mfp_coeffs=ms,
            ss_mfp_scale=mss,
            measured_idx=i32(meas_idx),
            mix_m0=i32(col("mix_m0", 0)),
            mix_m1=i32(col("mix_m1", 0)),
            mix_amount=f32(col("mix_amount", 0.5)),
            **_measured_stack(tables),
            med_inside=i32(col("med_inside", -2)),
            med_outside=i32(col("med_outside", -2)),
            any_conductor=any(
                k in (MAT_CONDUCTOR, MAT_COATEDCONDUCTOR) for k in kinds
            ),
            any_dielectric=MAT_DIELECTRIC in kinds,
            any_thin=MAT_THINDIELECTRIC in kinds,
            any_coated=any(
                k in (MAT_COATEDDIFFUSE, MAT_COATEDCONDUCTOR) for k in kinds
            ),
            any_diffusetrans=MAT_DIFFUSETRANS in kinds,
            any_hair=MAT_HAIR in kinds,
            any_subsurface=MAT_SUBSURFACE in kinds,
            any_measured=MAT_MEASURED in kinds,
            any_mix=MAT_MIX in kinds,
            any_retro=MAT_RETRO in kinds,
            any_interface_mat=MAT_INTERFACE in kinds,
        )

    def gather(self, mat_idx):
        """Per-ray material parameters: a dict of (N, ...) rows."""
        out = {
            name: take(getattr(self, name), mat_idx)
            for name in (
                "kind", "albedo_coeffs", "roughness", "eta",
                "cond_eta_coeffs", "cond_eta_scale", "cond_k_coeffs",
                "cond_k_scale", "albedo_tex", "coat_roughness",
                "trans_coeffs", "hair_sigma_coeffs", "hair_sigma_scale",
                "hair_alpha", "thickness", "ss_mfp_coeffs", "ss_mfp_scale",
                "measured_idx",
            )
        }
        out["measured_coeffs"] = self.measured_coeffs
        out["measured_scale"] = self.measured_scale
        out["any_conductor"] = self.any_conductor
        out["any_dielectric"] = self.any_dielectric
        out["any_thin"] = self.any_thin
        return out
