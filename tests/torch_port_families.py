"""The families box of the port's tests, its golden script and
chip_smoke.py: tests/data/torch_port/families.pbrt, a box after
tests/goldens/box.pbrt whose surfaces carry the five material families
of the reference's item-10 slice (hair, subsurface, measured from an RGL
.bsdf file, mix and retroreflective), triangles only, so that every query
of a pass (the subsurface probes included) is the small-scene tier's.

`write_bsdf` writes the small synthetic isotropic .bsdf file the left
wall reads (families.bsdf, committed beside the scene), in the layout of
tests/test_rgl.py: no measured asset ships with the repository.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
FAMILIES_PBRT = os.path.join(DATA, "families.pbrt")
FAMILIES_BSDF = os.path.join(DATA, "families.bsdf")

# A subsurface floor under a light, rendered with the volumetric path:
# the reference's volpath has no subsurface step, so its kind-8 lanes
# shade with the normalized-Fresnel lobe through the BxDF chain
# (kind8_volpath8_samples.npz, scripts/make_torch_port_golden_families.py).
SUBSURFACE_VOLPATH = """
Integrator "volpath" "integer maxdepth" 3
Film "rgb" "integer xresolution" 8 "integer yresolution" 8
LookAt 0 2 4  0 0 0  0 1 0
Camera "perspective" "float fov" 45
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [8 8 8]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-0.5 3 -0.5  0.5 3 -0.5  0.5 3 0.5  -0.5 3 0.5]
AttributeEnd
Material "subsurface" "float eta" 1.33 "rgb mfp" [0.1 0.2 0.3]
  "rgb reflectance" [0.8 0.6 0.4]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [-2 0 -2  2 0 -2  2 0 2  -2 0 2]
"""


def write_bsdf(path: str, write_tensor_file) -> None:
    """A synthetic isotropic RGL file: sigma constant, an ndf rising with
    u_x, a vndf of density 1 + x (a non-trivial warp) and spectra
    S(lam) G(u_x) that redden the reflection; 8x8 grids over 4 theta_i
    nodes and 3 wavelengths (~10 KB). write_tensor_file is either
    package's writer."""
    n_t, n_p, n_w, res = 4, 2, 3, 8
    xs = np.linspace(0, 1, res)
    wavelengths = np.linspace(400, 700, n_w).astype(np.float32)
    vndf = np.broadcast_to(1.0 + xs, (n_p, n_t, res, res))
    s_l = 0.3 + 0.6 * (wavelengths - 400.0) / 300.0
    spectra = (s_l[None, None, :, None, None]
               * (0.2 + 0.8 * xs)[None, None, None, None, :]
               * np.ones((n_p, n_t, 1, res, 1)))
    write_tensor_file(path, {
        "theta_i": np.linspace(0, np.pi / 2, n_t).astype(np.float32),
        "phi_i": np.asarray([-np.pi, np.pi], np.float32),
        "wavelengths": wavelengths,
        "ndf": np.tile(0.5 + xs ** 2, (res, 1)).astype(np.float32),
        "sigma": np.full((res, res), 0.25, np.float32),
        "vndf": vndf.astype(np.float32).copy(),
        "spectra": spectra.astype(np.float32),
        "luminance": spectra[:, :, 1].astype(np.float32).copy(),
        "description": np.frombuffer(b"families box", np.uint8),
        "jacobian": np.zeros(1, np.uint8),
    })


# The grid the mix hash's inputs are rounded to in cross-pipeline
# comparisons (1/256 of a scene unit; of a unit direction's component).
COARSE_MIX_GRID = 256.0


def _coarse(x, rnd):
    """x rounded to the grid; + 0.0 turns -0.0 into +0.0."""
    return rnd(x * COARSE_MIX_GRID) / COARSE_MIX_GRID + 0.0


class _CoarseLax:
    """jax.lax as the reference's surface_params sees it inside
    `coarse_mix_keys`: it bitcasts the rounded values."""

    def __init__(self, lax):
        self._lax = lax

    def bitcast_convert_type(self, x, dtype):
        import jax.numpy as jnp

        return self._lax.bitcast_convert_type(_coarse(x, jnp.round), dtype)

    def __getattr__(self, name):
        return getattr(self._lax, name)


class _CoarseJax:
    def __init__(self, jax):
        self._jax = jax
        self.lax = _CoarseLax(jax.lax)

    def __getattr__(self, name):
        return getattr(self._jax, name)


@contextlib.contextmanager
def coarse_mix_keys(*bxdf_modules):
    """Within the block, each given `materials.bxdf` module (the
    reference's or the port's) keys the mix materials' hash on the hit
    point and wo rounded to a grid of 1/256. (Any module that hashes
    float bits through the port's `_bits` or the reference's inline
    bitcast takes the same shim: tests/torch_port_shapes.py's
    coarse_alpha_keys.)

    The hash reads the bit patterns of p and wo, and two float pipelines
    round the hit point (t of the triangle test) and the directions
    differently in the last bit. On the floor, p.y is rounding noise about
    0, whose bits (sign and exponent included) differ between pipelines on
    most lanes: 15 of the 66 floor lanes of a 16x16, 2 spp pass take the
    other sub-material against the reference (keeping each component's top
    16 bits, as the layered walk's coarse keys do, leaves 8). Rounded to
    the grid, a lane re-keys only where a component lies within a few ulps
    of a half-step. Whole-render comparisons across pipelines therefore
    run inside this block in both packages; the exact keys are held bit
    for bit at op level and by the share of lanes each sub-material takes
    (tests/test_torch_families.py). The reference's hash bitcasts inline,
    so its module's `jax` is swapped for a shim whose
    lax.bitcast_convert_type rounds first; the port's `_bits` is wrapped.
    A JAX trace must be made inside the block to see it. This module
    imports numpy and torch only, so chip_smoke.py can use it."""
    saved = []
    try:
        for m in bxdf_modules:
            if hasattr(m, "_bits"):  # the port's
                saved.append((m, "_bits", m._bits))
                bits = m._bits
                m._bits = lambda x, bits=bits: bits(_coarse(x, torch.round))
            else:
                saved.append((m, "jax", m.jax))
                m.jax = _CoarseJax(m.jax)
        yield
    finally:
        for m, name, value in saved:
            setattr(m, name, value)
