"""Shared pieces of the tests that hold the port's coated materials and the
many-light hall against the reference: the coated Cornell box, built by
each package from its own builders, and the coarse walk keys.

The layered walk (materials/layered.py of both packages) keys its random
numbers on the bit patterns of wo and wi. Two float pipelines (XLA on the
CPU and PyTorch, or PyTorch on the CPU and on the card) round directions
differently in the last bit on about a third of the lanes (rsqrt and
three-term dot products), and each such lane's walk then draws other
numbers: another, equally valid estimate. Comparisons of whole renders
across pipelines therefore key the walk on each component's top 16 bits
(sign, exponent and 7 mantissa bits), in both packages alike
(`coarse_walk_keys`): a difference of a few ulps then re-keys a lane
with probability about 2^-16 instead of 1. (With 12 bits cleared, the
coated Cornell box still re-keyed 2 of 512 samples against the reference
and 9 of 768 pixel values between the card and the CPU.) The keys
themselves are held bit for bit at op level (tests/test_torch_coated.py).
This module imports numpy and torch only, so chip_smoke.py can use it.
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch

# The walk's key bits kept in cross-pipeline comparisons.
COARSE_KEY_MASK = 0xFFFF0000


@contextlib.contextmanager
def coarse_walk_keys(*layered_modules):
    """Within the block, each given `materials.layered` module (the
    reference's or the port's) keys its walk on
    `_bits(x) & COARSE_KEY_MASK`. A JAX trace must be made inside the
    block to see it."""
    saved = [(m, m._bits) for m in layered_modules]

    def coarse(bits):
        def masked(x):
            b = bits(x)
            if isinstance(b, torch.Tensor):
                return b & COARSE_KEY_MASK
            return b & np.uint32(COARSE_KEY_MASK)
        return masked

    try:
        for m, bits in saved:
            m._bits = coarse(bits)
        yield
    finally:
        for m, bits in saved:
            m._bits = bits


def coated_cornell(pkg: str, resolution=(16, 16)):
    """The Cornell box of `pkg` ("pbrt_tpu" or "pbrt_tpu_torch") with
    tests/test_layered.py's materials (a coated-diffuse white, the red and
    green walls) and a coated gold conductor on the tall box. Returns
    (scene, camera), no accelerator attached."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    mb = mod("materials.buffers")
    scene, camera = mod("scenes.cornell").cornell_box(resolution=resolution)
    mats = [
        {"kind": mb.MAT_COATEDDIFFUSE, "albedo": (0.7, 0.7, 0.7),
         "roughness": 0.2, "coat_roughness": 0.05, "thickness": 0.05},
        {"kind": mb.MAT_DIFFUSE, "albedo": (0.65, 0.05, 0.05)},
        {"kind": mb.MAT_DIFFUSE, "albedo": (0.12, 0.45, 0.15)},
        {"kind": mb.MAT_COATEDCONDUCTOR, "conductor": "Au", "roughness": 0.1,
         "coat_roughness": 0.08, "thickness": 0.02},
    ]
    # The tall box: the last box of cornell_box, before the two light
    # triangles.
    n_box = len(mod("shapes.geometry").make_box((0, 0, 0), (1, 1, 1)))
    tri_mat = np.array(np.asarray(scene.geom.tri_mat), np.int32)
    n_tri = tri_mat.shape[0]
    tri_mat[n_tri - 2 - n_box:n_tri - 2] = 3
    if pkg == "pbrt_tpu":
        import jax.numpy as jnp

        tri_mat = jnp.asarray(tri_mat)
    else:
        tri_mat = torch.from_numpy(tri_mat)
    scene = scene.replace(geom=scene.geom.replace(tri_mat=tri_mat),
                          materials=mb.MaterialBuffers.build(mats))
    return scene, camera
