"""The instanced-field scene file and the PLY prototypes it references,
written by either package from its own mesh builders.

tests/data/torch_port/instanced_field.pbrt places 36 instances of
"blob.ply" and "knot.ply"; the meshes are made at run time, at full size
(the card's check and the golden) or small (the CPU tests), with the same
file.
"""

from __future__ import annotations

import importlib
import os

import numpy as np

FIELD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "torch_port", "instanced_field.pbrt")
# (fbm_blob subdivisions, torus_knot nu, nv): 81,920 + 40,320 triangles at
# full size; 1,280 + 720 small.
FULL = (6, 420, 48)
SMALL = (3, 60, 6)


def write_field_meshes(pkg: str, directory: str, size=FULL) -> None:
    """Write blob.ply and knot.ply into `directory` with `pkg`'s
    ("pbrt_tpu" or "pbrt_tpu_torch") fbm_blob, torus_knot and write_ply,
    as shared-vertex meshes (vertices rounded to 1e-6 and merged)."""
    meshes = importlib.import_module(f"{pkg}.scenes.meshes")
    ply = importlib.import_module(f"{pkg}.io.ply")
    subdiv, nu, nv = size
    parts = {
        "blob": meshes.fbm_blob(subdiv, radius=0.62, center=(0.0, 0.72, 0.0)),
        "knot": meshes.torus_knot(2, 3, tube=0.1, scale=0.55, nu=nu, nv=nv,
                                  center=(0.0, 0.6, 0.0)),
    }
    for name, tris in parts.items():
        flat = np.asarray(tris, np.float32).reshape(-1, 3)
        verts, inv = np.unique(flat.round(6), axis=0, return_inverse=True)
        ply.write_ply(os.path.join(directory, f"{name}.ply"), verts,
                      inv.reshape(-1, 3).astype(np.int32))


def field_text() -> str:
    with open(FIELD) as f:
        return f.read()
