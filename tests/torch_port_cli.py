"""The render CLI's scenes and golden file, shared by
scripts/make_torch_port_golden_cli.py (which runs the JAX package's CLI)
and the port's tests (which run pbrt_tpu_torch's).

The three scenes are tests/test_tools.py's: a quad light over a diffuse
floor, at 16x16 (the image case), 12x12 with no material (the GBuffer
case) and 8x8 (the --debugstart case). The golden cli16.npz holds, at
seed 0:

- "image" (16, 16, 3): the EXR image of `--spp 4 --samples-per-pass 2`
  on IMAGE_SCENE;
- "aov" (12, 12, 13) with "aov_channels", and "spectral" (12, 12, 6):
  the `--gbuffer --spectral-buckets 6` channels of GBUFFER_SCENE at the
  same spp;
- "debug_<key>": the `--debugstart 3,5,1` record of DEBUG_SCENE, one
  array per key of DEBUG_KEYS.

This module imports numpy only.
"""

from __future__ import annotations

import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port", "cli16.npz")

_LIGHT = """LookAt 0.5 0.5 -1.4  0.5 0.5 0.5  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [1 1 1] "float scale" [10]
  Shape "trianglemesh" "point3 P" [0.3 0.99 0.3  0.7 0.99 0.3  0.7 0.99 0.7  0.3 0.99 0.7]
      "integer indices" [0 1 2  0 2 3]
AttributeEnd
"""
_FLOOR = """Shape "trianglemesh" "point3 P" [0 0 0  1 0 0  1 0 1  0 0 1]
    "integer indices" [0 2 1  0 3 2]
WorldEnd
"""


def _film(res: int, sampler: bool = True) -> str:
    text = (f'Film "rgb" "integer xresolution" [{res}] '
            f'"integer yresolution" [{res}]\n')
    if sampler:
        text += 'Sampler "independent" "integer pixelsamples" [4]\n'
    return text


_DIFFUSE = 'Material "diffuse" "rgb reflectance" [0.7 0.7 0.7]\n'
IMAGE_SCENE = _film(16) + _LIGHT + _DIFFUSE + _FLOOR
GBUFFER_SCENE = _film(12, sampler=False) + _LIGHT + _FLOOR
DEBUG_SCENE = _film(8) + _LIGHT + _DIFFUSE + _FLOOR

IMAGE_ARGS = ["--spp", "4", "--samples-per-pass", "2", "--quiet"]
GBUFFER_ARGS = IMAGE_ARGS + ["--gbuffer", "--spectral-buckets", "6"]
DEBUG_ARGS = ["--debugstart", "3,5,1", "--quiet"]
DEBUG_KEYS = ("pixel", "sample", "seed", "ray_o", "ray_d", "lambdas", "L",
              "rgb", "rays")


def write_scene(directory: str, name: str, text: str) -> str:
    path = os.path.join(directory, name)
    with open(path, "w") as f:
        f.write(text)
    return path
