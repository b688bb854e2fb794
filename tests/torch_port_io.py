"""The io scenes' input files, made from a seed and written by either
package's writers (the reference's for the committed files, the port's
for chip_smoke.py's full-width phase e14).

tests/data/torch_port/io/io_surfaces.pbrt and io_smoke.pbrt read these
files by name:

- sky.exr: the image infinite light, float channels, no compression, a
  square (equal-area) map of a graded sky with a sun;
- left.exr (half, ZIP), right.png and back.qoi: the imagemaps on three
  walls of the box;
- floor.ptx (uint16, 2 faces), ceiling.ptx (uint8, 2 faces) and
  cube.ptx (half, 12 faces of 1x1 to `ptex` texels a side, a constant
  face among them): the Ptex textures of io_surfaces;
- wall.ptx (float, 2 faces): io_smoke's back wall;
- smoke.nvdb (ZIP): io_smoke's density, a blob on an (n, n, n) grid
  whose corner leaves hold only the background, so the writer skips
  them.

SMALL is the committed size (every file tens of KB at most). FULL is
e14's: 1024^2 imagemaps, 64^2 Ptex faces and a 128^3 grid; its sky is
128^2, because building an environment map fits a spectrum to every
texel on the host (rgb2spec.fit_unbounded), and a 2048^2 map's 256 times
as many texels would not fit chip_smoke.py's time limit. e14 times the
EXR reader on a 2048^2 half ZIP map (`env_read`) all the same.

This module imports numpy and the named package's io modules only, so
chip_smoke.py can use it without JAX.
"""

from __future__ import annotations

import importlib
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IO_DIR = os.path.join(ROOT, "tests", "data", "torch_port", "io")
SCENES = ("io_surfaces", "io_smoke")
SMALL = dict(env=32, wall=32, ptex=8, vdb=32)
FULL = dict(env=128, wall=1024, ptex=64, vdb=128, env_read=2048)
SEED = 0
# The renders of the goldens; the tests and chip_smoke.py read them back.
IMAGE = dict(resolution=32, spp=4, n_spectrum=8, seed=0)
SAMPLES = dict(resolution=16, spp=2, n_spectrum=8, seed=0)
# Scenes with a scene-level medium, whose entry comparisons across float
# pipelines inset (tests/torch_port_media.py).
INSET = {"io_surfaces": False, "io_smoke": True}


def _pattern(rng, n, lo=0.05, hi=0.95):
    """A smooth (n, n, 3) pattern in [lo, hi]: bands and a checker,
    colours from the seed."""
    y, x = np.meshgrid((np.arange(n) + 0.5) / n, (np.arange(n) + 0.5) / n,
                       indexing="ij")
    c0, c1 = rng.uniform(0.1, 0.9, 3), rng.uniform(0.1, 0.9, 3)
    f = rng.uniform(1.0, 3.0)
    band = 0.5 + 0.5 * np.sin(2 * np.pi * f * (x + 0.5 * y))[..., None]
    check = ((np.floor(x * 4) + np.floor(y * 4)) % 2)[..., None]
    img = c0 * band + c1 * (1 - band) * (0.6 + 0.4 * check)
    return np.clip(img, lo, hi).astype(np.float32)


def _sky(rng, n):
    """A square sky: a vertical grade and a sun, values up to ~4."""
    y, x = np.meshgrid((np.arange(n) + 0.5) / n, (np.arange(n) + 0.5) / n,
                       indexing="ij")
    grade = np.stack([0.3 + 0.5 * y, 0.4 + 0.5 * y, 0.6 + 0.6 * y], -1)
    sx, sy = rng.uniform(0.3, 0.7, 2)
    sun = 4.0 * np.exp(-((x - sx) ** 2 + (y - sy) ** 2) / 0.004)[..., None]
    return (grade + sun * np.asarray([1.0, 0.9, 0.7])).astype(np.float32)


def _faces(rng, count, side, const=()):
    """Ptex faces with sides `side`, side / 2, ... 1 in turn; faces named
    in `const` hold one colour."""
    sides = [side >> (i % (int(np.log2(side)) + 1)) for i in range(count)]
    out = []
    for i, s in enumerate(sides):
        if i in const:
            out.append(np.broadcast_to(rng.uniform(0.1, 0.9, 3).astype(
                np.float32), (4, 4, 3)).copy())
        else:
            out.append(_pattern(rng, s))
    return out


def _density(n):
    """A blob on an (n, n, n) grid, [z][y][x], quantized to 1/64, zero in
    the corners."""
    c = (np.arange(n) + 0.5) / n
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.45) ** 2 + (z - 0.5) ** 2)
    d = np.clip(1.0 - r / 0.42, 0.0, 1.0) ** 0.7
    d *= 0.75 + 0.25 * np.sin(9.0 * x) * np.cos(7.0 * z)
    return (np.round(np.clip(d, 0.0, 1.0) * 64.0) / 64.0).astype(np.float32)


def make_inputs(size: dict, seed: int = SEED) -> dict:
    """The arrays of every input file at `size` (SMALL or FULL)."""
    rng = np.random.default_rng(seed)
    n = size["wall"]
    return {
        "sky": _sky(rng, size["env"]),
        "left": _pattern(rng, n, 0.05, 1.5),
        "right": _pattern(rng, n),
        "back": _pattern(rng, n),
        "floor": _faces(rng, 2, size["ptex"]),
        "ceiling": _faces(rng, 2, size["ptex"]),
        "cube": _faces(rng, 12, size["ptex"], const=(5,)),
        "wall": _faces(rng, 2, size["ptex"]),
        "smoke": _density(size["vdb"]),
    }


def write_inputs(pkg: str, out_dir: str, size: dict,
                 seed: int = SEED) -> dict:
    """Write every input file into out_dir with `pkg`'s writers ("pbrt_tpu"
    or "pbrt_tpu_torch"). Returns each file's writer seconds."""
    image = importlib.import_module(pkg + ".io.image")
    ptex = importlib.import_module(pkg + ".io.ptex")
    nanovdb = importlib.import_module(pkg + ".io.nanovdb")
    arrays = make_inputs(size, seed)
    n = size["vdb"]
    grid = nanovdb.NVDBGrid(name="density", values=arrays["smoke"],
                            ijk_min=np.asarray([-n // 2, 0, -n // 2]),
                            voxel_size=np.full(3, 1.0 / n))
    writes = {
        "sky.exr": lambda p: image.write_exr(p, arrays["sky"],
                                             compression="none"),
        "left.exr": lambda p: image.write_exr(p, arrays["left"],
                                              compression="zip", half=True),
        "right.png": lambda p: image.write_png(p, arrays["right"]),
        "back.qoi": lambda p: image.write_qoi(p, arrays["back"]),
        "floor.ptx": lambda p: ptex.write_ptex(p, arrays["floor"],
                                               datatype=ptex.DT_UINT16),
        "ceiling.ptx": lambda p: ptex.write_ptex(p, arrays["ceiling"],
                                                 datatype=ptex.DT_UINT8),
        "cube.ptx": lambda p: ptex.write_ptex(p, arrays["cube"],
                                              datatype=ptex.DT_HALF),
        "wall.ptx": lambda p: ptex.write_ptex(p, arrays["wall"],
                                              datatype=ptex.DT_FLOAT),
        "smoke.nvdb": lambda p: nanovdb.write_nanovdb(p, grid, codec="zip"),
    }
    seconds = {}
    for name, write in writes.items():
        t0 = time.perf_counter()
        write(os.path.join(out_dir, name))
        seconds[name] = time.perf_counter() - t0
    return seconds


def read_inputs(pkg: str, in_dir: str) -> dict:
    """Read every input file back with `pkg`'s readers, as the parser
    does. Returns {file: (value, reader seconds)}."""
    image = importlib.import_module(pkg + ".io.image")
    ptex = importlib.import_module(pkg + ".io.ptex")
    nanovdb = importlib.import_module(pkg + ".io.nanovdb")
    out = {}
    for name in sorted(os.listdir(in_dir)):
        path = os.path.join(in_dir, name)
        t0 = time.perf_counter()
        if name.endswith((".exr", ".png", ".qoi")):
            val = image.read_image_rgb(path)
        elif name.endswith(".ptx"):
            val = ptex.read_ptex(path)[0]
        elif name.endswith(".nvdb"):
            val = nanovdb.read_nanovdb(path, "density")
        else:
            continue
        out[name] = (val, time.perf_counter() - t0)
    return out
