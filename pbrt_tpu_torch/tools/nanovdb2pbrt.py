#!/usr/bin/env python
"""nanovdb2pbrt — convert a NanoVDB float grid to pbrt grid-medium text.

Port of pbrt_tpu/tools/nanovdb2pbrt.py (numpy on the host, the port's
NanoVDB reader).

Behavioral analogue of the reference's cmd/nanovdb2pbrt.cpp: extract the
named FogVolume grid dense over its index bounding box, optionally 2x
box-downsample it n times (trimming the resolution — and the world bounds
with it — to a multiple of 2^n), and print the "integer nx/ny/nz",
"point3 p0/p1" and "float <grid>" parameter text ready to paste into a
MakeNamedMedium "uniformgrid" block.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def convert(grid, downsample: int = 0) -> str:
    """Return the pbrt parameter text for an NVDBGrid."""
    vals = np.asarray(grid.values, np.float64)  # (nz, ny, nx)
    nz, ny, nx = vals.shape
    p0 = np.asarray(grid.world_min, np.float64).copy()
    p1 = np.asarray(grid.world_max, np.float64).copy()

    def trim(n, lo, hi, axis):
        """Trim resolution to a multiple of 2^downsample, alternating
        low/high so the kept region stays centered (reference `round`)."""
        mult = 1 << downsample
        a, b = 0, n
        delta = (hi - lo) / max(n, 1)
        while (b - a) % mult:
            a += 1
            lo += delta
            if (b - a) % mult:
                b -= 1
                hi -= delta
        return a, b, lo, hi

    z0, z1, p0[2], p1[2] = trim(nz, p0[2], p1[2], 0)
    y0, y1, p0[1], p1[1] = trim(ny, p0[1], p1[1], 1)
    x0, x1, p0[0], p1[0] = trim(nx, p0[0], p1[0], 2)
    vals = vals[z0:z1, y0:y1, x0:x1]

    for _ in range(downsample):
        nz2, ny2, nx2 = (s // 2 for s in vals.shape)
        vals = vals.reshape(nz2, 2, ny2, 2, nx2, 2).mean(axis=(1, 3, 5))

    nz, ny, nx = vals.shape
    lines = [
        f'"integer nx" {nx} "integer ny" {ny}  "integer nz" {nz}',
        '\t"point3 p0" [ %f %f %f ] "point3 p1" [ %f %f %f ]'
        % (p0[0], p0[1], p0[2], p1[0], p1[1], p1[2]),
        f'\t"float {grid.name}" [',
    ]
    flat = vals.ravel()
    row = []
    for i, d in enumerate(flat):
        row.append("0" if d == 0 else "%f" % d)
        if (i % 20) == 19:
            lines.append(" ".join(row) + " ")
            row = []
    lines.append(" ".join(row) + (" " if row else "") + "]")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nanovdb2pbrt", description=__doc__.splitlines()[0]
    )
    ap.add_argument("filename", help=".nvdb input file")
    ap.add_argument(
        "--downsample", type=int, default=0,
        help="number of times to 2x downsample the volume (default 0)",
    )
    ap.add_argument(
        "--grid", default="density",
        help='name of grid to extract (default "density")',
    )
    args = ap.parse_args(argv)

    from ..io.nanovdb import read_nanovdb

    try:
        grid = read_nanovdb(args.filename, args.grid)
    except (OSError, ValueError, KeyError) as e:
        print(f"nanovdb2pbrt: {e}", file=sys.stderr)
        return 1
    print(convert(grid, args.downsample))
    return 0


if __name__ == "__main__":
    sys.exit(main())
