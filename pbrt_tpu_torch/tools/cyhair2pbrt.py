"""cyhair2pbrt: convert Cem Yuksel .hair files to pbrt curve shapes.

Port of pbrt_tpu/tools/cyhair2pbrt.py (numpy on the host).

Reference analogue: pbrt-v4 src/pbrt/cmd/cyhair2pbrt.cpp. The HAIR
binary format: 128-byte header (magic "HAIR", num_strands, total_points,
flags, default_segments, default_thickness, default_transparency,
default_color[3], 88-byte info), then optional arrays gated by flags bits —
0x1 per-strand segment counts (u16), 0x2 xyz float points, 0x4 per-point
thickness, 0x8 transparency, 0x10 rgb colors.

Strand control points are Catmull-Rom; each span converts to a cubic Bezier
(Q1 = P1 + (P2 - P0)/6, Q2 = P2 - (P3 - P1)/6, one-sided differences at
strand ends — the tool's toC2B matrices). Points swap z-up -> y-up like the
reference. Divergence: we emit every span with per-point widths where
available (the reference skips endpoint spans and uses constant thickness).
"""

from __future__ import annotations

import argparse
import struct
import sys

import numpy as np

_HEADER = struct.Struct("<4sIIIIff3f88s")


def read_cyhair(path: str):
    """Returns (strands, thicknesses): lists of (n_i, 3) point arrays and
    (n_i,) per-point radii."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < _HEADER.size or raw[:4] != b"HAIR":
        raise ValueError(f"not a CyHair file: {path}")
    (_, n_strands, total_points, flags, def_segments, def_thickness,
     _def_transp, _r, _g, _b, _info) = _HEADER.unpack_from(raw, 0)
    off = _HEADER.size
    has_segments = bool(flags & 0x1)
    has_points = bool(flags & 0x2)
    has_thickness = bool(flags & 0x4)
    has_transparency = bool(flags & 0x8)
    has_color = bool(flags & 0x10)
    if not has_points:
        raise ValueError("CyHair file has no point data")
    if has_segments:
        segments = np.frombuffer(raw, "<u2", n_strands, off).astype(np.int64)
        off += 2 * n_strands
    else:
        if def_segments < 1:
            raise ValueError("CyHair file has no segment information")
        segments = np.full(n_strands, def_segments, np.int64)
    points = np.frombuffer(raw, "<f4", 3 * total_points, off).reshape(-1, 3)
    off += 12 * total_points
    if has_thickness:
        thickness = np.frombuffer(raw, "<f4", total_points, off)
        off += 4 * total_points
    else:
        thickness = np.full(total_points, def_thickness, np.float32)
    if has_transparency:
        off += 4 * total_points  # parsed for completeness, unused
    if has_color:
        off += 12 * total_points
    counts = segments + 1
    ends = np.cumsum(counts)
    starts = ends - counts
    strands = [points[s:e] for s, e in zip(starts, ends)]
    thicks = [thickness[s:e] for s, e in zip(starts, ends)]
    return strands, thicks


def catmullrom_to_beziers(pts: np.ndarray) -> np.ndarray:
    """(n, 3) Catmull-Rom control points -> (n-1, 4, 3) cubic Beziers."""
    n = pts.shape[0]
    if n < 2:
        return np.zeros((0, 4, 3), np.float32)
    # One-sided differences at the ends (clamped CR tangents).
    prev = np.concatenate([pts[:1], pts[:-1]], 0)
    nxt = np.concatenate([pts[1:], pts[-1:]], 0)
    tan = (nxt - prev) / 6.0 * np.where(
        (np.arange(n) == 0) | (np.arange(n) == n - 1), 2.0, 1.0
    )[:, None]
    q0 = pts[:-1]
    q3 = pts[1:]
    q1 = q0 + tan[:-1]
    q2 = q3 - tan[1:]
    return np.stack([q0, q1, q2, q3], axis=1).astype(np.float32)


def convert(hair_path: str, out, max_strands: int = -1,
            thickness: float = -1.0, scale=(1.0, 1.0, 1.0),
            translate=(0.0, 0.0, 0.0)) -> int:
    """Write pbrt curve shapes; returns the number of spans emitted."""
    strands, thicks = read_cyhair(hair_path)
    if max_strands > 0:
        strands = strands[:max_strands]
        thicks = thicks[:max_strands]
    scale = np.asarray(scale, np.float32)
    translate = np.asarray(translate, np.float32)
    out.write(f'# Converted from "{hair_path}" by cyhair2pbrt\n')
    out.write(f"# strands = {len(strands)}\n\n")
    n_spans = 0
    for pts, th in zip(strands, thicks):
        if pts.shape[0] < 2:
            continue
        pts = pts[:, [0, 2, 1]] * scale[None] + translate[None]  # z-up->y-up
        bez = catmullrom_to_beziers(pts)
        for k in range(bez.shape[0]):
            w0 = thickness if thickness > 0 else float(th[k])
            w1 = thickness if thickness > 0 else float(th[k + 1])
            flat = " ".join(f"{v:.6g}" for v in bez[k].reshape(-1))
            out.write(
                f'Shape "curve" "string type" [ "cylinder" ] '
                f'"point3 P" [ {flat} ] '
                f'"float width0" [ {w0:.6g} ] "float width1" [ {w1:.6g} ]\n'
            )
            n_spans += 1
    return n_spans


def main(argv=None):
    p = argparse.ArgumentParser(prog="cyhair2pbrt")
    p.add_argument("hairfile")
    p.add_argument("output", help="'-' for stdout")
    p.add_argument("maxstrands", nargs="?", type=int, default=-1)
    p.add_argument("thickness", nargs="?", type=float, default=-1.0)
    args = p.parse_args(argv)
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        n = convert(args.hairfile, out, args.maxstrands, args.thickness)
    finally:
        if out is not sys.stdout:
            out.close()
    print(f"Converted {n} curve spans.", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
