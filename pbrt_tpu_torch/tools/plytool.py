"""plytool: PLY mesh inspection and processing.

Port of pbrt_tpu/tools/plytool.py (numpy on the host, the port's PLY
and image readers).

Reference analogue: pbrt-v4 src/pbrt/cmd/plytool.cpp. Commands:

  info <file.ply ...>
      Vertex/face counts, bounding box, edge-length stats.

  cat <file.ply>
      Print the mesh as a pbrt `Shape "trianglemesh"` directive.

  displace --image <img> --scale <s> [--uvscale <u>] <in.ply> <out.ply>
      Displace vertices along their (area-weighted) vertex normals by the
      displacement image sampled with planar-projected UVs, then rewrite.
      (The reference requires UVs in the PLY; this build's PLY reader keeps
      positions+faces, so UVs are synthesized by bounding-box projection —
      documented divergence.)

  split --maxfaces <n> <in.ply>
      Split a large mesh into <in>-NNN.ply chunks of at most n faces each
      (vertices deduplicated per chunk).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..io.ply import read_ply, write_ply


def _vertex_normals(verts, faces):
    """Area-weighted vertex normals."""
    v = verts[faces]  # (F, 3, 3)
    fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])  # 2*area-weighted
    n = np.zeros_like(verts)
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(ln, 1e-20)


def cmd_info(args):
    for path in args.files:
        verts, faces = read_ply(path)
        lo, hi = verts.min(0), verts.max(0)
        e = verts[faces]
        el = np.concatenate([
            np.linalg.norm(e[:, 1] - e[:, 0], axis=-1),
            np.linalg.norm(e[:, 2] - e[:, 1], axis=-1),
            np.linalg.norm(e[:, 0] - e[:, 2], axis=-1),
        ])
        print(f"{path}: {len(verts)} vertices, {len(faces)} triangles")
        print(f"  bounds: [{lo[0]:g} {lo[1]:g} {lo[2]:g}] - "
              f"[{hi[0]:g} {hi[1]:g} {hi[2]:g}]")
        print(f"  edge length: min {el.min():g} mean {el.mean():g} "
              f"max {el.max():g}")


def cmd_cat(args):
    verts, faces = read_ply(args.file)
    print('Shape "trianglemesh"')
    print('  "point3 P" [')
    for v in verts:
        print(f"    {v[0]:g} {v[1]:g} {v[2]:g}")
    print("  ]")
    print('  "integer indices" [')
    for f in faces:
        print(f"    {f[0]} {f[1]} {f[2]}")
    print("  ]")


def cmd_displace(args):
    from ..io.image import read_image_rgb

    verts, faces = read_ply(args.input)
    img = np.asarray(read_image_rgb(args.image), np.float32)
    if img.ndim == 3:
        img = img.mean(-1)
    h, w = img.shape
    n = _vertex_normals(verts, faces)
    # Planar-projected UVs over the two largest bbox axes.
    ext = verts.max(0) - verts.min(0)
    axes = np.argsort(ext)[-2:]
    uv = (verts[:, axes] - verts.min(0)[axes]) / np.maximum(
        ext[axes], 1e-20
    )
    uv = (uv * args.uvscale) % 1.0
    xi = np.clip((uv[:, 0] * (w - 1)).astype(np.int64), 0, w - 1)
    yi = np.clip((uv[:, 1] * (h - 1)).astype(np.int64), 0, h - 1)
    disp = img[yi, xi] * args.scale
    write_ply(args.output, verts + n * disp[:, None], faces)
    print(f"{args.input} -> {args.output}: displaced {len(verts)} vertices "
          f"(scale {args.scale})")


def cmd_split(args):
    verts, faces = read_ply(args.input)
    base, _ = os.path.splitext(args.input)
    nchunks = (len(faces) + args.maxfaces - 1) // args.maxfaces
    for i in range(nchunks):
        chunk = faces[i * args.maxfaces: (i + 1) * args.maxfaces]
        used = np.unique(chunk)
        remap = np.full(len(verts), -1, np.int64)
        remap[used] = np.arange(len(used))
        out = f"{base}-{i:03d}.ply"
        write_ply(out, verts[used], remap[chunk])
        print(f"{out}: {len(used)} vertices, {len(chunk)} triangles")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plytool")
    sub = ap.add_subparsers(dest="cmd", required=True)

    i = sub.add_parser("info")
    i.add_argument("files", nargs="+")
    i.set_defaults(fn=cmd_info)

    c = sub.add_parser("cat")
    c.add_argument("file")
    c.set_defaults(fn=cmd_cat)

    d = sub.add_parser("displace")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument("--image", required=True)
    d.add_argument("--scale", type=float, default=1.0)
    d.add_argument("--uvscale", type=float, default=1.0)
    d.set_defaults(fn=cmd_displace)

    s = sub.add_parser("split")
    s.add_argument("input")
    s.add_argument("--maxfaces", type=int, default=100000)
    s.set_defaults(fn=cmd_split)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
