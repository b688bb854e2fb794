"""Minimal PLY mesh reader (ascii + binary little/big endian) and writer.

A copy of pbrt_tpu/io/ply.py (numpy only), so the port needs nothing of
the reference package. Reference analogue: the vendored rply reader used
by Shape "plymesh" (pbrt-v4 src/ext/rply, util/mesh.cpp). Supports the
subset pbrt scenes use: vertex x/y/z (+optional nx/ny/nz/u/v), face
vertex_indices, triangulating polygons by fanning.
"""

from __future__ import annotations

import struct

import numpy as np

_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def read_ply(path: str):
    """Returns (vertices (V, 3) float32, faces (F, 3) int32)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"ply"):
        raise ValueError("not a PLY file")
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace")
    body = data[header_end:]

    fmt = "ascii"
    elements = []  # (name, count, [(prop_type, prop_name) or ("list", ...)])
    for line in header.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[1], parts[2]))

    verts = None
    faces = []
    if fmt == "ascii":
        tokens = body.split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                stride = len(props)
                arr = np.asarray(
                    tokens[pos : pos + count * stride], dtype=np.float64
                ).reshape(count, stride)
                names = [p[1] for p in props]
                ix = [names.index(c) for c in ("x", "y", "z")]
                verts = arr[:, ix].astype(np.float32)
                pos += count * stride
            elif name == "face":
                for _ in range(count):
                    k = int(tokens[pos])
                    idx = [int(t) for t in tokens[pos + 1 : pos + 1 + k]]
                    pos += 1 + k
                    for j in range(1, k - 1):
                        faces.append((idx[0], idx[j], idx[j + 1]))
            else:
                # Skip unknown ascii elements conservatively (fixed props).
                pos += count * len(props)
    else:
        endian = "<" if "little" in fmt else ">"
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                fmt_str = endian + "".join(_TYPES[p[0]][0] for p in props)
                stride = struct.calcsize(fmt_str)
                names = [p[1] for p in props]
                ix = [names.index(c) for c in ("x", "y", "z")]
                rows = np.zeros((count, 3), np.float32)
                for i in range(count):
                    vals = struct.unpack_from(fmt_str, body, off + i * stride)
                    rows[i] = [vals[ix[0]], vals[ix[1]], vals[ix[2]]]
                verts = rows
                off += count * stride
            elif name == "face":
                lp = props[0]
                cnt_fmt, cnt_sz = _TYPES[lp[1]]
                idx_fmt, idx_sz = _TYPES[lp[2]]
                for _ in range(count):
                    (k,) = struct.unpack_from(endian + cnt_fmt, body, off)
                    off += cnt_sz
                    idx = struct.unpack_from(endian + str(k) + idx_fmt, body, off)
                    off += k * idx_sz
                    for j in range(1, k - 1):
                        faces.append((idx[0], idx[j], idx[j + 1]))
            else:
                raise ValueError(f"unsupported binary PLY element {name}")
    return verts, np.asarray(faces, np.int32).reshape(-1, 3)


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Binary little-endian writer (for tests and the plytool equivalent)."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(verts)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n".encode())
        f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        f.write(verts.astype("<f4").tobytes())
        for face in faces:
            f.write(struct.pack("<B3i", 3, *face))
