"""NanoVDB (.nvdb) container I/O — float fog-volume grids.

A copy of pbrt_tpu/io/nanovdb.py (numpy only), so the port needs nothing
of the reference package.
Self-contained reader/writer for the NanoVDB 32.3-generation file layout
(the format pbrt-v4's NanoVDBMedium and `nanovdb2pbrt` consume; reference
analogues: media.h:599 NanoVDBMedium, cmd/nanovdb2pbrt.cpp). The sparse
tree is the standard VDB 5/4/3 configuration:

    RootData -> upper InternalNode (32^3 children, 4096^3 voxel span)
             -> lower InternalNode (16^3 children,  128^3 voxel span)
             -> LeafNode (8^3 voxels)

Every struct offset lives in the _pack/_unpack helpers below so the whole
layout is centralized. Scope: GridType Float, GridClass FogVolume/Unknown,
codec NONE or ZIP (zlib); child references are stored as byte offsets
relative to the referencing node's start. Files written here are read back
bit-exactly (tests/test_nanovdb.py, tests/test_torch_io.py), and the reader walks value tiles at
every level, so sparse constant regions survive the trip.

Dense extraction (`NVDBGrid.values`) matches what the reference converter
does: `floatGrid->tree().getValue({x,y,z})` over the index bounding box,
with inactive voxels resolving to the background value.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

MAGIC = 0x304244566F6E614E  # "NanoVDB0" little-endian
ALIGN = 32

CODEC_NONE = 0
CODEC_ZIP = 1

GRID_TYPE_FLOAT = 1
GRID_CLASS_UNKNOWN = 0
GRID_CLASS_LEVELSET = 1
GRID_CLASS_FOG = 2

_GRIDDATA_SIZE = 672
_TREEDATA_SIZE = 64
_LEAF_HEADER = 96
_LEAF_SIZE = _LEAF_HEADER + 512 * 4
_LOWER_HEADER = 1088  # 24+8+512+512+16 = 1072 -> 32-aligned
_LOWER_SIZE = _LOWER_HEADER + 4096 * 8
_UPPER_HEADER = 8256  # 24+8+4096+4096+16 = 8240 -> 32-aligned
_UPPER_SIZE = _UPPER_HEADER + 32768 * 8
_ROOT_HEADER = 64  # 24+4+20 = 48 -> padded
_ROOT_TILE = 32  # 8+8+4+4 = 24 -> padded
_FILEHEADER = struct.Struct("<QIHH")  # magic, version, gridCount, codec
# gridSize fileSize nameKey voxelCount | gridType gridClass | worldBBox |
# indexBBox | voxelSize | nameSize | nodeCount[4] | tileCount[3] |
# codec pad | version   == 176 bytes
_FILEMETA = struct.Struct("<4Q2I6d6i3dI4I3IHHI")
assert _FILEMETA.size == 176


def _version(major=32, minor=3, patch=0):
    return (major << 21) | (minor << 10) | patch


def _fnv1a(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _pack_mask(bits: np.ndarray) -> bytes:
    """bool array (n,) -> n/8 bytes, bit i of word i>>6 (little-endian)."""
    return np.packbits(bits.astype(np.uint8), bitorder="little").tobytes()


def _unpack_mask(buf: bytes, n: int) -> np.ndarray:
    return np.unpackbits(
        np.frombuffer(buf, np.uint8), bitorder="little", count=n
    ).astype(bool)


def _root_key(i: int, j: int, k: int) -> int:
    """Pack the 4096-aligned tile origin into a 63-bit key (21 bits per
    axis, biased so negative coordinates sort correctly)."""
    bias = 1 << 20
    u = ((i >> 12) + bias) & 0x1FFFFF
    v = ((j >> 12) + bias) & 0x1FFFFF
    w = ((k >> 12) + bias) & 0x1FFFFF
    return (w << 42) | (v << 21) | u


def _key_origin(key: int) -> tuple[int, int, int]:
    bias = 1 << 20
    u = (key & 0x1FFFFF) - bias
    v = ((key >> 21) & 0x1FFFFF) - bias
    w = ((key >> 42) & 0x1FFFFF) - bias
    return (u << 12, v << 12, w << 12)


@dataclass
class NVDBGrid:
    """A float grid as dense values over its index bounding box."""

    name: str
    values: np.ndarray  # (nz, ny, nx) float32, [z][y][x]
    ijk_min: np.ndarray  # (3,) int32 index-space origin (x, y, z)
    voxel_size: np.ndarray = field(
        default_factory=lambda: np.ones(3, np.float64)
    )
    world_min: np.ndarray | None = None  # (3,) float64
    world_max: np.ndarray | None = None
    grid_class: int = GRID_CLASS_FOG
    background: float = 0.0

    def __post_init__(self):
        self.values = np.asarray(self.values, np.float32)
        self.ijk_min = np.asarray(self.ijk_min, np.int32)
        self.voxel_size = np.asarray(self.voxel_size, np.float64)
        nz, ny, nx = self.values.shape
        if self.world_min is None:
            self.world_min = self.ijk_min * self.voxel_size
        if self.world_max is None:
            self.world_max = (
                self.ijk_min + np.array([nx, ny, nz])
            ) * self.voxel_size
        self.world_min = np.asarray(self.world_min, np.float64)
        self.world_max = np.asarray(self.world_max, np.float64)

    @property
    def dims(self):
        nz, ny, nx = self.values.shape
        return (nx, ny, nz)


# ---------------------------------------------------------------- writer


def _node_stats(vals: np.ndarray):
    v = vals[np.isfinite(vals)]
    if v.size == 0:
        return (0.0, 0.0, 0.0, 0.0)
    return (float(v.min()), float(v.max()), float(v.mean()), float(v.std()))


def _grid_blob(g: NVDBGrid) -> tuple[bytes, dict]:
    """Serialize one grid into its in-memory NanoVDB blob."""
    nz, ny, nx = g.values.shape
    x0, y0, z0 = (int(c) for c in g.ijk_min)
    x1, y1, z1 = x0 + nx - 1, y0 + ny - 1, z0 + nz - 1  # inclusive

    # Pad to 8-aligned absolute leaf blocks; P is [x][y][z] for NanoVDB's
    # x-major voxel order.
    lx0, ly0, lz0 = (c & ~7 for c in (x0, y0, z0))
    lx1, ly1, lz1 = (c | 7 for c in (x1, y1, z1))
    P = np.full(
        (lx1 - lx0 + 1, ly1 - ly0 + 1, lz1 - lz0 + 1), g.background, np.float32
    )
    A = np.zeros(P.shape, bool)
    vt = np.transpose(g.values, (2, 1, 0))
    P[x0 - lx0 : x1 - lx0 + 1, y0 - ly0 : y1 - ly0 + 1,
      z0 - lz0 : z1 - lz0 + 1] = vt
    # FogVolume active set: in-bounds voxels whose value differs from the
    # background — all-background leaves are dropped from the file and the
    # reader restores them from the root background value.
    A[x0 - lx0 : x1 - lx0 + 1, y0 - ly0 : y1 - ly0 + 1,
      z0 - lz0 : z1 - lz0 + 1] = vt != g.background

    # Leaf blocks (skip fully-inactive ones -> sparse file).
    bx, by, bz = (s // 8 for s in P.shape)
    PB = P.reshape(bx, 8, by, 8, bz, 8).transpose(0, 2, 4, 1, 3, 5)
    AB = A.reshape(bx, 8, by, 8, bz, 8).transpose(0, 2, 4, 1, 3, 5)
    leaves = {}  # origin -> (values512, active512)
    for ix in range(bx):
        for iy in range(by):
            for iz in range(bz):
                if not AB[ix, iy, iz].any():
                    continue
                org = (lx0 + 8 * ix, ly0 + 8 * iy, lz0 + 8 * iz)
                leaves[org] = (
                    PB[ix, iy, iz].ravel(),
                    AB[ix, iy, iz].ravel(),
                )

    # Group into lower (128-span) and upper (4096-span) nodes.
    lowers: dict = {}
    for org, lv in leaves.items():
        lo = tuple(c & ~127 for c in org)
        lowers.setdefault(lo, {})[org] = lv
    uppers: dict = {}
    for org, ch in lowers.items():
        uo = tuple(c & ~4095 for c in org)
        uppers.setdefault(uo, {})[org] = ch

    leaf_list = sorted(leaves)
    lower_list = sorted(lowers)
    upper_list = sorted(uppers)
    leaf_idx = {o: i for i, o in enumerate(leaf_list)}
    lower_idx = {o: i for i, o in enumerate(lower_list)}

    tree_off = _GRIDDATA_SIZE
    root_off = tree_off + _TREEDATA_SIZE
    root_size = _ROOT_HEADER + _ROOT_TILE * len(upper_list)
    upper0 = root_off + root_size
    lower0 = upper0 + _UPPER_SIZE * len(upper_list)
    leaf0 = lower0 + _LOWER_SIZE * len(lower_list)
    total = leaf0 + _LEAF_SIZE * len(leaf_list)

    out = bytearray(total)
    stats = _node_stats(g.values)

    # --- leaves
    for i, org in enumerate(leaf_list):
        vals, act = leaves[org]
        off = leaf0 + i * _LEAF_SIZE
        st = _node_stats(vals[act])
        struct.pack_into(
            "<3i3BB", out, off, org[0], org[1], org[2], 7, 7, 7, 0
        )
        out[off + 16 : off + 80] = _pack_mask(act)
        struct.pack_into("<4f", out, off + 80, *st)
        out[off + _LEAF_HEADER : off + _LEAF_SIZE] = (
            vals.astype("<f4").tobytes()
        )

    # --- lower internal nodes (16^3 table, leaf children)
    for i, org in enumerate(lower_list):
        off = lower0 + i * _LOWER_SIZE
        cmask = np.zeros(4096, bool)
        vmask = np.zeros(4096, bool)
        table = np.zeros(4096, "<i8")
        for lorg in lowers[org]:
            n = (
                (((lorg[0] & 127) >> 3) << 8)
                | (((lorg[1] & 127) >> 3) << 4)
                | ((lorg[2] & 127) >> 3)
            )
            cmask[n] = True
            table[n] = leaf0 + leaf_idx[lorg] * _LEAF_SIZE - off
        struct.pack_into(
            "<6iQ", out, off,
            org[0], org[1], org[2], org[0] + 127, org[1] + 127, org[2] + 127,
            0,
        )
        out[off + 32 : off + 544] = _pack_mask(vmask)
        out[off + 544 : off + 1056] = _pack_mask(cmask)
        struct.pack_into("<4f", out, off + 1056, *stats)
        out[off + _LOWER_HEADER : off + _LOWER_SIZE] = table.tobytes()

    # --- upper internal nodes (32^3 table, lower children)
    for i, org in enumerate(upper_list):
        off = upper0 + i * _UPPER_SIZE
        cmask = np.zeros(32768, bool)
        vmask = np.zeros(32768, bool)
        table = np.zeros(32768, "<i8")
        for lorg in uppers[org]:
            n = (
                (((lorg[0] & 4095) >> 7) << 10)
                | (((lorg[1] & 4095) >> 7) << 5)
                | ((lorg[2] & 4095) >> 7)
            )
            cmask[n] = True
            table[n] = lower0 + lower_idx[lorg] * _LOWER_SIZE - off
        struct.pack_into(
            "<6iQ", out, off,
            org[0], org[1], org[2],
            org[0] + 4095, org[1] + 4095, org[2] + 4095, 0,
        )
        out[off + 32 : off + 4128] = _pack_mask(vmask)
        out[off + 4128 : off + 8224] = _pack_mask(cmask)
        struct.pack_into("<4f", out, off + 8224, *stats)
        out[off + _UPPER_HEADER : off + _UPPER_SIZE] = table.tobytes()

    # --- root
    struct.pack_into(
        "<6iI4x5f", out, root_off,
        x0, y0, z0, x1, y1, z1, len(upper_list),
        g.background, *stats,
    )
    for i, org in enumerate(upper_list):
        toff = root_off + _ROOT_HEADER + i * _ROOT_TILE
        struct.pack_into(
            "<QqIf", out, toff,
            _root_key(*org),
            upper0 + i * _UPPER_SIZE - root_off,
            0,
            0.0,
        )

    # --- tree
    n_voxels = int(sum(lv[1].sum() for lv in leaves.values()))
    struct.pack_into(
        "<4Q3I3IQ", out, tree_off,
        leaf0 - tree_off, lower0 - tree_off, upper0 - tree_off,
        root_off - tree_off,
        len(leaf_list), len(lower_list), len(upper_list),
        0, 0, 0,
        n_voxels,
    )

    # --- grid header
    name_b = g.name.encode()[:255]
    struct.pack_into(
        "<QQIIIIQ", out, 0,
        MAGIC, 0, _version(), 0, 0, 1, total,
    )
    out[40 : 40 + len(name_b)] = name_b
    # Map (296..560): affine index->world as float+double mat/inv/translate.
    vs = g.voxel_size
    mat = np.diag(vs).ravel()
    inv = np.diag(1.0 / vs).ravel()
    vec = np.zeros(3)  # index->world is pure scaling; bbox carries placement
    struct.pack_into(
        "<9f9f3ff", out, 296, *mat.astype(np.float32), *inv.astype(np.float32),
        *vec.astype(np.float32), 0.0,
    )
    struct.pack_into("<9d9d3dd", out, 384, *mat, *inv, *vec, 0.0)
    struct.pack_into(
        "<6d3dIIqI", out, 560,
        *g.world_min, *g.world_max, *vs,
        g.grid_class, GRID_TYPE_FLOAT, 0, 0,
    )

    meta = {
        "voxel_count": n_voxels,
        "node_count": (len(leaf_list), len(lower_list), len(upper_list), 1),
        "index_bbox": (x0, y0, z0, x1, y1, z1),
    }
    return bytes(out), meta


def write_nanovdb(path, grids, codec: str = "none") -> None:
    """Write float grids to a .nvdb file. `grids`: NVDBGrid or list."""
    if isinstance(grids, NVDBGrid):
        grids = [grids]
    codec_id = {"none": CODEC_NONE, "zip": CODEC_ZIP}[codec]
    with open(path, "wb") as f:
        f.write(_FILEHEADER.pack(MAGIC, _version(), len(grids), codec_id))
        for g in grids:
            blob, meta = _grid_blob(g)
            data = zlib.compress(blob) if codec_id == CODEC_ZIP else blob
            name_b = g.name.encode() + b"\0"
            x0, y0, z0, x1, y1, z1 = meta["index_bbox"]
            f.write(
                _FILEMETA.pack(
                    len(blob), len(data), _fnv1a(g.name.encode()),
                    meta["voxel_count"],
                    GRID_TYPE_FLOAT, g.grid_class,
                    *g.world_min, *g.world_max,
                    x0, y0, z0, x1, y1, z1,
                    *g.voxel_size,
                    len(name_b),
                    *meta["node_count"],
                    0, 0, 0,
                    codec_id, 0, _version(),
                )
            )
            f.write(name_b)
            f.write(data)


# ---------------------------------------------------------------- reader


def _read_grid_blob(blob: bytes, meta) -> NVDBGrid:
    magic, _, _, _, _, _, gsize = struct.unpack_from("<QQIIIIQ", blob, 0)
    if magic != MAGIC:
        raise ValueError(f"bad grid magic {magic:#x}")
    name = blob[40:296].split(b"\0", 1)[0].decode()
    wb = struct.unpack_from("<6d3dII", blob, 560)
    world_min, world_max = np.array(wb[:3]), np.array(wb[3:6])
    voxel_size = np.array(wb[6:9])
    grid_class, grid_type = wb[9], wb[10]
    if grid_type != GRID_TYPE_FLOAT:
        raise ValueError(f"unsupported GridType {grid_type} (float only)")

    tree_off = _GRIDDATA_SIZE
    toff = struct.unpack_from("<4Q", blob, tree_off)
    root_off = tree_off + toff[3]

    x0, y0, z0, x1, y1, z1, n_tiles = struct.unpack_from(
        "<6iI", blob, root_off
    )
    background = struct.unpack_from("<f", blob, root_off + 32)[0]
    nx, ny, nz = x1 - x0 + 1, y1 - y0 + 1, z1 - z0 + 1
    out = np.full((nz, ny, nx), background, np.float32)

    def fill(ox, oy, oz, span, value):
        xa, xb = max(ox, x0), min(ox + span - 1, x1)
        ya, yb = max(oy, y0), min(oy + span - 1, y1)
        za, zb = max(oz, z0), min(oz + span - 1, z1)
        if xa > xb or ya > yb or za > zb:
            return
        out[za - z0 : zb - z0 + 1, ya - y0 : yb - y0 + 1,
            xa - x0 : xb - x0 + 1] = value

    def read_leaf(off):
        ox, oy, oz = struct.unpack_from("<3i", blob, off)
        vals = np.frombuffer(
            blob, "<f4", 512, off + _LEAF_HEADER
        ).reshape(8, 8, 8)  # [x][y][z]
        vz = np.transpose(vals, (2, 1, 0))  # -> [z][y][x]
        xa, xb = max(ox, x0), min(ox + 7, x1)
        ya, yb = max(oy, y0), min(oy + 7, y1)
        za, zb = max(oz, z0), min(oz + 7, z1)
        if xa > xb or ya > yb or za > zb:
            return
        out[za - z0 : zb - z0 + 1, ya - y0 : yb - y0 + 1,
            xa - x0 : xb - x0 + 1] = vz[
            za - oz : zb - oz + 1, ya - oy : yb - oy + 1, xa - ox : xb - ox + 1
        ]

    def read_internal(off, log2dim, child_span, read_child):
        n = 1 << (3 * log2dim)
        ox, oy, oz = struct.unpack_from("<3i", blob, off)
        ox, oy, oz = (
            ox & ~(child_span * (1 << log2dim) - 1),
            oy & ~(child_span * (1 << log2dim) - 1),
            oz & ~(child_span * (1 << log2dim) - 1),
        )
        mask_off = off + 32
        vmask = _unpack_mask(blob[mask_off : mask_off + n // 8], n)
        cmask = _unpack_mask(
            blob[mask_off + n // 8 : mask_off + n // 4], n
        )
        header = _LOWER_HEADER if log2dim == 4 else _UPPER_HEADER
        table = np.frombuffer(blob, "<i8", n, off + header)
        dim = 1 << log2dim
        for idx in np.nonzero(cmask | vmask)[0]:
            i = (idx >> (2 * log2dim)) & (dim - 1)
            j = (idx >> log2dim) & (dim - 1)
            k = idx & (dim - 1)
            cx = ox + i * child_span
            cy = oy + j * child_span
            cz = oz + k * child_span
            if cmask[idx]:
                read_child(off + int(table[idx]), cx, cy, cz)
            else:
                # Active value tile: float in the entry's low 4 bytes.
                val = np.frombuffer(
                    blob, "<f4", 1, off + header + 8 * int(idx)
                )[0]
                fill(cx, cy, cz, child_span, val)

    def read_lower(off, *_org):
        read_internal(off, 4, 8, lambda o, x, y, z: read_leaf(o))

    def read_upper(off, *_org):
        read_internal(off, 5, 128, lambda o, x, y, z: read_lower(o))

    for t in range(n_tiles):
        toff2 = root_off + _ROOT_HEADER + t * _ROOT_TILE
        key, child, state, value = struct.unpack_from("<QqIf", blob, toff2)
        if child != 0:
            read_upper(root_off + child)
        elif state:
            ox, oy, oz = _key_origin(key)
            fill(ox, oy, oz, 4096, value)

    return NVDBGrid(
        name=name,
        values=out,
        ijk_min=np.array([x0, y0, z0], np.int32),
        voxel_size=voxel_size,
        world_min=world_min,
        world_max=world_max,
        grid_class=grid_class,
        background=background,
    )


def read_nanovdb(path, grid_name: str | None = None):
    """Read a .nvdb file. Returns the named NVDBGrid, or a dict of all
    grids when grid_name is None."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version, n_grids, codec = _FILEHEADER.unpack_from(buf, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not a NanoVDB file (magic {magic:#x})")
    if codec not in (CODEC_NONE, CODEC_ZIP):
        raise ValueError(f"{path}: unsupported codec {codec} (NONE/ZIP only)")
    pos = _FILEHEADER.size
    grids = {}
    for _ in range(n_grids):
        m = _FILEMETA.unpack_from(buf, pos)
        pos += _FILEMETA.size
        grid_size, file_size = m[0], m[1]
        name_size = m[21]
        name = buf[pos : pos + name_size].split(b"\0", 1)[0].decode()
        pos += name_size
        data = buf[pos : pos + file_size]
        pos += file_size
        if grid_name is not None and name != grid_name:
            continue
        blob = zlib.decompress(data) if codec == CODEC_ZIP else data
        if len(blob) != grid_size:
            raise ValueError(f"{path}: grid {name}: size mismatch")
        grids[name] = _read_grid_blob(blob, m)
    if grid_name is not None:
        if grid_name not in grids:
            raise KeyError(f"{path}: no grid named {grid_name!r}")
        return grids[grid_name]
    return grids
