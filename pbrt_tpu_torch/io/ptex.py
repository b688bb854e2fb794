"""Ptex per-face texture container: reader + writer.

A copy of pbrt_tpu/io/ptex.py (numpy only), so the port needs nothing of
the reference package. Reference analogue: pbrt-v4 links the external Ptex
library and wraps it in PtexTexture (src/pbrt/textures.h:1003-1044,
textures.cpp PtexTexture::Evaluate). This is an independent implementation
of the on-disk Ptex container (PtexIO.h layout):

  Header | ExtHeader | zip(FaceInfo[nfaces]) | zip(constdata) |
  LevelInfo[nlevels] | per-level { zip(FaceDataHeader[nfaces]), face blocks }

Supported subset (documented): mt_quad/mt_triangle mesh types; uint8,
uint16, half, float data; enc_constant and enc_zipped face encodings
(enc_diffzipped is decoded for uint8; enc_tiled — used by the official
writer only for large faces — is rejected with a clear error). Only the
finest level (level 0) is read; reductions are regenerated in memory by the
texture system's own mip pyramid. Metadata and edit blocks are skipped.

Faces are returned/accepted as (res_v, res_u, nchannels) float32 arrays in
[0,1] for integer types (native scale for half/float).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 0x78657450  # 'Ptex' little-endian

MT_TRIANGLE = 0
MT_QUAD = 1

DT_UINT8 = 0
DT_UINT16 = 1
DT_HALF = 2
DT_FLOAT = 3

ENC_CONSTANT = 0
ENC_ZIPPED = 1
ENC_DIFFZIPPED = 2
ENC_TILED = 3

FLAG_CONSTANT = 1

_DTYPES = {
    DT_UINT8: np.uint8,
    DT_UINT16: np.uint16,
    DT_HALF: np.float16,
    DT_FLOAT: np.float32,
}

_HEADER = struct.Struct("<IIIIiHHIIIIIQII")
_EXTHEADER = struct.Struct("<HHIIQQQ")
_LEVELINFO = struct.Struct("<QII")


def _to_float(arr, dt):
    a = np.asarray(arr)
    if dt == DT_UINT8:
        return a.astype(np.float32) / 255.0
    if dt == DT_UINT16:
        return a.astype(np.float32) / 65535.0
    return a.astype(np.float32)


def _from_float(arr, dt):
    a = np.asarray(arr, np.float32)
    if dt == DT_UINT8:
        return np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if dt == DT_UINT16:
        return np.clip(a * 65535.0 + 0.5, 0, 65535).astype(np.uint16)
    return a.astype(_DTYPES[dt])


def read_ptex(path: str):
    """Read a .ptx file. Returns (faces, meshtype) where faces is a list of
    (res_v, res_u, nchannels) float32 arrays, one per face."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _HEADER.size:
        raise ValueError(f"{path}: not a Ptex file (too short)")
    (magic, version, meshtype, datatype, alphachan, nchannels, nlevels,
     nfaces, extheadersize, faceinfosize, constdatasize, levelinfosize,
     leveldatasize, metadatazipsize, metadatamemsize) = _HEADER.unpack_from(
        data, 0
    )
    if magic != MAGIC:
        raise ValueError(f"{path}: bad Ptex magic {magic:#x}")
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported datatype {datatype}")
    pos = _HEADER.size + extheadersize

    fi_raw = zlib.decompress(data[pos:pos + faceinfosize])
    pos += faceinfosize
    if len(fi_raw) != 20 * nfaces:
        raise ValueError(f"{path}: faceinfo block size mismatch")
    faceinfo = []
    for i in range(nfaces):
        ulog2, vlog2, adjedges, flags = struct.unpack_from(
            "<bbBB", fi_raw, 20 * i
        )
        faceinfo.append((ulog2, vlog2, flags))

    dt_np = _DTYPES[datatype]
    psize = np.dtype(dt_np).itemsize * nchannels
    const_raw = zlib.decompress(data[pos:pos + constdatasize]) \
        if constdatasize else b""
    pos += constdatasize
    constdata = np.frombuffer(const_raw, dt_np).reshape(nfaces, nchannels) \
        if constdatasize else None

    levelinfo = []
    for i in range(nlevels):
        levelinfo.append(_LEVELINFO.unpack_from(data, pos + 16 * i))
    pos += levelinfosize

    faces = [None] * nfaces
    if nlevels > 0:
        lsize, lheadersize, lfaces = levelinfo[0]
        lpos = pos
        fdh_raw = zlib.decompress(data[lpos:lpos + lheadersize])
        fdhs = np.frombuffer(fdh_raw, "<u4")
        dpos = lpos + lheadersize
        for i in range(lfaces):
            blocksize = int(fdhs[i]) & 0x3FFFFFFF
            enc = int(fdhs[i]) >> 30
            ulog2, vlog2, flags = faceinfo[i]
            ru, rv = 1 << max(ulog2, 0), 1 << max(vlog2, 0)
            blk = data[dpos:dpos + blocksize]
            dpos += blocksize
            if enc == ENC_CONSTANT:
                texel = np.frombuffer(blk[:psize], dt_np)
                face = np.broadcast_to(
                    texel, (rv, ru, nchannels)
                ).copy()
            elif enc == ENC_ZIPPED:
                raw = zlib.decompress(blk)
                face = np.frombuffer(raw, dt_np).reshape(rv, ru, nchannels)
            elif enc == ENC_DIFFZIPPED and datatype == DT_UINT8:
                raw = np.frombuffer(zlib.decompress(blk), np.uint8)
                face = np.cumsum(raw.astype(np.uint32), dtype=np.uint32)
                face = (face & 0xFF).astype(np.uint8).reshape(
                    rv, ru, nchannels
                )
            else:
                raise ValueError(
                    f"{path}: face {i} uses unsupported encoding {enc} "
                    "(tiled faces are not supported by this reader)"
                )
            faces[i] = _to_float(face, datatype)
    # Fill any face the level somehow missed from constdata.
    for i in range(nfaces):
        if faces[i] is None:
            ulog2, vlog2, flags = faceinfo[i]
            ru, rv = 1 << max(ulog2, 0), 1 << max(vlog2, 0)
            c = constdata[i] if constdata is not None else np.zeros(nchannels)
            faces[i] = np.broadcast_to(
                _to_float(c, datatype), (rv, ru, nchannels)
            ).copy()
    return faces, meshtype


def write_ptex(path: str, faces, meshtype: int = MT_QUAD,
               datatype: int = DT_UINT8) -> None:
    """Write faces (list of (res_v, res_u, C) arrays, power-of-two sizes,
    float in [0,1] for integer datatypes) as a single-level .ptx file.
    Constant faces use enc_constant; others enc_zipped."""
    nfaces = len(faces)
    if nfaces == 0:
        raise ValueError("write_ptex: no faces")
    nchannels = int(np.asarray(faces[0]).shape[-1])
    dt_np = _DTYPES[datatype]
    psize = np.dtype(dt_np).itemsize * nchannels

    fi_raw = b""
    const_raw = b""
    fdhs = []
    blocks = []
    for f in faces:
        f = np.asarray(f)
        rv, ru, c = f.shape
        assert c == nchannels, "write_ptex: inconsistent channel counts"
        ulog2, vlog2 = int(np.log2(ru)), int(np.log2(rv))
        assert (1 << ulog2) == ru and (1 << vlog2) == rv, (
            "write_ptex: face resolutions must be powers of two"
        )
        native = _from_float(f, datatype)
        const = _from_float(f.reshape(-1, c).mean(0), datatype)
        const_raw += const.tobytes()
        is_const = bool((native == native.reshape(-1, c)[0]).all())
        flags = FLAG_CONSTANT if is_const else 0
        fi_raw += struct.pack("<bbBB", ulog2, vlog2, 0, flags)
        fi_raw += struct.pack("<iiii", -1, -1, -1, -1)  # adjfaces
        if is_const:
            blk = native.reshape(-1, c)[0].tobytes()
            fdhs.append((len(blk) & 0x3FFFFFFF) | (ENC_CONSTANT << 30))
        else:
            blk = zlib.compress(native.tobytes())
            fdhs.append((len(blk) & 0x3FFFFFFF) | (ENC_ZIPPED << 30))
        blocks.append(blk)

    fi_zip = zlib.compress(fi_raw)
    const_zip = zlib.compress(const_raw)
    fdh_zip = zlib.compress(
        np.asarray(fdhs, "<u4").tobytes()
    )
    level_data = fdh_zip + b"".join(blocks)
    levelinfo = _LEVELINFO.pack(len(level_data), len(fdh_zip), nfaces)

    header = _HEADER.pack(
        MAGIC, 1, meshtype, datatype, -1, nchannels, 1, nfaces,
        _EXTHEADER.size, len(fi_zip), len(const_zip), len(levelinfo),
        len(level_data), 0, 0,
    )
    extheader = _EXTHEADER.pack(0, 0, 0, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(header)
        f.write(extheader)
        f.write(fi_zip)
        f.write(const_zip)
        f.write(levelinfo)
        f.write(level_data)
