"""Image file I/O: OpenEXR (float scanline), PFM, PNG, QOI.

A copy of pbrt_tpu/io/image.py (numpy only), so the port needs nothing of
the reference package and reads every image bit-equal to it.
Reference analogue: pbrt-v4 src/pbrt/util/image.cpp (EXR via the
vendored OpenEXR library; PFM and PNG writers). Implemented from the public
file-format specifications in pure Python + numpy + zlib.

EXR support targets the subset pbrt emits/consumes for films: single-part
scanline images, float or half channels, NONE or ZIP compression.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# --- PFM --------------------------------------------------------------------


def write_pfm(path: str, img: np.ndarray) -> None:
    """img: (h, w, 3) or (h, w) float32. PFM stores bottom-to-top."""
    img = np.asarray(img, np.float32)
    color = img.ndim == 3
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # little-endian
        f.write(np.flipud(img).tobytes())


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        color = header == b"PF"
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(
            f.read(), "<f4" if scale < 0 else ">f4"
        )
    img = data.reshape(h, w, 3) if color else data.reshape(h, w)
    return np.flipud(img).copy()


# --- PNG --------------------------------------------------------------------


def encode_png(img: np.ndarray) -> bytes:
    """Encode (h, w, 3) uint8 (or float in [0,1]) to PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    h, w = img.shape[:2]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        c = tag + payload
        return (
            struct.pack(">I", len(payload))
            + c
            + struct.pack(">I", zlib.crc32(c) & 0xFFFFFFFF)
        )

    raw = b"".join(
        b"\x00" + img[y].tobytes() for y in range(h)
    )  # filter 0 per scanline
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray) -> None:
    """img: (h, w, 3) uint8 or float in [0,1] (converted with sRGB encode
    responsibility on the caller — this writes raw 8-bit values)."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


# --- OpenEXR (scanline, float/half, NONE/ZIP) -------------------------------

_EXR_MAGIC = 20000630
_PIXELTYPE_HALF = 1
_PIXELTYPE_FLOAT = 2
_COMP_NONE = 0
_COMP_ZIP = 3


def _attr(name: bytes, type_: bytes, value: bytes) -> bytes:
    return name + b"\x00" + type_ + b"\x00" + struct.pack("<I", len(value)) + value


def write_exr(
    path: str,
    img: np.ndarray,
    channel_names=("R", "G", "B"),
    compression: str = "zip",
    half: bool = False,
    metadata: dict | None = None,
) -> None:
    """Write a single-part scanline EXR.

    img: (h, w, C) float; channel_names length must equal C. `metadata` maps
    string keys to string values (written as EXR string attributes — the
    provenance channel pbrt uses for spp/render-time, film.cpp WriteImage).
    """
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    assert len(channel_names) == c
    comp = _COMP_ZIP if compression == "zip" else _COMP_NONE
    ptype = _PIXELTYPE_HALF if half else _PIXELTYPE_FLOAT

    # Channel list sorted alphabetically as EXR requires.
    order = sorted(range(c), key=lambda i: channel_names[i])
    chans = b""
    for i in order:
        chans += channel_names[i].encode() + b"\x00"
        chans += struct.pack("<iiii", ptype, 0, 1, 1)
    chans += b"\x00"

    header = b""
    header += _attr(b"channels", b"chlist", chans)
    header += _attr(b"compression", b"compression", struct.pack("<B", comp))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr(b"dataWindow", b"box2i", box)
    header += _attr(b"displayWindow", b"box2i", box)
    header += _attr(b"lineOrder", b"lineOrder", struct.pack("<B", 0))
    header += _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _attr(
        b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0)
    )
    header += _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    for k, v in (metadata or {}).items():
        header += _attr(k.encode(), b"string", str(v).encode())
    header += b"\x00"

    lines_per_block = 16 if comp == _COMP_ZIP else 1
    n_blocks = (h + lines_per_block - 1) // lines_per_block

    dtype = np.dtype("<f2") if half else np.dtype("<f4")
    blocks = []
    for b in range(n_blocks):
        y0 = b * lines_per_block
        y1 = min(y0 + lines_per_block, h)
        # Per scanline: all pixels of each channel, channels in sorted order.
        rows = []
        for y in range(y0, y1):
            for i in order:
                rows.append(np.ascontiguousarray(img[y, :, i]).astype(dtype).tobytes())
        data = b"".join(rows)
        if comp == _COMP_ZIP:
            packed = _exr_zip_compress(data)
            if len(packed) >= len(data):
                packed = data
        else:
            packed = data
        blocks.append(struct.pack("<i", y0) + struct.pack("<i", len(packed)) + packed)

    with open(path, "wb") as f:
        f.write(struct.pack("<I", _EXR_MAGIC))
        f.write(struct.pack("<I", 2))  # version 2, no flags
        f.write(header)
        offset_table_pos = f.tell()
        offset0 = offset_table_pos + 8 * n_blocks
        offsets = []
        pos = offset0
        for blk in blocks:
            offsets.append(pos)
            pos += len(blk)
        f.write(struct.pack(f"<{n_blocks}Q", *offsets))
        for blk in blocks:
            f.write(blk)


def _exr_zip_compress(data: bytes) -> bytes:
    """OpenEXR ZIP pre-filter: interleave split, then delta, then deflate
    (matches ImfZip.cpp so standard readers can open our files)."""
    raw = np.frombuffer(data, np.uint8)
    n = len(raw)
    half = (n + 1) // 2
    tmp = np.empty(n, np.uint8)
    tmp[:half] = raw[0::2]
    tmp[half:] = raw[1::2]
    d = tmp.astype(np.int16)
    d[1:] = d[1:] - tmp[:-1].astype(np.int16) + (128 + 256)
    out = (d & 0xFF).astype(np.uint8)
    out[0] = tmp[0]
    return zlib.compress(out.tobytes(), 6)


def _exr_zip_decompress(data: bytes, expected: int) -> bytes:
    d = np.frombuffer(zlib.decompress(data), np.uint8).astype(np.int64)
    # Invert delta: orig[i] = (orig[i-1] + d[i] - 384) mod 256.
    vals = d.copy()
    vals[1:] -= 384
    tmp = (np.cumsum(vals) & 0xFF).astype(np.uint8)
    # Invert interleave split.
    n = len(tmp)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = tmp[:half]
    out[1::2] = tmp[half:]
    return out.tobytes()


def read_exr(path: str):
    """Read a single-part scanline EXR written by this module (and the common
    subset of pbrt outputs: float/half, NONE/ZIP/ZIPS compression).

    Returns (img (h, w, C) float32, channel_names sorted, metadata dict).
    """
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<II", buf, 0)
    assert magic == _EXR_MAGIC, "not an EXR file"
    assert version & 0xFF == 2
    assert not (version & 0x200), "multi-part EXR unsupported"
    pos = 8

    attrs = {}
    while buf[pos] != 0:
        e = buf.index(b"\x00", pos)
        name = buf[pos:e].decode()
        pos = e + 1
        e = buf.index(b"\x00", pos)
        type_ = buf[pos:e].decode()
        pos = e + 1
        (size,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        attrs[name] = (type_, buf[pos : pos + size])
        pos += size
    pos += 1

    # Channels.
    chdata = attrs["channels"][1]
    chans = []
    cp = 0
    while chdata[cp] != 0:
        e = chdata.index(b"\x00", cp)
        cname = chdata[cp:e].decode()
        cp = e + 1
        ptype, _, sx, sy = struct.unpack_from("<iiii", chdata, cp)
        cp += 16
        chans.append((cname, ptype))
    comp = attrs["compression"][1][0]
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1

    metadata = {
        k: v[1].decode(errors="replace")
        for k, (t, v_) in ((k, attrs[k]) for k in attrs)
        if (v := attrs[k])[0] == "string"
    }

    lines_per_block = {0: 1, 2: 1, 3: 16, 4: 32}.get(comp)
    assert lines_per_block is not None, f"unsupported compression {comp}"
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, pos)

    img = np.zeros((h, w, len(chans)), np.float32)
    bytes_per = {1: 2, 2: 4}
    for off in offsets:
        (y,) = struct.unpack_from("<i", buf, off)
        (size,) = struct.unpack_from("<i", buf, off + 4)
        data = buf[off + 8 : off + 8 + size]
        ny = min(lines_per_block, y1 - y + 1)
        row_bytes = sum(w * bytes_per[pt] for _, pt in chans)
        expected = row_bytes * ny
        if comp in (3, 4) and size != expected:
            data = _exr_zip_decompress(data, expected)
        dp = 0
        for yy in range(y, y + ny):
            for ci, (cname, ptype) in enumerate(chans):
                nb = w * bytes_per[ptype]
                row = np.frombuffer(
                    data[dp : dp + nb], "<f2" if ptype == 1 else "<f4"
                )
                img[yy - y0, :, ci] = row.astype(np.float32)
                dp += nb
    return img, [c for c, _ in chans], metadata


def read_png(path: str) -> np.ndarray:
    """Decode a baseline 8/16-bit PNG (gray/RGB/RGBA, non-interlaced).

    Reference analogue: lodepng usage in util/image.cpp. Returns (h, w, C)
    float32 in [0, 1] (raw values; sRGB decode is the caller's call).
    """
    with open(path, "rb") as f:
        buf = f.read()
    assert buf[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG file"
    pos = 8
    idat = b""
    w = h = depth = ctype = None
    while pos < len(buf):
        (length,) = struct.unpack_from(">I", buf, pos)
        tag = buf[pos + 4 : pos + 8]
        payload = buf[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, ctype, comp, filt, ilace = struct.unpack(
                ">IIBBBBB", payload
            )
            assert ilace == 0, "interlaced PNG unsupported"
            assert depth in (8, 16), f"PNG bit depth {depth} unsupported"
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    bpp = nch * (depth // 8)
    raw = zlib.decompress(idat)
    stride = w * bpp
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros((stride,), np.uint8)
    p = 0
    for y in range(h):
        ft = raw[p]
        line = np.frombuffer(raw[p + 1 : p + 1 + stride], np.uint8).copy()
        p += 1 + stride
        if ft == 1:  # Sub
            for i in range(bpp, stride):
                line[i] = (line[i] + line[i - bpp]) & 0xFF
        elif ft == 2:  # Up
            line = (line + prev) & 0xFF
        elif ft == 3:  # Average
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                line[i] = (line[i] + ((int(a) + int(prev[i])) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            for i in range(stride):
                a = int(line[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                c = int(prev[i - bpp]) if i >= bpp else 0
                pp = a + b - c
                pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[i] = (line[i] + pr) & 0xFF
        out[y] = line
        prev = line
    if depth == 8:
        img = out.reshape(h, w, nch).astype(np.float32) / 255.0
    else:
        img = (
            out.reshape(h, w, nch, 2).astype(np.uint16) << np.array([8, 0])
        ).sum(-1).astype(np.float32) / 65535.0
    return img


def read_image_rgb(path: str) -> np.ndarray:
    """Load any supported image as linear-RGB float32 (h, w, 3).

    EXR/PFM are linear already; PNG is sRGB-decoded (the reference's
    Image::Read gamma handling, util/image.cpp).
    """
    low = path.lower()
    if low.endswith(".exr"):
        img, chans, _ = read_exr(path)
        if all(c in chans for c in "RGB"):
            return np.stack(
                [img[..., chans.index(c)] for c in "RGB"], axis=-1
            ).astype(np.float32)
        return np.repeat(img[..., :1], 3, axis=-1).astype(np.float32)
    if low.endswith(".pfm"):
        img = np.asarray(read_pfm(path), np.float32)
        return img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
    if low.endswith(".qoi"):
        img = read_qoi(path)[..., :3]
        srgb = img <= 0.04045
        return np.where(
            srgb, img / 12.92, ((img + 0.055) / 1.055) ** 2.4
        ).astype(np.float32)
    if low.endswith(".png"):
        img = read_png(path)[..., :3]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        srgb = img <= 0.04045
        return np.where(
            srgb, img / 12.92, ((img + 0.055) / 1.055) ** 2.4
        ).astype(np.float32)
    raise ValueError(f"unsupported image format: {path}")


# --- QOI (Quite OK Image format; spec qoiformat.org) -------------------------


def write_qoi(path: str, img: np.ndarray) -> None:
    """Encode (h, w, 3|4) uint8 or [0,1] float to QOI (util/image.cpp's QOI
    writer role; the format spec is public domain)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    h, w, ch = img.shape
    assert ch in (3, 4), ch
    px = np.concatenate(
        [img, np.full((h, w, 1), 255, np.uint8)], -1
    ) if ch == 3 else img
    flat = px.reshape(-1, 4).astype(np.int64)  # python-int arithmetic
    out = bytearray()
    out += b"qoif" + struct.pack(">IIBB", w, h, ch, 0)
    index = [(0, 0, 0, 0)] * 64
    prev = (0, 0, 0, 255)
    run = 0
    for p in map(tuple, flat):
        if p == prev:
            run += 1
            if run == 62:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        r, g, b, a = p
        idx = (r * 3 + g * 5 + b * 7 + a * 11) % 64
        if index[idx] == p:
            out.append(idx)
        else:
            index[idx] = p
            pr, pg, pb, pa = prev
            if a == pa:
                dr = (r - pr + 128) % 256 - 128
                dg = (g - pg + 128) % 256 - 128
                db = (b - pb + 128) % 256 - 128
                if -2 <= dr <= 1 and -2 <= dg <= 1 and -2 <= db <= 1:
                    out.append(
                        0x40 | ((dr + 2) << 4) | ((dg + 2) << 2) | (db + 2)
                    )
                elif (
                    -32 <= dg <= 31 and -8 <= dr - dg <= 7
                    and -8 <= db - dg <= 7
                ):
                    out.append(0x80 | (dg + 32))
                    out.append(((dr - dg + 8) << 4) | (db - dg + 8))
                else:
                    out += bytes((0xFE, r, g, b))
            else:
                out += bytes((0xFF, r, g, b, a))
        prev = p
    if run:
        out.append(0xC0 | (run - 1))
    out += b"\x00\x00\x00\x00\x00\x00\x00\x01"
    with open(path, "wb") as f:
        f.write(bytes(out))


def read_qoi(path: str) -> np.ndarray:
    """Decode QOI to (h, w, C) float32 in [0, 1]."""
    with open(path, "rb") as f:
        buf = f.read()
    assert buf[:4] == b"qoif", "not a QOI file"
    w, h, ch, _cs = struct.unpack(">IIBB", buf[4:14])
    px = np.zeros((h * w, 4), np.uint8)
    index = [(0, 0, 0, 0)] * 64
    prev = (0, 0, 0, 255)
    i, n = 14, h * w
    pos = 0
    while pos < n and i < len(buf) - 8:
        b0 = int(buf[i])
        i += 1
        if b0 == 0xFE:
            prev = (buf[i], buf[i + 1], buf[i + 2], prev[3])
            i += 3
        elif b0 == 0xFF:
            prev = (buf[i], buf[i + 1], buf[i + 2], buf[i + 3])
            i += 4
        elif b0 >> 6 == 0:
            prev = index[b0]
        elif b0 >> 6 == 1:
            dr = ((b0 >> 4) & 3) - 2
            dg = ((b0 >> 2) & 3) - 2
            db = (b0 & 3) - 2
            prev = (
                (prev[0] + dr) % 256, (prev[1] + dg) % 256,
                (prev[2] + db) % 256, prev[3],
            )
        elif b0 >> 6 == 2:
            dg = (b0 & 0x3F) - 32
            b1 = buf[i]
            i += 1
            dr = dg + ((b1 >> 4) & 0xF) - 8
            db = dg + (b1 & 0xF) - 8
            prev = (
                (prev[0] + dr) % 256, (prev[1] + dg) % 256,
                (prev[2] + db) % 256, prev[3],
            )
        else:  # run
            run = (b0 & 0x3F) + 1
            px[pos:pos + run] = prev
            pos += run
            idx = (
                prev[0] * 3 + prev[1] * 5 + prev[2] * 7 + prev[3] * 11
            ) % 64
            index[idx] = prev
            continue
        idx = (prev[0] * 3 + prev[1] * 5 + prev[2] * 7 + prev[3] * 11) % 64
        index[idx] = prev
        px[pos] = prev
        pos += 1
    out = px.reshape(h, w, 4).astype(np.float32) / 255.0
    return out[..., :ch]
