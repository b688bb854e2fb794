"""tev display-server client: stream images to a running tev viewer.

A copy of pbrt_tpu/utils/display.py (sockets and numpy), so the port needs
nothing of the reference package. Reference analogue: pbrt-v4
src/pbrt/util/display.cpp (:26-75) — the
same wire protocol (little-endian length-prefixed packets: CreateImage = 4,
UpdateImage = 3), so images appear live in stock tev.
"""

from __future__ import annotations

import socket
import struct

import numpy as np

_CREATE = 4
_UPDATE = 3


def _packet(payload: bytes) -> bytes:
    return struct.pack("<I", len(payload) + 4) + payload


def _cstr(s: str) -> bytes:
    return s.encode() + b"\x00"


def send_to_tev(
    img: np.ndarray,
    name: str = "pbrt_tpu",
    host: str = "127.0.0.1",
    port: int = 14158,
    channels=("R", "G", "B"),
) -> bool:
    """Send a full (H, W, C) float image. Returns False if unreachable."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    img = img.reshape(h, w, c)
    try:
        sock = socket.create_connection((host, port), timeout=2.0)
    except OSError:
        return False
    try:
        # CreateImage: type, grabFocus, name, width, height, nChannels, names
        payload = struct.pack("<Bb", _CREATE, 1) + _cstr(name)
        payload += struct.pack("<ii", w, h)
        payload += struct.pack("<i", c)
        for ch in channels[:c]:
            payload += _cstr(ch)
        sock.sendall(_packet(payload))
        # UpdateImage per channel (whole image as one tile).
        for ci in range(c):
            payload = struct.pack("<Bb", _UPDATE, 0) + _cstr(name)
            payload += _cstr(channels[ci])
            payload += struct.pack("<iiii", 0, 0, w, h)
            payload += img[..., ci].astype("<f4").tobytes()
            sock.sendall(_packet(payload))
        return True
    finally:
        sock.close()
