"""GIMP brush reading without Pillow, as Pillow's GbrImagePlugin reads
version 1 and 2 brushes: big-endian header words (header size, version,
width, height, bytes a pixel), version 2 with "GIMP" and a spacing word,
then a comment to the header's end; 1 byte a pixel is "L", 4 "RGBA".
Pillow's accept takes any data whose first words are >= 20 and 1 or 2, so
its open's checks decide, and data that fail them pass on (PassOn).
"""

from __future__ import annotations

import struct

import numpy as np

from .imagemodes import PassOn, check_size


def is_gbr(data: bytes) -> bool:
    return len(data) >= 8 and struct.unpack_from(">I", data, 0)[0] >= 20 and struct.unpack_from(">I", data, 4)[0] in (1, 2)


def read_gbr(data: bytes):
    """GBR bytes -> (mode, pixels [H, W] or [H, W, 4])."""
    try:
        size, version, w, h, depth = struct.unpack_from(">5I", data, 0)
    except struct.error as e:
        raise PassOn(f"not a GIMP brush ({e})") from e
    if size < 20 or version not in (1, 2) or w == 0 or h == 0 or depth not in (1, 4):
        raise PassOn("not a GIMP brush")
    pos = 20
    if version == 2:
        if data[20:24] != b"GIMP" or len(data) < 28:
            raise PassOn("not a GIMP brush, bad magic number")
        pos = 28
    comment = size - pos
    pos = len(data) if comment < 0 else min(pos + comment, len(data))  # read(-n) reads to the end
    check_size("GBR", w, h)
    need = w * h * depth
    if pos + need > len(data):
        raise ValueError("GBR: not enough image data")
    px = np.frombuffer(data, np.uint8, need, pos)
    return ("L", px.reshape(h, w)) if depth == 1 else ("RGBA", px.reshape(h, w, 4))


def decode_gbr(data: bytes) -> np.ndarray:
    """GBR bytes -> uint8 [H, W, 1] ("L") or [H, W, 4] ("RGBA")."""
    mode, px = read_gbr(data)
    return px[..., None] if mode == "L" else px
