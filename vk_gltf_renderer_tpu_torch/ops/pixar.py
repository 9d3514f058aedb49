"""PIXAR reading without Pillow, as Pillow's PixarImagePlugin reads PIXAR
raster files: the magic 0x80 0xE8 0 0, a 512-byte header (the size at
bytes 418 and 416, little-endian), and only the layout word pair (14, 2)
at bytes 424 and 426, which Pillow opens as "RGB"; the pixels are raw RGB
rows from byte 1024. Any other layout leaves Pillow without a mode, so the
data pass on (PassOn).
"""

from __future__ import annotations

import struct

import numpy as np

from .imagemodes import PassOn, check_size

MAGIC = b"\x80\xe8\x00\x00"


def is_pixar(data: bytes) -> bool:
    return data[:4] == MAGIC


def read_pixar(data: bytes):
    """PIXAR bytes -> ("RGB", pixels [H, W, 3])."""
    if not is_pixar(data):
        raise PassOn("not a PIXAR file")
    head = data[:512]
    try:
        w, h = struct.unpack_from("<H", head, 418)[0], struct.unpack_from("<H", head, 416)[0]
        layout = struct.unpack_from("<H", head, 424)[0], struct.unpack_from("<H", head, 426)[0]
    except struct.error as e:
        raise PassOn(f"PIXAR: short header ({e})") from e
    if layout != (14, 2) or w <= 0 or h <= 0:
        raise PassOn("PIXAR: a layout Pillow does not open")
    check_size("PIXAR", w, h)
    if 1024 + w * h * 3 > len(data):
        raise ValueError("PIXAR: image file is truncated")
    return "RGB", np.frombuffer(data, np.uint8, w * h * 3, 1024).reshape(h, w, 3)


def decode_pixar(data: bytes) -> np.ndarray:
    """PIXAR bytes -> uint8 [H, W, 3] (Pillow's "RGB")."""
    return read_pixar(data)[1]
