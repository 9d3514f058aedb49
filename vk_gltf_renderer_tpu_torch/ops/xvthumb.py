"""XV thumbnail reading without Pillow, as Pillow's XVThumbImagePlugin
reads them: "P7 332", the rest of that line skipped, "#" comment lines,
then a line whose first two fields are the width and height; mode "P" over
XV's fixed 3-3-2 palette, one byte a pixel from the next line on.
"""

from __future__ import annotations

import io

import numpy as np

from .imagemodes import PassOn, check_size, to_rgba

MAGIC = b"P7 332"
PALETTE = np.array([((r * 255) // 7, (g * 255) // 7, (b * 255) // 3) for r in range(8) for g in range(8)
                    for b in range(4)], np.uint8)


def is_xvthumb(data: bytes) -> bool:
    return data[:6] == MAGIC


def read_xvthumb(data: bytes):
    """XV thumbnail bytes -> ("P", indices [H, W], palette [256, 3])."""
    fp = io.BytesIO(data)
    if fp.read(6) != MAGIC:
        raise PassOn("not an XV thumbnail file")
    fp.readline()
    while True:
        s = fp.readline()
        if not s:
            raise PassOn("Unexpected EOF reading XV thumbnail file")
        if s[0] != 35:
            break
    w, h = (int(v) for v in s.strip().split(maxsplit=2)[:2])  # too few fields or a bad number: ValueError
    if w <= 0 or h <= 0:
        raise PassOn("XV thumbnail: empty image")
    check_size("XVThumb", w, h)
    pos = fp.tell()
    if pos + w * h > len(data):
        raise ValueError("XV thumbnail: image file is truncated")
    return "P", np.frombuffer(data, np.uint8, w * h, pos).reshape(h, w), PALETTE


def decode_xvthumb(data: bytes) -> np.ndarray:
    """XV thumbnail bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    mode, px, palette = read_xvthumb(data)
    return to_rgba(mode, px, palette)
