"""SPIDER reading without Pillow, as Pillow's SpiderImagePlugin reads
SPIDER 2D images: 27 big- or little-endian float32 header values, tried
big-endian first with isSpiderHeader's test as written (values 1, 2, 5,
12, 13, 22 and 23 whole numbers, iform among 1, 3, -11, -12, -21, -22,
labbyt = labrec * lenbyt); Pillow registers SPIDER without a magic check,
so the test runs on any data that reaches it, and data that fail it, or
are not a 2D image (iform 1), or hold an inconsistent stack header, pass on
(PassOn). The pixels are float32 in the header's byte order after labbyt
bytes (twice that for a stack's first image), mode "F".
"""

from __future__ import annotations

import struct

import numpy as np

from .imagemodes import PassOn, check_size, to_rgba

IFORMS = (1, 3, -11, -12, -21, -22)


def _is_int(f) -> bool:
    """SpiderImagePlugin.isInt."""
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def header_length(t) -> int:
    """isSpiderHeader over 23 or more header values: labbyt, or 0."""
    h = (99, *t)
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in IFORMS:
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def read_spider(data: bytes):
    """SPIDER bytes -> ("F", float32 pixels [H, W])."""
    if len(data) < 108:
        raise PassOn("not a valid Spider file")
    bo = ">"
    t = struct.unpack(">27f", data[:108])
    hdrlen = header_length(t)
    if hdrlen == 0:
        bo = "<"
        t = struct.unpack("<27f", data[:108])
        hdrlen = header_length(t)
    if hdrlen == 0:
        raise PassOn("not a valid Spider file")
    h = (99, *t)
    if int(h[5]) != 1:
        raise PassOn("not a Spider 2D image")
    w, ht = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])  # a NaN here is a ValueError, as in Pillow
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = hdrlen * 2
    elif istack == 0 and imgnumber > 0:  # Pillow reads a stack offset it has not set yet (AttributeError)
        raise ValueError("SPIDER: an image inside a stack opened on its own")
    else:
        raise PassOn("inconsistent stack header values")
    if w <= 0 or ht <= 0:
        raise PassOn("SPIDER: empty image")
    check_size("SPIDER", w, ht)
    if offset < 0 or offset + w * ht * 4 > len(data):
        raise ValueError("SPIDER: image file is truncated")
    return "F", np.frombuffer(data, bo + "f4", w * ht, offset).reshape(ht, w)


def decode_spider(data: bytes) -> np.ndarray:
    """SPIDER bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    mode, px = read_spider(data)
    return to_rgba(mode, px)
