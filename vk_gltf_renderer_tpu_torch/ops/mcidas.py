"""McIDAS area file reading without Pillow, as Pillow's McIdasImagePlugin
reads them: a 256-byte directory of 64 big-endian words after the magic
0 0 0 0 0 0 0 4; word 11 the bytes a sample (1 "L", 2 "I;16B", 4 "I" from
big-endian int32; any other passes the data on), words 10 and 9 the size;
rows of word 10 * word 11 * word 14 bytes plus a prefix of word 15 bytes,
the first at word 34 + word 15.
"""

from __future__ import annotations

import numpy as np

from .imagemodes import PassOn, check_size, to_rgba

MAGIC = b"\x00\x00\x00\x00\x00\x00\x00\x04"


def is_mcidas(data: bytes) -> bool:
    return data[:8] == MAGIC


def read_mcidas(data: bytes):
    """McIDAS bytes -> (mode, pixels [H, W])."""
    if not is_mcidas(data) or len(data) < 256:
        raise PassOn("not an McIdas area file")
    word = [0, *np.frombuffer(data[:256], ">i4").tolist()]
    modes = {1: ("L", ">u1"), 2: ("I;16B", ">u2"), 4: ("I", ">i4")}
    if word[11] not in modes:
        raise PassOn("unsupported McIdas format")
    mode, dtype = modes[word[11]]
    w, h = word[10], word[9]
    if w <= 0 or h <= 0:
        raise PassOn("McIdas: empty image")
    check_size("McIdas", w, h)
    offset = word[34] + word[15]
    stride = word[15] + word[10] * word[11] * word[14]
    line = w * word[11]
    if stride < line or offset < 0:  # Pillow's raw decoder refuses a stride shorter than a row
        raise ValueError("McIdas: a row stride shorter than a row")
    if offset + stride * (h - 1) + line > len(data):
        raise ValueError("McIdas: image file is truncated")
    rows = np.lib.stride_tricks.as_strided(np.frombuffer(data, np.uint8, len(data) - offset, offset),
                                           (h, line), (stride, 1))
    px = np.ascontiguousarray(rows).view(dtype).reshape(h, w)
    return mode, px.astype(np.int64) if mode != "L" else px.astype(np.uint8)


def decode_mcidas(data: bytes) -> np.ndarray:
    """McIDAS bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    mode, px = read_mcidas(data)
    return to_rgba(mode, px)
