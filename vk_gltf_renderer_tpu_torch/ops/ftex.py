"""FTEX reading without Pillow, as Pillow's FtexImagePlugin reads Iron
Will 2's textures: one format (DXT1, read by Pillow's BC1 decoder as
"RGBA": ops/blp.dxt_blocks with the 565 colours widened as BcnDecode.c
widens them, or uncompressed "RGB") and mip 0 at its offset, a 32-bit size in
front of it. A header Pillow's open cannot parse passes the data on; a
format count other than one, or an unknown format, is refused.
"""

from __future__ import annotations

import struct

import numpy as np

from .blp import dxt_blocks
from .imagemodes import PassOn, check_size


def is_ftex(data: bytes) -> bool:
    return data[:4] == b"FTEX"


def decode_ftex(data: bytes) -> np.ndarray:
    """FTEX bytes -> uint8 [H, W, 4] (DXT1) or [H, W, 3]."""
    if not is_ftex(data):
        raise PassOn("not an FTEX file")
    try:
        _, w, h, _, nformats = struct.unpack_from("<5i", data, 4)
        if nformats != 1:  # Pillow asserts it
            raise ValueError("FTEX: more than one format")
        fmt, where = struct.unpack_from("<2i", data, 24)
        if where < 0:
            raise ValueError("FTEX: a negative offset")
        (size,) = struct.unpack_from("<i", data, where)
    except struct.error as e:
        raise PassOn(f"FTEX: truncated header ({e})") from e
    if fmt not in (0, 1):
        raise ValueError(f"FTEX: invalid texture compression format {fmt}")
    if w <= 0 or h <= 0:
        raise PassOn("FTEX: empty image")
    check_size("FTEX", w, h)
    body = data[where + 4 :] if size < 0 else data[where + 4 : where + 4 + size]
    need = ((w + 3) // 4) * ((h + 3) // 4) * 8 if fmt == 0 else w * h * 3
    if len(body) < need:
        raise ValueError("FTEX: image file is truncated")
    if fmt == 0:
        bx, by = (w + 3) // 4, (h + 3) // 4
        return np.ascontiguousarray(dxt_blocks(body[: need], bx, by, 0, True, replicate=True)[:h, :w])
    return np.frombuffer(body, np.uint8, w * h * 3).reshape(h, w, 3).copy()
