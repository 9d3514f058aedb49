"""ICO and CUR reading without Pillow, as Pillow's IcoImagePlugin and
CurImagePlugin read them.

ICO: the directory's entries sorted as Pillow sorts them (by colour depth,
then by area, largest first, stably), and the first one read: a PNG
(utils/png) or a DIB (ops/bmp) of half its stated height, made RGBA with
its alpha from the fourth byte of each pixel where the directory says 32
bits, else from the AND mask that ends the entry (a set bit transparent).
A directory with no entries, or one cut short, lets the next reader try
(utils/image_io), as Image.open does.

CUR: the largest cursor (the first entry, replaced by any later one wider
and taller), a DIB of half its stated height, with no mask; a directory
with no cursor lets the next reader try.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from ..utils.png import is_png, read_png
from .bmp import read_bmp
from .imagemodes import PassOn, to_rgba


def is_ico(data: bytes) -> bool:
    return data[:4] == b"\0\0\1\0"


def is_cur(data: bytes) -> bool:
    return data[:4] == b"\0\0\2\0"


def _dib_offset(dib: bytes) -> int:
    """Where a DIB's pixels start: after its header, masks and palette."""
    hsize = struct.unpack_from("<I", dib)[0]
    if hsize == 12:
        bits = struct.unpack_from("<H", dib, 10)[0]
        return hsize + (3 << bits if bits <= 8 else 0)
    bits, comp = struct.unpack_from("<HI", dib, 14)
    colors = struct.unpack_from("<I", dib, 32)[0] or (1 << bits if bits <= 8 else 0)
    return hsize + (12 if comp == 3 and hsize == 40 else 0) + (4 * colors if bits <= 8 else 0)


def decode_ico(data: bytes) -> np.ndarray:
    """ICO bytes -> uint8 [H, W, C] of the entry Pillow picks (a PNG entry
    as utils/png gives it, a DIB entry RGBA)."""
    if len(data) < 6 or not is_ico(data):
        raise PassOn("not an ICO file")
    n = struct.unpack_from("<H", data, 4)[0]
    entries = []
    for i in range(n):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise PassOn("ICO: a directory entry cut short")
        w, h, ncol = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (ncol != 0 and math.ceil(math.log(ncol, 2))) or 256
        entries.append((w * h, depth, bpp, size, offset))
    if not entries:
        raise PassOn("ICO: no entries")
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    _, _, bpp, size, offset = entries[0]
    if is_png(data[offset:offset + 8]):
        return read_png(data[offset:])
    mode, px, palette = read_bmp(data[offset:], dib=True, half_height=True)
    rgba = to_rgba(mode, px, palette)
    h, w = px.shape[:2]
    if bpp == 32:
        o = offset + _dib_offset(data[offset:])
        alpha = np.frombuffer(data[o:o + w * h * 4], np.uint8)[3::4]
        if len(alpha) < w * h:
            raise ValueError("ICO: not enough alpha data")
        rgba[..., 3] = alpha[: w * h].reshape(h, w)[::-1]
    else:
        wp = w + (32 - w % 32) % 32
        total = wp * h // 8
        start = offset + size - total
        mask = np.frombuffer(data[max(start, 0):max(start, 0) + total], np.uint8)
        if start < 0 or len(mask) < total:
            raise ValueError("ICO: not enough mask data")
        bits = np.unpackbits(mask.reshape(h, wp // 8), axis=1)[:, :w]
        rgba[..., 3] = np.where(bits[::-1] == 1, 0, 255)
    return rgba


def decode_cur(data: bytes) -> np.ndarray:
    """CUR bytes -> uint8 [H, W, 4] of the largest cursor."""
    if len(data) < 6 or not is_cur(data):
        raise PassOn("not a CUR file")
    n = struct.unpack_from("<H", data, 4)[0]
    m = b""
    for i in range(n):
        s = data[6 + 16 * i:22 + 16 * i]
        if not m:
            m = s
        elif len(s) < 2:
            raise PassOn("CUR: a directory entry cut short")
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if not m or len(m) < 16:
        raise PassOn("CUR: no cursors")
    offset = struct.unpack_from("<I", m, 12)[0]
    return to_rgba(*read_bmp(data[offset:], dib=True, half_height=True))
