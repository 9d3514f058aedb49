"""Sun raster reading without Pillow, as Pillow's SunImagePlugin reads it.

Depth 1 ("1", a set bit black), 4 ("L" scaled by 17), 8 ("L"), 24 (BGR, or
RGB for file type 3) and 32 (BGRX, or RGBX for type 3, the fourth byte
dropped); a colour map (type 1, planar R, G, B, up to 1,024 bytes) makes
4 and 8-bit images "P" and is ignored otherwise. Raw rows are padded to 16
bits (types 0, 1, 3, 4, 5); type 2 is one RLE stream (native/
image_coders.cpp) of unpadded rows whose runs pass from row to row, as
Pillow's decoder reads it. Another depth, map type or file type, or a map
longer than 1,024 bytes, lets the next reader try (utils/image_io), which
Image.open does too.
"""

from __future__ import annotations

import struct

import numpy as np

from .imagemodes import PassOn, check_size, native_rc, to_rgba

MAGIC = 0x59A66A95


def is_sun(data: bytes) -> bool:
    return len(data) >= 4 and struct.unpack_from(">I", data)[0] == MAGIC


def _lib():
    from ..native import image_lib

    return image_lib()


def read_sun(data: bytes):
    """Sun raster bytes -> (mode, pixels, palette)."""
    if len(data) < 32 or not is_sun(data):
        raise PassOn("not a Sun raster file")
    _, w, h, depth, _, ftype, ptype, plen = struct.unpack_from(">8I", data)
    if depth not in (1, 4, 8, 24, 32):
        raise PassOn("Unsupported Mode/Bit Depth")
    palette = None
    if plen:
        if plen > 1024:
            raise PassOn("Unsupported Color Palette Length")
        if ptype != 1:
            raise PassOn("Unsupported Palette Type")
        raw = np.frombuffer(data[32:32 + plen], np.uint8)
        n = len(raw) // 3
        palette = raw[: 3 * n].reshape(3, n).T.copy()
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise PassOn("Unsupported Sun Raster file type")
    if w == 0 or h == 0:
        raise ValueError("Sun raster: empty image")
    offset = 32 + plen
    row = (w * depth + 7) // 8
    check_size("Sun raster", w, h)
    if ftype == 2:
        body = np.frombuffer(data, np.uint8, offset=min(offset, len(data)))
        check_size("Sun raster", w, h, h * row, len(body), 86)  # a run: 256 bytes from 3
        rows = np.empty((h, row), np.uint8)
        native_rc(_lib().vkgr_sun_rle(body.ctypes.data, len(body), rows.ctypes.data, h * row), "Sun RLE")
    else:
        stride = ((w * depth + 15) // 16) * 2
        if offset + stride * h > len(data):
            raise ValueError("Sun raster: truncated image data")
        rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)[:, :row]
    if depth == 1:
        return "1", np.where(np.unpackbits(rows, axis=1)[:, :w] == 0, 255, 0).astype(np.uint8), None
    if depth == 4:
        v = np.stack([rows >> 4, rows & 15], axis=-1).reshape(h, -1)[:, :w]
        return ("P", v, palette) if palette is not None else ("L", (v * 17).astype(np.uint8), None)
    if depth == 8:
        return ("P" if palette is not None else "L"), np.ascontiguousarray(rows), palette
    px = rows.reshape(h, w, depth // 8)[..., :3]
    return "RGB", np.ascontiguousarray(px if ftype == 3 else px[..., ::-1]), None


def decode_sun(data: bytes) -> np.ndarray:
    """Sun raster bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    return to_rgba(*read_sun(data))
