"""PCX and DCX reading without Pillow, as Pillow's PcxImagePlugin and
DcxImagePlugin read them.

PCX: version 0, 2, 3 or 5 (the first two bytes are what Pillow accepts);
one 1-bit plane ("1"), two or four 1-bit planes ("P", the header's 16-entry
palette, the planes of a row one after another), one 8-bit plane at
version 5 ("L", or "P" with the 256-entry palette that the last 769 bytes
of the file hold after a 12 byte, unless it is the gray ramp), three 8-bit
planes at version 5 ("RGB", the row's planes one after another); any other
layout is refused, as Pillow refuses it. The row stride is computed from
the width as Pillow computes it (even when the header's differs), RLE
through native/image_coders.cpp (a run past a row's end is refused), and
Pillow's move of padded planes together before it unpacks a row (bit
planes by whole bytes, 8-bit planes by the width). A header
whose size is empty or negative, or one too short to read, lets the next
reader try (utils/image_io).

DCX: page 0 of the page directory, read as a PCX from its offset; the
256-entry palette is still looked for at the end of the whole file, as
Pillow looks for it.
"""

from __future__ import annotations

import struct

import numpy as np

from .imagemodes import PassOn, check_size, native_rc, to_rgba

DCX_MAGIC = 987654321


def is_pcx(data: bytes) -> bool:
    return len(data) >= 2 and data[0] == 10 and data[1] in (0, 2, 3, 5)


def is_dcx(data: bytes) -> bool:
    return len(data) >= 4 and struct.unpack_from("<I", data)[0] == DCX_MAGIC


def _lib():
    from ..native import image_lib

    return image_lib()


def read_pcx(data: bytes, start: int = 0):
    """PCX bytes (the page at `start` of data) -> (mode, pixels, palette)."""
    s = data[start:start + 68]
    if len(s) < 68 or not is_pcx(s):
        raise PassOn("not a PCX file")
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", s, 4)
    x1, y1 = x1 + 1, y1 + 1
    if x1 <= x0 or y1 <= y0:
        raise PassOn("bad PCX image size")
    version, bits, planes = s[1], s[3], s[65]
    given_stride = struct.unpack_from("<H", s, 66)[0]
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "P"
        palette = np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        tail = data[-769:] if len(data) >= 769 else b""
        if len(tail) == 769 and tail[0] == 12:
            pal = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
            if not (pal == np.arange(256, dtype=np.uint8)[:, None]).all():
                mode, palette = "P", pal
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise ValueError("unknown PCX mode")
    w, h = x1 - x0, y1 - y0
    stride = (w * bits + 7) // 8
    if given_stride != stride:
        stride += stride % 2
    row_bytes = planes * stride
    body = np.frombuffer(data, np.uint8, offset=min(start + 128, len(data)))
    check_size("PCX", w, h, h * row_bytes, len(body), 32)  # a run: 63 bytes from 2
    rows = np.empty((h, row_bytes), np.uint8)
    native_rc(_lib().vkgr_pcx_rle(body.ctypes.data, len(body), row_bytes, h, rows.ctypes.data), "PCX RLE")
    # Pillow's PcxDecode.c moves padded planes together before it unpacks a row: bit planes by whole bytes,
    # 8-bit planes by the width
    if bits == 1 and planes in (2, 4):
        xsize, bands = (w + 7) // 8, planes
        step = row_bytes // bands
    else:
        xsize, bands = w, row_bytes // w
        step = row_bytes // bands if bands else 0
    if step > xsize:
        for i in range(1, bands):
            rows[:, i * xsize:(i + 1) * xsize] = rows[:, i * step:i * step + xsize].copy()
    if mode == "1":
        px = np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
    elif mode == "P" and bits == 1:
        s8 = (w + 7) // 8
        px = np.zeros((h, w), np.uint8)
        for p in range(planes):
            px |= np.unpackbits(rows[:, p * s8:(p + 1) * s8], axis=1)[:, :w] << p
    elif mode == "RGB":
        px = np.stack([rows[:, c * w:(c + 1) * w] for c in range(3)], axis=-1)
    else:
        px = rows[:, :w]
    return mode, np.ascontiguousarray(px), palette


def read_dcx(data: bytes):
    """DCX bytes -> page 0 as (mode, pixels, palette)."""
    if len(data) < 8 or not is_dcx(data):
        raise PassOn("not a DCX file")
    off = struct.unpack_from("<I", data, 4)[0]
    if not off:
        raise PassOn("a DCX file without pages")
    return read_pcx(data, off)


def decode_pcx(data: bytes) -> np.ndarray:
    """PCX bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    return to_rgba(*read_pcx(data))


def decode_dcx(data: bytes) -> np.ndarray:
    """DCX bytes -> page 0 as uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    return to_rgba(*read_dcx(data))
