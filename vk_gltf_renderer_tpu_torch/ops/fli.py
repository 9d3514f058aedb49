"""FLI/FLC reading without Pillow, as Pillow's FliImagePlugin reads the
first frame of an Autodesk animation: a 128-byte header (magic 0xAF11 or
0xAF12, flags 0 or 3, its reserved ranges zero), mode "P" with a gray
palette that the first frame's first COLOR chunk (4, or 11 with values
shifted left by 2) changes, read as _open reads it; then the frame's
chunks decoded into a zeroed image by native/image_coders.cpp
(vkgr_fli_frame, Pillow's FliDecode.c: SS2 7, LC 12, BLACK 13, BRUN 15,
COPY 16; COLOR and PSTAMP 18 skipped). A palette entry past 255, or a
value past 255 after the shift, passes the data on, as Pillow's open
fails there (IndexError, struct.error).
"""

from __future__ import annotations

import struct

import numpy as np

from .imagemodes import PassOn, check_size, native_rc, to_rgba


def is_fli(data: bytes) -> bool:
    return (len(data) >= 16 and struct.unpack_from("<H", data, 4)[0] in (0xAF11, 0xAF12)
            and struct.unpack_from("<H", data, 14)[0] in (0, 3))


def _palette(data: bytes, pos: int, shift: int):
    """FliImageFile._palette from pos -> [256, 3] uint8."""
    pal = np.repeat(np.arange(256, dtype=np.int64)[:, None], 3, axis=1)
    try:
        (packets,) = struct.unpack_from("<H", data, pos)
        pos += 2
        i = 0
        for _ in range(packets):
            skip, n = data[pos], data[pos + 1]
            pos += 2
            i += skip
            n = n or 256
            rgb = np.frombuffer(data[pos : pos + 3 * n], np.uint8)
            pos += 3 * n
            for k in range(0, len(rgb) - len(rgb) % 3, 3):
                pal[i] = rgb[k : k + 3].astype(np.int64) << shift
                i += 1
            if len(rgb) % 3:
                raise IndexError("palette entry cut short")
    except (IndexError, struct.error) as e:
        raise PassOn(f"FLI: bad COLOR chunk ({e})") from e
    if pal.max() > 255:  # o8 of the shifted value
        raise PassOn("FLI: a palette value past 255")
    return pal.astype(np.uint8)


def read_fli(data: bytes):
    """FLI/FLC bytes -> ("P", indices [H, W], palette [256, 3])."""
    s = data[:128]
    if not (is_fli(s) and s[20:22] == b"\0\0" and s[42:80] == bytes(38) and s[88:] == bytes(40)):
        raise PassOn("not an FLI/FLC file")
    w, h = struct.unpack_from("<HH", s, 8)
    if w <= 0 or h <= 0:
        raise PassOn("FLI: empty image")
    palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    try:
        head = data[128:144]
        offset = 128
        if struct.unpack_from("<H", head, 4)[0] == 0xF100:  # a prefix chunk: _open reads past it, the frame does not
            at = offset + struct.unpack_from("<I", head, 0)[0]
            head = data[at : at + 16]
        else:
            at = offset
        if struct.unpack_from("<H", head, 4)[0] == 0xF1FA:
            pos = at + 16
            size = None
            for _ in range(struct.unpack_from("<H", head, 6)[0]):
                if size is not None:
                    pos += size - 6
                ch = data[pos : pos + 6]
                pos += 6
                kind = struct.unpack_from("<H", ch, 4)[0]
                if kind in (4, 11):
                    palette = _palette(data, pos, 2 if kind == 11 else 0)
                    break
                size = struct.unpack_from("<I", ch, 0)[0]
                if not size:
                    break
    except struct.error as e:
        raise PassOn(f"FLI: short header ({e})") from e
    check_size("FLI", w, h)
    if offset + 4 > len(data):
        raise PassOn("FLI: missing frame size")  # _seek(0)'s EOFError
    framesize = struct.unpack_from("<I", data, offset)[0]
    buf = np.frombuffer(data, np.uint8, min(framesize, len(data) - offset), offset)
    from ..native import image_lib

    px = np.zeros((h, w), np.uint8)
    rc = image_lib().vkgr_fli_frame(buf.ctypes.data, len(buf), w, h, px.ctypes.data)
    native_rc(rc, "FLI")
    return "P", px, palette


def decode_fli(data: bytes) -> np.ndarray:
    """FLI/FLC bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA") of frame 0."""
    mode, px, palette = read_fli(data)
    return to_rgba(mode, px, palette)
