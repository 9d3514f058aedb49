"""XBM reading without Pillow, as Pillow's XbmImagePlugin and XbmDecode.c
read X11 bitmaps: the #define width and height (and hotspot) lines matched
in the first 512 bytes by Pillow's pattern, which ends after the last
"_bits[]" there; then each byte is the two characters after an "x" (a
character that is not a hex digit counts 0, and the three are skipped
before the next "x" is looked for), rows of whole bytes, bits LSB first,
a set bit white (mode "1").
"""

from __future__ import annotations

import re

import numpy as np

from .imagemodes import PassOn, check_size, to_rgba

HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    rb"(?P<hotspot>"
    rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    rb")?"
    rb"[\000-\377]*_bits\[]"
)
_HEX = np.zeros(256, np.uint8)
for _i, _c in enumerate(b"0123456789"):
    _HEX[_c] = _i
for _i, _c in enumerate(b"abcdef"):
    _HEX[_c] = _HEX[_c - 32] = 10 + _i


def is_xbm(data: bytes) -> bool:
    return data[:16].lstrip().startswith(b"#define")  # Image.open hands accept 16 bytes


def _x_positions(buf: np.ndarray) -> np.ndarray:
    """The "x"s XbmDecode.c takes, in order: each at least three bytes past
    the one before, with two bytes after it."""
    xs = np.flatnonzero(buf == ord("x"))
    xs = xs[xs + 3 <= len(buf)]
    if len(xs) < 2 or np.diff(xs).min() >= 3:
        return xs
    keep, last = [], -3
    for p in xs.tolist():  # only where an "x" falls within a byte's two characters
        if p >= last + 3:
            keep.append(p)
            last = p
    return np.asarray(keep, np.int64)


def read_xbm(data: bytes):
    """XBM bytes -> ("1", pixels [H, W] of 0/255)."""
    m = HEAD.match(data[:512])
    if not m:
        raise PassOn("not a XBM file")
    w, h = int(m.group("width")), int(m.group("height"))
    if w <= 0 or h <= 0:
        raise PassOn("XBM: empty image")
    check_size("XBM", w, h)
    stride = (w + 7) // 8
    buf = np.frombuffer(data, np.uint8, offset=m.end())
    xs = _x_positions(buf)[: stride * h]
    if len(xs) < stride * h:
        raise ValueError("XBM: image file is truncated")
    v = (_HEX[buf[xs + 1]] << 4) | _HEX[buf[xs + 2]]
    bits = np.unpackbits(v.astype(np.uint8).reshape(h, stride), axis=1, bitorder="little")[:, :w]
    return "1", bits * np.uint8(255)


def decode_xbm(data: bytes) -> np.ndarray:
    """XBM bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    mode, px = read_xbm(data)
    return to_rgba(mode, px)
