"""IM Tools reading without Pillow, as Pillow's ImtImagePlugin reads them:
a text header of "key value" lines ("width", "height", "pixel n8" for mode
"L"; "*" comments), the pixels after a form feed. Pillow registers IMT
without a magic check, so every data that reaches it is parsed as
ImtImageFile._open parses it (emulated here on the same reads), and data
without a mode or a size pass on (PassOn).
"""

from __future__ import annotations

import io
import re

import numpy as np

from .imagemodes import PassOn, check_size

FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def read_imt(data: bytes):
    """IMT bytes -> ("L", pixels [H, W])."""
    fp = io.BytesIO(data)
    buffer = fp.read(100)
    if b"\n" not in buffer:
        raise PassOn("not an IM file")
    w = h = 0
    mode, offset = "", None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = fp.read(1)
        if not s:
            break
        if s == b"\x0c":
            offset = fp.tell() - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += fp.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            w = int(v)
        elif k == b"height":
            h = int(v)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode or w <= 0 or h <= 0:
        raise PassOn("IMT: no mode or an empty image")
    if offset is None:
        raise ValueError("IMT: cannot load this image (no pixel data)")
    check_size("IMT", w, h)
    if offset + w * h > len(data):
        raise ValueError("IMT: image file is truncated")
    return "L", np.frombuffer(data, np.uint8, w * h, offset).reshape(h, w)


def decode_imt(data: bytes) -> np.ndarray:
    """IMT bytes -> uint8 [H, W, 1] (Pillow's "L")."""
    return read_imt(data)[1][..., None]
