"""SGI image reading without Pillow, as Pillow's SgiImagePlugin reads
.sgi, .rgb, .rgba, .bw files.

The (bytes per sample, dimension, channels) key picks Pillow's mode from
its table: L (dimension 1 or 2, one channel), RGB and RGBA (dimension 3,
three or four channels), at 8 or 16 bits; anything else is refused, as
Pillow refuses it. 16-bit samples keep their high byte (Pillow's "L;16B").
Rows are stored bottom row first, each channel as a plane (raw), or as
RLE rows located by the start and length tables after the 512-byte header
(native/image_coders.cpp, with the quirks of Pillow's SgiRleDecode.c).
"""

from __future__ import annotations

import struct

import numpy as np

from .imagemodes import PassOn, check_size, native_rc, to_rgba

MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L", (1, 3, 3): "RGB", (2, 3, 3): "RGB",
         (1, 3, 4): "RGBA", (2, 3, 4): "RGBA"}


def is_sgi(data: bytes) -> bool:
    return len(data) >= 2 and struct.unpack_from(">H", data)[0] == 474


def _lib():
    from ..native import image_lib

    return image_lib()


def read_sgi(data: bytes):
    """SGI bytes -> (mode, pixels [H, W] or [H, W, C])."""
    if len(data) < 512 or not is_sgi(data):
        raise PassOn("not an SGI file")
    rle, bpc = data[2], data[3]
    dimension, w, h, z = struct.unpack_from(">HHHH", data, 4)
    if (bpc, dimension, z) not in MODES:
        raise ValueError("Unsupported SGI image mode")
    mode = MODES[(bpc, dimension, z)]
    if w == 0 or h == 0:
        raise ValueError("SGI: empty image")
    check_size("SGI", w, h)
    if rle == 0:
        n = w * h * z * bpc
        if 512 + n > len(data):
            raise ValueError("SGI: truncated image data")
        planes = np.frombuffer(data, np.uint8, n, 512).reshape(z, h, w, bpc)[..., 0]
        px = planes.transpose(1, 2, 0)[::-1]
    elif rle == 1:
        body = np.frombuffer(data, np.uint8, offset=512)
        out = np.zeros((h, w, z), np.uint8)
        native_rc(_lib().vkgr_sgi_rle(body.ctypes.data, len(body), w, h, z, bpc, out.ctypes.data), "SGI RLE")
        px = out[::-1]
    else:
        raise ValueError(f"SGI compression {rle}: Pillow has no decoder for it")
    return mode, np.ascontiguousarray(px[..., 0] if z == 1 else px)


def decode_sgi(data: bytes) -> np.ndarray:
    """SGI bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    mode, px = read_sgi(data)
    return to_rgba(mode, px)
