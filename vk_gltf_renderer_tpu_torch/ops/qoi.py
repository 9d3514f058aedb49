"""QOI reading without Pillow, as Pillow's QoiImagePlugin reads it.

The 14-byte header gives the size and the channel count (3 is "RGB", any
other count "RGBA"); the ops decode in native/image_coders.cpp with the
semantics of Pillow's decoder (an index entry that was never set is
(0, 0, 0, 0); a stream that ends before the image is full is refused).
"""

from __future__ import annotations

import struct

import numpy as np

from .imagemodes import PassOn, check_size, native_rc, to_rgba


def is_qoi(data: bytes) -> bool:
    return data[:4] == b"qoif"


def _lib():
    from ..native import image_lib

    return image_lib()


def read_qoi(data: bytes):
    """QOI bytes -> (mode, pixels [H, W, 3 or 4])."""
    if len(data) < 13 or not is_qoi(data):
        raise PassOn("not a QOI file")
    w, h = struct.unpack_from(">II", data, 4)
    bands = 3 if data[12] == 3 else 4
    if w == 0 or h == 0:
        raise ValueError("QOI: empty image")
    body = np.frombuffer(data, np.uint8, offset=min(14, len(data)))
    check_size("QOI", w, h, w * h, len(body), 62)  # a run: 62 pixels from 1 byte
    out = np.empty((h, w, bands), np.uint8)
    native_rc(_lib().vkgr_qoi_decode(body.ctypes.data, len(body), w * h, bands, out.ctypes.data), "QOI")
    return ("RGB" if bands == 3 else "RGBA"), out


def decode_qoi(data: bytes) -> np.ndarray:
    """QOI bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    return to_rgba(*read_qoi(data))
