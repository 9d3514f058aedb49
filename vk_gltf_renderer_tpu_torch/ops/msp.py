"""MSP reading without Pillow, as Pillow's MspImagePlugin reads Windows
Paint files: a 32-byte header whose 16-bit words XOR to zero ("DanM"
version 1, "LinS" version 2), the size at bytes 4 and 6, mode "1". Version
1 holds raw rows (MSB first, set bits white); version 2 a map of each
row's byte count, then the rows' runs, decoded by native/image_coders.cpp
(vkgr_msp_rle) into one stream that fills the image row after row, as
Pillow's raw decoder fills it.
"""

from __future__ import annotations

import numpy as np

from .imagemodes import PassOn, check_size, native_rc, to_rgba


def is_msp(data: bytes) -> bool:
    return data[:4] in (b"DanM", b"LinS")


def read_msp(data: bytes):
    """MSP bytes -> ("1", pixels [H, W] of 0/255)."""
    if len(data) < 32 or not is_msp(data):
        raise PassOn("not an MSP file")
    words = np.frombuffer(data[:32], "<u2")
    if int(np.bitwise_xor.reduce(words)) != 0:
        raise PassOn("MSP: bad checksum")
    w, h = int(words[2]), int(words[3])
    if w <= 0 or h <= 0:
        raise PassOn("MSP: empty image")
    stride = (w + 7) // 8
    need = stride * h
    check_size("MSP", w, h)
    if data[:4] == b"DanM":
        rows = np.frombuffer(data, np.uint8, min(need, max(len(data) - 32, 0)), 32)
    else:
        if 32 + 2 * h > len(data):
            raise ValueError("MSP: truncated file in row map")
        from ..native import image_lib

        rowmap = np.frombuffer(data, "<u2", h, 32).astype(np.uint16)
        src = np.frombuffer(data, np.uint8, len(data) - 32 - 2 * h, 32 + 2 * h)
        rows = np.empty(need, np.uint8)
        n = np.zeros(1, np.int64)
        native_rc(image_lib().vkgr_msp_rle(src.ctypes.data, len(src), rowmap.ctypes.data, h, stride,
                                          rows.ctypes.data, need, n.ctypes.data), "MSP")
        rows = rows[: int(n[0])]
    if len(rows) < need:
        raise ValueError("MSP: not enough image data")
    bits = np.unpackbits(rows[:need].reshape(h, stride), axis=1)[:, :w]
    return "1", bits * np.uint8(255)


def decode_msp(data: bytes) -> np.ndarray:
    """MSP bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    mode, px = read_msp(data)
    return to_rgba(mode, px)
