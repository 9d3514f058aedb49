"""PSD reading without Pillow, as Pillow's PsdImagePlugin reads the merged
image of a Photoshop file.

The header's (colour mode, depth) picks Pillow's mode: bitmap 1-bit "1",
gray, duotone and multichannel "L", indexed "P" (the 768-byte colour map,
planar R, G, B, as the palette; another size leaves none), RGB (and "RGBA"
when the file has exactly four channels), CMYK (each channel inverted, as
the "C;I" raw modes read it), Lab "LAB" (the L, a and b planes stored as
they are, a and b plus 128, converted as Pillow converts LAB:
ops/imagemodes.lab_to_rgb, with alpha 0, the fourth byte of Pillow's
storage that no band fills). Any other pair (16 and 32-bit samples) is
refused, as Pillow refuses it. The colour mode data,
image resources and layer sections are passed over by their lengths. The
merged image is raw (0) or PackBits row by row (1): Pillow reads the byte
counts of the mode's channels only, so with more channels in the file its
first channel starts inside the count table, and this module reads the
same bytes. Other compressions leave Pillow no tile ("cannot load this
image"), so they are refused. PackBits runs through
native/image_coders.cpp (a run that passes a row's end is cut there, as in
Pillow's decoder).
"""

from __future__ import annotations

import struct

import numpy as np

from .dds import UnsupportedCodec
from .imagemodes import PassOn, check_size, native_rc, to_rgba

MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1), (3, 8): ("RGB", 3),
         (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def is_psd(data: bytes) -> bool:
    return data[:4] == b"8BPS"


def _lib():
    from ..native import image_lib

    return image_lib()


def _u32(data, off):
    if off + 4 > len(data):
        raise ValueError("PSD: truncated file")
    return struct.unpack_from(">I", data, off)[0]


def read_psd(data: bytes):
    """PSD bytes -> (mode, pixels, palette) of the merged image."""
    if len(data) < 26 or not is_psd(data) or struct.unpack_from(">H", data, 4)[0] != 1:
        raise PassOn("not a PSD file")
    channels, h, w, bits, cmode = struct.unpack_from(">HIIHH", data, 12)
    if (cmode, bits) not in MODES:
        raise UnsupportedCodec(f"PSD colour mode {cmode} at {bits} bits is not supported")
    mode, nch = MODES[(cmode, bits)]
    if nch > channels:
        raise ValueError("PSD: not enough channels")
    if mode == "RGB" and channels == 4:
        mode, nch = "RGBA", 4
    pos = 26
    size = _u32(data, pos)
    palette = None
    if size and mode == "P" and size == 768:
        palette = np.frombuffer(data, np.uint8, 768, pos + 4).reshape(3, 256).T.copy()
    pos += 4 + size
    pos += 4 + _u32(data, pos)  # image resources
    pos += 4 + _u32(data, pos)  # layer and mask information
    if pos + 2 > len(data):
        raise ValueError("PSD: truncated file")
    comp = struct.unpack_from(">H", data, pos)[0]
    pos += 2
    row = (w * bits + 7) // 8
    if w <= 0 or h <= 0:
        raise ValueError("PSD: empty image")
    check_size("PSD", w, h, nch * row * h, len(data) - pos, 64)  # a PackBits run: 128 bytes from 2
    planes = []
    if comp == 0:
        if pos + nch * row * h > len(data):
            raise ValueError("PSD: truncated merged image")
        raw = np.frombuffer(data, np.uint8, nch * row * h, pos).reshape(nch, h, row)
        planes = list(raw)
    elif comp == 1:
        if pos + 2 * nch * h > len(data):
            raise ValueError("PSD: truncated byte counts")
        counts = np.frombuffer(data, ">u2", nch * h, pos).astype(np.int64)
        off = pos + 2 * nch * h
        src = np.frombuffer(data, np.uint8)
        for c in range(nch):
            out = np.empty((h, row), np.uint8)
            part = np.ascontiguousarray(src[off:])
            native_rc(_lib().vkgr_packbits_rows(part.ctypes.data, len(part), row, h, out.ctypes.data), "PSD PackBits")
            planes.append(out)
            off += int(counts[c * h:(c + 1) * h].sum())
    else:
        raise ValueError(f"PSD compression {comp}: Pillow cannot load this image")
    if mode == "1":
        px = np.unpackbits(planes[0], axis=1)[:, :w] * np.uint8(255)
    else:
        px = np.stack(planes, axis=-1)[..., :nch] if nch > 1 else planes[0]
        if mode == "CMYK":
            px = 255 - px
        elif mode == "LAB":  # the bands are read one by one, so the storage's fourth byte (alpha) stays 0
            px = np.concatenate([px, np.zeros_like(px[..., :1])], axis=-1)
    return mode, np.ascontiguousarray(px), palette


def decode_psd(data: bytes) -> np.ndarray:
    """PSD bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    mode, px, palette = read_psd(data)
    return to_rgba(mode, px, palette)
