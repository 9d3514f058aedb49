"""TGA reading and writing without Pillow, as Pillow's TgaImagePlugin reads
and writes it.

TGA has no magic bytes: is_tga makes the header checks of Pillow's
TgaImageFile._open (colour-map type 0 or 1, a non-empty size, a depth of
1, 8, 16, 24 or 32, a known image type, a colour map of 16, 24 or 32
bits), and utils/image_io.read_image asks it last, as Pillow tries its TGA
plugin after the formats with magic.

Reading: image types 1 (colour-mapped), 2 (true colour) and 3 (gray), and
their run-length forms 9, 10 and 11 (packets through
native/image_coders.cpp, literal packets running on across scan lines as
in Pillow's TgaRleDecode.c); depths 8, 16 (5-5-5, its attribute bit set
for transparent), 24 and 32, gray 8 and 16 (with alpha) and 1; colour
maps of 16 and 24 bits from their first entry on (Pillow refuses 32-bit
maps, and so does this module); the four origins. A header that passes the checks but names
a type/depth pair Pillow has no raw mode for is refused, and so is a run
packet that crosses a scan line (an overrun in Pillow).

encode_tga writes what Image.fromarray(a).save(path) writes: uncompressed,
gray as type 3, RGB and RGBA as type 2 (RGBA with 8 attribute bits),
bottom-left origin, and the TGA 2.0 footer.
"""

from __future__ import annotations

import struct

import numpy as np

from .dds import UnsupportedCodec
from .imagemodes import to_rgba

# (image type & 7, depth) -> Pillow's raw mode
RAW_MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z", (2, 24): "BGR",
             (2, 32): "BGRA"}


def _lib():
    from ..native import image_lib

    return image_lib()


def _header(data: bytes):
    if len(data) < 18:
        raise UnsupportedCodec("not a TGA file")
    id_len, cmap_type, itype = data[0], data[1], data[2]
    w, h = struct.unpack_from("<HH", data, 12)
    depth, flags = data[16], data[17]
    if cmap_type not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32):
        raise UnsupportedCodec("not a TGA file")
    if itype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif itype in (1, 9):
        mode = "P" if cmap_type else "L"
    elif itype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise UnsupportedCodec("not a TGA file")
    if cmap_type and data[7] not in (16, 24, 32):
        raise UnsupportedCodec("not a TGA file")
    return id_len, cmap_type, itype, w, h, depth, flags, mode


def is_tga(data: bytes) -> bool:
    """The checks of Pillow's TgaImageFile._open."""
    try:
        _header(data)
    except UnsupportedCodec:
        return False
    return True


def _bgra15(v: np.ndarray) -> np.ndarray:
    """Pillow's BGRA;15Z: 5-5-5 bits scaled by 255/31, the top bit clear
    for opaque (alpha 255) and set for transparent (alpha 0)."""
    v = v.astype(np.int32)
    b, g, r = v & 31, (v >> 5) & 31, (v >> 10) & 31
    out = np.stack([r * 255 // 31, g * 255 // 31, b * 255 // 31, (1 - (v >> 15)) * 255], axis=-1)
    return out.astype(np.uint8)


def _unpack(raw: np.ndarray, raw_mode: str, w: int) -> np.ndarray:
    """[h, row bytes] -> pixels of Pillow's mode for raw_mode."""
    h = raw.shape[0]
    if raw_mode == "1":
        return np.where(np.unpackbits(raw, axis=1)[:, :w] != 0, 255, 0).astype(np.uint8)
    if raw_mode in ("P", "L"):
        return raw[:, :w]
    if raw_mode == "LA":
        return raw[:, : 2 * w].reshape(h, w, 2)
    if raw_mode == "BGRA;15Z":
        return _bgra15(raw[:, : 2 * w].copy().view("<u2"))
    if raw_mode == "BGR":
        return raw[:, : 3 * w].reshape(h, w, 3)[..., ::-1]
    return raw[:, : 4 * w].reshape(h, w, 4)[..., [2, 1, 0, 3]]  # BGRA


def read_tga(data: bytes):
    """TGA bytes -> (mode, pixels, palette [n, 3 or 4] or None)."""
    id_len, cmap_type, itype, w, h, depth, flags, mode = _header(data)
    pos = 18 + id_len
    palette = None
    if cmap_type:
        start, size, map_depth = struct.unpack_from("<HHB", data, 3)
        nb = {16: 2, 24: 3, 32: 4}[map_depth]
        raw = data[pos : pos + nb * size]
        pos += nb * size
        ent = np.frombuffer(bytes(nb * start) + raw, np.uint8)
        ent = ent[: len(ent) // nb * nb].reshape(-1, nb)
        if map_depth == 16:
            palette = _bgra15(ent.copy().view("<u2")[:, 0])
        elif map_depth == 24:
            palette = ent[:, ::-1]
        else:
            raise ValueError("TGA: a 32-bit colour map (Pillow has no raw mode for it)")
    raw_mode = RAW_MODES.get((itype & 7, depth))
    if raw_mode is None:
        raise UnsupportedCodec(f"TGA type {itype} at depth {depth}: Pillow has no decoder for it")
    if mode == "L" and raw_mode == "P":
        raise UnsupportedCodec("TGA colour-mapped type without a colour map")
    bits = {"1": 1, "P": 8, "L": 8, "LA": 16, "BGRA;15Z": 16, "BGR": 24, "BGRA": 32}[raw_mode]
    row_bytes = (w * bits + 7) // 8
    if itype & 8:
        buf = np.empty(row_bytes * h, np.uint8)
        src = np.frombuffer(data, np.uint8)[pos:]
        rc = _lib().vkgr_tga_rle(src.ctypes.data, len(src), (depth + 7) // 8, row_bytes, h, buf.ctypes.data)
        if rc == -1:
            raise ValueError("TGA: a run packet runs past the end of a scan line")
        if rc != 0:
            raise ValueError("TGA: RLE data end before the image is full")
        raw = buf.reshape(h, row_bytes)
    else:
        if pos + row_bytes * h > len(data):
            raise ValueError("TGA: truncated pixel data")
        raw = np.frombuffer(data, np.uint8, count=row_bytes * h, offset=pos).reshape(h, row_bytes)
    px = _unpack(raw, raw_mode, w)
    if not flags & 0x20:  # bottom-up rows
        px = px[::-1]
    if flags & 0x10:
        px = px[:, ::-1]
    return mode, np.ascontiguousarray(px), palette


def decode_tga(data: bytes) -> np.ndarray:
    """TGA bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    mode, px, palette = read_tga(data)
    return to_rgba(mode, px, palette)


def encode_tga(u8: np.ndarray) -> bytes:
    """uint8 [H, W], [H, W, 3] or [H, W, 4] -> Pillow's default TGA."""
    a = np.asarray(u8, np.uint8)
    h, w = a.shape[:2]
    if a.ndim == 2:
        itype, bits, flags, body = 3, 8, 0, a
    elif a.shape[2] == 3:
        itype, bits, flags, body = 2, 24, 0, a[..., ::-1]
    else:
        itype, bits, flags, body = 2, 32, 8, a[..., [2, 1, 0, 3]]
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, itype, 0, 0, 0, 0, 0, w, h, bits, flags)
    return head + np.ascontiguousarray(body[::-1]).tobytes() + b"\0" * 8 + b"TRUEVISION-XFILE.\0"
