"""BMP and DIB reading and writing without Pillow, as Pillow's
BmpImagePlugin reads and writes them.

Reading: the 12-byte OS/2 header and the 40, 52, 56, 64, 108 and 124-byte
Windows headers (a DIB is the same without the 14-byte file header); 1, 4
and 8-bit palettes, short ones too (missing entries are black), read as
Pillow reads them (a two-entry black/white palette is mode "1", a gray ramp
is "L"); 16, 24 and 32 bits, uncompressed or BI_BITFIELDS with the mask
layouts of Pillow's table only (any other layout is refused, as Pillow
refuses it); RLE8 and RLE4 through native/image_coders.cpp with Pillow's
record semantics; bottom-up and top-down rows. 32-bit BI_RGB ignores the
fourth byte, as Pillow does by default. JPEG and PNG inside a BMP are
refused, as Pillow refuses them.

encode_bmp writes what Image.fromarray(a).save(path) writes: a 40-byte
header, 96 dpi as 3780 pixels per metre, gray as 8 bits with a 256-entry
ramp, RGB as 24 bits, RGBA as 32 bits (BI_RGB), rows bottom-up padded to
4 bytes; without the file header for a .dib path.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .dds import UnsupportedCodec
from .imagemodes import to_rgba

HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)
BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3

# (bits, masks) -> Pillow's raw mode: the byte order of a pixel
MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}


def is_bmp(data: bytes) -> bool:
    return data[:2] == b"BM"


def is_dib(data: bytes) -> bool:
    """Pillow's _dib_accept: a bare info header."""
    return len(data) >= 4 and struct.unpack_from("<I", data)[0] in HEADER_SIZES


def _lib():
    from ..native import image_lib

    return image_lib()


def _u32(data, off):
    if off + 4 > len(data):
        raise ValueError("BMP: truncated header")
    return struct.unpack_from("<I", data, off)[0]


def _unpack_pixels(rows: np.ndarray, raw_mode: str, bits: int, w: int) -> np.ndarray:
    """[h, stride] uint8 rows -> pixels in Pillow's unpacked layout."""
    if bits == 1:
        return np.unpackbits(rows, axis=1)[:, :w]
    if bits == 4:
        return np.stack([rows >> 4, rows & 15], axis=-1).reshape(rows.shape[0], -1)[:, :w]
    if bits == 8:
        return rows[:, :w]
    if bits == 16:
        v = rows[:, : 2 * w].copy().view("<u2").astype(np.int32)
        if raw_mode == "BGR;16":
            r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
            return np.stack([(r * 255) // 31, (g * 255) // 63, (b * 255) // 31], axis=-1).astype(np.uint8)
        r, g, b = (v >> 10) & 31, (v >> 5) & 31, v & 31
        return np.stack([(r * 255) // 31, (g * 255) // 31, (b * 255) // 31], axis=-1).astype(np.uint8)
    nb = bits // 8
    px = rows[:, : nb * w].reshape(rows.shape[0], w, nb)
    order = [raw_mode.index(c) for c in ("RGBA" if "A" in raw_mode else "RGB")]
    return px[..., order]


def read_bmp(data: bytes, dib: bool = False, half_height: bool = False):
    """BMP (or headerless DIB) bytes -> (mode, pixels, palette); with
    half_height the image an icon or cursor holds (ops/ico.py): the
    header's height halved, the rows of the first half read."""
    if dib:
        start, offset = 0, 0
    else:
        if len(data) < 14 or not is_bmp(data):
            raise UnsupportedCodec("not a BMP file")
        start, offset = 14, _u32(data, 10)
    hsize = _u32(data, start)
    if start + hsize > len(data):
        raise ValueError("BMP: truncated header")
    hd = data[start + 4 : start + hsize]
    pos = start + hsize
    masks = None
    if hsize == 12:
        w, h, _planes, bits = struct.unpack_from("<HHHH", hd)
        comp, colors, pal_pad, top_down = BI_RGB, 0, 3, False
    elif hsize in HEADER_SIZES:
        top_down = hd[7] == 0xFF
        w = struct.unpack_from("<I", hd, 0)[0]
        h = struct.unpack_from("<I", hd, 4)[0]
        if top_down:
            h = 2**32 - h
        bits, comp = struct.unpack_from("<HI", hd, 10)
        colors = struct.unpack_from("<I", hd, 28)[0]
        pal_pad = 4
        if comp == BI_BITFIELDS:
            if len(hd) >= 48:
                masks = struct.unpack_from("<4I" if len(hd) >= 52 else "<3I", hd, 36)
                if len(masks) == 3:
                    masks = masks + (0,)
            else:
                if pos + 12 > len(data):
                    raise ValueError("BMP: truncated bit masks")
                masks = struct.unpack_from("<3I", data, pos) + (0,)
                pos += 12
    else:
        raise UnsupportedCodec(f"BMP header size {hsize} is not supported")
    if half_height:
        h //= 2
    if w <= 0 or h <= 0 or w >= 2**31 or h >= 2**31:
        raise ValueError("BMP: empty or negative image size")
    colors = colors if colors else 1 << bits
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    modes = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"),
             32: ("RGB", "BGRX")}
    if bits not in modes:
        raise UnsupportedCodec(f"BMP pixel depth {bits} is not supported")
    mode, raw_mode = modes[bits]
    rle = False
    if comp == BI_BITFIELDS:
        key = (bits, masks if bits == 32 else masks[:3])
        if key not in MASK_MODES:
            raise UnsupportedCodec("BMP bitfields layout that Pillow refuses")
        raw_mode = MASK_MODES[key]
        if bits == 32 and "A" in raw_mode:
            mode = "RGBA"
    elif comp in (BI_RLE8, BI_RLE4):
        rle = True
    elif comp != BI_RGB:
        raise UnsupportedCodec(f"BMP compression {comp} is not supported")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError("BMP: bad palette size")
        raw_pal = np.frombuffer(data[pos : pos + pal_pad * colors], np.uint8)
        pos += len(raw_pal)
        n = len(raw_pal) // pal_pad
        pal = raw_pal[: n * pal_pad].reshape(n, pal_pad)[:, 2::-1]  # BGR(X) -> RGB
        ramp = [0, 255] if colors == 2 else list(range(colors))
        gray = all(ind < n and (pal[ind] == v).all() for ind, v in enumerate(ramp)) if len(ramp) <= n else False
        if gray and colors == 2:
            mode = "1"
        elif gray:
            mode = "L"
        else:
            palette = pal
        if (mode == "1" and (bits != 1 or rle)) or (mode == "L" and bits != 8):
            # Pillow reads such data with the wrong raw mode (or none)
            raise UnsupportedCodec("BMP gray palette at a depth Pillow misreads")
    if not offset:
        offset = pos
    if rle:
        idx = np.empty(w * h, np.uint8)
        produced = ctypes.c_int64(0)
        buf = np.frombuffer(data, np.uint8)
        rc = _lib().vkgr_bmp_rle(buf.ctypes.data, len(data), offset, int(comp == BI_RLE4), w, h,
                                 idx.ctypes.data, ctypes.byref(produced))
        if rc != 0 or produced.value < w * h:
            raise ValueError("BMP: RLE data end before the image is full")
        px = idx.reshape(h, w)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        if offset + stride * h > len(data):
            raise ValueError("BMP: truncated pixel data")
        rows = np.frombuffer(data, np.uint8, count=stride * h, offset=offset).reshape(h, stride)
        px = _unpack_pixels(rows, raw_mode, bits, w)
        if mode == "1":
            px = np.where(px != 0, 255, 0).astype(np.uint8)
    if not top_down:
        px = px[::-1]
    return mode, np.ascontiguousarray(px), palette


def decode_bmp(data: bytes, dib: bool = False) -> np.ndarray:
    """BMP or DIB bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    mode, px, palette = read_bmp(data, dib)
    return to_rgba(mode, px, palette)


def encode_bmp(u8: np.ndarray, file_header: bool = True) -> bytes:
    """uint8 [H, W], [H, W, 3] or [H, W, 4] -> Pillow's default BMP (or,
    without the file header, its DIB)."""
    a = np.asarray(u8, np.uint8)
    h, w = a.shape[:2]
    if a.ndim == 2:
        bits, colors = 8, 256
        palette = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
        palette[:, 3] = 0
        body = a
    else:
        bits, colors, palette = (24 if a.shape[2] == 3 else 32), 0, None
        order = [2, 1, 0] if a.shape[2] == 3 else [2, 1, 0, 3]
        body = a[..., order].reshape(h, -1)
    stride = ((w * bits + 7) // 8 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : body.shape[1]] = body
    image = stride * h
    ppm = int(96 * 39.3701 + 0.5)
    out = b""
    if file_header:
        offset = 14 + 40 + colors * 4
        out += b"BM" + struct.pack("<III", offset + image, 0, offset)
    out += struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, 0, image, ppm, ppm, colors, colors)
    if palette is not None:
        out += palette.tobytes()
    return out + rows[::-1].tobytes()
