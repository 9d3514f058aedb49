"""A small PNG reader and writer on zlib + numpy (no Pillow).

The reader handles what the slice's scenes need: 8-bit, non-interlaced
grayscale, gray+alpha, RGB and RGBA images with all five scanline filter
types. Anything else (palette, 16-bit, interlaced) raises ValueError, as
does any non-PNG data (ops/textures.decode_image sends JPEG, DDS and KTX2
to their own decoders).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples per pixel


def is_png(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def _chunks(data: bytes):
    pos = 8
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise ValueError("PNG: truncated chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(ctype + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG: bad CRC in {ctype!r} chunk")
        yield ctype, body
        pos += 12 + length


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int16)
    prev = np.zeros(stride, np.int16)
    for y in range(h):
        ft = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int16)
        if ft == 0:
            cur = line
        elif ft == 2:
            cur = (line + prev) & 0xFF
        elif ft in (1, 3, 4):
            # left-dependent filters: walk one pixel (bpp bytes) at a time
            cur = np.zeros(stride, np.int16)
            for x in range(0, stride, bpp):
                a = cur[x - bpp : x] if x >= bpp else np.zeros(bpp, np.int16)
                b = prev[x : x + bpp]
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp : x] if x >= bpp else np.zeros(bpp, np.int16)
                    pred = _paeth(a, b, c)
                cur[x : x + bpp] = (line[x : x + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"PNG: unknown filter type {ft}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8)


def read_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 array [H, W, C] (C = 1, 2, 3 or 4)."""
    if not is_png(data):
        raise ValueError("not a PNG file")
    ihdr = None
    idat = []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG: missing IHDR")
    w, h, depth, ctype_, comp, filt, interlace = ihdr
    if depth != 8 or ctype_ not in _CHANNELS or interlace != 0 or comp != 0 or filt != 0:
        raise ValueError(
            f"PNG: unsupported format (bit depth {depth}, color type {ctype_}, interlace {interlace})")
    ch = _CHANNELS[ctype_]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * ch + 1):
        raise ValueError("PNG: image data size mismatch")
    return _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)


def _filter_rows(img: np.ndarray, ft: int) -> bytes:
    h = img.shape[0]
    bpp = img.shape[2]
    rows = img.reshape(h, -1).astype(np.int16)
    out = []
    prev = np.zeros(rows.shape[1], np.int16)
    for y in range(h):
        cur = rows[y]
        a = np.concatenate([np.zeros(bpp, np.int16), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int16), prev[:-bpp]])
        pred = {0: 0, 1: a, 2: prev, 3: (a + prev) >> 1, 4: _paeth(a, prev, c)}[ft]
        out.append(bytes([ft]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, filter_type: int = 0) -> bytes:
    """uint8 [H, W] or [H, W, C] (C = 1..4) -> PNG bytes, every scanline
    with the given filter type (0-4)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png: expected uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    ctype = {v: k for k, v in _CHANNELS.items()}[ch]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(_filter_rows(img, filter_type), 6))
            + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
