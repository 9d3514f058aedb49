"""BLP reading without Pillow, as Pillow's BlpImagePlugin reads Blizzard's
textures.

The header's alpha flag picks "RGBA" or "RGB". BLP1: a JPEG (compression
0), its shared header followed by mip 0's bytes, decoded by ops/jpeg.py and
taken with its red and blue swapped (Pillow reads the RGB bytes back as
"BGR"); or 8-bit indices (compression 1, encoding 4 or 5) into the BGRA
palette that follows the header, read from right after the palette. BLP2:
the palette always follows the header; mip 0 is read at its offset, as
indices (encoding 1) or DXT blocks (encoding 2; alpha encoding 0, 1 or 7:
DXT1, DXT3, DXT5) decoded as Pillow's own Python decoders decode them
(565 endpoints widened by a shift, DXT3 alpha times 17, DXT1's three-colour
mode transparent only with the alpha flag). An index image takes its alpha
from the palette whatever the alpha depth. The decoded bytes fill the
image as a stream (rows of whole blocks, DXT3 and DXT5 four bytes a pixel
even in an "RGB" image), as Pillow's raw decoder fills it. Other
compressions and encodings are refused, as Pillow refuses them.
"""

from __future__ import annotations

import struct

import numpy as np

from .dds import UnsupportedCodec
from .imagemodes import PassOn, check_size


def is_blp(data: bytes) -> bool:
    return data[:4] in (b"BLP1", b"BLP2")


def _read(data: bytes, off: int, n: int) -> bytes:
    """ImageFile._safe_read: n bytes at off, or ValueError (Pillow's
    "Truncated File Read")."""
    if n <= 0:
        return b""
    if off + n > len(data):
        raise ValueError("BLP: truncated file")
    return data[off : off + n]


def _palette(data: bytes, off: int) -> np.ndarray:
    return np.frombuffer(_read(data, off, 1024), np.uint8).reshape(256, 4)  # B, G, R, A


def _indexed(data: bytes, off: int, n: int, palette: np.ndarray, alpha: bool) -> np.ndarray:
    idx = np.frombuffer(_read(data, off, n), np.uint8)
    bgra = palette[idx]
    return bgra[:, [2, 1, 0, 3] if alpha else [2, 1, 0]]


def _565(c, replicate):
    r, g, b = (c >> 11) & 31, (c >> 5) & 63, c & 31
    if replicate:  # Pillow's BcnDecode.c: the high bits repeated
        return np.stack([(r << 3) | (r >> 2), (g << 2) | (g >> 4), (b << 3) | (b >> 2)], axis=-1)
    return np.stack([r << 3, g << 2, b << 3], axis=-1)  # BlpImagePlugin's unpack_565


def dxt_blocks(blocks: bytes, bx: int, by: int, kind: int, alpha: bool, replicate: bool = False) -> np.ndarray:
    """by rows of bx DXT1 (kind 0), DXT3 (1) or DXT5 (2) blocks -> [4 * by,
    4 * bx, C], as Pillow's BLP decoders decode them (DXT1 with alpha: four
    channels, its three-colour mode's index 3 transparent black; without:
    three), or with replicate DXT1 as Pillow's BcnDecode.c decodes BC1 (565
    widened by repeating the high bits; call it with alpha)."""
    size = 8 if kind == 0 else 16
    b = np.frombuffer(blocks, np.uint8).reshape(by * bx, size).astype(np.int64)
    col = b[:, -8:]
    c0 = col[:, 0] | (col[:, 1] << 8)
    c1 = col[:, 2] | (col[:, 3] << 8)
    code = col[:, 4] | (col[:, 5] << 8) | (col[:, 6] << 16) | (col[:, 7] << 24)
    p0, p1 = _565(c0, replicate), _565(c1, replicate)
    four = (c0 > c1)[:, None] if kind == 0 else np.ones((len(c0), 1), bool)
    pal = np.stack([p0, p1, np.where(four, (2 * p0 + p1) // 3, (p0 + p1) // 2),
                    np.where(four, (2 * p1 + p0) // 3, 0)], axis=1)  # [N, 4, 3]
    sel = (code[:, None] >> (2 * np.arange(16))) & 3
    rgb = pal[np.arange(len(c0))[:, None], sel]  # [N, 16, 3]
    if kind == 0:
        a = np.where(~four & (sel == 3), 0, 255)
    elif kind == 1:
        nib = b[:, :8]
        a = np.stack([nib & 15, nib >> 4], axis=-1).reshape(-1, 16) * 17
    else:
        a0, a1 = b[:, 0:1], b[:, 1:2]
        bits = sum(b[:, 2 + i] << (8 * i) for i in range(6))
        ac = (bits[:, None] >> (3 * np.arange(16))) & 7
        eight = a0 > a1
        a = np.where(ac == 0, a0, np.where(ac == 1, a1, np.where(
            eight, ((8 - ac) * a0 + (ac - 1) * a1) // 7,
            np.where(ac == 6, 0, np.where(ac == 7, 255, ((6 - ac) * a0 + (ac - 1) * a1) // 5)))))
    px = np.concatenate([rgb, a[..., None]], axis=-1) if (kind or alpha) else rgb
    c = px.shape[-1]
    return px.reshape(by, bx, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(4 * by, 4 * bx, c).astype(np.uint8)


def read_blp(data: bytes):
    """BLP bytes -> (mode, pixels [H, W, 3 or 4])."""
    if not is_blp(data):
        raise PassOn("not a BLP file")
    v1 = data[:4] == b"BLP1"
    try:
        if v1:
            compression, alpha, w, h, encoding = struct.unpack_from("<iIIIi", data, 4)
            head = 28
        else:
            compression, encoding, alpha, alpha_encoding, w, h = struct.unpack_from("<ibbbxII", data, 4)
            head = 20
    except struct.error as e:
        raise PassOn(f"BLP: truncated header ({e})") from e
    if w <= 0 or h <= 0:
        raise PassOn("BLP: empty image")
    alpha = alpha != 0
    mode = "RGBA" if alpha else "RGB"
    nch = 4 if alpha else 3
    check_size("BLP", w, h)
    offsets = struct.unpack("<16I", _read(data, head, 64))
    lengths = struct.unpack("<16I", _read(data, head + 64, 64))
    pos = head + 128
    if v1 and compression == 0:
        from .jpeg import decode_jpeg

        (hsize,) = struct.unpack("<I", _read(data, pos, 4))
        header = _read(data, pos + 4, hsize)
        pos += 4 + hsize
        pos = max(pos, offsets[0])  # Pillow skips to mip 0 (never back)
        rgb = decode_jpeg(header + _read(data, pos, lengths[0]), color="cmyk")
        check_size("BLP", rgb.shape[1], rgb.shape[0])
        if rgb.shape[2] == 1:
            rgb = np.repeat(rgb, 3, axis=-1)
        stream = rgb[..., ::-1]
        if alpha:
            stream = np.concatenate([stream, np.full(stream.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    elif compression == 1 and (v1 and encoding in (4, 5) or not v1 and encoding == 1):
        palette = _palette(data, pos)
        stream = _indexed(data, pos + 1024 if v1 else offsets[0], lengths[0], palette, alpha)
    elif not v1 and compression == 1 and encoding == 2:
        if alpha_encoding not in (0, 1, 7):
            raise UnsupportedCodec(f"BLP: unsupported alpha encoding {alpha_encoding}")
        _palette(data, pos)  # read (and so required) before the blocks, as Pillow reads it
        bx, by = (w + 3) // 4, (h + 3) // 4
        kind = {0: 0, 1: 1, 7: 2}[alpha_encoding]
        stream = dxt_blocks(_read(data, offsets[0], by * bx * (8 if kind == 0 else 16)), bx, by, kind, alpha)
    else:
        raise UnsupportedCodec(f"BLP: compression {compression}, encoding {encoding} is not supported")
    flat = np.ascontiguousarray(stream).reshape(-1)
    if flat.size < w * h * nch:
        raise ValueError("BLP: not enough image data")
    return mode, flat[: w * h * nch].reshape(h, w, nch)


def decode_blp(data: bytes) -> np.ndarray:
    """BLP bytes -> uint8 [H, W, 3 or 4] (Pillow's "RGB" or "RGBA")."""
    return read_blp(data)[1]
