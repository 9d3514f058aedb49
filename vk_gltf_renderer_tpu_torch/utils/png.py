"""PNG reading and writing on zlib + numpy (no Pillow).

read_png reads every form Pillow's PngImagePlugin reads, as Pillow reads
it: every bit depth and colour type PNG allows (gray at 1, 2, 4, 8 and 16
bits, RGB, gray+alpha and RGBA at 8 and 16, palette at 1, 2, 4 and 8),
Adam7 interlacing (each pass unfiltered on its own, then scattered), tRNS
for gray, RGB and palette images, and APNG's default image. The five
scanline filters are undone by native/image_coders.cpp (vkgr_png_unfilter;
it raises when it cannot be built); inflate is zlib's. Chunks are treated
as Pillow treats them: every chunk before the image data must have a good
CRC (Pillow's open fails otherwise), the image data's and later chunks'
CRCs are not read, ancillary chunks do not touch the pixels, and the image
data are the IDAT chunks that follow one another. 8-bit gray, gray+alpha,
RGB and RGBA without tRNS come back as they are stored (1, 2, 3 or 4
channels); every other form comes back as Pillow's convert("RGBA") gives
it, from Pillow's mode (ops/imagemodes.to_rgba): 1-bit gray as 0/255, 2-
and 4-bit gray scaled by 85 and 17, 16-bit gray as Pillow's "I;16"
(clipped to 255), 16-bit colour samples by their high byte, a palette
shorter than the indices black, tRNS compared with the converted pixels
as Pillow's convert_transparent compares them.

encode_png writes 8-bit images, every scanline with one filter type.
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np

from ..ops.imagemodes import PassOn, check_size, native_rc, to_rgba

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples per pixel (8-bit forms encode_png writes)
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}  # Pillow's _MODES
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CID = re.compile(rb"\w\w\w\w")


def is_png(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def _lib():
    from ..native import image_lib

    return image_lib()


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _read_chunks(data: bytes):
    """The chunks up to the image data, as Pillow's open reads them (each
    CRC checked), then the image data: (IHDR, PLTE, tRNS, IDAT bytes)."""
    ihdr = plte = trns = None
    pos = 8
    while True:
        head = data[pos : pos + 8]
        cid = head[4:]
        if len(head) < 8 or not _CID.fullmatch(cid):
            raise PassOn(f"PNG: broken file (chunk {cid!r})")
        (length,) = struct.unpack(">I", head[:4])
        body = data[pos + 8 : pos + 8 + length]
        if cid in (b"IDAT", b"fdAT"):
            break
        if cid == b"IEND":
            raise ValueError("PNG: no image data")
        if len(body) < length:
            raise ValueError("PNG: truncated chunk")
        crc = data[pos + 8 + length : pos + 12 + length]
        if len(crc) < 4 or zlib.crc32(cid + body) & 0xFFFFFFFF != struct.unpack(">I", crc)[0]:
            raise PassOn(f"PNG: broken file (bad header checksum in {cid!r})")
        if cid == b"IHDR":
            if length < 13:
                raise ValueError("PNG: truncated IHDR chunk")
            if body[11]:
                raise PassOn("PNG: unknown filter category")
            ihdr = body
        elif cid == b"PLTE":
            plte = body
        elif cid == b"tRNS":
            trns = body
        pos += 12 + length
    idat = []
    while cid in (b"IDAT", b"fdAT", b"DDAT"):  # the chunks Pillow's load reads on, CRCs unread
        skip = 4 if cid == b"fdAT" else 0  # its sequence number
        idat.append(data[pos + 8 + skip : pos + 8 + length])
        pos += 12 + length
        head = data[pos : pos + 8]
        if len(head) < 8:
            break
        (length,), cid = struct.unpack(">I", head[:4]), head[4:]
    if ihdr is None:
        raise ValueError("PNG: missing IHDR")
    return ihdr, plte, trns, b"".join(idat)


def _samples(rows: np.ndarray, bits: int, nsamp: int, width: int) -> np.ndarray:
    """Unfiltered rows [h, stride] -> samples [h, width, nsamp] (MSB-first
    fields below 8 bits, big-endian at 16)."""
    h = rows.shape[0]
    if bits == 8:
        return rows[:, : width * nsamp].reshape(h, width, nsamp)
    if bits == 16:
        return rows[:, : 2 * width * nsamp].view(">u2").astype(np.uint16).reshape(h, width, nsamp)
    per = 8 // bits  # sub-byte fields: one sample a pixel
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    v = (rows[:, :, None] >> shifts) & np.uint8((1 << bits) - 1)
    return v.reshape(h, rows.shape[1] * per)[:, :width, None]


def _decode(data: bytes):
    """PNG bytes -> (Pillow's mode, pixels, palette or None, transparency
    or None, bit depth), as PngImagePlugin opens and loads the file."""
    if not is_png(data):
        raise PassOn("not a PNG file")
    ihdr, plte, trns, idat = _read_chunks(data)
    w, h, bits, ctype, _, _, interlace = struct.unpack(">IIBBBBB", ihdr[:13])
    if ctype not in _DEPTHS or bits not in _DEPTHS[ctype]:
        raise ValueError(f"PNG: bit depth {bits} with colour type {ctype} has no Pillow mode")
    if w <= 0 or h <= 0:
        raise ValueError("PNG: empty image")
    nsamp = _SAMPLES[ctype]
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    shapes = [(-(-(h - y0) // dy), -(-(w - x0) // dx)) for x0, y0, dx, dy in passes]
    strides = [(pw * bits * nsamp + 7) // 8 for _, pw in shapes]
    need = sum(ph * (st + 1) for (ph, pw), st in zip(shapes, strides) if ph > 0 and pw > 0)
    check_size("PNG", w, h, need, len(idat), 1032)  # deflate's largest ratio
    try:
        raw = zlib.decompressobj().decompress(idat, need)
    except zlib.error as e:
        raise ValueError(f"PNG: broken data stream ({e})") from e
    if len(raw) < need:
        raise ValueError("PNG: image file is truncated")
    src = np.frombuffer(raw, np.uint8)
    bpp = max(1, bits * nsamp // 8)
    samples = np.empty((h, w, nsamp), np.uint16 if bits == 16 else np.uint8)
    pos = 0
    for (x0, y0, dx, dy), (ph, pw), stride in zip(passes, shapes, strides):
        if ph <= 0 or pw <= 0:
            continue
        part = np.ascontiguousarray(src[pos : pos + ph * (stride + 1)])
        rows = np.empty((ph, stride), np.uint8)
        native_rc(_lib().vkgr_png_unfilter(part.ctypes.data, len(part), ph, stride, bpp, rows.ctypes.data),
                  "PNG scanline filters")
        samples[y0::dy, x0::dx] = _samples(rows, bits, nsamp, pw)
        pos += ph * (stride + 1)
    palette = transparency = None
    s = samples
    try:
        if ctype == 3:
            mode, px = "P", s[..., 0]
            if plte is not None:
                n = min(len(plte) // 3, 256)
                palette = np.frombuffer(plte, np.uint8, 3 * n).reshape(n, 3)
            if trns is not None:
                transparency = trns
        elif ctype == 0:
            mode, px = {1: "1", 16: "I;16"}.get(bits, "L"), s[..., 0]
            if bits < 8:
                px = px * np.uint8({1: 255, 2: 0x55, 4: 0x11}[bits])
            if trns is not None:
                t = struct.unpack_from(">H", trns)[0]
                transparency = (255 if t else 0) if bits == 1 else t
        elif ctype == 2:
            mode, px = "RGB", (s >> 8).astype(np.uint8) if bits == 16 else s
            if trns is not None:
                transparency = struct.unpack_from(">HHH", trns)
        elif ctype == 4:
            mode, px = ("LA", s) if bits == 8 else ("RGBA", (s[..., [0, 0, 0, 1]] >> 8).astype(np.uint8))
        else:
            mode, px = "RGBA", (s >> 8).astype(np.uint8) if bits == 16 else s
    except struct.error as e:  # a tRNS too short for its colour type fails Pillow's open
        raise PassOn(f"PNG: short tRNS chunk ({e})") from e
    return mode, np.ascontiguousarray(px), palette, transparency, bits


def read_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, C]: 8-bit gray, gray+alpha, RGB and RGBA
    without tRNS as stored (C = 1, 2, 3, 4), every other form RGBA as
    Pillow's convert("RGBA") gives it."""
    mode, px, palette, transparency, bits = _decode(data)
    if transparency is None and bits == 8 and mode in ("L", "LA", "RGB", "RGBA"):
        return px[..., None] if mode == "L" else px
    return to_rgba(mode, px, palette, transparency)


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
