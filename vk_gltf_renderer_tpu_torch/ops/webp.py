"""WebP images without Pillow: the RIFF container here, the pixel coding in
native/webp_decode.cpp (built by g++ at first use, like the JPEG coder).

decode_webp reads every form glTF's EXT_texture_webp can carry: a simple
lossy file (one VP8 chunk), a simple lossless file (VP8L) and an extended
file (VP8X) with an ALPH chunk (raw or VP8L-compressed alpha, unfiltered or
with the horizontal, vertical or gradient filter) beside a VP8 frame;
ICCP, EXIF, XMP and unknown chunks are skipped. An animated file decodes
its first frame, placed on a transparent canvas. The output is what
Pillow's WebP reader gives after .convert("RGBA") (libwebp's default
decode: fancy chroma upsampling, non-premultiplied alpha), bit for bit; a
file that declares no alpha comes out opaque.

A corrupt or truncated file raises ValueError; a form the decoder does
not handle (a VP8 inter frame) raises ops.dds.UnsupportedCodec; a coder
library that cannot be built or loaded raises RuntimeError.

encode_webp writes a lossless file (one VP8L chunk: the subtract-green
transform and one set of prefix codes, without LZ77 or a colour cache):
the pixels read back exactly, where Pillow would write lossy at quality
80 by default. encode_vp8l_stream writes the bare VP8L image stream of a
compressed ALPH chunk (or, with header, of a VP8L chunk).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .dds import UnsupportedCodec

# VP8X flag bits
_ALPHA_FLAG = 0x10
_ANIMATION_FLAG = 0x02


def is_webp(data: bytes) -> bool:
    return len(data) >= 12 and data[:4] == b"RIFF" and data[8:12] == b"WEBP"


def _lib():
    from ..native import webp_lib

    return webp_lib()


def _ptr(a) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _check(rc: int, what: str) -> None:
    if rc == -2:
        raise UnsupportedCodec(f"{what}: a form of the bitstream the decoder does not handle")
    if rc != 0:
        raise ValueError(f"{what}: corrupt or truncated")


def _u24(b: bytes, off: int) -> int:
    return b[off] | (b[off + 1] << 8) | (b[off + 2] << 16)


def _chunks(data: bytes, start: int, end: int):
    """(fourcc, payload) of each chunk in data[start:end]; chunks are padded to even sizes."""
    off = start
    while off < end:
        if off + 8 > end:
            raise ValueError("webp: truncated chunk header")
        fourcc = data[off:off + 4]
        size = struct.unpack_from("<I", data, off + 4)[0]
        if off + 8 + size > end:
            raise ValueError(f"webp: chunk {fourcc!r} runs past the end of the file")
        yield fourcc, data[off + 8:off + 8 + size]
        off += 8 + size + (size & 1)


def _vp8_size(payload: bytes) -> tuple[int, int]:
    if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
        raise ValueError("webp: not a VP8 key frame")
    w = struct.unpack_from("<H", payload, 6)[0] & 0x3FFF
    h = struct.unpack_from("<H", payload, 8)[0] & 0x3FFF
    return w, h


def _vp8l_size(payload: bytes) -> tuple[int, int, bool]:
    """(width, height, alpha_is_used) of a VP8L header: the signature 0x2f,
    then 14 + 14 bits of size less one, the alpha bit and a 3-bit version 0."""
    if len(payload) < 5 or payload[0] != 0x2F:
        raise ValueError("webp: not a VP8L stream")
    bits = int.from_bytes(payload[1:5], "little")
    if bits >> 29:
        raise ValueError("webp: unknown VP8L version")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool((bits >> 28) & 1)


def _decode_frame(image: tuple, alph: bytes | None) -> np.ndarray:
    """RGBA uint8 [H,W,4] of one VP8 or VP8L chunk, with the ALPH chunk's alpha beside a VP8 one."""
    fourcc, payload = image
    lib = _lib()
    buf = np.frombuffer(payload, np.uint8)
    if fourcc == b"VP8L":
        w, h, _ = _vp8l_size(payload)
        argb = np.empty(w * h, np.uint32)
        _check(lib.vkgr_vp8l_decode(_ptr(buf), buf.size, w, h, 1, _ptr(argb)), "webp VP8L")
        b = argb.view(np.uint8).reshape(h, w, 4)  # little endian: B G R A
        return np.ascontiguousarray(b[..., [2, 1, 0, 3]])
    w, h = _vp8_size(payload)
    rgba = np.empty((h, w, 4), np.uint8)
    _check(lib.vkgr_vp8_decode(_ptr(buf), buf.size, w, h, _ptr(rgba)), "webp VP8")
    if alph is not None:
        abuf = np.frombuffer(alph, np.uint8)
        alpha = np.empty((h, w), np.uint8)
        _check(lib.vkgr_alpha_decode(_ptr(abuf), abuf.size, w, h, _ptr(alpha)), "webp ALPH")
        rgba[..., 3] = alpha
    return rgba


def _frame_chunks(chunks) -> tuple:
    """(image chunk, ALPH payload or None) of a frame's chunk list."""
    alph = None
    for fourcc, payload in chunks:
        if fourcc == b"ALPH" and alph is None:
            alph = payload
        elif fourcc in (b"VP8 ", b"VP8L"):
            return (fourcc, payload), alph
    raise ValueError("webp: no VP8 or VP8L image data")


def decode_webp(data: bytes) -> np.ndarray:
    """WebP bytes -> uint8 RGBA [H,W,4] (see the module docstring)."""
    if not is_webp(data):
        raise ValueError("not a WebP file")
    riff_size = struct.unpack_from("<I", data, 4)[0]
    if riff_size < 12 or riff_size + 8 > len(data):
        raise ValueError("webp: truncated file")
    end = riff_size + 8
    chunks = list(_chunks(data, 12, end))
    if not chunks:
        raise ValueError("webp: no chunks")
    fourcc, payload = chunks[0]
    if fourcc == b"VP8 ":
        return _decode_frame(chunks[0], None)
    if fourcc == b"VP8L":
        rgba = _decode_frame(chunks[0], None)
        if not _vp8l_size(payload)[2]:
            rgba[..., 3] = 255
        return rgba
    if fourcc != b"VP8X" or len(payload) < 10:
        raise ValueError(f"webp: unknown first chunk {fourcc!r}")
    flags = payload[0]
    cw, ch = _u24(payload, 4) + 1, _u24(payload, 7) + 1
    has_alpha = bool(flags & _ALPHA_FLAG)
    if flags & _ANIMATION_FLAG:
        frame = next((p for f, p in chunks[1:] if f == b"ANMF"), None)
        if frame is None or len(frame) < 16:
            raise ValueError("webp: animation without a frame")
        x, y = 2 * _u24(frame, 0), 2 * _u24(frame, 3)
        fw, fh = _u24(frame, 6) + 1, _u24(frame, 9) + 1
        rgba = _decode_frame(*_frame_chunks(_chunks(frame, 16, len(frame))))
        if rgba.shape[:2] != (fh, fw) or x + fw > cw or y + fh > ch:
            raise ValueError("webp: frame does not fit its canvas")
        canvas = np.zeros((ch, cw, 4), np.uint8)  # transparent black
        canvas[y:y + fh, x:x + fw] = rgba
    else:
        image, alph = _frame_chunks(chunks[1:])
        canvas = _decode_frame(image, alph)
        if canvas.shape[:2] != (ch, cw):
            raise ValueError("webp: image size differs from the canvas size")
        if image[0] == b"VP8L":
            has_alpha = _vp8l_size(image[1])[2]
        else:
            has_alpha = has_alpha or alph is not None
    if not has_alpha:
        canvas[..., 3] = 255
    return canvas


def _argb(u8: np.ndarray) -> np.ndarray:
    img = np.asarray(u8, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    c = img.shape[2]
    rgb = np.repeat(img[..., :1], 3, axis=2) if c in (1, 2) else img[..., :3]
    a = img[..., -1] if c in (2, 4) else np.full(img.shape[:2], 255, np.uint8)
    return ((a.astype(np.uint32) << 24) | (rgb[..., 0].astype(np.uint32) << 16)
            | (rgb[..., 1].astype(np.uint32) << 8) | rgb[..., 2].astype(np.uint32))


def encode_vp8l_stream(argb: np.ndarray, header: bool = True) -> bytes:
    """uint32 ARGB [H,W] -> a VP8L image stream (header: the 5-byte VP8L
    header with the alpha_is_used bit, as a VP8L chunk holds; without it,
    the stream of a compressed ALPH chunk, whose alpha is the green)."""
    argb = np.ascontiguousarray(argb, np.uint32)
    h, w = argb.shape
    if not (1 <= w <= 16384 and 1 <= h <= 16384):
        raise ValueError(f"webp: {w}x{h} is outside 1..16384")
    cap = 8 * w * h + 4096  # 4 codes of at most 15 bits a pixel, and the prefix codes
    out = np.empty(cap, np.uint8)
    size = ctypes.c_int64()
    alpha_used = int((argb >> 24 != 255).any())
    rc = _lib().vkgr_vp8l_encode(_ptr(argb), w, h, int(header), alpha_used, _ptr(out), cap, ctypes.byref(size))
    if rc != 0:
        raise RuntimeError(f"webp encode failed ({rc})")
    return out[:size.value].tobytes()


def riff(chunks: list) -> bytes:
    """A WebP file of (fourcc, payload) chunks, each padded to an even size."""
    body = b"".join(f + struct.pack("<I", len(p)) + p + b"\0" * (len(p) & 1) for f, p in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def encode_webp(u8: np.ndarray) -> bytes:
    """uint8 [H,W], [H,W,1|2|3|4] -> a lossless WebP file (one VP8L chunk)."""
    return riff([(b"VP8L", encode_vp8l_stream(_argb(u8)))])
