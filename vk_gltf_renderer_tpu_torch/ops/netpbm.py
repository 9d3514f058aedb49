"""Netpbm (PBM, PGM, PPM, PFM) reading and writing without Pillow, as
Pillow's PpmImagePlugin reads and writes them.

Reading: P1-P6 plain and raw, comments, maxval 1..65535, Pf (gray float,
the scale's sign giving the byte order, rows bottom-up), and the PyP,
PyRGBA, PyCMYK and P0CMYK forms of Pillow's tests. The header is read token
by token as Pillow reads it (a comment runs to CR or LF and does not end a
token; a token is at most 10 bytes; numbers are Python's int and float of
the token). Sample values map to Pillow's modes as its decoders map them:

  * raw samples at maxval 255 are taken as they are; a gray file at maxval
    65535 is the 16-bit mode "I" as it is; any other maxval scales each
    value v to round(v / maxval * 255), or to 65535 for gray above 255
    ("I" mode, which convert("RGBA") then clips to 255);
  * plain files scale the same way, and refuse a value above maxval;
  * P1 and P4 are mode "1", a set bit black.

write_netpbm writes what Image.fromarray(a).save(path) writes for a .ppm,
.pgm, .pbm or .pnm path: P5 for gray, P6 for RGB and RGBA (alpha dropped),
maxval 255.
"""

from __future__ import annotations

import math

import numpy as np

from .dds import UnsupportedCodec
from .imagemodes import to_rgba

WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"
MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
         b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}


def is_netpbm(data: bytes) -> bool:
    """Pillow's PpmImagePlugin._accept."""
    return len(data) >= 2 and data[:1] == b"P" and data[1] in b"0123456fy"


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read1(self) -> bytes:
        c = self.data[self.pos : self.pos + 1]
        self.pos += len(c)
        return c

    def magic(self) -> bytes:
        m = b""
        for _ in range(6):
            c = self.read1()
            if not c or c in WHITESPACE:
                break
            m += c
        return m

    def token(self) -> bytes:
        tok = b""
        while len(tok) <= 10:
            c = self.read1()
            if not c:
                break
            if c in WHITESPACE:
                if not tok:
                    continue
                break
            if c == b"#":
                while self.read1() not in b"\r\n":  # b"" (the end) is in it too
                    pass
                continue
            tok += c
        if not tok:
            raise ValueError("Netpbm: the header ends early")
        if len(tok) > 10:
            raise ValueError("Netpbm: a header token longer than 10 bytes")
        return tok


SAFEBLOCK = 1024 * 1024  # Pillow's ImageFile.SAFEBLOCK: the plain decoders read blocks this long


class _PlainBlocks:
    """The data after the header in Pillow's PpmPlainDecoder blocks, each
    with its comments removed (a comment runs to and with the next CR or
    LF, also across blocks)."""

    def __init__(self, body: bytes):
        self.body, self.pos, self.spans = body, 0, False

    def _read(self) -> bytes:
        b = self.body[self.pos : self.pos + SAFEBLOCK]
        self.pos += len(b)
        return b

    @staticmethod
    def _comment_end(block: bytes, start: int = 0) -> int:
        ends = [e for e in (block.find(b"\n", start), block.find(b"\r", start)) if e >= 0]
        return min(ends) if ends else -1

    def next(self) -> bytes:
        block = self._read()
        if self.spans:
            while block:
                e = self._comment_end(block)
                if e != -1:
                    block = block[e + 1 :]
                    break
                block = self._read()
        self.spans = False
        while True:
            k = block.find(b"#")
            if k == -1:
                break
            e = self._comment_end(block, k)
            if e != -1:
                block = block[:k] + block[e + 1 :]
            else:
                block = block[:k]
                self.spans = True
                break
        return block


def _plain_bits(body: bytes, count: int) -> bytes:
    """PpmPlainDecoder._decode_bitonal: '0'/'1' bytes, whitespace ignored."""
    blocks, data = _PlainBlocks(body), b""
    while len(data) != count:
        if blocks.pos >= len(blocks.body):
            break
        tokens = b"".join(blocks.next().split())
        if set(tokens) - {48, 49}:
            raise ValueError("Netpbm: a P1 token other than 0 or 1")
        data = (data + tokens)[:count]
    return data


def _plain_values(body: bytes, count: int, maxval: int, out_max: int) -> list:
    """PpmPlainDecoder._decode_blocks: decimal tokens, scaled."""
    blocks, vals, half = _PlainBlocks(body), [], b""
    while len(vals) != count:
        if blocks.pos >= len(blocks.body):
            if not half:
                break
            block = b" "
        else:
            block = blocks.next()
        if half:
            block, half = half + block, b""
        tokens = block.split()
        if block and not block[-1:].isspace():
            half = tokens.pop()
            if len(half) > 10:
                raise ValueError("Netpbm: a sample token longer than 10 bytes")
        for tok in tokens:
            if len(tok) > 10:
                raise ValueError("Netpbm: a sample token longer than 10 bytes")
            v = int(tok)
            if v < 0 or v > maxval:
                raise ValueError(f"Netpbm: sample {v} outside 0..{maxval}")
            vals.append(round(v / maxval * out_max))
            if len(vals) == count:
                break
    return vals


def read_netpbm(data: bytes):
    """Netpbm bytes -> (mode, pixels) in Pillow's mode for the file."""
    r = _Reader(data)
    magic = r.magic()
    if magic not in MODES:
        raise UnsupportedCodec("not a Netpbm file Pillow reads")
    mode = MODES[magic]
    w, h = int(r.token()), int(r.token())
    if w <= 0 or h <= 0:
        raise ValueError("Netpbm: empty image")
    plain = magic in (b"P1", b"P2", b"P3")
    if mode == "1":
        if plain:
            digits = _plain_bits(data[r.pos :], w * h)
            if len(digits) < w * h:
                raise ValueError("Netpbm: not enough image data")
            bits = np.frombuffer(digits, np.uint8) == 48
            return "1", np.where(bits, 255, 0).astype(np.uint8).reshape(h, w)
        stride = (w + 7) // 8
        body = np.frombuffer(data, np.uint8, offset=r.pos)
        if len(body) < stride * h:
            raise ValueError("Netpbm: truncated P4 data")
        bits = np.unpackbits(body[: stride * h].reshape(h, stride), axis=1)[:, :w]
        return "1", np.where(bits == 0, 255, 0).astype(np.uint8)
    if mode == "F":
        scale = float(r.token())
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("Netpbm: PFM scale must be finite and non-zero")
        n = w * h * 4
        if len(data) - r.pos < n:
            raise ValueError("Netpbm: truncated PFM data")
        px = np.frombuffer(data, "<f4" if scale < 0 else ">f4", count=w * h, offset=r.pos)
        return "F", px.reshape(h, w)[::-1].astype(np.float32)
    maxval = int(r.token())
    if not 0 < maxval < 65536:
        raise ValueError("Netpbm: maxval must be in 1..65535")
    if maxval > 255 and mode == "L":
        mode = "I"
    bands = BANDS[mode]
    count = w * h * bands
    shape = (h, w, bands) if bands > 1 else (h, w)
    if plain:
        vals = _plain_values(data[r.pos :], count, maxval, 65535 if mode == "I" else 255)
        if len(vals) < count:
            raise ValueError("Netpbm: not enough image data")
        return mode, np.asarray(vals, np.int64).reshape(shape)
    in_bytes = 1 if maxval < 256 else 2
    if len(data) - r.pos < count * in_bytes:
        raise ValueError("Netpbm: truncated data")
    raw = np.frombuffer(data, np.uint8 if in_bytes == 1 else ">u2", count=count, offset=r.pos)
    if maxval == 255 or (maxval == 65535 and mode == "I"):
        return mode, raw.reshape(shape).astype(np.int64 if mode == "I" else np.uint8)
    out_max = 65535 if mode == "I" else 255
    v = np.minimum(out_max, np.round(raw.astype(np.float64) / maxval * out_max))
    return mode, v.astype(np.int64).reshape(shape)


def decode_netpbm(data: bytes) -> np.ndarray:
    """Netpbm bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    mode, px = read_netpbm(data)
    if mode in ("RGB", "RGBA", "CMYK", "P"):
        px = px.astype(np.uint8)
    # a "P" file has no palette: Pillow's default is black for every entry
    return to_rgba(mode, px, palette=np.zeros((0, 3), np.uint8) if mode == "P" else None)


def encode_netpbm(u8: np.ndarray) -> bytes:
    """uint8 [H, W] (gray), [H, W, 3] or [H, W, 4] -> Pillow's P5 or P6 file
    (RGBA written as RGB)."""
    a = np.asarray(u8, np.uint8)
    h, w = a.shape[:2]
    if a.ndim == 2:
        return b"P5\n%d %d\n255\n" % (w, h) + a.tobytes()
    return b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(a[..., :3]).tobytes()
