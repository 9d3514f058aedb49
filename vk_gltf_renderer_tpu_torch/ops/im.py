"""IM reading without Pillow, as Pillow's ImImagePlugin reads IFUNC Image
Memory files.

Pillow registers IM without a magic check, so every data that reaches IM
in Image.open's order is parsed as an IM header: a newline in the first
100 bytes, then "Key: value" lines of at most 100 bytes ("\\r" skipped),
up to a NUL, a 0x1A or the end, at least one of Pillow's keys among them;
then the data after the next 0x1A (and the 768-byte "Lut" palette, planar
R, G, B, when the header has one), the bottom row first. A header Pillow's open cannot parse
(its SyntaxError, IndexError, TypeError, KeyError and struct.error) passes
the data on (PassOn); a number that is not one refuses it.

Image types read: "0 1" / "L 1" / "B1" ("1"), "B2" / "B4" (2- and 4-bit
"P", the palette a Lut gives, else black), "Greyscale"/"Grayscale" ("L",
"P" with a Lut that is not gray), "LA", "RGB", "RGBA", "RGBX", "CMYK"
(each line-interleaved, a row of each band in turn), "X 24" (RGB
pixels), "L 16", "L 16L", "L 16B", "L 32S", "L 32 S", "L 8", "L 8S",
"L 16S", "L 32", "L 32F", "L 32 F" and their "L*" forms (the float
modes), "PA" with a Lut that is not gray, as Pillow's raw unpackers read
them; "YCC" (Pillow's "YCbCr", converted by imagemodes.ycbcr_to_rgb), the
planar "RGB3" / "RYB3" (a G, an R and a B plane, each bottom row first)
and the "L*j" widths other than 8, 16 and 32, which Pillow's bit decoder
reads (native/image_coders.cpp vkgr_bit_decode). "RLB", "RYB" and "PA"
without such a Lut are refused, as Pillow refuses them (it has no unpacker
for them).
"""

from __future__ import annotations

import re

import numpy as np

from .dds import UnsupportedCodec
from .imagemodes import PassOn, check_size, native_rc, to_rgba

SIZE, MODE, FRAMES, SCALE, LUT = "Image size (x*y)", "Image type", "File size (no of images)", "Scale (x,y)", "Lut"
TAGS = ("Comment", "Date", "Digitalization equipment", FRAMES, LUT, "Name", SCALE, SIZE, MODE)
_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")

# Pillow's OPEN: image type -> (mode, raw mode), of the raw modes read here
OPEN = {"0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "B1 image": ("1", "1"), "Greyscale image": ("L", "L"),
        "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"), "X 24 image": ("RGB", "RGB"),
        "L 32 S image": ("I", "I;32"), "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
        "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
        "RGBA image": ("RGBA", "RGBA;L"),
        "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"), "L 32 F image": ("F", "F;32"),
        "RGB3 image": ("RGB", "RGB;T"), "RYB3 image": ("RGB", "RYB;T"), "YCC image": ("YCbCr", "YCbCr;L")}
for _t in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_t} image"] = OPEN[f"L*{_t} image"] = ("F", f"F;{_t}")
for _t in ("16", "16L", "16B"):
    OPEN[f"L {_t} image"] = OPEN[f"L*{_t} image"] = (f"I;{_t}", f"I;{_t}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):  # last, as in Pillow: "L*8", "L*16" and "L*32" are float too
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")
# types Pillow knows and has no unpacker for: it refuses them
_OTHER = ("RLB image", "RYB image")

# raw mode -> (numpy type of a sample, bands, line-interleaved)
_RAW = {"1": (None, 1, False), "P;2": (2, 1, False), "P;4": (4, 1, False), "L": ("u1", 1, False),
        "RGB": ("u1", 3, False), "RGB;L": ("u1", 3, True), "RGBA;L": ("u1", 4, True), "RGBX;L": ("u1", 4, True),
        "CMYK;L": ("u1", 4, True),
        "LA;L": ("u1", 2, True), "PA;L": ("u1", 2, True), "I;16": ("<u2", 1, False), "I;16L": ("<u2", 1, False),
        "I;16B": (">u2", 1, False), "I;32": ("<i4", 1, False), "I;32S": ("<i4", 1, False), "F;8": ("u1", 1, False),
        "F;8S": ("i1", 1, False), "F;16": ("<u2", 1, False), "F;16S": ("<i2", 1, False), "F;32": ("<u4", 1, False),
        "F;32F": ("<f4", 1, False), "P": ("u1", 1, False), "YCbCr;L": ("u1", 3, True)}


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)  # a ValueError here refuses the data, as it leaves Pillow's open


def _header(data: bytes):
    """Pillow's ImImageFile._open: -> (info, raw mode, offset of the pixels)."""
    if b"\n" not in data[:100]:
        raise PassOn("not an IM file")
    info = {MODE: "L", SIZE: (512, 512), FRAMES: 1}
    raw, n, pos, s = "L", 0, 0, b""
    while True:
        s = data[pos : pos + 1]
        pos += 1
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s += data[pos:end]
        pos = end
        if len(s) > 100:
            raise PassOn("not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _SPLIT.match(s)
        if not m:
            raise PassOn("IM: syntax error in the header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in (FRAMES, SCALE, SIZE):
            v = tuple(map(_number, v.replace("*", ",").split(",")))
            if len(v) == 1:
                v = v[0]
        elif k == MODE and v in OPEN:
            v, raw = OPEN[v]
        elif k == MODE and v in _OTHER:
            v, raw = v, None
        info[k] = v
        if k in TAGS:
            n += 1
    if not n:
        raise PassOn("not an IM file")
    while s and not s.startswith(b"\x1a"):
        s = data[pos : pos + 1]
        pos += 1
    if not s:
        raise PassOn("IM: file truncated")
    return info, raw, pos


def read_im(data: bytes):
    """IM bytes -> (mode, pixels, palette or None) of frame 0."""
    info, raw, pos = _header(data)
    size, mode = info[SIZE], info[MODE]
    if not isinstance(size, tuple) or len(size) < 2:
        raise PassOn("IM: a size Pillow cannot take")
    w, h = size[0], size[1]
    if not isinstance(w, int) or not isinstance(h, int):
        raise ValueError("IM: a size that is not whole")
    if w <= 0 or h <= 0:
        raise PassOn("IM: empty image")
    palette = None
    if LUT in info:
        lut = data[pos : pos + 768]
        if len(lut) < 768:
            raise PassOn("IM: palette cut short")  # Pillow's IndexError
        pos += 768
        p = np.frombuffer(lut, np.uint8).reshape(3, 256)
        gray = bool((p[0] == p[1]).all() and (p[1] == p[2]).all())
        if mode in ("L", "LA", "P", "PA") and not gray:
            mode, raw = ("P", "P") if mode in ("L", "P") else ("PA", "PA;L")
            palette = p.T.copy()
    check_size("IM", w, h)
    if raw in ("RGB;T", "RYB;T"):  # three planes, G, R and B (RYB3 too), each its bottom row first
        if pos + 3 * w * h > len(data):
            raise ValueError("IM: image file is truncated")
        g, r, b = np.frombuffer(data, np.uint8, 3 * w * h, pos).reshape(3, h, w)[:, ::-1]
        return mode, np.stack([r, g, b], axis=-1), None
    if raw and raw.startswith("F;") and raw[2:].isdigit() and int(raw[2:]) not in (8, 16, 32):
        return mode, _bits(data, pos, int(raw[2:]), w, h), None
    if (raw is None or raw not in _RAW or (mode, raw) == ("LA", "PA;L")  # Pillow has no unpacker for that pair
            or mode not in ("1", "L", "LA", "P", "PA", "RGB", "RGBA", "CMYK", "I", "F", "I;16", "I;16L", "I;16B",
                            "YCbCr")):
        raise UnsupportedCodec(f"IM: image type {mode!r} is not supported")
    dtype, bands, interleaved = _RAW[raw]
    if dtype is None or isinstance(dtype, int):  # bits MSB first: "1", or 2- and 4-bit indices
        stride = (w * (dtype or 1) + 7) // 8
    else:
        stride = w * bands * np.dtype(dtype).itemsize
    if pos + stride * h > len(data):
        raise ValueError("IM: image file is truncated")
    rows = np.frombuffer(data, np.uint8, stride * h, pos).reshape(h, stride)[::-1]  # bottom row first
    if dtype is None:
        return mode, np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255), None
    if isinstance(dtype, int):
        shifts = np.arange(8 - dtype, -1, -dtype, dtype=np.uint8)
        px = ((rows[:, :, None] >> shifts) & np.uint8((1 << dtype) - 1)).reshape(h, -1)[:, :w]
        return mode, np.ascontiguousarray(px), palette
    v = rows.view(dtype)
    v = v.reshape(h, bands, w).transpose(0, 2, 1) if interleaved else v.reshape(h, w, bands)
    if mode == "F":
        return mode, v[..., 0].astype(np.float32), None
    if mode in ("I", "I;16", "I;16L", "I;16B"):
        return ("I;16" if mode == "I;16L" else mode), v[..., 0].astype(np.int64), None
    return mode, np.ascontiguousarray(v[..., :{"RGB": 3, "RGBA": 4, "CMYK": 4, "LA": 2, "PA": 2, "YCbCr": 3}.get(mode, 1)]
                                      if mode not in ("L", "P") else v[..., 0]), palette


def _bits(data: bytes, pos: int, bits: int, w: int, h: int) -> np.ndarray:
    """Pillow's bit decoder as IM calls it (bits, pad 8, fill 3, unsigned,
    bottom row first): float32 [h, w]."""
    from ..native import image_lib

    src = np.frombuffer(data, np.uint8, len(data) - pos, pos)
    out = np.empty((h, w), np.float32)
    native_rc(image_lib().vkgr_bit_decode(src.ctypes.data, len(src), bits, w, h, out.ctypes.data), "IM")
    return out


def decode_im(data: bytes) -> np.ndarray:
    """IM bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    mode, px, palette = read_im(data)
    return to_rgba(mode, px, palette)
