"""IPTC/NAA reading without Pillow, as Pillow's IptcImagePlugin reads an
IPTC record holding an image: 0x1C-tagged fields up to the first (8, 10)
field; (3, 60) gives the layers and component (1 layer without a component
is "L"; 3 or 4 layers with a component "RGB" or "CMYK", of which band
(3, 65) - 1, or the first, holds the image and the others are zero),
(3, 20) and (3, 30) the size, (3, 120) the compression (1 raw, 5 JPEG).
The (8, 10) fields' data, after Pillow's "P5" header for raw data, are
opened as Pillow opens them (raw data as a PGM, JPEG through ops/jpeg.py,
anything else by utils/image_io's readers). Pillow registers IPTC without
a magic check, so every data that reaches it is parsed as its field reader
parses it (emulated on the same reads), and what its open cannot parse
passes on (PassOn).
"""

from __future__ import annotations

import io
import struct

import numpy as np

from .imagemodes import PassOn, check_size

_TAG_RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)


class _Parse(Exception):
    """An error that Pillow's ImageFile turns into a pass-on (IndexError,
    TypeError, KeyError, struct.error, SyntaxError)."""


def _i(c) -> int:
    if not isinstance(c, (bytes, bytearray)):
        raise _Parse("not bytes")
    return struct.unpack(">I", (b"\0\0\0\0" + c)[-4:])[0]


def _field(fp):
    """IptcImageFile.field -> (tag or None, size)."""
    s = fp.read(5)
    if not s.strip(b"\x00"):
        return None, 0
    if len(s) < 3:
        raise _Parse("short field")
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in _TAG_RECORDS:
        raise _Parse("invalid IPTC/NAA file")
    if len(s) < 4:
        raise _Parse("short field")
    size = s[3]
    if size > 132:
        raise ValueError("illegal field length in IPTC/NAA file")
    if size == 128:
        return tag, 0
    if size > 128:
        return tag, _i(fp.read(size - 128))
    if len(s) < 5:
        raise _Parse("short field")
    return tag, struct.unpack_from(">H", s, 3)[0]


def _open(data: bytes):
    """IptcImageFile._open -> (mode, size, band, compression, offset)."""
    fp = io.BytesIO(data)
    info = {}
    while True:
        offset = fp.tell()
        tag, size = _field(fp)
        if not tag or tag == (8, 10):
            break
        tagdata = fp.read(size) if size else None
        if tag in info:
            info[tag] = info[tag] + [tagdata] if isinstance(info[tag], list) else [info[tag], tagdata]
        else:
            info[tag] = tagdata
    try:
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
    except (KeyError, IndexError, TypeError) as e:
        raise _Parse(f"no layers ({e!r})") from e
    mode, band = "", None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        if (3, 65) in info:
            try:
                band = info[(3, 65)][0] - 1
            except (IndexError, TypeError) as e:
                raise _Parse(f"bad band ({e!r})") from e
        else:
            band = 0
    if (3, 20) not in info or (3, 30) not in info:
        raise _Parse("no size")
    size = _i(info[(3, 20)]), _i(info[(3, 30)])
    if (3, 120) not in info:
        raise ValueError("Unknown IPTC image compression")
    compression = {1: "raw", 5: "jpeg"}.get(_i(info[(3, 120)]))
    if compression is None:
        raise ValueError("Unknown IPTC image compression")
    return mode, size, band, compression, offset if tag == (8, 10) else None


def read_iptc(data: bytes):
    """IPTC bytes -> uint8 [H, W, C], as Pillow's convert("RGBA") would
    expand it (the image Pillow opens inside, merged into its band)."""
    try:
        mode, (w, h), band, compression, offset = _open(data)
    except _Parse as e:
        raise PassOn(f"IPTC: {e}") from e
    if not mode or w <= 0 or h <= 0:
        raise PassOn("IPTC: no mode or an empty image")
    check_size("IPTC", w, h)
    if offset is None:
        raise ValueError("IPTC: cannot load this image (no image data)")
    fp = io.BytesIO(data)
    fp.seek(offset)
    out = io.BytesIO()
    if compression == "raw":
        out.write(b"P5\n%d %d\n255\n" % (w, h))
    while True:
        try:
            tag, size = _field(fp)
        except _Parse as e:
            raise ValueError(f"IPTC: {e}") from e
        if tag != (8, 10):
            break
        out.write(fp.read(size))
    if compression == "raw":  # a PGM of maxval 255: "L"
        from .netpbm import read_netpbm

        mode_in, inner = read_netpbm(out.getvalue())[:2]
        inner = np.asarray(inner, np.uint8).reshape(inner.shape[0], inner.shape[1], -1)[..., :1]
    else:
        from ..utils.image_io import identify_and_read

        fmt, inner = identify_and_read(out.getvalue())
        if band is not None and inner.shape[2] != 1:  # Image.merge of an inner image that is not "L"
            raise ValueError(f"IPTC: an inner {fmt} image that is not gray")
    if band is None:
        return inner
    bands = 3 if mode == "RGB" else 4
    if not -bands <= band < bands:
        raise ValueError("IPTC: a band past the image's bands")
    px = np.zeros(inner.shape[:2] + (bands,), np.uint8)
    px[..., band] = inner[..., 0]
    if mode == "CMYK":
        from .imagemodes import to_rgba

        return to_rgba("CMYK", px)
    return px


def decode_iptc(data: bytes) -> np.ndarray:
    """IPTC bytes -> uint8 [H, W, C]."""
    return read_iptc(data)

