"""FITS reading without Pillow, as Pillow's FitsImagePlugin reads FITS
images: 80-byte header cards from "SIMPLE = T", each header unit padded to
2880 bytes; the first unit (or XTENSION unit) with a size picks the image:
BITPIX 8 "L", 16 "I;16", 32 "I", -32 and -64 "F", read with Pillow's raw
modes of those names (little-endian, as Pillow reads them, though FITS
stores big-endian), the bottom row first; a BINTABLE unit with ZIMAGE = T
and ZCMPTYPE = 'GZIP_1' holds a gzip stream after its table, ZNAXIS1 x
ZNAXIS2 four-byte samples of which Pillow keeps the last ZBITPIX / 8
bytes, rows reversed (a float ZBITPIX keeps none, and Pillow then fails).
The card loop, its KeyError and SyntaxError pass-ons and its ValueError
refusals follow FitsImageFile._open line by line.
"""

from __future__ import annotations

import gzip
import io
import math
import zlib

import numpy as np

from .imagemodes import PassOn, check_size, to_rgba


def is_fits(data: bytes) -> bool:
    return data[:6] == b"SIMPLE"


def _size(headers: dict, prefix: bytes):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _parse(headers: dict):
    """FitsImageFile._parse_headers -> (decoder, offset, size, mode, bits)."""
    prefix, decoder, offset = b"", "raw", 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        plain = _size(headers, prefix) or (0, 0)
        offset = plain[0] * plain[1] * (int(headers[b"BITPIX"]) // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = _size(headers, prefix)
    if not size:
        return "", 0, None, "", 0
    bits = int(headers[prefix + b"BITPIX"])
    mode = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}.get(bits, "")
    return decoder, offset, size, mode, bits


def _header(data: bytes):
    fp = io.BytesIO(data)
    headers, in_progress, decoder = {}, False, ""
    while True:
        card = fp.read(80)
        if not card:
            raise ValueError("Truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break
        elif keyword == b"END":
            fp.seek(math.ceil(fp.tell() / 2880) * 2880)
            if not decoder:
                decoder, offset, size, mode, bits = _parse(headers)
            in_progress = False
            continue
        if decoder:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not is_fits(keyword) or value != b"T"):
            raise PassOn("Not a FITS file")
        headers[keyword] = value
    if not decoder:
        raise ValueError("No image data")
    return decoder, offset + fp.tell() - 80, size, mode, bits


def read_fits(data: bytes):
    """FITS bytes -> (mode, pixels [H, W])."""
    try:
        decoder, offset, size, mode, bits = _header(data)
    except KeyError as e:
        raise PassOn(f"FITS: no {e}") from e
    w, h = size
    if not mode or w <= 0 or h <= 0:
        raise PassOn("FITS: no mode or an empty image")
    check_size("FITS", w, h)
    dtype = {"L": "u1", "I;16": "<u2", "I": "<i4", "F": "<f4"}[mode]
    itemsize = np.dtype(dtype).itemsize
    if decoder == "raw":
        if offset + w * h * itemsize > len(data):
            raise ValueError("FITS: image file is truncated")
        px = np.frombuffer(data, dtype, w * h, offset).reshape(h, w)[::-1]
    else:
        try:
            value = gzip.decompress(data[offset:])
        except (OSError, EOFError, zlib.error) as e:
            raise ValueError(f"FITS: corrupt GZIP_1 data ({e})") from e
        keep = min(bits // 8, 4)
        if keep <= 0 or len(value) < 4 * w * h:  # FitsGzipDecoder then hands set_as_raw too few bytes
            raise ValueError("FITS: not enough image data")
        samples = np.frombuffer(value, np.uint8, 4 * w * h).reshape(h, w, 4)[::-1, :, 4 - keep:]
        px = np.ascontiguousarray(samples).view(dtype).reshape(h, w)
    return mode, px.astype(np.float32) if mode == "F" else px.astype(np.int64)


def decode_fits(data: bytes) -> np.ndarray:
    """FITS bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    mode, px = read_fits(data)
    return to_rgba(mode, px)
