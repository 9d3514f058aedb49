"""TIFF reading (page 0) and writing without Pillow, as Pillow's
TiffImagePlugin reads (with libtiff under it for compressed data) and
writes it.

Reading: little- and big-endian files, classic and BigTIFF; strips and
tiles (edge tiles clipped); PlanarConfiguration 1 and 2; compression none,
LZW (with libtiff's old-style form) and PackBits through
native/image_coders.cpp, Deflate (8 and 32946) through zlib, Predictor 2
at 8, 16 and 32 bits, and JPEG (7) through ops/jpeg.py with the
JPEGTables stream merged in front of each strip (YCbCr converted to RGB,
RGB and gray taken as they are, as libtiff asks libjpeg); FillOrder 2.
The file's (photometric, sample format, bits, extra samples) key picks
Pillow's mode and raw mode from a copy of Pillow's OPEN_INFO table, and a
key Pillow does not know is refused. The raw modes map as Pillow's
unpackers map them: WhiteIsZero inverted at 1, 2, 4 and 8 bits (not at
16), 2- and 4-bit gray scaled by 85 and 17, 16-bit colour samples to their
high byte, associated alpha un-premultiplied (v * 255 // a, 0 where a is
0), the colour map's high bytes as the palette. The Orientation tag is
applied as Pillow 12's load_end applies it (ImageOps.exif_transpose: flips,
rotations and transposes, the size swapped for 5-8). The codecs Pillow
reads through libtiff: CCITT modified Huffman (2), T.4 (3, one- and
two-dimensional, T4Options) and T.6 (4), and ThunderScan through
native/image_coders.cpp (black runs as set bits, as libtiff hands them to
Pillow's "1" and "1;I" raw modes); LZMA (34925) through the standard
library's lzma; ZSTD (50000) through the port's own Zstandard decoder
(ops/zstd.py); the floating-point predictor (3); 12-bit gray (Pillow's
"I;12" raw mode, MSB-first fields); YCbCr that JPEG did not code, as
libtiff's TIFFRGBAImage converts it for Pillow (each data unit's chroma
over its hs x vs pixels, TIFFYCbCrtoRGB's fixed-point tables from the
coefficients and ReferenceBlackWhite); old-style JPEG (6), whose stream
(the strip, or the JPEGInterchangeFormat bytes) libtiff's OJPEG codec
decodes to raw, not upsampled YCbCr planes (ops/jpeg.py's "planes"), in
data units of the JPEG's luma sampling, which then go through that same
YCbCr conversion; CIELab (8), Pillow's "LAB" raw mode (a* and b* signed,
stored plus 128) converted as Pillow converts LAB (ops/imagemodes.py's
LittleCMS transform). WebP (this Pillow's libtiff has no WebP codec, so
the JAX package refuses it too) and SGILog (no mode in Pillow's table)
raise UnsupportedCodec; uncompressed YCbCr, which Pillow reads with a
four-byte raw mode, raises ValueError.

encode_tiff writes what Image.fromarray(a).save(path) writes: little
endian, uncompressed, one strip (RowsPerStrip = height), Pillow's tags in
Pillow's order and types, the IFD at offset 8 and the pixels after it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .dds import UnsupportedCodec
from .imagemodes import check_size, to_rgba

PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00")

# Pillow's COMPRESSION_INFO; the names this module decodes
COMPRESSIONS = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4", 5: "tiff_lzw", 6: "tiff_jpeg", 7: "jpeg",
                8: "tiff_adobe_deflate", 32771: "tiff_raw_16", 32773: "packbits", 32809: "tiff_thunderscan",
                32946: "tiff_deflate", 34676: "tiff_sgilog", 34677: "tiff_sgilog24", 34925: "lzma", 50000: "zstd",
                50001: "webp"}
DECODED = ("raw", "tiff_lzw", "packbits", "tiff_adobe_deflate", "tiff_deflate", "jpeg", "tiff_ccitt", "group3", "group4",
           "lzma", "tiff_thunderscan", "zstd", "tiff_jpeg")
CCITT = {"tiff_ccitt": 2, "group3": 3, "group4": 4}

# Pillow's OPEN_INFO: (byte orders, photometric, sample format, fill order, bits, extra samples) -> (mode,
# raw mode); "*" is both byte orders
_OPEN_INFO_ROWS = [
    ("*", 0, (1,), 1, (1,), (), "1", "1;I"), ("*", 0, (1,), 2, (1,), (), "1", "1;IR"),
    ("*", 1, (1,), 1, (1,), (), "1", "1"), ("*", 1, (1,), 2, (1,), (), "1", "1;R"),
    ("*", 0, (1,), 1, (2,), (), "L", "L;2I"), ("*", 0, (1,), 2, (2,), (), "L", "L;2IR"),
    ("*", 1, (1,), 1, (2,), (), "L", "L;2"), ("*", 1, (1,), 2, (2,), (), "L", "L;2R"),
    ("*", 0, (1,), 1, (4,), (), "L", "L;4I"), ("*", 0, (1,), 2, (4,), (), "L", "L;4IR"),
    ("*", 1, (1,), 1, (4,), (), "L", "L;4"), ("*", 1, (1,), 2, (4,), (), "L", "L;4R"),
    ("*", 0, (1,), 1, (8,), (), "L", "L;I"), ("*", 0, (1,), 2, (8,), (), "L", "L;IR"),
    ("*", 1, (1,), 1, (8,), (), "L", "L"), ("*", 1, (2,), 1, (8,), (), "L", "L"),
    ("*", 1, (1,), 2, (8,), (), "L", "L;R"),
    ("II", 1, (1,), 1, (12,), (), "I;16", "I;12"),
    ("II", 0, (1,), 1, (16,), (), "I;16", "I;16"), ("II", 1, (1,), 1, (16,), (), "I;16", "I;16"),
    ("MM", 1, (1,), 1, (16,), (), "I;16B", "I;16B"), ("II", 1, (1,), 2, (16,), (), "I;16", "I;16R"),
    ("II", 1, (2,), 1, (16,), (), "I", "I;16S"), ("MM", 1, (2,), 1, (16,), (), "I", "I;16BS"),
    ("II", 0, (3,), 1, (32,), (), "F", "F;32F"), ("MM", 0, (3,), 1, (32,), (), "F", "F;32BF"),
    ("II", 1, (1,), 1, (32,), (), "I", "I;32N"), ("II", 1, (2,), 1, (32,), (), "I", "I;32S"),
    ("MM", 1, (2,), 1, (32,), (), "I", "I;32BS"),
    ("II", 1, (3,), 1, (32,), (), "F", "F;32F"), ("MM", 1, (3,), 1, (32,), (), "F", "F;32BF"),
    ("*", 1, (1,), 1, (8, 8), (2,), "LA", "LA"),
    ("*", 2, (1,), 1, (8, 8, 8), (), "RGB", "RGB"), ("*", 2, (1,), 2, (8, 8, 8), (), "RGB", "RGB;R"),
    ("*", 2, (1,), 1, (8, 8, 8, 8), (), "RGBA", "RGBA"),
    ("*", 2, (1,), 1, (8, 8, 8, 8), (0,), "RGB", "RGBX"),
    ("*", 2, (1,), 1, (8, 8, 8, 8, 8), (0, 0), "RGB", "RGBXX"),
    ("*", 2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0), "RGB", "RGBXXX"),
    ("*", 2, (1,), 1, (8, 8, 8, 8), (1,), "RGBA", "RGBa"),
    ("*", 2, (1,), 1, (8, 8, 8, 8, 8), (1, 0), "RGBA", "RGBaX"),
    ("*", 2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0), "RGBA", "RGBaXX"),
    ("*", 2, (1,), 1, (8, 8, 8, 8), (2,), "RGBA", "RGBA"),
    ("*", 2, (1,), 1, (8, 8, 8, 8, 8), (2, 0), "RGBA", "RGBAX"),
    ("*", 2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0), "RGBA", "RGBAXX"),
    ("*", 2, (1,), 1, (8, 8, 8, 8), (999,), "RGBA", "RGBA"),
    ("II", 2, (1,), 1, (16, 16, 16), (), "RGB", "RGB;16L"), ("MM", 2, (1,), 1, (16, 16, 16), (), "RGB", "RGB;16B"),
    ("II", 2, (1,), 1, (16, 16, 16, 16), (), "RGBA", "RGBA;16L"),
    ("MM", 2, (1,), 1, (16, 16, 16, 16), (), "RGBA", "RGBA;16B"),
    ("II", 2, (1,), 1, (16, 16, 16, 16), (0,), "RGB", "RGBX;16L"),
    ("MM", 2, (1,), 1, (16, 16, 16, 16), (0,), "RGB", "RGBX;16B"),
    ("II", 2, (1,), 1, (16, 16, 16, 16), (1,), "RGBA", "RGBa;16L"),
    ("MM", 2, (1,), 1, (16, 16, 16, 16), (1,), "RGBA", "RGBa;16B"),
    ("II", 2, (1,), 1, (16, 16, 16, 16), (2,), "RGBA", "RGBA;16L"),
    ("MM", 2, (1,), 1, (16, 16, 16, 16), (2,), "RGBA", "RGBA;16B"),
    ("*", 3, (1,), 1, (1,), (), "P", "P;1"), ("*", 3, (1,), 2, (1,), (), "P", "P;1R"),
    ("*", 3, (1,), 1, (2,), (), "P", "P;2"), ("*", 3, (1,), 2, (2,), (), "P", "P;2R"),
    ("*", 3, (1,), 1, (4,), (), "P", "P;4"), ("*", 3, (1,), 2, (4,), (), "P", "P;4R"),
    ("*", 3, (1,), 1, (8,), (), "P", "P"), ("*", 3, (1,), 1, (8, 8), (0,), "P", "PX"),
    ("*", 3, (1,), 1, (8, 8), (2,), "PA", "PA"), ("*", 3, (1,), 2, (8,), (), "P", "P;R"),
    ("*", 5, (1,), 1, (8, 8, 8, 8), (), "CMYK", "CMYK"),
    ("*", 5, (1,), 1, (8, 8, 8, 8, 8), (0,), "CMYK", "CMYKX"),
    ("*", 5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0), "CMYK", "CMYKXX"),
    ("II", 5, (1,), 1, (16, 16, 16, 16), (), "CMYK", "CMYK;16L"),
    ("MM", 5, (1,), 1, (16, 16, 16, 16), (), "CMYK", "CMYK;16B"),
    ("*", 6, (1,), 1, (8,), (), "L", "L"), ("*", 6, (1,), 1, (8, 8, 8), (), "RGB", "RGBX"),
    ("*", 8, (1,), 1, (8, 8, 8), (), "LAB", "LAB"),
]
OPEN_INFO = {}
for _o, *_key, _mode, _raw in _OPEN_INFO_ROWS:
    for _order in (("II", "MM") if _o == "*" else (_o,)):
        OPEN_INFO[(_order, *_key)] = (_mode, _raw)

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii", 11: "f", 12: "d",
          13: "I", 16: "Q", 17: "q", 18: "Q"}
_REVERSE_BITS = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def is_tiff(data: bytes) -> bool:
    return data[:4] in PREFIXES


def _lib():
    from ..native import image_lib

    return image_lib()


STRIP_TAGS = (273, 279, 324, 325)
# The tags Pillow's TiffImageFile._setup reads as numbers: an ASCII value there (a str in Pillow) fails its open.
# Not among them: the photometric interpretation of old-style JPEG data (Pillow sets 6 in its place), and the
# planar configuration of uncompressed data (a str is not 2: the samples read as contiguous)
PILLOW_NUMERIC = (256, 257, 258, 259, 266, 273, 277, 278, 322, 323, 324, 338, 339)
# The numeric tags this reader takes from libtiff's directory: libtiff skips one whose type is ASCII
# ("Incompatible type"), keeping its default, and fails the directory when it is a strip or tile array
LIBTIFF_NUMERIC = (*PILLOW_NUMERIC, 274, 279, 292, 317, 320, 325, 513, 514, 529, 530, 532)


def _read_ifd(data: bytes):
    """Page 0's tags: tag -> tuple of values (bytes for ASCII and UNDEFINED),
    as Pillow's directory reader reads them: a tag whose values lie past the
    end of the file stops it, the tags before that one kept. Also the tags
    libtiff reads from the whole directory, which decodes compressed data
    (-> order, byte order, tags, libtiff's tags): it skips a tag whose values
    run past the end, but of the strip or tile offsets and byte counts it
    reads only as many as the image has strips (TIFFFetchStripThing), here
    those that lie in the file."""
    bo = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"\x2b\x00", b"\x00\x2b")
    try:
        if big:
            off = struct.unpack_from(bo + "Q", data, 8)[0]
            (n,) = struct.unpack_from(bo + "Q", data, off)
            ent, esize, inline = off + 8, 20, 8
        else:
            off = struct.unpack_from(bo + "I", data, 4)[0]
            (n,) = struct.unpack_from(bo + "H", data, off)
            ent, esize, inline = off + 2, 12, 4
        tags, full, cut = {}, {}, False
        for i in range(n):
            e = ent + i * esize
            tag, typ = struct.unpack_from(bo + "HH", data, e)
            count = struct.unpack_from(bo + ("Q" if big else "I"), data, e + 4)[0]
            if typ not in _TYPES:
                continue
            fmt = _TYPES[typ]
            size = struct.calcsize("=" + fmt) * count
            voff = e + (12 if big else 8)
            if size > inline:
                voff = struct.unpack_from(bo + ("Q" if big else "I"), data, voff)[0]
            if voff + size > len(data):
                cut = True
                if tag not in STRIP_TAGS:
                    continue
                count = max(len(data) - voff, 0) // struct.calcsize("=" + fmt)
            if typ in (2, 7):
                vals = (data[voff : voff + count],)
            else:
                vals = struct.unpack_from(bo + fmt * count, data, voff)
                if typ in (5, 10):
                    vals = tuple(a / b if b else float("nan") for a, b in zip(vals[::2], vals[1::2]))
            if not cut:
                tags[tag] = vals
            if typ == 2 and tag in LIBTIFF_NUMERIC:  # libtiff skips it, or fails on a strip or tile array
                if tag in STRIP_TAGS:
                    full[tag] = None
                continue
            full[tag] = vals
    except struct.error as e:
        raise ValueError(f"TIFF: truncated directory ({e})") from e
    return ("II" if bo == "<" else "MM"), bo, tags, full


def _byte_counts(tags, tag):
    """The strip or tile byte counts; None where the tag is absent, or ASCII
    (Pillow's reader of uncompressed data does not need them)."""
    v = tags.get(tag)
    return None if v is None or isinstance(v[0], bytes) else v


def _scalar(tags, tag, default=None):
    v = tags.get(tag)
    return v[0] if v else default


def _samples(rows: np.ndarray, bits: int, nsamp: int, width: int, bo: str, sfmt: int) -> np.ndarray:
    """[h, row bytes] -> samples [h, width, nsamp] (integers, or float32)."""
    h = rows.shape[0]
    if bits < 8 or bits == 12:  # MSB-first bit fields (Pillow's "I;12" unpacker reads 12-bit ones so)
        b = np.unpackbits(rows, axis=1)[:, : width * nsamp * bits].reshape(h, width * nsamp, bits)
        v = b.dot(1 << np.arange(bits - 1, -1, -1)).astype(np.uint8 if bits < 8 else np.int64)
        return v.reshape(h, width, nsamp)
    nb = bits // 8
    kind = {1: "u", 2: "i", 3: "f"}[sfmt]
    dt = np.dtype(f"{bo}{kind}{nb}") if nb > 1 else np.dtype(f"{kind}1")
    v = np.frombuffer(np.ascontiguousarray(rows[:, : width * nsamp * nb]).tobytes(), dt)
    return v.reshape(h, width, nsamp).astype(dt.newbyteorder("="))


def _unpremultiply(rgb: np.ndarray, a: np.ndarray) -> np.ndarray:
    a32 = a.astype(np.int32)[..., None]
    v = np.where(a32 == 0, 0, np.minimum(rgb.astype(np.int32) * 255 // np.maximum(a32, 1), 255))
    return np.where(a32 == 255, rgb, v).astype(np.uint8)


def _to_mode(s: np.ndarray, raw: str, mode: str) -> np.ndarray:
    """Samples [h, w, n] -> pixels of Pillow's mode, as raw's unpacker maps them."""
    if raw in ("1", "1;I"):
        on = s[..., 0] != 0
        return np.where(on if raw == "1" else ~on, 255, 0).astype(np.uint8)
    if raw.startswith("L;2") or raw.startswith("L;4"):
        v = s[..., 0].astype(np.int32) * (0x55 if raw.startswith("L;2") else 0x11)
        return (255 - v if raw.endswith("I") else v).astype(np.uint8)
    if raw in ("L", "L;I"):
        return (255 - s[..., 0] if raw == "L;I" else s[..., 0]).astype(np.uint8)
    if mode == "F":
        return s[..., 0].astype(np.float32)
    if mode == "I" and raw == "I;32N":  # unsigned samples stored in Pillow's signed 32-bit mode
        return (s[..., 0] & 0xFFFFFFFF).astype(np.uint32).view(np.int32).astype(np.int64)
    if mode in ("I;16", "I;16B", "I"):
        return s[..., 0]
    if raw.startswith("P"):
        if raw == "PA":
            return s[..., :2].astype(np.uint8)
        return s[..., 0].astype(np.uint8)
    eight = (s >> 8).astype(np.uint8) if raw.endswith(("16L", "16B")) else s.astype(np.uint8)
    if raw == "LA":
        return eight[..., :2]
    if raw.startswith("CMYK"):
        return eight[..., :4]
    if raw.startswith("RGBa"):
        return np.concatenate([_unpremultiply(eight[..., :3], eight[..., 3]), eight[..., 3:4]], axis=-1)
    if mode == "RGBA":
        return eight[..., :4]
    return eight[..., :3]


def read_tiff(data: bytes):
    """TIFF bytes -> (mode, pixels, palette or None) of page 0."""
    if not is_tiff(data):
        raise UnsupportedCodec("not a TIFF file")
    order, bo, tags, full = _read_ifd(data)
    if any(isinstance(tags.get(t, (0,))[0], bytes) for t in PILLOW_NUMERIC):
        raise ValueError("TIFF: an ASCII value where Pillow reads a number")
    ascii_planar = isinstance(_scalar(tags, 284), bytes)
    if ascii_planar:
        tags = {t: v for t, v in tags.items() if t != 284}
    if 0xBC01 in tags:
        raise UnsupportedCodec("Windows Media Photo in TIFF is not supported")
    ctag = _scalar(tags, 259, 1)
    if ctag not in COMPRESSIONS:
        raise UnsupportedCodec(f"TIFF compression {ctag} is unknown to Pillow")
    comp = COMPRESSIONS[ctag]
    if ascii_planar and comp != "raw":
        raise ValueError("TIFF: an ASCII planar configuration, which Pillow's libtiff path refuses")
    planar = _scalar(tags, 284, 1)
    photo = 6 if comp == "tiff_jpeg" else _scalar(tags, 262, 0)
    if isinstance(photo, bytes):
        raise ValueError("TIFF: an ASCII value where Pillow reads a number")
    fill = _scalar(tags, 266, 1)
    w, h = _scalar(tags, 256), _scalar(tags, 257)
    if not isinstance(w, int) or not isinstance(h, int) or w <= 0 or h <= 0:
        raise ValueError("TIFF: missing or bad dimensions")
    check_size("TIFF", w, h)
    sfmt = tags.get(339, (1,))
    if len(sfmt) > 1 and max(sfmt) == min(sfmt) == 1:
        sfmt = (1,)
    bps = tags.get(258, (1,))
    extra = tags.get(338, ())
    nbase = 3 if photo in (2, 6, 8) else 4 if photo == 5 else 1
    spp = _scalar(tags, 277, 3 if comp == "tiff_jpeg" and photo in (2, 6) else 1)
    if spp > 6:
        raise ValueError("TIFF: more samples per pixel than Pillow decodes")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError("TIFF: unknown data organisation")
    key = (order, photo, tuple(sfmt), fill, tuple(bps), tuple(extra))
    if key not in OPEN_INFO:
        raise UnsupportedCodec(f"TIFF: a pixel layout Pillow does not open {key}")
    mode, raw = OPEN_INFO[key]
    if comp not in DECODED:
        raise UnsupportedCodec(f"TIFF compression {comp} is not supported")
    if comp != "raw":  # libtiff decodes compressed data with the tags it reads itself
        tags = full
        if any(tags.get(t, ()) is None for t in STRIP_TAGS):
            raise ValueError("TIFF: libtiff refuses an ASCII strip or tile array")
        planar, fill = _scalar(tags, 284, 1), _scalar(tags, 266, 1)
    if fill == 2:  # the data are bit-reversed below, so the ";R" raw modes read as their plain forms
        if comp != "raw":
            mode, raw = OPEN_INFO[key[:3] + (1,) + key[4:]]
        elif raw.endswith("R"):
            raw = raw[:-1].rstrip(";")
    if comp == "tiff_jpeg":
        rgb = _old_jpeg(data, tags, w, h, planar, bps)
        return mode, np.ascontiguousarray(_orient(rgb, _scalar(tags, 274, 1))), None
    # libtiff hands Pillow YCbCr that JPEG did not code as RGBA (TIFFRGBAImage)
    ycbcr = photo == 6 and comp not in ("raw", "jpeg")
    if photo == 6 and comp == "raw":  # Pillow reads it with its own "RGBX" raw mode: four bytes a pixel
        raise ValueError("TIFF: uncompressed YCbCr, which Pillow reads four bytes a pixel")
    subsampling = tuple(tags.get(530, (2, 2)))[:2] if ycbcr else (1, 1)
    if ycbcr and (planar == 2 or bps != (8, 8, 8) or subsampling[0] not in (1, 2, 4) or subsampling[1] not in (1, 2, 4)):
        raise ValueError("TIFF: a YCbCr layout libtiff does not convert")
    predictor = _scalar(tags, 317, 1)
    if comp == "raw":
        predictor = 1
    if predictor not in (1, 2, 3):
        raise UnsupportedCodec(f"TIFF predictor {predictor} is not supported")
    bits = bps[0]
    sample_fmt = sfmt[0]
    if predictor == 2 and bits not in (8, 16, 32):
        raise ValueError(f"TIFF: horizontal differencing at {bits} bits")
    if predictor == 3 and (sample_fmt != 3 or bits % 8):
        raise ValueError("TIFF: the floating-point predictor needs floating-point samples")
    if comp in CCITT and (bits != 1 or spp != 1):
        raise ValueError("TIFF: CCITT data of more than one bit a pixel")
    if comp == "tiff_thunderscan" and (bits != 4 or spp != 1):
        raise ValueError("TIFF: ThunderScan data that are not 4-bit gray")

    tiled = 324 in tags
    if tiled:
        tw, tl = _scalar(tags, 322), _scalar(tags, 323)
        offsets, counts = tags[324], _byte_counts(tags, 325)
        if not isinstance(tw, int) or not isinstance(tl, int) or tw <= 0 or tl <= 0:
            raise ValueError("TIFF: bad tile size")
    elif 273 in tags:
        tw, tl = w, min(_scalar(tags, 278, h), h)
        offsets, counts = tags[273], _byte_counts(tags, 279)
    else:
        raise ValueError("TIFF: no strips or tiles")
    planes = spp if planar == 2 else 1
    seg_n = spp // planes
    across, down = -(-w // tw), -(-h // tl)
    need = across * down * planes
    if comp == "raw" and not tiled and tl == h and planar != 2:
        offsets = offsets[-1:]
    if len(offsets) < need:
        raise ValueError("TIFF: fewer strips or tiles than the image needs")
    if comp != "raw" and (counts is None or len(counts) < need):
        raise ValueError("TIFF: missing StripByteCounts")
    is_float = sample_fmt == 3
    samples = np.zeros((h, w, spp), np.float32 if is_float else np.int64)
    row_bytes = (tw * seg_n * bits + 7) // 8
    jpeg_tables = _scalar(tags, 347) if comp == "jpeg" else None
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                k = p * across * down + ty * across + tx
                y0, x0 = ty * tl, tx * tw
                sh = min(tl, h - y0)
                sw = min(tw, w - x0)
                seg_rows = tl if tiled and comp != "raw" else sh  # the raw reader reads no more than it places
                if comp == "jpeg":
                    s = _jpeg_segment(data, offsets[k], counts[k], jpeg_tables, photo, fill)[:sh, :sw]
                    if s.shape[:2] != (sh, sw):
                        raise ValueError("TIFF: a JPEG strip smaller than its strip")
                elif ycbcr:
                    hs, vs = subsampling
                    nblocks = -(-tw // hs) * -(-seg_rows // vs)
                    blocks = _segment_bytes(data, comp, offsets[k], counts[k], nblocks * (hs * vs + 2), fill, tags,
                                            tw, seg_rows, partial=True)
                    s = _ycbcr_to_rgb(blocks, tw, seg_rows, hs, vs, tags)[:sh, :sw]
                else:
                    rows = _segment_bytes(data, comp, offsets[k], counts[k] if counts else None,
                                          seg_rows * row_bytes, fill, tags, tw, seg_rows)
                    if predictor == 3:
                        s = _undo_fp_predictor(rows.reshape(seg_rows, row_bytes), bits, seg_n, tw)
                    else:
                        # libtiff differences floats as 32-bit integers
                        s = _samples(rows.reshape(seg_rows, row_bytes), bits, seg_n, tw, bo,
                                     1 if predictor == 2 and is_float else sample_fmt)
                    if predictor == 2:
                        s = _undo_predictor(s, bits, sample_fmt == 2)
                        if is_float:
                            s = s.astype(np.uint32).view(np.float32)
                    s = s[:sh, :sw]
                if planar == 2:
                    samples[y0 : y0 + sh, x0 : x0 + sw, p] = s[..., 0]
                else:
                    samples[y0 : y0 + sh, x0 : x0 + sw] = s
    px = _to_mode(samples, raw, mode)
    if mode == "LAB":  # Pillow's LAB unpacker: a* and b* signed, stored plus 128
        px = px ^ np.array([0, 128, 128], np.uint8)
    palette = None
    if mode in ("P", "PA"):
        cmap = tags.get(320)
        if cmap is None:
            raise ValueError("TIFF: palette image without a colour map")
        hi = np.asarray(cmap, np.int64) // 256
        n = len(hi) // 3
        palette = np.stack([hi[:n], hi[n : 2 * n], hi[2 * n : 3 * n]], axis=-1).astype(np.uint8)
    return mode, np.ascontiguousarray(_orient(px, _scalar(tags, 274, 1))), palette


def _orient(px: np.ndarray, orientation) -> np.ndarray:
    """The Orientation tag applied as Pillow's load_end applies it
    (ImageOps.exif_transpose)."""
    return {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
            5: lambda a: a.swapaxes(0, 1), 6: lambda a: np.rot90(a, -1), 7: lambda a: a[::-1, ::-1].swapaxes(0, 1),
            8: lambda a: np.rot90(a)}.get(orientation, lambda a: a)(px)


def _segment_bytes(data, comp, off, count, expect, fill, tags=None, width=0, rows=0, partial=False):
    """One strip or tile's bytes after decompression (expect bytes; CCITT
    and ThunderScan decode `rows` rows of `width` pixels). A compressed
    strip that runs past the end of the file is refused, as libtiff's
    TIFFFillStrip refuses it. With `partial` (TIFFRGBAImage, which Pillow
    asks not to stop on errors), LZW, PackBits and Deflate data that end
    before the strip is full give what they decoded, the rest zero, as
    libtiff's codecs leave the strip."""
    if comp == "raw":
        raw = np.frombuffer(data, np.uint8, count=min(expect, max(len(data) - off, 0)), offset=min(off, len(data)))
        if len(raw) < expect:
            raise ValueError("TIFF: truncated strip")
        return _REVERSE_BITS[raw] if fill == 2 else raw
    if off + count > len(data):
        raise ValueError("TIFF: a strip past the end of the file")
    src = np.frombuffer(data[off : off + count], np.uint8)
    if fill == 2:
        src = _REVERSE_BITS[src]
    src = np.ascontiguousarray(src)
    if comp in ("tiff_adobe_deflate", "tiff_deflate", "lzma", "zstd"):
        if comp == "zstd":
            from .zstd import decompress

            out = decompress(src.tobytes(), expect)
        elif comp == "lzma":
            import lzma  # the standard library's; a Python built without it raises ImportError here

            try:
                out = lzma.LZMADecompressor().decompress(src.tobytes(), expect)
            except lzma.LZMAError as e:
                raise ValueError(f"TIFF: corrupt LZMA data ({e})") from e
        else:
            try:
                out = zlib.decompressobj().decompress(src.tobytes(), expect)
            except zlib.error as e:
                raise ValueError(f"TIFF: corrupt Deflate data ({e})") from e
        if len(out) < expect:
            if not (partial and comp in ("tiff_adobe_deflate", "tiff_deflate")):
                raise ValueError(f"TIFF: {comp} data end before the strip is full")
            out += bytes(expect - len(out))
        return np.frombuffer(out, np.uint8)
    out = np.zeros(expect, np.uint8)
    if comp in CCITT:
        rc = _lib().vkgr_ccitt(src.ctypes.data, len(src), width, rows, CCITT[comp], int(_scalar(tags, 292, 0)),
                               out.ctypes.data)
    elif comp == "tiff_thunderscan":
        rc = _lib().vkgr_thunderscan(src.ctypes.data, len(src), width, rows, out.ctypes.data)
    else:
        fn = _lib().vkgr_tiff_lzw if comp == "tiff_lzw" else _lib().vkgr_packbits
        rc = fn(src.ctypes.data, len(src), out.ctypes.data, expect)
    # kept: a T.4 or T.6 strip cut after its first row (the rows decoded, >= 1); with partial, LZW or PackBits data
    # that end early (-1)
    kept = rc >= 1 if comp in CCITT else partial and rc == -1 and comp in ("tiff_lzw", "packbits")
    if rc != 0 and not kept:
        raise ValueError(f"TIFF: corrupt or short {comp} data (rc {rc})")
    return out


def _undo_fp_predictor(rows: np.ndarray, bits: int, nsamp: int, width: int) -> np.ndarray:
    """libtiff's floating-point predictor (3) undone: each row's bytes summed
    along the row a pixel apart, then its byte planes (most significant
    first) put back together; -> float32 samples [h, width, nsamp]."""
    h, n = rows.shape
    nb = bits // 8
    acc = rows.reshape(h, -1, nsamp).cumsum(axis=1, dtype=np.uint8).reshape(h, n)  # modulo 256
    wc = n // nb
    planes = acc[:, : wc * nb].reshape(h, nb, wc)
    v = np.zeros((h, wc), np.uint64)
    for b in range(nb):
        v = (v << np.uint64(8)) | planes[:, b].astype(np.uint64)
    f = v.astype(np.uint32).view(np.float32) if nb == 4 else v.astype(np.uint16).view(np.float16).astype(np.float32)
    return f.reshape(h, -1, nsamp)[:, :width]


def _ycbcr_tables(tags):
    """libtiff's TIFFYCbCrToRGBInit tables (tif_color.c) from the
    YCbCrCoefficients and ReferenceBlackWhite tags (or their defaults)."""
    f32 = np.float32
    luma = [f32(v) for v in tags.get(529, (0.299, 0.587, 0.114))]
    ref = [f32(v) for v in tags.get(532, (0.0, 255.0, 128.0, 255.0, 128.0, 255.0))]

    def fix(x):
        return int(float(f32(x) * f32(65536)) + 0.5)

    def clamp(v, lo, hi):
        return min(max(v, lo), hi)

    f1 = f32(2) - f32(2) * luma[0]
    d1 = fix(clamp(f1, f32(0), f32(2)))
    f2 = luma[0] * f1 / luma[1]
    d2 = -fix(clamp(f2, f32(0), f32(2)))
    f3 = f32(2) - f32(2) * luma[2]
    d3 = fix(clamp(f3, f32(0), f32(2)))
    f4 = luma[2] * f3 / luma[1]
    d4 = -fix(clamp(f4, f32(0), f32(2)))

    def code2v(c, rb, rw, cr):
        den = rw - rb if rw - rb != 0 else f32(1)
        return f32(f32(c - int(rb)) * f32(cr)) / f32(den)

    tabs = np.zeros((5, 256), np.int64)
    for i, x in enumerate(range(-128, 128)):
        cr = int(clamp(code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127), -128.0 * 32, 128.0 * 32))
        cb = int(clamp(code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127), -128.0 * 32, 128.0 * 32))
        tabs[0, i] = (d1 * cr + 32768) >> 16  # Cr -> r
        tabs[1, i] = (d3 * cb + 32768) >> 16  # Cb -> b
        tabs[2, i] = d2 * cr  # Cr -> g
        tabs[3, i] = d4 * cb + 32768  # Cb -> g
        tabs[4, i] = int(clamp(code2v(x + 128, ref[0], ref[1], 255), -128.0 * 32, 128.0 * 32))  # Y
    return tabs


def _ycbcr_to_rgb(blocks: np.ndarray, width: int, rows: int, hs: int, vs: int, tags) -> np.ndarray:
    """A segment of YCbCr data units (hs * vs luma samples, then Cb and Cr)
    -> RGB [rows, width, 3]: each unit's chroma over its pixels, converted
    with libtiff's TIFFYCbCrtoRGB."""
    bx, by = -(-width // hs), -(-rows // vs)
    u = blocks.reshape(by, bx, hs * vs + 2).astype(np.int64)
    y = u[..., : hs * vs].reshape(by, bx, vs, hs).transpose(0, 2, 1, 3).reshape(by * vs, bx * hs)
    cb = np.repeat(np.repeat(u[..., -2], vs, axis=0), hs, axis=1)
    cr = np.repeat(np.repeat(u[..., -1], vs, axis=0), hs, axis=1)
    t = _ycbcr_tables(tags)
    yv = t[4][np.minimum(y, 255)]
    r = yv + t[0][cr]
    g = yv + ((t[3][cb] + t[2][cr]) >> 16)
    b = yv + t[1][cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255)[:rows, :width]


def _old_jpeg(data, tags, w, h, planar, bps):
    """An old-style JPEG TIFF (compression 6) -> RGB [h, w, 3], as Pillow
    reads it through libtiff: the JPEG stream at JPEGInterchangeFormat, or
    else the image's one strip, decoded to raw planes; each data unit of
    the luma sampling (hs x vs luma samples and one Cb and Cr) converted as
    TIFFRGBAImage converts YCbCr."""
    from .jpeg import decode_jpeg

    if planar == 2 or tuple(bps) != (8, 8, 8):
        raise ValueError("TIFF: an old-style JPEG layout libtiff does not read")
    if 513 in tags:
        off, count = _scalar(tags, 513), _scalar(tags, 514, len(data))
    elif 273 in tags and len(tags[273]) == 1 and 279 in tags:
        off, count = tags[273][0], tags[279][0]
    else:
        raise UnsupportedCodec("TIFF: old-style JPEG in several strips without JPEGInterchangeFormat")
    planes = decode_jpeg(data[off : off + count] + _FAKE_EOI, color="planes")
    if len(planes) != 3 or any((ph, pv) != (1, 1) for _, ph, pv in planes[1:]):
        raise UnsupportedCodec("TIFF: old-style JPEG whose chroma libtiff upsamples inside libjpeg")
    (y, hs, vs), (cb, _, _), (cr, _, _) = planes
    if hs not in (1, 2, 4) or vs not in (1, 2, 4):
        raise ValueError("TIFF: a YCbCr sampling libtiff does not convert")
    bx, by = -(-w // hs), -(-h // vs)
    if y.shape[0] < by * vs or y.shape[1] < bx * hs or cb.shape[0] < by or cb.shape[1] < bx:
        raise ValueError("TIFF: an old-style JPEG stream smaller than the image")
    units = np.concatenate([y[: by * vs, : bx * hs].reshape(by, vs, bx, hs).transpose(0, 2, 1, 3).reshape(by, bx, -1),
                            cb[:by, :bx, None], cr[:by, :bx, None]], axis=-1)
    return _ycbcr_to_rgb(units.reshape(-1), w, h, hs, vs, tags).astype(np.uint8)


def _undo_predictor(s: np.ndarray, bits: int, signed: bool) -> np.ndarray:
    """Horizontal differencing undone along each row, per sample, modulo 2^bits."""
    v = (np.cumsum(s.astype(np.uint64), axis=1) & np.uint64((1 << bits) - 1)).astype(np.int64)
    return np.where(v >= 1 << (bits - 1), v - (1 << bits), v) if signed else v


# libtiff's JPEG source managers end a strip's data with an EOI marker (std_fill_input_buffer's fake EOI,
# OJPEGWriteStreamEoi): a strip cut short decodes as libjpeg decodes a scan that runs into a marker
_FAKE_EOI = b"\xff\xd9"


def _jpeg_segment(data, off, count, tables, photo, fill):
    from .jpeg import decode_jpeg

    if off + count > len(data):
        raise ValueError("TIFF: a strip past the end of the file")
    seg = data[off : off + count]
    if fill == 2:
        seg = _REVERSE_BITS[np.frombuffer(seg, np.uint8)].tobytes()
    if tables and len(tables) > 4 and seg[:2] == b"\xff\xd8":
        seg = tables[:-2] + seg[2:]  # the tables' SOI .. DQT/DHT, then the strip after its SOI
    color = "ycc" if photo == 6 else "raw"
    px = decode_jpeg(seg + _FAKE_EOI, color=color)
    return px.astype(np.int64)


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes -> uint8 [H, W, 4] of page 0, as Pillow's convert("RGBA")."""
    mode, px, palette = read_tiff(data)
    return to_rgba(mode, px, palette)


def encode_tiff(u8: np.ndarray) -> bytes:
    """uint8 [H, W], [H, W, 3] or [H, W, 4] -> Pillow's default TIFF."""
    a = np.asarray(u8, np.uint8)
    h, w = a.shape[:2]
    nsamp = 1 if a.ndim == 2 else a.shape[2]
    photo = 1 if nsamp == 1 else 2
    ntags = 9 if nsamp == 1 else 10 if nsamp == 3 else 11
    ext = 8 + 2 + 12 * ntags + 4  # the out-of-line values start after the IFD
    bits_off = ext
    data_off = ext + (2 * nsamp if nsamp > 1 else 0)
    nbytes = w * h * nsamp
    e = []

    def tag(t, typ, count, val):
        e.append(struct.pack("<HHI", t, typ, count) + val)

    tag(256, 4, 1, struct.pack("<I", w))
    tag(257, 4, 1, struct.pack("<I", h))
    tag(258, 3, nsamp, struct.pack("<HH", 8, 0) if nsamp == 1 else struct.pack("<I", bits_off))
    tag(259, 3, 1, struct.pack("<HH", 1, 0))
    tag(262, 3, 1, struct.pack("<HH", photo, 0))
    tag(273, 4, 1, struct.pack("<I", data_off))
    if nsamp > 1:
        tag(277, 3, 1, struct.pack("<HH", nsamp, 0))
    tag(278, 4, 1, struct.pack("<I", h))
    tag(279, 4, 1, struct.pack("<I", nbytes))
    tag(284, 3, 1, struct.pack("<HH", 1, 0))
    if nsamp == 4:
        tag(338, 3, 1, struct.pack("<HH", 2, 0))
    out = b"II\x2a\x00" + struct.pack("<IH", 8, ntags) + b"".join(e) + struct.pack("<I", 0)
    if nsamp > 1:
        out += struct.pack(f"<{nsamp}H", *([8] * nsamp))
    return out + np.ascontiguousarray(a).tobytes()
