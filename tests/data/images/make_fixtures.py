"""Regenerate the image fixtures of this directory and digests.json.

The files are BMP/DIB, TGA, GIF, TIFF, Netpbm, JPEG, PSD, SGI, PCX/DCX,
ICO/CUR, QOI, Sun raster, PNG, BLP, FTEX, XBM, XPM, MSP and IM forms that
the JAX package reads through Pillow (12.1.0 when they were made) and the
port reads without it: files
Pillow writes, and files assembled here from seeded numpy images for the
forms Pillow cannot be asked to write (OS/2 and V4/V5 BMP headers, bit
masks, RLE; TGA colour maps and packets across scan lines; GIF frames off
the logical screen, local tables, a full LZW table; TIFF tiles, planes,
big-endian, BigTIFF, predictors, old-style LZW, JPEG strips with shared
tables, subsampled YCbCr, ThunderScan, 12-bit gray; arithmetic-coded,
lossless (subsampled too) and CMYK/YCCK JPEG through
tests/torch_test_helpers.py's encoders; PSD, SGI RLE, PCX bit planes, DCX,
icons and cursors with DIB images, QOI ops, Sun raster; PNG at every
depth, Adam7 and 16-bit RGB; ZSTD, old-style JPEG and CIELab TIFF, Lab
PSD; BLP, FTEX, XBM, XPM, MSP and IM; IM's YCC, planar and bit-decoded
types, BLP1 CMYK JPEG, IPTC, PIXAR, SPIDER, FITS, McIDAS, GBR, PhotoCD,
FLI/FLC, XV thumbnails, IM Tools and ICNS; JPEG 2000 codestreams and JP2
files, from Pillow's encoder, with JP2 boxes written here, and from
OpenJPEG's own encoder through openjpeg_encode.py for what Pillow's save
cannot ask for; AVIF stills from Pillow's writer, lossless and lossy, with aom's options). Some are files
Pillow refuses, EPS among them (Pillow needs Ghostscript to load it). digests.json holds, for each file, the shape and
sha256 of Pillow's decode (Image.open(f).convert("RGBA") as uint8 bytes),
or that Pillow refuses it (and, under "divergences", the files Pillow
decodes where the port cannot match it; "large" the JPEG 2000 and AVIF
maps that only chip_smoke.py decodes; "gaps" the AVIF forms Pillow decodes
and the port refuses until ROADMAP A ports them), so that the port can be held to Pillow where
Pillow is absent (chip_smoke.py's phase 22); tests/test_torch_images.py
holds it to Pillow itself.

It also writes zstd_strip.zst, one Zstandard frame of
scenes.zstd_strip_pattern, from which chip_smoke.py tiles its ZSTD TIFFs.

Run from the repository root: python tests/data/images/make_fixtures.py
"""

import hashlib
import io
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent))  # tests/, for torch_test_helpers
sys.path.insert(0, str(HERE.parent.parent.parent))  # the repository root

from torch_test_helpers import cmyk_to_ycck, jpeg_from_planes, jpeg_lossless  # noqa: E402


def smooth(w, h, seed, chans=3):
    """A smooth seeded uint8 image [h, w, chans] with a little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32) / max(w, h, 2)
    out = []
    for _ in range(chans):
        fx, fy, ph = rng.uniform(1, 5), rng.uniform(1, 5), rng.uniform(0, 6.3)
        out.append(127.5 + 110 * np.sin(2 * np.pi * (fx * x + fy * y * y) + ph) + rng.normal(0, 6, (h, w)))
    return np.clip(np.stack(out, -1), 0, 255).astype(np.uint8)


def indices(w, h, n, seed):
    """A seeded index image of n values in diagonal bands with noise."""
    rng = np.random.default_rng(seed)
    idx = (np.add.outer(np.arange(h), np.arange(w)) // 3 + rng.integers(0, 2, (h, w))) % n
    return idx.astype(np.uint8)


def pillow(img, fmt, **kw) -> bytes:
    b = io.BytesIO()
    img.save(b, fmt, **kw)
    return b.getvalue()


# ------------------------------------------------------------------ Netpbm


def netpbm() -> dict:
    rgb, g = smooth(17, 13, 1), smooth(17, 13, 2, 1)[..., 0]
    bits = indices(17, 13, 2, 3)
    out = {
        "ppm_p6.ppm": pillow(Image.fromarray(rgb), "PPM"),
        "ppm_p5.pgm": pillow(Image.fromarray(g), "PPM"),
        "ppm_p4.pbm": pillow(Image.fromarray(bits * 255).convert("1"), "PPM"),
        "ppm_p5_16bit.pgm": pillow(Image.fromarray(g.astype(np.uint16) * 3 + 50), "PPM"),
        "ppm_pf.pfm": pillow(Image.fromarray(g.astype(np.float32) * 1.7 - 40), "PPM"),
    }

    def plain(magic, vals, maxval=None, per_line=9):
        toks = [str(v) for v in vals.reshape(-1)]
        lines = [" ".join(toks[i:i + per_line]) for i in range(0, len(toks), per_line)]
        head = f"{magic}\n# a comment\n{17} {13}\n" + (f"{maxval}\n" if maxval else "")
        return (head + "\n".join(lines) + "\n").encode()

    out["ppm_p1_plain.pbm"] = b"P1\n#c\n17 13\n" + b"\n".join(
        b"".join(b"01"[v:v + 1] for v in row) for row in bits) + b"\n"
    out["ppm_p2_plain_15.pgm"] = plain("P2", (g // 17).astype(int), 15)
    out["ppm_p2_plain_1000.pgm"] = plain("P2", (g.astype(int) * 4), 1000)
    out["ppm_p3_plain.ppm"] = plain("P3", rgb.astype(int), 255)
    out["ppm_p5_maxval_100.pgm"] = b"P5 17 13 100\n" + (g.astype(int) * 100 // 255).astype(np.uint8).tobytes()
    out["ppm_p5_maxval_4095.pgm"] = b"P5\n17 13\n4095\n" + (g.astype(">u2") * 16).tobytes()
    out["ppm_p6_maxval_1023.ppm"] = b"P6\n17 13\n1023\n" + (rgb.astype(">u2") * 4).tobytes()
    out["ppm_p6_comment_token.ppm"] = b"P6\n1#split\n7 13 255\n" + rgb.tobytes()
    out["ppm_pf_big_endian.pfm"] = b"Pf\n17 13\n1.0\n" + (g.astype(">f4") / 255 * 300 - 20).tobytes()
    out["ppm_pyp.ppm"] = b"PyP\n17 13\n255\n" + indices(17, 13, 7, 4).tobytes()
    out["ppm_pyrgba.ppm"] = b"PyRGBA\n17 13\n255\n" + smooth(17, 13, 5, 4).tobytes()
    out["ppm_p0cmyk.ppm"] = b"P0CMYK\n17 13\n255\n" + smooth(17, 13, 6, 4).tobytes()
    # refused: P7 (PAM) is not a Pillow magic, a value above maxval, a truncated raster
    out["ppm_refused_pam.pam"] = b"P7\nWIDTH 4\nHEIGHT 4\nDEPTH 3\nMAXVAL 255\nENDHDR\n" + bytes(48)
    out["ppm_refused_above_maxval.pgm"] = b"P2\n2 2\n10\n1 2 3 11\n"
    out["ppm_refused_truncated.ppm"] = out["ppm_p6.ppm"][:-40]
    return out


# ------------------------------------------------------------------ BMP


def bmp_file(w, h, bits, rows, header=40, comp=0, palette=b"", masks=None, top_down=False, colors=0,
             dib=False, image_size=None):
    """A BMP of rows (bytes, already padded and ordered as stored)."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        hh = (2**32 - h) if top_down else h
        info = struct.pack("<IIIHHIIiiII", header, w, hh, 1, bits, comp,
                           len(rows) if image_size is None else image_size, 2835, 2835, colors, 0)
        if header >= 52 and masks is not None:
            info += struct.pack("<4I", *(list(masks) + [0] * (4 - len(masks))))
        info = info.ljust(header, b"\0")
    extra = struct.pack("<3I", *masks[:3]) if header == 40 and masks is not None else b""
    body = info + extra + palette
    if dib:
        return body + rows
    off = 14 + len(body)
    return b"BM" + struct.pack("<IHHI", off + len(rows), 0, 0, off) + body + rows


def pack_rows(px, bits, bottom_up=True):
    h = px.shape[0]
    rows = []
    for r in (range(h - 1, -1, -1) if bottom_up else range(h)):
        row = px[r]
        if bits < 8:
            v = np.zeros((len(row) * bits + 7) // 8 * 8 // bits, np.uint8)
            v[: len(row)] = row
            b = np.packbits(np.unpackbits(v[:, None], axis=1)[:, 8 - bits:].reshape(-1)).tobytes()
        else:
            b = np.ascontiguousarray(row).tobytes()
        rows.append(b + b"\0" * (-len(b) % 4))
    return b"".join(rows)


def rle8(px):
    """RLE8 records of px (rows bottom-up): runs, absolute runs, EOL, EOB."""
    out = bytearray()
    for row in px[::-1]:
        x = 0
        while x < len(row):
            n = 1
            while x + n < len(row) and row[x + n] == row[x] and n < 255:
                n += 1
            if n >= 3 or len(row) - x < 3:
                out += bytes([n, row[x]])
                x += n
            else:
                m = 3
                while x + m < len(row) and m < 255 and not (x + m + 2 < len(row) and row[x + m] == row[x + m + 1]
                                                          == row[x + m + 2]):
                    m += 1
                out += bytes([0, m]) + bytes(row[x:x + m]) + (b"\0" if m % 2 else b"")
                x += m
        out += b"\0\0"
    return bytes(out + b"\0\1")


def bmp() -> dict:
    rgb, g = smooth(19, 11, 11), smooth(19, 11, 12, 1)[..., 0]
    rgba = smooth(19, 11, 13, 4)
    idx16, idx5 = indices(19, 11, 16, 14), indices(19, 11, 5, 15)
    rng = np.random.default_rng(16)
    pal16 = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    pal_bgrx = lambda p: np.concatenate([p[:, ::-1], np.zeros((len(p), 1), np.uint8)], 1).tobytes()  # noqa: E731
    out = {
        "bmp_rgb24.bmp": pillow(Image.fromarray(rgb), "BMP"),
        "bmp_rgba32.bmp": pillow(Image.fromarray(rgba), "BMP"),
        "bmp_gray8.bmp": pillow(Image.fromarray(g), "BMP"),
        "bmp_bilevel.bmp": pillow(Image.fromarray(g).convert("1"), "BMP"),
        "bmp_palette8.bmp": pillow(Image.fromarray(rgb).quantize(40), "BMP"),
        "bmp_rgb24.dib": pillow(Image.fromarray(rgb), "DIB"),
    }
    out["bmp_palette4.bmp"] = bmp_file(19, 11, 4, pack_rows(idx16, 4), palette=pal_bgrx(pal16), colors=16)
    out["bmp_palette4_short.bmp"] = bmp_file(19, 11, 4, pack_rows(idx5 + 3, 4), palette=pal_bgrx(pal16[:6]),
                                             colors=6)
    two = np.array([[200, 30, 60], [10, 240, 120]], np.uint8)
    out["bmp_palette1_colour.bmp"] = bmp_file(19, 11, 1, pack_rows(indices(19, 11, 2, 17), 1),
                                              palette=pal_bgrx(two), colors=2)
    out["bmp_os2_rgb24.bmp"] = bmp_file(19, 11, 24, pack_rows(rgb[..., ::-1], 24), header=12)
    out["bmp_os2_palette8.bmp"] = bmp_file(19, 11, 8, pack_rows(idx16, 8), header=12,
                                           palette=pal16[:, ::-1].tobytes() + bytes(3 * 240))
    out["bmp_top_down.bmp"] = bmp_file(19, 11, 24, pack_rows(rgb[..., ::-1], 24, bottom_up=False), top_down=True)
    v555 = ((rgb[..., 0].astype(np.uint16) >> 3) << 10) | ((rgb[..., 1].astype(np.uint16) >> 3) << 5) \
        | (rgb[..., 2].astype(np.uint16) >> 3)
    v565 = ((rgb[..., 0].astype(np.uint16) >> 3) << 11) | ((rgb[..., 1].astype(np.uint16) >> 2) << 5) \
        | (rgb[..., 2].astype(np.uint16) >> 3)
    out["bmp_rgb16_555.bmp"] = bmp_file(19, 11, 16, pack_rows(v555.astype("<u2").view(np.uint8), 8))
    out["bmp_bitfields16_565_v4.bmp"] = bmp_file(19, 11, 16, pack_rows(v565.astype("<u2").view(np.uint8), 8),
                                                 header=108, comp=3, masks=(0xF800, 0x7E0, 0x1F))
    out["bmp_bitfields16_555_v3.bmp"] = bmp_file(19, 11, 16, pack_rows(v555.astype("<u2").view(np.uint8), 8),
                                                 header=40, comp=3, masks=(0x7C00, 0x3E0, 0x1F))
    for name, masks, order in (("rgba_v5", (0xFF, 0xFF00, 0xFF0000, 0xFF000000), [0, 1, 2, 3]),
                               ("bgra_v3_56", (0xFF0000, 0xFF00, 0xFF, 0xFF000000), [2, 1, 0, 3]),
                               ("abgr_v4", (0xFF000000, 0xFF0000, 0xFF00, 0xFF), [3, 2, 1, 0]),
                               ("xbgr_v3_52", (0xFF000000, 0xFF0000, 0xFF00), [3, 2, 1, 0]),
                               ("zero_masks_v5", (0, 0, 0, 0), [2, 1, 0, 3])):
        header = {"v5": 124, "v4": 108, "56": 56, "52": 52}[name.split("_")[-1]]
        out[f"bmp_bitfields32_{name}.bmp"] = bmp_file(19, 11, 32, pack_rows(rgba[..., order], 8), header=header,
                                                      comp=3, masks=masks)
    out["bmp_rle8.bmp"] = bmp_file(19, 11, 8, rle8(indices(19, 11, 6, 18) * 7), comp=1,
                                   palette=pal_bgrx(rng.integers(0, 256, (256, 3), dtype=np.uint8)), colors=256)
    # RLE4: runs of alternating pixels, an odd absolute run (Pillow drops its last pixel), a delta, EOL, EOB
    rle4 = bytearray()
    for r in range(11):
        if r == 4:
            rle4 += bytes([0, 2, 9, 9, 3, 1])  # delta: Pillow skips two bytes and reads (right 3, up 1)
            rle4 += bytes([0, 0])
            continue
        rle4 += bytes([7, 0x3A, 0, 5, 0x12, 0x34, 0x50, 0, 5, 0xC4, 2, 0x77]) + bytes([0, 0])
    rle4 += bytes([0, 1])
    out["bmp_rle4.bmp"] = bmp_file(19, 11, 4, bytes(rle4), comp=2, palette=pal_bgrx(pal16), colors=16)
    # refused: a 16-bit mask layout outside Pillow's table, JPEG inside a BMP, 2 bits a pixel
    out["bmp_refused_bitfields_444.bmp"] = bmp_file(19, 11, 16, pack_rows(v555.astype("<u2").view(np.uint8), 8),
                                                    comp=3, masks=(0xF00, 0xF0, 0xF))
    out["bmp_refused_jpeg.bmp"] = bmp_file(19, 11, 24, pillow(Image.fromarray(rgb), "JPEG"), comp=4)
    out["bmp_refused_2bit.bmp"] = bmp_file(19, 11, 2, pack_rows(idx5 % 4, 2), palette=pal_bgrx(pal16[:4]),
                                           colors=4)
    return out


# ------------------------------------------------------------------ TGA


def tga_file(itype, depth, w, h, body, cmap=None, flags=0, ident=b""):
    """A TGA: cmap = (first entry, entry bits, entries bytes, count)."""
    if cmap:
        first, cbits, entries, count = cmap
        head = struct.pack("<BBBHHB", len(ident), 1, itype, first, count, cbits)
    else:
        head, entries = struct.pack("<BBBHHB", len(ident), 0, itype, 0, 0, 0), b""
    head += struct.pack("<HHHHBB", 0, 0, w, h, depth, flags)
    return head + ident + entries + body


def tga_rle(pixels, nb, cross=True):
    """RLE packets over the whole pixel stream ([n, nb] bytes): runs of 2+
    equal pixels and literal packets, up to 128 pixels, across scan lines."""
    out = bytearray()
    i, n = 0, len(pixels)
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and (pixels[j] == pixels[i]).all():
            j += 1
        if j - i >= 2:
            out += bytes([0x80 | (j - i - 1)]) + pixels[i].tobytes()
            i = j
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n and (pixels[j] == pixels[j + 1]).all()):
            j += 1
        out += bytes([j - i - 1]) + pixels[i:j].tobytes()
        i = j
    return bytes(out)


def tga() -> dict:
    rgb, g = smooth(21, 9, 21), smooth(21, 9, 22, 1)[..., 0]
    rgba = smooth(21, 9, 23, 4)
    out = {
        "tga_rgb24.tga": pillow(Image.fromarray(rgb), "TGA"),
        "tga_rgba32.tga": pillow(Image.fromarray(rgba), "TGA"),
        "tga_gray8.tga": pillow(Image.fromarray(g), "TGA"),
        "tga_gray_alpha16.tga": pillow(Image.fromarray(np.stack([g, g[::-1]], -1), "LA"), "TGA"),
        "tga_palette8.tga": pillow(Image.fromarray(rgb).quantize(30), "TGA"),
        "tga_rgb24_rle.tga": pillow(Image.fromarray(rgb), "TGA", compression="tga_rle"),
        "tga_rgba32_rle_top.tga": pillow(Image.fromarray(rgba), "TGA", compression="tga_rle", orientation=1),
        "tga_gray8_rle.tga": pillow(Image.fromarray(g // 40 * 40), "TGA", compression="tga_rle"),
        "tga_palette8_rle.tga": pillow(Image.fromarray(rgb).quantize(6), "TGA", compression="tga_rle"),
    }
    v = ((rgba[..., 3] > 127).astype(np.uint16) << 15) | ((rgb[..., 0].astype(np.uint16) >> 3) << 10) \
        | ((rgb[..., 1].astype(np.uint16) >> 3) << 5) | (rgb[..., 2].astype(np.uint16) >> 3)
    out["tga_rgb16.tga"] = tga_file(2, 16, 21, 9, v[::-1].astype("<u2").tobytes())
    idx = indices(21, 9, 12, 24)
    rng = np.random.default_rng(25)
    c16 = (rng.integers(0, 2**16, 12)).astype("<u2").tobytes()
    out["tga_cmap16_first4.tga"] = tga_file(1, 8, 21, 9, (idx[::-1] + 4).tobytes(), cmap=(4, 16, c16, 12))
    c32 = rng.integers(0, 256, (12, 4), dtype=np.uint8).tobytes()
    out["tga_cmap24_ident.tga"] = tga_file(1, 8, 21, 9, idx[::-1].tobytes(), cmap=(0, 24, c32[:36], 12),
                                           ident=b"fixture")
    out["tga_flip_h.tga"] = tga_file(2, 24, 21, 9, rgb[::-1, :, ::-1].tobytes(), flags=0x10)
    out["tga_flip_both.tga"] = tga_file(2, 24, 21, 9, rgb[:, :, ::-1].tobytes(), flags=0x30)
    q = (rgb // 64 * 64)[..., ::-1][::-1].reshape(-1, 3)
    out["tga_rle_across_lines.tga"] = tga_file(10, 24, 21, 9, tga_rle(q, 3))
    noisy = np.random.default_rng(26).integers(0, 256, (9, 21), dtype=np.uint8)
    out["tga_gray_rle_literals_across_lines.tga"] = tga_file(11, 8, 21, 9, tga_rle(noisy[::-1].reshape(-1, 1), 1))
    # refused: true colour at 8 bits (no raw mode), a colour-mapped type without a map, a 15-bit and a 32-bit
    # map, a run packet across a scan line (an overrun in Pillow)
    out["tga_refused_cmap32.tga"] = tga_file(1, 8, 21, 9, idx[::-1].tobytes(), cmap=(0, 32, c32, 12))
    out["tga_refused_run_across_lines.tga"] = tga_file(11, 8, 21, 9, bytes([0x80 | 29, 77]) + bytes(
        [0x80 | 127, 10]) + bytes([0x80 | 31, 200]))
    out["tga_refused_rgb8.tga"] = tga_file(2, 8, 21, 9, g.tobytes())
    out["tga_refused_no_map.tga"] = tga_file(1, 8, 21, 9, idx.tobytes())
    out["tga_refused_map15.tga"] = tga_file(1, 8, 21, 9, idx.tobytes(), cmap=(0, 15, c16, 12))
    return out


# ------------------------------------------------------------------ GIF


def gif_lzw(idx, bits, clear_when_full=True):
    """GIF LZW of a flat index sequence with minimum code size bits (1..8),
    as sub-blocks; without clear_when_full the table stays full (deferred
    clear) to the end."""
    clear, end = 1 << bits, (1 << bits) + 1
    size, nxt = bits + 1, clear + 2
    table = {}
    acc = nacc = 0
    out = bytearray()

    def emit(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    emit(clear)
    prefix = int(idx[0])
    for k in idx[1:]:
        k = int(k)
        if (prefix, k) in table:
            prefix = table[(prefix, k)]
            continue
        emit(prefix)
        if nxt < 4096:
            table[(prefix, k)] = nxt
            if nxt == (1 << size) and size < 12:
                size += 1
            nxt += 1
        elif clear_when_full:
            emit(clear)
            table, size, nxt = {}, bits + 1, clear + 2
        prefix = k
    emit(prefix)
    if nxt < 4096 and nxt == (1 << size) and size < 12:
        size += 1
    emit(end)
    if nacc:
        out.append(acc & 255)
    blocks = b"".join(bytes([len(out[i:i + 255])]) + out[i:i + 255] for i in range(0, len(out), 255))
    return bytes([bits]) + blocks + b"\0"


def gif_file(sw, sh, frame, gpal=None, bg=0, ext=b""):
    """A GIF89a: frame = (x, y, w, h, idx, bits, local palette or None, interlace)."""
    x, y, w, h, idx, bits, lpal, inter = frame
    flags = 0
    out = b"GIF89a"
    if gpal is not None:
        n = len(gpal).bit_length() - 1
        out += struct.pack("<HHBBB", sw, sh, 0x80 | (n - 1), bg, 0) + np.asarray(gpal, np.uint8).tobytes()
    else:
        out += struct.pack("<HHBBB", sw, sh, 0, bg, 0)
    out += ext
    if lpal is not None:
        flags = 0x80 | (len(lpal).bit_length() - 2)
        lp = np.asarray(lpal, np.uint8).tobytes()
    else:
        lp = b""
    if inter:
        flags |= 0x40
        order = list(range(0, h, 8)) + list(range(4, h, 8)) + list(range(2, h, 4)) + list(range(1, h, 2))
        idx = idx[order]
    out += b"," + struct.pack("<HHHHB", x, y, w, h, flags) + lp + gif_lzw(idx.reshape(-1), bits)
    return out + b";"


def gce(trns):
    return b"!\xf9\x04" + bytes([1, 0, 0, trns]) + b"\0"


def gif() -> dict:
    rgb = smooth(23, 15, 31)
    q = Image.fromarray(rgb).quantize(64)
    rng = np.random.default_rng(32)
    pal = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    idx = indices(13, 9, 16, 33)
    out = {
        "gif_rgb_200_colours.gif": pillow(Image.fromarray(rgb).quantize(200).convert("RGB"), "GIF"),
        "gif_gray.gif": pillow(Image.fromarray(smooth(23, 15, 34, 1)[..., 0]), "GIF"),
        "gif_palette_transparent.gif": pillow(q, "GIF", transparency=5),
        "gif_interlaced.gif": pillow(q, "GIF", interlace=1),
        "gif_bilevel.gif": pillow(Image.fromarray(smooth(23, 15, 35, 1)[..., 0]).convert("1"), "GIF"),
    }
    out["gif_frame_offset_transparent.gif"] = gif_file(30, 20, (7, 5, 13, 9, idx, 4, None, False), gpal=pal,
                                                       ext=gce(3))
    out["gif_frame_offset_opaque.gif"] = gif_file(30, 20, (7, 5, 13, 9, idx, 4, None, False), gpal=pal, bg=9)
    out["gif_frame_past_screen.gif"] = gif_file(10, 6, (4, 3, 13, 9, idx, 4, None, True), gpal=pal)
    out["gif_local_palette.gif"] = gif_file(13, 9, (0, 0, 13, 9, idx, 4, pal[::-1], False), gpal=pal)
    gray_ramp = np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, 1)
    out["gif_local_gray_ramp.gif"] = gif_file(13, 9, (0, 0, 13, 9, idx, 4, gray_ramp, False))
    out["gif_local_gray_ramp_over_global.gif"] = gif_file(13, 9, (0, 0, 13, 9, idx, 4, gray_ramp, False), gpal=pal)
    out["gif_gray_transparent.gif"] = gif_file(20, 12, (3, 2, 13, 9, idx, 4, None, False), ext=gce(2))
    out["gif_no_palette.gif"] = gif_file(13, 9, (0, 0, 13, 9, idx, 4, None, False))
    out["gif_short_palette.gif"] = gif_file(13, 9, (0, 0, 13, 9, idx, 4, None, False), gpal=pal[:8])
    two = indices(13, 9, 2, 36)
    out["gif_refused_code_size_1.gif"] = gif_file(13, 9, (0, 0, 13, 9, two, 1, None, False), gpal=pal[:2])
    out["gif_interlaced_3_rows.gif"] = gif_file(13, 3, (0, 0, 13, 3, idx[:3], 4, None, True), gpal=pal)
    noise = rng.integers(0, 256, (160, 160), dtype=np.uint8)
    big_pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    full = gif_file(160, 160, (0, 0, 160, 160, noise, 8, None, False), gpal=big_pal)
    out["gif_table_full_clear.gif"] = full
    deferred = b"GIF89a" + struct.pack("<HHBBB", 160, 160, 0x87, 0, 0) + big_pal.tobytes() + b"," + \
        struct.pack("<HHHHB", 0, 0, 160, 160, 0) + gif_lzw(noise.reshape(-1), 8, clear_when_full=False) + b";"
    out["gif_table_full_deferred.gif"] = deferred
    ext = b"!\xfe\x05hello\x03abc\x00" + b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00" + b"\x00\x00junk"
    out["gif_extensions_junk.gif"] = gif_file(13, 9, (0, 0, 13, 9, idx, 4, None, False), gpal=pal, ext=ext)
    # refused: a code past the table, LZW sub-blocks that run off the end of the file, a gray-ramp local
    # table with transparency over a global table; above, a 1-bit code size (Pillow's decoder never widens its
    # 2-bit codes then)
    out["gif_refused_gray_ramp_transparent.gif"] = gif_file(13, 9, (0, 0, 13, 9, idx, 4, gray_ramp, False),
                                                            gpal=pal, ext=gce(2))
    bad = bytearray(gif_file(13, 9, (0, 0, 13, 9, idx, 4, None, False), gpal=pal))
    start = bad.index(b",") + 10
    bad[start + 2] = 0xFF
    bad[start + 3] = 0xFF
    out["gif_refused_broken_lzw.gif"] = bytes(bad)
    good = gif_file(13, 9, (0, 0, 13, 9, idx, 4, None, False), gpal=pal)
    out["gif_refused_truncated.gif"] = good[: start + 12]
    return out


# ------------------------------------------------------------------ TIFF


def tiff_lzw(data: bytes, old_style=False):
    """TIFF LZW: MSB-first codes with early change, clear at 4094; or
    libtiff's old-style form (LSB-first, no early change)."""
    acc = nacc = 0
    out = bytearray()
    size = 9

    def emit(code):
        nonlocal acc, nacc
        if old_style:
            acc |= code << nacc
            nacc += size
            while nacc >= 8:
                out.append(acc & 255)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << size) | code
            nacc += size
            while nacc >= 8:
                out.append((acc >> (nacc - 8)) & 255)
                nacc -= 8

    # libtiff's encoder widens once its next free code passes 2^n - 1 (the decoder, a code behind, at
    # 2^n - 2: the "early change"); the old-style form one code later
    late = 1 if old_style else 0
    table, nxt = {}, 258
    emit(256)
    if data:
        prefix = data[0]
        for k in data[1:]:
            if (prefix, k) in table:
                prefix = table[(prefix, k)]
                continue
            emit(prefix)
            table[(prefix, k)] = nxt
            nxt += 1
            if nxt - late >= (1 << size) and size < 12:
                size += 1
            if nxt >= 4094:
                emit(256)
                table, nxt, size = {}, 258, 9
            prefix = k
        emit(prefix)
        nxt += 1
        if nxt - late >= (1 << size) and size < 12:
            size += 1
    emit(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255 if not old_style else acc & 255)
    return bytes(out)


def packbits(data: bytes):
    out = bytearray()
    i = 0
    while i < len(data):
        j = i + 1
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 2:
            out += bytes([(257 - (j - i)) & 255, data[i]])
            i = j
            continue
        j = i + 1
        while j < len(data) and j - i < 128 and not (j + 1 < len(data) and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def tiff_file(w, h, bps, photometric, segments, layout, compression=1, tags=None, bo="<", big=False):
    """A TIFF whose segments (strip or tile bytes, already compressed) are
    laid out as ("strips", rows per strip) or ("tiles", tw, tl)."""
    spp = len(bps)
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, list(bps)), 259: (3, [compression]), 262: (3, [photometric]),
         277: (3, [spp])}
    if layout[0] == "strips":
        t[278] = (4, [layout[1]])
        off_tag, cnt_tag = 273, 279
    else:
        t[322], t[323] = (4, [layout[1]]), (4, [layout[2]])
        off_tag, cnt_tag = 324, 325
    for k, v in (tags or {}).items():
        t[k] = v
    t[off_tag] = (4, [0] * len(segments))
    t[cnt_tag] = (4, [len(s) for s in segments])
    fmt = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 7: "B", 11: "f", 16: "Q"}
    head = (b"II" if bo == "<" else b"MM") + (struct.pack(bo + "HHHQ", 43, 8, 0, 16) if big
                                               else struct.pack(bo + "HI", 42, 8))
    n = len(t)
    ifd_len = (8 + 20 * n + 8) if big else (2 + 12 * n + 4)
    inline = 8 if big else 4
    pos = len(head) + ifd_len
    extra = bytearray()
    seg_base = None
    entries = []
    for k in sorted(t):
        typ, vals = t[k]
        if typ in (2, 7):
            raw = bytes(vals)
            count = len(raw)
        else:
            raw = struct.pack(bo + fmt[typ] * len(vals), *vals)
            count = len(vals) // (2 if typ == 5 else 1)
        entries.append([k, typ, count, raw])
    total_extra = sum(len(e[3]) + (len(e[3]) & 1) for e in entries if len(e[3]) > inline)
    seg_base = pos + total_extra
    seg_offsets, p = [], seg_base
    for s in segments:
        seg_offsets.append(p)
        p += len(s) + (len(s) & 1)
    out_entries = b""
    for e in entries:
        k, typ, count, raw = e
        if k == off_tag:
            raw = struct.pack(bo + "I" * len(seg_offsets), *seg_offsets)
        if len(raw) > inline:
            val = struct.pack(bo + ("Q" if big else "I"), pos + len(extra))
            extra += raw + (b"\0" if len(raw) & 1 else b"")
        else:
            val = raw.ljust(inline, b"\0")
        out_entries += struct.pack(bo + ("HHQ" if big else "HHI"), k, typ, count) + val
    ifd = struct.pack(bo + ("Q" if big else "H"), n) + out_entries + (b"\0" * (8 if big else 4))
    body = b"".join(s + (b"\0" if len(s) & 1 else b"") for s in segments)
    return head + ifd + bytes(extra) + body


def split(px, rows):
    return [px[y:y + rows] for y in range(0, px.shape[0], rows)]


def tiles(px, tw, tl):
    h, w = px.shape[:2]
    out = []
    for y in range(0, h, tl):
        for x in range(0, w, tw):
            t = np.zeros((tl, tw) + px.shape[2:], px.dtype)
            blk = px[y:y + tl, x:x + tw]
            t[: blk.shape[0], : blk.shape[1]] = blk
            out.append(t)
    return out


def hdiff(px):
    """Predictor 2: horizontal differences per sample, in the sample's width."""
    d = px.astype(np.int64)
    d[:, 1:] = d[:, 1:] - d[:, :-1]
    return (d % (1 << (8 * px.dtype.itemsize))).astype(px.dtype)


def jpeg_tables_split(data: bytes):
    """A full JPEG -> (tables-only stream SOI DQT DHT EOI, abbreviated image stream)."""
    pos, tables, rest = 2, [], []
    while True:
        m, n = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos:pos + 2 + n]
        if m == 0xDA:
            rest.append(data[pos:])
            break
        (tables if m in (0xDB, 0xC4) else rest).append(seg)
        pos += 2 + n
    return b"\xff\xd8" + b"".join(tables) + b"\xff\xd9", b"\xff\xd8" + b"".join(rest)


def tiff() -> dict:
    rgb, g = smooth(37, 29, 41), smooth(37, 29, 42, 1)[..., 0]
    rgba = smooth(37, 29, 43, 4)
    lzw = {"compression": "tiff_lzw"}
    out = {
        "tiff_rgb.tif": pillow(Image.fromarray(rgb), "TIFF"),
        "tiff_rgba.tif": pillow(Image.fromarray(rgba), "TIFF"),
        "tiff_gray.tif": pillow(Image.fromarray(g), "TIFF"),
        "tiff_bilevel.tif": pillow(Image.fromarray(g).convert("1"), "TIFF"),
        "tiff_palette.tif": pillow(Image.fromarray(rgb).quantize(50), "TIFF"),
        "tiff_gray_alpha.tif": pillow(Image.fromarray(np.stack([g, g[::-1]], -1), "LA"), "TIFF"),
        "tiff_cmyk.tif": pillow(Image.fromarray(rgba, "CMYK"), "TIFF"),
        "tiff_gray16.tif": pillow(Image.fromarray(g.astype(np.uint16) + 200), "TIFF"),
        "tiff_float.tif": pillow(Image.fromarray(g.astype(np.float32) * 1.2 - 30), "TIFF"),
        "tiff_rgb_lzw.tif": pillow(Image.fromarray(rgb), "TIFF", **lzw),
        "tiff_rgb_lzw_predictor.tif": pillow(Image.fromarray(rgb), "TIFF", tiffinfo={317: 2}, **lzw),
        "tiff_rgba_packbits.tif": pillow(Image.fromarray(rgba), "TIFF", compression="packbits"),
        "tiff_gray_deflate.tif": pillow(Image.fromarray(g), "TIFF", compression="tiff_adobe_deflate"),
        "tiff_bilevel_lzw.tif": pillow(Image.fromarray(g).convert("1"), "TIFF", **lzw),
        "tiff_float_lzw_predictor.tif": pillow(Image.fromarray(g.astype(np.float32) - 9.5), "TIFF",
                                               tiffinfo={317: 2}, **lzw),
    }
    out["tiff_tiles_lzw.tif"] = tiff_file(37, 29, (8, 8, 8), 2, [tiff_lzw(t.tobytes()) for t in tiles(rgb, 16, 16)],
                                          ("tiles", 16, 16), compression=5)
    out["tiff_tiles_raw.tif"] = tiff_file(37, 29, (8,), 1, [t.tobytes() for t in tiles(g, 16, 16)],
                                          ("tiles", 16, 16))
    planes = [rgb[..., c] for c in range(3)]
    out["tiff_planar_deflate.tif"] = tiff_file(
        37, 29, (8, 8, 8), 2, [zlib.compress(s.tobytes()) for p in planes for s in split(p, 10)], ("strips", 10),
        compression=8, tags={284: (3, [2])})
    out["tiff_planar_raw.tif"] = tiff_file(37, 29, (8, 8, 8), 2, [p.tobytes() for p in planes], ("strips", 29),
                                           tags={284: (3, [2])})
    out["tiff_strips_packbits.tif"] = tiff_file(37, 29, (8, 8, 8), 2,
                                                [packbits((s // 32 * 32).tobytes()) for s in split(rgb, 7)],
                                                ("strips", 7), compression=32773)
    g16 = (g.astype(np.uint16) * 257 // 3 + 7)
    out["tiff_gray16_big_endian.tif"] = tiff_file(37, 29, (16,), 1, [g16.astype(">u2").tobytes()], ("strips", 29),
                                                  bo=">")
    out["tiff_gray16_predictor_lzw.tif"] = tiff_file(37, 29, (16,), 1,
                                                     [tiff_lzw(hdiff(g16).astype("<u2").tobytes())], ("strips", 29),
                                                     compression=5, tags={317: (3, [2])})
    rgb16 = rgb.astype(np.uint16) * 257 + 40
    out["tiff_rgb16.tif"] = tiff_file(37, 29, (16, 16, 16), 2, [rgb16.astype("<u2").tobytes()], ("strips", 29))
    out["tiff_rgb16_big_endian_deflate.tif"] = tiff_file(
        37, 29, (16, 16, 16), 2, [zlib.compress(rgb16.astype(">u2").tobytes())], ("strips", 29), compression=32946,
        bo=">")
    a = rgba[..., 3:].astype(np.int64)
    pre = np.concatenate([(rgba[..., :3] * a + 127) // 255, a], -1).astype(np.uint8)
    out["tiff_rgb_associated_alpha.tif"] = tiff_file(37, 29, (8, 8, 8, 8), 2, [pre.tobytes()], ("strips", 29),
                                                     tags={338: (3, [1])})
    out["tiff_rgb_unassociated_alpha_lzw.tif"] = tiff_file(37, 29, (8, 8, 8, 8), 2, [tiff_lzw(rgba.tobytes())],
                                                           ("strips", 29), compression=5, tags={338: (3, [2])})
    out["tiff_rgb_extra_unspecified.tif"] = tiff_file(37, 29, (8, 8, 8, 8), 2, [rgba.tobytes()], ("strips", 29),
                                                      tags={338: (3, [0])})
    idx = indices(37, 29, 16, 44)
    rng = np.random.default_rng(45)
    cmap = rng.integers(0, 65536, 48).tolist()
    packed4 = np.packbits(np.unpackbits(np.pad(idx, ((0, 0), (0, 1)))[..., None], axis=2)[..., 4:].reshape(29, -1),
                          axis=1)
    out["tiff_palette4.tif"] = tiff_file(37, 29, (4,), 3, [packed4.tobytes()], ("strips", 29),
                                         tags={320: (3, cmap)})
    out["tiff_white_is_zero.tif"] = tiff_file(37, 29, (8,), 0, [g.tobytes()], ("strips", 29))
    g4 = (g >> 4).astype(np.uint8)
    packed = np.packbits(np.unpackbits(np.pad(g4, ((0, 0), (0, 1)))[..., None], axis=2)[..., 4:].reshape(29, -1),
                         axis=1)
    out["tiff_gray4_white_is_zero.tif"] = tiff_file(37, 29, (4,), 0, [packed.tobytes()], ("strips", 29))
    g2 = (g >> 6).astype(np.uint8)
    packed2 = np.packbits(np.unpackbits(np.pad(g2, ((0, 0), (0, 3)))[..., None], axis=2)[..., 6:].reshape(29, -1),
                          axis=1)
    out["tiff_gray2.tif"] = tiff_file(37, 29, (2,), 1, [packed2.tobytes()], ("strips", 29))
    out["tiff_old_style_lzw.tif"] = tiff_file(37, 29, (8, 8, 8), 2, [tiff_lzw(rgb.tobytes(), old_style=True)],
                                              ("strips", 29), compression=5)
    bits = np.packbits(np.pad((g > 128).astype(np.uint8), ((0, 0), (0, 3))), axis=1)
    rev = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
    out["tiff_fill_order_2.tif"] = tiff_file(37, 29, (1,), 1, [rev[bits].tobytes()], ("strips", 29),
                                             tags={266: (3, [2])})
    out["tiff_fill_order_2_lzw.tif"] = tiff_file(37, 29, (1,), 1, [rev[np.frombuffer(tiff_lzw(bits.tobytes()),
                                                                                      np.uint8)].tobytes()],
                                                 ("strips", 29), compression=5, tags={266: (3, [2])})
    out["tiff_bigtiff.tif"] = tiff_file(37, 29, (8, 8, 8), 2, [rgb.tobytes()], ("strips", 29), big=True)
    for o in (3, 6, 7):  # Pillow 12 applies the tag when it loads the page
        out[f"tiff_orientation_{o}.tif"] = tiff_file(37, 29, (8,), 1, [tiff_lzw(g.tobytes())], ("strips", 29),
                                                     compression=5, tags={274: (3, [o])})
    # JPEG strips and tiles: YCbCr with the tables in JPEGTables, RGB, gray
    strips = []
    for s in split(rgb, 16):
        full = pillow(Image.fromarray(s), "JPEG", quality=85, subsampling=2)
        tables, abbreviated = jpeg_tables_split(full)
        strips.append(abbreviated)
    out["tiff_jpeg_ycbcr_strips.tif"] = tiff_file(37, 29, (8, 8, 8), 6, strips, ("strips", 16), compression=7,
                                                  tags={347: (7, list(tables)), 530: (3, [2, 2])})
    tl = [pillow(Image.fromarray(t), "JPEG", quality=90, subsampling=0) for t in tiles(rgb, 16, 16)]
    out["tiff_jpeg_ycbcr_tiles.tif"] = tiff_file(37, 29, (8, 8, 8), 6, tl, ("tiles", 16, 16), compression=7,
                                                 tags={530: (3, [1, 1])})
    rgb_jpeg = [jpeg_from_planes([s[..., c] for c in range(3)], jfif=False, adobe=0) for s in split(rgb, 29)]
    out["tiff_jpeg_rgb.tif"] = tiff_file(37, 29, (8, 8, 8), 2, rgb_jpeg, ("strips", 29), compression=7)
    out["tiff_jpeg_gray.tif"] = tiff_file(37, 29, (8,), 1, [pillow(Image.fromarray(g), "JPEG")], ("strips", 29),
                                          compression=7)
    # refused by Pillow: an unknown compression, a layout outside OPEN_INFO (two 8-bit samples, no extra)
    out["tiff_refused_compression.tif"] = tiff_file(37, 29, (8,), 1, [g.tobytes()], ("strips", 29),
                                                    compression=99)
    out["tiff_refused_layout.tif"] = tiff_file(37, 29, (8, 8), 1, [rgba[..., :2].tobytes()], ("strips", 29))
    return out


def thunderscan(px) -> bytes:
    """ThunderScan data of 4-bit rows: runs of the last pixel (never to the
    row's end, where libtiff leaves them unwritten), three 2-bit or two
    3-bit deltas, raw pixels."""
    d2, d3 = {0: 0, 1: 1, -1: 3}, {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    out = bytearray()
    for row in px:
        row = [int(v) for v in row]
        w, x, last = len(row), 0, 0
        while x < w:
            k = 0
            while x + k < w - 1 and k < 63 and row[x + k] == last:
                k += 1
            if k >= 2:
                out.append(k)
                x += k
                continue
            dd = [((row[x + i] - (row[x + i - 1] if i else last) + 8) % 16) - 8 for i in range(min(3, w - x))]
            if len(dd) == 3 and all(v in d2 for v in dd):
                out.append(0x40 | (d2[dd[0]] << 4) | (d2[dd[1]] << 2) | d2[dd[2]])
                x, last = x + 3, row[x + 2]
            elif len(dd) >= 2 and all(v in d3 for v in dd[:2]):
                out.append(0x80 | (d3[dd[0]] << 3) | d3[dd[1]])
                x, last = x + 2, row[x + 1]
            else:
                out.append(0xC0 | row[x])
                x, last = x + 1, row[x]
    return bytes(out)


def ycbcr_units(rgb, hs, vs):
    """YCbCr data units (hs x vs luma samples, then Cb, Cr of the unit's
    mean colour) of an RGB image, the edges replicated to whole units."""
    h, w = rgb.shape[:2]
    pad = np.pad(rgb.astype(np.float64), ((0, -h % vs), (0, -w % hs), (0, 0)), mode="edge")
    y = pad @ [0.299, 0.587, 0.114]
    cb = (pad[..., 2] - y) / 1.772 + 128
    cr = (pad[..., 0] - y) / 1.402 + 128
    by, bx = pad.shape[0] // vs, pad.shape[1] // hs
    yu = y.reshape(by, vs, bx, hs).transpose(0, 2, 1, 3).reshape(by, bx, hs * vs)
    cu = [c.reshape(by, vs, bx, hs).mean(axis=(1, 3))[..., None] for c in (cb, cr)]
    return np.clip(np.concatenate([yu] + cu, -1).round(), 0, 255).astype(np.uint8).tobytes()


def libtiff() -> dict:
    """TIFF forms Pillow reads through libtiff's other codecs: CCITT (RLE,
    T.4 one- and two-dimensional, T.6), LZMA, the floating-point predictor,
    YCbCr that JPEG did not code, ThunderScan and 12-bit gray; and the
    ones it refuses (WebP without libtiff's WebP codec, SGILog,
    uncompressed YCbCr)."""
    g = smooth(37, 29, 46, 1)[..., 0]
    rgb, rgba = smooth(37, 29, 47), smooth(37, 29, 48, 4)
    bl = Image.fromarray(g).convert("1")
    big = Image.fromarray(smooth(300, 200, 49, 1)[..., 0]).convert("1")
    out = {
        "tiff_libtiff_group4.tif": pillow(bl, "TIFF", compression="group4"),
        "tiff_libtiff_lzma.tif": pillow(Image.fromarray(g), "TIFF", compression="lzma"),
        "tiff_ccitt_rle.tif": pillow(bl, "TIFF", compression="tiff_ccitt"),
        "tiff_group3_1d.tif": pillow(bl, "TIFF", compression="group3"),
        "tiff_group3_2d.tif": pillow(bl, "TIFF", compression="group3", tiffinfo={292: 1}),
        "tiff_group3_2d_fill_bits.tif": pillow(big, "TIFF", compression="group3", tiffinfo={292: 5}),
        "tiff_group4_300x200.tif": pillow(big, "TIFF", compression="group4"),
        "tiff_ccitt_rle_300x200.tif": pillow(big, "TIFF", compression="tiff_ccitt"),
        "tiff_lzma_rgb.tif": pillow(Image.fromarray(rgb), "TIFF", compression="lzma"),
        "tiff_lzma_rgba.tif": pillow(Image.fromarray(rgba), "TIFF", compression="lzma"),
        "tiff_float_predictor3_lzw.tif": pillow(Image.fromarray(g.astype(np.float32) * 1.3 - 7), "TIFF",
                                                compression="tiff_lzw", tiffinfo={317: 3}),
        "tiff_float_predictor3_deflate.tif": pillow(Image.fromarray(g.astype(np.float32) / 3 + 0.25), "TIFF",
                                                    compression="tiff_adobe_deflate", tiffinfo={317: 3}),
        "tiff_ycbcr_lzw.tif": pillow(Image.fromarray(rgb).convert("YCbCr"), "TIFF", compression="tiff_lzw"),
    }
    # a G4 strip with FillOrder 2, and one in MinIsWhite
    g4 = Image.open(io.BytesIO(out["tiff_libtiff_group4.tif"]))
    strip = out["tiff_libtiff_group4.tif"][g4.tag_v2[273][0]:g4.tag_v2[273][0] + g4.tag_v2[279][0]]
    rev = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
    out["tiff_group4_fill_order_2.tif"] = tiff_file(37, 29, (1,), 1, [rev[np.frombuffer(strip, np.uint8)].tobytes()],
                                                    ("strips", 29), compression=4, tags={266: (3, [2])})
    out["tiff_group4_min_is_white.tif"] = tiff_file(37, 29, (1,), 0, [strip], ("strips", 29), compression=4)
    for hs, vs, comp in ((2, 2, 8), (2, 1, 5), (1, 2, 32773), (4, 2, 8)):
        units = [ycbcr_units(s, hs, vs) for s in split(rgb, 8)]
        enc = {8: zlib.compress, 5: tiff_lzw, 32773: packbits}[comp]
        out[f"tiff_ycbcr_{hs}{vs}_{comp}.tif"] = tiff_file(37, 29, (8, 8, 8), 6, [enc(u) for u in units],
                                                           ("strips", 8), compression=comp,
                                                           tags={530: (3, [hs, vs])})
    out["tiff_ycbcr_22_coefficients.tif"] = tiff_file(
        37, 29, (8, 8, 8), 6, [zlib.compress(ycbcr_units(rgb, 2, 2))], ("strips", 29), compression=8,
        tags={530: (3, [2, 2]), 529: (5, [2126, 10000, 7152, 10000, 722, 10000]),
              532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])})
    out["tiff_thunderscan.tif"] = tiff_file(37, 29, (4,), 1, [thunderscan(g >> 4)], ("strips", 29), compression=32809)
    v = g.astype(">u2") * 16 + 7
    bits = np.unpackbits(v.view(np.uint8).reshape(29, 37, 2), axis=2)[:, :, 4:].reshape(29, -1)
    packed = np.packbits(np.pad(bits, ((0, 0), (0, -bits.shape[1] % 8))), axis=1)
    out["tiff_gray12.tif"] = tiff_file(37, 29, (12,), 1, [packed.tobytes()], ("strips", 29))
    out["tiff_gray12_lzw.tif"] = tiff_file(37, 29, (12,), 1, [tiff_lzw(packed.tobytes())], ("strips", 29),
                                           compression=5)
    from vk_gltf_renderer_tpu_torch.ops.webp import encode_webp

    out["tiff_refused_webp.tif"] = tiff_file(37, 29, (8, 8, 8), 2, [encode_webp(rgb)], ("strips", 29),
                                             compression=50001)
    out["tiff_refused_sgilog.tif"] = tiff_file(37, 29, (16,), 32844, [bytes(37 * 29 * 2)], ("strips", 29),
                                               compression=34676, tags={339: (3, [2])})
    out["tiff_refused_ycbcr_raw.tif"] = tiff_file(37, 29, (8, 8, 8), 6, [rgb.tobytes()], ("strips", 29),
                                                  tags={530: (3, [1, 1])})
    return out


def libtiff_lab_zstd_ojpeg() -> dict:
    """TIFF forms Pillow reads through libtiff's ZSTD and old-style JPEG
    (6) codecs, and CIELab (Pillow converts LAB through LittleCMS): ZSTD
    strips (Pillow's and hand-made at other levels), old-style JPEG at 2x2
    and 1x1 sampling in the strip and through JPEGInterchangeFormat, Lab
    compressed and raw."""
    import zstandard

    g, rgb = smooth(37, 29, 46, 1)[..., 0], smooth(37, 29, 41)
    jp = pillow(Image.fromarray(rgb), "JPEG", quality=90)
    out = {"tiff_libtiff_old_jpeg.tif": tiff_file(37, 29, (8, 8, 8), 6, [jp], ("strips", 29), compression=6),
           "tiff_libtiff_cielab.tif": tiff_file(37, 29, (8, 8, 8), 8, [tiff_lzw(rgb.tobytes())], ("strips", 29),
                                                compression=5),
           "tiff_libtiff_zstd.tif": pillow(Image.fromarray(g), "TIFF", compression="zstd")}
    jp11 = pillow(Image.fromarray(smooth(37, 29, 44)), "JPEG", quality=85, subsampling=0)
    out["tiff_old_jpeg_11.tif"] = tiff_file(37, 29, (8, 8, 8), 6, [jp11], ("strips", 29), compression=6)
    first = tiff_file(37, 29, (8, 8, 8), 6, [jp], ("strips", 29), compression=6,
                      tags={513: (4, [0]), 514: (4, [len(jp)])})
    at = first.index(jp)
    out["tiff_old_jpeg_interchange.tif"] = tiff_file(37, 29, (8, 8, 8), 6, [jp], ("strips", 29), compression=6,
                                                     tags={513: (4, [at]), 514: (4, [len(jp)])})
    lab = np.random.default_rng(45).integers(0, 256, (29, 37, 3), dtype=np.uint8)
    out["tiff_cielab_raw.tif"] = tiff_file(37, 29, (8, 8, 8), 8, [lab.tobytes()], ("strips", 29))
    rgba = smooth(37, 29, 43, 4)
    for level in (1, 9, 19):
        strips = [zstandard.ZstdCompressor(level=level, write_checksum=level == 9).compress(s.tobytes())
                  for s in split(rgba, 8)]
        out[f"tiff_zstd_rgba_level{level}.tif"] = tiff_file(37, 29, (8, 8, 8, 8), 2, strips, ("strips", 8),
                                                           compression=50000, tags={338: (3, [2])})
    out["tiff_zstd_gray_predictor.tif"] = tiff_file(37, 29, (8,), 1, [zstandard.ZstdCompressor(level=3).compress(
        hdiff(g).tobytes())], ("strips", 29), compression=50000, tags={317: (3, [2])})
    out["tiff_refused_zstd_corrupt.tif"] = tiff_file(37, 29, (8,), 1, [b"\x28\xb5\x2f\xfd" + bytes(40)],
                                                     ("strips", 29), compression=50000)
    return out


# ------------------------------------------------------------------ JPEG forms


def jpeg() -> dict:
    rgb = smooth(45, 37, 51)
    from vk_gltf_renderer_tpu_torch.ops.jpeg import _rgb_to_ycc

    ycc = [p.astype(np.uint8) for p in _rgb_to_ycc(rgb)]
    cmyk = smooth(29, 23, 52, 4)
    out = {
        "jpeg_arith_sequential.jpg": jpeg_from_planes(ycc, samp=[(2, 2), (1, 1), (1, 1)], arith=True),
        "jpeg_arith_sequential_dac_restart.jpg": jpeg_from_planes(
            ycc, samp=[(2, 1), (1, 1), (1, 1)], arith=True, restart=3,
            dac={(0, 0): 0x52, (1, 0): 12, (0, 1): 0x20, (1, 1): 2}),
        "jpeg_arith_progressive.jpg": jpeg_from_planes(ycc, samp=[(2, 2), (1, 1), (1, 1)], arith=True,
                                                       progressive=True),
        "jpeg_arith_gray.jpg": jpeg_from_planes(ycc[:1], arith=True, progressive=True, restart=4),
        "jpeg_lossless_rgb.jpg": jpeg_lossless([rgb[..., c] for c in range(3)], predictor=7, restart_rows=8),
        "jpeg_lossless_gray_pt2.jpg": jpeg_lossless([rgb[..., 1]], predictor=4, pt=2),
        "jpeg_cmyk_adobe0.jpg": pillow(Image.fromarray(cmyk, "CMYK"), "JPEG", quality=80),
        "jpeg_cmyk_no_adobe.jpg": jpeg_from_planes([cmyk[..., c] for c in range(4)], jfif=False),
        "jpeg_ycck_adobe2.jpg": jpeg_from_planes(cmyk_to_ycck(cmyk), samp=[(2, 2), (1, 1), (1, 1), (2, 2)],
                                                 adobe=2, jfif=False),
        "jpeg_ycck_arith.jpg": jpeg_from_planes(cmyk_to_ycck(cmyk), adobe=2, jfif=False, arith=True),
        "jpeg_arith_progressive_restart.jpg": jpeg_from_planes(ycc, samp=[(2, 2), (1, 1), (1, 1)], arith=True,
                                                               progressive=True, restart=2),
        "jpeg_ycck_arith_restart.jpg": jpeg_from_planes(cmyk_to_ycck(cmyk), adobe=2, jfif=False, arith=True,
                                                        restart=2),
    }
    for hs, vs in ((2, 2), (2, 1), (1, 2)):
        cw, ch = -(-45 // hs), -(-37 // vs)
        small = [np.ascontiguousarray(rgb[::vs, ::hs, c][:ch, :cw]) for c in (1, 2)]
        for inter in (True, False):
            for adobe in (0, None):
                name = f"jpeg_lossless_{hs}x{vs}_{'interleaved' if inter else 'scans'}{'_adobe0' if adobe == 0 else ''}"
                out[name + ".jpg"] = jpeg_lossless([rgb[..., 0]] + small, predictor=1 + (hs + 2 * vs) % 7,
                                                   samp=[(hs, vs), (1, 1), (1, 1)], interleaved=inter,
                                                   size=(45, 37), adobe=adobe)
    base = jpeg_lossless([rgb[..., 0]])
    i = base.index(b"\xff\xc3")
    out["jpeg_refused_lossless_arith.jpg"] = base[:i] + b"\xff\xcb" + base[i + 2:]
    out["jpeg_refused_hierarchical.jpg"] = base[:i] + b"\xff\xc7" + base[i + 2:]
    out["jpeg_refused_lossless_jfif.jpg"] = jpeg_lossless([rgb[..., c] for c in range(3)], jfif=True)
    twelve = bytearray(pillow(Image.fromarray(rgb), "JPEG"))
    twelve[twelve.index(b"\xff\xc0") + 4] = 12
    out["jpeg_refused_12bit.jpg"] = bytes(twelve)
    return out


# ------------------------------------------------------------------ PSD


def psd_file(mode, bits, channels, w, h, planes, compression=0, cmap=b"", layers=b"", resources=b""):
    """A PSD whose merged image is `planes` (bytes of each channel, rows of
    (w * bits + 7) // 8 bytes), raw or PackBits row by row."""
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, channels, h, w, bits, mode)
    out = head + struct.pack(">I", len(cmap)) + cmap + struct.pack(">I", len(resources)) + resources
    out += struct.pack(">I", len(layers)) + layers
    row = (w * bits + 7) // 8
    if compression == 0:
        return out + struct.pack(">H", 0) + b"".join(planes)
    rows = [packbits(p[y * row:(y + 1) * row]) for p in planes for y in range(h)]
    return out + struct.pack(">H", 1) + b"".join(struct.pack(">H", len(r)) for r in rows) + b"".join(rows)


def psd() -> dict:
    w, h = 23, 17
    rgba = smooth(w, h, 61, 4)
    q = rgba // 16 * 16  # runs for PackBits
    g = smooth(w, h, 62, 1)[..., 0]
    planes = lambda a: [np.ascontiguousarray(a[..., c]).tobytes() for c in range(a.shape[2])]  # noqa: E731
    bits = np.packbits(g > 128, axis=1)
    rng = np.random.default_rng(63)
    pal = rng.integers(0, 256, (3, 256), dtype=np.uint8).tobytes()
    resource = b"8BIM" + struct.pack(">H", 1005) + b"\0\0" + struct.pack(">I", 5) + b"abcde\0"
    out = {
        "psd_rgb_raw.psd": psd_file(3, 8, 3, w, h, planes(rgba[..., :3])),
        "psd_rgba_packbits.psd": psd_file(3, 8, 4, w, h, planes(q), compression=1),
        "psd_gray_packbits.psd": psd_file(1, 8, 1, w, h, [(g // 32 * 32).tobytes()], compression=1),
        "psd_bitmap.psd": psd_file(0, 1, 1, w, h, [bits.tobytes()]),
        "psd_palette.psd": psd_file(2, 8, 1, w, h, [indices(w, h, 200, 64).tobytes()], cmap=pal),
        "psd_cmyk_packbits.psd": psd_file(4, 8, 4, w, h, planes(q), compression=1),
        "psd_duotone.psd": psd_file(8, 8, 1, w, h, [g.tobytes()], cmap=bytes(range(40))),
        "psd_rgb_five_channels_raw.psd": psd_file(3, 8, 5, w, h, planes(np.concatenate([rgba, q[..., :1]], -1))),
        "psd_rgb_layers_resources.psd": psd_file(3, 8, 3, w, h, planes(q[..., :3]), compression=1,
                                                 layers=struct.pack(">I", 0) + bytes(range(30)), resources=resource),
        "psd_lab_raw.psd": psd_file(9, 8, 3, w, h, planes(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))),
        "psd_lab_packbits.psd": psd_file(9, 8, 3, w, h, planes(q[..., :3]), compression=1),
    }
    # PackBits with more channels than the mode reads: Pillow takes the byte counts past the mode's channels for
    # data; refused: 16-bit samples, ZIP compression, a PSB (version 2)
    out["psd_refused_16bit.psd"] = psd_file(3, 16, 3, w, h, planes(np.repeat(rgba[..., :3], 2, axis=1)))
    out["psd_rgb_five_channels_packbits.psd"] = psd_file(3, 8, 5, w, h, planes(np.concatenate([q, q[..., :1]], -1)),
                                                         compression=1)
    zipped = bytearray(psd_file(3, 8, 3, w, h, planes(rgba[..., :3])))
    zipped[26 + 12: 26 + 14] = b"\0\2"
    out["psd_refused_zip.psd"] = bytes(zipped)
    psb = bytearray(out["psd_rgb_raw.psd"])
    psb[5] = 2
    out["psd_refused_psb.psd"] = bytes(psb)
    return out


# ------------------------------------------------------------------ SGI


def sgi_rle_rows(rows: list, bpc: int) -> list:
    """SGI RLE of each row (a 1-D array of samples): runs of 3+ equal
    samples, copy packets otherwise, up to 127 samples; a 0 count ends it."""
    out = []
    for r in rows:
        r = [int(v) for v in r]
        pk = []
        i = 0
        while i < len(r):
            j = i + 1
            while j < len(r) and j - i < 127 and r[j] == r[i]:
                j += 1
            if j - i >= 3:
                pk += [j - i, r[i]]
                i = j
                continue
            j = i + 1
            while j < len(r) and j - i < 127 and not (j + 2 < len(r) and r[j] == r[j + 1] == r[j + 2]):
                j += 1
            pk += [0x80 | (j - i)] + r[i:j]
            i = j
        pk.append(0)
        out.append(struct.pack(f">{len(pk)}{'B' if bpc == 1 else 'H'}", *pk))
    return out


def sgi_file(px, bpc=1, rle=False, dimension=None):
    """An SGI file of px [h, w, z] (uint8 or uint16), rows stored bottom-up,
    channel after channel."""
    h, w, z = px.shape
    dimension = dimension or (3 if z > 1 else 2)
    head = struct.pack(">hBBHHHHll4s80sl404s", 474, int(rle), bpc, dimension, w, h, z, 0, 255 if bpc == 1 else 65535,
                       b"", b"fixture", 0, b"")
    chans = [px[::-1, :, c] for c in range(z)]
    if not rle:
        dt = ">u1" if bpc == 1 else ">u2"
        return head + b"".join(c.astype(dt).tobytes() for c in chans)
    rows = sgi_rle_rows([r for c in chans for r in c], bpc)
    base = 512 + 8 * h * z
    starts, p = [], base
    for r in rows:
        starts.append(p)
        p += len(r)
    return head + struct.pack(f">{h * z}I", *starts) + struct.pack(f">{h * z}I", *map(len, rows)) + b"".join(rows)


def sgi() -> dict:
    w, h = 21, 15
    rgba = smooth(w, h, 71, 4)
    g = smooth(w, h, 72, 1)[..., 0]
    out = {
        "sgi_rgb.sgi": pillow(Image.fromarray(rgba[..., :3]), "SGI"),
        "sgi_rgba.sgi": pillow(Image.fromarray(rgba), "SGI"),
        "sgi_gray.bw": pillow(Image.fromarray(g), "SGI"),
        "sgi_rgb16.sgi": pillow(Image.fromarray(rgba[..., :3]), "SGI", bpc=2),
        "sgi_gray16.sgi": pillow(Image.fromarray(g), "SGI", bpc=2),
    }
    q = rgba // 32 * 32
    out["sgi_rgb_rle.rgb"] = sgi_file(q[..., :3], rle=True)
    out["sgi_rgba_rle.sgi"] = sgi_file(q, rle=True)
    out["sgi_gray_rle.bw"] = sgi_file((g // 40 * 40)[..., None], rle=True)
    out["sgi_rgba16_rle.sgi"] = sgi_file(q.astype(np.uint16) * 257 + 3, bpc=2, rle=True)
    out["sgi_gray_dimension1.bw"] = sgi_file(g[:1, :, None], dimension=1)
    # refused: two channels (no mode in Pillow's table), one channel with dimension 3
    out["sgi_refused_two_channels.sgi"] = sgi_file(rgba[..., :2])
    out["sgi_refused_gray_dimension3.sgi"] = sgi_file(g[..., None], dimension=3)
    return out


# ------------------------------------------------------------------ PCX and DCX


def pcx_rle(rows: bytes) -> bytes:
    """PCX RLE of a byte string (a whole image's scan lines): runs up to 63
    within each line, a byte >= 0xC0 always as a run."""
    out = bytearray()
    i = 0
    while i < len(rows):
        j = i + 1
        while j < len(rows) and j - i < 63 and rows[j] == rows[i]:
            j += 1
        if j - i > 1 or rows[i] >= 0xC0:
            out += bytes([0xC0 | (j - i), rows[i]])
        else:
            out.append(rows[i])
        i = j
    return bytes(out)


def pcx_file(w, h, bits, planes, lines, version=5, palette16=b"", stride=None, palette256=None):
    """A PCX: lines = [h][planes] bytes of each plane's scan line (stride
    bytes), RLE-coded line by line."""
    stride = stride or (w * bits + 7) // 8 + ((w * bits + 7) // 8) % 2
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, w - 1, h - 1, 72, 72)
    head += palette16.ljust(48, b"\0") + bytes([0, planes]) + struct.pack("<HH", stride, 1)
    body = b"".join(pcx_rle(b"".join(ln.ljust(stride, b"\0") for ln in row)) for row in lines)
    return head.ljust(128, b"\0") + body + (b"\x0c" + palette256 if palette256 is not None else b"")


def bitplanes(idx, nplanes):
    """[h][nplanes] packed bit planes of an index image."""
    return [[np.packbits((row >> p) & 1).tobytes() for p in range(nplanes)] for row in idx]


def pcx() -> dict:
    w, h = 19, 13
    rgb = smooth(w, h, 81)
    g = smooth(w, h, 82, 1)[..., 0]
    q = Image.fromarray(rgb).quantize(60)
    out = {
        "pcx_rgb.pcx": pillow(Image.fromarray(rgb), "PCX"),
        "pcx_gray.pcx": pillow(Image.fromarray(g), "PCX"),
        "pcx_palette.pcx": pillow(q, "PCX"),
        "pcx_bilevel.pcx": pillow(Image.fromarray(g).convert("1"), "PCX"),
        "pcx_rgb_even_width.pcx": pillow(Image.fromarray(smooth(20, 13, 83)), "PCX"),
    }
    rng = np.random.default_rng(84)
    pal16 = rng.integers(0, 256, (16, 3), dtype=np.uint8).tobytes()
    out["pcx_planes4.pcx"] = pcx_file(w, h, 1, 4, bitplanes(indices(w, h, 16, 85), 4), palette16=pal16)
    out["pcx_planes2.pcx"] = pcx_file(w, h, 1, 2, bitplanes(indices(w, h, 4, 86), 2), palette16=pal16)
    out["pcx_planes4_wide.pcx"] = pcx_file(40, 9, 1, 4, bitplanes(indices(40, 9, 16, 87), 4), palette16=pal16)
    out["pcx_rgb_odd_stride.pcx"] = pcx_file(w, h, 8, 3, [[r[:, c].tobytes() for c in range(3)] for r in rgb])
    ramp = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    out["pcx_gray_ramp_palette.pcx"] = pcx_file(w, h, 8, 1, [[r.tobytes()] for r in g], palette256=ramp)
    out["pcx_no_palette.pcx"] = pcx_file(w, h, 8, 1, [[r.tobytes()] for r in g])
    out["pcx_given_stride_odd.pcx"] = pcx_file(w, h, 8, 1, [[r.tobytes()] for r in g], stride=w,
                                               palette256=rng.integers(0, 256, 768, dtype=np.uint8).tobytes())
    # refused: 8 bits at version 3, 2 bits in one plane, a run across scan lines past the last line
    out["pcx_refused_version3_8bit.pcx"] = pcx_file(w, h, 8, 1, [[r.tobytes()] for r in g], version=3)
    out["pcx_refused_2bit.pcx"] = pcx_file(w, h, 2, 1, [[np.packbits(np.unpackbits(r[:, None] >> 6, axis=1)[
        :, 6:].reshape(-1)).tobytes()] for r in g])
    out["pcx_refused_truncated.pcx"] = out["pcx_rgb.pcx"][:300]
    pages = [out["pcx_palette.pcx"], out["pcx_rgb.pcx"]]
    offs, p = [], 4 + 4 * (len(pages) + 1)
    for pg in pages:
        offs.append(p)
        p += len(pg)
    out["dcx_two_pages.dcx"] = struct.pack("<I", 987654321) + struct.pack(f"<{len(pages) + 1}I", *offs, 0) \
        + b"".join(pages)
    one = out["pcx_rgb_odd_stride.pcx"]
    out["dcx_one_page.dcx"] = struct.pack("<III", 987654321, 12, 0) + one
    return out


# ------------------------------------------------------------------ ICO and CUR


def dib(px, bits, palette=None, mask=None, height_factor=2):
    """A BITMAPINFOHEADER DIB of px [h, w, 3 or 4] (bits 24 / 32) or an
    index image (bits 1, 4, 8 with palette [n, 3]), its height doubled as in
    an icon, then the AND mask (1 = transparent) rows."""
    h, w = px.shape[:2]
    ncol = 0 if palette is None else len(palette)
    info = struct.pack("<IiiHHIIiiII", 40, w, h * height_factor, 1, bits, 0, 0, 0, 0, ncol, 0)
    pal = b"" if palette is None else np.concatenate(
        [palette[:, ::-1], np.zeros((ncol, 1), np.uint8)], 1).tobytes()
    if bits >= 24:
        order = [2, 1, 0, 3][: bits // 8]
        rows = pack_rows(px[..., order], 8)
    else:
        rows = pack_rows(px, bits)
    m = mask if mask is not None else np.zeros((h, w), np.uint8)
    return info + pal + rows + pack_rows(m, 1)


def icon_dir(kind, entries):
    """An ICO (kind 1) or CUR (kind 2): entries = (w, h, colours, planes or
    hotspot x, bpp or hotspot y, image bytes)."""
    out = struct.pack("<HHH", 0, kind, len(entries))
    off = 6 + 16 * len(entries)
    body = b""
    for w, h, ncol, a, b, data in entries:
        out += struct.pack("<BBBBHHII", w % 256, h % 256, ncol, 0, a, b, len(data), off + len(body))
        body += data
    return out + body


def ico() -> dict:
    rgba = smooth(24, 24, 91, 4)
    rgba[..., 3] = np.where(rgba[..., 3] > 100, 255, rgba[..., 3] // 2)
    rgb16 = smooth(16, 16, 92)
    mask16 = indices(16, 16, 2, 93)
    pal = np.random.default_rng(94).integers(0, 256, (16, 3), dtype=np.uint8)
    idx = indices(32, 32, 16, 95)
    out = {
        "ico_png_sizes.ico": pillow(Image.fromarray(smooth(48, 48, 96, 4)), "ICO", sizes=[(16, 16), (32, 32), (48, 48)]),
        "ico_png_rgb.ico": pillow(Image.fromarray(smooth(32, 32, 97)), "ICO", sizes=[(32, 32)]),
    }
    out["ico_bmp32_alpha.ico"] = icon_dir(1, [(24, 24, 0, 1, 32, dib(rgba, 32))])
    out["ico_bmp24_mask.ico"] = icon_dir(1, [(16, 16, 0, 1, 24, dib(rgb16, 24, mask=mask16))])
    out["ico_bmp4_mask_largest.ico"] = icon_dir(1, [(16, 16, 0, 1, 24, dib(rgb16, 24, mask=mask16)),
                                                    (32, 32, 16, 1, 4, dib(idx, 4, pal, mask=indices(32, 32, 2, 98))),
                                                    (32, 32, 0, 1, 8, dib(idx, 8, pal))])
    out["ico_bmp1.ico"] = icon_dir(1, [(32, 32, 2, 1, 1, dib(idx % 2, 1, pal[:2], mask=indices(32, 32, 2, 99)))])
    out["ico_bmp8_gray_ramp.ico"] = icon_dir(1, [(16, 16, 0, 1, 8, dib(np.arange(256, dtype=np.uint8).reshape(16, 16),
                                                                         8, np.repeat(np.arange(256, dtype=np.uint8)
                                                                                      [:, None], 3, 1)))])
    out["ico_png_in_dir_256.ico"] = icon_dir(1, [(256, 256, 0, 1, 32, pillow(Image.fromarray(smooth(256, 256, 100, 4)),
                                                                              "PNG"))])
    out["cur_bmp24.cur"] = icon_dir(2, [(16, 16, 0, 3, 5, dib(rgb16, 24, mask=mask16))])
    out["cur_bmp32_largest.cur"] = icon_dir(2, [(16, 16, 0, 0, 0, dib(rgb16, 24)), (24, 24, 0, 1, 1, dib(rgba, 32))])
    out["cur_bmp8.cur"] = icon_dir(2, [(32, 32, 0, 0, 0, dib(idx, 8, pal))])
    # refused: an icon directory with no entries (and no other plugin takes the data), a cursor whose image is not a DIB
    out["ico_refused_empty.ico"] = struct.pack("<HHH", 0, 1, 0) + bytes(40)
    out["cur_refused_bad_dib.cur"] = icon_dir(2, [(16, 16, 0, 0, 0, b"\x07" * 100)])
    return out


# ------------------------------------------------------------------ QOI


def qoi() -> dict:
    rgba = smooth(27, 19, 101, 4)
    q = rgba // 24 * 24
    q[5:9, 3:20] = [10, 200, 30, 255]  # runs
    out = {
        "qoi_rgb.qoi": pillow(Image.fromarray(rgba[..., :3]), "QOI"),
        "qoi_rgba.qoi": pillow(Image.fromarray(rgba), "QOI"),
        "qoi_rgba_runs.qoi": pillow(Image.fromarray(q), "QOI"),
        "qoi_rgb_runs.qoi": pillow(Image.fromarray(q[..., :3]), "QOI"),
    }
    # a hand-made stream: an index before its entry is set (Pillow's (0, 0, 0, 0)), every op, a run past the end
    ops = bytes([0xFE, 10, 20, 30, 0x00 | 7, 0x40 | 0x1B, 0x80 | 40, 0x9C, 0xC0 | 3, 0xFF, 1, 2, 3, 4,
                 0x00 | ((10 * 3 + 20 * 5 + 30 * 7 + 255 * 11) % 64), 0xC0 | 20])
    out["qoi_hand_ops.qoi"] = b"qoif" + struct.pack(">IIBB", 5, 6, 4, 0) + ops + bytes(7) + b"\1"
    out["qoi_refused_truncated.qoi"] = out["qoi_rgb.qoi"][:60]
    return out


# ------------------------------------------------------------------ Sun raster


def sun_rle(data: bytes) -> bytes:
    """Sun byte-encoded RLE: runs of 3+ as 0x80 n-1 v, a lone 0x80 as 0x80 0."""
    out = bytearray()
    i = 0
    while i < len(data):
        j = i + 1
        while j < len(data) and j - i < 256 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([0x80, j - i - 1, data[i]])
            i = j
        else:
            for _ in range(j - i):
                out += b"\x80\x00" if data[i] == 0x80 else bytes([data[i]])
            i = j
    return bytes(out)


def sun_file(w, h, depth, rows, file_type=1, cmap=b"", cmap_type=1):
    """A Sun raster: rows padded to 16 bits (raw), or the unpadded rows
    RLE-coded as one stream (type 2, as Pillow reads it)."""
    stride = ((w * depth + 15) // 16) * 2
    if file_type == 2:
        body = sun_rle(b"".join(rows))
    else:
        body = b"".join(r.ljust(stride, b"\0") for r in rows)
    head = struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), file_type, cmap_type if cmap else 0, len(cmap))
    return head + cmap + body


def sun() -> dict:
    w, h = 21, 11
    rgb = smooth(w, h, 111)
    g = smooth(w, h, 112, 1)[..., 0]
    idx = indices(w, h, 40, 113)
    rng = np.random.default_rng(114)
    cmap = rng.integers(0, 256, (3, 40), dtype=np.uint8).tobytes()
    cmap16 = rng.integers(0, 256, (3, 16), dtype=np.uint8).tobytes()
    q = rgb // 32 * 32
    out = {
        "sun_bilevel.ras": sun_file(w, h, 1, [np.packbits(r > 128).tobytes() for r in g]),
        "sun_gray4.ras": sun_file(w, h, 4, [np.packbits(np.unpackbits((r >> 4)[:, None], axis=1)[:, 4:]).tobytes()
                                            for r in g]),
        "sun_gray8.ras": sun_file(w, h, 8, [r.tobytes() for r in g]),
        "sun_palette8.ras": sun_file(w, h, 8, [r.tobytes() for r in idx], cmap=cmap),
        "sun_palette4.ras": sun_file(w, h, 4, [np.packbits(np.unpackbits((r % 16)[:, None], axis=1)[:, 4:]).tobytes()
                                               for r in idx], cmap=cmap16),
        "sun_bgr24.ras": sun_file(w, h, 24, [r[:, ::-1].tobytes() for r in rgb]),
        "sun_rgb24_type3.ras": sun_file(w, h, 24, [r.tobytes() for r in rgb], file_type=3),
        "sun_bgrx32.ras": sun_file(w, h, 32, [np.concatenate([r[:, ::-1], r[:, :1]], 1).tobytes() for r in rgb]),
        "sun_xrgb32_type3.ras": sun_file(w, h, 32, [np.concatenate([r, r[:, :1]], 1).tobytes() for r in rgb],
                                         file_type=3),
        "sun_rle_gray8.ras": sun_file(w, h, 8, [(r // 64 * 64).tobytes() for r in g], file_type=2),
        "sun_rle_bgr24.ras": sun_file(w, h, 24, [r[:, ::-1].tobytes() for r in q], file_type=2),
        "sun_rle_palette8_0x80.ras": sun_file(w, h, 8, [np.where(r % 3 == 0, 0x80, r).astype(np.uint8).tobytes()
                                                         for r in idx], file_type=2,
                                              cmap=rng.integers(0, 256, (3, 256), dtype=np.uint8).tobytes()),
    }
    # refused: a raw palette type, 16 bits a pixel, an unknown file type, RLE data that end early
    out["sun_refused_cmap_type2.ras"] = sun_file(w, h, 8, [r.tobytes() for r in idx], cmap=cmap, cmap_type=2)
    out["sun_refused_depth16.ras"] = sun_file(w, h, 16, [r.astype(">u2").tobytes() for r in g])
    out["sun_refused_type6.ras"] = sun_file(w, h, 8, [r.tobytes() for r in g], file_type=6)
    out["sun_refused_rle_truncated.ras"] = out["sun_rle_bgr24.ras"][:-20]
    return out


# ------------------------------------------------------------------ PNG


def png() -> dict:
    """PNG forms beyond 8-bit gray and colour, written by scenes.png_file
    (Pillow writes neither Adam7 nor 16-bit RGB) and by Pillow; refused:
    a bad IHDR CRC, data cut short."""
    from vk_gltf_renderer_tpu_torch.scenes import png_file

    rng = np.random.default_rng(110)
    w, h = 29, 23
    pal = rng.integers(0, 256, (13, 3), dtype=np.uint8)
    idx = indices(w, h, 16, 111)
    rgb16 = (smooth(w, h, 112).astype(np.uint16) * 257) ^ rng.integers(0, 256, (h, w, 3), dtype=np.uint16)
    out = {
        "png_palette4_short_plte_trns.png": png_file(idx, 4, 3, palette=pal, trns=bytes(range(0, 250, 25)),
                                                     filters=[1, 4]),
        "png_palette8_adam7.png": png_file(indices(w, h, 200, 113), 8, 3, interlace=True,
                                           palette=rng.integers(0, 256, (200, 3), dtype=np.uint8), filters=3),
        "png_palette1.png": png_file(idx % 2, 1, 3, palette=pal[:2]),
        "png_palette2_adam7_trns.png": png_file(idx % 4, 2, 3, interlace=True, palette=pal[:4], trns=b"\x00\x80"),
        "png_gray1_adam7.png": png_file(idx % 2, 1, 0, interlace=True, filters=[0, 2]),
        "png_gray2_trns.png": png_file(idx % 4, 2, 0, trns=b"\x00\x00", filters=4),
        "png_gray4.png": png_file(idx, 4, 0, filters=[3, 1]),
        "png_gray16_trns.png": png_file(smooth(w, h, 114, 1)[..., 0].astype(np.uint16) * 3, 16, 0,
                                        trns=struct.pack(">H", 255)),
        "png_rgb16.png": png_file(rgb16, 16, 2, filters=[4, 3, 2, 1, 0]),
        "png_rgb16_adam7.png": png_file(rgb16, 16, 2, interlace=True, filters=4),
        "png_rgb8_adam7_trns.png": png_file(smooth(w, h, 115) // 64 * 64, 8, 2, interlace=True,
                                            trns=struct.pack(">3H", 64, 128, 192), filters=[1, 3]),
        "png_la16.png": png_file(rng.integers(0, 65536, (h, w, 2)), 16, 4, filters=2),
        "png_rgba16_adam7.png": png_file(rng.integers(0, 65536, (h, w, 4)), 16, 6, interlace=True, filters=[4, 1]),
        "png_la8_adam7.png": png_file(smooth(w, h, 116, 2), 8, 4, interlace=True, filters=[2, 4]),
        "png_pillow_1bit.png": pillow(Image.fromarray(idx % 2 * 255).convert("1"), "PNG"),
        "png_pillow_palette_bits2.png": pillow(Image.fromarray(smooth(w, h, 117)).quantize(4), "PNG", bits=2),
        "png_pillow_i16.png": pillow(Image.fromarray(smooth(w, h, 118, 1)[..., 0].astype(np.uint16) * 200), "PNG"),
    }
    good = out["png_rgb16.png"]
    i = good.index(b"IDAT")
    n = struct.unpack(">I", good[i - 4:i])[0]
    out["png_idat_crc_ignored.png"] = good[:i + 4 + n] + b"\0\0\0\0" + good[i + 8 + n:]
    out["png_refused_ihdr_crc.png"] = good[:29] + b"\0\0\0\0" + good[33:]
    out["png_refused_truncated.png"] = good[:i + 4 + n // 2] + good[i + 8 + n:]
    return out


# ------------------------------------------------------------------ BLP and FTEX


def blp1(w, h, compression, alpha, encoding, body, offset0, length0):
    """A BLP1 file: header, mip offsets and lengths, then body (the palette
    and indices, or the JPEG header's size, the header and mip 0)."""
    return (b"BLP1" + struct.pack("<iIIIiI", compression, alpha, w, h, encoding, 0)
            + struct.pack("<16I", offset0, *([0] * 15)) + struct.pack("<16I", length0, *([0] * 15)) + body)


def blp() -> dict:
    from vk_gltf_renderer_tpu_torch.scenes import blp2_file as blp2

    """BLP1 palette and JPEG, BLP2 palette (alpha depths 0, 1, 4, 8) and
    DXT1 (with and without alpha), DXT3, DXT5 (random blocks, so every
    block mode appears), Pillow's own BLP1 and BLP2; refused: raw BGRA
    (encoding 3), BLP2 JPEG, an unknown alpha encoding, a cut palette."""
    rng = np.random.default_rng(120)
    w, h = 16, 8
    pal = rng.integers(0, 256, (256, 4), dtype=np.uint8).tobytes()
    idx = indices(w, h, 256, 121).tobytes()
    p_img = Image.fromarray(smooth(w, h, 122)).quantize(40)
    out = {"blp_pillow_blp2.blp": pillow(p_img, "BLP"), "blp_pillow_blp1.blp": pillow(p_img, "BLP", blp_version="BLP1")}
    for depth in (0, 1, 4, 8):
        out[f"blp2_palette_alpha{depth}.blp"] = blp2(w, h, 1, depth, 0, pal, idx)
    for name, (aenc, depth, size) in {"dxt1": (0, 0, 8), "dxt1_alpha": (0, 1, 8), "dxt3": (1, 8, 16),
                                      "dxt5": (7, 8, 16), "dxt5_no_alpha_flag": (7, 0, 16)}.items():
        blocks = rng.integers(0, 256, (w // 4) * (h // 4) * size, dtype=np.uint8).tobytes()
        out[f"blp2_{name}.blp"] = blp2(w, h, 2, depth, aenc, pal, blocks)
    blocks = rng.integers(0, 256, 3 * 2 * 8, dtype=np.uint8).tobytes()
    out["blp2_dxt1_12x6.blp"] = blp2(12, 6, 2, 1, 0, pal, blocks)
    out["blp1_palette.blp"] = blp1(w, h, 1, 0, 5, pal + idx, 156 + 1024, len(idx))
    out["blp1_palette_alpha.blp"] = blp1(w, h, 1, 8, 4, pal + idx + b"extra", 0, len(idx))
    jp = pillow(Image.fromarray(smooth(w, h, 123)), "JPEG", quality=90)
    sos = jp.index(b"\xff\xda")
    head, rest = jp[:sos], jp[sos:]
    body = struct.pack("<I", len(head)) + head + b"pad!"
    for alpha in (0, 8):
        out[f"blp1_jpeg_alpha{alpha}.blp"] = blp1(w, h, 0, alpha, 0, body + rest, 156 + len(body), len(rest))
    out["blp_refused_raw_bgra.blp"] = blp2(w, h, 3, 8, 0, pal,
                                           rng.integers(0, 256, w * h * 4, dtype=np.uint8).tobytes())
    out["blp_refused_blp2_jpeg.blp"] = blp2(w, h, 1, 0, 0, pal, idx, compression=0)
    out["blp_refused_alpha_encoding.blp"] = blp2(w, h, 2, 8, 3, pal, bytes(128))
    out["blp_refused_cut_palette.blp"] = blp2(w, h, 1, 0, 0, pal, idx)[:148 + 600]
    return out


def ftex() -> dict:
    from vk_gltf_renderer_tpu_torch.scenes import ftex_file

    """FTEX: FTC (DXT1, random blocks) and FTU (uncompressed RGB); refused:
    an unknown format, two formats, data cut short."""
    rng = np.random.default_rng(130)
    out = {"ftex_dxt1.ftc": ftex_file(16, 12, 0, rng.integers(0, 256, 4 * 3 * 8, dtype=np.uint8).tobytes()),
           "ftex_dxt1_10x6.ftc": ftex_file(10, 6, 0, rng.integers(0, 256, 3 * 2 * 8, dtype=np.uint8).tobytes()),
           "ftex_rgb.ftu": ftex_file(13, 9, 1, smooth(13, 9, 131).tobytes())}
    out["ftex_refused_format.ftc"] = ftex_file(16, 12, 2, bytes(400))
    out["ftex_refused_two_formats.ftc"] = ftex_file(16, 12, 0, bytes(400), nformats=2)
    out["ftex_refused_truncated.ftu"] = ftex_file(13, 9, 1, smooth(13, 9, 131).tobytes()[:100])
    return out


# ------------------------------------------------------------------ XBM, XPM, MSP, IM


def xbm() -> dict:
    """XBM: Pillow's (with a hotspot too), hand-made with uppercase hex and
    single-digit bytes; refused: data cut short."""
    bits = indices(21, 13, 2, 140) * 255
    img = Image.fromarray(bits.astype(np.uint8)).convert("1")
    out = {"xbm_pillow.xbm": pillow(img, "XBM"), "xbm_pillow_hotspot.xbm": pillow(img, "XBM", hotspot=(3, 4))}
    vals = np.packbits(indices(21, 13, 2, 141).astype(bool), axis=1, bitorder="little").reshape(-1)
    text = ", ".join(f"0x{v:02X}" if i % 3 else f"0x{v:x}" for i, v in enumerate(vals))
    out["xbm_hand_hex_forms.xbm"] = (b"#define pic_width 21\n#define pic_height 13\n"
                                     b"static unsigned char pic_bits[] = {\n" + text.encode() + b"};\n")
    out["xbm_refused_truncated.xbm"] = out["xbm_pillow.xbm"][:-60]
    return out


def xpm_file(w, h, colours, rows, cpp=1, pixels_comment=True):
    lines = [b"/* XPM */", b"static char *pic[] = {", b"/* columns rows colors chars-per-pixel */",
             f'"{w} {h} {len(colours)} {cpp} ",'.encode()]
    lines += [b'"' + k + b" c " + v + b'",' for k, v in colours]
    if pixels_comment:
        lines.append(b"/* pixels */")
    lines += [b'"' + r + b'",' for r in rows]
    return b"\n".join(lines) + b"\n};\n"


def xpm() -> dict:
    """XPM, written here (Pillow has no XPM writer): one and two characters
    a pixel, a None key that no pixel uses (its bytes become per-entry
    alphas in Pillow's convert), over 256 colours (RGB); refused: a pixel
    of the None key, a colour name."""
    rng = np.random.default_rng(150)
    w, h = 11, 7
    keys1 = [bytes([c]) for c in b".Xo+@#"]
    cols = [(k, f"#{int(v):06x}".encode()) for k, v in zip(keys1, rng.integers(0, 1 << 24, 6))]
    idx = indices(w, h, 6, 151)
    rows1 = [b"".join(keys1[i] for i in r) for r in idx]
    out = {"xpm_one_char.xpm": xpm_file(w, h, cols, rows1),
           "xpm_none_unused.xpm": xpm_file(w, h, [(b" ", b"None")] + cols, rows1, pixels_comment=False)}
    keys2 = [bytes([a, b]) for a in b"abcdefghijklmnopqrst" for b in b"ABCDEFGHIJKLMNOP"][:300]
    cols2 = [(k, f"#{int(v):06X}".encode()) for k, v in zip(keys2, rng.integers(0, 1 << 24, 300))]
    idx2 = rng.integers(0, 300, (h, w))
    out["xpm_two_chars_rgb.xpm"] = xpm_file(w, h, cols2, [b"".join(keys2[i] for i in r) for r in idx2], cpp=2)
    out["xpm_two_chars_palette.xpm"] = xpm_file(w, h, cols2[:40], [b"".join(keys2[i % 40] for i in r) for r in idx2],
                                                cpp=2)
    used = [r.replace(b".", b" ") for r in rows1]
    out["xpm_refused_none_used.xpm"] = xpm_file(w, h, [(b" ", b"None")] + cols, used)
    out["xpm_refused_colour_name.xpm"] = xpm_file(w, h, [(b".", b"red")] + cols[1:], rows1)
    return out


def msp_header(version, w, h):
    words = [*struct.unpack("<2H", b"DanM" if version == 1 else b"LinS"), w, h, 1, 1, 1, 1, w, h, 0, 0, 0, 0, 0, 0]
    check = 0
    for v in words:
        check ^= v
    words[12] = check
    return struct.pack("<16H", *words)


def msp_rows(rows):
    """Version 2 rows: runs of 3+ equal bytes as (0, count, value), the rest
    as literal packets."""
    out = []
    for r in rows:
        r, enc, i = bytes(r), b"", 0
        while i < len(r):
            j = i
            while j < len(r) and j - i < 255 and r[j] == r[i]:
                j += 1
            if j - i >= 3:
                enc += bytes([0, j - i, r[i]])
                i = j
                continue
            j = i
            while j < len(r) and j - i < 255 and not (j + 2 < len(r) and r[j] == r[j + 1] == r[j + 2]):
                j += 1
            enc += bytes([j - i]) + r[i:j]
            i = j
        out.append(enc)
    return out


def msp() -> dict:
    """MSP: Pillow's version 1, version 2 written here (runs, an empty row,
    a literal packet cut at its row's end); refused: a bad checksum, a row
    cut short."""
    w, h = 37, 19
    bits = (indices(w, h, 2, 160) * 255).astype(np.uint8)
    packed = np.packbits(bits > 0, axis=1)
    out = {"msp_pillow_v1.msp": pillow(Image.fromarray(bits).convert("1"), "MSP")}
    rows = msp_rows(packed)
    rows[3] = b""
    out["msp_v2_rle.msp"] = msp_header(2, w, h) + struct.pack(f"<{h}H", *map(len, rows)) + b"".join(rows)
    cut = list(rows)
    cut[5] = bytes([9]) + packed[5].tobytes()[:2]  # a literal of 9 bytes of which the row holds 2
    cut += [bytes([0, 10, 0x55])]
    hh = h + 1
    out["msp_v2_cut_literal.msp"] = (msp_header(2, w, hh) + struct.pack(f"<{hh}H", *map(len, cut)) + b"".join(cut))
    bad = bytearray(out["msp_pillow_v1.msp"])
    bad[24] ^= 1
    out["msp_refused_checksum.msp"] = bytes(bad)
    out["msp_refused_truncated_row.msp"] = out["msp_v2_rle.msp"][:-5]
    return out


def im() -> dict:
    """IM: Pillow's for 1, L, LA, P (a Lut), PA, I, I;16, I;16B, F, RGB, RGBA,
    CMYK; written here: X 24, B4, L 32 S (unsigned samples past 2^31), PA
    with a colour Lut, float types of 8 and 16 bits, a gray Lut, CR
    at the start of lines, a NUL-padded header; refused: a size that is not
    a number, pixels cut short, a CR inside a line (the image type is then
    no type Pillow knows), RLB (no unpacker in Pillow). YCC is left out: Pillow reads it, the port does
    not (ROADMAP)."""
    w, h = 19, 13
    rgb, rgba = smooth(w, h, 170), smooth(w, h, 171, 4)
    g = rgb[..., 0]
    out = {}
    for mode, img in (("1", Image.fromarray(g).convert("1")), ("L", Image.fromarray(g)),
                      ("LA", Image.fromarray(rgba[..., :2], "LA")), ("P", Image.fromarray(rgb).quantize(30)),
                      ("PA", Image.fromarray(rgb).quantize(30).convert("PA")),
                      ("I", Image.fromarray(g.astype(np.int32) * 300 - 9000)),
                      ("I16", Image.fromarray(g.astype(np.uint16) * 2)),
                      ("I16B", Image.frombytes("I;16B", (w, h), (g.astype(">u2") + 100).tobytes())),
                      ("F", Image.fromarray(g.astype(np.float32) * 1.5 - 20)), ("RGB", Image.fromarray(rgb)),
                      ("RGBA", Image.fromarray(rgba)), ("CMYK", Image.fromarray(rgba, "CMYK"))):
        out[f"im_pillow_{mode.lower()}.im"] = pillow(img, "IM")

    def hand(itype, body, extra=b"", pad=512):
        head = b"Image type: " + itype + b" image\r\nImage size (x*y): %d*%d\r\n" % (w, h) + extra
        return head + b"\0" * (pad - 1 - len(head)) + b"\x1a" + body

    out["im_x24.im"] = hand(b"X 24", rgb.tobytes())
    out["im_float8.im"] = hand(b"L 8", g.tobytes())
    out["im_float16s.im"] = hand(b"L 16S", (g.astype("<i2") * 40 - 3000).tobytes())
    out["im_gray_lut.im"] = hand(b"Greyscale", g.tobytes(), b"Lut: 1\r\n") + b""
    out["im_gray_lut.im"] = (out["im_gray_lut.im"][:512] + np.repeat(np.arange(255, -1, -1, dtype=np.uint8)[None], 3, 0)
                             .tobytes() + g.tobytes())
    out["im_cr_lines.im"] = (b"\rImage type: L image\n\r\rImage size (x*y): %d*%d\n\x1a" % (w, h)) + g.tobytes()
    out["im_refused_cr_inside_line.im"] = (b"Image type: L image\rImage size (x*y): %d*%d\n\x1a" % (w, h)) + g.tobytes()
    out["im_b4.im"] = hand(b"B4", np.packbits(np.unpackbits(indices(w, h, 16, 172)[..., None], axis=-1)[..., 4:]
                                             .reshape(h, -1), axis=1).tobytes())
    out["im_l32s_unsigned.im"] = hand(b"L 32 S", ((g.astype("<u4") << 24) | 77).tobytes())
    lut = np.random.default_rng(173).integers(0, 256, 768, dtype=np.uint8).tobytes()
    out["im_pa_lut.im"] = hand(b"PA", lut + rgba[..., :2].transpose(0, 2, 1).tobytes(), b"Lut: 1\r\n")
    out["im_refused_rlb.im"] = hand(b"RLB", rgb.tobytes())
    out["im_refused_size_not_number.im"] = hand(b"Greyscale", g.tobytes()).replace(b"%d*%d" % (w, h), b"ab*cd")
    out["im_refused_truncated.im"] = hand(b"RGB", rgb.tobytes()[:-40])
    return out


def im_repaired() -> dict:
    """IM types Pillow reads that the port refused before: YCC (Pillow's
    YCbCr), the planar RGB3 and RYB3, "L*j" widths its bit decoder reads,
    "L 32 F"; refused: bit-decoded data cut short."""
    from vk_gltf_renderer_tpu_torch.scenes import im_bits, im_file

    w, h = 19, 13
    rng = np.random.default_rng(175)
    ycc = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    rgb = smooth(w, h, 176)
    out = {"im_ycc.im": im_file(b"YCC", w, h, ycc[::-1].transpose(0, 2, 1).tobytes())}
    planes = np.stack([rgb[..., 1], rgb[..., 0], rgb[..., 2]])[:, ::-1]  # G, R, B, each bottom row first
    out["im_rgb3.im"] = im_file(b"RGB3", w, h, planes.tobytes())
    out["im_ryb3.im"] = im_file(b"RYB3", w, h, planes.tobytes())
    for bits in (2, 4, 12, 27):
        vals = rng.integers(0, 1 << bits, (h, w), dtype=np.uint64) if bits > 4 else indices(w, h, 1 << bits, 177 + bits)
        out[f"im_bits{bits}.im"] = im_file(b"L*%d" % bits, w, h, im_bits(vals, bits))
    out["im_l32_f.im"] = im_file(b"L 32 F", w, h, (rgb[..., 0].astype("<u4") * 3)[::-1].tobytes())
    out["im_refused_bits_truncated.im"] = out["im_bits12.im"][:-30]
    return out


def blp_cmyk() -> dict:
    """BLP1 JPEG in CMYK: Pillow decodes it with the jpeg mode "CMYK" (no
    YCCK conversion, still inverted): a YCCK stream (Adobe transform 2) and
    Pillow's own CMYK JPEG."""
    w, h = 16, 8
    out = {}
    b = io.BytesIO()
    Image.fromarray(smooth(w, h, 124, 4), "CMYK").save(b, "JPEG", quality=90)
    ycck = jpeg()["jpeg_ycck_adobe2.jpg"]
    for name, jp in (("blp1_jpeg_cmyk.blp", b.getvalue()), ("blp1_jpeg_ycck.blp", ycck)):
        im = Image.open(io.BytesIO(jp))
        sos = jp.index(b"\xff\xda")
        body = struct.pack("<I", sos) + jp[:sos]
        out[name] = blp1(im.size[0], im.size[1], 0, 0, 0, body + jp[sos:], 156 + len(body), len(jp) - sos)
    return out


def iptc() -> dict:
    """IPTC records: raw gray, raw into band 2 of RGB and band 1 of CMYK,
    gray JPEG, data in several (8, 10) fields; refused: an unknown
    compression, a colour JPEG in a band, data cut short."""
    from vk_gltf_renderer_tpu_torch.ops.jpeg import encode_jpeg
    from vk_gltf_renderer_tpu_torch.scenes import iptc_file

    w, h = 19, 13
    g = smooth(w, h, 180)[..., 0]
    out = {"iptc_raw_gray.iim": iptc_file(w, h, g.tobytes()),
           "iptc_raw_rgb_band2.iim": iptc_file(w, h, g.tobytes(), 3, 1, 1, band=2),
           "iptc_raw_cmyk_band1.iim": iptc_file(w, h, g.tobytes(), 4, 1, 1, band=1),
           "iptc_raw_rgb_first_band.iim": iptc_file(w, h, g.tobytes(), 3, 1, 1),
           "iptc_jpeg_gray.iim": iptc_file(w, h, encode_jpeg(g), 1, 0, 5)}
    big = smooth(200, 180, 181)[..., 1]
    out["iptc_raw_two_fields.iim"] = iptc_file(200, 180, big.tobytes())
    out["iptc_refused_compression.iim"] = iptc_file(w, h, g.tobytes(), compression=3)
    out["iptc_refused_colour_jpeg_band.iim"] = iptc_file(w, h, encode_jpeg(smooth(w, h, 182)), 3, 1, 5, band=1)
    out["iptc_refused_truncated.iim"] = out["iptc_raw_gray.iim"][:-40]
    return out


def pixar_spider() -> dict:
    """PIXAR (RGB, layout 14/2) and SPIDER (big- and little-endian, and
    Pillow's own); refused: data cut short."""
    from vk_gltf_renderer_tpu_torch.scenes import pixar_file, spider_file

    w, h = 19, 13
    out = {"pixar_rgb.pxr": pixar_file(smooth(w, h, 185))}
    out["pixar_refused_truncated.pxr"] = out["pixar_rgb.pxr"][:-50]
    f = (smooth(w, h, 186)[..., 0].astype(np.float32) * 1.7 - 60).astype(np.float32)
    out["spider_big_endian.spi"] = spider_file(f)
    out["spider_little_endian.spi"] = spider_file(f, big_endian=False)
    out["spider_pillow.spi"] = pillow(Image.fromarray(f, "F"), "SPIDER")
    out["spider_refused_truncated.spi"] = out["spider_big_endian.spi"][:-20]
    return out


def fits() -> dict:
    """FITS: BITPIX 8, 16, 32, -32, -64 (big-endian, as the standard stores
    them; Pillow reads them with its little-endian raw modes), one NAXIS,
    tile-compressed GZIP_1 of 8, 16 and 32 bits; refused: GZIP_1 of float
    samples, a header without an image, data cut short."""
    from vk_gltf_renderer_tpu_torch.scenes import fits_file

    w, h = 19, 13
    g = smooth(w, h, 190)[..., 0].astype(np.int64)
    out = {"fits_8.fits": fits_file(g, 8), "fits_16.fits": fits_file(g * 3 + 7, 16),
           "fits_32.fits": fits_file(g * 5 - 100, 32), "fits_float32.fits": fits_file(g * 1.5 - 10, -32),
           "fits_float64.fits": fits_file(g * 0.5, -64), "fits_naxis1.fits": fits_file(g[:1], 8)}
    out["fits_naxis1.fits"] = out["fits_naxis1.fits"].replace(b"NAXIS   = 2", b"NAXIS   = 1")
    for bits in (8, 16, 32):
        out[f"fits_gzip_{bits}.fits"] = fits_file(g * (1 if bits == 8 else 300), bits, gzip_tile=True)
    out["fits_refused_gzip_float.fits"] = fits_file(g, -32, gzip_tile=True)
    out["fits_refused_no_image.fits"] = fits_file(g, 8, gzip_tile=True)[:2880]
    out["fits_refused_truncated.fits"] = fits_file(g, 16)[: 2880 + 200]
    return out


def mcidas_gbr() -> dict:
    """McIDAS areas of 1, 2 (with a row prefix) and 4 bytes a sample; GIMP
    brushes v1 gray, v2 gray and RGBA; refused: a stride shorter than a
    row, a brush cut short."""
    from vk_gltf_renderer_tpu_torch.scenes import gbr_file, mcidas_file

    w, h = 19, 13
    g = smooth(w, h, 195)[..., 0].astype(np.int64)
    out = {"mcidas_l.area": mcidas_file(g, 1), "mcidas_i16_prefix.area": mcidas_file(g * 257, 2, prefix=3),
           "mcidas_i32.area": mcidas_file(g * 3 - 200, 4)}
    bad = bytearray(out["mcidas_l.area"])
    struct.pack_into(">i", bad, 4 * 14, -5)  # word 15: a negative prefix, the stride shorter than a row
    out["mcidas_refused_stride.area"] = bytes(bad)
    out["gbr_v1_gray.gbr"] = gbr_file(g.astype(np.uint8), 1)
    out["gbr_v2_gray.gbr"] = gbr_file(g.astype(np.uint8), 2)
    out["gbr_v2_rgba.gbr"] = gbr_file(smooth(w, h, 196, 4), 2)
    out["gbr_refused_truncated.gbr"] = out["gbr_v2_rgba.gbr"][:-30]
    return out


def pcd() -> dict:
    """PhotoCD base images turned 0, 90 and 270 degrees (smooth planes, so
    that git stores them small); refused: data cut short."""
    from vk_gltf_renderer_tpu_torch.scenes import pcd_file

    y = smooth(768, 512, 200)[..., 0]
    c = smooth(384, 256, 201, 2)
    out = {f"pcd_{deg}.pcd": pcd_file(y, c[..., 0], c[..., 1], o) for deg, o in ((0, 0), (90, 1), (270, 3))}
    out["pcd_refused_truncated.pcd"] = out["pcd_0.pcd"][:300000]
    return out


def fli_lc(rows: dict, y0: int, n: int) -> bytes:
    """An LC chunk payload: lines y0 .. y0 + n - 1, each a list of packets
    (skip, run value or literal bytes)."""
    body = struct.pack("<HH", y0, n)
    for y in range(y0, y0 + n):
        packets = rows.get(y, [])
        body += bytes([len(packets)])
        for skip, v in packets:
            body += bytes([skip]) + (bytes([256 - v[1], v[0]]) if isinstance(v, tuple) else bytes([len(v)]) + v)
    return body


def fli() -> dict:
    """FLI (COLOR 11, BRUN) and FLC (COLOR 4; BRUN, COPY, BLACK and LC,
    BRUN and SS2 with skipped lines, a last-byte word, word runs and
    literals, PSTAMP); refused: an unknown chunk, a frame cut short."""
    from vk_gltf_renderer_tpu_torch.scenes import fli_brun, fli_chunk, fli_file, fli_palette

    w, h = 19, 13
    rng = np.random.default_rng(205)
    idx = indices(w, h, 200, 206)
    pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    pal64 = rng.integers(0, 64, (256, 3), dtype=np.uint8) << 2
    col = fli_chunk(4, fli_palette(pal))
    out = {"fli_brun_color64.fli": fli_file(w, h, [fli_chunk(11, fli_palette(pal64, 2)), fli_chunk(15, fli_brun(idx))],
                                            0xAF11),
           "flc_brun.flc": fli_file(w, h, [col, fli_chunk(15, fli_brun(idx))]),
           "flc_pstamp_copy.flc": fli_file(w, h, [col, fli_chunk(18, bytes(range(40))), fli_chunk(16, idx.tobytes())])}
    lc = fli_lc({2: [(1, (7, 5)), (2, b"abcdefg")], 3: [(0, bytes(range(19)))], 6: [(4, (9, 15))],
                 8: [(18, b"z")]}, 2, 8)
    out["flc_black_lc.flc"] = fli_file(w, h, [col, fli_chunk(16, idx.tobytes()), fli_chunk(13, b""), fli_chunk(12, lc)])
    ss2 = struct.pack("<H", 3)
    ss2 += struct.pack("<HH", 0x10000 - 2, 0x8000 | 0x5A) + struct.pack("<H", 2) + bytes([1, 256 - 3, 0x11, 0x22])
    ss2 += bytes([2, 2]) + b"wxyz"  # line 2: skip 2 lines, the last byte 0x5A, a run of 3 words, 2 literal words
    ss2 += struct.pack("<H", 1) + bytes([0, 9]) + bytes(range(100, 118))  # line 3: 9 literal words
    ss2 += struct.pack("<HH", 0x10000 - 4, 1) + bytes([5, 256 - 2, 0xAB, 0xCD])  # line 8: a run of 2 words after 5
    out["flc_brun_ss2.flc"] = fli_file(w, h, [col, fli_chunk(15, fli_brun(idx)), fli_chunk(7, ss2)])
    out["fli_refused_unknown_chunk.flc"] = fli_file(w, h, [col, fli_chunk(99, bytes(8))])
    out["fli_refused_truncated.flc"] = out["flc_brun.flc"][:-40]
    return out


def xvthumb_imt() -> dict:
    """XV thumbnails (3-3-2 indices, comment lines) and IM Tools gray;
    refused: data cut short."""
    from vk_gltf_renderer_tpu_torch.scenes import imt_file, xvthumb_file

    w, h = 19, 13
    out = {"xvthumb_332.xv": xvthumb_file(indices(w, h, 256, 210)), "imt_gray.imt": imt_file(smooth(w, h, 211)[..., 0])}
    out["xvthumb_refused_truncated.xv"] = out["xvthumb_332.xv"][:-25]
    out["imt_refused_truncated.imt"] = out["imt_gray.imt"][:-25]
    return out


def icns() -> dict:
    """ICNS: is32 RLE with its s8mk mask beside il32 + l8mk (the larger
    picked), it32 with its prefix and t8mk, raw ih32, an ic07 PNG entry
    beside it32; refused: RLE that passes its channel (the JPEG 2000
    entries: icns_jpeg2000)."""
    from vk_gltf_renderer_tpu_torch.scenes import icns_file, icns_rle, png_file

    def rle(img):
        return b"".join(icns_rle(img[..., k]) for k in range(3))

    i16, i32, i48, i128 = smooth(16, 16, 215), smooth(32, 32, 216), smooth(48, 48, 217), smooth(128, 128, 218)
    i16[:, 4:12] = 9  # runs
    m16, m32 = smooth(16, 16, 219)[..., 0], smooth(32, 32, 220)[..., 0]
    out = {"icns_is32_mask.icns": icns_file([(b"is32", rle(i16)), (b"s8mk", m16.tobytes())]),
           "icns_il32_over_is32.icns": icns_file([(b"is32", rle(i16)), (b"s8mk", m16.tobytes()), (b"il32", rle(i32)),
                                                  (b"l8mk", m32.tobytes())]),
           "icns_it32_mask.icns": icns_file([(b"it32", bytes(4) + rle(i128)), (b"t8mk", i128[..., 1].tobytes())]),
           "icns_ih32_raw.icns": icns_file([(b"ih32", i48.tobytes())]),
           "icns_ic07_png.icns": icns_file([(b"it32", bytes(4) + rle(i128)),
                                            (b"ic07", png_file(smooth(128, 128, 221, 4), 8, 6))])}
    bad = bytearray(rle(i16))
    bad[0] = 0xFF  # a run of 130 into a channel that holds fewer
    out["icns_refused_bad_rle.icns"] = icns_file([(b"is32", bytes(bad))])
    return out


def icns_jpeg2000() -> dict:
    """ICNS JPEG 2000 entries: a JP2 file as ic11 (32x32), a raw codestream
    with alpha as ic07 (128x128)."""
    from vk_gltf_renderer_tpu_torch.scenes import icns_file

    return {"icns_jpeg2000.icns": icns_file([(b"ic11", pillow(Image.fromarray(smooth(32, 32, 222)), "JPEG2000"))]),
            "icns_jpeg2000_ic07.icns": icns_file([(b"ic07", pillow(Image.fromarray(smooth(128, 128, 223, 4)),
                                                                   "JPEG2000", no_jp2=True, irreversible=True))])}


# ------------------------------------------------------------------ JPEG 2000


def box(kind: bytes, body: bytes, xl=False, zero=False) -> bytes:
    """A JP2 box: its length (XL when xl, 0 when zero: to the end of the file), type and body."""
    if zero:
        return struct.pack(">I", 0) + kind + body
    if xl:
        return struct.pack(">I", 1) + kind + struct.pack(">Q", 16 + len(body)) + body
    return struct.pack(">I", 8 + len(body)) + kind + body


def jp2_file(cs: bytes, w: int, h: int, nc: int, bpc: int = 7, enumcs=16, extra=b"", xl=False, zero=False) -> bytes:
    """A JP2 file around a codestream: signature, ftyp, jp2h (ihdr, colr of
    enumerated space `enumcs`, then `extra` boxes), jp2c."""
    ihdr = box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
    colr = box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))
    return (box(b"jP  ", b"\x0d\x0a\x87\x0a") + box(b"ftyp", b"jp2 " + struct.pack(">I", 0) + b"jp2 ")
            + box(b"jp2h", ihdr + colr + extra, xl=xl) + box(b"jp2c", cs, zero=zero))


def jpeg2000() -> dict:
    """JPEG 2000 written by Pillow's encoder (OpenJPEG): reversible and
    irreversible, the multiple component transform on and off, all five
    progressions with precincts and 16x16 code-blocks, one and six
    resolutions with 64x64 code-blocks, tiles with image and tile offsets,
    quality layers, PLT markers, odd sizes, L, LA, RGB, RGBA, 16-bit I;16
    and signed samples, raw codestreams and JP2 files; JP2 boxes written
    here around Pillow's codestreams (sYCC and CMYK colr, pclr + cmap for P
    and PA, cdef with alpha first, an XL box length and a last box of
    length 0); a CAP marker (Part 15) before COD, read past as OpenJPEG
    does; refused: a header cut short, a bad SIZ, the colour space gray
    for three components, and codestreams cut short (with and without
    their EOC: OpenJPEG's strict mode fails them); a COD whose code-blocks
    say HT (Part 15)."""
    def j2k(img, mode=None, **kw):
        return pillow(Image.fromarray(img, mode) if mode else Image.fromarray(img), "JPEG2000", **kw)

    rgb, rgba, odd = smooth(61, 47, 601), smooth(40, 30, 602, 4), smooth(37, 45, 603)
    gray = smooth(37, 45, 604, 1)[..., 0]
    la = smooth(33, 20, 605, 2)
    i16 = (smooth(37, 45, 606, 1)[..., 0].astype(np.uint16) * 257) ^ np.uint16(0x5A)
    out = {}
    for irr in (False, True):
        t = "irr" if irr else "rev"
        for prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
            out[f"j2k_{t}_{prog.lower()}_precincts.jp2"] = j2k(rgb, irreversible=irr, progression=prog,
                                                              precinct_size=(32, 32), codeblock_size=(16, 16))
        out[f"j2k_{t}_tiles_offsets_layers.j2k"] = j2k(smooth(70, 50, 607), irreversible=irr, no_jp2=True,
                                                        tile_size=(32, 24), tile_offset=(3, 5), offset=(7, 9),
                                                        quality_mode="rates", quality_layers=[30, 8, 2], plt=True)
        out[f"j2k_{t}_mct_off.jp2"] = j2k(odd, irreversible=irr, mct=0)
        out[f"j2k_{t}_one_resolution.j2k"] = j2k(gray, irreversible=irr, num_resolutions=1, no_jp2=True)
        out[f"j2k_{t}_six_resolutions.jp2"] = j2k(smooth(100, 90, 608), irreversible=irr, num_resolutions=6,
                                                  codeblock_size=(64, 64))
        out[f"j2k_{t}_rgba.jp2"] = j2k(rgba, irreversible=irr)
        out[f"j2k_{t}_la.j2k"] = j2k(la, "LA", irreversible=irr, no_jp2=True)
        out[f"j2k_{t}_i16.jp2"] = j2k(i16, "I;16", irreversible=irr)
        out[f"j2k_{t}_signed.j2k"] = j2k(gray, irreversible=irr, signed=True, no_jp2=True)
    out["j2k_irr_dB_layer.jp2"] = j2k(odd, irreversible=True, quality_mode="dB", quality_layers=[38])
    out["j2k_rev_l_odd.jp2"] = j2k(gray)
    out["j2k_rev_one_row.jp2"] = j2k(smooth(9, 1, 609))
    out["j2k_rev_comment.j2k"] = j2k(odd, no_jp2=True, comment="a comment segment")
    # JP2 boxes written here around Pillow's codestreams
    cs3 = j2k(odd, irreversible=True, mct=0, no_jp2=True)
    out["j2k_box_sycc.jp2"] = jp2_file(cs3, 37, 45, 3, enumcs=18)
    out["j2k_refused_gray_colr_rgb.jp2"] = jp2_file(cs3, 37, 45, 3, enumcs=17)
    out["j2k_box_xl_and_zero_length.jp2"] = jp2_file(cs3, 37, 45, 3, xl=True, zero=True)
    cs4 = j2k(rgba, mct=0, no_jp2=True)
    out["j2k_box_cmyk.jp2"] = jp2_file(cs4, 40, 30, 4, enumcs=12)
    cdef = box(b"cdef", struct.pack(">H", 4) + b"".join(struct.pack(">HHH", i, t, a) for i, t, a in
                                                         ((0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3))))
    out["j2k_box_cdef_alpha_first.jp2"] = jp2_file(cs4, 40, 30, 4, extra=cdef)
    idx = (smooth(37, 45, 610, 1)[..., 0] // 40).astype(np.uint8)  # 7 indices
    pal = smooth(8, 1, 611)[0]
    pal[5] = pal[2]  # a repeated entry: Pillow's getcolor keeps the first
    pclr = box(b"pclr", struct.pack(">HB", 8, 3) + bytes([7, 7, 7]) + pal.tobytes())
    cmap = box(b"cmap", struct.pack(">HBB", 0, 1, 0) + struct.pack(">HBB", 0, 1, 1) + struct.pack(">HBB", 0, 1, 2))
    out["j2k_box_pclr.jp2"] = jp2_file(j2k(idx, no_jp2=True), 37, 45, 1, extra=pclr + cmap)
    ia = np.stack([idx, smooth(37, 45, 612, 1)[..., 0]], -1)
    out["j2k_box_pclr_alpha.jp2"] = jp2_file(j2k(ia, "LA", no_jp2=True), 37, 45, 2, extra=pclr + cmap)
    # refused by Pillow
    cs = j2k(odd, no_jp2=True)
    out["j2k_refused_cut_in_siz.j2k"] = cs[:20]
    bad = bytearray(cs)
    bad[40:42] = b"\x00\x07"  # Csiz 7: no mode for it
    out["j2k_refused_bad_siz.j2k"] = bytes(bad)
    cod = cs.index(b"\xff\x52")
    out["j2k_cap_marker.j2k"] = cs[:cod] + b"\xff\x50\x00\x08\x00\x02\x00\x00\x00\x00" + cs[cod:]
    ht = bytearray(cs)
    ht[cod + 12] |= 0x40  # Part 15's HT code-blocks: the port refuses them (ROADMAP A)
    out["j2k_refused_ht_codeblocks.j2k"] = bytes(ht)
    # cut short
    big = j2k(smooth(64, 64, 613), irreversible=True, no_jp2=True)
    out["j2k_refused_cut_half_no_eoc.j2k"] = big[: len(big) // 2]
    out["j2k_refused_cut_half_eoc.j2k"] = big[: len(big) // 2] + b"\xff\xd9"
    return out


def packed_headers(cs: bytes, where: str) -> bytes:
    """A one-tile-part codestream with SOP and EPH markers rewritten with
    its packet headers packed into a PPM marker (where "ppm", in the main
    header) or a PPT marker (where "ppt", in the tile-part header): each
    packet's header runs from after its SOP to its EPH, included (bit
    stuffing keeps FF 92 out of a header, the MQ coder out of a body)."""
    sot = cs.index(b"\xff\x90")
    sod = cs.index(b"\xff\x93", sot)
    body = cs[sod + 2 : -2]
    assert body[:2] == b"\xff\x91" and cs[-2:] == b"\xff\xd9" and b"\xff\x90" not in cs[sot + 2 :]
    headers, data, at = bytearray(), bytearray(), 0
    while at < len(body):
        eph = body.index(b"\xff\x92", at) + 2
        nxt = body.find(b"\xff\x91", eph)
        nxt = len(body) if nxt < 0 else nxt
        data += body[at : at + 6] + body[eph:nxt]
        headers += body[at + 6 : eph]
        at = nxt
    if where == "ppm":
        main = cs[:sot] + b"\xff\x60" + struct.pack(">HB", 7 + len(headers), 0) + struct.pack(">I", len(headers)) + headers
        tph = cs[sot + 12 : sod]
    else:
        main = cs[:sot]
        tph = cs[sot + 12 : sod] + b"\xff\x61" + struct.pack(">HB", 3 + len(headers), 0) + headers
    psot = 12 + len(tph) + 2 + len(data)
    return main + cs[sot : sot + 6] + struct.pack(">I", psot) + cs[sot + 10 : sot + 12] + tph + b"\xff\x93" + data + cs[-2:]


def restated_headers(cs: bytes) -> bytes:
    """A one-tile-part codestream of three components with its COD and QCD
    restated: a COC and a QCC for component 1 in the main header, and the
    COD and QCD again in the tile-part header (the same values: the
    pixels stay, the markers are read)."""
    def seg(marker):
        at = cs.index(marker)
        return cs[at : at + 2 + struct.unpack_from(">H", cs, at + 2)[0]]

    cod, qcd = seg(b"\xff\x52"), seg(b"\xff\x5c")
    coc = b"\xff\x53" + struct.pack(">H", 4 + len(cod) - 9) + b"\x01" + bytes([cod[4] & 1]) + cod[9:]
    qcc = b"\xff\x5d" + struct.pack(">H", len(qcd) - 4 + 2 + 1) + b"\x01" + qcd[4:]
    sot = cs.index(b"\xff\x90")
    psot = struct.unpack_from(">I", cs, sot + 6)[0] + len(cod) + len(qcd)
    return (cs[:sot] + coc + qcc + cs[sot : sot + 6] + struct.pack(">I", psot) + cs[sot + 10 : sot + 12] + cod + qcd
            + cs[sot + 12 :])


def jpeg2000_openjpeg() -> dict:
    """JPEG 2000 codestreams that OpenJPEG's encoder writes when asked
    through its own parameters (openjpeg_encode.py; Pillow's save has no
    such options): each code-block style bit alone and all together,
    reversible and irreversible (bypass, reset, termination on each pass,
    vertically causal contexts, predictable termination, segmentation
    symbols), SOP and EPH markers, packed packet headers (PPM, PPT:
    packed_headers), COC, QCC and a tile-part header's COD and QCD
    (restated_headers), a region of interest (maxshift),
    progression order changes, per-resolution precincts, and 4:2:0 and
    4:2:2 subsampled components at odd sizes (Pillow takes them for
    sYCC)."""
    from openjpeg_encode import encode

    rgb = smooth(53, 41, 700)
    planes = [rgb[..., c] for c in range(3)]
    out = {}
    for mode in (1, 2, 4, 8, 16, 32, 63):
        for irr in (False, True):
            out[f"j2k_opj_style_{mode}_{'irr' if irr else 'rev'}.j2k"] = encode(planes, mode=mode, irreversible=irr,
                                                                               cblk=(16, 16), numres=4)
    out["j2k_opj_sop_eph.j2k"] = encode(planes, sop=True, eph=True, cblk=(16, 16))
    layered = encode(planes, sop=True, eph=True, rates=[40, 12, 4], irreversible=True, cblk=(16, 16))
    out["j2k_opj_ppm.j2k"] = packed_headers(layered, "ppm")
    out["j2k_opj_ppt.j2k"] = packed_headers(layered, "ppt")
    out["j2k_opj_tile_parts_by_resolution.j2k"] = encode(planes, tiles=(32, 24), tile_parts="R", numres=3,
                                                         cblk=(16, 16))
    one = encode(planes, cblk=(16, 16))
    sot = one.index(b"\xff\x90")
    out["j2k_opj_psot_zero.j2k"] = one[: sot + 6] + bytes(4) + one[sot + 10 :]  # the last tile-part runs to EOC
    out["j2k_opj_coc_qcc_tile_header.j2k"] = restated_headers(encode(planes, irreversible=True, rates=[12],
                                                                     precincts=[(32, 32), (16, 16)], cblk=(16, 16)))
    out["j2k_opj_eph_layers_irr.j2k"] = encode(planes, eph=True, rates=[30, 10, 3], irreversible=True)
    out["j2k_opj_roi_rev.j2k"] = encode(planes, roi=(0, 6), cblk=(16, 16))
    out["j2k_opj_roi_irr.j2k"] = encode(planes, roi=(1, 7), irreversible=True, rates=[20])
    out["j2k_opj_poc.j2k"] = encode(planes, pocs=[(0, 0, 1, 2, 3, "RPCL"), (2, 0, 1, 6, 3, "CPRL")])
    out["j2k_opj_precincts_rpcl.j2k"] = encode(planes, precincts=[(32, 32), (16, 16), (8, 8)], prog="RPCL",
                                               cblk=(8, 8))
    out["j2k_opj_ycc420_rev.j2k"] = encode([rgb[..., 0], rgb[::2, ::2, 1], rgb[::2, ::2, 2]],
                                           sub=[(1, 1), (2, 2), (2, 2)])
    out["j2k_opj_ycc420_irr.j2k"] = encode([rgb[..., 0], rgb[::2, ::2, 1], rgb[::2, ::2, 2]],
                                           sub=[(1, 1), (2, 2), (2, 2)], irreversible=True)
    out["j2k_opj_ycc422.j2k"] = encode([rgb[..., 0], rgb[:, ::2, 1], rgb[:, ::2, 2]], sub=[(1, 1), (2, 1), (2, 1)])
    # precisions past 8 bits and below: Pillow's shifts to 8 bits (with its rounding offset), to 16 for I;16
    wide = rgb.astype(np.int64) * 16 + smooth(53, 41, 701) % 16
    out["j2k_opj_gray12.j2k"] = encode([wide[..., 0]], prec=12)
    out["j2k_opj_rgb12_irr.j2k"] = encode([wide[..., c] for c in range(3)], prec=12, irreversible=True)
    out["j2k_opj_rgb5_signed.j2k"] = encode([(rgb[..., c] >> 3).astype(np.int64) - 16 for c in range(3)], prec=5,
                                            signed=True)
    return out


def jpeg2000_large() -> dict:
    """The maps chip_smoke.py times (not in the CPU tests): a 2048x2048
    lossy JP2 at about 0.5 bits a pixel and a 512x512 lossless codestream,
    of scenes.texture_image."""
    from vk_gltf_renderer_tpu_torch.scenes import texture_image

    def j2k(img, **kw):
        return pillow(Image.fromarray(img), "JPEG2000", **kw)

    return {"j2k_map_2048_lossy.jp2": j2k(texture_image(2048, seed=7)[..., :3], irreversible=True,
                                          quality_mode="rates", quality_layers=[48]),
            "j2k_map_512_lossless.j2k": j2k(texture_image(512, seed=3)[..., :3], no_jp2=True)}


# ------------------------------------------------------------------ AVIF


# aom's intra tools, each switched off on the ladder's first rung and on again one at a time
AVIF_TOOLS = ("smooth-intra", "paeth-intra", "cfl-intra", "filter-intra", "angle-delta", "directional-intra",
              "diagonal-intra", "intra-edge-filter")


def avif_file(img, **kw) -> bytes:
    """Pillow's AVIF writer, one thread (aom's output does not then depend on the machine), quality 100 (aom's
    lossless mode) unless asked otherwise."""
    kw.setdefault("quality", 100)
    kw.setdefault("max_threads", 1)
    return pillow(Image.fromarray(img), "AVIF", **kw)


def avif() -> dict:
    """AVIF stills from Pillow's writer (libavif over aom): coded lossless
    AV1 (quality 100) at 4:4:4, 4:2:2 and 4:2:0, RGB and RGBA, limited
    range, odd sizes and one-row images, uniform tiles, and a ladder of
    aom's intra tools (DC prediction in square partitions first, then one
    tool, partition shape or superblock size at a time, named in the file)."""
    out = {}
    rgb = smooth(45, 37, 800)
    rgba = np.concatenate([rgb, smooth(45, 37, 801, 1)], axis=-1)
    for sub in ("4:4:4", "4:2:2", "4:2:0"):
        tag = sub.replace(":", "")
        out[f"avif_q100_{tag}.avif"] = avif_file(rgb, subsampling=sub)
        out[f"avif_q100_rgba_{tag}.avif"] = avif_file(rgba, subsampling=sub)
        for w, h in ((1, 1), (33, 1), (1, 9), (7, 5), (66, 3)):
            out[f"avif_q100_{tag}_{w}x{h}.avif"] = avif_file(smooth(w, h, 802 + w * h), subsampling=sub)
    out["avif_q100_limited_range_420.avif"] = avif_file(rgb, subsampling="4:2:0", range="limited")
    out["avif_q100_rgba_idat_420.avif"] = avif_in_idat(out["avif_q100_rgba_420.avif"])
    # an Exif orientation becomes irot/imir; Pillow reads the pixels as stored and hands the orientation on in info
    for orientation in (2, 6):
        exif = Image.Exif()
        exif[0x0112] = orientation
        out[f"avif_q100_exif_orientation_{orientation}.avif"] = avif_file(rgb, subsampling="4:4:4", exif=exif.tobytes())
    noise = np.random.default_rng(803).integers(0, 256, (40, 52, 3), np.uint8)
    out["avif_q100_noise_444.avif"] = avif_file(noise, subsampling="4:4:4")
    big = smooth(200, 150, 804)
    out["avif_q100_tiles_2x2_420.avif"] = avif_file(big, subsampling="4:2:0", tile_rows=1, tile_cols=1)
    out["avif_q100_tiles_1x4_444.avif"] = avif_file(big, subsampling="4:4:4", tile_cols=2)
    # the ladder at aom's slowest speed, which tries every tool, partition shape and filter intra mode
    off = [(f"enable-{t}", "0") for t in AVIF_TOOLS]
    square = [("enable-rect-partitions", "0"), ("enable-ab-partitions", "0"), ("enable-1to4-partitions", "0")]
    ladder = smooth(96, 80, 805)
    out["avif_q100_ladder_dc_square.avif"] = avif_file(ladder, subsampling="4:2:0", speed=0, advanced=off + square)
    for t in AVIF_TOOLS:
        on = ("enable-diagonal-intra", "enable-directional-intra") if t == "diagonal-intra" else (f"enable-{t}",)
        adv = [(k, "1" if k in on else v) for k, v in off] + square
        out[f"avif_q100_ladder_{t}.avif"] = avif_file(ladder, subsampling="4:2:0", speed=0, advanced=adv)
    for part, sub in (("rect", "4:2:0"), ("ab", "4:4:4"), ("1to4", "4:2:2")):
        out[f"avif_q100_ladder_{part}_partitions.avif"] = avif_file(ladder, subsampling=sub, speed=0, advanced=[
            (f"enable-{p}-partitions", "1" if p == part else "0") for p in ("rect", "ab", "1to4")])
    out["avif_q100_ladder_all_tools_444.avif"] = avif_file(ladder, subsampling="4:4:4", speed=0)
    out["avif_q100_ladder_all_tools_420.avif"] = avif_file(ladder, subsampling="4:2:0", speed=0)
    out["avif_q100_ladder_sb128.avif"] = avif_file(big, subsampling="4:2:0", advanced=[("sb-size", "128")])
    out["avif_q100_ladder_min_partition_4.avif"] = avif_file(ladder, subsampling="4:2:0", advanced=[
        ("min-partition-size", "4"), ("max-partition-size", "16")])
    # skipped blocks: a flat patch that DC prediction reproduces exactly
    patch = smooth(64, 48, 806)
    patch[8:40, 16:48] = (120, 60, 200)
    out["avif_q100_flat_patch_420.avif"] = avif_file(patch, subsampling="4:2:0")
    return out


def avif_in_idat(data: bytes) -> bytes:
    """The same AVIF with its items' data moved into the meta box's idat (iloc version 1, construction method
    1) and no mdat: the layout libavif reads and Pillow's writer never makes."""
    def boxes(buf, pos, end):
        while pos < end:
            size, typ = struct.unpack_from(">I4s", buf, pos)
            yield typ, buf[pos + 8 : pos + size]
            pos += size

    def box(typ, body):
        return struct.pack(">I4s", 8 + len(body), typ) + body

    top = dict(boxes(data, 0, len(data)))
    meta = list(boxes(top[b"meta"], 4, len(top[b"meta"])))
    iloc = dict(meta)[b"iloc"]
    assert iloc[:6] == b"\x00\x00\x00\x00\x44\x00"  # version 0, 4-byte offsets and lengths, no base offset
    count = struct.unpack_from(">H", iloc, 6)[0]
    entries, idat, pos = [], b"", 8
    for _ in range(count):
        iid, _, n = struct.unpack_from(">HHH", iloc, pos)
        pos += 6
        entry = struct.pack(">HHHH", iid, 1, 0, n)
        for _ in range(n):
            off, length = struct.unpack_from(">II", iloc, pos)
            pos += 8
            entry += struct.pack(">II", len(idat), length)
            idat += data[off : off + length]
        entries.append(entry)
    new_iloc = b"\x01\x00\x00\x00\x44\x00" + struct.pack(">H", count) + b"".join(entries)
    body = b"".join(box(t, new_iloc) + box(b"idat", idat) if t == b"iloc" else box(t, b) for t, b in meta)
    return box(b"ftyp", top[b"ftyp"]) + box(b"meta", top[b"meta"][:4] + body)


def avif_lossy_image(w, h, seed):
    """A smooth image with a noise patch and a sharp-edged bar: large transforms, small ones and filtered edges."""
    img = smooth(w, h, seed)
    rng = np.random.default_rng(seed)
    img[h // 4 : h // 2, w // 2 : w // 2 + w // 4] = rng.integers(0, 256, (h // 2 - h // 4, w // 4, 3), np.uint8)
    img[h // 2 + 4 : h // 2 + 12, 4 : w - 4] = (230, 40, 90)
    return img


# aom's transform switches for the lossy ladder (libavif hands each to aom as a codec option)
AVIF_TX_SWITCHES = (("enable-tx64", "0"), ("enable-rect-tx", "0"), ("reduced-tx-type-set", "1"),
                    ("enable-flip-idtx", "0"), ("use-intra-dct-only", "1"), ("use-intra-default-tx-only", "1"))


def avif_lossy() -> dict:
    """Lossy AVIF stills from Pillow's writer at its defaults but for what the name says (quality 75, speed 6,
    4:2:0): a quality ladder at 4:4:4, 4:2:2 and 4:2:0, RGBA with a lossy alpha item, the odd sizes of the
    lossless set, 2x2 and 1x4 tiles, 64x64 and 128x128 superblocks, speeds 5-10, aom's transform switches one at a
    time, the deblocking filter off, a sharpness, CDEF on with every strength 0, and speed 0 without loop
    restoration (every intra tool aom tries). The deblocking filter is the only loop filter of each."""
    out = {}
    rgb = smooth(45, 37, 800)
    out["avif_refused_q75.avif"] = avif_file(rgb, quality=75)  # the name from when the port refused it
    img = avif_lossy_image(128, 96, 900)
    for sub in ("4:4:4", "4:2:2", "4:2:0"):
        tag = sub.replace(":", "")
        for q in (1, 10, 30, 50, 75, 90, 99):
            out[f"avif_lossy_q{q}_{tag}.avif"] = avif_file(img, quality=q, subsampling=sub)
        for w, h in ((1, 1), (33, 1), (1, 9), (7, 5), (66, 3)):
            out[f"avif_lossy_{tag}_{w}x{h}.avif"] = avif_file(smooth(w, h, 902 + w * h), quality=50, subsampling=sub)
    rgba = np.concatenate([img, smooth(128, 96, 901, 1)], axis=-1)
    out["avif_lossy_rgba_420.avif"] = avif_file(rgba, quality=50)
    big = avif_lossy_image(200, 150, 903)
    out["avif_lossy_tiles_2x2_420.avif"] = avif_file(big, quality=60, tile_rows=1, tile_cols=1)
    out["avif_lossy_tiles_1x4_444.avif"] = avif_file(big, quality=60, subsampling="4:4:4", tile_cols=2)
    wide = avif_lossy_image(320, 192, 904)
    for sb in ("64", "128"):
        out[f"avif_lossy_sb{sb}.avif"] = avif_file(wide, quality=70, advanced=[("sb-size", sb)])
    for speed in range(5, 11):
        out[f"avif_lossy_speed{speed}.avif"] = avif_file(img, quality=60, speed=speed)
    for key, value in AVIF_TX_SWITCHES:
        out[f"avif_lossy_{key}_{value}.avif"] = avif_file(img, quality=60, advanced=[(key, value)])
    out["avif_lossy_loopfilter_off.avif"] = avif_file(img, quality=60, advanced=[("loopfilter-control", "0")])
    out["avif_lossy_sharpness_3.avif"] = avif_file(img, quality=60, advanced=[("sharpness", "3")])
    out["avif_lossy_cdef_zero.avif"] = avif_file(smooth(160, 128, 905), quality=85, advanced=[("enable-cdef", "1")])
    out["avif_lossy_speed0_444.avif"] = avif_file(img, quality=60, subsampling="4:4:4", speed=0,
                                                  advanced=[("enable-restoration", "0")])
    return out


def avif_filters() -> dict:
    """Lossy AVIF stills whose frames use CDEF and loop restoration: aom's speeds 0-2 (which search loop
    restoration) with enable-cdef=1. A quality ladder at 4:4:4, 4:2:2 and 4:2:0, speeds 0 and 1, RGBA (the alpha
    item filtered too), the odd sizes of the lossless set, 2x2 and 1x4 tiles, 64x64 and 128x128 superblocks, and
    the two files of the gaps the port once refused (their names from then: CDEF at Pillow's default speed,
    loop restoration at speed 2 without CDEF)."""
    cdef = [("enable-cdef", "1")]
    out = {}
    img = avif_lossy_image(128, 96, 900)
    out["avif_refused_loop_restoration.avif"] = avif_file(avif_lossy_image(200, 150, 903), quality=60, speed=2)
    out["avif_refused_cdef.avif"] = avif_file(img, quality=60, advanced=cdef)
    for sub in ("4:4:4", "4:2:2", "4:2:0"):
        tag = sub.replace(":", "")
        for q in (15, 30, 45, 60, 75):
            out[f"avif_filters_q{q}_{tag}.avif"] = avif_file(img, quality=q, subsampling=sub, speed=2, advanced=cdef)
        for speed in (0, 1):
            out[f"avif_filters_speed{speed}_{tag}.avif"] = avif_file(img, quality=60 if speed else 85,
                                                                     subsampling=sub, speed=speed, advanced=cdef)
        # at quality 10 (30 for 1x9) aom's search finds a CDEF strength at every odd size but 1x1, whose one
        # sample leaves CDEF nothing to smooth
        for w, h in ((1, 1), (33, 1), (1, 9), (7, 5), (66, 3)):
            out[f"avif_filters_{tag}_{w}x{h}.avif"] = avif_file(smooth(w, h, 1902 + w * h), quality=30 if h == 9 else 10,
                                                                subsampling=sub, speed=2, advanced=cdef)
    rgba = np.concatenate([img, smooth(128, 96, 901, 1)], axis=-1)
    out["avif_filters_rgba_420.avif"] = avif_file(rgba, quality=50, speed=1, advanced=cdef)
    big = avif_lossy_image(200, 150, 903)
    out["avif_filters_tiles_2x2_420.avif"] = avif_file(big, quality=60, tile_rows=1, tile_cols=1, speed=0,
                                                       advanced=cdef)
    out["avif_filters_tiles_1x4_444.avif"] = avif_file(big, quality=60, subsampling="4:4:4", tile_cols=2, speed=0,
                                                       advanced=cdef)
    wide = avif_lossy_image(320, 192, 904)
    for sb in ("64", "128"):
        for speed in (0, 2):
            out[f"avif_filters_sb{sb}_speed{speed}.avif"] = avif_file(wide, quality=70, speed=speed,
                                                                      advanced=cdef + [("sb-size", sb)])
    return out


def avif_gaps() -> dict:
    """AVIF stills Pillow reads and the port refuses (UnsupportedCodec, ROADMAP A): an image sequence (save_all,
    the avis brand), an image aom codes with screen content tools, and quantiser matrices."""
    out = {}
    rgb = smooth(45, 37, 800)
    img = avif_lossy_image(128, 96, 900)
    out["avif_refused_qm.avif"] = avif_file(img, quality=60, advanced=[("enable-qm", "1")])
    out["avif_refused_sequence.avif"] = pillow(Image.fromarray(rgb), "AVIF", save_all=True, quality=100,
                                               max_threads=1, append_images=[Image.fromarray(rgb[::-1].copy())])
    # few colours in flat regions: aom's screen content detection turns the tools on
    flat = np.zeros((48, 64, 3), np.uint8)
    flat[:, :32] = (200, 30, 60)
    flat[:24, 32:] = (10, 250, 90)
    flat[30:40, 5:20] = smooth(15, 10, 807)
    out["avif_refused_screen_content.avif"] = avif_file(flat, subsampling="4:2:0")
    return out


def avif_large() -> dict:
    """The maps chip_smoke.py decodes and times: a 512x512 lossless AVIF (4:4:4) of scenes.texture_image, a
    2048x2048 one at Pillow's defaults (quality 75, speed 6, 4:2:0), and the same image at speed 2 with
    enable-cdef=1 (CDEF and loop restoration)."""
    from vk_gltf_renderer_tpu_torch.scenes import texture_image

    tex = texture_image(2048, seed=3)[..., :3]
    return {"avif_map_512_lossless.avif": avif_file(texture_image(512, seed=3)[..., :3], subsampling="4:4:4"),
            "avif_map_2048_lossy.avif": avif_file(tex, quality=75),
            "avif_map_2048_cdef_lr.avif": avif_file(tex, quality=75, speed=2, advanced=[("enable-cdef", "1")])}


def stubs() -> dict:
    """Formats Pillow identifies and cannot load: BUFR, GRIB and HDF5 (no
    handler) and MPEG (no loader)."""
    return {"bufr_refused.bufr": b"BUFR" + bytes(60), "grib_refused.grib": b"GRIB\0\0\0\x01" + bytes(60),
            "hdf5_refused.h5": b"\x89HDF\r\n\x1a\n" + bytes(60),
            "mpeg_refused.mpg": b"\x00\x00\x01\xb3\x01\x40\xf0\x13" + bytes(60)}


def eps() -> dict:
    """EPS: Pillow opens it and needs Ghostscript to load it; without
    Ghostscript both packages refuse it."""
    return {"eps_refused_no_ghostscript.eps": b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 4 4\n%%EndComments\n"
                                              b"0 0 moveto 4 4 lineto stroke\nshowpage\n%%EOF\n"}


def fixtures() -> dict:
    return {**netpbm(), **bmp(), **tga(), **gif(), **tiff(), **libtiff(), **libtiff_lab_zstd_ojpeg(), **jpeg(), **psd(),
            **sgi(), **pcx(), **ico(), **qoi(), **sun(), **png(), **blp(), **ftex(), **xbm(), **xpm(), **msp(), **im(),
            **eps(), **im_repaired(), **blp_cmyk(), **iptc(), **pixar_spider(), **fits(), **mcidas_gbr(), **pcd(),
            **fli(), **xvthumb_imt(), **icns(), **stubs(), **icns_jpeg2000(), **jpeg2000(), **jpeg2000_openjpeg(), **avif(),
            **avif_lossy(), **avif_filters()}


def main():
    digests = {"pillow": Image.__version__, "files": {}, "divergences": {}, "large": {}, "gaps": {}}
    for old in HERE.iterdir():
        if old.suffix in (".bmp", ".dib", ".tga", ".gif", ".tif", ".ppm", ".pgm", ".pbm", ".pfm", ".pam", ".jpg", ".psd",
                          ".sgi", ".rgb", ".bw", ".pcx", ".dcx", ".ico", ".cur", ".qoi", ".ras", ".eps", ".png", ".blp",
                          ".ftc", ".ftu", ".xbm", ".xpm", ".msp", ".im", ".iim", ".pxr", ".spi", ".fits", ".area",
                          ".gbr", ".pcd", ".fli", ".flc", ".xv", ".imt", ".icns", ".bufr", ".grib", ".h5", ".mpg", ".jp2",
                          ".j2k", ".avif"):
            old.unlink()
    # "divergences": files Pillow decodes where the port cannot match it (ROADMAP C); "large": the maps only
    # chip_smoke.py decodes; "gaps": files Pillow decodes in a form the port does not read yet (ROADMAP A)
    for group, files in (("files", fixtures()), ("large", {**jpeg2000_large(), **avif_large()}),
                         ("gaps", avif_gaps())):
        for name, data in files.items():
            (HERE / name).write_bytes(data)
            try:
                rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
                entry = {"shape": list(rgba.shape), "sha256": hashlib.sha256(rgba.tobytes()).hexdigest()}
            except Exception as e:  # noqa: BLE001 - any failure is a refusal, as the texture pool treats it
                entry = {"refused": type(e).__name__}
            digests[group][name] = entry
    (HERE / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")
    # chip_smoke.py's ZSTD maps: one frame of scenes.zstd_strip_pattern, tiled (the card's machine has no
    # zstandard package to write one)
    import zstandard

    from vk_gltf_renderer_tpu_torch.scenes import zstd_strip_pattern

    (HERE / "zstd_strip.zst").write_bytes(zstandard.ZstdCompressor(level=19, write_checksum=True).compress(
        zstd_strip_pattern().tobytes()))


if __name__ == "__main__":
    main()
