"""Regenerate the image fixtures of this directory and digests.json.

The files are BMP/DIB, TGA, GIF, TIFF, Netpbm and JPEG forms that the JAX
package reads through Pillow (12.1.0 when they were made) and the port
reads without it: files Pillow writes, and files assembled here from
seeded numpy images for the forms Pillow cannot be asked to write (OS/2
and V4/V5 BMP headers, bit masks, RLE; TGA colour maps and packets across
scan lines; GIF frames off the logical screen, local tables, a full LZW
table; TIFF tiles, planes, big-endian, BigTIFF, predictors, old-style
LZW, JPEG strips with shared tables; arithmetic-coded, lossless and
CMYK/YCCK JPEG through tests/torch_test_helpers.py's encoders). Some are
files Pillow refuses. digests.json holds, for each file, the shape and
sha256 of Pillow's decode (Image.open(f).convert("RGBA") as uint8 bytes),
or that Pillow refuses it, so that the port can be held to Pillow where
Pillow is absent (chip_smoke.py's phase 22); tests/test_torch_images.py
holds it to Pillow itself.

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


def libtiff_only() -> dict:
    """TIFF forms Pillow reads through libtiff's other codecs, which the port
    refuses (ROADMAP C): CCITT Group 4 and an LZMA-compressed strip where
    Pillow's libtiff has them."""
    g = smooth(37, 29, 46, 1)[..., 0]
    out = {}
    for name, img, comp in (("tiff_libtiff_group4.tif", Image.fromarray(g).convert("1"), "group4"),
                            ("tiff_libtiff_lzma.tif", Image.fromarray(g), "lzma"),
                            ("tiff_libtiff_zstd.tif", Image.fromarray(g), "zstd")):
        try:
            out[name] = pillow(img, "TIFF", compression=comp)
        except (OSError, ValueError, KeyError):
            pass
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
    }
    base = jpeg_lossless([rgb[..., 0]])
    i = base.index(b"\xff\xc3")
    out["jpeg_refused_lossless_arith.jpg"] = base[:i] + b"\xff\xcb" + base[i + 2:]
    out["jpeg_refused_hierarchical.jpg"] = base[:i] + b"\xff\xc7" + base[i + 2:]
    out["jpeg_refused_lossless_jfif.jpg"] = jpeg_lossless([rgb[..., c] for c in range(3)], jfif=True)
    twelve = bytearray(pillow(Image.fromarray(rgb), "JPEG"))
    twelve[twelve.index(b"\xff\xc0") + 4] = 12
    out["jpeg_refused_12bit.jpg"] = bytes(twelve)
    return out


def fixtures() -> dict:
    return {**netpbm(), **bmp(), **tga(), **gif(), **tiff(), **jpeg()}


def main():
    digests = {"pillow": Image.__version__, "files": {}, "libtiff_only": {}}
    for old in HERE.iterdir():
        if old.suffix in (".bmp", ".dib", ".tga", ".gif", ".tif", ".ppm", ".pgm", ".pbm", ".pfm", ".pam", ".jpg"):
            old.unlink()
    for group, files in (("files", fixtures()), ("libtiff_only", libtiff_only())):
        for name, data in files.items():
            (HERE / name).write_bytes(data)
            try:
                rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
                entry = {"shape": list(rgba.shape), "sha256": hashlib.sha256(rgba.tobytes()).hexdigest()}
            except Exception as e:  # noqa: BLE001 - any failure is a refusal, as the texture pool treats it
                entry = {"refused": type(e).__name__}
            digests[group][name] = entry
    (HERE / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")


if __name__ == "__main__":
    main()
