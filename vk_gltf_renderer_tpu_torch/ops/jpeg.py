"""JPEG decoding and encoding without an image library.

The JAX package reads JPEG textures and writes JPEG images through Pillow,
which decodes with libjpeg-turbo. This module decodes as libjpeg-turbo
does with its defaults, so that a texture reads the same in both packages:

  * frames: baseline (SOF0), extended 8-bit Huffman (SOF1) and progressive
    (SOF2, spectral selection and successive approximation), their
    arithmetic-coded forms (SOF9, SOF10, with DAC conditioning), and 8-bit
    lossless (SOF3; subsampled components, interleaved or in scans of
    their own, replicated up as libjpeg-turbo upsamples a lossless frame);
    restart intervals; one, three or four components at any integral
    sampling;
  * the entropy decoding of each scan in C++ (native/jpeg_entropy.cpp,
    built at first use); dequantisation, the inverse DCT, upsampling and
    colour conversion vectorised in numpy over all blocks:
      - the accurate integer IDCT (libjpeg's jpeg_idct_islow: 13-bit
        constants, descale by 11 after the columns and by 18 after the
        rows), with the 16-bit wraps and saturations of libjpeg-turbo's
        SIMD version where huge coefficients overflow it,
      - "fancy" triangular chroma upsampling (h2v1, h1v2, h2v2, with the
        image edge replicated), box upsampling otherwise,
      - libjpeg's fixed-point YCbCr -> RGB tables, and libjpeg's guess of
        the colour space (JFIF, Adobe transform, component ids);
  * four components: CMYK (Adobe transform 0, or no Adobe marker) or YCCK
    (any other transform, turned into CMYK as libjpeg does), read inverted
    as Pillow's "CMYK;I" raw mode reads them and turned into RGB by
    Pillow's cmyk2rgb (ops/imagemodes.py);
  * lossless scans convert no colour space, as libjpeg-turbo's: three
    components without JFIF or Adobe markers are RGB, and a file that
    libjpeg-turbo takes for YCbCr or YCCK is refused (ValueError, as
    Pillow's "broken data stream");
  * gray images decode to one channel (the caller repeats it over RGB with
    alpha 1, as Pillow's convert("RGBA") does).

Hierarchical frames (SOF5-7, SOF13-15), lossless arithmetic (SOF11), 12-bit
samples and two-component files raise UnsupportedCodec, as Pillow refuses
them; a truncated file raises ValueError.

encode_jpeg writes what Pillow writes by default: baseline, quality 75
(the IJG tables scaled as libjpeg scales them), 4:2:0 chroma (libjpeg's
biased box downsampling), the Annex K Huffman tables, libjpeg's integer
forward DCT (jfdctint) and fixed-point RGB -> YCbCr. It also writes 4:4:4,
4:2:2 and 4:4:0, and a progressive file of spectral-selection scans (one
DC scan, then one AC scan a component), for tests and the chip check.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .dds import UnsupportedCodec
from .imagemodes import cmyk_to_rgb

JPEG_MAGIC = b"\xff\xd8\xff"

# zigzag position -> natural (row-major) index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,
    7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
    39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

# Annex K quantisation tables, natural order
STD_LUMINANCE_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
STD_CHROMINANCE_QT = np.full(64, 99, np.int64)
STD_CHROMINANCE_QT[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25, 32]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66, 99]

# Annex K Huffman tables: (16 code counts, values)
_AC_LUM_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a"
    "3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a9293"
    "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6"
    "e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROM_VALS = bytes.fromhex(
    "00010203110405213106124151076171132232810814429" "1a1b1c109233352f0156272d10a162434e125f11718191a2627"
    "28292a35363738393a434445464748494a535455565758595a636465666768696a737475767778797a82838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6"
    "e7e8e9eaf2f3f4f5f6f7f8f9fa")
STD_HUFFMAN = {
    "dc_lum": (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    "dc_chrom": (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    "ac_lum": (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), _AC_LUM_VALS),
    "ac_chrom": (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), _AC_CHROM_VALS),
}

# jidctint.c / jfdctint.c fixed-point constants (CONST_BITS 13)
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100, FIX_0_765366865 = 2446, 3196, 4433, 6270
FIX_0_899976223, FIX_1_175875602, FIX_1_501321110, FIX_1_847759065 = 7373, 9633, 12299, 15137
FIX_1_961570560, FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16069, 16819, 20995, 25172

# jdcolor.c / jccolor.c (SCALEBITS 16)
SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


def is_jpeg(data: bytes) -> bool:
    return data[:3] == JPEG_MAGIC


# ------------------------------------------------------------------ native


def _lib():
    from ..native import jpeg_lib

    return jpeg_lib()


def _ptr(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


# ------------------------------------------------------------------ decode


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None  # latched at the component's first scan, as libjpeg latches it
        self.scanned = False
        self.coef = None


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _w16(x):
    """int32 x wrapped to int16, as the SIMD IDCT's 16-bit lanes hold it."""
    return x.astype(np.int16).astype(np.int32)


def _idct_1d(s0, s1, s2, s3, s4, s5, s6, s7, descale):
    """One pass of libjpeg-turbo's SIMD jsimd_idct_islow (jidctint-avx2.asm,
    bit-identical to its SSE2 twin) over int32 arrays holding int16 inputs
    (frequency order): sums of two inputs wrap to 16 bits (paddw), the
    products are pairs summed into 32 bits (pmaddwd), every 32-bit sum
    wraps as int32 arithmetic wraps, the outputs are descaled and saturated
    to int16 (packssdw). Without overflow this is jidctint.c's
    jpeg_idct_islow to the bit."""
    tmp3 = s2 * (FIX_0_541196100 + FIX_0_765366865) + s6 * FIX_0_541196100
    tmp2 = s2 * FIX_0_541196100 + s6 * (FIX_0_541196100 - FIX_1_847759065)
    tmp0 = _w16(s0 + s4) << CONST_BITS
    tmp1 = _w16(s0 - s4) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    z3, z4 = _w16(s7 + s3), _w16(s5 + s1)
    z3, z4 = (z3 * (FIX_1_175875602 - FIX_1_961570560) + z4 * FIX_1_175875602,
              z3 * FIX_1_175875602 + z4 * (FIX_1_175875602 - FIX_0_390180644))
    t0 = s7 * (FIX_0_298631336 - FIX_0_899976223) - s1 * FIX_0_899976223 + z3
    t3 = s1 * (FIX_1_501321110 - FIX_0_899976223) - s7 * FIX_0_899976223 + z4
    t1 = s5 * (FIX_2_053119869 - FIX_2_562915447) - s3 * FIX_2_562915447 + z4
    t2 = s3 * (FIX_3_072711026 - FIX_2_562915447) - s5 * FIX_2_562915447 + z3
    outs = (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)
    rnd = np.int32(1 << (descale - 1))
    return [np.clip((o + rnd) >> descale, -32768, 32767) for o in outs]


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's accurate integer IDCT as Pillow's libjpeg-turbo runs
    it on x86-64 (the SIMD jsimd_idct_islow) over blocks: coef [N, 64]
    natural-order quantised coefficients (int16), qt [64] natural order ->
    uint8 samples [N, 8, 8]. For coefficients that real encoders write it
    is jidctint.c's result; where the products overflow (the huge
    coefficients that an arithmetic decoder reads from the zero data past
    a cut) it keeps the SIMD code's 16-bit dequantisation (pmullw), its
    DC-only column shortcut (a 16-bit shift, taken when rows 1-7 of the
    quantised block are zero), its saturations and its final clamp to
    0..255, where the C code wraps through its range-limit table. The
    blocks run along the last axis ([8, 8, N]), so that each pass reads
    whole planes."""
    raw = coef.T.reshape(8, 8, -1).astype(np.int32)
    d = _w16(raw * qt.reshape(8, 8, 1).astype(np.int32))
    # pass 1: columns (the first axis is the vertical frequency)
    ws = np.stack(_idct_1d(*d, CONST_BITS - PASS1_BITS))
    dc_only = ~raw[1:].any(axis=(0, 1))
    if dc_only.any():
        ws[:, :, dc_only] = _w16(d[0, :, dc_only].T << PASS1_BITS)[None]
    # pass 2: rows
    out = np.empty((8, 8, d.shape[2]), np.uint8)
    for k, r in enumerate(_idct_1d(*(ws[:, j] for j in range(8)), CONST_BITS + PASS1_BITS + 3)):
        out[:, k] = np.clip(r, -128, 127) + 128
    return out.transpose(2, 0, 1)


def _edge(x, axis, step):
    """x shifted by one along axis (step -1: the previous sample, +1: the
    next), the edge sample replicated."""
    n = x.shape[axis]
    idx = np.clip(np.arange(n) + step, 0, n - 1)
    return np.take(x, idx, axis=axis)


def _fancy_h2v1(x):
    x3 = 3 * x
    even = (x3 + _edge(x, 1, -1) + 1) >> 2
    odd = (x3 + _edge(x, 1, 1) + 2) >> 2
    return np.stack([even, odd], axis=2).reshape(x.shape[0], 2 * x.shape[1])


def _fancy_h1v2(x):
    x3 = 3 * x
    upper = (x3 + _edge(x, 0, -1) + 1) >> 2
    lower = (x3 + _edge(x, 0, 1) + 2) >> 2
    return np.stack([upper, lower], axis=1).reshape(2 * x.shape[0], x.shape[1])


def _fancy_h2v2(x):
    x3 = 3 * x
    rows = []
    for near in (_edge(x, 0, -1), _edge(x, 0, 1)):  # the upper, then the lower output row
        c = x3 + near
        c3 = 3 * c
        even = (c3 + _edge(c, 1, -1) + 8) >> 4
        odd = (c3 + _edge(c, 1, 1) + 7) >> 4
        rows.append(np.stack([even, odd], axis=2).reshape(x.shape[0], 2 * x.shape[1]))
    return np.stack(rows, axis=1).reshape(2 * x.shape[0], 2 * x.shape[1])


def _upsample(plane, hr, vr):
    """plane [ch, cw] int32 at the component's own size -> (hr, vr) times
    larger, as libjpeg-turbo's jdsample.c picks the method."""
    if hr == 1 and vr == 1:
        return plane
    cw = plane.shape[1]
    if hr == 2 and vr == 1 and cw > 2:
        return _fancy_h2v1(plane)
    if hr == 1 and vr == 2:
        return _fancy_h1v2(plane)
    if hr == 2 and vr == 2 and cw > 2:
        return _fancy_h2v2(plane)
    return np.repeat(np.repeat(plane, vr, axis=0), hr, axis=1)


# jdcolor.c build_ycc_rgb_table, indexed by the chroma sample 0..255
_X = np.arange(256, dtype=np.int64) - 128
_CR_R = ((_fix(1.40200) * _X + ONE_HALF) >> SCALEBITS).astype(np.int32)
_CB_B = ((_fix(1.77200) * _X + ONE_HALF) >> SCALEBITS).astype(np.int32)
_CR_G = -_fix(0.71414) * _X
_CB_G = -_fix(0.34414) * _X + ONE_HALF
_SAMPLE_LIMIT = np.clip(np.arange(-512, 768), 0, 255).astype(np.uint8)  # the simple range limit, offset 512


def _ycc_to_rgb(y, cb, cr):
    """libjpeg's ycc_rgb_convert over uint8-valued planes."""
    y = y.astype(np.int32) + 512
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = _SAMPLE_LIMIT[y + _CR_R[cr]]
    out[..., 1] = _SAMPLE_LIMIT[y + ((_CB_G[cb] + _CR_G[cr]) >> SCALEBITS).astype(np.int32)]
    out[..., 2] = _SAMPLE_LIMIT[y + _CB_B[cb]]
    return out


def _u16(seg, off):
    if off + 2 > len(seg):
        raise ValueError("JPEG: short marker segment")
    return (seg[off] << 8) | seg[off + 1]


def _scan_ends(arr: np.ndarray) -> np.ndarray:
    """Positions p where arr[p] = 0xFF starts a marker other than RSTn (the
    candidates for the end of an entropy-coded segment)."""
    nxt = arr[1:]
    stuffed_or_rst = (nxt == 0) | ((nxt >= 0xD0) & (nxt <= 0xD7))
    return np.flatnonzero((arr[:-1] == 0xFF) & ~stuffed_or_rst)


def decode_jpeg(data: bytes, color: str | None = None) -> np.ndarray:
    """JPEG bytes -> uint8 [H,W,3] RGB, or [H,W,1] for a gray file. color
    "ycc" or "raw" overrides libjpeg's guess of a three-component file's
    colour space (what libtiff asks of libjpeg for a TIFF's JPEG strips);
    "planes" gives libjpeg's raw data of a DCT file instead: a list of
    (plane, h, v), each component's samples in whole MCU rows and columns,
    not upsampled and not converted (what libtiff's old-style JPEG codec
    reads); "cmyk" takes a four-component file for CMYK whatever its Adobe
    transform says (BLP1's JPEG, which Pillow decodes with the jpeg mode
    "CMYK": no YCCK conversion, the samples still read inverted)."""
    if not is_jpeg(data):
        raise ValueError("not a JPEG file")
    arr = np.frombuffer(data, np.uint8)
    ends = _scan_ends(arr)
    n = len(data)
    qts = {}
    huff_bits = np.zeros((8, 16), np.uint8)
    huff_vals = np.zeros((8, 256), np.uint8)
    present = np.zeros(8, np.uint8)
    comps = None
    width = height = 0
    progressive = arith = lossless = False
    dac_l = np.zeros(4, np.int32)  # the DAC conditioning bounds, libjpeg's defaults
    dac_u = np.ones(4, np.int32)
    dac_k = np.full(4, 5, np.int32)
    planes16 = None
    restart = 0
    jfif = False
    adobe = None
    seen_eoi = False
    pos = 2
    while pos < n:
        if data[pos] != 0xFF:  # garbage between segments: libjpeg skips it
            pos += 1
            continue
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            seen_eoi = True
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        if pos + 2 > n:
            break
        seglen = _u16(data, pos)
        if seglen < 2 or pos + seglen > n:
            raise ValueError("truncated JPEG marker segment")
        seg = data[pos + 2 : pos + seglen]
        pos += seglen
        if marker == 0xDB:  # DQT
            off = 0
            while off < len(seg):
                pq, tq = seg[off] >> 4, seg[off] & 15
                size = 128 if pq else 64
                if off + 1 + size > len(seg) or tq > 3:
                    raise ValueError("bad JPEG DQT segment")
                vals = np.frombuffer(seg[off + 1 : off + 1 + size], ">u2" if pq else np.uint8).astype(np.int64)
                qt = np.zeros(64, np.int64)
                qt[ZIGZAG] = vals
                qts[tq] = qt
                off += 1 + size
        elif marker == 0xC4:  # DHT
            off = 0
            while off < len(seg):
                tc, th = seg[off] >> 4, seg[off] & 15
                if off + 17 > len(seg) or tc > 1 or th > 3:
                    raise ValueError("bad JPEG DHT segment")
                counts = np.frombuffer(seg[off + 1 : off + 17], np.uint8)
                total = int(counts.sum())
                if total > 256 or off + 17 + total > len(seg):
                    raise ValueError("bad JPEG DHT segment")
                t = 4 * tc + th
                huff_bits[t] = counts
                huff_vals[t] = 0
                huff_vals[t, :total] = np.frombuffer(seg[off + 17 : off + 17 + total], np.uint8)
                present[t] = 1
                off += 17 + total
        elif marker == 0xDD:  # DRI
            restart = _u16(seg, 0)
        elif marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
            if comps is not None:
                raise ValueError("JPEG with two frames")
            if len(seg) < 6:
                raise ValueError("bad JPEG SOF segment")
            precision, height, width, nc = seg[0], _u16(seg, 1), _u16(seg, 3), seg[5]
            if precision != 8:
                raise UnsupportedCodec(f"{precision}-bit JPEG samples are not supported")
            if nc not in (1, 3, 4):
                raise UnsupportedCodec(f"JPEG with {nc} components is not supported")
            if height == 0 or width == 0 or len(seg) < 6 + 3 * nc:
                raise ValueError("bad JPEG SOF segment")
            comps = []
            for i in range(nc):
                cid, hv, tq = seg[6 + 3 * i], seg[7 + 3 * i], seg[8 + 3 * i]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                    raise ValueError("bad JPEG sampling factors")
                comps.append(_Component(cid, h, v, tq))
            progressive = marker in (0xC2, 0xCA)
            arith = marker in (0xC9, 0xCA)
            lossless = marker == 0xC3
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            mcux = -(-width // (8 * hmax))
            mcuy = -(-height // (8 * vmax))
            for c in comps:
                c.w = -(-width * c.h // hmax)
                c.hgt = -(-height * c.v // vmax)
                c.cols, c.rows = mcux * c.h, mcuy * c.v
                if not lossless:
                    c.coef = np.zeros((c.rows * c.cols, 64), np.int16)
        elif 0xC5 <= marker <= 0xCF and marker not in (0xC8, 0xC9, 0xCA, 0xCC):
            raise UnsupportedCodec(f"JPEG SOF{marker - 0xC0} (hierarchical, or lossless arithmetic) "
                                   "is not supported")
        elif marker == 0xCC:  # DAC
            for off in range(0, len(seg) - 1, 2):
                tc, tb, val = seg[off] >> 4, seg[off] & 15, seg[off + 1]
                if tb > 3 or tc > 1:
                    raise ValueError("bad JPEG DAC table index")
                if tc == 0:
                    dac_l[tb], dac_u[tb] = val & 15, val >> 4
                    if dac_l[tb] > dac_u[tb]:
                        raise ValueError("bad JPEG DAC value")
                else:
                    if not 1 <= val <= 63:
                        raise ValueError("bad JPEG DAC value")
                    dac_k[tb] = val
        elif marker == 0xE0:
            jfif = jfif or seg[:5] == b"JFIF\x00"
        elif marker == 0xEE:
            if seg[:5] == b"Adobe" and len(seg) >= 12:
                adobe = seg[11]
        elif marker == 0xDA:  # SOS
            if comps is None:
                raise ValueError("JPEG scan before the frame header")
            ns = seg[0] if seg else 0
            if not 1 <= ns <= 4 or len(seg) < 4 + 2 * ns:
                raise ValueError("bad JPEG SOS segment")
            scomps, geom = [], []
            for i in range(ns):
                cs, tables = seg[1 + 2 * i], seg[2 + 2 * i]
                match = [c for c in comps if c.id == cs]
                if not match:
                    raise ValueError("JPEG scan names an unknown component")
                c = match[0]
                c.scanned = True
                if c.qt is None and not lossless:
                    if c.tq not in qts:
                        raise ValueError("JPEG component without a quantisation table")
                    c.qt = qts[c.tq]
                scomps.append(c)
                cols = -(-c.w // 8) if ns == 1 else c.cols
                rows = -(-c.hgt // 8) if ns == 1 else c.rows
                geom.append([c.h, c.v, c.cols, cols, rows, tables >> 4, tables & 15])
            ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            if not progressive and not lossless:
                ss, se = 0, 63
            k = np.searchsorted(ends, pos)
            if k >= len(ends):
                raise ValueError("truncated JPEG: the scan has no end")
            end = int(ends[k])
            entropy = np.ascontiguousarray(arr[pos:end])
            geom_a = np.ascontiguousarray(geom, np.int32)
            if lossless:
                if planes16 is None:
                    planes16 = {c.id: np.zeros((c.hgt, c.w), np.uint16) for c in comps}
                outs = (ctypes.c_void_p * 4)(*[planes16[c.id].ctypes.data for c in scomps])
                lgeom = np.ascontiguousarray([[c.h, c.v, c.w, c.hgt, g[5]] for c, g in zip(scomps, geom)], np.int32)
                rc = _lib().vkgr_jpeg_decode_lossless(
                    _ptr(entropy), len(entropy), ns, outs, _ptr(lgeom), -(-width // hmax), -(-height // vmax),
                    _ptr(huff_bits), _ptr(huff_vals), _ptr(present), 8, ss, ahal & 15, restart)
                if rc == -5:
                    raise ValueError("lossless JPEG restart interval that is not a whole number of MCU rows")
            elif arith:
                ptrs = (ctypes.c_void_p * 4)(*[c.coef.ctypes.data for c in scomps])
                rc = _lib().vkgr_jpeg_decode_scan_arith(
                    _ptr(entropy), len(entropy), ns, ptrs, _ptr(geom_a), mcux, mcuy, _ptr(dac_l), _ptr(dac_u),
                    _ptr(dac_k), ss, se, ahal >> 4, ahal & 15, int(progressive), restart)
            else:
                ptrs = (ctypes.c_void_p * 4)(*[c.coef.ctypes.data for c in scomps])
                rc = _lib().vkgr_jpeg_decode_scan(
                    _ptr(entropy), len(entropy), ns, ptrs, _ptr(geom_a), mcux, mcuy,
                    _ptr(huff_bits), _ptr(huff_vals), _ptr(present), ss, se, ahal >> 4, ahal & 15,
                    int(progressive), restart)
            if rc == -2:
                raise ValueError("JPEG scan uses an undefined Huffman table")
            if rc == -4:
                raise ValueError("bad JPEG Huffman table (over-full, or a DC symbol above 15)")
            if rc != 0:
                raise ValueError(f"bad JPEG scan parameters (rc {rc})")
            pos = end
    if not seen_eoi:
        raise ValueError("truncated JPEG: no end-of-image marker")
    if comps is None:
        raise ValueError("JPEG without a frame header")
    if not all(c.scanned for c in comps):
        raise ValueError("truncated JPEG: a component has no scan")

    if jfif:
        ycc = True
    elif adobe is not None:
        ycc = adobe != 0
    elif len(comps) == 3:
        ycc = [c.id for c in comps] != [82, 71, 66]  # ASCII R, G, B
    else:
        ycc = False
    if lossless:
        # libjpeg-turbo converts no colour space in lossless mode: a file it takes for YCbCr or YCCK is refused
        # (without JFIF or Adobe markers it takes three components for RGB)
        if len(comps) > 1 and (jfif or (adobe is not None and adobe != 0)):
            raise ValueError("lossless JPEG in a colour space libjpeg-turbo cannot convert")
        hmax = max(c.h for c in comps)
        vmax = max(c.v for c in comps)
        if any(hmax % c.h or vmax % c.v for c in comps):
            raise UnsupportedCodec("JPEG with non-integral sampling ratios is not supported")
        # a data unit is one sample, so libjpeg-turbo upsamples by replication (no fancy upsampling)
        planes = [np.repeat(np.repeat((planes16[c.id] & 0xFF).astype(np.uint8), vmax // c.v, axis=0),
                            hmax // c.h, axis=1)[:height, :width] for c in comps]
        if len(comps) == 4:
            return cmyk_to_rgb(255 - np.stack(planes, axis=-1))
        return np.stack(planes, axis=-1)
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    if color == "planes":  # libjpeg's raw data: whole iMCU rows, no upsampling, no colour conversion
        return [(idct_islow(c.coef, c.qt).reshape(c.rows, c.cols, 8, 8).transpose(0, 2, 1, 3)
                 .reshape(c.rows * 8, c.cols * 8).astype(np.uint8), c.h, c.v) for c in comps]
    planes = []
    for c in comps:
        blocks = idct_islow(c.coef, c.qt).reshape(c.rows, c.cols, 8, 8)
        plane = blocks.transpose(0, 2, 1, 3).reshape(c.rows * 8, c.cols * 8)[: c.hgt, : c.w]
        if hmax % c.h or vmax % c.v:
            raise UnsupportedCodec("JPEG with non-integral sampling ratios is not supported")
        up = _upsample(plane.astype(np.int32), hmax // c.h, vmax // c.v)
        planes.append(up[:height, :width])
    if len(comps) == 1:
        return planes[0].astype(np.uint8)[..., None]
    if len(comps) == 4:
        # Adobe transform 0 (or none) is CMYK, anything else YCCK, which libjpeg turns into CMYK; Pillow reads
        # the samples inverted ("CMYK;I") and converts them to RGB with its cmyk2rgb
        if adobe is not None and adobe != 0 and color != "cmyk":
            inv = np.concatenate([_ycc_to_rgb(*planes[:3]), (255 - planes[3]).astype(np.uint8)[..., None]], axis=-1)
        else:
            inv = 255 - np.stack(planes, axis=-1).astype(np.int32)
        return cmyk_to_rgb(inv.astype(np.uint8))
    if color in ("ycc", "raw"):
        ycc = color == "ycc"
    if not ycc:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


# ------------------------------------------------------------------ encode

SAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2), "4:4:0": (1, 2)}


QUALITY = 75  # Pillow's default


def quality_tables(quality: int = QUALITY):
    """libjpeg's jpeg_set_quality: the Annex K tables scaled, clamped to
    1..255 (baseline)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (STD_LUMINANCE_QT, STD_CHROMINANCE_QT))


def _rgb_to_ycc(rgb):
    """jccolor.c rgb_ycc_convert (every sum fits in int32)."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    off = (128 << SCALEBITS) + ONE_HALF - 1
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + ONE_HALF) >> SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.50000) * b + off) >> SCALEBITS
    cr = (_fix(0.50000) * r - _fix(0.41869) * g - _fix(0.08131) * b + off) >> SCALEBITS
    return y, cb, cr


def _downsample(plane, hr, vr):
    """libjpeg's jcsample.c: h2v2 and h2v1 with alternating biases, the
    integral box average (rounded) otherwise."""
    if hr == 1 and vr == 1:
        return plane
    h, w = plane.shape
    if hr == 2 and vr == 2:
        s = plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2] + plane[1::2, 1::2]
        bias = np.where(np.arange(w // 2) % 2 == 0, 1, 2)
        return (s + bias) >> 2
    if hr == 2 and vr == 1:
        bias = np.where(np.arange(w // 2) % 2 == 0, 0, 1)
        return (plane[:, 0::2] + plane[:, 1::2] + bias) >> 1
    n = hr * vr
    s = plane.reshape(h // vr, vr, w // hr, hr).sum(axis=(1, 3))
    return (s + n // 2) // n


def _fdct_1d(d0, d1, d2, d3, d4, d5, d6, d7, even_shift, odd_descale, pass2):
    tmp0, tmp7 = d0 + d7, d0 - d7
    tmp1, tmp6 = d1 + d6, d1 - d6
    tmp2, tmp5 = d2 + d5, d2 - d5
    tmp3, tmp4 = d3 + d4, d3 - d4
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    if pass2:
        o0 = _descale(tmp10 + tmp11, PASS1_BITS)
        o4 = _descale(tmp10 - tmp11, PASS1_BITS)
    else:
        o0 = (tmp10 + tmp11) << even_shift
        o4 = (tmp10 - tmp11) << even_shift
    z1 = (tmp12 + tmp13) * FIX_0_541196100
    o2 = _descale(z1 + tmp13 * FIX_0_765366865, odd_descale)
    o6 = _descale(z1 + tmp12 * -FIX_1_847759065, odd_descale)
    z1 = tmp4 + tmp7
    z2 = tmp5 + tmp6
    z3 = tmp4 + tmp6
    z4 = tmp5 + tmp7
    z5 = (z3 + z4) * FIX_1_175875602
    tmp4 = tmp4 * FIX_0_298631336
    tmp5 = tmp5 * FIX_2_053119869
    tmp6 = tmp6 * FIX_3_072711026
    tmp7 = tmp7 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    o7 = _descale(tmp4 + z1 + z3, odd_descale)
    o5 = _descale(tmp5 + z2 + z4, odd_descale)
    o3 = _descale(tmp6 + z2 + z3, odd_descale)
    o1 = _descale(tmp7 + z1 + z4, odd_descale)
    return o0, o1, o2, o3, o4, o5, o6, o7


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """libjpeg's jpeg_fdct_islow over blocks laid along the last axis: [8,
    8, N] centred samples (row, column) -> [8, 8, N] coefficients (vertical,
    horizontal frequency) scaled up by 8."""
    d = blocks.astype(np.int64)
    ws = np.empty_like(d)
    for k, o in enumerate(_fdct_1d(*(d[:, j] for j in range(8)), PASS1_BITS, CONST_BITS - PASS1_BITS, False)):
        ws[:, k] = o  # pass 1: rows
    out = np.empty_like(d)
    for k, o in enumerate(_fdct_1d(*ws, 0, CONST_BITS + PASS1_BITS, True)):
        out[k] = o  # pass 2: columns
    return out


def _quantize(coef, qt):
    """jcdctmgr.c: round |coef| / (q * 8) half up, keep the sign; [8, 8, N]."""
    q8 = (qt.reshape(8, 8, 1) << 3).astype(np.int64)
    mag = (np.abs(coef) + (q8 >> 1)) // q8
    return np.where(coef < 0, -mag, mag)


def _huff_codes(bits: bytes, vals: bytes):
    """Annex C: (code [256] u16, size [256] u8) of a table."""
    code = np.zeros(256, np.uint16)
    size = np.zeros(256, np.uint8)
    c, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code[vals[k]], size[vals[k]] = c, length
            c += 1
            k += 1
        c <<= 1
    return code, size


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload


def _encode_scan(blocks, comp, tables, ss, se):
    """Entropy-code [n,64] natural-order blocks (native)."""
    dc_code = np.zeros((4, 256), np.uint16)
    dc_size = np.zeros((4, 256), np.uint8)
    ac_code = np.zeros((4, 256), np.uint16)
    ac_size = np.zeros((4, 256), np.uint8)
    for i, (dc, ac) in enumerate(tables):
        dc_code[i], dc_size[i] = _huff_codes(*STD_HUFFMAN[dc])
        ac_code[i], ac_size[i] = _huff_codes(*STD_HUFFMAN[ac])
    blocks = np.ascontiguousarray(blocks, np.int16)
    comp = np.ascontiguousarray(comp, np.int32)
    cap = int(blocks.shape[0]) * 64 * 8 + 1024
    out = np.empty(cap, np.uint8)
    written = np.zeros(1, np.int64)
    rc = _lib().vkgr_jpeg_encode_scan(_ptr(blocks), _ptr(comp), blocks.shape[0], _ptr(dc_code), _ptr(dc_size),
                                      _ptr(ac_code), _ptr(ac_size), ss, se, _ptr(out), cap, _ptr(written))
    if rc != 0:
        raise ValueError(f"JPEG encode failed (rc {rc})")
    return out[: int(written[0])].tobytes()


def component_blocks(planes, samp, qts):
    """Full-size sample planes (int, [H, W] each) with their sampling
    factors and quantisation tables -> each component's quantised blocks
    [rows, cols, 64] (natural order) over the MCU grid: the planes padded by
    edge replication, downsampled as libjpeg does, libjpeg's integer
    forward DCT."""
    height, width = planes[0].shape
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    pad_h, pad_w = mcuy * 8 * vmax - height, mcux * 8 * hmax - width
    out = []
    for plane, (h, v), qt in zip(planes, samp, qts):
        plane = np.pad(plane, ((0, pad_h), (0, pad_w)), mode="edge")
        plane = _downsample(plane, hmax // h, vmax // v)
        rows, cols = plane.shape[0] // 8, plane.shape[1] // 8
        blocks = plane.reshape(rows, 8, cols, 8).transpose(1, 3, 0, 2).reshape(8, 8, rows * cols) - 128
        coef = _quantize(fdct_islow(blocks), qt)
        out.append(coef.reshape(64, rows * cols).T.reshape(rows, cols, 64))
    return out


def encode_jpeg(img: np.ndarray, subsampling: str = "4:2:0", progressive: bool = False) -> bytes:
    """uint8 [H,W,3] RGB (alpha dropped from [H,W,4]) or [H,W] / [H,W,1]
    gray -> JPEG bytes (module docstring)."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 3:
        img = img[..., :3]
    gray = img.ndim == 2
    height, width = img.shape[:2]
    if not (0 < height < 65536 and 0 < width < 65536):
        raise ValueError(f"JPEG cannot hold a {width}x{height} image")
    qlum, qchrom = quality_tables()
    if gray:
        planes, samp, qsel = [img.astype(np.int64)], [(1, 1)], [0]
    else:
        if subsampling not in SAMPLING:
            raise ValueError(f"unknown subsampling {subsampling!r}")
        hl, vl = SAMPLING[subsampling]
        planes, samp, qsel = list(_rgb_to_ycc(img)), [(hl, vl), (1, 1), (1, 1)], [0, 1, 1]
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    comp_blocks = component_blocks(planes, samp, [(qlum, qchrom)[q] for q in qsel])

    def mcu_order(indices):
        """Blocks of the given components in interleaved MCU order."""
        parts, owner = [], []
        for i in indices:
            h, v = samp[i]
            b = comp_blocks[i].reshape(mcuy, v, mcux, h, 64).transpose(0, 2, 1, 3, 4)
            parts.append(b.reshape(mcuy, mcux, v * h, 64))
            owner.append(np.full(v * h, i, np.int32))
        if len(indices) == 1:  # a one-component scan walks its own block grid
            i = indices[0]
            h, v = samp[i]
            cw, ch = -(-width * h // hmax), -(-height * v // vmax)
            b = comp_blocks[i][: -(-ch // 8), : -(-cw // 8)].reshape(-1, 64)
            return b, np.full(b.shape[0], i, np.int32)
        blocks = np.concatenate(parts, axis=2).reshape(-1, 64)
        return blocks, np.tile(np.concatenate(owner), mcuy * mcux)

    ncomp = len(planes)
    tables = [("dc_lum", "ac_lum")] + [("dc_chrom", "ac_chrom")] * (ncomp - 1)
    ids = list(range(1, ncomp + 1))
    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, q in enumerate((qlum, qchrom)[: 1 if gray else 2]):
        out.append(_segment(0xDB, bytes([t]) + bytes(q[ZIGZAG].astype(np.uint8))))
    sof = struct.pack(">BHHB", 8, height, width, ncomp) + b"".join(
        bytes([ids[i], (samp[i][0] << 4) | samp[i][1], qsel[i]]) for i in range(ncomp))
    out.append(_segment(0xC2 if progressive else 0xC0, sof))
    for th, names in enumerate((("dc_lum", "ac_lum"), ("dc_chrom", "ac_chrom"))[: 1 if gray else 2]):
        for cls, name in enumerate(names):  # one table a segment, in libjpeg's order
            bits, vals = STD_HUFFMAN[name]
            out.append(_segment(0xC4, bytes([(cls << 4) | th]) + bits + vals))

    def sos(indices, ss, se):
        head = bytes([len(indices)]) + b"".join(
            bytes([ids[i], (min(i, 1) << 4) | min(i, 1)]) for i in indices) + bytes([ss, se, 0])
        blocks, owner = mcu_order(indices)
        scan_tables = [tables[i] for i in indices]
        local = np.searchsorted(np.asarray(indices), owner).astype(np.int32)
        return _segment(0xDA, head) + _encode_scan(blocks, local, scan_tables, ss, se)

    every = list(range(ncomp))
    if progressive:
        out.append(sos(every, 0, 0))
        for i in every:
            out.append(sos([i], 1, 63))
    else:
        out.append(sos(every, 0, 63))
    out.append(b"\xff\xd9")
    return b"".join(out)
