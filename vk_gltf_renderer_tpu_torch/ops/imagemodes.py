"""Pillow's image modes turned into 8-bit RGBA, as Image.convert("RGBA")
turns them, for the port's readers of BMP, TGA, GIF, TIFF and Netpbm.

Each reader returns a decoded image in the mode that Pillow opens the file
in (its plugins' mode tables), and to_rgba maps it as Pillow's Convert.c
does:

  * "1" is stored as 0/255 (Pillow's own storage), "L" as gray;
  * "I" (32-bit) and "I;16" clip to 0..255: no shift;
  * "F" maps NaN to 0 and truncates after clipping to 0..255;
  * "P" and "PA" look up a palette of up to 256 entries (missing entries
    are black, alpha 255); "PA" takes its alpha from the image;
  * "CMYK" goes through Pillow's cmyk2rgb (k' = 255 - k, c' = k' - c*k'/255
    rounded as MULDIV255), "YCbCr" through its fixed-point ConvertYCbCr.c
    tables (ycbcr_to_rgb);
  * "LAB" (L, a + 128, b + 128 a pixel, Pillow's storage) goes where
    Pillow's convert sends it, LittleCMS's transform from its built-in v2
    Lab profile to its sRGB profile, perceptual intent: lab_to_rgb; the
    alpha is the storage's fourth byte (255 where Pillow's LAB unpacker
    filled it, 0 where the bands were read one by one), or 255 when px
    has three channels;
  * a "transparency" value (an index, a gray value or an RGB triple, or
    per-entry palette alphas) makes the matching pixels' alpha 0; a gray
    or RGB value is compared with the converted 8-bit pixel, as Pillow's
    convert_transparent compares it (a 16-bit value above 255 matches
    nothing, 255 matches every clipped pixel).
"""

from __future__ import annotations

import functools

import numpy as np

from .dds import UnsupportedCodec


def _muldiv255(a, b):
    t = a.astype(np.int32) * b.astype(np.int32) + 128
    return ((t >> 8) + t) >> 8


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's cmyk2rgb over uint8 [..., 4] -> uint8 [..., 3]."""
    nk = 255 - cmyk[..., 3].astype(np.int32)
    out = [np.clip(nk - _muldiv255(cmyk[..., i], nk), 0, 255) for i in range(3)]
    return np.stack(out, axis=-1).astype(np.uint8)


# LittleCMS: the D50 white, the largest XYZ its 16-bit encoding holds, sRGB's primaries and white, Bradford's
# cone matrix, sRGB's tone curve (parametric type 4: gamma, a, b, c, d)
_D50 = (0.9642, 1.0, 0.8249)
_MAX_XYZ = 1.0 + 32767.0 / 32768.0
_SRGB_PRIMARIES = ((0.64, 0.33), (0.30, 0.60), (0.15, 0.06))
_SRGB_WHITE = (0.3127, 0.3290)
_BRADFORD = ((0.8951, 0.2664, -0.1614), (-0.7502, 1.7135, 0.0367), (0.0389, -0.0685, 1.0296))
_SRGB_CURVE = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)
LAB_GRID = 33  # _cmsReasonableGridpointsByColorspace for three channels


def _inv3(a):
    """_cmsMAT3inverse, in its order of operations."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det, (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det, (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det, (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _mul3(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j] for j in range(3)] for i in range(3)]


def _eval3(a, v):
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2] for i in range(3)]


def _xyz_to_srgb_matrix():
    """The matrix stage of LittleCMS's sRGB output pipeline
    (BuildRGBOutputMatrixShaper): the inverse of the D50-adapted RGB to XYZ
    matrix (_cmsBuildRGB2XYZtransferMatrix, _cmsAdaptMatrixToD50), scaled
    by the XYZ encoding's range, all in doubles in LittleCMS's order."""
    (xr, yr), (xg, yg), (xb, yb) = _SRGB_PRIMARIES
    xn, yn = _SRGB_WHITE
    coef = _eval3(_inv3([[xr, xg, xb], [yr, yg, yb], [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]]),
                  [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    m = [[coef[0] * xr, coef[1] * xg, coef[2] * xb], [coef[0] * yr, coef[1] * yg, coef[2] * yb],
         [coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg), coef[2] * (1.0 - xb - yb)]]
    src = _eval3(_BRADFORD, [xn / yn, 1.0, (1 - xn - yn) / yn])
    dst = _eval3(_BRADFORD, list(_D50))
    cone = [[dst[0] / src[0], 0.0, 0.0], [0.0, dst[1] / src[1], 0.0], [0.0, 0.0, dst[2] / src[2]]]
    adapt = _mul3(_inv3(_BRADFORD), _mul3(cone, _BRADFORD))
    return [[v * _MAX_XYZ for v in row] for row in _inv3(_mul3(adapt, m))]


def _saturate_word(d):
    """_cmsQuickSaturateWord: d + 0.5 floored as _cmsQuickFloor floors it
    (to 16 fractional bits first, by adding 1.5 * 2^36), clamped to 0..65535."""
    d = d + 0.5
    magic = 68719476736.0 * 1.5
    fl = np.floor(((d - 32767.0) + magic) - magic) + 32767.0
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, fl)).astype(np.uint16)


@functools.lru_cache(maxsize=1)
def lab_table() -> np.ndarray:
    """The 16-bit table LittleCMS resamples its Lab to sRGB pipeline into
    (OptimizeByResampling): uint16 [33, 33, 33, 3] indexed [L][a][b], each
    node the float pipeline (Lab to XYZ, the sRGB matrix, the inverse sRGB
    curve) at the node's 16-bit input, in float32 where LittleCMS keeps
    float32 and doubles where it computes in doubles."""
    n = LAB_GRID
    q = _saturate_word(np.arange(n) * 65535.0 / (n - 1))  # _cmsQuantizeVal
    g = np.stack(np.meshgrid(q, q, q, indexing="ij"), -1).reshape(-1, 3)
    f = (g.astype(np.float32) / np.float32(65535.0)).astype(np.float64)  # From16ToFloat
    y = (f[:, 0] * 100.0 + 16.0) / 116.0  # EvaluateLab2XYZ, cmsLab2XYZ
    t = (y + 0.002 * (f[:, 1] * 255.0 - 128.0), y, y - 0.005 * (f[:, 2] * 255.0 - 128.0))
    xyz = [(np.where(v <= 24.0 / 116.0, (108.0 / 841.0) * (v - 16.0 / 116.0), v * v * v) * w / _MAX_XYZ)
           .astype(np.float32).astype(np.float64) for v, w in zip(t, _D50)]
    g_, a, b, c, d = _SRGB_CURVE
    disc = (a * d + b) ** g_
    out = []
    for row in _xyz_to_srgb_matrix():  # EvaluateMatrix: a double sum, stored as float32
        r = ((0.0 + xyz[0] * row[0]) + xyz[1] * row[1] + xyz[2] * row[2]).astype(np.float32).astype(np.float64)
        with np.errstate(invalid="ignore"):  # the parametric curve's type -4, in doubles
            v = np.where(r >= disc, (np.power(r, 1.0 / g_) - b) / a, r / c)
        out.append(_saturate_word(v.astype(np.float32).astype(np.float64) * 65535.0))
    return np.ascontiguousarray(np.stack(out, -1).reshape(n, n, n, 3))


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """Pillow's LAB pixels uint8 [..., 3] (L, a + 128, b + 128) -> uint8
    [..., 3] RGB, as Image.convert("RGB") gives them: LittleCMS's
    tetrahedral interpolation in lab_table at each byte times 257, brought
    to 8 bits as LittleCMS does (native/image_coders.cpp vkgr_lab_to_rgb)."""
    from ..native import image_lib

    src = np.ascontiguousarray(lab, np.uint8)
    out = np.empty(src.shape, np.uint8)
    table = lab_table()
    native_rc(image_lib().vkgr_lab_to_rgb(table.ctypes.data, LAB_GRID, src.ctypes.data, src.size // 3,
                                          out.ctypes.data), "LAB conversion")
    return out


def _ycc_table(k: float) -> np.ndarray:
    """One of ConvertYCbCr.c's tables: k * (i - 128) in 1/64ths, + 0.5 and
    truncated toward zero, for i in 0..255."""
    return np.trunc((np.arange(256) - 128) * k * 64 + 0.5).astype(np.int64)


_YCC = {"r_cr": _ycc_table(1.402), "g_cb": _ycc_table(-0.34414), "g_cr": _ycc_table(-0.71414),
        "b_cb": _ycc_table(1.772)}


def ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """Pillow's YCbCr pixels uint8 [..., 3] -> uint8 [..., 3] RGB, as
    Image.convert("RGB") gives them (ImagingConvertYCbCr2RGB: y plus the
    tables' sums shifted right by 6, clipped)."""
    y, cb, cr = (ycc[..., i].astype(np.int64) for i in range(3))
    rgb = (y + (_YCC["r_cr"][cr] >> 6), y + ((_YCC["g_cb"][cb] + _YCC["g_cr"][cr]) >> 6), y + (_YCC["b_cb"][cb] >> 6))
    return np.clip(np.stack(rgb, axis=-1), 0, 255).astype(np.uint8)


def gray_to_u8(mode: str, px: np.ndarray) -> np.ndarray:
    """Modes "1", "L", "I", "I;16", "I;16B" (any width) and "F" -> uint8 gray."""
    if mode == "F":
        f = np.nan_to_num(px.astype(np.float32), nan=0.0, posinf=255.0, neginf=0.0)
        return np.clip(f, 0, 255).astype(np.uint8)
    if mode in ("1", "L"):
        return px.astype(np.uint8)
    return np.clip(px.astype(np.int64), 0, 255).astype(np.uint8)


def palette_rgba(palette) -> np.ndarray:
    """A palette ([n, 3] or [n, 4] uint8, n <= 256, or None) -> [256, 4],
    the missing entries black and opaque."""
    out = np.zeros((256, 4), np.uint8)
    out[:, 3] = 255
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:256]
        out[: len(p), : p.shape[1]] = p
    return out


def to_rgba(mode: str, px: np.ndarray, palette=None, transparency=None) -> np.ndarray:
    """One decoded image in Pillow's `mode` -> uint8 [H, W, 4], as
    Image.convert("RGBA") gives it."""
    h, w = px.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    if mode in ("1", "L", "I", "I;16", "I;16B", "F"):
        g = gray_to_u8(mode, px)
        out[..., :3] = g[..., None]
        out[..., 3] = 255
        if transparency is not None and mode != "F":  # compared with the converted gray (convert_transparent)
            out[..., 3] = np.where(g.astype(np.int64) == int(transparency), 0, 255)
    elif mode == "LA":
        out[..., :3] = px[..., :1]
        out[..., 3] = px[..., 1]
    elif mode in ("P", "PA"):
        pal = palette_rgba(palette)
        if mode == "P" and transparency is not None:
            if isinstance(transparency, (bytes, bytearray)):
                t = np.frombuffer(bytes(transparency[:256]), np.uint8)
                pal[: len(t), 3] = t
            else:
                pal[int(transparency), 3] = 0
        idx = px if mode == "P" else px[..., 0]
        out[:] = pal[idx]
        if mode == "PA":
            out[..., 3] = px[..., 1]
    elif mode == "RGB":
        out[..., :3] = px[..., :3]
        out[..., 3] = 255
        if transparency is not None:
            t = np.asarray(transparency, np.int64)
            out[..., 3] = np.where(np.all(px[..., :3].astype(np.int64) == t, axis=-1), 0, 255)
    elif mode == "RGBA":
        out[:] = px[..., :4]
    elif mode == "CMYK":
        out[..., :3] = cmyk_to_rgb(px)
        out[..., 3] = 255
    elif mode == "YCbCr":
        out[..., :3] = ycbcr_to_rgb(px)
        out[..., 3] = 255
    elif mode == "LAB":  # Pillow copies the storage's fourth byte into alpha (pyCMScopyAux)
        out[..., :3] = lab_to_rgb(px[..., :3])
        out[..., 3] = px[..., 3] if px.shape[-1] > 3 else 255
    else:
        raise UnsupportedCodec(f"image mode {mode} is not supported")
    return out


class PassOn(UnsupportedCodec):
    """A reader's header checks failed the way Image.open lets the next
    plugin try (its _open raised SyntaxError, IndexError, TypeError or
    struct.error): utils/image_io.read_image asks the next reader."""


# Pillow's DecompressionBombError limit: twice Image.MAX_IMAGE_PIXELS
MAX_PIXELS = 2 * 89_478_485


def check_size(what: str, w: int, h: int, need: int = 0, have: int = 0, ratio: int = 0) -> None:
    """Raise ValueError for an image past Pillow's decompression-bomb limit,
    and, with a coder's largest expansion `ratio`, for coded data (`have`
    bytes) too short to fill `need` bytes, before anything is allocated
    (Pillow fails such data as truncated when it loads them)."""
    if w * h > MAX_PIXELS:
        raise ValueError(f"{what}: {w}x{h} pixels is past Pillow's decompression-bomb limit")
    if ratio and need > ratio * have:
        raise ValueError(f"{what}: truncated data")


def native_rc(rc: int, what: str) -> None:
    """Raise ValueError for a native coder's error code."""
    if rc != 0:
        raise ValueError(f"{what}: corrupt or truncated data (rc {rc})")
