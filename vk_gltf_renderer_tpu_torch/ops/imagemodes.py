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
    rounded as MULDIV255);
  * a "transparency" value (an index, a gray value or an RGB triple, or
    per-entry palette alphas) makes the matching pixels' alpha 0.
"""

from __future__ import annotations

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
        if transparency is not None and mode != "F":
            out[..., 3] = np.where(px == transparency, 0, 255)
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
            out[..., 3] = np.where(np.all(px[..., :3] == np.asarray(transparency, px.dtype), axis=-1), 0, 255)
    elif mode == "RGBA":
        out[:] = px[..., :4]
    elif mode == "CMYK":
        out[..., :3] = cmyk_to_rgb(px)
        out[..., 3] = 255
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
