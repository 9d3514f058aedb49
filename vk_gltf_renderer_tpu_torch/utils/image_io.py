"""Writing and reading 8-bit images by file suffix (no Pillow).

write_image is what the port's front ends write their output through
(GltfRenderer.save_image, headless --output, the viewer's --output,
edit_cli's render): PNG by utils/png.py, JPEG by ops/jpeg.py with what
Pillow writes by default (baseline, quality 75, 4:2:0), WebP by
ops/webp.py as a lossless file (Pillow writes lossy at quality 80 by
default: the port's file is larger and its pixels exact). Another suffix
raises NotImplementedError (ROADMAP A12: Pillow's other formats), where
the JAX package would write it through Pillow. read_image reads PNG,
JPEG or WebP by their magic bytes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops.jpeg import decode_jpeg, encode_jpeg, is_jpeg
from ..ops.webp import decode_webp, encode_webp, is_webp
from .png import is_png, read_png, write_png

WRITABLE = (".png", ".jpg", ".jpeg", ".webp")


def check_writable(path) -> None:
    """Raise NotImplementedError when write_image cannot write path's suffix."""
    if Path(path).suffix.lower() not in WRITABLE:
        raise NotImplementedError(f"{path}: the port writes PNG, JPEG and WebP only (ROADMAP A12, "
                                  "Pillow's other formats)")


def write_image(path, u8: np.ndarray) -> None:
    """Write uint8 [H,W], [H,W,1], [H,W,3] or [H,W,4] by path's suffix."""
    check_writable(path)
    suffix = Path(path).suffix.lower()
    if suffix == ".png":
        write_png(path, u8)
    elif suffix == ".webp":
        Path(path).write_bytes(encode_webp(u8))
    else:
        Path(path).write_bytes(encode_jpeg(u8))


def read_image(data: bytes) -> np.ndarray:
    """PNG, JPEG or WebP bytes -> uint8 [H,W,C] (WebP: RGBA); other data
    raises ValueError."""
    if is_png(data):
        return read_png(data)
    if is_jpeg(data):
        return decode_jpeg(data)
    if is_webp(data):
        return decode_webp(data)
    raise ValueError("not a PNG, JPEG or WebP image")
