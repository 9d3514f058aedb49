"""Writing and reading 8-bit images by file suffix (no Pillow).

write_image is what the port's front ends write their output through
(GltfRenderer.save_image, headless --output, the viewer's --output,
edit_cli's render): PNG by utils/png.py, JPEG by ops/jpeg.py with what
Pillow writes by default (baseline, quality 75, 4:2:0). Another suffix
raises NotImplementedError (ROADMAP A12, image codecs), where the JAX
package would write it through Pillow. read_image reads PNG or JPEG by
their magic bytes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops.jpeg import decode_jpeg, encode_jpeg, is_jpeg
from .png import is_png, read_png, write_png

WRITABLE = (".png", ".jpg", ".jpeg")


def check_writable(path) -> None:
    """Raise NotImplementedError when write_image cannot write path's suffix."""
    if Path(path).suffix.lower() not in WRITABLE:
        raise NotImplementedError(f"{path}: the port writes PNG and JPEG only (ROADMAP A12, image codecs)")


def write_image(path, u8: np.ndarray) -> None:
    """Write uint8 [H,W], [H,W,1], [H,W,3] or [H,W,4] by path's suffix."""
    check_writable(path)
    if Path(path).suffix.lower() == ".png":
        write_png(path, u8)
    else:
        Path(path).write_bytes(encode_jpeg(u8))


def read_image(data: bytes) -> np.ndarray:
    """PNG or JPEG bytes -> uint8 [H,W,C]; other data raises ValueError."""
    if is_png(data):
        return read_png(data)
    if is_jpeg(data):
        return decode_jpeg(data)
    raise ValueError("not a PNG or JPEG image")
