"""Writing and reading 8-bit images by file suffix and magic bytes (no
Pillow).

write_image is what the port's front ends write their output through
(GltfRenderer.save_image, headless --output, the viewer's --output,
edit_cli's render), with what Image.fromarray(a).save(path) writes:

  * PNG by utils/png.py; JPEG by ops/jpeg.py (baseline, quality 75,
    4:2:0); WebP by ops/webp.py as a lossless file (Pillow writes lossy at
    quality 80 by default: the port's file is larger and its pixels exact);
  * BMP and DIB (ops/bmp.py), TGA (ops/tga.py), TIFF (ops/tiff.py) and
    Netpbm (ops/netpbm.py) byte for byte as Pillow writes them;
  * GIF (ops/gif.py): the same pixels as Pillow's file for an image of at
    most 256 colours, a median cut of its own above that (ROADMAP C).

An [H,W,1] array is written as [H,W] (Image.fromarray refuses it). Another
suffix raises ValueError("unknown file extension"), as Pillow does.

read_image identifies data the way Image.open does: PNG, BMP, DIB, GIF,
JPEG, Netpbm, TIFF and WebP by their magic bytes, and TGA last, by the
header checks of Pillow's TGA plugin (TGA has no magic). Data that no
reader claims raise UnsupportedCodec (a ValueError), where Image.open
raises UnidentifiedImageError.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops.bmp import decode_bmp, encode_bmp, is_bmp, is_dib
from ..ops.dds import UnsupportedCodec
from ..ops.gif import decode_gif, encode_gif, is_gif
from ..ops.jpeg import decode_jpeg, encode_jpeg, is_jpeg
from ..ops.netpbm import decode_netpbm, encode_netpbm, is_netpbm
from ..ops.tga import decode_tga, encode_tga, is_tga
from ..ops.tiff import decode_tiff, encode_tiff, is_tiff
from ..ops.webp import decode_webp, encode_webp, is_webp
from .png import is_png, read_png, write_png

_ENCODERS = {
    ".jpg": encode_jpeg, ".jpeg": encode_jpeg, ".webp": encode_webp,
    ".bmp": encode_bmp, ".dib": lambda a: encode_bmp(a, file_header=False), ".tga": encode_tga,
    ".tif": encode_tiff, ".tiff": encode_tiff, ".gif": encode_gif,
    ".ppm": encode_netpbm, ".pgm": encode_netpbm, ".pbm": encode_netpbm, ".pnm": encode_netpbm,
}
WRITABLE = (".png", *_ENCODERS)


def check_writable(path) -> None:
    """Raise ValueError, as Pillow's save does, when write_image cannot
    write path's suffix."""
    if Path(path).suffix.lower() not in WRITABLE:
        raise ValueError(f"unknown file extension: {Path(path).suffix}")


def write_image(path, u8: np.ndarray) -> None:
    """Write uint8 [H,W], [H,W,1], [H,W,3] or [H,W,4] by path's suffix."""
    check_writable(path)
    suffix = Path(path).suffix.lower()
    if suffix == ".png":
        write_png(path, u8)
        return
    a = np.asarray(u8, np.uint8)
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    Path(path).write_bytes(_ENCODERS[suffix](a))


def read_image(data: bytes) -> np.ndarray:
    """Image bytes -> uint8 [H,W,C]: PNG, JPEG and WebP as their decoders
    give them (WebP RGBA), the other formats as Pillow's convert("RGBA")."""
    if is_png(data):
        return read_png(data)
    if is_bmp(data):
        return decode_bmp(data)
    if is_dib(data):
        return decode_bmp(data, dib=True)
    if is_gif(data):
        return decode_gif(data)
    if is_jpeg(data):
        return decode_jpeg(data)
    if is_netpbm(data):
        return decode_netpbm(data)
    if is_tiff(data):
        return decode_tiff(data)
    if is_webp(data):
        return decode_webp(data)
    if is_tga(data):
        return decode_tga(data)
    raise UnsupportedCodec("cannot identify image data")
