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

read_image identifies data the way Image.open does, in its order: the
plugins Image.preinit loads (BMP, DIB, GIF, JPEG, PPM, PNG), then Image.ID's
order (AVIF, BLP, BUFR, CUR, PCX, DCX, FITS, FLI, FTEX, GBR, GRIB, HDF5,
JPEG2000, ICNS, ICO, IM, IMT, IPTC, MCIDAS, MPEG, TIFF, MSP, PCD, PIXAR,
PSD, QOI, SGI, SPIDER, SUN, TGA, WEBP, XBM, XPM, XVTHUMB, of those the
port reads), each reader asked when its magic bytes or header checks
accept the data (TGA has no magic: Pillow's TGA header checks; IM, IMT,
IPTC, PCD and SPIDER have no check at all, so every data that reaches
them is parsed as Pillow's open parses it). A reader whose header checks fail the way
Image.open lets the next plugin try (ops/imagemodes.PassOn) passes the
data on; any other failure refuses it, as Image.open raises. BUFR, GRIB,
HDF5 and MPEG are claimed and refused (ops/stubs.py): Pillow identifies
them and cannot load them. Data that no reader claims raise
UnsupportedCodec (a ValueError), where Image.open raises
UnidentifiedImageError. JPEG 2000 (raw codestreams and JP2 files, Part 1)
is read by ops/jpeg2000.py; AVIF stills, lossy and coded lossless, with
the deblocking filter, CDEF and loop restoration, by ops/avif.py. EPS, WMF,
AVIF's other tools (quantiser matrices, segmentation, delta q/lf, superres,
film grain, screen content tools, more than 8 bits), AVIF sequences and
grid items, and JPEG 2000's Part 15 (HT) code-blocks are not ported
(ROADMAP A): such data are refused.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops.avif import decode_avif, is_avif
from ..ops.blp import decode_blp, is_blp
from ..ops.bmp import decode_bmp, encode_bmp, is_bmp, is_dib
from ..ops.dds import UnsupportedCodec
from ..ops.fits import decode_fits, is_fits
from ..ops.fli import decode_fli, is_fli
from ..ops.ftex import decode_ftex, is_ftex
from ..ops.gbr import decode_gbr, is_gbr
from ..ops.gif import decode_gif, encode_gif, is_gif
from ..ops.icns import decode_icns, is_icns
from ..ops.ico import decode_cur, decode_ico, is_cur, is_ico
from ..ops.im import decode_im
from ..ops.imt import decode_imt
from ..ops.iptc import decode_iptc
from ..ops.imagemodes import PassOn
from ..ops.jpeg import decode_jpeg, encode_jpeg, is_jpeg
from ..ops.jpeg2000 import decode_jpeg2000, is_jpeg2000
from ..ops.mcidas import decode_mcidas, is_mcidas
from ..ops.msp import decode_msp, is_msp
from ..ops.netpbm import decode_netpbm, encode_netpbm, is_netpbm
from ..ops.pcd import decode_pcd
from ..ops.pcx import decode_dcx, decode_pcx, is_dcx, is_pcx
from ..ops.pixar import decode_pixar, is_pixar
from ..ops.psd import decode_psd, is_psd
from ..ops.qoi import decode_qoi, is_qoi
from ..ops.sgi import decode_sgi, is_sgi
from ..ops.spider import decode_spider
from ..ops.stubs import decode_mpeg, is_bufr, is_grib, is_hdf5, is_mpeg, refuse_stub
from ..ops.sun import decode_sun, is_sun
from ..ops.tga import decode_tga, encode_tga, is_tga
from ..ops.tiff import decode_tiff, encode_tiff, is_tiff
from ..ops.webp import decode_webp, encode_webp, is_webp
from ..ops.xbm import decode_xbm, is_xbm
from ..ops.xpm import decode_xpm, is_xpm
from ..ops.xvthumb import decode_xvthumb, is_xvthumb
from .png import is_png, read_png, write_png

# Image.open's order: (Pillow's format name, accept, decode)
_ANY = lambda d: True  # noqa: E731 - a plugin Pillow registers without an accept function
READERS = (
    ("BMP", is_bmp, decode_bmp), ("DIB", is_dib, lambda d: decode_bmp(d, dib=True)), ("GIF", is_gif, decode_gif),
    ("JPEG", is_jpeg, decode_jpeg), ("PPM", is_netpbm, decode_netpbm), ("PNG", is_png, read_png),
    ("AVIF", is_avif, decode_avif), ("BLP", is_blp, decode_blp), ("BUFR", is_bufr, refuse_stub("BUFR")),
    ("CUR", is_cur, decode_cur),
    ("PCX", is_pcx, decode_pcx), ("DCX", is_dcx, decode_dcx), ("FITS", is_fits, decode_fits),
    ("FLI", is_fli, decode_fli), ("FTEX", is_ftex, decode_ftex), ("GBR", is_gbr, decode_gbr),
    ("GRIB", is_grib, refuse_stub("GRIB")), ("HDF5", is_hdf5, refuse_stub("HDF5")),
    ("JPEG2000", is_jpeg2000, decode_jpeg2000), ("ICNS", is_icns, decode_icns),
    ("ICO", is_ico, decode_ico), ("IM", _ANY, decode_im), ("IMT", _ANY, decode_imt), ("IPTC", _ANY, decode_iptc),
    ("MCIDAS", is_mcidas, decode_mcidas), ("MPEG", is_mpeg, decode_mpeg), ("TIFF", is_tiff, decode_tiff),
    ("MSP", is_msp, decode_msp), ("PCD", _ANY, decode_pcd), ("PIXAR", is_pixar, decode_pixar),
    ("PSD", is_psd, decode_psd), ("QOI", is_qoi, decode_qoi), ("SGI", is_sgi, decode_sgi),
    ("SPIDER", _ANY, decode_spider), ("SUN", is_sun, decode_sun), ("TGA", is_tga, decode_tga),
    ("WEBP", is_webp, decode_webp), ("XBM", is_xbm, decode_xbm), ("XPM", is_xpm, decode_xpm),
    ("XVThumb", is_xvthumb, decode_xvthumb),
)

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


def identify_and_read(data: bytes) -> tuple:
    """Image bytes -> (Pillow's format name, uint8 [H,W,C]): the first
    reader in Image.open's order that accepts the data and does not pass
    it on (PassOn)."""
    for fmt, accept, decode in READERS:
        if accept(data):
            try:
                return fmt, decode(data)
            except PassOn:
                continue
    raise UnsupportedCodec("cannot identify image data")


def read_image(data: bytes) -> np.ndarray:
    """Image bytes -> uint8 [H,W,C]: PNG, JPEG and WebP as their decoders
    give them (WebP RGBA), AVIF as RGB or RGBA, the other formats as
    Pillow's convert("RGBA")."""
    return identify_and_read(data)[1]
