"""Apple icon (ICNS) reading without Pillow, as Pillow's IcnsImagePlugin
reads an icon file: "icns" and the file size, then blocks of a type and a
size; the largest (width, height, scale) of IcnsFile.SIZES that has a
block (IcnsFile.bestsize); its entries in SIZES' order: PNG entries
(ic07-ic14, icp4-icp6) through utils/png.py; is32, il32, ih32 and it32
(after its four zero bytes) RGB, raw when the block holds exactly
3 * w * h bytes and else three channels of Apple's RLE
(native/image_coders.cpp vkgr_icns_rle); s8mk, l8mk, h8mk and t8mk the
alpha. A block directory Pillow's open cannot parse passes the data on
(PassOn); a JPEG 2000 entry (a raw codestream or a JP2 file) decodes
through ops/jpeg2000.py, converted to RGBA as Pillow converts it.
"""

from __future__ import annotations

import struct

import numpy as np

from .imagemodes import PassOn, check_size, native_rc

# IcnsFile.SIZES: (width, height, scale) -> [(block type, kind)], kind "png", "rgb", "rgb32t" or "mask"
SIZES = {
    (512, 512, 2): [(b"ic10", "png")], (512, 512, 1): [(b"ic09", "png")],
    (256, 256, 2): [(b"ic14", "png")], (256, 256, 1): [(b"ic08", "png")],
    (128, 128, 2): [(b"ic13", "png")],
    (128, 128, 1): [(b"ic07", "png"), (b"it32", "rgb32t"), (b"t8mk", "mask")],
    (64, 64, 1): [(b"icp6", "png")], (32, 32, 2): [(b"ic12", "png")],
    (48, 48, 1): [(b"ih32", "rgb"), (b"h8mk", "mask")],
    (32, 32, 1): [(b"icp5", "png"), (b"il32", "rgb"), (b"l8mk", "mask")],
    (16, 16, 2): [(b"ic11", "png")],
    (16, 16, 1): [(b"icp4", "png"), (b"is32", "rgb"), (b"s8mk", "mask")],
}
_J2K = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")


def is_icns(data: bytes) -> bool:
    return data[:4] == b"icns"


def _blocks(data: bytes) -> dict:
    """IcnsFile.__init__: block type -> (start, length)."""
    try:
        sig, filesize = struct.unpack_from(">4sI", data, 0)
        if sig != b"icns":
            raise PassOn("not an icns file")
        dct, i = {}, 8
        while i < filesize:
            sig, blocksize = struct.unpack_from(">4sI", data, i)
            if blocksize <= 0:
                raise PassOn("invalid block header")
            i += 8
            dct[sig] = (i, blocksize - 8)
            i += blocksize - 8
    except struct.error as e:
        raise PassOn(f"ICNS: short block header ({e})") from e
    return dct


def _png_or_j2k(data: bytes, start: int, length: int):
    from ..utils.png import read_png

    sig = data[start : start + 12]
    if sig.startswith(b"\x89PNG\r\n\x1a\n"):
        return read_png(data[start:])
    if sig.startswith(_J2K) or sig == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
        from .jpeg2000 import decode_jpeg2000

        try:
            return decode_jpeg2000(data[start : start + length])
        except PassOn as e:  # Pillow opens the entry when it loads the icon: any failure refuses the file
            raise ValueError(f"ICNS: bad JPEG 2000 entry ({e})") from e
    raise ValueError("Unsupported icon subimage format")


def _rgb(data: bytes, start: int, length: int, side: int):
    """read_32: RGB [side, side, 3], raw or RLE."""
    npix = side * side
    if length == npix * 3:
        if start + length > len(data):
            raise ValueError("ICNS: not enough image data")
        return np.frombuffer(data, np.uint8, length, start).reshape(side, side, 3)
    from ..native import image_lib

    src = np.frombuffer(data, np.uint8, max(len(data) - start, 0), min(start, len(data)))
    out = np.empty((3, npix), np.uint8)
    native_rc(image_lib().vkgr_icns_rle(src.ctypes.data, len(src), npix, out.ctypes.data), "ICNS")
    return np.ascontiguousarray(out.T).reshape(side, side, 3)


def read_icns(data: bytes) -> np.ndarray:
    """ICNS bytes -> uint8 [H, W, C] of the largest icon, as Pillow loads it."""
    dct = _blocks(data)
    sizes = [size for size, fmts in SIZES.items() if any(code in dct for code, _ in fmts)]
    if not sizes:
        raise PassOn("No 32bit icon resources found")
    best = max(sizes)
    side = best[0] * best[2]
    check_size("ICNS", side, side)
    channels = {}
    for code, kind in SIZES[best]:
        if code not in dct:
            continue
        start, length = dct[code]
        if kind == "png":
            channels["RGBA"] = _png_or_j2k(data, start, length)
        elif kind == "mask":
            if start + side * side > len(data):
                raise ValueError("ICNS: not enough image data")
            channels["A"] = np.frombuffer(data, np.uint8, side * side, start).reshape(side, side, 1)
        else:
            if kind == "rgb32t":
                if data[start : start + 4] != b"\0\0\0\0":
                    raise ValueError("Unknown signature, expecting 0x00000000")
                start, length = start + 4, length - 4
            channels["RGB"] = _rgb(data, start, length, side)
    img = channels.get("RGBA")
    if img is None:
        img = channels["RGB"]
        if "A" in channels:
            img = np.concatenate([img, channels["A"]], axis=-1)
    h, w = img.shape[:2]
    # IcnsImageFile's size setter: the loaded image's size must be one of the file's sizes at some scale
    if not any((s[1] * s[2]) / h == (s[0] * s[2]) // w for s in sizes):
        raise ValueError("This is not one of the allowed sizes of this image")
    return img


def decode_icns(data: bytes) -> np.ndarray:
    """ICNS bytes -> uint8 [H, W, C]."""
    return read_icns(data)
