"""The formats Pillow identifies and cannot load: BUFR, GRIB and HDF5 (its
stub plugins, which need a handler the box does not install) and MPEG
(which it opens without a tile). Each claims the data where Pillow's open
accepts them, so that no later reader takes them, and refuses them, as
Pillow's load refuses them (a white texel in both packages).
"""

from __future__ import annotations

from .dds import UnsupportedCodec
from .imagemodes import PassOn


def is_bufr(data: bytes) -> bool:
    return data[:4] in (b"BUFR", b"ZCZC")


def is_grib(data: bytes) -> bool:
    return len(data) >= 8 and data[:4] == b"GRIB" and data[7] == 1


def is_hdf5(data: bytes) -> bool:
    return data[:8] == b"\x89HDF\r\n\x1a\n"


def is_mpeg(data: bytes) -> bool:
    return data[:4] == b"\x00\x00\x01\xb3"


def refuse_stub(name: str):
    def decode(data: bytes):
        raise UnsupportedCodec(f"{name}: Pillow identifies the data and cannot load them")

    return decode


def decode_mpeg(data: bytes):
    """MPEG: Pillow opens a sequence header with a size and has no loader
    for it; one without a size (or cut short) passes on."""
    if len(data) < 7:
        raise PassOn("MPEG: short sequence header")
    bits = int.from_bytes(data[4:7], "big")
    if bits >> 12 == 0 or bits & 0xFFF == 0:
        raise PassOn("MPEG: empty image")
    raise UnsupportedCodec("MPEG: Pillow cannot load this image")
