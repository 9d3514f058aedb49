"""A JPEG 2000 codestream whose packets never reach its highest
resolutions, as Pillow 12.1.0 (OpenJPEG 2.5.4) reads it, against the
port's reader (ops/jpeg2000.py over native/j2k_decode.cpp), on the CPU.

OpenJPEG runs the inverse DWT only up to the highest resolution a packet
reached (its resno_decoded) and hands Pillow that smaller tile, which
Pillow's unpacker reads as if it were the full tile. The samples Pillow
reads from inside OpenJPEG's tile are equal in the port; what it reads
past it is its own buffer, not compared (ROADMAP C2).

Pillow is only a reference here: the port never imports it."""

import io
import struct
from pathlib import Path

import numpy as np
import pytest

PIL_Image = pytest.importorskip("PIL.Image")

from vk_gltf_renderer_tpu_torch.ops.jpeg2000 import _tiles  # noqa: E402
from vk_gltf_renderer_tpu_torch.utils.image_io import read_image  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "data" / "images"


def _capped(data: bytes, top: int) -> bytes:
    """The POC entries' last resolutions cut to `top` (an entry whose first
    resolution lies past it then visits no packet)."""
    i = data.index(b"\xff\x5f")
    length = struct.unpack_from(">H", data, i + 2)[0]
    csiz = struct.unpack_from(">H", data, 40)[0]
    cb = 1 if csiz < 257 else 2
    step = 5 + 2 * cb
    d = bytearray(data)
    for e in range((length - 2) // step):
        at = i + 4 + e * step + 1 + cb + 2
        d[at] = min(d[at], top)
    return bytes(d)


@pytest.mark.parametrize("top", [1, 2, 3])
def test_packets_short_of_the_top_resolution_decode_as_openjpeg(top):
    data = _capped((FIXTURES / "j2k_opj_poc.j2k").read_bytes(), top)
    _, _, tiles = _tiles(data)
    (x0, y0, x1, y1, planes), = tiles
    rh, rw = planes[0].shape
    w, h = x1 - x0, y1 - y0
    assert rw * rh < w * h  # OpenJPEG's tile is the smaller one
    ref = np.asarray(PIL_Image.open(io.BytesIO(data)).convert("RGBA"))
    got = read_image(data)
    # the first component, where Pillow reads it from inside OpenJPEG's tile (row-major, w samples a row)
    inside = (np.arange(h * w) < rw * rh).reshape(h, w)
    assert got.shape[:2] == ref.shape[:2] == (h, w)
    assert np.array_equal(got[..., 0][inside], ref[..., 0][inside])
