"""Damaged TIFF data as Pillow 12.1.0 (over libtiff) reads it, against the
port's TIFF reader (ops/tiff.py over native/image_coders.cpp), on the CPU.

- A directory entry whose type is set to ASCII, entry by entry, in every
  committed tiff_* fixture: the port's texture decode and the JAX
  package's both fail, or give the same pixels. Pillow's own reader fails
  on an ASCII value where it reads a number (a str there), except the
  planar configuration of uncompressed data and the photometric
  interpretation of old-style JPEG; libtiff, which decodes compressed data,
  skips such a tag ("Incompatible type") and keeps its default, and fails
  the directory where it is a strip or tile array. No TypeError escapes.
- CCITT T.6 and T.4 strips with seeded bits flipped decode as libtiff
  decodes them, in every row libtiff writes: a bad code completes its row
  as CLEANUP_RUNS does and the decoding goes on; libtiff's run arrays are
  never cleared, so a reference read past its row's runs meets an earlier
  row's (cut as libtiff's fill cuts them); a run past the row's end is
  taken back. The rows after the data end (or after a T.6 EOL) are not
  written by libtiff, and are not compared.
- Those rows of a T.4 strip cut short are not in the file: Pillow's rows
  there stay the same whatever the bytes after the cut (ROADMAP C4).

Pillow is only a reference here: the port never imports it."""

import io
import struct
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

PIL_Image = pytest.importorskip("PIL.Image")

from vk_gltf_renderer_tpu.ops import textures as jtextures  # noqa: E402
from vk_gltf_renderer_tpu_torch.native import image_lib  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import textures as ttextures  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops.tiff import CCITT, COMPRESSIONS, _read_ifd, decode_tiff  # noqa: E402
from test_torch_images import _ifd_entries, _strip_cut_short  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "data" / "images"
TIFFS = sorted(p.name for p in FIXTURES.glob("tiff_*.tif"))


def _model(data):
    return SimpleNamespace(buffer_views=[{"buffer": 0, "byteOffset": 0, "byteLength": len(data)}],
                           buffers=[data], base_dir=None)


@pytest.mark.parametrize("name", TIFFS)
def test_ascii_typed_entries_decode_or_fail_as_pillow(name):
    data = (FIXTURES / name).read_bytes()
    bo, _, ents = _ifd_entries(data)
    assert ents
    for i, (e, tag, _, _) in enumerate(ents):
        d = bytearray(data)
        struct.pack_into(bo + "H", d, e + 2, 2)
        model = _model(bytes(d))
        try:
            ref = np.asarray(jtextures.decode_image(model, {"bufferView": 0}))
        except Exception:  # noqa: BLE001 - whatever Pillow raises, the reference's pool makes the texel white
            ref = None
        if ref is None:
            with pytest.raises(ValueError):
                ttextures.decode_image(model, {"bufferView": 0})
            continue
        got = ttextures.decode_image(model, {"bufferView": 0})
        assert got.shape == ref.shape and np.array_equal(got, ref), (name, i, tag)


FAX = sorted(n for n in TIFFS if COMPRESSIONS.get(_read_ifd((FIXTURES / n).read_bytes())[2].get(259, (1,))[0])
             in ("group3", "group4"))


def _rows_written(data):
    """The rows libtiff writes of a one-strip CCITT file: all, or those up to
    the row where the data end (native vkgr_ccitt's count)."""
    _, _, tags, _ = _read_ifd(data)
    off, cnt = tags[273][0], tags[279][0]
    w, h = tags[256][0], tags[257][0]
    src = np.frombuffer(data[off : off + cnt], np.uint8)
    if tags.get(266, (1,))[0] == 2:
        src = np.packbits(np.unpackbits(src).reshape(-1, 8)[:, ::-1].ravel())
    src = np.ascontiguousarray(src)
    out = np.zeros((w + 7) // 8 * h, np.uint8)
    rc = image_lib().vkgr_ccitt(src.ctypes.data, len(src), w, h, CCITT[COMPRESSIONS[tags[259][0]]],
                                int(tags.get(292, (0,))[0]), out.ctypes.data)
    return h if rc == 0 else rc


@pytest.mark.parametrize("name", FAX)
def test_flipped_bits_in_fax_strips_decode_as_libtiff(name):
    """60 seeded single-bit flips in the strip of each T.4 and T.6 fixture."""
    data = (FIXTURES / name).read_bytes()
    _, _, tags, _ = _read_ifd(data)
    off, cnt = tags[273][0], tags[279][0]
    rng = np.random.default_rng(7)
    for k in range(60):
        d = bytearray(data)
        d[off + int(rng.integers(0, cnt - 4))] ^= 1 << int(rng.integers(0, 8))
        d = bytes(d)
        ref = np.asarray(PIL_Image.open(io.BytesIO(d)).convert("L"))
        got = decode_tiff(d)
        got = got[..., 0] if got.ndim == 3 else got
        rows = _rows_written(d)
        assert rows > 0 and np.array_equal(got[:rows], ref[:rows]), (name, k, rows)


@pytest.mark.parametrize("name", [n for n in FAX if COMPRESSIONS[_read_ifd((FIXTURES / n).read_bytes())[2][259][0]]
                                  == "group3"])
def test_t4_rows_past_the_data_end_are_not_in_the_file(name):
    """A T.4 strip cut short (its byte count halved): the port matches
    Pillow through the row where the data end; Pillow's later rows do not
    change when every byte of the file after the cut is changed, so no
    decoder of the file can give them (ROADMAP C4)."""
    data = (FIXTURES / name).read_bytes()
    cut = _strip_cut_short(data)
    _, _, tags, _ = _read_ifd(cut)
    end = tags[273][0] + tags[279][0]
    rows = _rows_written(cut)
    ref = np.asarray(PIL_Image.open(io.BytesIO(cut)).convert("L"))
    got = decode_tiff(cut)
    got = got[..., 0] if got.ndim == 3 else got
    assert 0 < rows < ref.shape[0] and np.array_equal(got[:rows], ref[:rows])
    strip_end = _read_ifd(data)[2][273][0] + _read_ifd(data)[2][279][0]
    scrambled = cut[:end] + bytes(b ^ 0xA5 for b in cut[end:strip_end]) + cut[strip_end:]
    again = np.asarray(PIL_Image.open(io.BytesIO(scrambled)).convert("L"))
    assert np.array_equal(again, ref)
