"""The port's PNG reader (utils/png.py over native/image_coders.cpp's
vkgr_png_unfilter) against the JAX package's decode_image, which reads
through Pillow 12.1.0, bit for bit on the CPU.

- Every bit depth and colour type PNG allows, non-interlaced and Adam7,
  with and without tRNS, from seeded numpy samples written by
  scenes.png_file (Pillow writes neither Adam7 nor 16-bit RGB), every
  scanline filter cycled over the rows.
- Each of the five filters on its own, at 2, 8 and 16 bits.
- A PLTE shorter than the indices used, a tRNS shorter than the PLTE, a
  palette image without PLTE, a gray tRNS that matches no pixel.
- Pillow's own PNGs (1-bit, 2- and 4-bit palettes, I;16, LA, RGB with
  tRNS, optimised and interlaced by Pillow where it can).
- Chunks as Pillow reads them: a bad CRC in IDAT or after it is not read,
  one in IHDR or in an ancillary chunk before IDAT refuses the file;
  APNG's default image; truncated data and an unknown filter refused.
- The unfilter is native: with the coder library missing the read raises
  RuntimeError (no Python path).

Pillow is only a reference here: the port never imports it."""

import io
import struct
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

PIL_Image = pytest.importorskip("PIL.Image")

from vk_gltf_renderer_tpu.ops import textures as jtextures  # noqa: E402
from vk_gltf_renderer_tpu_torch import native, scenes  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import textures as ttextures  # noqa: E402
from vk_gltf_renderer_tpu_torch.utils.png import read_png  # noqa: E402

DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
FORMS = [(c, b) for c, bs in DEPTHS.items() for b in bs]


def _model(data):
    return SimpleNamespace(buffer_views=[{"buffer": 0, "byteOffset": 0, "byteLength": len(data)}],
                           buffers=[data], base_dir=None)


def _same_as_jax(data):
    """The port's texture decode equals the JAX package's bit for bit, and
    so does read_png expanded to RGBA."""
    model = _model(data)
    ref = np.asarray(jtextures.decode_image(model, {"bufferView": 0}))
    got = ttextures.decode_image(model, {"bufferView": 0})
    assert got.shape == ref.shape and np.array_equal(got, ref)
    return ref


def _refused_by_both(data):
    model = _model(data)
    with pytest.raises(Exception):  # noqa: B017 - whatever Pillow raises, the reference's pool catches
        jtextures.decode_image(model, {"bufferView": 0})
    with pytest.raises(ValueError):
        ttextures.decode_image(model, {"bufferView": 0})


def _form(ctype, bits, interlace, trns, h=13, w=19, seed=0):
    rng = np.random.default_rng([ctype, bits, interlace, trns, seed])
    s = rng.integers(0, 1 << bits, (h, w, SAMPLES[ctype]))
    palette = t = None
    if ctype == 3:
        n = max(1, (1 << bits) - 1)  # shorter than the indices used
        palette = rng.integers(0, 256, (n, 3)).astype(np.uint8)
        if trns:
            t = bytes(rng.integers(0, 256, max(1, n - 1)).astype(np.uint8))  # shorter than PLTE
    elif trns and ctype in (0, 2):
        t = b"".join(int(v).to_bytes(2, "big") for v in s[h // 2, w // 3])
        s[(h - 1) // 2, (w - 1) // 2] = s[h // 2, w // 3]
    elif trns:
        t = b"\x00\x01"  # Pillow ignores tRNS for images with alpha
    return scenes.png_file(s, bits, ctype, interlace, palette, t, filters=[0, 1, 2, 3, 4])


@pytest.mark.parametrize("trns", [False, True], ids=["plain", "trns"])
@pytest.mark.parametrize("interlace", [False, True], ids=["progressive", "adam7"])
@pytest.mark.parametrize("ctype,bits", FORMS, ids=[f"type{c}_{b}bit" for c, b in FORMS])
def test_every_form_decodes_as_the_jax_package(ctype, bits, interlace, trns):
    for h, w in ((13, 19), (1, 1), (5, 3), (9, 33)):  # Adam7's empty passes at the small sizes
        _same_as_jax(_form(ctype, bits, interlace, trns, h, w))


@pytest.mark.parametrize("ft", range(5), ids=["none", "sub", "up", "average", "paeth"])
def test_each_filter(ft):
    rng = np.random.default_rng(ft)
    for ctype, bits in ((2, 8), (6, 16), (0, 2), (4, 8)):
        s = rng.integers(0, 1 << bits, (17, 23, SAMPLES[ctype]))
        _same_as_jax(scenes.png_file(s, bits, ctype, filters=ft))
        _same_as_jax(scenes.png_file(s, bits, ctype, interlace=True, filters=ft))


def test_rgb_8bit_returns_its_channels():
    """8-bit gray, gray+alpha, RGB and RGBA without tRNS keep their
    channels (the port's own writers and readers round-trip through
    read_png); every other form comes back RGBA."""
    rng = np.random.default_rng(3)
    for ctype, n in ((0, 1), (4, 2), (2, 3), (6, 4)):
        s = rng.integers(0, 256, (6, 7, n)).astype(np.uint8)
        assert np.array_equal(read_png(scenes.png_file(s, 8, ctype, filters=[1, 4])), s)
    assert read_png(_form(0, 16, False, False)).shape[2] == 4
    assert read_png(_form(2, 8, True, True)).shape[2] == 4


def _chunk(cid, body, crc=None):
    crc = zlib.crc32(cid + body) & 0xFFFFFFFF if crc is None else crc
    return struct.pack(">I", len(body)) + cid + body + struct.pack(">I", crc)


def _palette_png(**kw):
    rng = np.random.default_rng(11)
    return scenes.png_file(rng.integers(0, 16, (9, 11)), 4, 3, **kw)


EDGES = {
    "palette_without_plte": lambda: _palette_png(),
    "plte_of_two_entries": lambda: _palette_png(palette=np.array([[10, 20, 30], [200, 100, 0]], np.uint8)),
    "trns_of_one_entry": lambda: _palette_png(palette=np.arange(48, dtype=np.uint8).reshape(16, 3), trns=b"\x00"),
    "trns_one_transparent_index": lambda: _palette_png(palette=np.arange(48, dtype=np.uint8).reshape(16, 3),
                                                       trns=b"\xff\xff\xff\x00\xff"),
    "gray2_trns_matches_no_scaled_pixel": lambda: scenes.png_file(np.arange(12).reshape(3, 4) % 4, 2, 0, trns=b"\0\1"),
    "gray2_trns_zero": lambda: scenes.png_file(np.arange(12).reshape(3, 4) % 4, 2, 0, trns=b"\0\0"),
    "gray1_trns": lambda: scenes.png_file(np.arange(12).reshape(3, 4) % 2, 1, 0, trns=b"\0\1"),
    "gray16_trns_255": lambda: scenes.png_file(np.array([[0, 255, 256, 70000 % 65536]]), 16, 0, trns=b"\0\xff"),
    "gray16_trns_above_255": lambda: scenes.png_file(np.array([[0, 255, 300, 4000]]), 16, 0, trns=b"\x01\x2c"),
    "rgb16_trns_high_bytes": lambda: scenes.png_file(np.array([[[256, 512, 768], [1, 2, 3]]]), 16, 2,
                                                     trns=b"\0\1\0\2\0\3"),
    "mixed_filters_level9": lambda: scenes.png_file(np.random.default_rng(5).integers(0, 256, (40, 40, 3)), 8, 2,
                                                    filters=[4, 3, 1, 0, 2, 4], level=9),
    "ancillary_chunks_before_idat": lambda: scenes.png_file(np.arange(12).reshape(3, 4), 8, 0, before_idat=_chunk(
        b"tEXt", b"k\0v") + _chunk(b"gAMA", struct.pack(">I", 45455)) + _chunk(b"prVt", b"private")),
}


@pytest.mark.parametrize("case", sorted(EDGES))
def test_edge_cases_decode_as_the_jax_package(case):
    _same_as_jax(EDGES[case]())


def _crc_cases():
    base = _palette_png(palette=np.arange(48, dtype=np.uint8).reshape(16, 3))
    i = base.index(b"IDAT")
    n = struct.unpack(">I", base[i - 4:i])[0]
    j = base.index(b"IEND")
    bad = _chunk(b"tEXt", b"k\0v", crc=0)
    return base, {
        "idat": (base[:i + 4 + n] + b"\0\0\0\0" + base[i + 8 + n:], True),
        "ancillary_after_idat": (base[:j - 4] + bad + base[j - 4:], True),
        "ihdr": (base[:29] + b"\0\0\0\0" + base[33:], False),
        "ancillary_before_idat": (base[:i - 4] + bad + base[i - 4:], False),
    }


@pytest.mark.parametrize("case", ["idat", "ancillary_after_idat", "ihdr", "ancillary_before_idat"])
def test_crc_faults_as_pillow_treats_them(case):
    """Pillow checks the CRC of every chunk before the image data and of
    none after; the port accepts and refuses the same files."""
    base, cases = _crc_cases()
    data, decodes = cases[case]
    if decodes:
        assert np.array_equal(_same_as_jax(data), _same_as_jax(base))
    else:
        _refused_by_both(data)


def test_apng_default_image():
    """An APNG whose IDAT is the first frame (an fcTL before it) and one
    whose IDAT is a default image outside the animation: both read the IDAT
    image, as Pillow does."""
    rng = np.random.default_rng(8)
    s = rng.integers(0, 256, (6, 5, 3)).astype(np.uint8)
    png = scenes.png_file(s, 8, 2)
    i = png.index(b"IDAT") - 4
    actl = _chunk(b"acTL", struct.pack(">II", 2, 0))
    fctl = lambda seq: _chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, 5, 6, 0, 0, 1, 1, 0, 0))  # noqa: E731
    idat_len = struct.unpack(">I", png[i:i + 4])[0]
    second = zlib.compress(b"".join(b"\0" + bytes(15) for _ in range(6)))
    fdat = _chunk(b"fdAT", struct.pack(">I", 2) + second)
    tail = png[i + 12 + idat_len:]
    frame0 = png[:i] + actl + fctl(0) + png[i:i + 12 + idat_len] + fctl(1) + fdat + tail
    default = png[:i] + actl + png[i:i + 12 + idat_len] + fctl(0) + _chunk(b"fdAT", struct.pack(">I", 1) + second) \
        + fctl(2) + fdat + tail
    for data in (frame0, default):
        assert np.array_equal(_same_as_jax(data)[..., :3], s / np.float32(255))


def test_split_idat_and_truncation():
    rng = np.random.default_rng(9)
    s = rng.integers(0, 256, (20, 20, 4)).astype(np.uint8)
    png = scenes.png_file(s, 8, 6, filters=4)
    i = png.index(b"IDAT") - 4
    n = struct.unpack(">I", png[i:i + 4])[0]
    body = png[i + 8:i + 8 + n]
    split = png[:i] + _chunk(b"IDAT", body[:7]) + _chunk(b"IDAT", b"") + _chunk(b"IDAT", body[7:]) + png[i + 12 + n:]
    assert np.array_equal(read_png(split), s)
    _same_as_jax(split)
    _refused_by_both(png[:i] + _chunk(b"IDAT", body[: n // 2]) + png[i + 12 + n:])  # rows missing
    raw = bytearray(zlib.decompress(body))
    raw[0] = 7  # an unknown filter type
    _refused_by_both(png[:i] + _chunk(b"IDAT", zlib.compress(bytes(raw))) + png[i + 12 + n:])
    unknown_depth = bytearray(png)
    unknown_depth[24] = 3
    unknown_depth[29:33] = struct.pack(">I", zlib.crc32(bytes(unknown_depth[12:29])) & 0xFFFFFFFF)
    _refused_by_both(bytes(unknown_depth))


def _pillow(img, **kw):
    b = io.BytesIO()
    img.save(b, "PNG", **kw)
    return b.getvalue()


def _pillow_written():
    rng = np.random.default_rng(12)
    rgb = rng.integers(0, 256, (21, 27, 3), dtype=np.uint8)
    g = rgb[..., 0]
    p = PIL_Image.fromarray(rgb).quantize(13)
    return {
        "1bit": _pillow(PIL_Image.fromarray(g).convert("1")),
        "p_bits2": _pillow(PIL_Image.fromarray(rgb).quantize(4), bits=2),
        "p_bits4_transparency": _pillow(PIL_Image.fromarray(rgb).quantize(13), bits=4, transparency=3),
        "p_alpha_bytes": _pillow(p, transparency=bytes(range(0, 260, 20))),
        "i16": _pillow(PIL_Image.fromarray(g.astype(np.uint16) * 300)),
        "la": _pillow(PIL_Image.fromarray(np.stack([g, g[::-1]], -1), "LA")),
        "rgb_transparency": _pillow(PIL_Image.fromarray(rgb), transparency=tuple(int(v) for v in rgb[3, 4])),
        "l_transparency": _pillow(PIL_Image.fromarray(g), transparency=int(g[2, 2])),
        "rgba_optimize": _pillow(PIL_Image.fromarray(rng.integers(0, 256, (21, 27, 4), dtype=np.uint8)),
                                 optimize=True),
    }


@pytest.mark.parametrize("name", ["1bit", "p_bits2", "p_bits4_transparency", "p_alpha_bytes", "i16", "la",
                                  "rgb_transparency", "l_transparency", "rgba_optimize"])
def test_pillow_written_pngs(name):
    _same_as_jax(_pillow_written()[name])


def test_unfilter_is_native(monkeypatch):
    """With the coder library unavailable, the read raises RuntimeError
    (not one of the decode errors the texture pool makes white): no Python
    path stands in for vkgr_png_unfilter."""
    data = _form(2, 8, False, False)
    native.get_lib()

    def refuse(*args, **kwargs):
        raise OSError("file too short")

    monkeypatch.setattr(native, "_image", None)
    monkeypatch.setattr(native.ctypes, "CDLL", refuse)
    with pytest.raises(RuntimeError, match="image_coders"):
        read_png(data)
