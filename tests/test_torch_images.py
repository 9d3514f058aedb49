"""The port's image codecs (ops/bmp.py, ops/tga.py, ops/gif.py, ops/tiff.py,
ops/netpbm.py, ops/psd.py, ops/sgi.py, ops/pcx.py, ops/ico.py, ops/qoi.py,
ops/sun.py, ops/blp.py, ops/ftex.py, ops/xbm.py, ops/xpm.py, ops/msp.py,
ops/im.py, ops/iptc.py, ops/pixar.py, ops/spider.py, ops/fits.py,
ops/mcidas.py, ops/gbr.py, ops/pcd.py, ops/fli.py, ops/xvthumb.py,
ops/imt.py, ops/icns.py, ops/stubs.py over native/image_coders.cpp, and
ops/imagemodes.py) against Pillow 12.1.0 and the JAX package, on the CPU.

- Every committed fixture of tests/data/images decodes in the port's
  texture decode_image bit for bit as in the JAX package's (which reads
  through Pillow), and to the digest of Pillow's decode in digests.json;
  where Pillow refuses a file (EPS without Ghostscript among them), both
  packages refuse it, and both texture pools make it 1x1 white. The
  fixtures cover the TIFF forms Pillow reads through libtiff's ZSTD and
  old-style JPEG codecs, CIELab TIFF and Lab PSD, PNG beyond 8-bit gray
  and colour, BLP (CMYK JPEG too), FTEX, XBM, XPM, MSP, IM (YCC, planar
  and bit-decoded types too), IPTC, PIXAR, SPIDER, FITS, McIDAS, GBR,
  PhotoCD, FLI/FLC, XV thumbnails, IM Tools, ICNS (its JPEG 2000 entries
  too) and JPEG 2000 (tests/test_torch_jpeg2000.py has more); BUFR, GRIB,
  HDF5 and MPEG are white in both.
- Every TIFF and JPEG fixture, cut at a quarter, a half and three
  quarters, with a strip cut short, a tag past the end or its EOI
  dropped, and each arithmetic-coded JPEG with restart markers with the
  second half of a scan dropped, is white in both texture decoders or
  decodes to the same pixels (libtiff's and libjpeg's recoveries; a CCITT
  strip up to the row where its data end, that row included).
- Identification follows Image.open, in its order: data that no reader
  claims, TGA headers that fail Pillow's checks, TGA headers that PCX,
  CUR or ICO claim first, data IM's header parser takes or passes on, and
  the magic bytes of BLP, FTEX, MSP, XBM and XPM with headers Pillow's
  open cannot parse are decoded or refused as Pillow does, and the format
  the port names is Pillow's.
- Pillow's mode conversions (convert("RGBA") from 1, L, I, I;16, F, P with
  short palettes and transparency, PA, LA, RGB with transparency, CMYK)
  equal ops/imagemodes.to_rgba on seeded arrays, its LAB to RGB
  (LittleCMS) equals ops/imagemodes.lab_to_rgb on all 2^24 LAB pixels,
  and its YCbCr to RGB ops/imagemodes.ycbcr_to_rgb on all 2^24 YCbCr
  pixels.
- write_image writes BMP, DIB, TGA, TIFF and Netpbm byte for byte as
  Image.fromarray(a).save(path), for every array shape it takes; its GIF
  decodes to Pillow's GIF's pixels for images of at most 256 colours, and
  above that holds the median-cut error measured in ROADMAP C; an unknown
  suffix raises ValueError as Pillow's save does.
- edit_cli's render to an unknown suffix prints Pillow's error and keeps
  the shell alive, as the reference's shell does.
- A glTF whose base colour is BMP, TGA, TIFF, GIF, PPM, PSD, SGI, PCX,
  DCX, ICO, CUR, QOI, Sun raster, subsampled lossless JPEG, an Adam7
  palette PNG, a DXT5 BLP, an old-style JPEG TIFF, FITS, FLC, PhotoCD,
  ICNS or JPEG 2000 (9/7) renders 48x32
  frames that agree with the JAX renderer's at tests/test_torch_frame.py's
  thresholds, and headless --output writes each suffix, read back equal to
  the PNG output.
- No front end hands write_image four channels, so a GIF is never written
  from RGBA there; written from RGBA by hand, the port's GIF keeps the
  colours and drops alpha where Pillow's marks a transparent index
  (ROADMAP C).
- The image coder library that fails to load fails the scene load (no
  white texel in its place).

Pillow is only a reference here: the port never imports it."""

import hashlib
import io
import json
import struct
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

PIL_Image = pytest.importorskip("PIL.Image")

from vk_gltf_renderer_tpu.models import Scene as JScene  # noqa: E402
from vk_gltf_renderer_tpu.ops import textures as jtextures  # noqa: E402
from vk_gltf_renderer_tpu.renderer import GltfRenderer as JaxRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch import headless, native, scenes  # noqa: E402
from vk_gltf_renderer_tpu_torch.models import Scene as TScene  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import gif, textures as ttextures  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops.imagemodes import to_rgba  # noqa: E402
from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch.utils.image_io import WRITABLE, identify_and_read, read_image, write_image  # noqa: E402
from torch_test_helpers import one_torch_thread, share_native_builder  # noqa: E402, F401 (a fixture)

share_native_builder()

FIXTURES = Path(__file__).resolve().parent / "data" / "images"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())


@pytest.fixture(autouse=True)
def _settings_file(tmp_path, monkeypatch):
    """The front ends read and write one settings file of the test's own."""
    monkeypatch.setenv("VKGR_SETTINGS", str(tmp_path / "settings.json"))


def _model(data):
    return SimpleNamespace(buffer_views=[{"buffer": 0, "byteOffset": 0, "byteLength": len(data)}],
                           buffers=[data], base_dir=None)


def _pillow_rgba(data):
    return np.asarray(PIL_Image.open(io.BytesIO(data)).convert("RGBA"))


def _rgba(img):
    """read_image's [H, W, C] as RGBA, as decode_image expands it."""
    if img.shape[2] == 1:
        return np.concatenate([img] * 3 + [np.full_like(img, 255)], axis=-1)
    if img.shape[2] == 2:
        return np.concatenate([img[..., :1]] * 3 + [img[..., 1:]], axis=-1)
    if img.shape[2] == 3:
        return np.concatenate([img, np.full_like(img[..., :1], 255)], axis=-1)
    return img


# ------------------------------------------------------------ the committed fixtures


@pytest.mark.parametrize("name", sorted(DIGESTS["files"]))
def test_fixture_decodes_as_the_jax_package(name):
    data = (FIXTURES / name).read_bytes()
    entry = DIGESTS["files"][name]
    model = _model(data)
    if "refused" in entry:
        with pytest.raises(Exception):  # noqa: B017 - whatever Pillow raises, the reference's pool catches
            jtextures.decode_image(model, {"bufferView": 0})
        with pytest.raises(ValueError):
            ttextures.decode_image(model, {"bufferView": 0})
        return
    ref = np.asarray(jtextures.decode_image(model, {"bufferView": 0}))
    got = ttextures.decode_image(model, {"bufferView": 0})
    assert got.shape == ref.shape and np.array_equal(got, ref)
    rgba = np.ascontiguousarray(_rgba(read_image(data)))
    assert list(rgba.shape) == entry["shape"] and hashlib.sha256(rgba.tobytes()).hexdigest() == entry["sha256"]


@pytest.mark.parametrize("fmt", ["bmp", "tga", "gif", "tiff", "ppm", "psd", "sgi", "pcx", "ico", "cur", "qoi", "sun",
                                 "eps", "png", "blp", "ftex", "xbm", "xpm", "msp", "im", "iptc", "pixar", "spider",
                                 "fits", "mcidas", "gbr", "pcd", "fli", "xvthumb", "imt", "icns", "bufr", "grib", "hdf5",
                                 "mpeg", "j2k"])
def test_refused_fixtures_load_white_in_both_packages(fmt, tmp_path):
    names = sorted(n for n, e in DIGESTS["files"].items() if n.startswith(fmt + "_") and "refused" in e)
    assert names
    for name in names:
        path = scenes.helmet_with_texture(str(tmp_path), (FIXTURES / name).read_bytes(), name)
        for Scene, build in ((JScene, jtextures.build_texture_pool), (TScene, ttextures.build_texture_pool)):
            sc = Scene()
            sc.load(path)
            quads, desc, _, num_mips = build(sc.model)
            assert np.asarray(desc).tolist() == [[0, 1, 1, 0]] and np.asarray(num_mips).tolist() == [1], name
            assert np.array_equal(np.asarray(quads), np.ones((1, 16), np.float32)), name


def _tga_header(itype, depth, cmap_type=0, w=4, h=3, map_depth=24):
    return bytes([0, cmap_type, itype, 0, 0, 4 if cmap_type else 0, 0, map_depth if cmap_type else 0, 0, 0, 0,
                  0, w, 0, h, 0, depth, 0])


IDENTIFY = {
    "random": bytes(np.random.default_rng(1).integers(0, 256, 300, dtype=np.uint8)),
    "empty": b"",
    "text": b"hello, this is not an image at all\n" * 4,
    "tga_bad_colormap_type": _tga_header(2, 24, cmap_type=2) + bytes(36),
    "tga_bad_depth": _tga_header(2, 12) + bytes(36),
    "tga_unknown_type": _tga_header(5, 24) + bytes(36),
    "tga_zero_width": _tga_header(2, 24, w=0) + bytes(36),
    "tga_plain": _tga_header(2, 24) + bytes(range(36)),
    "tga_type3_depth16": _tga_header(3, 16) + bytes(range(24)),
    "tga_type1_cmap16": _tga_header(1, 8, cmap_type=1, map_depth=16) + bytes(range(8)) + bytes(12),
    "dib_header": (40).to_bytes(4, "little") + (2).to_bytes(4, "little") + (2).to_bytes(4, "little")
                  + (1).to_bytes(2, "little") + (24).to_bytes(2, "little") + bytes(24) + bytes(16),
    "netpbm_p7": b"P7\n4 4\n",
    "gif_no_image": b"GIF89a" + bytes([2, 0, 2, 0, 0, 0, 0]) + b";",
    "tiff_short": b"II*\x00\x08\x00",
    # TGA headers that Pillow's PCX, CUR and ICO plugins accept first (Image.ID's order)
    "tga_id_length_10_pcx_unknown_mode": bytes([10]) + _tga_header(2, 24)[1:] + bytes(10) + bytes(range(36)),
    "tga_type2_cur_no_entries": _tga_header(2, 24) + bytes(range(36)),
    "tga_type2_cur_entries_cut_short": bytes([0, 0, 2, 0, 0, 3]) + _tga_header(2, 24, w=2, h=2)[6:] + bytes(12),
    "tga_type2_cur_entry_not_a_dib": bytes([0, 0, 2, 0, 0, 1]) + _tga_header(2, 24, w=4, h=3)[6:] + bytes(range(36)),
    "tga_type1_ico_no_entries": _tga_header(1, 8) + bytes(range(12)),
    "tga_type1_ico_entry_cut_short": bytes([0, 0, 1, 0, 2, 0]) + _tga_header(1, 8, w=2, h=2)[6:] + bytes(4),
    "pcx_empty_size": bytes([10, 5, 1, 8]) + struct.pack("<4H", 5, 5, 4, 4) + bytes(120),
    "pcx_short_header": bytes([10, 5, 1, 8, 0, 0]),
    "dcx_no_pages": (987654321).to_bytes(4, "little") + bytes(8),
    "psd_version_2": b"8BPS\x00\x02" + bytes(40),
    "qoi_short_header": b"qoif\x00\x00",
    "sun_depth_16": (0x59A66A95).to_bytes(4, "big") + struct.pack(">7I", 2, 2, 16, 8, 1, 0, 0) + bytes(8),
    "sgi_short_header": (474).to_bytes(2, "big") + bytes(20),
    "eps_header": b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 2 2\n",
    "blp_short_header": b"BLP2\x01\x00\x00\x00\x02",
    "blp1_zero_width": b"BLP1" + struct.pack("<iIIIiI", 1, 0, 0, 4, 5, 0) + bytes(200),
    "ftex_short_header": b"FTEX" + struct.pack("<3i", 1, 4, 4),
    "ftex_zero_height": b"FTEX" + struct.pack("<5i", 1, 4, 0, 1, 1) + struct.pack("<3i", 1, 32, 0),
    "msp_short": b"DanM" + bytes(10),
    "msp_bad_checksum": b"LinS" + struct.pack("<14H", 4, 4, 1, 1, 1, 1, 4, 4, 0, 0, 7, 0, 0, 0) + bytes(16),
    "xbm_no_bits_line": b"#define a_width 8\n#define a_height 2\nstatic char a[] = { 0x01, 0x02 };\n",
    "xbm_ten_spaces_first": b" " * 10 + b"#define a_width 8\n#define a_height 1\nstatic char a_bits[] = { 0x01 };\n",
    "xpm_no_header_line": b"/* XPM */\nstatic char *x[] = {\n};\n",
    "xpm_empty_field": b'/* XPM */\n"2  1 1",\n". c #000000",\n"..",\n',
    "im_header": b"Image type: L image\r\nImage size (x*y): 2*2\r\n\x00\x1a" + bytes(range(4)),
    "im_no_known_key": b"Foo: bar\n\x1a" + bytes(4),
    "im_line_over_100": b"Comment: " + b"x" * 120 + b"\n\x1a" + bytes(4),
    "im_no_ctrl_z": b"Image type: L image\nImage size (x*y): 2*2\n\x00" + bytes(8),
    "im_size_one_number": b"Image size (x*y): 4\n\x1a" + bytes(16),
    "im_lut_cut_short": b"Image type: L image\nImage size (x*y): 2*2\nLut: 1\n\x1a" + bytes(100),
    "im_colon_in_binary": b"A:\x80\x81\n\x00" + bytes(8),
    # the readers Pillow registers without a magic check (IMT, IPTC, PCD, SPIDER) and the loose GBR accept: data
    # their open cannot parse pass on, as Pillow's do
    "gbr_loose_accept_zero_width": struct.pack(">5I", 28, 2, 0, 4, 1) + b"GIMP" + bytes(40),
    "gbr_loose_accept_depth_3": struct.pack(">5I", 20, 1, 4, 4, 3) + bytes(48),
    "gbr_v2_no_magic": struct.pack(">5I", 28, 2, 4, 4, 1) + b"PMIG" + bytes(40),
    "spider_floats_not_a_header": np.arange(27, dtype=">f4").tobytes() + bytes(64),
    "spider_header_not_2d": np.array([1, 2, 2, 0, 3, 0, 0, 0, 0, 0, 0, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 8, 8, 0, 0, 0, 0],
                                     ">f4").tobytes() + bytes(64),
    "imt_text_no_fields": b"hello\nworld\n" + bytes(20),
    "imt_width_without_pixel": b"width 4\nheight 2\n\x0c" + bytes(8),
    "iptc_bad_record": bytes([0x1C, 10, 5, 0, 2]) + bytes(10),
    "iptc_no_layers": bytes([0x1C, 3, 20, 0, 2, 0, 4]) + bytes([0x1C, 8, 10, 0, 4]) + bytes(4),
    "pcd_no_magic": bytes(4000),
    "fli_reserved_bytes_set": struct.pack("<IHHHHHHI", 200, 0xAF12, 1, 4, 4, 8, 3, 5) + b"\x01" * 108 + bytes(72),
    "xvthumb_eof_in_comments": b"P7 332\n#only a comment\n",
    "fits_value_not_t": b"SIMPLE  =                    F".ljust(80) + bytes(2800),
    "mcidas_short_directory": b"\x00\x00\x00\x00\x00\x00\x00\x04" + bytes(100),
    "pixar_other_layout": b"\x80\xe8\x00\x00" + bytes(412) + struct.pack("<HHHHHH", 4, 4, 0, 0, 14, 3) + bytes(700),
    "icns_bad_block_size": b"icns" + struct.pack(">I", 40) + b"is32" + struct.pack(">I", 0) + bytes(24),
    "mpeg_zero_size": b"\x00\x00\x01\xb3\x00\x00\x00" + bytes(20),
    # sizes refused before anything is allocated: past Pillow's decompression-bomb limit, or coded data too short
    "qoi_past_bomb_limit": b"qoif" + struct.pack(">IIBB", 20000, 20000, 4, 0) + bytes(10),
    "sun_rle_past_bomb_limit": (0x59A66A95).to_bytes(4, "big") + struct.pack(">7I", 30000, 30000, 8, 8, 2, 0, 0)
                               + bytes(8),
    "pcx_rle_data_too_short": bytes([10, 5, 1, 8]) + struct.pack("<4H", 0, 0, 3999, 3999) + bytes(53) + bytes([3])
                              + struct.pack("<H", 4000) + bytes(58) + bytes(10),
}


@pytest.mark.parametrize("case", sorted(IDENTIFY))
def test_identification_follows_image_open(case):
    """Data claimed by no reader, or a TGA header that fails Pillow's
    checks, is refused by both; data that passes decodes alike."""
    data = IDENTIFY[case]
    try:
        ref = _pillow_rgba(data)
    except Exception:  # noqa: BLE001 - any refusal
        ref = None
    if ref is None:
        with pytest.raises(ValueError):
            read_image(data)
    else:
        assert np.array_equal(_rgba(read_image(data)), ref)


def _pillow_format(data):
    try:
        return PIL_Image.open(io.BytesIO(data)).format
    except Exception:  # noqa: BLE001 - any refusal
        return None


@pytest.mark.parametrize("name", sorted(DIGESTS["files"]) + sorted(IDENTIFY))
def test_read_image_names_pillows_format(name):
    """Where the port decodes the data, the format it names is the one
    Image.open names; where the port refuses the data, Pillow's open or
    load refuses it too."""
    data = IDENTIFY[name] if name in IDENTIFY else (FIXTURES / name).read_bytes()
    fmt = _pillow_format(data)
    try:
        got, _ = identify_and_read(data)
    except ValueError:
        try:
            _pillow_rgba(data)
        except Exception:  # noqa: BLE001 - any refusal
            return
        raise AssertionError(f"{name}: the port refuses data that Pillow reads as {fmt}")
    assert got == fmt, (name, got, fmt)


def test_no_pcx_cur_or_ico_data_decodes_as_tga():
    """Every fixture and identification case whose first bytes PCX, CUR or
    ICO accept is read by that reader or refused, never by the TGA reader,
    unless Pillow passes it on to TGA too."""
    from vk_gltf_renderer_tpu_torch.ops.ico import is_cur, is_ico
    from vk_gltf_renderer_tpu_torch.ops.pcx import is_pcx

    cases = {n: (FIXTURES / n).read_bytes() for n in DIGESTS["files"]} | IDENTIFY
    claimed = {n: d for n, d in cases.items() if is_pcx(d) or is_cur(d) or is_ico(d)}
    assert len(claimed) > 20
    for name, data in claimed.items():
        try:
            fmt, _ = identify_and_read(data)
        except ValueError:
            continue
        assert fmt != "TGA" or _pillow_format(data) == "TGA", name


# ------------------------------------------------------------ Pillow's modes


def _img(mode, arr):
    return PIL_Image.frombuffer(mode, arr.shape[1::-1], np.ascontiguousarray(arr).tobytes(), "raw", mode, 0, 1)


MODE_CASES = ["1", "L", "L_trns", "I", "I;16", "F", "P_short", "P_trns_int", "P_trns_bytes", "PA", "LA",
              "RGB_trns", "CMYK"]


@pytest.mark.parametrize("case", MODE_CASES)
def test_mode_conversions_match_pillow(case):
    rng = np.random.default_rng(MODE_CASES.index(case))
    h, w = 7, 11
    mode = case.split("_")[0]
    palette, trns = None, None
    if mode == "1":
        px = rng.integers(0, 2, (h, w)).astype(np.uint8) * 255
        im = PIL_Image.fromarray(px).convert("1")
    elif mode == "I":
        px = rng.integers(-300, 70000, (h, w)).astype(np.int32)
        im = PIL_Image.frombuffer("I", (w, h), px.tobytes(), "raw", "I", 0, 1)
    elif mode == "I;16":
        px = rng.integers(0, 65536, (h, w)).astype(np.uint16)
        im = PIL_Image.frombuffer("I;16", (w, h), px.tobytes(), "raw", "I;16", 0, 1)
    elif mode == "F":
        px = (rng.normal(100, 120, (h, w))).astype(np.float32)
        px[0, :4] = [np.nan, np.inf, -np.inf, 254.99]
        im = PIL_Image.frombuffer("F", (w, h), px.tobytes(), "raw", "F", 0, 1)
    elif mode in ("L", "LA", "PA", "P", "CMYK", "RGB"):
        bands = {"L": 1, "LA": 2, "PA": 2, "P": 1, "CMYK": 4, "RGB": 3}[mode]
        px = rng.integers(0, 256, (h, w, bands) if bands > 1 else (h, w), dtype=np.uint8)
        if mode == "P":
            px = px % 12
        im = _img(mode, px)
        if mode in ("P", "PA"):
            palette = rng.integers(0, 256, (9, 3), dtype=np.uint8)
            im.putpalette(palette.reshape(-1).tolist())
        if case == "L_trns":
            trns = int(px[0, 0])
        elif case == "P_trns_int":
            trns = 3
        elif case == "P_trns_bytes":
            trns = bytes(rng.integers(0, 256, 7, dtype=np.uint8))
        elif case == "RGB_trns":
            trns = tuple(int(v) for v in px[1, 2])
            px[4, 5] = px[1, 2]
            im = _img(mode, px)
        if trns is not None:
            im.info["transparency"] = trns
    ref = np.asarray(im.convert("RGBA"))
    assert np.array_equal(to_rgba(mode, px if mode != "1" else np.asarray(im, np.uint8) * 255, palette, trns), ref)


def test_ycbcr_conversion_matches_pillow_on_every_pixel():
    """All 2^24 YCbCr pixels in one 4096x4096 image: Pillow's
    convert("RGB") (ConvertYCbCr.c's fixed-point tables) and
    ops/imagemodes.ycbcr_to_rgb agree bit for bit."""
    from vk_gltf_renderer_tpu_torch.ops.imagemodes import ycbcr_to_rgb

    v = np.arange(1 << 24, dtype=np.uint32)
    raw = np.stack([v >> 16, (v >> 8) & 255, v & 255], axis=-1).astype(np.uint8)
    del v
    ref = np.asarray(PIL_Image.frombytes("YCbCr", (4096, 4096), raw.tobytes()).convert("RGB")).reshape(-1, 3)
    got = ycbcr_to_rgb(raw)
    assert got.shape == ref.shape and np.array_equal(got, ref)


def test_photo_ycc_matches_pillow():
    """A PhotoCD base image of random luma and chroma: Pillow's PhotoYCC
    unpacker and ops/pcd.py agree on every pixel (the fixtures' planes are
    smooth)."""
    rng = np.random.default_rng(23)
    data = scenes.pcd_file(rng.integers(0, 256, (512, 768), dtype=np.uint8),
                           rng.integers(0, 256, (256, 384), dtype=np.uint8),
                           rng.integers(0, 256, (256, 384), dtype=np.uint8))
    assert np.array_equal(_rgba(read_image(data)), _pillow_rgba(data))


def test_icns_jpeg2000_entry_is_an_open_divergence():
    """ICNS icons whose only entry is JPEG 2000 (a JP2 file as ic11, a raw
    codestream with alpha as ic07): Pillow (built with OpenJPEG) decodes
    each to its digest, and so does the port (ops/jpeg2000.py); no fixture
    is left under digests.json's "divergences" that the port does not
    read."""
    names = sorted(n for n in DIGESTS["files"] if n.startswith("icns_jpeg2000"))
    assert len(names) == 2 and not DIGESTS["divergences"]
    for name in names:
        data = (FIXTURES / name).read_bytes()
        entry = DIGESTS["files"][name]
        ref = _pillow_rgba(data)
        assert list(ref.shape) == entry["shape"] and hashlib.sha256(ref.tobytes()).hexdigest() == entry["sha256"]
        fmt, got = identify_and_read(data)
        assert fmt == "ICNS" and np.array_equal(_rgba(got), ref), name


# ------------------------------------------------------------ damaged TIFF and JPEG data


def _ifd_entries(data):
    """(entry position, tag, type, count) of a TIFF's first directory, and its byte order and BigTIFF flag."""
    bo = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"\x2b\x00", b"\x00\x2b")
    off = struct.unpack_from(bo + ("Q" if big else "I"), data, 8 if big else 4)[0]
    n = struct.unpack_from(bo + ("Q" if big else "H"), data, off)[0]
    ent, size = off + (8 if big else 2), 20 if big else 12
    return bo, big, [(ent + i * size, *struct.unpack_from(bo + "HH", data, ent + i * size),
                      struct.unpack_from(bo + ("Q" if big else "I"), data, ent + i * size + 4)[0]) for i in range(n)]


_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}


def _strip_cut_short(data):
    """The first StripByteCounts (or TileByteCounts) value halved."""
    bo, big, ents = _ifd_entries(data)
    for e, tag, typ, count in ents:
        if tag in (279, 325) and typ in (3, 4, 16):
            fmt = bo + {3: "H", 4: "I", 16: "Q"}[typ]
            at = e + (12 if big else 8)
            if _TYPE_SIZE[typ] * count > (8 if big else 4):
                at = struct.unpack_from(bo + ("Q" if big else "I"), data, at)[0]
            out = bytearray(data)
            struct.pack_into(fmt, out, at, struct.unpack_from(fmt, data, at)[0] // 2)
            return bytes(out)
    return None


def _tag_past_end(data):
    """The count of the directory's last out-of-line tag grown so that its values run past the end of the file."""
    bo, big, ents = _ifd_entries(data)
    last = [(e, typ, count) for e, tag, typ, count in ents
            if _TYPE_SIZE.get(typ) and _TYPE_SIZE[typ] * count > (8 if big else 4)]
    if not last:
        return None
    e, typ, count = last[-1]
    out = bytearray(data)
    struct.pack_into(bo + ("Q" if big else "I"), out, e + 4, count + len(data) // _TYPE_SIZE[typ] + 1)
    return bytes(out)


def _scans(data):
    """(start, end) of each JPEG scan's entropy-coded data."""
    out, i = [], 2
    while i + 4 <= len(data):
        if data[i] != 0xFF or data[i + 1] in (0xD8, 0xD9):
            break
        length = (data[i + 2] << 8) | data[i + 3]
        if data[i + 1] != 0xDA:
            i += 2 + length
            continue
        start = end = i + 2 + length
        while end + 1 < len(data) and not (data[end] == 0xFF and data[end + 1] != 0 and not 0xD0 <= data[end + 1] <= 0xD7):
            end += 1
        out.append((start, end))
        i = end
    return out


def _mutations(name, data):
    """A fixed set of damaged copies: the file cut at 1/4, 1/2 and 3/4; a
    TIFF's strip cut short and a tag whose values run past the end; a
    JPEG's end-of-image marker dropped; for an arithmetic-coded JPEG with
    restart markers, each scan with the second half of its data dropped
    (the markers after it kept: libjpeg's resync meets the next scan's
    marker or the EOI where it wants an RSTn)."""
    out = {f"cut_{k}_4": data[: len(data) * k // 4] for k in (1, 2, 3)}
    if name.startswith("tiff_"):
        out["strip_cut_short"], out["tag_past_end"] = _strip_cut_short(data), _tag_past_end(data)
    else:
        out["no_eoi"] = data[:-2] if data.endswith(b"\xff\xd9") else None
        if b"\xff\xdd" in data and (b"\xff\xc9" in data or b"\xff\xca" in data):
            for k, (start, end) in enumerate(_scans(data)):
                out[f"scan_{k}_half_dropped"] = data[: start + (end - start) // 2] + data[end:]
    return {k: v for k, v in out.items() if v is not None}


def _undamaged_rows(damaged, undamaged):
    """The rows of Pillow's decode of a damaged CCITT strip before the
    first row that differs from the undamaged file's decode: the row where
    the data end (libtiff fills it with the runs it decoded from the bits
    left, padded with zeros); libtiff stops there and may leave the
    strip's later rows unwritten (Pillow shows whatever its buffer held,
    different from run to run)."""
    differ = np.flatnonzero((damaged != undamaged).any(axis=(1, 2)))
    return int(differ[0]) if len(differ) else damaged.shape[0]


@pytest.mark.parametrize("name", sorted(n for n in DIGESTS["files"] if n.startswith(("tiff_", "jpeg_"))))
def test_damaged_data_decodes_or_fails_as_the_jax_package(name):
    """Every TIFF and JPEG fixture under the fixed mutations: the port's
    texture decode and the JAX package's both fail (a white texel in both
    pools), or give the same pixels: libtiff's recoveries (a JPEG strip
    whose data end early reads as libjpeg reads a scan cut short, YCbCr
    strips keep what LZW, PackBits or Deflate decoded, libtiff's own strip
    tags when Pillow's directory reader stops at a tag past the end, a
    CCITT strip cut short keeps its rows) included. A plain JPEG cut short
    or without its EOI is refused by both."""
    from vk_gltf_renderer_tpu.ops.textures import decode_image as jdecode
    from vk_gltf_renderer_tpu_torch.ops.tiff import CCITT, COMPRESSIONS, _read_ifd

    data = (FIXTURES / name).read_bytes()
    ccitt = name.startswith("tiff_") and COMPRESSIONS.get(_read_ifd(data)[2].get(259, (1,))[0]) in CCITT
    cases = _mutations(name, data)
    assert cases
    for kind, damaged in cases.items():
        model = _model(damaged)
        try:
            ref = np.asarray(jdecode(model, {"bufferView": 0}))
        except Exception:  # noqa: BLE001 - whatever Pillow raises, the reference's pool makes the texel white
            ref = None
        if ref is None:
            with pytest.raises(ValueError):
                ttextures.decode_image(model, {"bufferView": 0})
            continue
        got = ttextures.decode_image(model, {"bufferView": 0})
        assert got.shape == ref.shape, (name, kind)
        if ccitt and kind == "strip_cut_short":
            k = _undamaged_rows(_pillow_rgba(damaged), _pillow_rgba(data))
            assert k > 0 and np.array_equal(got[: k + 1], ref[: k + 1]), (name, kind, k)
        else:
            assert np.array_equal(got, ref), (name, kind)


def test_lab_conversion_matches_pillow_on_every_pixel():
    """All 2^24 LAB pixels in one 4096x4096 image: Pillow's convert("RGB")
    (LittleCMS's Lab to sRGB transform) and ops/imagemodes.lab_to_rgb agree
    bit for bit."""
    from vk_gltf_renderer_tpu_torch.ops.imagemodes import lab_to_rgb

    v = np.arange(1 << 24, dtype=np.uint32)
    raw = np.stack([v >> 16, (v >> 8) & 255, v & 255], axis=-1).astype(np.uint8)
    del v
    im = PIL_Image.frombytes("LAB", (4096, 4096), raw.tobytes(), "raw", "LAB")  # a* and b* signed
    ref = np.asarray(im.convert("RGB")).reshape(-1, 3)
    del im
    raw[:, 1:] ^= 128  # Pillow's storage: a* and b* plus 128
    got = lab_to_rgb(raw)
    assert got.shape == ref.shape and np.array_equal(got, ref)


# ------------------------------------------------------------ writers


SHAPES = {"gray": (13, 17), "gray1": (13, 17, 1), "rgb": (13, 17, 3), "rgba": (13, 17, 4), "one_pixel": (1, 1, 3),
          "odd_rgb": (31, 29, 3)}
BYTE_EQUAL = [".bmp", ".dib", ".tga", ".tif", ".tiff", ".ppm", ".pgm", ".pbm", ".pnm"]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("suffix", BYTE_EQUAL)
def test_writer_matches_pillow_byte_for_byte(suffix, shape, tmp_path):
    a = np.random.default_rng(len(suffix) + 7 * len(shape)).integers(0, 256, SHAPES[shape], dtype=np.uint8)
    write_image(tmp_path / ("x" + suffix), a)
    ref = tmp_path / ("ref" + suffix)
    PIL_Image.fromarray(a[..., 0] if a.ndim == 3 and a.shape[2] == 1 else a).save(ref)
    assert (tmp_path / ("x" + suffix)).read_bytes() == ref.read_bytes()
    back = _rgba(read_image(ref.read_bytes()))
    assert np.array_equal(back, _pillow_rgba(ref.read_bytes()))


def _smooth_frame(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([0.5 + 0.4 * np.sin(6 * x + k + 3 * y * y) for k in range(3)], -1) + rng.normal(0, 0.01, (h, w, 3))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


@pytest.mark.parametrize("colours", [2, 100, 256])
def test_gif_writer_keeps_every_colour_up_to_256(colours, tmp_path):
    """At most 256 colours: the port's GIF and Pillow's decode to the same
    pixels, the image itself."""
    rng = np.random.default_rng(colours)
    pal = rng.integers(0, 256, (colours, 3), dtype=np.uint8)
    a = pal[rng.integers(0, colours, (19, 23))]
    write_image(tmp_path / "x.gif", a)
    PIL_Image.fromarray(a).save(tmp_path / "ref.gif")
    mine = _pillow_rgba((tmp_path / "x.gif").read_bytes())
    assert np.array_equal(mine, _pillow_rgba((tmp_path / "ref.gif").read_bytes()))
    assert np.array_equal(mine[..., :3], a) and np.array_equal(read_image((tmp_path / "x.gif").read_bytes()), mine)


def test_gif_writer_median_cut_above_256_colours(tmp_path):
    """A smooth 96x128 frame of thousands of colours: the port's median cut
    and Pillow's differ (ROADMAP C records the share and the largest
    channel error measured here); each stays close to the frame."""
    a = _smooth_frame(96, 128, 3)
    assert len(np.unique(a.reshape(-1, 3), axis=0)) > 256
    write_image(tmp_path / "x.gif", a)
    PIL_Image.fromarray(a).save(tmp_path / "ref.gif")
    mine = read_image((tmp_path / "x.gif").read_bytes())[..., :3].astype(int)
    assert np.array_equal(_pillow_rgba((tmp_path / "x.gif").read_bytes())[..., :3], mine)
    ref = _pillow_rgba((tmp_path / "ref.gif").read_bytes())[..., :3].astype(int)
    assert np.abs(mine - a).max() <= 16 and np.abs(mine - a).mean() < 2.5
    assert np.abs(ref - a).max() <= 16
    differ = (mine != ref).any(-1).mean()
    print(f"GIF median cut of {len(np.unique(a.reshape(-1, 3), axis=0))} colours, 96x128: {100 * differ:.2f}% of "
          f"pixels differ from Pillow's, largest channel error {np.abs(mine - ref).max()}; against the frame "
          f"port {np.abs(mine - a).max()} / {np.abs(mine - a).mean():.3f}, Pillow {np.abs(ref - a).max()} / "
          f"{np.abs(ref - a).mean():.3f} (largest / mean)")
    assert 0 < differ < 1 and np.abs(mine - ref).max() <= 16


@pytest.mark.parametrize("suffix", [".xyz", ".jp2", ".ico"])
def test_unknown_suffix_raises_value_error(suffix, tmp_path):
    with pytest.raises(ValueError, match="unknown file extension"):
        write_image(tmp_path / ("x" + suffix), np.zeros((2, 2, 3), np.uint8))
    with pytest.raises(ValueError, match="unknown file extension"):
        headless.main(["--scenefile", str(tmp_path / "absent.gltf"), "--device", "cpu", "--output",
                       str(tmp_path / ("o" + suffix))])


def test_edit_shell_render_unknown_suffix_keeps_the_shell(tmp_path, capsys):
    """edit_cli's `render x.xyz` prints the error the reference's shell
    prints from Pillow's save (ValueError: unknown file extension) and
    keeps the shell alive, before any frame renders."""
    from vk_gltf_renderer_tpu_torch import edit_cli

    with pytest.raises(ValueError) as pillow:
        PIL_Image.new("RGB", (1, 1)).save(tmp_path / "ref.xyz")
    sc = TScene()
    sc.load(scenes.make_helmet_standin(str(tmp_path)))
    sh = edit_cli.EditShell(sc, device="cpu")
    assert sh.run_line(f"render {tmp_path / 'x.xyz'} 8 8")
    assert capsys.readouterr().out == f"error: ValueError: {pillow.value}\n"
    assert not (tmp_path / "x.xyz").exists()


# ------------------------------------------------------------ whole frames


FRAME_FIXTURES = ["bmp_palette8.bmp", "tga_rgb24_rle.tga", "tiff_tiles_lzw.tif", "gif_interlaced.gif",
                  "ppm_p6_maxval_1023.ppm", "psd_rgb_layers_resources.psd", "sgi_rgb_rle.rgb", "pcx_planes4.pcx",
                  "dcx_one_page.dcx", "ico_bmp24_mask.ico", "cur_bmp8.cur", "qoi_rgb_runs.qoi", "sun_rle_bgr24.ras",
                  "tiff_lzma_rgb.tif", "tiff_group4_300x200.tif", "tiff_ycbcr_22_8.tif",
                  "jpeg_lossless_2x2_interleaved.jpg", "png_palette8_adam7.png", "blp2_dxt5.blp",
                  "tiff_libtiff_old_jpeg.tif", "fits_8.fits", "flc_brun.flc", "pcd_90.pcd", "icns_it32_mask.icns",
                  "j2k_irr_six_resolutions.jp2"]
W, H, DEPTH = 48, 32, 5


def _frame(renderer, path, hdr):
    renderer.create_scene(path)
    renderer.create_hdr(hdr)
    aux = renderer.on_render()
    aux = {k: np.asarray(v.cpu() if hasattr(v, "cpu") else v) for k, v in aux.items()}
    return np.array(renderer.image_linear()), aux


@pytest.mark.parametrize("name", FRAME_FIXTURES)
@pytest.mark.usefixtures("one_torch_thread")
def test_textured_frame_matches_jax_renderer(name, tmp_path):
    data = (FIXTURES / name).read_bytes()
    path = scenes.helmet_with_texture(str(tmp_path), data, name)
    hdr = scenes.write_synthetic_hdr(tmp_path / "env.hdr", 64, 128)
    img_r, aux_r = _frame(JaxRenderer(W, H, spp=1, max_depth=DEPTH), path, hdr)
    r = GltfRenderer(W, H, spp=1, max_depth=DEPTH, device="cpu")
    img_p, aux_p = _frame(r, path, hdr)
    assert r.dev_scene.tex_desc[0, 1:3].tolist() == DIGESTS["files"][name]["shape"][1::-1]
    assert img_p.shape == (H, W, 3) and np.isfinite(img_p).all() and img_p.mean() > 0.01
    ids = (aux_p["first_rnode"] == aux_r["first_rnode"]) & (aux_p["first_tri"] == aux_r["first_tri"])
    assert ids.mean() >= 0.999
    close = (np.abs(img_p - img_r) <= 1e-3 * (1.0 + np.abs(img_r))).all(axis=-1)
    assert close.mean() >= 0.99
    np.testing.assert_allclose(img_p.mean(axis=(0, 1)), img_r.mean(axis=(0, 1)), rtol=1e-3)


NEW_SUFFIXES = [s for s in WRITABLE if s not in (".png", ".jpg", ".jpeg", ".webp")]


@pytest.fixture(scope="module")
def headless_outputs(tmp_path_factory):
    """One headless render written in PNG and in every new suffix. The
    renders read and write a settings file of their own, so the flags they
    remember reach no other test."""
    tmp = tmp_path_factory.mktemp("headless")
    sc = scenes.make_helmet_standin(str(tmp))
    hdr = scenes.write_synthetic_hdr(str(tmp / "env.hdr"), 32, 64)
    base = ["--scenefile", sc, "--hdrfile", hdr, "--envSystem", "1", "--size", "24", "16", "--frames", "1",
            "--ptDepth", "2", "--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VKGR_SETTINGS", str(tmp / "settings.json"))
        for suffix in [".png"] + NEW_SUFFIXES:
            assert headless.main(base + ["--output", str(tmp / ("o" + suffix))]) == 0
    assert (tmp / "settings.json").exists()
    return tmp


@pytest.mark.parametrize("suffix", NEW_SUFFIXES)
def test_headless_output_in_each_new_suffix(suffix, headless_outputs):
    png = read_image((headless_outputs / "o.png").read_bytes())[..., :3]
    data = (headless_outputs / ("o" + suffix)).read_bytes()
    got = _rgba(read_image(data))
    assert np.array_equal(got, _pillow_rgba(data))
    colours = len(np.unique(png.reshape(-1, 3), axis=0))
    if suffix == ".gif" and colours > 256:
        assert np.abs(got[..., :3].astype(int) - png).max() <= 16
    else:
        assert np.array_equal(got[..., :3], png)


# ------------------------------------------------------------ the native coder


def test_image_coder_that_fails_to_load_raises(monkeypatch, tmp_path):
    """An image coder library that builds but does not load fails the scene
    load: no texture turns white in its place, and there is no numpy path."""
    path = scenes.helmet_with_texture(str(tmp_path), (FIXTURES / "tiff_rgb_lzw.tif").read_bytes(), "t.tif")
    native.get_lib()

    def refuse(*args, **kwargs):
        raise OSError("file too short")

    monkeypatch.setattr(native, "_image", None)
    monkeypatch.setattr(native.ctypes, "CDLL", refuse)
    with pytest.raises(RuntimeError, match="image_coders.*file too short"):
        GltfRenderer(W, H, spp=1, max_depth=DEPTH, device="cpu").create_scene(path)


def test_gif_from_rgba_no_front_end_writes_it(tmp_path, monkeypatch):
    """A GIF written from an RGBA array, by Pillow and by the port: Pillow
    quantizes RGBA (its fast octree) and maps the fully transparent pixels
    to a transparency index, the port keeps every colour and drops alpha
    (ROADMAP C). No front end reaches
    this: save_image (headless, edit_cli) and the viewer's --output hand
    write_image three channels."""
    rng = np.random.default_rng(5)
    pal = rng.integers(0, 256, (20, 3), dtype=np.uint8)
    rgb = pal[rng.integers(0, 20, (19, 23))]
    rgba = np.concatenate([rgb, np.where(rng.random((19, 23, 1)) < 0.3, 0, 255).astype(np.uint8)], -1)
    write_image(tmp_path / "x.gif", rgba)
    PIL_Image.fromarray(rgba).save(tmp_path / "ref.gif")
    mine, ref = _pillow_rgba((tmp_path / "x.gif").read_bytes()), _pillow_rgba((tmp_path / "ref.gif").read_bytes())
    clear = rgba[..., 3] == 0
    assert np.array_equal(mine[..., :3], rgb) and (mine[..., 3] == 255).all()
    assert (ref[..., 3] == np.where(clear, 0, 255)).all()
    assert np.abs(ref[~clear, :3].astype(int) - rgb[~clear]).max() <= 16
    from vk_gltf_renderer_tpu_torch import renderer as trenderer, viewer as tviewer

    shapes = []
    monkeypatch.setattr(trenderer, "write_image", lambda path, a: shapes.append(np.asarray(a).shape))
    monkeypatch.setattr(tviewer, "write_image", lambda path, a: shapes.append(np.asarray(a).shape))
    sc = scenes.make_helmet_standin(str(tmp_path))
    assert headless.main(["--scenefile", sc, "--size", "8", "6", "--frames", "1", "--ptDepth", "1", "--device", "cpu",
                          "--output", str(tmp_path / "o.gif")]) == 0
    assert tviewer.main(["--scenefile", sc, "--size", "8", "--keys", " ", "--output", str(tmp_path / "v.gif"),
                         "--device", "cpu"]) in (0, None)
    assert shapes and all(len(sh) == 3 and sh[2] == 3 for sh in shapes), shapes


def test_gif_median_cut_is_a_partition():
    cols = np.random.default_rng(2).integers(0, 256, (5000, 3))
    weights = np.random.default_rng(3).integers(1, 9, 5000)
    palette, box = gif.median_cut(cols, weights, 256)
    assert len(palette) == 256 and box.max() == 255
    for i in (0, 100, 255):
        members = cols[box == i]
        assert len(members) and (members.min(0) <= palette[i]).all() and (palette[i] <= members.max(0)).all()
