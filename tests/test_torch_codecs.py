"""The port's image codecs against the JAX package's, on the CPU.

- ops/dds.py, ops/astc.py and ops/basisu.py are copies: every function's
  and class's source equals the reference's, and every input the
  reference's decoder tests build (tests/test_features.py,
  tests/test_env.py, tests/test_astc.py, tests/test_basisu.py), and the
  seeded containers of scenes.py, decode to bit-equal float images in both
  packages (or raise the same error).
- ops/jpeg.py decodes as the JAX package's decode_image does through
  Pillow (libjpeg-turbo): every sample within 1/255 and at least 99% of
  samples equal, in every mode listed in JPEG_CASES (Pillow-made files, and
  the port's writer's 4:4:0 and progressive files, which Pillow cannot
  write). The forms Pillow decodes beyond Huffman DCT (arithmetic coding,
  8-bit lossless, CMYK and YCCK, made by tests/torch_test_helpers.py's
  encoders) decode bit for bit as the JAX package decodes them; the forms
  it refuses (12-bit, hierarchical, lossless arithmetic, lossless YCbCr)
  are white in both packages. The port's writer's files decode in Pillow as in the port, and
  its quality-75 file keeps the PSNR of Pillow's own quality-75 save
  within 0.5 dB.
- A glTF whose base colour is JPEG, DDS or KTX2 BasisLZ renders 48x32
  frames that agree with the JAX renderer's at tests/test_torch_frame.py's
  thresholds.
- Truncated files, and JPEGs with Huffman tables libjpeg refuses, give a
  white 1x1 texture in both packages' build_texture_pool, and the scene
  loads; a JPEG coder that does not load fails the scene load; WebP decodes
  as Pillow does (tests/test_torch_webp.py has the rest), renders as the
  JAX renderer does and loads white when truncated; BMP decodes as Pillow
  decodes it (tests/test_torch_images.py has Pillow's other formats).

Pillow is only a reference here: the port never imports it."""

import inspect
import io
import json
import struct
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

PIL_Image = pytest.importorskip("PIL.Image")

from test_astc import _build_uastc_ktx2  # noqa: E402
from test_basisu import _build_basislz_ktx2  # noqa: E402
from test_features import _encode_bc1_block  # noqa: E402
from vk_gltf_renderer_tpu.models import Scene as JScene  # noqa: E402
from vk_gltf_renderer_tpu.ops import astc as jastc  # noqa: E402
from vk_gltf_renderer_tpu.ops import basisu as jbasisu  # noqa: E402
from vk_gltf_renderer_tpu.ops import dds as jdds  # noqa: E402
from vk_gltf_renderer_tpu.ops import textures as jtextures  # noqa: E402
from vk_gltf_renderer_tpu.renderer import GltfRenderer as JaxRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch import scenes  # noqa: E402
from vk_gltf_renderer_tpu_torch.models import Scene as TScene  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import astc as tastc  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import basisu as tbasisu  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import dds as tdds  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import jpeg  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import textures as ttextures  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import webp  # noqa: E402
from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer  # noqa: E402
from torch_test_helpers import cmyk_to_ycck, jpeg_from_planes, jpeg_lossless  # noqa: E402
from torch_test_helpers import one_torch_thread, share_native_builder  # noqa: E402, F401 (a fixture)

share_native_builder()

COPIES = {"ops/dds.py": (jdds, tdds), "ops/astc.py": (jastc, tastc), "ops/basisu.py": (jbasisu, tbasisu)}


def _own(module):
    return {n: v for n, v in vars(module).items()
            if (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == module.__name__}


# the one deliberate difference: KTX2's zstd supercompression goes through the port's own decoder
# (ops/zstd.py), not the zstandard package, which the card's machine lacks
_ZSTD_REF = """        try:
            import zstandard
        except ImportError as e:
            raise UnsupportedCodec(
                "KTX2 zstd supercompression requires the zstandard package") from e

        payload = zstandard.ZstdDecompressor().decompress(payload, max_output_size=int(uncomp) or 1 << 30)"""
_ZSTD_PORT = """        from .zstd import decompress

        payload = decompress(payload, int(uncomp) or 1 << 30)"""
DIFFERENCES = {("ops/dds.py", "decode_ktx2"): (_ZSTD_REF, _ZSTD_PORT)}


@pytest.mark.parametrize("path", sorted(COPIES))
def test_copied_codec_modules_match_the_originals(path):
    ref, port = COPIES[path]
    names = _own(ref)
    assert names and sorted(names) == sorted(_own(port)), path
    for n in names:
        want = inspect.getsource(getattr(ref, n))
        if (path, n) in DIFFERENCES:
            old, new = DIFFERENCES[(path, n)]
            assert want.count(old) == 1, (path, n)
            want = want.replace(old, new)
        assert inspect.getsource(getattr(port, n)) == want, (path, n)


# ------------------------------------------------------------ the reference tests' inputs


def _dds(w, h, pf_flags, fourcc, masks=None):
    head = b"DDS " + struct.pack("<I", 124) + struct.pack("<3I", 0, h, w)
    head += b"\0" * (72 - 16)
    head += struct.pack("<2I4s", 32, pf_flags, fourcc)
    head += struct.pack("<5I", *masks) if masks else b"\0" * 20
    return head + b"\0" * (124 + 4 - len(head))


def _ktx2_rgba(scheme, payload, n_raw, w=2, h=2):
    head = tdds.KTX2_MAGIC + struct.pack("<9I", 37, 1, w, h, 0, 0, 1, 1, scheme)
    head += struct.pack("<2I2I2Q", 0, 0, 0, 0, 0, 0)
    return head + struct.pack("<3Q", 80 + 24, len(payload), n_raw) + payload


def _features_bc1():  # tests/test_features.py: BC1 red/blue, one row each of the four indices
    return _dds(4, 4, 0x4, b"DXT1") + _encode_bc1_block(0xF800, 0x001F, [0] * 4 + [1] * 4 + [2] * 4 + [3] * 4)


def _features_bgra():
    raw = np.array([[[1, 2, 3, 255], [4, 5, 6, 255]], [[7, 8, 9, 255], [10, 11, 12, 255]]], np.uint8)
    return _dds(2, 2, 0x40, b"\0\0\0\0", (32, 0x00FF0000, 0x0000FF00, 0x000000FF, 0xFF000000)) + \
        raw[..., [2, 1, 0, 3]].tobytes()


_RGBA = np.arange(16, dtype=np.uint8).reshape(2, 2, 4)


def _zstd(data):
    zstandard = pytest.importorskip("zstandard")
    return zstandard.ZstdCompressor().compress(data)


def _env_zstd():  # tests/test_env.py: an 8x8 zstd KTX2
    rgba = (np.arange(8 * 8 * 4) % 255).astype(np.uint8)
    return _ktx2_rgba(2, _zstd(rgba.tobytes()), rgba.size, 8, 8)


def _basisu_etc1s(with_alpha):  # tests/test_basisu.py: the seeded 8x8 BasisLZ container
    rng = np.random.default_rng(9)
    ne, ns = 5, 6
    color5 = rng.integers(0, 32, (ne, 3)).astype(np.uint8)
    inten5 = rng.integers(0, 8, ne).astype(np.uint8)
    rows = rng.integers(0, 256, (ns, 4)).astype(np.uint8)
    eidx = rng.integers(0, ne, (2, 2))
    sidx = rng.integers(0, ns, (2, 2))
    return _build_basislz_ktx2(8, 8, color5, inten5, rows, eidx, sidx, with_alpha=with_alpha)


REFERENCE_INPUTS = {
    "features_dds_bc1": _features_bc1,
    "features_dds_bgra8": _features_bgra,
    "features_ktx2_rgba8": lambda: _ktx2_rgba(0, _RGBA.tobytes(), _RGBA.size),
    "features_ktx2_zlib": lambda: _ktx2_rgba(3, zlib.compress(_RGBA.tobytes()), _RGBA.size),
    "features_ktx2_zstd": lambda: _ktx2_rgba(2, _zstd(_RGBA.tobytes()), _RGBA.size),
    "features_ktx2_basislz_unsupported": lambda: _ktx2_rgba(1, b"basislz-data", 12),
    "env_ktx2_zstd": _env_zstd,
    "astc_uastc_void_extents": lambda: _build_uastc_ktx2(8, 8, b"".join(
        jastc.encode_void_extent((c, 2 * c, 3 * c, 255)) for c in (10, 20, 30, 40))),
    "astc_plain_4x4": lambda: _build_uastc_ktx2(4, 4, jastc.encode_block(
        4, 4, 8, [(7, 0)] * 16, [8], [(v, 0) for v in (0, 255, 0, 255, 0, 255)]), vk_format=157, color_model=0),
    "astc_uastc_gltf_texture": lambda: _build_uastc_ktx2(8, 8, jastc.encode_void_extent((200, 10, 10, 255)) * 4),
    "basisu_etc1s": lambda: _basisu_etc1s(False),
    "basisu_etc1s_alpha": lambda: _basisu_etc1s(True),
}

# the port's seeded containers of scenes.py (a 64x64 texture_image)
SEEDED_INPUTS = {
    "dds_bgra8": lambda img: scenes.dds_bgra8(img),
    "dds_bc1": lambda img: scenes.dds_bc1(img),
    "ktx2_rgba8": lambda img: scenes.ktx2_rgba8(img),
    "ktx2_zlib": lambda img: scenes.ktx2_rgba8(img, zlib_level=6),
    "ktx2_etc1s": lambda img: scenes.ktx2_etc1s(img),
    "ktx2_astc": lambda img: scenes.ktx2_astc(scenes.astc_4x4_blocks(img), 64, 64),
    "ktx2_uastc": lambda img: scenes.ktx2_astc(scenes.astc_4x4_blocks(img), 64, 64, uastc=True),
}


def _decode_both(data):
    out = []
    for mod in (jdds, tdds):
        try:
            out.append(mod.sniff_decode(data))
        except Exception as e:  # noqa: BLE001 (the two packages must raise alike)
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("case", sorted(REFERENCE_INPUTS))
def test_reference_decoder_inputs_decode_alike(case):
    ref, port = _decode_both(REFERENCE_INPUTS[case]())
    if isinstance(ref, str):
        assert ref == port == "UnsupportedCodec", (ref, port)
        return
    assert ref.dtype == port.dtype == np.float32 and np.array_equal(ref, port)


@pytest.mark.parametrize("case", sorted(SEEDED_INPUTS))
def test_seeded_containers_decode_alike(case):
    img = scenes.texture_image(64, seed=3)
    data = SEEDED_INPUTS[case](img)
    ref, port = _decode_both(data)
    assert ref.shape == (64, 64, 4) and np.array_equal(ref, port)
    # through decode_image as well: the texture path's dispatch
    model = _model(data)
    assert np.array_equal(ttextures.decode_image(model, {"bufferView": 0}), ref)
    err = np.abs(port[..., :3] * 255 - img).mean()
    lossless = case in ("dds_bgra8", "ktx2_rgba8", "ktx2_zlib")
    assert err == 0 if lossless else err < 12, (case, err)


# ------------------------------------------------------------ JPEG against Pillow


def _model(data):
    """The least model decode_image reads: one image in one buffer view."""
    return SimpleNamespace(buffer_views=[{"buffer": 0, "byteOffset": 0, "byteLength": len(data)}],
                           buffers=[data], base_dir=None)


def _photo(h, w, seed=0, gray=False):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7 + rng.random() * 6) * np.cos(y / 5),
                    128 + 90 * np.sin((x + y) / 11), 128 + 60 * np.cos(x / 3 - y / 9)], -1)
    img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


def _pillow_jpeg(img, **kw):
    buf = io.BytesIO()
    PIL_Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _sof1(data):
    """The same file as an extended-sequential (SOF1) frame: its Huffman
    baseline scans decode identically."""
    i = data.index(b"\xff\xc0")
    return data[:i] + b"\xff\xc1" + data[i + 2:]


JPEG_CASES = {
    "444": lambda: _pillow_jpeg(_photo(64, 64), subsampling=0),
    "422": lambda: _pillow_jpeg(_photo(64, 64), subsampling=1),
    "420": lambda: _pillow_jpeg(_photo(64, 64), subsampling=2),
    "440": lambda: jpeg.encode_jpeg(_photo(64, 64), subsampling="4:4:0"),
    "gray": lambda: _pillow_jpeg(_photo(48, 40, gray=True)),
    "odd_37x23_420": lambda: _pillow_jpeg(_photo(23, 37, seed=1)),
    "odd_37x23_422": lambda: _pillow_jpeg(_photo(23, 37, seed=1), subsampling=1),
    "odd_37x23_440": lambda: jpeg.encode_jpeg(_photo(23, 37, seed=1), subsampling="4:4:0"),
    "restart_blocks": lambda: _pillow_jpeg(_photo(64, 48), restart_marker_blocks=3),
    "restart_rows": lambda: _pillow_jpeg(_photo(64, 48, seed=2), restart_marker_rows=1, subsampling=0),
    "quality_50": lambda: _pillow_jpeg(_photo(64, 64, seed=4), quality=50),
    "quality_95": lambda: _pillow_jpeg(_photo(64, 64, seed=4), quality=95),
    "progressive": lambda: _pillow_jpeg(_photo(64, 64, seed=5), progressive=True),
    "progressive_444_q90": lambda: _pillow_jpeg(_photo(56, 72, seed=5), progressive=True, subsampling=0,
                                                quality=90),
    "progressive_gray": lambda: _pillow_jpeg(_photo(40, 48, seed=6, gray=True), progressive=True),
    "progressive_restart": lambda: _pillow_jpeg(_photo(64, 64, seed=7), progressive=True,
                                                restart_marker_blocks=2),
    "progressive_writer_440": lambda: jpeg.encode_jpeg(_photo(37, 23, seed=8), subsampling="4:4:0",
                                                       progressive=True),
    "sof1_extended": lambda: _sof1(_pillow_jpeg(_photo(48, 48, seed=9))),
}


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_jpeg_decoder_matches_pillow(case):
    data = JPEG_CASES[case]()
    model = _model(data)
    ref = jtextures.decode_image(model, {"bufferView": 0})
    port = ttextures.decode_image(model, {"bufferView": 0})
    assert port.shape == ref.shape and port.dtype == np.float32
    diff = np.abs(np.rint(port * 255) - np.rint(ref * 255))
    assert diff.max() <= 1, (case, diff.max())
    assert (diff == 0).mean() >= 0.99, (case, (diff == 0).mean())


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4", "4:2:2", "4:4:0"])
@pytest.mark.parametrize("progressive", [False, True])
def test_jpeg_writer_files_decode_in_pillow_as_in_the_port(subsampling, progressive):
    img = _photo(45, 61, seed=11)
    data = jpeg.encode_jpeg(img, subsampling=subsampling, progressive=progressive)
    pil = np.asarray(PIL_Image.open(io.BytesIO(data)).convert("RGB"))
    port = jpeg.decode_jpeg(data)
    assert pil.shape == port.shape == img.shape and np.array_equal(pil, port)


def _psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b) ** 2))


@pytest.mark.parametrize("seed", [0, 1])
def test_jpeg_writer_quality_matches_pillow(seed):
    img = scenes.texture_image(256, seed=seed)
    ours = np.asarray(PIL_Image.open(io.BytesIO(jpeg.encode_jpeg(img))).convert("RGB"))
    pillow = np.asarray(PIL_Image.open(io.BytesIO(_pillow_jpeg(img))).convert("RGB"))
    assert abs(_psnr(img, ours) - _psnr(img, pillow)) <= 0.5
    # the same markers Pillow writes by default: baseline, q75 tables, Annex K Huffman tables
    segs = {}
    for data, key in ((jpeg.encode_jpeg(img), "port"), (_pillow_jpeg(img), "pillow")):
        pos, found = 2, {}
        while data[pos + 1] != 0xDA:
            n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
            found.setdefault(data[pos + 1], b"")
            found[data[pos + 1]] += data[pos + 4:pos + 2 + n]
            pos += 2 + n
        segs[key] = found
    for marker in (0xC0, 0xDB, 0xC4):  # SOF0, DQT, DHT
        assert segs["port"][marker] == segs["pillow"][marker], hex(marker)


def _cmyk(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8)


def _ycc_planes(img):
    return [p.astype(np.uint8) for p in jpeg._rgb_to_ycc(img)]


# forms libjpeg-turbo (through Pillow) decodes and the port decodes as well: arithmetic coding (the QM coder,
# DAC conditioning, restarts, progressive refinement), 8-bit lossless (every predictor, point transforms,
# restarts) and four-component Adobe files (CMYK, YCCK)
PILLOW_DECODES = {
    "arith_baseline_420": lambda: jpeg_from_planes(_ycc_planes(_photo(37, 45)), samp=[(2, 2), (1, 1), (1, 1)],
                                                   arith=True),
    "arith_422_dac_restart": lambda: jpeg_from_planes(
        _ycc_planes(_photo(37, 45, 1)), samp=[(2, 1), (1, 1), (1, 1)], arith=True, restart=3,
        dac={(0, 0): 0x52, (1, 0): 12, (0, 1): 0x20, (1, 1): 2}),
    "arith_progressive_420": lambda: jpeg_from_planes(_ycc_planes(_photo(37, 45, 2)),
                                                      samp=[(2, 2), (1, 1), (1, 1)], arith=True, progressive=True),
    "arith_progressive_restart": lambda: jpeg_from_planes(_ycc_planes(_photo(21, 30, 3)), arith=True,
                                                          progressive=True, restart=2),
    "arith_gray": lambda: jpeg_from_planes([_photo(33, 17, 4, gray=True)], arith=True, quality=95),
    **{f"lossless_gray_predictor{p}": (lambda p=p: jpeg_lossless([_photo(13, 19, 5, gray=True)], predictor=p))
       for p in range(1, 8)},
    "lossless_rgb_restart": lambda: jpeg_lossless(list(_photo(17, 15, 6).transpose(2, 0, 1)), predictor=6,
                                                  restart_rows=4),
    "lossless_rgb_adobe0": lambda: jpeg_lossless(list(_photo(9, 11, 7).transpose(2, 0, 1)), adobe=0),
    "lossless_gray_pt3": lambda: jpeg_lossless([_photo(11, 9, 8, gray=True)], predictor=5, pt=3),
    "lossless_cmyk": lambda: jpeg_lossless(list(_cmyk(9, 7, 9).transpose(2, 0, 1)), predictor=2),
    **{f"lossless_subsampled_{h}x{v}_{'interleaved' if inter else 'scans'}_{'adobe0' if adobe == 0 else 'no_marker'}":
       (lambda h=h, v=v, inter=inter, adobe=adobe: _lossless_subsampled(h, v, inter, adobe))
       for h, v in ((2, 2), (2, 1), (1, 2)) for inter in (True, False) for adobe in (0, None)},
    "cmyk_pillow": lambda: _pillow_cmyk(_cmyk(23, 29, 10)),
    "cmyk_no_adobe": lambda: jpeg_from_planes(list(_cmyk(23, 29, 11).transpose(2, 0, 1)), jfif=False),
    "ycck_adobe2_420": lambda: jpeg_from_planes(cmyk_to_ycck(_cmyk(23, 29, 12)),
                                                samp=[(2, 2), (1, 1), (1, 1), (2, 2)], adobe=2, jfif=False),
    "ycck_adobe1": lambda: jpeg_from_planes(cmyk_to_ycck(_cmyk(16, 16, 13)), adobe=1, jfif=False),
    "ycck_arith": lambda: jpeg_from_planes(cmyk_to_ycck(_cmyk(23, 29, 14)), adobe=2, jfif=False, arith=True),
}


def _lossless_subsampled(h, v, interleaved, adobe, w=19, ht=13):
    """Lossless RGB whose first component is sampled h x v and the other two
    1x1 (each plane at its own size; the chroma-sized planes a smooth photo's
    box means), predictor 1 + h + 2v."""
    rgb = _photo(ht, w, 20 + 4 * h + v).astype(np.int32)
    cw, ch = -(-w // h), -(-ht // v)
    pad = np.pad(rgb, ((0, ch * v - ht), (0, cw * h - w), (0, 0)), mode="edge")
    small = pad.reshape(ch, v, cw, h, 3).mean(axis=(1, 3)).astype(np.uint8)
    planes = [rgb[..., 0].astype(np.uint8), small[..., 1], small[..., 2]]
    return jpeg_lossless(planes, predictor=1 + h + 2 * v if 1 + h + 2 * v <= 7 else 7,
                         samp=[(h, v), (1, 1), (1, 1)], interleaved=interleaved, size=(w, ht), adobe=adobe)


def _pillow_cmyk(cmyk):
    b = io.BytesIO()
    PIL_Image.fromarray(cmyk, "CMYK").save(b, "JPEG", quality=85)
    return b.getvalue()


@pytest.mark.parametrize("case", sorted(PILLOW_DECODES))
def test_jpeg_decodes_what_pillow_decodes(case):
    """Each form decodes in the port bit for bit as the JAX package's
    decode_image (Pillow) decodes it; Pillow is asked first, so that a form
    it refused would fail here rather than pass as a shared refusal."""
    data = PILLOW_DECODES[case]()
    PIL_Image.open(io.BytesIO(data)).convert("RGBA")  # Pillow decodes it
    model = _model(data)
    ref = np.asarray(jtextures.decode_image(model, {"bufferView": 0}))
    assert np.array_equal(ttextures.decode_image(model, {"bufferView": 0}), ref)


def _with_sof(data, marker):
    i = data.index(b"\xff\xc3") if b"\xff\xc3" in data else data.index(b"\xff\xc0")
    return data[:i] + bytes([0xFF, marker]) + data[i + 2:]


def _twelve_bit():
    twelve = bytearray(_pillow_jpeg(_photo(16, 16)))
    twelve[twelve.index(b"\xff\xc0") + 4] = 12
    return bytes(twelve)


def _two_components():
    data = bytearray(jpeg_from_planes(_ycc_planes(_photo(16, 16))[:2], jfif=False))
    return bytes(data)


# forms Pillow refuses (libjpeg-turbo's errors, or Pillow's own SOF checks): both packages give white
PILLOW_REFUSES = {
    "twelve_bit": _twelve_bit,
    "two_components": _two_components,
    "lossless_arithmetic_sof11": lambda: _with_sof(jpeg_lossless([_photo(8, 8, gray=True)]), 0xCB),
    **{f"hierarchical_sof{m - 0xC0}": (lambda m=m: _with_sof(_pillow_jpeg(_photo(16, 16)), m))
       for m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)},
    "lossless_jfif_ycbcr": lambda: jpeg_lossless(list(_photo(9, 11).transpose(2, 0, 1)), jfif=True),
    "lossless_adobe1_ycbcr": lambda: jpeg_lossless(list(_photo(9, 11).transpose(2, 0, 1)), adobe=1),
    "lossless_ycck": lambda: jpeg_lossless(list(_cmyk(9, 7, 1).transpose(2, 0, 1)), adobe=2),
}


@pytest.mark.parametrize("case", sorted(PILLOW_REFUSES))
def test_jpeg_refuses_what_it_does_not_decode(case, tmp_path):
    """Pillow raises for each form, the port raises ValueError (so its
    texture pool makes it white), and both packages' pools give 1x1 white."""
    data = PILLOW_REFUSES[case]()
    with pytest.raises(Exception):  # noqa: B017 - whatever Pillow raises, the reference's pool catches
        PIL_Image.open(io.BytesIO(data)).convert("RGBA")
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(data)
    path = scenes.helmet_with_texture(str(tmp_path), data, "tex.jpg")
    for Scene, build in ((JScene, jtextures.build_texture_pool), (TScene, ttextures.build_texture_pool)):
        sc = Scene()
        sc.load(path)
        quads, desc, _, num_mips = build(sc.model)
        assert np.asarray(desc).tolist() == [[0, 1, 1, 0]] and np.asarray(num_mips).tolist() == [1]
        assert np.array_equal(np.asarray(quads), np.ones((1, 16), np.float32))


def test_webp_raises_naming_a12():
    """WebP decodes as the JAX package's decode_image (Pillow) does, bit for
    bit (tests/test_torch_webp.py covers every form); BMP, once a format
    that raised NotImplementedError naming A12, decodes as Pillow decodes
    it too (tests/test_torch_images.py covers Pillow's other formats)."""
    webp = io.BytesIO()
    PIL_Image.fromarray(scenes.texture_image(8, seed=4)[..., :3]).save(webp, "WEBP")
    bmp = io.BytesIO()
    PIL_Image.fromarray(scenes.texture_image(8, seed=5)[..., :3]).save(bmp, "BMP")
    for data in (webp.getvalue(), bmp.getvalue()):
        model = _model(data)
        assert np.array_equal(ttextures.decode_image(model, {"bufferView": 0}),
                              np.asarray(jtextures.decode_image(model, {"bufferView": 0})))


# ------------------------------------------------------------ truncated files, whole frames


def _pillow_webp(img, **kw) -> bytes:
    b = io.BytesIO()
    PIL_Image.fromarray(img).save(b, "WEBP", **kw)
    return b.getvalue()


TRUNCATED = {
    "jpeg": lambda img: (jpeg.encode_jpeg(img), "tex.jpg"),
    "dds_bc1": lambda img: (scenes.dds_bc1(img), "tex.dds"),
    "ktx2_zlib": lambda img: (scenes.ktx2_rgba8(img, zlib_level=6), "tex.ktx2"),
    "ktx2_etc1s": lambda img: (scenes.ktx2_etc1s(img), "tex.ktx2"),
    "ktx2_uastc": lambda img: (scenes.ktx2_astc(scenes.astc_4x4_blocks(img), 32, 32, uastc=True), "tex.ktx2"),
    "webp_lossy": lambda img: (_pillow_webp(img, quality=80), "tex.webp"),
    "webp_lossless": lambda img: (webp.encode_webp(img), "tex.webp"),
}


@pytest.mark.parametrize("fraction", [0.1, 0.5, 0.97])
@pytest.mark.parametrize("case", sorted(TRUNCATED))
def test_truncated_textures_load_white_in_both_packages(case, fraction, tmp_path):
    from vk_gltf_renderer_tpu.ops.flat import build_scene_flat as jflat
    from vk_gltf_renderer_tpu_torch.ops.flat import build_scene_flat as tflat

    data, name = TRUNCATED[case](scenes.texture_image(32, seed=2))
    path = scenes.helmet_with_texture(str(tmp_path), data[:int(len(data) * fraction)], name)
    pools = []
    for Scene, build in ((JScene, jtextures.build_texture_pool), (TScene, ttextures.build_texture_pool)):
        sc = Scene()
        sc.load(path)
        quads, desc, mip_table, num_mips = build(sc.model)
        pools.append((np.asarray(quads), np.asarray(desc), np.asarray(num_mips)))
    for quads, desc, num_mips in pools:
        assert desc.tolist() == [[0, 1, 1, 0]] and num_mips.tolist() == [1]
        assert np.array_equal(quads, np.ones((1, 16), np.float32))
    for Scene, build_flat in ((JScene, jflat), (TScene, tflat)):  # the scene loads
        sc = Scene()
        sc.load(path)
        assert np.asarray(build_flat(sc).tex_quads).shape == (1, 16)


def _with_dht(data, tc, th, bits, vals):
    """data with its DHT segment for table class tc, id th replaced."""
    pos = 2
    while data[pos + 1] != 0xDA:
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if data[pos + 1] == 0xC4 and data[pos + 4] == (tc << 4) | th:
            seg = bytes([(tc << 4) | th]) + bytes(bits) + bytes(vals)
            return data[:pos] + b"\xff\xc4" + struct.pack(">H", len(seg) + 2) + seg + data[pos + 2 + n:]
        pos += 2 + n
    raise AssertionError("no such DHT segment")


def _lengths(*counts):
    return list(counts) + [0] * (16 - len(counts))


# Huffman tables libjpeg refuses (jpeg_make_d_derived_tbl): class, bits, values
BAD_HUFFMAN = {
    "dc_overfull": (0, _lengths(5), range(5)),  # five codes of length 1
    "ac_overfull": (1, _lengths(5), [0x00, 0x01, 0x11, 0xF0, 0x02]),
    "all_ones_code": (0, _lengths(2), [0, 1]),  # codes 0 and 1: the all-ones code is reserved
    "dc_symbol_16": (0, _lengths(0, 1, 5, 1, 1, 1, 1, 1, 1), list(range(11)) + [16]),
}


@pytest.mark.parametrize("case", sorted(BAD_HUFFMAN))
def test_bad_huffman_tables_load_white_in_both_packages(case, tmp_path):
    """A DHT that libjpeg refuses raises ValueError in the port (no write
    past its lookup tables, no shift by a DC size above 15) and gives a
    white 1x1 texture in both packages, as Pillow raises for it."""
    tc, bits, vals = BAD_HUFFMAN[case]
    data = _with_dht(jpeg.encode_jpeg(scenes.texture_image(32, seed=3)), tc, 0, bits, vals)
    with pytest.raises(ValueError, match="Huffman table"):
        jpeg.decode_jpeg(data)
    with pytest.raises(OSError):
        PIL_Image.open(io.BytesIO(data)).convert("RGB")
    path = scenes.helmet_with_texture(str(tmp_path), data, "tex.jpg")
    for Scene, build in ((JScene, jtextures.build_texture_pool), (TScene, ttextures.build_texture_pool)):
        sc = Scene()
        sc.load(path)
        quads, desc, _, num_mips = build(sc.model)
        assert np.asarray(desc).tolist() == [[0, 1, 1, 0]] and np.asarray(num_mips).tolist() == [1]
        assert np.array_equal(np.asarray(quads), np.ones((1, 16), np.float32))


def test_jpeg_coder_that_fails_to_load_raises(monkeypatch, tmp_path):
    """A JPEG coder library that builds but does not load (a truncated
    file, a missing symbol) fails the scene load: no texture turns white
    in its place."""
    from vk_gltf_renderer_tpu_torch import native

    path = scenes.helmet_with_texture(str(tmp_path), jpeg.encode_jpeg(scenes.texture_image(32, seed=3)), "tex.jpg")
    native.get_lib()  # the BVH builder's library, loaded before CDLL refuses

    def refuse(*args, **kwargs):
        raise OSError("file too short")

    monkeypatch.setattr(native, "_jpeg", None)
    monkeypatch.setattr(native.ctypes, "CDLL", refuse)
    with pytest.raises(RuntimeError, match="jpeg_entropy.*file too short"):
        GltfRenderer(W, H, spp=1, max_depth=DEPTH, device="cpu").create_scene(path)


FRAME_FORMATS = {
    "jpeg": lambda img: (jpeg.encode_jpeg(img), "base.jpg"),
    "dds_bc1": lambda img: (scenes.dds_bc1(img), "base.dds"),
    "ktx2_basislz": lambda img: (scenes.ktx2_etc1s(img), "base.ktx2"),
    "webp_lossy": lambda img: (_pillow_webp(img, quality=80), "base.webp"),
}
W, H, DEPTH = 48, 32, 5


def _frame(renderer, path, hdr):
    renderer.create_scene(path)
    renderer.create_hdr(hdr)
    aux = renderer.on_render()
    aux = {k: np.asarray(v.cpu() if hasattr(v, "cpu") else v) for k, v in aux.items()}
    return np.array(renderer.image_linear()), aux


@pytest.mark.parametrize("fmt", sorted(FRAME_FORMATS))
@pytest.mark.usefixtures("one_torch_thread")
def test_textured_frame_matches_jax_renderer(fmt, tmp_path):
    data, name = FRAME_FORMATS[fmt](scenes.texture_image(64, seed=1))
    path = scenes.helmet_with_texture(str(tmp_path), data, name)
    gltf = json.loads(open(path).read())
    assert gltf["images"] == [{"uri": name}]
    hdr = scenes.write_synthetic_hdr(tmp_path / "env.hdr", 64, 128)
    img_r, aux_r = _frame(JaxRenderer(W, H, spp=1, max_depth=DEPTH), path, hdr)
    r = GltfRenderer(W, H, spp=1, max_depth=DEPTH, device="cpu")
    img_p, aux_p = _frame(r, path, hdr)
    assert r.dev_scene.tex_desc[0, 1:3].tolist() == [64, 64]  # the decoded texture, not a white texel
    assert img_p.shape == (H, W, 3) and np.isfinite(img_p).all() and img_p.mean() > 0.01
    ids = (aux_p["first_rnode"] == aux_r["first_rnode"]) & (aux_p["first_tri"] == aux_r["first_tri"])
    assert ids.mean() >= 0.999
    close = (np.abs(img_p - img_r) <= 1e-3 * (1.0 + np.abs(img_r))).all(axis=-1)
    assert close.mean() >= 0.99
    np.testing.assert_allclose(img_p.mean(axis=(0, 1)), img_r.mean(axis=(0, 1)), rtol=1e-3)
    assert float(aux_p["rays"]) == float(aux_r["rays"]) > W * H


@pytest.mark.parametrize("case", ["dds_bgra8", "ktx2_rgba8", "ktx2_zlib"])
def test_lossless_containers_give_the_png_texture_pool(case, tmp_path):
    """The texels of a lossless container, and so the whole mip chain,
    equal the PNG texture's bit for bit (chip_smoke.py phase 20 (b) holds
    their frames equal on the card)."""
    from vk_gltf_renderer_tpu_torch.utils.png import encode_png

    img = scenes.texture_image(64, seed=6)
    pools = []
    suffix = ".dds" if case.startswith("dds") else ".ktx2"
    for data, name in ((encode_png(img), "base.png"), (SEEDED_INPUTS[case](img), "base" + suffix)):
        sc = TScene()
        sc.load(scenes.helmet_with_texture(str(tmp_path), data, name))
        pools.append(ttextures.build_texture_pool(sc.model))
    for a, b in zip(*pools):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("shape", [(23, 37), (1, 5), (6, 1), (2, 2)])
def test_texture_pool_matches_reference_at_odd_sizes(shape, tmp_path):
    """The port's in-place quad packing gives the reference's pool (its
    rolls and concatenations) bit for bit, wrap rows and columns too."""
    from vk_gltf_renderer_tpu_torch.utils.png import encode_png

    img = np.random.default_rng(shape[0] * 7 + shape[1]).integers(0, 256, shape + (3,), dtype=np.uint8)
    path = scenes.helmet_with_texture(str(tmp_path), encode_png(img), "odd.png")
    pools = []
    for Scene, build in ((JScene, jtextures.build_texture_pool), (TScene, ttextures.build_texture_pool)):
        sc = Scene()
        sc.load(path)
        pools.append([np.asarray(a) for a in build(sc.model)])
    for a, b in zip(*pools):
        assert a.dtype == b.dtype and np.array_equal(a, b)


if __name__ == "__main__":
    # the shares PERF.md quotes: `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_codecs.py`
    for name in sorted(JPEG_CASES):
        data = JPEG_CASES[name]()
        ref = np.rint(jtextures.decode_image(_model(data), {"bufferView": 0}) * 255)
        port = np.rint(ttextures.decode_image(_model(data), {"bufferView": 0}) * 255)
        print(f"{name}: max diff {int(np.abs(port - ref).max())}/255, samples equal {(port == ref).mean():.6f}")
    for seed in (0, 1):
        img = scenes.texture_image(256, seed=seed)
        ours = np.asarray(PIL_Image.open(io.BytesIO(jpeg.encode_jpeg(img))).convert("RGB"))
        pillow = np.asarray(PIL_Image.open(io.BytesIO(_pillow_jpeg(img))).convert("RGB"))
        print(f"writer seed {seed}: PSNR {_psnr(img, ours):.4f} dB, Pillow's own q75 {_psnr(img, pillow):.4f} dB")
