"""The port's WebP codec (ops/webp.py, native/webp_decode.cpp) against
Pillow 12.1.0 with libwebp 1.6.0, on the CPU.

Decoding is bit for bit: the port's RGBA equals Image.open(f).convert(
"RGBA") on every file here, and the port's texture decode_image equals the
JAX package's (which reads through Pillow). The files: lossy at several
qualities and odd sizes (1x1, 33x17, ...); lossy with alpha as Pillow
writes it, and with ALPH chunks assembled here for every compression (raw,
VP8L) and filter (none, horizontal, vertical, gradient), which Pillow
cannot be asked for; lossless photos (predictor, colour and subtract-green
transforms, the colour cache) and palettes of 2, 3, 4, 16, 200 and 256
colours (colour indexing with 8, 4, 2 and 1 pixels a byte); VP8X files with
ICC, EXIF and XMP chunks; animations (frame 0 on a transparent canvas,
also at an offset); the committed fixtures of tests/data/webp against
their digests. A truncated file is a ValueError, and both packages' texture
pools make it white. The port's lossless writer's files read back exactly
through Pillow and through the port.

Pillow is only a reference here: the port never imports it."""

import ctypes
import hashlib
import io
import json
import struct
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

PIL_Image = pytest.importorskip("PIL.Image")

from vk_gltf_renderer_tpu.ops import textures as jtextures  # noqa: E402
from vk_gltf_renderer_tpu_torch import native  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import textures as ttextures  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import webp  # noqa: E402
from vk_gltf_renderer_tpu_torch.utils.image_io import read_image, write_image  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "data" / "webp"


def smooth(w, h, seed, alpha=False, noise=0.0):
    """A seeded image of low-frequency waves (plus noise, for busier blocks)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32) / max(w, h, 2)
    chans = []
    for _ in range(4 if alpha else 3):
        fx, fy, ph = rng.uniform(1, 6), rng.uniform(1, 6), rng.uniform(0, 6.3)
        chans.append(127.5 + 120 * np.sin(2 * np.pi * (fx * x + fy * y * y) + ph))
    img = np.stack(chans, -1) + rng.normal(0, noise, (h, w, len(chans)))
    return np.clip(img, 0, 255).astype(np.uint8)


def _save(arr_or_img, **kw) -> bytes:
    img = arr_or_img if isinstance(arr_or_img, PIL_Image.Image) else PIL_Image.fromarray(arr_or_img)
    b = io.BytesIO()
    img.save(b, "WEBP", **kw)
    return b.getvalue()


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(PIL_Image.open(io.BytesIO(data)).convert("RGBA"))


def _assert_like_pillow(data: bytes):
    ref = _pillow(data)
    got = webp.decode_webp(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.array_equal(got, ref), int(np.abs(got.astype(int) - ref).max())
    # through the texture path of both packages (float RGBA in [0, 1])
    model = SimpleNamespace(buffer_views=[{"buffer": 0, "byteLength": len(data)}], buffers=[bytearray(data)])
    port = ttextures.decode_image(model, {"bufferView": 0})
    assert np.array_equal(port, np.asarray(jtextures.decode_image(model, {"bufferView": 0})))


LOSSY_SIZES = [(1, 1), (33, 17), (64, 48), (131, 77)]


@pytest.mark.parametrize("quality", [5, 50, 80, 100])
@pytest.mark.parametrize("size", LOSSY_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_lossy_decodes_like_pillow(size, quality):
    _assert_like_pillow(_save(smooth(*size, seed=quality + size[0], noise=8.0), quality=quality))


@pytest.mark.parametrize("size", LOSSY_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_lossy_with_alpha_decodes_like_pillow(size):
    _assert_like_pillow(_save(smooth(*size, seed=3, alpha=True, noise=4.0), quality=70))
    _assert_like_pillow(_save(smooth(*size, seed=4, alpha=True), quality=40, alpha_quality=30))


def _alpha_filter(a: np.ndarray, method: int) -> np.ndarray:
    """The forward ALPH filters: 0 none, 1 horizontal, 2 vertical, 3 gradient."""
    a = a.astype(np.int32)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    if method:
        pred[1:, 0] = a[:-1, 0]
        if method == 1:
            pred[1:, 1:] = a[1:, :-1]
        elif method == 2:
            pred[1:, 1:] = a[:-1, 1:]
        else:
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    else:
        pred[:] = 0
    return ((a - pred) % 256).astype(np.uint8)


def _with_alph(vp8_file: bytes, alpha: np.ndarray, method: int, compressed: bool) -> bytes:
    """A VP8X file of vp8_file's VP8 chunk and an ALPH chunk made here."""
    off = vp8_file.index(b"VP8 ")
    size = struct.unpack_from("<I", vp8_file, off + 4)[0]
    vp8 = vp8_file[off + 8:off + 8 + size]
    h, w = alpha.shape
    filtered = _alpha_filter(alpha, method)
    if compressed:
        argb = 0xFF000000 | (filtered.astype(np.uint32) << 8)
        payload = webp.encode_vp8l_stream(argb, header=False)
    else:
        payload = filtered.tobytes()
    vp8x = bytes([0x10, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
    return webp.riff([(b"VP8X", vp8x), (b"ALPH", bytes([(method << 2) | int(compressed)]) + payload),
                      (b"VP8 ", vp8)])


@pytest.mark.parametrize("compressed", [False, True], ids=["raw", "vp8l"])
@pytest.mark.parametrize("method", [0, 1, 2, 3], ids=["none", "horizontal", "vertical", "gradient"])
def test_assembled_alpha_chunks_decode_like_pillow(method, compressed):
    w, h = 45, 29
    vp8_file = _save(smooth(w, h, seed=7, noise=5.0), quality=60)
    assert vp8_file[12:16] == b"VP8 "
    alpha = smooth(w, h, seed=8)[..., 0]
    alpha[::5, ::3] = 0
    data = _with_alph(vp8_file, alpha, method, compressed)
    got = webp.decode_webp(data)
    assert np.array_equal(got[..., 3], alpha)
    _assert_like_pillow(data)


@pytest.mark.parametrize("kw", [{}, {"quality": 0, "method": 0}, {"quality": 100, "method": 6},
                                {"quality": 50, "exact": True}], ids=["default", "fast", "best", "exact"])
@pytest.mark.parametrize("alpha", [False, True])
def test_lossless_decodes_like_pillow(kw, alpha):
    _assert_like_pillow(_save(smooth(97, 61, seed=11, alpha=alpha, noise=3.0), lossless=True, **kw))


def _palette_file(colours):
    rng = np.random.default_rng(colours)
    pal = rng.integers(0, 256, (colours, 4), dtype=np.uint8)
    pal[:, 3] = np.where(rng.random(colours) < 0.3, rng.integers(0, 256, colours), 255)
    idx = (np.add.outer(np.arange(47), np.arange(61)) // 5 + rng.integers(0, 2, (47, 61))) % colours
    return _save(pal[idx], lossless=True)


@pytest.mark.parametrize("colours", [2, 3, 4, 16, 200, 256])
def test_palettes_decode_like_pillow(colours):
    _assert_like_pillow(_palette_file(colours))


VP8L_FEATURES = ("predictor", "colour", "subtract_green", "colour_indexing", "colour_cache", "meta_codes")


def _vp8l_features(lib, data: bytes) -> set:
    """The VP8L_FEATURES that a file's VP8L chunk reads, through the
    decoder's test-only build (VKGR_WEBP_FEATURES)."""
    payload = data[data.index(b"VP8L") + 8:]
    w, h, _ = webp._vp8l_size(payload)
    buf = np.frombuffer(payload, np.uint8)
    bits = np.zeros(1, np.int32)
    assert lib.vkgr_vp8l_features(webp._ptr(buf), buf.size, w, h, webp._ptr(bits)) == 0
    return {n for i, n in enumerate(VP8L_FEATURES) if int(bits[0]) >> i & 1}


def test_lossless_files_cover_every_feature():
    """The lossless files above read, between them, every VP8L transform,
    the colour cache and meta prefix codes (a build of the decoder with
    VKGR_WEBP_FEATURES reports what a stream read; the shipped library has
    no such entry)."""
    lib = native._load_coder(native._WEBP_SRC, {"vkgr_vp8l_features": [ctypes.c_void_p, ctypes.c_int64]
                                                 + [ctypes.c_int32] * 2 + [ctypes.c_void_p]},
                             defines=("VKGR_WEBP_FEATURES",))
    assert not hasattr(native.webp_lib(), "vkgr_vp8l_features")
    seen = set()
    for kw in ({}, {"quality": 0, "method": 0}, {"quality": 100, "method": 6}, {"quality": 50, "exact": True}):
        for alpha in (False, True):
            seen |= _vp8l_features(lib, _save(smooth(97, 61, seed=11, alpha=alpha, noise=3.0), lossless=True, **kw))
    for colours in (2, 3, 4, 16, 200, 256):
        seen |= _vp8l_features(lib, _palette_file(colours))
    assert seen == set(VP8L_FEATURES), seen


def test_metadata_chunks_are_skipped():
    meta = {"exif": b"Exif\0\0" + bytes(range(40)), "xmp": b"<x:xmpmeta/>", "icc_profile": bytes(130)}
    for kw in ({"quality": 60}, {"lossless": True}):
        data = _save(smooth(40, 30, seed=2, alpha=True), **kw, **meta)
        assert data[12:16] == b"VP8X" and b"ICCP" in data and b"EXIF" in data and b"XMP " in data
        _assert_like_pillow(data)


@pytest.mark.parametrize("kw", [{"quality": 70}, {"lossless": True}])
@pytest.mark.parametrize("alpha", [False, True])
def test_animation_decodes_its_first_frame(kw, alpha):
    frames = [PIL_Image.fromarray(smooth(48, 32, seed=s, alpha=alpha)) for s in range(3)]
    data = _save(frames[0], save_all=True, append_images=frames[1:], duration=40, **kw)
    assert b"ANMF" in data
    _assert_like_pillow(data)


def test_animation_frame_at_an_offset():
    """Frame 0 smaller than the canvas, at (4, 2): transparent black around it."""
    frame = webp.encode_vp8l_stream(0xFF000000 | np.arange(20 * 10, dtype=np.uint32).reshape(10, 20) * 997)
    vp8x = bytes([0x12, 0, 0, 0]) + (31).to_bytes(3, "little") + (15).to_bytes(3, "little")
    anim = bytes(4) + struct.pack("<H", 0)
    anmf = ((2).to_bytes(3, "little") + (1).to_bytes(3, "little") + (19).to_bytes(3, "little")
            + (9).to_bytes(3, "little") + (100).to_bytes(3, "little") + b"\0"
            + b"VP8L" + struct.pack("<I", len(frame)) + frame + b"\0" * (len(frame) & 1))
    data = webp.riff([(b"VP8X", vp8x), (b"ANIM", anim), (b"ANMF", anmf)])
    got = webp.decode_webp(data)
    assert got.shape == (16, 32, 4) and (got[:2] == 0).all() and (got[2:12, 4:24, 3] == 255).all()
    _assert_like_pillow(data)


@pytest.mark.parametrize("name", sorted(json.loads((FIXTURES / "digests.json").read_text())["files"]))
def test_fixtures_match_their_digests_and_pillow(name):
    meta = json.loads((FIXTURES / "digests.json").read_text())["files"][name]
    data = (FIXTURES / name).read_bytes()
    got = webp.decode_webp(data)
    assert list(got.shape) == meta["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == meta["sha256"]
    _assert_like_pillow(data)


@pytest.mark.parametrize("fraction", [0.05, 0.5, 0.99])
def test_truncated_files_raise_value_error(fraction):
    for data in (_save(smooth(64, 64, seed=1), quality=80), _save(smooth(64, 64, seed=1), lossless=True)):
        with pytest.raises(ValueError):
            webp.decode_webp(data[:int(len(data) * fraction)])
        with pytest.raises(Exception):  # Pillow refuses it too
            _pillow(data[:int(len(data) * fraction)])


@pytest.mark.parametrize("shape", [(1, 1, 3), (17, 33, 3), (40, 64, 4), (9, 5), (12, 7, 2)])
def test_written_webp_reads_back_exactly(shape, tmp_path):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    if len(shape) == 3 and shape[2] == 3:
        img = smooth(shape[1], shape[0], seed=5, noise=20.0)
    p = tmp_path / "out.webp"
    write_image(p, img)
    data = p.read_bytes()
    assert data[12:16] == b"VP8L"  # lossless
    rgba = img if img.ndim == 3 else img[..., None]
    c = rgba.shape[2]
    rgb = rgba[..., :3] if c >= 3 else np.repeat(rgba[..., :1], 3, axis=2)
    alpha = rgba[..., -1] if c in (2, 4) else np.full(rgba.shape[:2], 255, np.uint8)
    want = np.concatenate([rgb, alpha[..., None]], axis=2)
    assert np.array_equal(_pillow(data), want)
    assert np.array_equal(read_image(data), want)
