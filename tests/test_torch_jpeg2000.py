"""The port's JPEG 2000 reader (ops/jpeg2000.py over native/j2k_decode.cpp)
against Pillow 12.1.0 (OpenJPEG 2.5.4) and the JAX package, on the CPU.

- A matrix of files that Pillow's encoder writes from seeded images
  (reversible and irreversible, every progression, precincts, code-block
  sizes from 4x4 to 64x64, one to seven resolutions, tiles with image and
  tile offsets, quality layers, PLT markers, the multiple component
  transform off, odd sizes down to one row or one column, L, LA, RGB, RGBA,
  16-bit I;16 and signed samples, raw codestreams and JP2 files) decodes in
  the port's texture decode_image to the same pixels as in the JAX
  package's (Pillow through OpenJPEG): tolerance 0, 9/7 included.
- JP2 files whose boxes are written here (colour spaces, palettes, channel
  definitions, boxes the header walk skips, broken box lengths) decode or
  are refused as Pillow decodes or refuses them.
- Codestreams cut short, with or without an EOC, and with bytes flipped in
  their packet data, and 400 seeded random mutations of the committed
  fixtures, are white in both packages or decode alike.
- The JPEG 2000 coder library that fails to build fails the scene load.

The committed fixtures (tests/data/images, digests.json) are held to
Pillow in tests/test_torch_images.py. Pillow is only a reference here:
the port never imports it."""

import io
import random
import shutil
import struct
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

PIL_Image = pytest.importorskip("PIL.Image")

from vk_gltf_renderer_tpu.ops import textures as jtextures  # noqa: E402
from vk_gltf_renderer_tpu_torch import native, scenes  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import textures as ttextures  # noqa: E402
from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch.utils.image_io import identify_and_read  # noqa: E402
from torch_test_helpers import share_native_builder  # noqa: E402

share_native_builder()


def _model(data):
    return {"bufferView": 0}, SimpleNamespace(buffer_views=[{"buffer": 0, "byteOffset": 0, "byteLength": len(data)}],
                                              buffers=[data], base_dir=None)


def _both(data):
    """(the JAX package's decode or None, the port's decode or None): None where a package refuses."""
    tex, model = _model(data)
    try:
        ref = np.asarray(jtextures.decode_image(model, tex))
    except Exception:  # noqa: BLE001 - whatever Pillow raises, the reference's pool makes the texel white
        ref = None
    try:
        got = ttextures.decode_image(model, tex)
    except ValueError:
        got = None
    return ref, got


def _image(kind, w, h, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32) / max(w, h, 2)
    planes = [127.5 + 100 * np.sin(2 * np.pi * (rng.uniform(1, 4) * x + rng.uniform(1, 4) * y) + rng.uniform(0, 6))
              + rng.normal(0, 9, (h, w)) for _ in range(4)]
    px = np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)
    if kind == "I;16":
        v = px[..., 0].astype(np.uint16) * 257 ^ rng.integers(0, 256, (h, w)).astype(np.uint16)
        return PIL_Image.frombytes("I;16", (w, h), v.astype("<u2").tobytes())
    if kind == "L":
        return PIL_Image.fromarray(px[..., 0])
    if kind == "LA":
        return PIL_Image.fromarray(px[..., :2], "LA")
    return PIL_Image.fromarray(px[..., : len(kind)], kind)


def _save(img, **kw):
    b = io.BytesIO()
    img.save(b, "JPEG2000", **kw)
    return b.getvalue()


MATRIX = {
    "rev_rgb": ("RGB", 37, 45, {}),
    "irr_rgb": ("RGB", 37, 45, {"irreversible": True}),
    "rev_l_4x4_blocks": ("L", 29, 23, {"codeblock_size": (4, 4)}),
    "irr_l_8x64_blocks": ("L", 70, 41, {"irreversible": True, "codeblock_size": (8, 64)}),
    "irr_rgb_7_resolutions": ("RGB", 130, 70, {"irreversible": True, "num_resolutions": 7}),
    "rev_rgb_precincts_16": ("RGB", 50, 45, {"precinct_size": (16, 16), "codeblock_size": (8, 8),
                                             "num_resolutions": 3}),
    "irr_rgba_rpcl_precincts": ("RGBA", 45, 50, {"irreversible": True, "progression": "RPCL",
                                                   "precinct_size": (32, 16), "codeblock_size": (16, 8),
                                                   "num_resolutions": 4}),
    "rev_rgb_pcrl_tiles": ("RGB", 66, 52, {"progression": "PCRL", "tile_size": (20, 24), "precinct_size": (16, 16),
                                           "codeblock_size": (8, 8)}),
    "irr_rgb_cprl_tiles_offsets": ("RGB", 66, 52, {"irreversible": True, "progression": "CPRL", "tile_size": (32, 32),
                                                   "tile_offset": (5, 3), "offset": (9, 4), "num_resolutions": 3}),
    "irr_rgb_rlcp_layers": ("RGB", 64, 48, {"irreversible": True, "progression": "RLCP", "quality_mode": "rates",
                                            "quality_layers": [60, 20, 6, 2]}),
    "rev_rgb_layers_db": ("RGB", 64, 48, {"quality_mode": "dB", "quality_layers": [30, 45]}),
    "irr_rgb_mct_off_j2k": ("RGB", 31, 33, {"irreversible": True, "mct": 0, "no_jp2": True}),
    "rev_la_j2k": ("LA", 33, 20, {"no_jp2": True}),
    "irr_rgba_plt": ("RGBA", 40, 30, {"irreversible": True, "plt": True}),
    "rev_i16": ("I;16", 37, 45, {}),
    "irr_i16_j2k": ("I;16", 37, 45, {"irreversible": True, "no_jp2": True}),
    "rev_signed_rgb": ("RGB", 21, 19, {"signed": True}),
    "irr_signed_l_j2k": ("L", 21, 19, {"irreversible": True, "signed": True, "no_jp2": True}),
    "rev_one_column": ("RGB", 1, 9, {}),
    "irr_one_column": ("L", 1, 9, {"irreversible": True}),
    "irr_one_row": ("RGB", 9, 1, {"irreversible": True}),
    "irr_two_by_three": ("RGB", 2, 3, {"irreversible": True}),
    "irr_rgb_low_rate": ("RGB", 96, 80, {"irreversible": True, "quality_mode": "rates", "quality_layers": [150]}),
    "irr_rgb_cinema_shape": ("RGB", 64, 48, {"irreversible": True, "progression": "CPRL", "tile_size": (16, 16),
                                             "precinct_size": (16, 16), "codeblock_size": (8, 8)}),
}


@pytest.mark.parametrize("case", sorted(MATRIX))
def test_encoder_matrix_decodes_as_the_jax_package(case):
    kind, w, h, kw = MATRIX[case]
    data = _save(_image(kind, w, h, len(case)), **kw)
    ref, got = _both(data)
    assert ref is not None and got is not None, case
    assert got.shape == ref.shape and np.array_equal(got, ref), (case, int((got != ref).sum()))
    assert identify_and_read(data)[0] == "JPEG2000"


def _box(kind, body):
    return struct.pack(">I", 8 + len(body)) + kind + body


def _jp2(cs, boxes, ftyp=b"jp2 ", after=b""):
    return (_box(b"jP  ", b"\r\n\x87\n") + _box(b"ftyp", ftyp + bytes(4) + ftyp) + _box(b"jp2h", boxes) + after
            + _box(b"jp2c", cs))


def _ihdr(w, h, nc, bpc=7):
    return _box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))


def _colr(enumcs, meth=1):
    return _box(b"colr", struct.pack(">BBBI", meth, 0, 0, enumcs))


CS_RGB = _save(_image("RGB", 23, 17, 1), no_jp2=True, irreversible=True, mct=0)
CS_L = _save(_image("L", 23, 17, 2), no_jp2=True)
CS_RGBA = _save(_image("RGBA", 23, 17, 3), no_jp2=True, mct=0)
PCLR = _box(b"pclr", struct.pack(">HB", 3, 3) + bytes([7, 7, 7]) + bytes([10, 20, 30, 200, 100, 50, 10, 20, 30]))
BOXES = {
    "srgb": _jp2(CS_RGB, _ihdr(23, 17, 3) + _colr(16)),
    "sycc": _jp2(CS_RGB, _ihdr(23, 17, 3) + _colr(18)),
    "e_sycc": _jp2(CS_RGB, _ihdr(23, 17, 3) + _colr(24)),
    "no_colr": _jp2(CS_RGB, _ihdr(23, 17, 3)),
    "icc_colr": _jp2(CS_RGB, _ihdr(23, 17, 3) + _box(b"colr", bytes([2, 0, 0]) + bytes(128))),
    "two_colr": _jp2(CS_RGB, _ihdr(23, 17, 3) + _colr(18) + _colr(16)),
    "gray_one_component": _jp2(CS_L, _ihdr(23, 17, 1) + _colr(17)),
    "srgb_one_component": _jp2(CS_L, _ihdr(23, 17, 1) + _colr(16)),
    "ihdr_says_three_of_one": _jp2(CS_L, _ihdr(23, 17, 3) + _colr(17)),
    "ihdr_size_differs": _jp2(CS_RGB, _ihdr(40, 9, 3) + _colr(16)),
    "cmyk": _jp2(CS_RGBA, _ihdr(23, 17, 4) + _colr(12)),
    "cmyk_icc": _jp2(CS_RGBA, _ihdr(23, 17, 4) + _box(b"colr", bytes([2, 0, 0]) + bytes(64))),
    "rgba_srgb": _jp2(CS_RGBA, _ihdr(23, 17, 4) + _colr(16)),
    "pclr_cmap": _jp2(CS_L, _ihdr(23, 17, 1) + _colr(16) + PCLR
                      + _box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, i) for i in range(3)))),
    "pclr_gray_colr": _jp2(CS_L, _ihdr(23, 17, 1) + _colr(17) + PCLR),
    "pclr_16_bit_entries": _jp2(CS_L, _ihdr(23, 17, 1) + _colr(16)
                                + _box(b"pclr", struct.pack(">HB", 1, 3) + bytes([15, 15, 15]) + bytes(6))),
    "bpcc_and_res": _jp2(CS_RGB, _ihdr(23, 17, 3, 255) + _box(b"bpcc", bytes([7, 7, 7])) + _colr(16)
                         + _box(b"res ", _box(b"resc", struct.pack(">HHHHBB", 72, 1, 72, 1, 0, 0)))),
    "jpx_brand": _jp2(CS_RGB, _ihdr(23, 17, 3) + _colr(16), ftyp=b"jpx "),
    "box_between": _jp2(CS_RGB, _ihdr(23, 17, 3) + _colr(16), after=_box(b"xml ", b"<x/>")),
    "ihdr_not_first": _jp2(CS_RGB, _colr(16) + _ihdr(23, 17, 3)),
    "jp2h_box_too_long": _box(b"jP  ", b"\r\n\x87\n") + _box(b"ftyp", b"jp2 " + bytes(4) + b"jp2 ")
    + struct.pack(">I", 4000) + b"jp2h" + _ihdr(23, 17, 3) + _colr(16),
    "no_codestream_box": _box(b"jP  ", b"\r\n\x87\n") + _box(b"ftyp", b"jp2 " + bytes(4) + b"jp2 ")
    + _box(b"jp2h", _ihdr(23, 17, 3) + _colr(16)),
    "zero_length_box_first": _box(b"jP  ", b"\r\n\x87\n") + struct.pack(">I", 0) + b"ftyp" + CS_RGB,
}


@pytest.mark.parametrize("case", sorted(BOXES))
def test_jp2_boxes_decode_or_fail_as_pillow(case):
    ref, got = _both(BOXES[case])
    if ref is None:
        assert got is None, case
    else:
        assert got is not None and got.shape == ref.shape and np.array_equal(got, ref), case


CUT = {"rev_tiles": _save(_image("RGB", 48, 40, 4), tile_size=(24, 24), quality_mode="rates", quality_layers=[8, 2]),
       "irr_layers_j2k": _save(_image("RGB", 48, 40, 5), irreversible=True, no_jp2=True, quality_mode="rates",
                               quality_layers=[20, 5, 1])}


@pytest.mark.parametrize("name", sorted(CUT))
def test_damaged_codestreams_fail_or_decode_as_the_jax_package(name):
    """Cut at an eighth to seven eighths, with and without an EOC appended,
    and with one byte flipped in the packet data: both refuse (OpenJPEG's
    strict mode fails a segment past the tile's data) or give the same
    pixels."""
    data = CUT[name]
    sod = data.index(b"\xff\x93")
    cases = {}
    for k in range(1, 8):
        cut = data[: len(data) * k // 8]
        cases[f"cut_{k}_8"], cases[f"cut_{k}_8_eoc"] = cut, cut + b"\xff\xd9"
    for k in (1, 3, 7):
        at = sod + 2 + (len(data) - sod) * k // 9
        flipped = bytearray(data)
        flipped[at] ^= 0x5A
        cases[f"flip_{k}_9"] = bytes(flipped)
    for kind, damaged in cases.items():
        ref, got = _both(damaged)
        if ref is None:
            assert got is None, (name, kind)
        else:
            assert got is not None and got.shape == ref.shape and np.array_equal(got, ref), (name, kind)


FIXTURES = Path(__file__).resolve().parent / "data" / "images"


@pytest.mark.parametrize("seed", range(4))
def test_mutated_fixtures_decode_or_fail_as_pillow(seed):
    """100 seeded mutations of the committed JPEG 2000 fixtures (one to
    three bits flipped, a byte of the first 160 set, the data cut): the
    port's texture decode refuses exactly the ones the JAX package's
    (Pillow's) refuses and decodes the others to its pixels. These mutations taught the decoder OpenJPEG's rules
    for damaged headers (EPH required, tile-parts in order, exact marker
    lengths, where a marker may stand, the search past an unknown one)."""
    rng = random.Random(seed)
    names = sorted(p.name for p in FIXTURES.glob("j2k_*") if "_map_" not in p.name and "refused" not in p.name)
    for i in range(100):
        name = rng.choice(names)
        d = bytearray((FIXTURES / name).read_bytes())
        kind = rng.choice(["flip", "head", "cut"])
        if kind == "flip":
            for _ in range(rng.randint(1, 3)):
                d[rng.randrange(len(d))] ^= 1 << rng.randrange(8)
        elif kind == "head":
            d[rng.randrange(min(len(d), 160))] = rng.randrange(256)
        else:
            d = d[: rng.randrange(len(d))]
        ref, got = _both(bytes(d))
        if ref is None:
            assert got is None, (name, kind, i)
        else:
            assert got is not None and got.shape == ref.shape and np.array_equal(got, ref), (name, kind, i)


def test_j2k_coder_that_fails_to_build_raises(monkeypatch, tmp_path):
    """The JPEG 2000 decoder has no Python stand-in: a failed build fails
    the scene load (no white texel in its place)."""
    data = _save(_image("RGB", 16, 16, 6))
    path = scenes.helmet_with_texture(str(tmp_path), data, "t.jp2")

    def broken(src, defines=()):
        raise native.subprocess.CalledProcessError(1, ["g++"], stderr=b"j2k_decode.cpp: error")

    monkeypatch.setattr(native, "_j2k", None)
    monkeypatch.setattr(native, "_compile", broken)
    with pytest.raises(RuntimeError, match="j2k_decode.cpp failed"):
        GltfRenderer(8, 8, spp=1, max_depth=1, device="cpu").create_scene(path)


def test_nine_seven_lines_keep_openjpegs_float_order(tmp_path):
    """The 9/7 path multiplies and adds as OpenJPEG's generic x86-64 build
    does: the library holds no fused multiply-add however -march=native
    builds it (a fused product would move pixels by one here and there)."""
    lib = native.j2k_lib()
    text = subprocess.run([shutil.which("objdump") or "objdump", "-d", lib._name], capture_output=True, text=True,
                          check=True).stdout
    assert "vkgr_j2k_decode" in text
    assert not any(op in text for op in ("vfmadd", "vfmsub", "vfnmadd", "vfnmsub"))
