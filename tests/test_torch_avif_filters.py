"""CDEF and loop restoration in the port's AVIF reader (ops/avif.py over
native/av1_decode.cpp) against Pillow 12.1.0 (libavif 1.3.0, dav1d 1.5.1)
and the JAX package, on the CPU.

- Every fixture of make_fixtures.avif_filters (tests/data/images/
  avif_filters_*: aom's speeds 0-2 with enable-cdef=1, a quality ladder at
  4:4:4, 4:2:2 and 4:2:0, RGBA, the odd sizes, 2x2 and 1x4 tiles, 64x64 and
  128x128 superblocks; and avif_refused_cdef.avif and
  avif_refused_loop_restoration.avif, the names from when the port refused
  them) and the 2048x2048 CDEF and loop restoration map decode to Pillow's
  pixels bit for bit, through utils/image_io and through the texture
  decoder: AV1 decoding has no tolerance. A header check holds that each is
  lossy, not refused, and filtered by CDEF or loop restoration (but the 1x1
  frames, at which aom's search finds no CDEF strength).
- The set as a whole holds CDEF with y and uv strengths, at 4:2:2, in
  128x128 superblocks, in tiled frames and in an alpha item, and loop
  restoration of every frame type (Wiener, self-guided, switchable) on luma
  and on chroma, at every unit size; what no aom encode here writes is
  listed in ROADMAP A7.
- 150 seeded mutations of the 128x96 and 200x150 fixtures decode or fail as
  Pillow does, under the bounds of tests/test_torch_avif.py's mutation test.
  They found that libavif reads an iloc extent of length 0 as no bytes (not
  as the rest of the file, which ops/avif.py read before): a test holds it.
- A glTF whose base colour is a CDEF and loop restoration AVIF renders a
  48x32 frame that agrees with the JAX renderer's at
  tests/test_torch_frame.py's thresholds.

Pillow is only a reference here: the port never imports it."""

import hashlib
import io
import json
import re
import struct
from pathlib import Path

import numpy as np
import pytest

PIL_Image = pytest.importorskip("PIL.Image")

from vk_gltf_renderer_tpu.ops import textures as jtextures  # noqa: E402
from vk_gltf_renderer_tpu.renderer import GltfRenderer as JaxRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch import scenes  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import avif  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import textures as ttextures  # noqa: E402
from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch.utils.image_io import identify_and_read, read_image  # noqa: E402
from test_torch_avif import _av1_items, _frame, _model, _rgba, mutation_outcomes  # noqa: E402
from torch_test_helpers import one_torch_thread, share_native_builder  # noqa: E402, F401 (a fixture)

share_native_builder()

FIXTURES = Path(__file__).resolve().parent / "data" / "images"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
SMALL = sorted(n for n in DIGESTS["files"] if n.startswith("avif_filters_")) + [
    "avif_refused_cdef.avif", "avif_refused_loop_restoration.avif"]
FILTERED = SMALL + ["avif_map_2048_cdef_lr.avif"]


def _entry(name):
    return DIGESTS["files"].get(name) or DIGESTS["large"][name]


def _filtered(h):
    return h["cdef_strength"] > 0 or h["lr_planes"] > 0


@pytest.mark.parametrize("name", FILTERED)
def test_filtered_fixture_decodes_to_pillows_pixels(name):
    data = (FIXTURES / name).read_bytes()
    headers = [avif.av1_header(obus) for obus in _av1_items(data)]
    for h in headers:
        assert h["base_q_idx"] > 0 and not h["refused"], (name, h)
    assert _filtered(headers[0]) or (headers[0]["w"], headers[0]["h"]) == (1, 1), (name, headers[0])
    if "filters" in name:
        assert headers[0]["enable_cdef"] == 1
    entry = _entry(name)
    fmt, img = identify_and_read(data)
    rgba = np.ascontiguousarray(_rgba(img))
    assert fmt == "AVIF" and list(rgba.shape) == entry["shape"]
    assert hashlib.sha256(rgba.tobytes()).hexdigest() == entry["sha256"]
    assert np.array_equal(read_image(data), img)
    tex = np.asarray(ttextures.decode_image(_model(data), {"bufferView": 0}))  # float RGBA in [0, 1]
    assert hashlib.sha256(np.rint(tex * 255).astype(np.uint8).tobytes()).hexdigest() == entry["sha256"]
    if name in SMALL:
        ref = np.asarray(PIL_Image.open(io.BytesIO(data)))
        assert img.shape == ref.shape and np.array_equal(img, ref)
        assert np.array_equal(tex, np.asarray(jtextures.decode_image(_model(data), {"bufferView": 0})))


def test_filtered_fixtures_cover_cdef_and_every_restoration_type():
    seen = set()
    for name in FILTERED:
        for k, obus in enumerate(_av1_items((FIXTURES / name).read_bytes())):
            h = avif.av1_header(obus)
            if h["cdef_strength"]:
                seen.add("cdef")
                seen.add(("cdef", h["ssx"], h["ssy"]))
                if h["cdef_y_strength"]:
                    seen.add("cdef y")
                if h["cdef_uv_strength"]:
                    seen.add("cdef uv")
                if h["sb128"]:
                    seen.add("cdef sb128")
                if h["tile_cols"] * h["tile_rows"] > 1:
                    seen.add("cdef tiles")
                if k:
                    seen.add("cdef alpha")
            for plane, key in enumerate(("lr_type_y", "lr_type_u", "lr_type_v")):
                if h[key]:
                    seen.add((avif.LR_TYPES[h[key]], "luma" if plane == 0 else "chroma"))
                    seen.add(("unit", h["lr_unit_y"]))
                    if plane:
                        seen.add(("uv shift", h["lr_uv_shift"]))
                        assert h["lr_unit_uv"] == h["lr_unit_y"] >> h["lr_uv_shift"]
            if h["lr_planes"] and k:
                seen.add("lr alpha")
    want = {"cdef", "cdef y", "cdef uv", ("cdef", 0, 0), ("cdef", 1, 0), ("cdef", 1, 1), "cdef sb128", "cdef tiles",
            "cdef alpha", "lr alpha", ("unit", 64), ("unit", 128), ("unit", 256), ("uv shift", 0)}
    want |= {(t, p) for t in ("wiener", "sgrproj", "switchable") for p in ("luma", "chroma")}
    assert want <= seen, want - seen
    assert sum(n.startswith("avif_filters_q") for n in FILTERED) >= 9


@pytest.mark.parametrize("seed", range(8, 10))
def test_mutated_filtered_fixtures_decode_or_fail_as_pillow(seed):
    """75 seeded mutations a seed of the 128x96 and 200x150 CDEF and loop
    restoration fixtures (the odd sizes are mostly headers; tiles and
    superblocks are the lossy test's choice too), held as the lossless ones
    are (test_torch_avif.mutation_outcomes, its bounds)."""
    names = sorted(n for n in SMALL if not re.search(r"_\d+x\d+\.avif$|tiles|sb", n))
    mutation_outcomes(seed, names)


def test_an_extent_of_length_zero_adds_no_bytes():
    """libavif sums an item's extent lengths as they stand, so an extent of
    length 0 adds nothing (it is not the rest of the file), and a primary
    item whose one extent has length 0 is empty: Pillow fails ("Missing or
    empty image item"), and so does the port; both texture pools make it
    white."""
    data = bytearray((FIXTURES / "avif_filters_q60_420.avif").read_bytes())
    at = data.index(b"iloc") + 4  # version and flags, sizes, item count, then the first item
    assert data[at] == 0 and data[at + 4] == 0x44 and struct.unpack_from(">HH", data, at + 6) == (1, 1)
    assert struct.unpack_from(">H", data, at + 12)[0] == 1  # one extent: its offset, then its length
    assert struct.unpack_from(">II", data, at + 14)[1] > 0
    struct.pack_into(">I", data, at + 18, 0)
    data = bytes(data)
    with pytest.raises(RuntimeError, match="Missing or empty image item"):
        PIL_Image.open(io.BytesIO(data)).load()
    with pytest.raises(ValueError):
        identify_and_read(data)
    with pytest.raises(Exception):  # noqa: B017 - whatever Pillow raises, the reference's pool makes it white
        jtextures.decode_image(_model(data), {"bufferView": 0})
    with pytest.raises(ValueError):
        ttextures.decode_image(_model(data), {"bufferView": 0})


W, H, DEPTH = 48, 32, 5


@pytest.mark.usefixtures("one_torch_thread")
def test_filtered_avif_textured_frame_matches_jax_renderer(tmp_path):
    buf = io.BytesIO()
    PIL_Image.fromarray(scenes.texture_image(64, seed=1)).save(buf, "AVIF", quality=75, speed=1, max_threads=1,
                                                             advanced=[("enable-cdef", "1")])
    data = buf.getvalue()
    h = avif.av1_header(_av1_items(data)[0])
    assert h["cdef_strength"] > 0 and h["lr_planes"] > 0 and not h["refused"], h
    path = scenes.helmet_with_texture(str(tmp_path), data, "base.avif")
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
