"""Lossy AVIF in the port (ops/avif.py over native/av1_decode.cpp) against
Pillow 12.1.0 (libavif 1.3.0, dav1d 1.5.1) and the JAX package, on the CPU.

- Every lossy fixture (tests/data/images/avif_lossy_* and
  avif_refused_q75.avif, the name from when the port refused it: a quality
  ladder at 4:4:4, 4:2:2 and 4:2:0, a lossy alpha item, odd sizes, tiles,
  64x64 and 128x128 superblocks, speeds 5-10, aom's transform switches, the
  deblocking filter off and sharpened, CDEF on at strength 0) and the
  2048x2048 map decodes to Pillow's pixels bit for bit, through
  utils/image_io and through the texture decoder: AV1 decoding has no
  tolerance. A header check holds that each is lossy and uses no tool the
  decoder refuses, and the set as a whole every subsampling, a lossy alpha
  item, both superblock sizes, the loop filter on and off, and both
  transform modes.
- 300 seeded mutations of the small lossy fixtures decode or fail as Pillow
  does, under the bounds of tests/test_torch_avif.py's mutation test.
- ROADMAP C5 stays a kept divergence: libavif scales a frame whose size is
  not its ispe to the ispe size (libyuv's ScalePlane on each plane), which
  the port does not do; the test shows Pillow's pixels are that resampling
  and not the frame's bytes re-read at the ispe width.
- A pixi box of no channels or too many fails where Pillow's fails.
- A glTF whose base colour is a lossy AVIF renders a 48x32 frame that
  agrees with the JAX renderer's at tests/test_torch_frame.py's thresholds.

Pillow is only a reference here: the port never imports it."""

import hashlib
import io
import json
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
from vk_gltf_renderer_tpu_torch.ops.dds import UnsupportedCodec  # noqa: E402
from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch.utils.image_io import identify_and_read, read_image  # noqa: E402
from test_torch_avif import _av1_items, _frame, _model, _rgba, mutation_outcomes  # noqa: E402
from torch_test_helpers import one_torch_thread, share_native_builder  # noqa: E402, F401 (a fixture)

share_native_builder()

FIXTURES = Path(__file__).resolve().parent / "data" / "images"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
SMALL = sorted(n for n in DIGESTS["files"] if n.startswith("avif_lossy_")) + ["avif_refused_q75.avif"]
LOSSY = SMALL + sorted(n for n in DIGESTS["large"] if n.startswith("avif_map_") and "lossy" in n)


def _entry(name):
    return DIGESTS["files"].get(name) or DIGESTS["large"][name]


@pytest.mark.parametrize("name", LOSSY)
def test_lossy_fixture_decodes_to_pillows_pixels(name):
    data = (FIXTURES / name).read_bytes()
    for obus in _av1_items(data):
        h = avif.av1_header(obus)
        assert h["base_q_idx"] > 0 and not h["lossless"] and not h["refused"], (name, h)
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


def test_lossy_fixtures_cover_the_forms_pillow_writes():
    seen = set()
    for name in LOSSY:
        items = _av1_items((FIXTURES / name).read_bytes())
        h = avif.av1_header(items[0])
        seen.add((h["ssx"], h["ssy"]))
        seen.add(("sb128", h["sb128"]))
        seen.add(("filtered", h["lf_y_v"] > 0 or h["lf_y_h"] > 0))
        seen.add(("tx_mode_select", h["tx_mode_select"]))
        seen.add(("reduced_tx_set", h["reduced_tx_set"]))
        if h["sharpness"]:
            seen.add("sharpness")
        # the deblocking filter is each one's only loop filter (tests/test_torch_avif_filters.py holds CDEF and
        # loop restoration); CDEF may be on at strength 0
        assert h["cdef_strength"] == 0 and h["lr_planes"] == 0, name
        if h["enable_cdef"]:
            seen.add("cdef at strength 0")
        if len(items) > 1:
            a = avif.av1_header(items[1])
            assert a["mono"] == 1 and a["base_q_idx"] > 0
            seen.add("lossy alpha")
    assert {(0, 0), (1, 0), (1, 1), ("sb128", 0), ("sb128", 1), ("filtered", True), ("filtered", False),
            ("tx_mode_select", 0), ("tx_mode_select", 1), ("reduced_tx_set", 1), "sharpness", "cdef at strength 0",
            "lossy alpha"} <= seen, seen
    assert sum(n.startswith("avif_lossy_q") for n in LOSSY) >= 21


@pytest.mark.parametrize("seed", range(4, 8))
def test_mutated_lossy_fixtures_decode_or_fail_as_pillow(seed):
    """75 seeded mutations a seed of the small lossy fixtures, held as the
    lossless ones are (test_torch_avif.mutation_outcomes, its bounds)."""
    names = sorted(n for n in SMALL if "tiles" not in n and "sb" not in n and "speed0" not in n)
    mutation_outcomes(seed, names)


def _with_ispe(data: bytes, w: int, h: int) -> bytes:
    """The file with its first ispe box (the primary item's) set to w x h."""
    at = data.index(b"ispe") + 8  # past the type and the full box's version and flags
    return data[:at] + struct.pack(">II", w, h) + data[at + 8 :]


def test_c5_a_frame_of_another_size_is_scaled_to_its_ispe():
    """ROADMAP C5, a kept divergence. Where the AV1 frame's size is not the
    ispe's, libavif 1.3.0 scales the decoded planes to the ispe size
    (avifImageScaleWithLimit, libyuv's ScalePlane) before Pillow reads them.
    Pillow's pixels are then not the frame's RGB bytes re-read as rows of the
    ispe width (there are too few of them), nor the frame padded or cropped,
    but a resampling of the frame; the port, which has no copy of libyuv's
    scaler, refuses the file with ValueError."""
    data = (FIXTURES / "avif_lossy_q90_444.avif").read_bytes()
    frame = identify_and_read(data)[1]
    fh, fw = frame.shape[:2]
    taller = _with_ispe(data, fw, fh + 16)
    ref = np.asarray(PIL_Image.open(io.BytesIO(taller)))
    assert ref.shape == (fh + 16, fw, 3)
    assert frame.size < ref.size  # the frame's bytes cannot fill the ispe image
    assert not np.array_equal(ref[:fh], frame)  # not the frame padded
    # each row of Pillow's image is close to the frame row at the same relative height
    rows = np.minimum((np.arange(fh + 16) + 0.5) * fh / (fh + 16), fh - 1).astype(int)
    diff = np.abs(ref.astype(int) - frame[rows].astype(int))
    assert diff.mean() < 6, diff.mean()
    narrower = _with_ispe(data, fw - 32, fh)
    ref = np.asarray(PIL_Image.open(io.BytesIO(narrower)))
    assert ref.shape == (fh, fw - 32, 3) and not np.array_equal(ref, frame[:, : fw - 32])  # not a crop
    for mutated in (taller, narrower):  # the reference textures the scaled image; the port's pool a white texel
        with pytest.raises(ValueError, match="ispe"):
            identify_and_read(mutated)
        jtex = np.asarray(jtextures.decode_image(_model(mutated), {"bufferView": 0}))
        assert np.array_equal(np.rint(jtex[..., :3] * 255).astype(np.uint8),
                              np.asarray(PIL_Image.open(io.BytesIO(mutated)).convert("RGB")))


@pytest.mark.parametrize("channels", [0, 1, 4, 5])
def test_pixi_channel_counts_fail_where_pillow_fails(channels):
    """libavif refuses a pixi box of no channels or more than four as not
    implemented (Pillow's open raises RuntimeError and tries no other
    plugin: the port's ValueError); four channels in a box that holds three
    run past it (a parse failure: Pillow tries the next plugin, and none
    takes the file)."""
    data = bytearray((FIXTURES / "avif_lossy_422_7x5.avif").read_bytes())
    data[data.index(b"pixi") + 8] = channels  # num_channels, past the full box's version and flags
    data = bytes(data)
    if channels == 1:
        ref = np.asarray(PIL_Image.open(io.BytesIO(data)))
        assert np.array_equal(identify_and_read(data)[1], ref)
    elif channels == 4:
        with pytest.raises(PIL_Image.UnidentifiedImageError):
            PIL_Image.open(io.BytesIO(data))
        with pytest.raises(UnsupportedCodec, match="cannot identify"):
            identify_and_read(data)
    else:
        with pytest.raises(RuntimeError, match="Not implemented"):
            PIL_Image.open(io.BytesIO(data))
        with pytest.raises(ValueError, match="pixi"):
            identify_and_read(data)


W, H, DEPTH = 48, 32, 5


@pytest.mark.usefixtures("one_torch_thread")
def test_lossy_avif_textured_frame_matches_jax_renderer(tmp_path):
    buf = io.BytesIO()
    PIL_Image.fromarray(scenes.texture_image(64, seed=1)).save(buf, "AVIF", quality=50, max_threads=1)
    data = buf.getvalue()
    assert avif.av1_header(_av1_items(data)[0])["base_q_idx"] > 0
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
