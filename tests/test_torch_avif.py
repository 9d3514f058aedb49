"""The port's AVIF reader (ops/avif.py over native/av1_decode.cpp) against
Pillow 12.1.0 (libavif 1.3.0, dav1d 1.5.1, libyuv) and the JAX package, on
the CPU.

- Every coded lossless fixture (tests/data/images/avif_q100_*: 4:4:4,
  4:2:2 and 4:2:0, RGB and RGBA, limited range, irot and imir, items in
  idat, odd sizes and one-row images, uniform tiles, aom's intra tools one
  at a time, every partition shape, 128x128 superblocks; 305,183
  distinct YUV triples) and the 512x512 map decode to Pillow's pixels
  bit for bit, identified as "AVIF"; a header check holds that each one
  (its alpha item too) is coded lossless (base_q_idx 0), so that a fixture
  aom made lossy cannot pass as one.
- The forms the port does not read yet (digests.json's "gaps": quantiser
  matrices, an image sequence, screen content tools) raise UnsupportedCodec
  naming what is not ported, Pillow decodes them to their digests, and the
  texture pool makes them white.
- 300 seeded mutations of the small fixtures (bits flipped, header bytes
  set, data bits flipped, the file cut) decode to Pillow's pixels or fail
  in both, but for the kinds of mutation that ROADMAP lists: AV1 that the
  mutation turned into a form the port does not decode and a colr matrix
  outside libyuv's (UnsupportedCodec; ROADMAP A), and an AV1 frame whose
  size is not its ispe (ROADMAP C5, a kept divergence).
  tests/test_torch_avif_lossy.py holds the lossy fixtures the same way.
- A glTF whose base colour is a lossless AVIF renders a 48x32 frame that
  agrees with the JAX renderer's at tests/test_torch_frame.py's thresholds.
- The AV1 decoder that fails to build fails the scene load.

Pillow is only a reference here: the port never imports it."""

import hashlib
import io
import json
import random
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

PIL_Image = pytest.importorskip("PIL.Image")

from vk_gltf_renderer_tpu.ops import textures as jtextures  # noqa: E402
from vk_gltf_renderer_tpu.renderer import GltfRenderer as JaxRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch import native, scenes  # noqa: E402
from vk_gltf_renderer_tpu_torch.models import Scene as TScene  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import avif  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import textures as ttextures  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops.dds import UnsupportedCodec  # noqa: E402
from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch.utils.image_io import identify_and_read  # noqa: E402
from torch_test_helpers import one_torch_thread, share_native_builder  # noqa: E402, F401 (a fixture)

share_native_builder()

FIXTURES = Path(__file__).resolve().parent / "data" / "images"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
LOSSLESS = sorted(n for g in ("files", "large") for n in DIGESTS[g] if n.startswith("avif_q100_") or
                  (n.startswith("avif_map_") and "lossless" in n))
GAPS = sorted(DIGESTS["gaps"])


def _rgba(img):
    if img.shape[2] == 3:
        return np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    return img


def _av1_items(data):
    """The AV1 data of the primary item and of its alpha item."""
    items, primary, idat = avif._parse(data)
    ids = [primary] + [i for i, it in items.items() if it.get("auxl") == primary]
    return [avif._item_data(data, items[i], idat) for i in ids]


def _model(data):
    return SimpleNamespace(buffer_views=[{"buffer": 0, "byteOffset": 0, "byteLength": len(data)}],
                           buffers=[data], base_dir=None)


@pytest.mark.parametrize("name", LOSSLESS)
def test_lossless_fixture_decodes_to_pillows_pixels(name):
    data = (FIXTURES / name).read_bytes()
    for obus in _av1_items(data):
        assert avif.av1_header(obus)["base_q_idx"] == 0, name
    entry = DIGESTS["files"].get(name) or DIGESTS["large"][name]
    fmt, img = identify_and_read(data)
    rgba = np.ascontiguousarray(_rgba(img))
    assert fmt == "AVIF" and list(rgba.shape) == entry["shape"]
    assert hashlib.sha256(rgba.tobytes()).hexdigest() == entry["sha256"]
    ref = np.asarray(PIL_Image.open(io.BytesIO(data)))
    assert img.shape == ref.shape and np.array_equal(img, ref)


def test_fixtures_cover_every_subsampling_alpha_and_tiles():
    seen = set()
    for name in LOSSLESS:
        data = (FIXTURES / name).read_bytes()
        obus = _av1_items(data)
        h = avif.av1_header(obus[0])
        seen.add((h["ssx"], h["ssy"]))
        if len(obus) > 1:
            seen.add("alpha")
            assert avif.av1_header(obus[1])["mono"] == 1
    assert {(0, 0), (1, 0), (1, 1), "alpha"} <= seen
    assert sum(n.startswith("avif_q100_ladder_") for n in LOSSLESS) >= 12


# what each gap's refusal names (the image sequence is refused before any AV1 is read)
GAP_TOOLS = {"avif_refused_qm.avif": "quantiser matrices", "avif_refused_screen_content.avif": "screen content tools",
             "avif_refused_sequence.avif": "image sequences"}


@pytest.mark.parametrize("name", GAPS)
def test_forms_not_ported_are_refused_where_pillow_reads_them(name, tmp_path):
    data = (FIXTURES / name).read_bytes()
    with pytest.raises(UnsupportedCodec, match=GAP_TOOLS[name]):
        identify_and_read(data)
    if name != "avif_refused_sequence.avif":
        assert avif.av1_header(_av1_items(data)[0])["why"] == GAP_TOOLS[name]
    ref = np.asarray(PIL_Image.open(io.BytesIO(data)).convert("RGBA"))
    entry = DIGESTS["gaps"][name]
    assert list(ref.shape) == entry["shape"] and hashlib.sha256(ref.tobytes()).hexdigest() == entry["sha256"]
    path = scenes.helmet_with_texture(str(tmp_path), data, name)
    sc = TScene()
    sc.load(path)
    quads, desc, _, _ = ttextures.build_texture_pool(sc.model)
    assert np.asarray(desc).tolist() == [[0, 1, 1, 0]] and np.array_equal(np.asarray(quads), np.ones((1, 16)))


def test_files_without_an_avif_brand_pass_on_as_pillow_does():
    """An ftyp box of an accepted major brand that lists no AVIF brand is
    libavif's invalid ftyp: Pillow's SyntaxError lets the next plugin try,
    and no other plugin takes it."""
    data = bytearray((FIXTURES / "avif_q100_444.avif").read_bytes())
    data[8:12] = b"mif1"
    data[16:24] = b"mif1miaf"
    assert avif.is_avif(bytes(data))
    with pytest.raises(avif.PassOn):
        avif.read_avif(bytes(data))
    with pytest.raises(UnsupportedCodec, match="cannot identify"):
        identify_and_read(bytes(data))
    with pytest.raises(PIL_Image.UnidentifiedImageError):
        PIL_Image.open(io.BytesIO(bytes(data)))


def _mutate(rng, data):
    """One seeded mutation: bits flipped anywhere, a header byte set, a data bit flipped, or the file cut."""
    d = bytearray(data)
    kind = rng.choice(["flip", "head", "data", "cut"])
    if kind == "flip":
        for _ in range(rng.randint(1, 3)):
            d[rng.randrange(len(d))] ^= 1 << rng.randrange(8)
    elif kind == "head":
        d[rng.randrange(min(len(d), 300))] = rng.randrange(256)
    elif kind == "data":
        d[len(d) - 1 - rng.randrange(min(len(d) // 2, 400))] ^= 1 << rng.randrange(8)
    else:
        d = d[: rng.randrange(len(d))]
    return kind, bytes(d)


@pytest.mark.parametrize("seed", range(4))
def test_mutated_fixtures_decode_or_fail_as_pillow(seed):
    """75 seeded mutations a seed. The texture decoders agree (both white, or
    the same pixels), but where the mutation made the AV1 frame one the port
    does not decode (UnsupportedCodec naming the tool, a gap of ROADMAP A),
    set a colr matrix libavif converts without libyuv (ROADMAP A), or made
    the frame's size differ from its ispe (libavif then scales the frame to
    the ispe size, ROADMAP C5); those are counted, few, and each is checked
    to be what it claims."""
    names = sorted(n for n in DIGESTS["files"] if n.startswith("avif_q100_") and "ladder" not in n
                   and "tiles" not in n)
    mutation_outcomes(seed, names)


def mutation_outcomes(seed, names):
    """75 mutations of the fixtures `names` from random.Random(seed), held as
    test_mutated_fixtures_decode_or_fail_as_pillow says."""
    rng = random.Random(seed)
    outcomes = {"equal": 0, "both fail": 0, "not ported": 0, "ispe": 0}
    for i in range(75):
        name = rng.choice(names)
        kind, d = _mutate(rng, (FIXTURES / name).read_bytes())
        model = _model(d)
        try:
            ref = np.asarray(jtextures.decode_image(model, {"bufferView": 0}))
        except Exception:  # noqa: BLE001 - whatever Pillow raises, the reference's pool makes the texel white
            ref = None
        try:
            got = ttextures.decode_image(model, {"bufferView": 0})
        except UnsupportedCodec as e:
            if ref is not None and "which the port does not decode" in str(e):
                assert any(avif.av1_header(o)["refused"] for o in _av1_items(d)), (name, kind, i)
                outcomes["not ported"] += 1
                continue
            if ref is not None and "matrix coefficients" in str(e):
                assert avif._prop(avif._parse(d)[0][avif._parse(d)[1]], b"colr")[3] not in (1, 2, 5, 6, 9)
                outcomes["not ported"] += 1
                continue
            got = None
        except ValueError as e:
            if ref is not None and "ispe" in str(e):  # an item (the colour or the alpha) not of its ispe size
                items, primary, _ = avif._parse(d)
                ids = [primary] + [k for k, it in items.items() if it.get("auxl") == primary]
                assert any((h["w"], h["h"]) != avif._prop(items[k], b"ispe")
                           for k, h in zip(ids, map(avif.av1_header, _av1_items(d)))), (name, kind, i)
                outcomes["ispe"] += 1
                continue
            got = None
        if ref is None:
            assert got is None, (name, kind, i)
            outcomes["both fail"] += 1
        else:
            assert got is not None and got.shape == ref.shape and np.array_equal(got, ref), (name, kind, i)
            outcomes["equal"] += 1
    assert outcomes["equal"] >= 20 and outcomes["both fail"] >= 20
    assert outcomes["not ported"] + outcomes["ispe"] <= 6, outcomes


W, H, DEPTH = 48, 32, 5


def _frame(renderer, path, hdr):
    renderer.create_scene(path)
    renderer.create_hdr(hdr)
    aux = renderer.on_render()
    aux = {k: np.asarray(v.cpu() if hasattr(v, "cpu") else v) for k, v in aux.items()}
    return np.array(renderer.image_linear()), aux


@pytest.mark.usefixtures("one_torch_thread")
def test_avif_textured_frame_matches_jax_renderer(tmp_path):
    buf = io.BytesIO()
    PIL_Image.fromarray(scenes.texture_image(64, seed=1)).save(buf, "AVIF", quality=100, subsampling="4:2:0",
                                                             max_threads=1)
    path = scenes.helmet_with_texture(str(tmp_path), buf.getvalue(), "base.avif")
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


def test_av1_coder_that_fails_to_build_raises(monkeypatch, tmp_path):
    """The AV1 decoder has no Python stand-in: a failed build fails the
    scene load (no white texel in its place)."""
    data = (FIXTURES / "avif_q100_420.avif").read_bytes()
    path = scenes.helmet_with_texture(str(tmp_path), data, "t.avif")

    def broken(src, defines=()):
        raise native.subprocess.CalledProcessError(1, ["g++"], stderr=b"av1_decode.cpp: error")

    monkeypatch.setattr(native, "_av1", None)
    monkeypatch.setattr(native, "_compile", broken)
    with pytest.raises(RuntimeError, match="av1_decode.cpp failed"):
        GltfRenderer(8, 8, spp=1, max_depth=1, device="cpu").create_scene(path)
