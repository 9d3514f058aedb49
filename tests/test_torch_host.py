"""Port host layer: the numpy builders of vk_gltf_renderer_tpu_torch against
the JAX package's, the PNG reader/writer against Pillow, and the port's
helmet stand-in against tools/baseline_standins.make_helmet.

Every builder comparison is exact (np.array_equal, same dtype): the port's
builders are copies of the reference's numpy code, so any difference is a
porting fault, not rounding."""

import dataclasses
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import baseline_standins  # noqa: E402
from vk_gltf_renderer_tpu.models import Scene  # noqa: E402
from vk_gltf_renderer_tpu.models.editor import SceneEditor  # noqa: E402
from vk_gltf_renderer_tpu.ops import bvh_flatten as jbvh  # noqa: E402
from vk_gltf_renderer_tpu.ops import flat as jflat  # noqa: E402
from vk_gltf_renderer_tpu.ops import hdr as jhdr  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import bvh_flatten as tbvh  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import flat as tflat  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import hdr as thdr  # noqa: E402
from vk_gltf_renderer_tpu_torch.scenes import make_helmet_standin, write_synthetic_hdr  # noqa: E402
from vk_gltf_renderer_tpu_torch.utils.png import encode_png, read_png  # noqa: E402


def _tiny(tmp_path):
    from __graft_entry__ import _tiny_scene

    return _tiny_scene()


def _helmet(tmp_path):
    sc = Scene()
    sc.load(baseline_standins.make_helmet(str(tmp_path)))
    return sc


def _editor(tmp_path):
    sc = baseline_standins._empty_scene()
    ed = SceneEditor(sc)
    ed.add_primitive("sphere", segments=12)
    cube = ed.add_primitive("cube")
    ed.set_translation(cube, [2.0, 0.5, -1.0])
    ed.set_scale(cube, [0.5, 1.5, 0.5])
    sc.parse_scene()
    return sc


SCENES = {"tiny": _tiny, "helmet": _helmet, "editor": _editor}


def _assert_same(a, b, what):
    a = np.asarray(a)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_flat_equals_reference(name, tmp_path):
    sc = SCENES[name](tmp_path)
    ref = jflat.build_scene_flat(sc)
    port = tflat.build_scene_flat(sc)
    for f in dataclasses.fields(tflat.SceneFlat):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if f.name == "materials":
            assert a.keys() == b.keys()
            for k in a:
                _assert_same(a[k], b[k], f"materials.{k}")
        elif f.name == "num_lights":
            assert a == b
        else:
            _assert_same(a, b, f.name)
    assert tflat.MAT_LAYOUT == jflat.MAT_LAYOUT


@pytest.mark.parametrize("name", sorted(SCENES))
def test_world_bvh_equals_reference(name, tmp_path):
    sc = SCENES[name](tmp_path)
    ref = jbvh.build_world_bvh(jflat.build_scene_flat(sc))
    port = tbvh.build_world_bvh(tflat.build_scene_flat(sc))
    # nodes_self cols 6:8 are never written by the native builder (np.empty)
    _assert_same(ref.nodes_self[:, :6], port.nodes_self[:, :6], "nodes_self")
    for k in ("nodes4_fi", "tris128", "hit_attr", "rn_attr_base", "attr_alpha_class"):
        _assert_same(getattr(ref, k), getattr(port, k), k)
    assert port.num_world_tris == ref.num_world_tris
    assert port.root4_code == ref.root4_code


def test_helmet_tables_have_the_slice_shapes(tmp_path):
    bvh = tbvh.build_world_bvh(tflat.build_scene_flat(_helmet(tmp_path)))
    assert bvh.num_world_tris == 9218
    assert bvh.nodes4_fi.shape == (784, 32)
    assert bvh.tris128.shape == (1525, 128)
    assert bvh.hit_attr.shape == (9218, 64)


def test_numpy_sah_oracle_equals_reference(tmp_path):
    """The numpy SAH fallback (used where the native builder cannot build)
    gives the reference's tree exactly."""
    flat = tflat.build_scene_flat(_editor(tmp_path))
    tri = flat.tri_idx
    v = flat.vtx_pos
    tlo = np.minimum(np.minimum(v[tri[:, 0]], v[tri[:, 1]]), v[tri[:, 2]])
    thi = np.maximum(np.maximum(v[tri[:, 0]], v[tri[:, 1]]), v[tri[:, 2]])
    cen = (tlo + thi) * 0.5
    for a, b in zip(jbvh._build_sah(tlo, thi, cen), tbvh._build_sah(tlo, thi, cen)):
        _assert_same(a, b, "_build_sah")


def test_environment_builder_equals_reference(tmp_path):
    p = write_synthetic_hdr(tmp_path / "env.hdr", 64, 128)
    rgb = thdr.read_hdr(p)
    _assert_same(jhdr.read_hdr(p), rgb, "read_hdr")
    ref = jhdr.build_environment(rgb, intensity=1.5, rotation=0.3)
    port = thdr.build_environment(rgb, intensity=1.5, rotation=0.3)
    for k in ("img", "samp", "intensity", "rotation"):
        _assert_same(ref[k], port[k], k)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_round_trip(filter_type, channels):
    rng = np.random.default_rng(10 * filter_type + channels)
    img = rng.integers(0, 256, size=(13, 17, channels), dtype=np.uint8)
    data = encode_png(img, filter_type=filter_type)
    assert np.array_equal(read_png(data), img)
    # Pillow reads what the writer wrote
    pil = np.asarray(Image.open(io.BytesIO(data)))
    assert np.array_equal(pil.reshape(img.shape), img)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_reader_decodes_like_pillow(mode, tmp_path):
    """Pillow chooses the scanline filters (adaptive per row); the reader
    must undo whatever it chose."""
    rng = np.random.default_rng(7)
    ch = len(mode)
    base = np.repeat(np.repeat(rng.integers(0, 256, size=(6, 9, ch), dtype=np.uint8), 7, 0), 5, 1)
    noisy = (base.astype(np.int16) + rng.integers(-3, 4, size=base.shape)).clip(0, 255).astype(np.uint8)
    p = tmp_path / "img.png"
    Image.fromarray(noisy.squeeze(-1) if ch == 1 else noisy, mode).save(p)
    ref = np.asarray(Image.open(p))
    assert np.array_equal(read_png(p.read_bytes()), ref.reshape(noisy.shape))


def test_png_reader_decodes_the_pillow_checker(tmp_path):
    p = tmp_path / "checker.png"
    baseline_standins._checker_png(str(p))
    assert np.array_equal(read_png(p.read_bytes()), np.asarray(Image.open(p)))


def test_png_reader_refuses_other_formats(tmp_path):
    with pytest.raises(ValueError):
        read_png(b"\xff\xd8\xff\xe0 not a png")
    p = tmp_path / "deep.png"
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(p)
    with pytest.raises(ValueError):
        read_png(p.read_bytes())


def test_make_helmet_standin_equals_tools_version(tmp_path):
    (tmp_path / "tools").mkdir()
    (tmp_path / "port").mkdir()
    pa = Path(baseline_standins.make_helmet(str(tmp_path / "tools")))
    pb = Path(make_helmet_standin(str(tmp_path / "port")))
    assert json.loads(pa.read_text()) == json.loads(pb.read_text())
    ta = pa.parent / "helmet_baseColor.png"
    tb = pb.parent / "helmet_baseColor.png"
    assert np.array_equal(np.asarray(Image.open(ta)), np.asarray(Image.open(tb)))
    assert np.array_equal(read_png(ta.read_bytes()), read_png(tb.read_bytes()))
