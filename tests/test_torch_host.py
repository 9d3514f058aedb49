"""Port host layer: the numpy builders of vk_gltf_renderer_tpu_torch against
the JAX package's (the BVH4 tables, and the BVH2 / BVH16 / lane-page /
sidecar tables of add_kernel_tables), the port's copies of the JAX
package's models/, utils/mathutil.py and native/ against their originals
(parsed scenes, material features, editor operations, matrix helpers, the
native SAH and radix builders), the PNG reader/writer against Pillow, and
the port's helmet stand-in, brainstem stand-in and terrain scene against
tools/baseline_standins.make_helmet, make_brainstem and
tools/large_scene_demo.write_large_glb. The refit maps of every table and
the LBVH branch (VKGR_BVH=lbvh) are held equal too, and so are the port's
copy of ops/omm.py (every function's source) and scenes.make_masked_quads
(against tests/test_omm.py's scene).

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
from vk_gltf_renderer_tpu.models import materials as jmaterials  # noqa: E402
from vk_gltf_renderer_tpu import native as jnative  # noqa: E402
from vk_gltf_renderer_tpu.utils import mathutil as jmu  # noqa: E402
from vk_gltf_renderer_tpu_torch import models as tmodels  # noqa: E402
from vk_gltf_renderer_tpu_torch import native as tnative  # noqa: E402
from vk_gltf_renderer_tpu_torch.models import editor as teditor  # noqa: E402
from vk_gltf_renderer_tpu_torch.models import materials as tmaterials  # noqa: E402
from vk_gltf_renderer_tpu_torch.utils import mathutil as tmu  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import bvh_flatten as tbvh  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import flat as tflat  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import hdr as thdr  # noqa: E402
from vk_gltf_renderer_tpu_torch.scenes import (  # noqa: E402
    make_brainstem,
    make_helmet_standin,
    png_file,
    write_large_glb,
    write_synthetic_hdr,
)
from vk_gltf_renderer_tpu_torch.utils.png import encode_png, read_png  # noqa: E402
from torch_test_helpers import share_native_builder  # noqa: E402

share_native_builder()


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


def _terrain(tmp_path):
    """2x2 grid of the terrain patches: 8,192 triangles."""
    p = str(tmp_path / "terrain.glb")
    write_large_glb(p, target_tris=8000, grid=2)
    sc = Scene()
    sc.load(p)
    return sc


def _few(tmp_path):
    """One plane, 2 triangles: every builder's root-is-leaf branch."""
    sc = baseline_standins._empty_scene()
    SceneEditor(sc).add_primitive("plane")
    sc.parse_scene()
    return sc


SCENES = {"tiny": _tiny, "helmet": _helmet, "editor": _editor, "terrain": _terrain, "few": _few}


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


# the WorldBvh fields every build carries, beside nodes_i and nodes_self
WORLD_FIELDS = ("nodes4_fi", "tris128", "hit_attr", "rn_attr_base", "attr_alpha_class", "nodes_f", "tris",
                "wtri_rnode", "wtri_tri", "nodes4_i", "nodes4_f", "refit_levels", "portal_roots", "map4",
                "wtri8_rnode", "wtri8_tri", "tri8_src", "attr_rnode", "attr_tri", "attr_has_uv", "attr_bary",
                "wtri_src_tri", "wtri_bary", "emit2ref")


def _assert_world_bvh_same(ref, port):
    # nodes_self cols 6:8 are never written by the native builder (np.empty)
    _assert_same(ref.nodes_self[:, :6], port.nodes_self[:, :6], "nodes_self")
    for k in WORLD_FIELDS:
        _assert_same(getattr(ref, k), getattr(port, k), k)
    # nodes_i: a leaf's child slots and col 7 are never written by the
    # native builder (np.empty); the port zeroes them. Col 6 holds the
    # portal ids of the treelet cut (-1 elsewhere).
    inner = ref.nodes_i[:, 3] == 0
    _assert_same(ref.nodes_i[:, 2:7], port.nodes_i[:, 2:7], "nodes_i")
    _assert_same(ref.nodes_i[inner, 0:2], port.nodes_i[inner, 0:2], "nodes_i children")
    assert (port.nodes_i[~inner, 0:2] == 0).all() and (port.nodes_i[:, 7] == 0).all()
    assert port.num_world_tris == ref.num_world_tris
    assert port.root4_code == ref.root4_code


@pytest.mark.parametrize("name", sorted(SCENES))
def test_world_bvh_equals_reference(name, tmp_path):
    sc = SCENES[name](tmp_path)
    ref = jbvh.build_world_bvh(jflat.build_scene_flat(sc))
    port = tbvh.build_world_bvh(tflat.build_scene_flat(sc))
    _assert_world_bvh_same(ref, port)
    # the other kernels' tables and their refit maps are built only on request
    assert port.nodes_fi is None and port.nodes16_fi is None and port.lane_pages is None
    assert port.map16 is None and port.lane_geo_idx is None


@pytest.mark.parametrize("name", sorted(SCENES))
def test_lbvh_tables_equal_reference(name, tmp_path, monkeypatch):
    """VKGR_BVH=lbvh: the Morton radix tree collapsed to <= 8-triangle
    leaves, every field and kernel table equal to the reference's."""
    monkeypatch.setenv("VKGR_BVH", "lbvh")
    sc = SCENES[name](tmp_path)
    ref = jbvh.build_world_bvh(jflat.build_scene_flat(sc))
    port = tbvh.add_kernel_tables(tbvh.build_world_bvh(tflat.build_scene_flat(sc)),
                                  {"bvh2", "bvh16", "lane", "bvh4_sidecar"})
    _assert_world_bvh_same(ref, port)
    for k in ("nodes16_fi", "map16", "lane_pages", "lane_geo_idx", "nodes4_sc", "nodes_fi"):
        _assert_same(getattr(ref, k), getattr(port, k), k)
    assert port.root_code == ref.root_code


@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel_tables_equal_reference(name, tmp_path):
    """nodes_fi/root_code (_packet2_tables), nodes16_fi + map16
    (_packet6_tables) and lane_pages + lane_geo_idx (build_lane_tree) of
    add_kernel_tables equal the reference's fields."""
    sc = SCENES[name](tmp_path)
    ref = jbvh.build_world_bvh(jflat.build_scene_flat(sc))
    port = tbvh.add_kernel_tables(tbvh.build_world_bvh(tflat.build_scene_flat(sc)),
                                  {"bvh2", "bvh16", "lane"})
    _assert_same(ref.nodes4_sc, tbvh.add_kernel_tables(port, {"bvh4_sidecar"}).nodes4_sc,
                 "nodes4_sc")
    _assert_same(ref.nodes16_fi, port.nodes16_fi, "nodes16_fi")
    _assert_same(ref.map16, port.map16, "map16")
    _assert_same(ref.lane_pages, port.lane_pages, "lane_pages")
    _assert_same(ref.lane_geo_idx, port.lane_geo_idx, "lane_geo_idx")
    assert port.root_code == ref.root_code
    # nodes_fi of a leaf row reads its (unwritten) child slots: compare the
    # reference's builder on the same tree, and the internal rows directly
    nodes_fi, *_, root_code = jbvh._packet2_tables(port.nodes_i, port.nodes_f, port.tris,
                                                   port.wtri_rnode, port.wtri_tri)
    _assert_same(nodes_fi, port.nodes_fi, "nodes_fi")
    assert root_code == port.root_code
    inner = ref.nodes_i[:, 3] == 0
    _assert_same(ref.nodes_fi[inner], port.nodes_fi[inner], "nodes_fi internal rows")
    if name == "few":
        assert port.root_code < 0 and port.nodes16_fi.shape == (1, 128)


def test_stack_need_bounds_the_walk(tmp_path):
    """stack_need is the exact worst case of a push-every-child walk: a
    plain walk that pushes every real child never exceeds it, and reaches
    it on some path."""
    wb = tbvh.add_kernel_tables(tbvh.build_world_bvh(tflat.build_scene_flat(_editor(tmp_path))),
                                {"bvh2", "bvh16"})
    for table, levels, root in ((wb.nodes_fi, 1, wb.root_code), (wb.nodes4_fi, 2, wb.root4_code),
                                (wb.nodes16_fi, 4, 0)):
        arity = 1 << levels
        deepest, stack = 0, [root]
        while stack:
            e = stack.pop()
            if e < 0:
                continue
            row = table[e]
            for s in range(arity):
                if row[6 * s] < 1e38:
                    stack.append(int(row[6 * arity + s]))
            deepest = max(deepest, len(stack))
        assert tbvh.stack_need(table, levels, root) == deepest, levels
    # v8's stack: the same walk with leaf children sent elsewhere
    deepest, stack = 0, [wb.root4_code]
    while stack:
        row = wb.nodes4_fi[stack.pop()]
        stack += [int(row[24 + s]) for s in range(4) if row[6 * s] < 1e38 and row[24 + s] >= 0]
        deepest = max(deepest, len(stack))
    assert tbvh.stack_need(wb.nodes4_fi, 2, wb.root4_code, internal_only=True) == deepest
    # v5's pop groups of 1 are the single-pop walk
    assert tbvh.multipop_stack_need(wb.nodes4_fi, wb.root4_code, 1) == tbvh.stack_need(
        wb.nodes4_fi, 2, wb.root4_code)
    assert tbvh.multipop_stack_need(wb.nodes4_fi, wb.root4_code, 4) >= tbvh.stack_need(
        wb.nodes4_fi, 2, wb.root4_code)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_split_tables_equal_reference(name, tmp_path):
    """nodes4_i and nodes4_f, the split BVH4 tables of the packet4
    traversal, equal the reference's byte for byte."""
    sc = SCENES[name](tmp_path)
    ref = jbvh.build_world_bvh(jflat.build_scene_flat(sc))
    port = tbvh.build_world_bvh(tflat.build_scene_flat(sc))
    for k in ("nodes4_i", "nodes4_f"):
        _assert_same(getattr(ref, k), getattr(port, k), k)
    assert ((port.nodes4_i[:, 0:4] == -1) == (port.nodes4_f[:, 0:24:6] > 1e38)).all()


@pytest.mark.parametrize("name", ["editor", "terrain", "few"])
def test_split_stack_need_bounds_the_walk(name, tmp_path):
    """split_stack_need is the deepest stack of the split walks when every
    box is entered, over every order a ray's near-first pushes can take:
    the packet4 walk pushes every child code but the missing ones (-1);
    the v1 walk, which descends (csrc/traverse_bvh2_split.cu), pushes the
    far child of an internal node and walks the near one next from a
    register. Checked against a recursive worst case (any child may come
    first, its siblings below it) and against walks in random push
    orders, none of which goes deeper."""
    wb = tbvh.build_world_bvh(tflat.build_scene_flat(SCENES[name](tmp_path)))

    def children4(e):
        return [int(c) for c in wb.nodes4_i[e, 0:4] if c != -1] if e >= 0 else []

    def children2(node):
        left, right, _, count = (int(x) for x in wb.nodes_i[node, 0:4])
        return [] if count else [left, right]

    rng = np.random.default_rng(0)
    for levels, children, descend in ((2, children4, False), (1, children2, True)):
        def worst(node, below):
            kids = children(node)
            return max([below + len(kids) - descend] + [worst(c, below + len(kids) - 1) for c in kids])

        need = tbvh.split_stack_need(wb, levels)
        assert need == max(1, worst(0, 0)), levels
        for _ in range(20):
            deepest, stack, node = 1, [], 0
            if not descend:
                stack = [node]
                while stack:
                    stack += list(rng.permutation(children(stack.pop())))
                    deepest = max(deepest, len(stack))
            while descend:  # all children but the last pushed, the last walked next
                kids = list(rng.permutation(children(node)))
                stack += kids[:-1]
                deepest = max(deepest, len(stack))
                if kids:
                    node = kids[-1]
                elif stack:
                    node = stack.pop()
                else:
                    break
            assert deepest <= need, levels
        if name == "few":
            assert need == (1 if levels == 1 else len(children4(0)))
    with pytest.raises(ValueError):
        tbvh.split_stack_need(wb, 4)


@pytest.mark.parametrize("target,grid", [(8000, 2), (40_000, 4), (1_050_000, 8)])
def test_write_large_glb_equals_tools_version(target, grid, tmp_path):
    from large_scene_demo import write_large_glb as tools_write_large_glb

    a, b = tmp_path / "tools.glb", tmp_path / "port.glb"
    assert tools_write_large_glb(str(a), target, grid) == write_large_glb(str(b), target, grid)
    assert a.read_bytes() == b.read_bytes()
    if target == 1_050_000:
        assert write_large_glb(str(b)) == 1_059_968


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
    """Data that is not a PNG, and a PNG whose bit depth and colour type
    Pillow has no mode for (16-bit palette), raise ValueError, as Pillow
    refuses them; a 16-bit gray PNG, which Pillow reads, reads as its
    convert("RGBA")."""
    with pytest.raises(ValueError):
        read_png(b"\xff\xd8\xff\xe0 not a png")
    p = tmp_path / "deep.png"
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(p)
    assert np.array_equal(read_png(p.read_bytes()), np.asarray(Image.open(p).convert("RGBA")))
    palette16 = png_file(np.arange(4).reshape(2, 2), 16, 3, palette=np.zeros((4, 3), np.uint8))
    with pytest.raises(Exception):  # noqa: B017 - whatever Pillow raises
        Image.open(io.BytesIO(palette16)).convert("RGBA")
    with pytest.raises(ValueError):
        read_png(palette16)


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


def test_make_brainstem_equals_tools_version(tmp_path):
    (tmp_path / "tools").mkdir()
    (tmp_path / "port").mkdir()
    pa = Path(baseline_standins.make_brainstem(str(tmp_path / "tools")))
    pb = Path(make_brainstem(str(tmp_path / "port")))
    assert pa.read_bytes() == pb.read_bytes()
    assert (pa.parent / "brainstem.bin").read_bytes() == (pb.parent / "brainstem.bin").read_bytes()
    sc = tmodels.Scene()
    sc.load(str(pb))
    assert sum(p.index_count // 3 for p in sc.render_primitives) == 64 and len(sc.animations) == 1


# ------------------------------------------------- copies of the JAX package


def _editor_ops(editor_cls, scene):
    """The editor operations the port's scenes use (scenes.make_helmet_standin
    and the tests' editor scene), through the given SceneEditor class."""
    ed = editor_cls(scene)
    ball = ed.add_primitive("sphere", segments=12, name="ball")
    cube = ed.add_primitive("cube")
    ed.set_translation(cube, [2.0, 0.5, -1.0])
    ed.set_scale(cube, [0.5, 1.5, 0.5])
    plate = ed.add_primitive("plane", name="plate")
    ed.set_translation(plate, [0.0, -1.1, 0.0])
    scene.model.materials.append({"pbrMetallicRoughness": {"metallicFactor": 0.6}})
    ed.set_material(ball, 0, 0)
    scene.parse_scene()
    return scene


def _scene_file(name, d):
    if name == "helmet":
        return make_helmet_standin(str(d))
    if name == "terrain":
        p = str(d / "terrain.glb")
        write_large_glb(p, target_tris=8000, grid=2)
        return p
    sc = _editor(d)
    p = str(d / "editor.gltf")
    sc.save(p)
    return p


@pytest.mark.parametrize("name", ["helmet", "terrain", "editor"])
def test_copied_models_parse_like_the_originals(name, tmp_path):
    """One glTF file through both packages' loaders: the same JSON, buffers,
    render nodes, render primitives, materials and scene features."""
    path = _scene_file(name, tmp_path)
    ref, port = Scene(), tmodels.Scene()
    ref.load(path)
    port.load(path)
    assert port.model.gltf == ref.model.gltf
    assert [bytes(b) for b in port.model.buffers] == [bytes(b) for b in ref.model.buffers]
    assert len(port.render_nodes) == len(ref.render_nodes) > 0
    for a, b in zip(ref.render_nodes, port.render_nodes):
        assert (a.material_id, a.render_prim_id, a.ref_node_id, a.skin_id, a.visible) == (
            b.material_id, b.render_prim_id, b.ref_node_id, b.skin_id, b.visible)
        _assert_same(a.world_matrix, b.world_matrix, "world_matrix")
    assert [(p.mesh_id, p.prim_index, p.vertex_count, p.index_count) for p in ref.render_primitives] == [
        (p.mesh_id, p.prim_index, p.vertex_count, p.index_count) for p in port.render_primitives]
    lo_r, hi_r = ref.scene_bounds()
    lo_p, hi_p = port.scene_bounds()
    _assert_same(lo_r, lo_p, "bounds lo")
    _assert_same(hi_r, hi_p, "bounds hi")
    assert tmaterials.detect_scene_features(port.model) == jmaterials.detect_scene_features(ref.model)
    for a, b in zip(jmaterials.MaterialConverter(ref.model).convert_all(),
                    tmaterials.MaterialConverter(port.model).convert_all()):
        for f in dataclasses.fields(a):
            _assert_same(np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name)), f.name)


def test_copied_editor_matches_the_original(tmp_path):
    ref = _editor_ops(SceneEditor, baseline_standins._empty_scene())
    port = tmodels.Scene()
    port.load_from_model(tmodels.gltf.load_model_from_json(
        {"asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": []}]}, []))
    port = _editor_ops(teditor.SceneEditor, port)
    assert port.model.gltf == ref.model.gltf
    assert [bytes(b) for b in port.model.buffers] == [bytes(b) for b in ref.model.buffers]
    ref.save(tmp_path / "ref.gltf")
    port.save(tmp_path / "port.gltf")
    assert (tmp_path / "ref.gltf").read_text() == (tmp_path / "port.gltf").read_text()


def test_copied_mathutil_matches_the_original():
    rng = np.random.default_rng(3)
    for _ in range(20):
        t = rng.normal(size=3).astype(np.float32)
        q = rng.normal(size=4)
        q = (q / np.linalg.norm(q)).astype(np.float32)
        sc = rng.uniform(0.1, 3.0, size=3).astype(np.float32)
        node = {"translation": t.tolist(), "rotation": q.tolist(), "scale": sc.tolist()}
        m = jmu.trs_matrix(t, q, sc)
        pts = rng.normal(size=(7, 3)).astype(np.float32)
        eye, center = rng.normal(size=3), rng.normal(size=3)
        fov, aspect = rng.uniform(0.2, 2.0), rng.uniform(0.5, 2.5)
        for fn, args in (("trs_matrix", (t, q, sc)), ("quat_to_matrix", (q,)),
                         ("matrix_to_trs", (m,)), ("rotmat_to_quat", (m[:3, :3],)),
                         ("node_local_matrix", (node,)), ("node_local_matrix", ({"matrix": m.T.reshape(-1).tolist()},)),
                         ("perspective", (fov, aspect, 0.01, 100.0)),
                         ("orthographic", (aspect, 1.0, 0.01, 100.0)),
                         ("look_at", (eye, center, np.array([0.0, 1.0, 0.0]))),
                         ("transform_points", (m, pts)), ("transform_dirs", (m, pts))):
            a, b = getattr(jmu, fn)(*args), getattr(tmu, fn)(*args)
            for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
                _assert_same(np.asarray(x), np.asarray(y), fn)


@pytest.mark.parametrize("name", ["helmet", "terrain", "editor"])
def test_copied_native_builders_match_the_originals(name, tmp_path):
    """The port's native/ (built into the repository's build/native/) gives
    the original's SAH tree and Morton radix tree exactly."""
    sc = SCENES[name](tmp_path)
    flat = tflat.build_scene_flat(sc)
    v, tri = flat.vtx_pos, flat.tri_idx
    tlo = np.minimum(np.minimum(v[tri[:, 0]], v[tri[:, 1]]), v[tri[:, 2]])
    thi = np.maximum(np.maximum(v[tri[:, 0]], v[tri[:, 1]]), v[tri[:, 2]])
    cen = (tlo + thi) * 0.5
    ref_sah = jnative.build_sah_native(tlo, thi, cen, 8)
    port_sah = tnative.build_sah_native(tlo, thi, cen, 8)
    assert ref_sah is not None and port_sah is not None
    perm, nodes_i, nodes_f, nodes_self = port_sah
    _assert_same(ref_sah[0], perm, "perm")
    inner = ref_sah[1][:, 3] == 0  # a leaf's child slots are never written
    _assert_same(ref_sah[1][:, 2:6], nodes_i[:, 2:6], "nodes_i")
    _assert_same(ref_sah[1][inner, 0:2], nodes_i[inner, 0:2], "nodes_i children")
    _assert_same(ref_sah[2], nodes_f, "nodes_f")
    _assert_same(ref_sah[3][:, :6], nodes_self[:, :6], "nodes_self")
    for a, b in zip(jnative.build_radix_tree_native(tlo, thi, cen),
                    tnative.build_radix_tree_native(tlo, thi, cen)):
        _assert_same(a, b, "radix tree")
    assert tnative._CACHE == ROOT / "build" / "native"


def test_copied_omm_matches_the_original():
    """ops/omm.py is a copy: every function's source and every constant of
    the JAX package's ops/omm.py, unchanged (its relative imports reach the
    port's flat.py, whose MAT_LAYOUT and tex_texels are held equal above and
    below)."""
    import inspect

    from vk_gltf_renderer_tpu.ops import omm as jomm
    from vk_gltf_renderer_tpu_torch.ops import omm as tomm

    names = [n for n, v in vars(jomm).items() if inspect.isfunction(v) and v.__module__ == jomm.__name__]
    assert sorted(names) == sorted(n for n, v in vars(tomm).items()
                                   if inspect.isfunction(v) and v.__module__ == tomm.__name__)
    assert {"_minmax_bounds", "_tex_alpha_bounds", "subtri_corners", "classify_subtri",
            "classify_attr_alpha"} <= set(names)
    for n in names:
        assert inspect.getsource(getattr(tomm, n)) == inspect.getsource(getattr(jomm, n)), n
    for c in ("ALPHA_OPAQUE", "ALPHA_MIXED", "ALPHA_TRANSPARENT", "_CELLS"):
        assert getattr(tomm, c) == getattr(jomm, c), c


def test_make_masked_quads_equals_the_omm_test_scene(tmp_path):
    """scenes.make_masked_quads (written without Pillow) parses to the same
    SceneFlat, texels included, as tests/test_omm.py's make_masked_quads,
    MASK and BLEND."""
    from test_omm import make_masked_quads as ref_quads

    from vk_gltf_renderer_tpu_torch.scenes import make_masked_quads

    for mode in ("MASK", "BLEND"):
        port = Scene()
        port.load(make_masked_quads(str(tmp_path), alpha_mode=mode, cutoff=0.4))
        a = jflat.build_scene_flat(ref_quads(mode, 0.4))
        b = jflat.build_scene_flat(port)
        for f in dataclasses.fields(a):
            if f.name == "materials":
                for k in a.materials:
                    _assert_same(a.materials[k], b.materials[k], f"materials.{k}")
            elif f.name != "num_lights":
                _assert_same(getattr(a, f.name), getattr(b, f.name), f.name)
        _assert_same(a.tex_texels, tflat.build_scene_flat(port).tex_texels, "tex_texels")
