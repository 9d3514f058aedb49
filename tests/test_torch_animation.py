"""Animation and the device refit: the port's ops/animation.py, the refit of
every table family, the refit-time hit-row bake and the renderer's
scene-change sync against the JAX package's, on the CPU.

Tolerances: skinning, morphing and the world-matrix propagation within
1e-5 absolute (the reference's einsums leave the summation order to XLA);
bake_world_tris within 2 ulp of each row's magnitude; refit_world_bvh
(min/max and gathers only) and refit_lane_pages bit for bit. The device
hit-row bake equals the reference's jitted bake bit for bit in every
column but 43 (texel density), where XLA's CPU rsqrt is an approximation:
on the moved helmet stand-in 669 of 9,218 rows differ there, by at most
2 ulp. Whole animated frames agree with the JAX renderer's at
tests/test_torch_frame.py's thresholds."""

import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import baseline_standins  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from conftest import make_triangle_gltf  # noqa: E402
from vk_gltf_renderer_tpu.models import Scene as JScene  # noqa: E402
from vk_gltf_renderer_tpu.ops import animation as janim  # noqa: E402
from vk_gltf_renderer_tpu.ops import bvh_flatten as jbvh  # noqa: E402
from vk_gltf_renderer_tpu.ops import flat as jflat  # noqa: E402
from vk_gltf_renderer_tpu.ops import hitstate as jhit  # noqa: E402
from vk_gltf_renderer_tpu.ops import lane_traverse as jlane  # noqa: E402
from vk_gltf_renderer_tpu.renderer import GltfRenderer as JaxRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch import renderer as trenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch.models import DirtyFlags, Scene  # noqa: E402
from vk_gltf_renderer_tpu_torch.models.editor import SceneEditor  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import animation as tanim  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import bvh_flatten as tbvh  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import flat as tflat  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import hitstate as thit  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import lane_traverse as tlane  # noqa: E402
from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch.scenes import make_brainstem, make_sliver_soup, write_large_glb  # noqa: E402
from torch_test_helpers import one_torch_thread, share_native_builder  # noqa: E402, F401 (a fixture)

share_native_builder()

W, H, DEPTH, FRAMES = 48, 32, 5, 3
HELMET_COL43_ROWS = 669  # rows of the moved helmet stand-in whose texel density differs from XLA's


def _t(a, dtype=None):
    a = np.ascontiguousarray(np.asarray(a))
    return torch.from_numpy(a if dtype is None else a.astype(dtype))


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    return x.view(np.int32)


def _load(tmp_path, name):
    sc = Scene()
    if name == "helmet":
        sc.load(baseline_standins.make_helmet(str(tmp_path)))
    elif name == "terrain":
        p = str(tmp_path / "terrain.glb")
        write_large_glb(p, target_tris=8000, grid=2)
        sc.load(p)
    elif name == "brainstem":
        sc.load(make_brainstem(str(tmp_path)))
    elif name == "soup":  # long thin triangles: VKGR_BVH=sbvh duplicates references
        sc.load(make_sliver_soup(str(tmp_path), n=600))
    else:  # "few": one plane, 2 triangles (the root is a leaf)
        sc = baseline_standins._empty_scene()
        SceneEditor(sc).add_primitive("plane")
        sc.parse_scene()
    return sc


# ------------------------------------------------------------ the ops


def test_skin_and_morph_match_reference():
    rng = np.random.default_rng(3)
    v, j, t = 257, 6, 3
    pos = rng.normal(size=(v, 3)).astype(np.float32)
    nrm = rng.normal(size=(v, 3)).astype(np.float32)
    joints = rng.integers(0, j, size=(v, 4)).astype(np.int32)
    weights = rng.random((v, 4)).astype(np.float32)
    weights[::7] = 0.0  # rows without influence keep their (zero) weights
    mats = rng.normal(size=(j, 4, 4)).astype(np.float32)
    mats[:, 3] = [0, 0, 0, 1]
    ref = janim.skin_vertices(*(jnp.asarray(a) for a in (pos, nrm, joints, weights, mats)))
    port = tanim.skin_vertices(*(_t(a) for a in (pos, nrm, joints, weights, mats)))
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=0, atol=1e-5)
    deltas = rng.normal(size=(t, v, 3)).astype(np.float32)
    w = rng.random(t).astype(np.float32)
    np.testing.assert_allclose(tanim.morph_vertices(_t(pos), _t(deltas), _t(w)).numpy(),
                               np.asarray(janim.morph_vertices(jnp.asarray(pos), jnp.asarray(deltas),
                                                               jnp.asarray(w))), rtol=0, atol=1e-5)


def _hierarchy_scene(fan=False):
    """A three-level node chain with translations, rotations and scales;
    fan: the root's two children side by side (two levels, the root's
    padded)."""
    sc = baseline_standins._empty_scene()
    ed = SceneEditor(sc)
    a = ed.add_primitive("cube")
    b = ed.add_primitive("sphere", segments=8)
    c = ed.add_primitive("plane")
    ed.set_translation(a, [1.0, 2.0, -0.5])
    ed.set_scale(b, [0.5, 1.5, 0.7])
    ed.set_translation(b, [0.0, 1.0, 0.0])
    ed.set_translation(c, [-2.0, 0.0, 1.0])
    sc.model.nodes[a]["rotation"] = [0.0, 0.3826834, 0.0, 0.9238795]
    sc.model.nodes[a]["children"] = [b, c] if fan else [b]
    if not fan:
        sc.model.nodes[b]["children"] = [c]
    sc.model.gltf["scenes"][0]["nodes"] = [a]
    sc.parse_scene()
    return sc


@pytest.mark.parametrize("name", ["hierarchy", "fan", "brainstem"])
def test_propagate_world_matrices_matches_scene(name, tmp_path):
    """The level propagation against Scene.world_matrices. On "fan" the
    root level is padded: the reference's padded lanes write node 0's old
    matrix back over its new one (ROADMAP C); the port's write a dummy row."""
    from vk_gltf_renderer_tpu_torch.utils import mathutil as mu

    sc = _load(tmp_path, name) if name == "brainstem" else _hierarchy_scene(fan=name == "fan")
    nodes, pars, mask = tanim.pack_levels(sc.topo_levels, sc.parents)
    for a, b in zip((nodes, pars, mask), janim.pack_levels(sc.topo_levels, sc.parents)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(sc.topo_levels) >= 2
    locals_ = np.stack([mu.node_local_matrix(n) for n in sc.model.nodes]).astype(np.float32)
    world = tanim.propagate_world_matrices(_t(locals_), _t(pars), _t(nodes), _t(mask))
    np.testing.assert_allclose(world.numpy(), sc.world_matrices, rtol=0, atol=1e-5)


def _moved(flat, seed=0):
    """The scene's vertices jittered and its first instance moved, rotated
    and scaled: the inputs of a rebake."""
    rng = np.random.default_rng(seed)
    vtx = (np.asarray(flat.vtx_pos) + rng.normal(scale=1e-2, size=flat.vtx_pos.shape)).astype(np.float32)
    o2w = np.asarray(flat.rn_o2w).copy()
    c, s = np.cos(0.3), np.sin(0.3)
    o2w[0, :3, :3] = (np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) * 1.1) @ o2w[0, :3, :3]
    o2w[0, :3, 3] += [0.3, -0.2, 0.1]
    return vtx, o2w.astype(np.float32)


def _tables(wb):
    names = ("nodes_i", "nodes_self", "refit_levels", "map4", "nodes4_fi", "nodes4_f", "tri8_src", "tris128",
             "nodes_fi", "nodes16_fi", "map16", "lane_pages", "lane_geo_idx")
    return types.SimpleNamespace(**{k: _t(getattr(wb, k)) for k in names})


@pytest.mark.parametrize("name,kind", [("helmet", "sah"), ("terrain", "sah"), ("terrain", "lbvh"),
                                       ("brainstem", "lbvh"), ("few", "sah"), ("soup", "sbvh")])
def test_refit_world_bvh_equals_reference(name, kind, tmp_path, monkeypatch):
    """bake_world_tris (2 ulp) and every output of refit_world_bvh (bit for
    bit) on the same tree and the same moved triangles, on a SAH and an
    LBVH tree and on an SBVH tree with duplicated references (each copy
    refits from its whole triangle); refit_lane_pages bit for bit on pages
    and entry-major."""
    monkeypatch.setenv("VKGR_BVH", kind)
    flat = tflat.build_scene_flat(_load(tmp_path, name))
    wb = tbvh.add_kernel_tables(tbvh.build_world_bvh(flat), {"bvh2", "bvh16", "lane"})
    vtx, o2w = _moved(flat)
    ref_tris = np.asarray(janim.bake_world_tris(
        jnp.asarray(vtx), jnp.asarray(flat.tri_idx), jnp.asarray(o2w), jnp.asarray(wb.wtri_rnode),
        jnp.asarray(wb.wtri_src_tri), wtri_bary=jnp.asarray(wb.wtri_bary)))
    tris = tanim.bake_world_tris(_t(vtx), _t(flat.tri_idx), _t(o2w), _t(wb.wtri_rnode), _t(wb.wtri_src_tri),
                                 _t(wb.wtri_bary))
    ulp = np.spacing(np.maximum(np.abs(ref_tris), 1e-30).astype(np.float32))
    assert tris.dtype == torch.float32 and (np.abs(tris.numpy() - ref_tris) <= 2 * ulp).all()

    ref = janim.refit_world_bvh(wb, jnp.asarray(ref_tris))  # the reference reads the numpy tree
    port = tanim.refit_world_bvh(_tables(wb), _t(ref_tris))
    names = ("nodes_f", "nodes_self", "nodes4_f", "tris", "nodes_fi", "tris128", "lane_pages", "nodes4_fi",
             "nodes16_fi")
    for what, r, p in zip(names, ref, port, strict=True):
        r = np.asarray(r)
        assert p.dtype == torch.float32 and p.shape == r.shape, what
        assert np.array_equal(_bits(p.numpy()), _bits(r)), what
    # the refit moved the boxes, and they hold every moved triangle
    assert not np.array_equal(port[1].numpy(), wb.nodes_self)
    nt = wb.num_world_tris
    lo, hi = port[1][0, 0:3].numpy(), port[1][0, 3:6].numpy()
    corners = ref_tris[:nt, 0:9].reshape(-1, 3)
    assert (corners >= lo).all() and (corners <= hi).all()

    # the lane pages, alone and in the entry-major layout the device reads
    pages = tlane.refit_lane_pages(_t(wb.lane_pages), _t(wb.lane_geo_idx), port[1], _t(ref_tris))
    ref_pages = np.asarray(jlane.refit_lane_pages(jnp.asarray(wb.lane_pages), jnp.asarray(wb.lane_geo_idx),
                                                  jnp.asarray(port[1].numpy()), jnp.asarray(ref_tris)))
    assert np.array_equal(_bits(pages.numpy()), _bits(ref_pages))
    entries = tlane.refit_lane_pages(_t(tlane.lane_entries(wb.lane_pages)), _t(tlane.lane_entries(wb.lane_geo_idx)),
                                     port[1], _t(ref_tris))
    assert np.array_equal(_bits(entries.numpy()), _bits(tlane.lane_entries(ref_pages)))


def test_from_reference_carries_the_refit_across(tmp_path):
    """convert.from_reference hands the reference's own WorldBvh (native
    builder, its unwritten leaf slots included) to the device refit:
    refit_device_bvh then equals the reference's refit_world_bvh on every
    table family the DeviceBvh holds, bit for bit."""
    from vk_gltf_renderer_tpu_torch.convert import from_reference, refit_device_bvh

    sc = _load(tmp_path, "helmet")
    flat = jflat.build_scene_flat(sc)
    ref_wb = jbvh.build_world_bvh(flat)
    _, dev, _ = from_reference(flat, ref_wb, None, "cpu")
    for family in ("bvh2", "bvh16", "lane"):
        from vk_gltf_renderer_tpu_torch.convert import add_kernel_tables_to_device

        add_kernel_tables_to_device(dev, ref_wb, "cpu", (family,))
    vtx, o2w = _moved(flat, 3)
    tris = tanim.bake_world_tris(_t(vtx), _t(flat.tri_idx), _t(o2w), _t(ref_wb.wtri_rnode),
                                 _t(ref_wb.wtri_src_tri), _t(ref_wb.wtri_bary))
    refit_device_bvh(dev, tris)
    ref = janim.refit_world_bvh(ref_wb, jnp.asarray(tris.numpy()))
    inner = np.asarray(ref_wb.nodes_i)[:, 3] == 0
    for what, table, r in (("nodes_f", dev.nodes_f, ref[0]), ("nodes_self", dev.nodes_self, ref[1]),
                           ("nodes4_f", dev.nodes4_f, ref[2]), ("tris", dev.tris, ref[3]),
                           ("nodes_fi", dev.nodes_fi, ref[4]), ("tris128", dev.tris128, ref[5]),
                           ("nodes4_fi", dev.nodes4_fi, ref[7]), ("nodes16_fi", dev.nodes16_fi, ref[8])):
        a, b = table.numpy(), np.asarray(r)
        if what in ("nodes_f", "nodes_fi"):  # a leaf row reads its unwritten child slots
            a, b = a[inner], b[inner]
        assert np.array_equal(_bits(a), _bits(b)), what
    assert np.array_equal(_bits(dev.lane_entries.numpy()), _bits(tlane.lane_entries(np.asarray(ref[6]))))
    assert torch.equal(dev.scene_lo, dev.nodes_self[0, 0:3])


@pytest.mark.parametrize("name", ["helmet", "terrain"])
def test_device_bake_matches_jitted_reference(name, tmp_path):
    """The refit-time hit-row bake against the reference's, jitted as its
    _refit_device runs it, on moved instances and deformed vertices.
    Every column bit for bit but 43 on the wide rows (texel density), which
    at most HELMET_COL43_ROWS rows of the helmet hold up to 2 ulp apart; the
    terrain's rows are narrow (no column 43) and equal whole."""
    flat = tflat.build_scene_flat(_load(tmp_path, name))
    wb = tbvh.build_world_bvh(flat)
    vtx, o2w = _moved(flat, 1)
    vp = np.asarray(flat.vtx_packed).copy()
    vp[:, 0:3] = vtx
    w2o = np.linalg.inv(o2w.astype(np.float64)).astype(np.float32)
    n = o2w.shape[0]
    rn_packed = np.concatenate([o2w.reshape(n, 16), w2o.reshape(n, 16)], axis=1)
    narrow = wb.hit_attr.shape[1] == thit.HIT_ATTR_COLS_NARROW
    assert narrow == (name == "terrain")
    ref = np.asarray(jax.jit(jhit.bake_hit_attrs, static_argnames=("narrow",))(
        jnp.asarray(vp), jnp.asarray(flat.tri_idx), jnp.asarray(rn_packed), jnp.asarray(wb.attr_rnode),
        jnp.asarray(wb.attr_tri), jnp.asarray(wb.attr_has_uv), narrow=narrow, attr_bary=jnp.asarray(wb.attr_bary)))
    out = thit.bake_hit_attrs(_t(vp), _t(flat.tri_idx, np.int64), _t(rn_packed), _t(wb.attr_rnode, np.int64),
                              _t(wb.attr_tri, np.int64), _t(wb.attr_has_uv), narrow=narrow,
                              attr_bary=_t(wb.attr_bary)).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    differ = (_bits(out) != _bits(ref)) & ~((out == 0) & (ref == 0))
    if narrow:
        assert not differ.any()
        return
    assert not np.delete(differ, 43, axis=1).any()
    ulps = np.abs(_bits(out[:, 43]).astype(np.int64) - _bits(ref[:, 43]))
    assert ulps.max() <= 2 and int(differ[:, 43].sum()) <= HELMET_COL43_ROWS


# ------------------------------------------------------------ the renderer


def _renderer(tmp_path, name="brainstem", w=16, h=12, depth=2):
    r = GltfRenderer(w, h, spp=1, max_depth=depth, device="cpu")
    if name == "triangle":
        r.create_scene(_morph_triangle(tmp_path))
    else:
        r.create_scene(make_brainstem(str(tmp_path)) if name == "brainstem" else
                       baseline_standins.make_helmet(str(tmp_path)))
    return r


def _count_builds(monkeypatch):
    calls = {"n": 0}
    orig = trenderer.build_world_bvh

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(trenderer, "build_world_bvh", counting)
    return calls


def test_transform_edit_refits_not_rebuilds(tmp_path, monkeypatch):
    """tests/test_contracts.py::test_transform_edit_uses_refit_not_rebuild
    through the port: a node translation syncs by the device refit (no
    build_world_bvh call), the boxes move, the host instance matrices
    follow and accumulation restarts."""
    r = _renderer(tmp_path, "helmet")
    builds = _count_builds(monkeypatch)
    dev = r.dev_bvh
    before = dev.nodes4_fi.clone()
    tris0 = dev.tris128.clone().reshape(-1, 16)
    r.total_samples = 3
    SceneEditor(r.scene).set_translation(0, [2.0, 0.0, 0.0])
    assert r.sync_scene_changes()
    assert builds["n"] == 0 and r.dev_bvh is dev and dev.refit is not None
    assert not torch.equal(dev.nodes4_fi, before) and dev.nodes4_fi.shape == before.shape
    assert torch.equal(dev.nodes4_fi[:, 24:32], before[:, 24:32])  # topology stays
    # render node 0's triangles moved +2 in x, the others stayed
    tris1 = dev.tris128.reshape(-1, 16)
    moved = (tris0[:, 9] == 0) & (tris0[:, 10] >= 0)
    shift = (tris1 - tris0)[:, 0:9].reshape(-1, 3, 3)
    assert moved.any() and torch.allclose(shift[moved][..., 0], torch.tensor(2.0), atol=1e-5)
    assert float(shift[moved][..., 1:].abs().max()) == 0.0 and float(shift[~moved].abs().max()) == 0.0
    np.testing.assert_allclose(r.flat.rn_o2w[0][:3, 3], [2, 0, 0], atol=1e-6)
    assert r.total_samples == 0
    assert not r.sync_scene_changes()  # clean scene: nothing to do


def test_visibility_and_geometry_edits_rebuild(tmp_path, monkeypatch):
    """tests/test_contracts.py's visibility and geometry contracts: a
    duplicate (new render node) and a hidden instance rebuild."""
    r = _renderer(tmp_path, "helmet")
    builds = _count_builds(monkeypatch)
    ed = SceneEditor(r.scene)
    n0 = r.bvh.num_world_tris
    ed.duplicate_node(0)
    assert r.sync_scene_changes() and builds["n"] == 1
    n2 = r.bvh.num_world_tris
    assert n2 > n0
    ed.set_visibility(0, False)
    assert r.sync_scene_changes() and builds["n"] == 2
    assert r.bvh.num_world_tris == n2 - r.flat.prim_tri_count[r.flat.rn_prim[0]]
    assert r.dev_bvh.refit is None  # a fresh device scene


def test_material_edit_updates_tables_only(tmp_path, monkeypatch):
    """tests/test_contracts.py::test_material_edit_updates_flat_only: the
    BVH and its device mirror stay, the packed materials change."""
    r = _renderer(tmp_path, "helmet")
    builds = _count_builds(monkeypatch)
    dev_bvh, mat = r.dev_bvh, r.dev_scene.mat_packed.clone()
    r.scene.model.materials[0]["pbrMetallicRoughness"]["baseColorFactor"] = [0, 1, 0, 1]
    r.scene.mark_dirty(DirtyFlags.MATERIALS, materials=[0])
    assert r.sync_scene_changes()
    assert builds["n"] == 0 and r.dev_bvh is dev_bvh and dev_bvh.refit is None
    np.testing.assert_allclose(r.flat.materials["base_color_factor"][0], [0, 1, 0, 1])
    assert not torch.equal(r.dev_scene.mat_packed, mat)


def _morph_triangle(tmp_path):
    """tests/test_animation.py::test_refit_frames_do_no_host_primitive_decode's
    scene as a file: conftest's triangle with a 2-key rotation clip on its
    node and one morph target (+0.2 z on every vertex) at weight 0.5."""
    g, bufs = make_triangle_gltf()
    buf = bytearray(bufs[0])

    def add(arr, atype, **kw):
        g["bufferViews"].append({"buffer": 0, "byteOffset": len(buf), "byteLength": arr.nbytes})
        buf.extend(arr.tobytes())
        g["accessors"].append({"bufferView": len(g["bufferViews"]) - 1, "componentType": 5126,
                               "count": arr.shape[0], "type": atype, **kw})
        return len(g["accessors"]) - 1

    times = np.array([0.0, 1.0], np.float32)
    rots = np.array([[0, 0, 0, 1], [0, 0, 1, 0]], np.float32)
    deltas = np.array([[0, 0, 0.2]] * 3, np.float32)
    a_t = add(times, "SCALAR", min=[0.0], max=[1.0])
    a_r = add(rots, "VEC4")
    a_d = add(deltas, "VEC3", min=deltas.min(0).tolist(), max=deltas.max(0).tolist())
    g["animations"] = [{"channels": [{"sampler": 0, "target": {"node": 0, "path": "rotation"}}],
                        "samplers": [{"input": a_t, "output": a_r, "interpolation": "LINEAR"}]}]
    g["meshes"][0]["primitives"][0]["targets"] = [{"POSITION": a_d}]
    g["nodes"][0]["weights"] = [0.5]
    g["buffers"][0] = {"byteLength": len(buf), "uri": "triangle.bin"}
    (tmp_path / "triangle.bin").write_bytes(bytes(buf))
    path = tmp_path / "triangle.gltf"
    path.write_text(json.dumps(g))
    return str(path)


@pytest.mark.parametrize("name", ["brainstem", "triangle"])
def test_animated_frames_decode_no_primitive(name, tmp_path, monkeypatch):
    """tests/test_animation.py::test_refit_frames_do_no_host_primitive_decode:
    after the first animated frame, frames refit from the device tables and
    decode no primitive, and never rebuild."""
    from vk_gltf_renderer_tpu_torch.models import geometry

    r = _renderer(tmp_path, name)
    r.animate = True
    r.on_render()  # the first frame builds the tables
    builds = _count_builds(monkeypatch)
    calls = {"n": 0}
    orig = geometry.extract_primitive

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(geometry, "extract_primitive", counting)
    boxes = []
    for _ in range(3):
        r.on_render()
        boxes.append(r.dev_bvh.nodes4_fi.clone())
    assert calls["n"] == 0 and builds["n"] == 0
    assert not torch.equal(boxes[0], boxes[1]) and not torch.equal(boxes[1], boxes[2])


def _render(renderer, path, frames, setup=None, between=None):
    if path is not None:
        renderer.create_scene(path)
    if setup is not None:
        setup(renderer)
    out = []
    for i in range(frames):
        if between is not None:
            between(i)
        aux = renderer.on_render()
        aux = {k: np.asarray(v.cpu() if hasattr(v, "cpu") else v) for k, v in aux.items()}
        out.append((np.array(renderer.image_linear()), aux))
    return out


def _assert_frames_agree(ref, port, w, h):
    """tests/test_torch_frame.py's thresholds, frame by frame."""
    for frame, ((img_r, aux_r), (img_p, aux_p)) in enumerate(zip(ref, port, strict=True)):
        assert img_p.shape == (h, w, 3) and np.isfinite(img_p).all()
        assert img_p.mean() > 0.01, "black frame"
        ids_equal = (aux_p["first_rnode"] == aux_r["first_rnode"]) & (aux_p["first_tri"] == aux_r["first_tri"])
        assert ids_equal.mean() >= 0.999, (frame, ids_equal.mean())
        close = (np.abs(img_p - img_r) <= 1e-3 * (1.0 + np.abs(img_r))).all(axis=-1)
        assert close.mean() >= 0.99, (frame, close.mean())
        np.testing.assert_allclose(img_p.mean(axis=(0, 1)), img_r.mean(axis=(0, 1)), rtol=1e-3,
                                   err_msg=f"frame {frame} channel means")
        assert float(aux_p["rays"]) == float(aux_r["rays"]) > w * h


def _animate(r):
    r.animate = True


@pytest.mark.parametrize("name", ["brainstem", "triangle"])
@pytest.mark.usefixtures("one_torch_thread")
def test_animated_frames_match_jax_renderer(name, tmp_path):
    """The brainstem stand-in (skinning) and the morphed, rotating triangle,
    48x32, depth 5, three animated frames against the JAX renderer's at the
    same frame indices; the geometry moves from frame to frame."""
    path = make_brainstem(str(tmp_path)) if name == "brainstem" else _morph_triangle(tmp_path)
    ref = _render(JaxRenderer(W, H, spp=1, max_depth=DEPTH), path, FRAMES, _animate)
    port = _render(GltfRenderer(W, H, spp=1, max_depth=DEPTH, device="cpu"), path, FRAMES, _animate)
    _assert_frames_agree(ref, port, W, H)
    assert not np.array_equal(port[0][1]["first_tri"], port[-1][1]["first_tri"]) or not np.array_equal(
        port[0][0], port[-1][0])


@pytest.mark.usefixtures("one_torch_thread")
def test_skinned_vertices_match_jax_renderer(tmp_path):
    """The brainstem's skinned vertex table after three animated frames
    within 1e-5 of the reference renderer's (its deformed normals carry
    over from frame to frame, and so do the port's)."""
    path = make_brainstem(str(tmp_path))
    ref, port = JaxRenderer(16, 12, spp=1, max_depth=1), GltfRenderer(16, 12, spp=1, max_depth=1, device="cpu")
    for r in (ref, port):
        r.create_scene(path)
        r.animate = True
        for _ in range(3):
            r.on_render()
    dev = port.dev_bvh.refit
    np.testing.assert_allclose(dev.vtx_pos.numpy(), np.asarray(ref.flat.vtx_pos), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dev.vtx_nrm.numpy(), np.asarray(ref.flat.vtx_nrm), rtol=0, atol=1e-5)
    assert not np.allclose(dev.vtx_pos.numpy(), port.flat.vtx_pos, atol=1e-3)  # the column bends


@pytest.mark.usefixtures("one_torch_thread")
def test_selection_switched_after_refit_traces_moved_geometry(tmp_path, monkeypatch):
    """A kernel selection switched after an animated frame builds its
    tables from the host tree, whose boxes are the build's; they are
    refitted on upload, so the frames (v2 rows, then BVH16 rows and lane
    pages, then the split tables of packet4) match the JAX renderer's
    animated frames at the same indices."""
    for k in ("VKGR_PRIMARY_KERNEL", "VKGR_PACKET_KERNEL", "VKGR_TRAVERSAL"):
        monkeypatch.delenv(k, raising=False)
    selections = [{}, {"VKGR_PRIMARY_KERNEL": "v2", "VKGR_PACKET_KERNEL": "v2"},
                  {"VKGR_PRIMARY_KERNEL": "v6", "VKGR_PACKET_KERNEL": "lane"}, {"VKGR_TRAVERSAL": "packet4"}]

    def select(i):
        for k in ("VKGR_PRIMARY_KERNEL", "VKGR_PACKET_KERNEL", "VKGR_TRAVERSAL"):
            monkeypatch.delenv(k, raising=False)
        for k, v in selections[i].items():
            monkeypatch.setenv(k, v)

    path = make_brainstem(str(tmp_path))
    port_r = GltfRenderer(W, H, spp=1, max_depth=DEPTH, device="cpu")
    port = _render(port_r, path, len(selections), _animate, select)
    select(0)
    ref = _render(JaxRenderer(W, H, spp=1, max_depth=DEPTH), path, len(selections), _animate)
    _assert_frames_agree(ref, port, W, H)
    dev, host = port_r.dev_bvh, port_r.bvh
    for table, built in ((dev.nodes_fi, host.nodes_fi), (dev.nodes16_fi, host.nodes16_fi),
                         (dev.nodes4_f, host.nodes4_f)):
        assert table is not None and not np.array_equal(table.numpy(), built)  # refitted on upload


def test_set_variant_refits_and_switches_the_material(tmp_path, monkeypatch):
    """set_variant goes through sync_scene_changes and refits (no
    build_world_bvh call). The reference's sync takes the refit branch for
    RENDER_NODES | MATERIALS and never re-packs the materials, so its
    switched render node keeps the old material (ROADMAP C); the port
    re-packs them and the render node takes the variant's material."""
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_frontends import _with_variants

    path = _with_variants(baseline_standins.make_helmet(str(tmp_path)))
    ref = JaxRenderer(16, 12, spp=1, max_depth=1)
    ref.create_scene(path)
    ref_mat = np.asarray(ref.flat.rn_material).copy()
    assert ref.set_variant(1) == 1 and np.array_equal(np.asarray(ref.flat.rn_material), ref_mat)
    r = GltfRenderer(16, 12, spp=1, max_depth=1, device="cpu")
    r.create_scene(path)
    builds = _count_builds(monkeypatch)
    mat = r.dev_scene.rn_material.clone()
    assert r.set_variant(1) == 1
    assert builds["n"] == 0 and r.dev_bvh.refit is not None
    loaded = tflat.build_scene_flat(_scene_of(_with_variants(baseline_standins.make_helmet(str(tmp_path)), 1)))
    assert not torch.equal(r.dev_scene.rn_material, mat)
    assert np.array_equal(r.dev_scene.rn_material.numpy(), loaded.rn_material)
    assert np.array_equal(r.dev_scene.mat_packed.numpy(), loaded.mat_packed)


def _scene_of(path):
    sc = Scene()
    sc.load(path)
    return sc


def test_refit_is_reference_lbvh_fallback_without_native(tmp_path, monkeypatch):
    """Without the native builders, a scene over _SAH_NUMPY_MAX_TRIS world
    triangles takes the reference's LBVH fallback (ops/bvh.py's radix
    tree), and a refit of it equals the reference's bit for bit."""
    from vk_gltf_renderer_tpu import native as jnative
    from vk_gltf_renderer_tpu_torch import native as tnative

    for mod in (tnative, jnative):
        monkeypatch.setattr(mod, "build_sah_native", lambda *a, **k: None)
        monkeypatch.setattr(mod, "build_radix_tree_native", lambda *a, **k: None)
    monkeypatch.setattr(tbvh, "_SAH_NUMPY_MAX_TRIS", 1000)
    sc = _load(tmp_path, "terrain")
    flat = tflat.build_scene_flat(sc)
    wb = tbvh.add_kernel_tables(tbvh.build_world_bvh(flat), {"bvh2", "bvh16", "lane"})
    monkeypatch.setenv("VKGR_BVH", "lbvh")
    ref = jbvh.build_world_bvh(jflat.build_scene_flat(sc))
    for k in ("nodes_i", "nodes_self", "nodes4_fi", "tris128", "refit_levels", "map4", "tri8_src", "map16",
              "lane_geo_idx", "lane_pages"):
        a, b = np.asarray(getattr(ref, k)), getattr(wb, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    vtx, o2w = _moved(flat, 2)
    tris = tanim.bake_world_tris(_t(vtx), _t(flat.tri_idx), _t(o2w), _t(wb.wtri_rnode), _t(wb.wtri_src_tri),
                                 _t(wb.wtri_bary))
    port = tanim.refit_world_bvh(_tables(wb), tris)
    refs = janim.refit_world_bvh(ref, jnp.asarray(tris.numpy()))
    for r_, p in zip(refs, port, strict=True):
        assert np.array_equal(_bits(p.numpy()), _bits(r_))


def test_unknown_builder_kinds(tmp_path, monkeypatch):
    """VKGR_BVH=sbvh builds the spatial-split BVH, the reference's table
    for table; any other value than sah or sbvh builds the LBVH, as in the
    reference."""
    flat = tflat.build_scene_flat(_load(tmp_path, "brainstem"))
    monkeypatch.setenv("VKGR_BVH", "sbvh")
    sbvh = tbvh.build_world_bvh(flat)
    ref = jbvh.build_world_bvh(jflat.build_scene_flat(_load(tmp_path, "brainstem")))
    assert sbvh.builder == "sbvh"
    for k in ("nodes_i", "nodes4_fi", "tris128", "emit2ref"):
        assert np.array_equal(getattr(sbvh, k), np.asarray(getattr(ref, k))), k
    monkeypatch.setenv("VKGR_BVH", "radix")
    other = tbvh.build_world_bvh(flat)
    monkeypatch.setenv("VKGR_BVH", "lbvh")
    lbvh = tbvh.build_world_bvh(flat)
    assert np.array_equal(other.nodes_i, lbvh.nodes_i) and np.array_equal(other.nodes4_fi, lbvh.nodes4_fi)


def test_jax_scene_world_matrices_after_animation(tmp_path):
    """The port's scene model animates the brainstem's joint as the
    reference's does: world matrices equal after the same clip steps."""
    from vk_gltf_renderer_tpu.models.animation import update_animation as jupdate
    from vk_gltf_renderer_tpu_torch.models.animation import update_animation

    path = make_brainstem(str(tmp_path))
    js, ts = JScene(), Scene()
    js.load(path)
    ts.load(path)
    for _ in range(5):
        for sc, upd in ((js, jupdate), (ts, update_animation)):
            sc.animations[0].increment_time(1.0 / 60.0)
            upd(sc, 0)
            sc.update_world_matrices_serial()
        assert np.array_equal(js.world_matrices, ts.world_matrices)
