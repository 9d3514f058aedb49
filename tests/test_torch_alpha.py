"""Stochastic alpha in the port against the JAX package, on the CPU: the
opacity classes of ops/omm.py, the culled and split world tables of
build_world_bvh (SAH and LBVH), the hit state and the refit on virtual
subtriangle rows, get_opacity, the alpha re-trace (_trace_with_alpha) and
the alpha shadow march (_trace_shadow), whole frames of the foliage
stand-in and of tests/test_omm.py's masked quads, the three acceleration
levels (none / whole / subtri) and the MASK -> OPAQUE material edit.

Inputs come from fixed numpy seeds. Tolerances: classes, cells and every
table field bit for bit (np.array_equal, same dtype); the hit state on a
virtual row against its parent's at the composed barycentrics within 1e-5
(tests/test_omm.py:263's); bake_world_tris within 2 ulp and
refit_world_bvh bit for bit (tests/test_torch_animation.py's); the
renderer's refit against a fresh build within 1e-5 / 1e-4 (tests/test_omm.py:363's);
opacity, hits and shadow factors within test_torch_shading's 1e-5, ids and
seeds exact; frames at tests/test_torch_frame.py's thresholds, at each
acceleration level; the levels within 2e-3 of each other on MASK-only
scenes (tests/test_omm.py:130's), and on the BLEND foliage the pixels
past 2e-3 the same as the reference's on 99% of pixels."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402
from vk_gltf_renderer_tpu.models import Scene as JScene  # noqa: E402
from vk_gltf_renderer_tpu.models.materials import detect_scene_features  # noqa: E402
from vk_gltf_renderer_tpu.ops import animation as janim  # noqa: E402
from vk_gltf_renderer_tpu.ops import bvh_flatten as jbvh  # noqa: E402
from vk_gltf_renderer_tpu.ops import flat as jflat  # noqa: E402
from vk_gltf_renderer_tpu.ops import hitstate as jhit  # noqa: E402
from vk_gltf_renderer_tpu.ops import materials_eval as jmat  # noqa: E402
from vk_gltf_renderer_tpu.ops import omm as jomm  # noqa: E402
from vk_gltf_renderer_tpu.ops import pathtrace as jpt  # noqa: E402
from vk_gltf_renderer_tpu.ops.traverse import as_device  # noqa: E402
from vk_gltf_renderer_tpu.renderer import GltfRenderer as JaxRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch.convert import from_reference  # noqa: E402
from vk_gltf_renderer_tpu_torch.models import DirtyFlags, Scene  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import animation as tanim  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import bvh_flatten as tbvh  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import flat as tflat  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import hitstate as thit  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import materials_eval as tmat  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import omm as tomm  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import pathtrace as tpt  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import rng as trng  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse as ttrav  # noqa: E402
from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch.scenes import make_foliage_standin, make_masked_quads  # noqa: E402
from test_torch_animation import _bits, _t, _tables  # noqa: E402
from test_torch_frame import _assert_frames_agree, _render  # noqa: E402
from test_torch_host import WORLD_FIELDS, _assert_same, _assert_world_bvh_same  # noqa: E402
from test_torch_shading import _close  # noqa: E402
from torch_test_helpers import one_torch_thread, share_native_builder  # noqa: E402, F401 (a fixture)

share_native_builder()

CARDS = 64  # the foliage stand-in's size in these tests: 128 card triangles
W, H = 48, 32


def _path(name, tmp):
    return make_masked_quads(str(tmp)) if name == "quads" else make_foliage_standin(str(tmp), cards=CARDS)


def _flats(name, tmp):
    """(scene path, the reference's SceneFlat, the port's) of one scene."""
    path = _path(name, tmp)
    sc = JScene()
    sc.load(path)
    return path, jflat.build_scene_flat(sc), tflat.build_scene_flat(sc)


def _classes(flat):
    cls = tomm.classify_attr_alpha(flat)
    return cls, tomm.classify_subtri(flat, cls)


@pytest.mark.parametrize("name", ["quads", "foliage"])
def test_omm_classes_equal_reference(name, tmp_path):
    """classify_attr_alpha and classify_subtri (and the cell corners) bit
    for bit; the masked quads give tests/test_omm.py's classes, and the
    foliage atlas every class, with transparent cells in MIXED rows."""
    _, jf, tf = _flats(name, tmp_path)
    ref_cls = jomm.classify_attr_alpha(jf)
    cls, cells = _classes(tf)
    _assert_same(ref_cls, cls, "tri_class")
    _assert_same(jomm.classify_subtri(jf, ref_cls), cells, "subtri_cells")
    _assert_same(jomm.subtri_corners(2), tomm.subtri_corners(2), "subtri_corners")
    if name == "quads":
        assert list(cls) == [tomm.ALPHA_OPAQUE, tomm.ALPHA_TRANSPARENT, tomm.ALPHA_MIXED]
    else:
        assert set(np.unique(cls)) == {0, 1, 2}
        mixed = cells[cls == tomm.ALPHA_MIXED]
        assert ((mixed == tomm.ALPHA_TRANSPARENT).any(1) & (mixed != tomm.ALPHA_TRANSPARENT).any(1)).any()


@pytest.mark.parametrize("builder", ["sah", "lbvh"])
@pytest.mark.parametrize("level", ["whole", "subtri"])
@pytest.mark.parametrize("name", ["quads", "foliage"])
def test_alpha_world_bvh_equals_reference(name, level, builder, tmp_path, monkeypatch):
    """build_world_bvh(flat, tri_class, subtri_cells) on culled and split
    rows: every WorldBvh field and every add_kernel_tables table (BVH2,
    BVH16, lane pages, the v7 sidecar) equal to the reference's, under the
    native SAH and the LBVH."""
    monkeypatch.setenv("VKGR_BVH", builder)
    _, jf, tf = _flats(name, tmp_path)
    cls, cells = _classes(tf)
    cells = cells if level == "subtri" else None
    ref = jbvh.build_world_bvh(jf, tri_class=cls, subtri_cells=cells)
    port = tbvh.add_kernel_tables(tbvh.build_world_bvh(tf, tri_class=cls, subtri_cells=cells),
                                  {"bvh2", "bvh16", "lane", "bvh4_sidecar"})
    _assert_world_bvh_same(ref, port)
    for k in ("nodes16_fi", "map16", "lane_pages", "lane_geo_idx", "nodes4_sc"):
        _assert_same(getattr(ref, k), getattr(port, k), k)
    inner = ref.nodes_i[:, 3] == 0  # a leaf row of nodes_fi reads the native builder's unwritten slots
    _assert_same(ref.nodes_fi[inner], port.nodes_fi[inner], "nodes_fi internal rows")
    assert port.root_code == ref.root_code
    assert port.num_world_tris < tf.tri_idx.shape[0] + (0 if level == "whole" else port.attr_rnode.shape[0])


def test_culled_and_split_rows(tmp_path):
    """tests/test_omm.py's emission checks on the port: the transparent
    triangle culled with the hit rows kept whole, the MIXED one replaced by
    its non-transparent cells as virtual rows after the primitive's span
    (source = the parent, non-identity barycentrics), every world row's
    (rnode, tri) resolving to a hit row, and no TRANSPARENT row emitted."""
    _, _, tf = _flats("quads", tmp_path)
    cls, cells = _classes(tf)
    full = tbvh.build_world_bvh(tf)
    whole = tbvh.build_world_bvh(tf, tri_class=cls)
    sub = tbvh.build_world_bvh(tf, tri_class=cls, subtri_cells=cells)
    assert (full.num_world_tris, whole.num_world_tris) == (3, 2)
    assert np.array_equal(whole.rn_attr_base, full.rn_attr_base) and whole.attr_rnode.shape == (3,)
    assert (full.attr_alpha_class == tomm.ALPHA_MIXED).all() and list(whole.attr_alpha_class) == list(cls)
    n_emit = int((cells[2] != tomm.ALPHA_TRANSPARENT).sum())
    assert sub.num_world_tris == 1 + n_emit and sub.attr_rnode.shape == (3 + n_emit,)
    assert list(sub.attr_tri[3:]) == [2] * n_emit
    nt = sub.num_world_tris
    virtual = sub.wtri_tri[:nt] >= 3
    assert virtual.sum() == n_emit and (sub.wtri_src_tri[:nt][virtual] == 2).all()
    assert not np.allclose(sub.wtri_bary[:nt][virtual], tbvh.IDENT_BARY)
    assert sorted(sub.wtri_tri[:nt][virtual]) == list(range(3, 3 + n_emit))
    rows = sub.rn_attr_base[sub.wtri_rnode[:nt]] + sub.wtri_tri[:nt]
    assert ((rows >= 0) & (rows < sub.attr_rnode.shape[0])).all()
    assert (sub.attr_alpha_class[3:] != tomm.ALPHA_TRANSPARENT).all()


def test_fully_culled_scene_gets_the_degenerate_triangle(tmp_path):
    """BLEND with base-color alpha 0: every triangle TRANSPARENT, so the
    world holds only the far-away degenerate triangle; equal to the
    reference's, and no ray hits it."""
    import json

    path = make_masked_quads(str(tmp_path), alpha_mode="BLEND")
    g = json.loads(open(path).read())
    g["materials"][0]["pbrMetallicRoughness"]["baseColorFactor"] = [1, 1, 1, 0.0]
    open(path, "w").write(json.dumps(g))
    sc = JScene()
    sc.load(path)
    jf, tf = jflat.build_scene_flat(sc), tflat.build_scene_flat(sc)
    cls, cells = _classes(tf)
    assert (cls == tomm.ALPHA_TRANSPARENT).all()
    ref = jbvh.build_world_bvh(jf, tri_class=cls, subtri_cells=cells)
    port = tbvh.build_world_bvh(tf, tri_class=cls, subtri_cells=cells)
    _assert_world_bvh_same(ref, port)
    assert port.num_world_tris == 1 and (port.tris[0, :9] == np.float32(3e37)).all()
    _, bvh, _ = from_reference(tf, port, None, "cpu")
    h = tpt.trace_closest(bvh, torch.tensor([[0.5, 0.3, 3.0]]), torch.tensor([[0.0, 0.0, -1.0]]))
    assert int(h["tri"][0]) == -1


def test_subtri_hitstate_exact(tmp_path):
    """A hit on a virtual row reconstructs its parent's hit state at the
    composed barycentrics (tests/test_omm.py:263, 1e-5), and equals the
    reference's get_hit_state_fused on the same rows."""
    _, jf, tf = _flats("quads", tmp_path)
    cls, cells = _classes(tf)
    wb = tbvh.build_world_bvh(tf, tri_class=cls, subtri_cells=cells)
    ta = wb.attr_rnode.shape[0]
    s = ta - 3
    rng = np.random.default_rng(0)
    u = rng.random(s).astype(np.float32) * 0.5
    v = rng.random(s).astype(np.float32) * 0.5
    rd = np.tile(np.float32([[0.0, 0.0, -1.0]]), (s, 1))
    attr, base = torch.tensor(wb.hit_attr), torch.tensor(wb.rn_attr_base)
    hit_sub = {"tri": torch.arange(3, ta, dtype=torch.int32), "rnode": torch.zeros(s, dtype=torch.int32),
               "t": torch.ones(s), "u": torch.tensor(u), "v": torch.tensor(v)}
    hs_sub = thit.get_hit_state_fused(attr, base, hit_sub, torch.tensor(rd))
    b = wb.attr_bary[3:]
    up = b[:, 0] + u * (b[:, 2] - b[:, 0]) + v * (b[:, 4] - b[:, 0])
    vp = b[:, 1] + u * (b[:, 3] - b[:, 1]) + v * (b[:, 5] - b[:, 1])
    hit_par = {"tri": torch.full((s,), 2, dtype=torch.int32), "rnode": torch.zeros(s, dtype=torch.int32),
               "t": torch.ones(s), "u": torch.tensor(up), "v": torch.tensor(vp)}
    hs_par = thit.get_hit_state_fused(attr, base, hit_par, torch.tensor(rd))
    for k in ("pos", "nrm", "geonrm", "uv0", "color"):
        np.testing.assert_allclose(hs_sub[k].numpy(), hs_par[k].numpy(), atol=1e-5, err_msg=k)
    ref = jhit.get_hit_state_fused(jnp.asarray(wb.hit_attr), jnp.asarray(wb.rn_attr_base),
                                   {k: jnp.asarray(x.numpy()) for k, x in hit_sub.items()}, jnp.asarray(rd))
    for k in hs_sub:
        _close(hs_sub[k], ref[k], k)


def test_subtri_refit_equals_reference(tmp_path):
    """The device refit on the split foliage tables: bake_world_tris through
    wtri_src_tri / wtri_bary within 2 ulp of the reference's, and every
    table refit_world_bvh refits bit for bit, from the same moved vertices
    and instance matrices."""
    _, _, tf = _flats("foliage", tmp_path)
    cls, cells = _classes(tf)
    wb = tbvh.add_kernel_tables(tbvh.build_world_bvh(tf, tri_class=cls, subtri_cells=cells),
                                {"bvh2", "bvh16", "lane"})
    rng = np.random.default_rng(5)
    vtx = (tf.vtx_pos + rng.normal(scale=0.01, size=tf.vtx_pos.shape)).astype(np.float32)
    o2w = tf.rn_o2w.copy()
    o2w[:, :3, 3] += rng.normal(scale=0.2, size=(o2w.shape[0], 3)).astype(np.float32)
    ref_tris = np.asarray(janim.bake_world_tris(
        jnp.asarray(vtx), jnp.asarray(tf.tri_idx), jnp.asarray(o2w), jnp.asarray(wb.wtri_rnode),
        jnp.asarray(wb.wtri_src_tri), wtri_bary=jnp.asarray(wb.wtri_bary)))
    tris = tanim.bake_world_tris(_t(vtx), _t(tf.tri_idx), _t(o2w), _t(wb.wtri_rnode), _t(wb.wtri_src_tri),
                                 _t(wb.wtri_bary))
    ulp = np.spacing(np.maximum(np.abs(ref_tris), 1e-30).astype(np.float32))
    assert (np.abs(tris.numpy() - ref_tris) <= 2 * ulp).all()
    virtual = wb.wtri_tri[:wb.num_world_tris] != wb.wtri_src_tri[:wb.num_world_tris]
    assert virtual.sum() > 100  # the split rows are rebaked from their parents
    ref = janim.refit_world_bvh(wb, jnp.asarray(ref_tris))
    port = tanim.refit_world_bvh(_tables(wb), _t(ref_tris))
    for what, r, p in zip(("nodes_f", "nodes_self", "nodes4_f", "tris", "nodes_fi", "tris128", "lane_pages",
                           "nodes4_fi", "nodes16_fi"), ref, port, strict=True):
        assert np.array_equal(_bits(p.numpy()), _bits(r)), what


def test_subtri_refit_parity(tmp_path):
    """tests/test_omm.py:363 on the port: a transform edit of the masked
    quads refits on the device (virtual rows present), and the refitted
    triangles and hit rows equal a fresh build of the moved scene (1e-5 /
    1e-4); the JAX renderer's refit of the same edit agrees as closely."""
    path = make_masked_quads(str(tmp_path))
    out = []
    for R, kw in ((GltfRenderer, {"device": "cpu"}), (JaxRenderer, {})):
        r = R(16, 16, spp=1, max_depth=2, **kw)
        r.create_scene(path)
        assert r.bvh.attr_rnode.shape[0] > 3
        r.scene.model.nodes[0]["translation"] = [0.25, -0.5, 0.125]
        r.scene.mark_dirty(DirtyFlags.NODE_TRANSFORMS)
        assert r.sync_scene_changes()
        out.append(r)
    port, ref = out
    nt = port.bvh.num_world_tris
    fresh = GltfRenderer(16, 16, spp=1, max_depth=2, device="cpu")
    fresh.scene = port.scene
    fresh.camera = port.camera
    fresh.rebuild_device_scene()
    assert fresh.bvh.num_world_tris == nt
    refit_tris = port.dev_bvh.refit.tris.numpy()[:nt, :9]
    np.testing.assert_allclose(refit_tris, fresh.bvh.tris[:nt, :9], atol=1e-5)
    np.testing.assert_allclose(port.dev_bvh.hit_attr.numpy(), fresh.bvh.hit_attr, atol=1e-4)
    np.testing.assert_allclose(port.dev_bvh.hit_attr.numpy(), np.asarray(ref.bvh.hit_attr), atol=1e-4)


def _foliage_device(tmp):
    """The foliage stand-in's flat and subtri BVH, the port's device copies
    and the scene's features."""
    path, jf, tf = _flats("foliage", tmp)
    cls, cells = _classes(tf)
    wb = jbvh.build_world_bvh(jf, tri_class=cls, subtri_cells=cells)
    scene_t, bvh_t, _ = from_reference(jf, wb, None, "cpu")
    sc = Scene()
    sc.load(path)
    feats = set(detect_scene_features(sc.model)) | {"textured"}
    return jf, wb, scene_t, bvh_t, frozenset(feats)


@pytest.fixture(scope="module")
def foliage(tmp_path_factory):
    return _foliage_device(tmp_path_factory.mktemp("foliage"))


def _random_hits(flat, wb, n, rng):
    """n hit states from random world rows, random barycentrics, uvs and
    vertex colours, over every material of the scene."""
    rows = rng.integers(0, wb.num_world_tris, n)
    u = rng.random(n).astype(np.float32) * 0.5
    v = rng.random(n).astype(np.float32) * 0.5
    hit = {"t": np.ones(n, np.float32), "rnode": wb.wtri_rnode[rows], "tri": wb.wtri_tri[rows], "u": u, "v": v}
    hs = {k: np.asarray(x) for k, x in jhit.get_hit_state_fused(
        jnp.asarray(wb.hit_attr), jnp.asarray(wb.rn_attr_base), {k: jnp.asarray(x) for k, x in hit.items()},
        jnp.asarray(np.tile(np.float32([[0.0, -1.0, 0.0]]), (n, 1)))).items()}
    hs["uv0"] = rng.random((n, 2)).astype(np.float32) * 1.5 - 0.25
    hs["color"] = rng.random((n, 4)).astype(np.float32)
    hs["color"][::3, 3] = 1.0
    return np.asarray(flat.rn_material)[hit["rnode"]], hs


@pytest.mark.parametrize("textured", [True, False])
def test_get_opacity_matches_reference(foliage, textured):
    """get_opacity on the foliage materials (OPAQUE ground, MASK atlas,
    BLEND atlas, BLEND constant alpha) at random uvs and vertex alphas,
    textured and not: within 1e-5, MASK values exactly 0 or 1."""
    jf, wb, scene_t, _, _ = foliage
    rng = np.random.default_rng(7)
    mat_id, hs = _random_hits(jf, wb, 4096, rng)
    assert set(np.unique(mat_id)) == {0, 1, 2, 3}
    ref = jmat.get_opacity(as_device(jf), jnp.asarray(mat_id), {k: jnp.asarray(x) for k, x in hs.items()},
                           textured=textured)
    port = tmat.get_opacity(scene_t, torch.tensor(mat_id), {k: torch.tensor(x) for k, x in hs.items()},
                            textured=textured)
    _close(port, ref, "opacity")
    p = port.numpy()
    assert (p[mat_id == 0] == 1.0).all() and np.isin(p[mat_id == 1], (0.0, 1.0)).all()
    assert ((p[mat_id >= 2] > 0) & (p[mat_id >= 2] < 1)).any()


def _canopy_rays(n, seed):
    """n rays from around the stand-in's camera into the canopy."""
    rng = np.random.default_rng(seed)
    ro = (np.float32([0.0, 1.9, 6.0]) + rng.normal(scale=0.3, size=(n, 3))).astype(np.float32)
    target = rng.uniform([-3.0, 0.0, -3.0], [3.0, 3.0, 3.0], size=(n, 3))
    rd = (target - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd.astype(np.float32)


def _seed(n, frame):
    return trng.xxhash32(torch.arange(n), torch.zeros(n, dtype=torch.int64), torch.full((n,), frame))


@pytest.mark.parametrize("masked", [False, True])
def test_trace_with_alpha_matches_reference(foliage, masked):
    """The primary trace with its alpha rounds on rays into the canopy: t,
    u, v within 1e-5, rnode / tri exact, the seed after the 4 rounds'
    draws exact; some lanes re-traced through a rejected hit, some ending
    on a virtual row. With a lane mask a third of the lanes are dead."""
    jf, wb, scene_t, bvh_t, feats = foliage
    n = 4096
    ro, rd = _canopy_rays(n, 11)
    alive = np.random.default_rng(12).random(n) > 1 / 3 if masked else np.ones(n, bool)
    seed = _seed(n, 2)
    cfg_r = jpt.RenderConfig(features=feats, alpha_any=True, traversal="wavefront")
    cfg_p = tpt.RenderConfig(features=feats, alpha_any=True)
    ref, seed_r = jpt._trace_with_alpha(as_device(jf), as_device(wb), jnp.asarray(ro), jnp.asarray(rd),
                                        jnp.asarray(seed.numpy().astype(np.uint32)), cfg_r,
                                        alive=jnp.asarray(alive))
    port, seed_p = tpt._trace_with_alpha(scene_t, bvh_t, torch.tensor(ro), torch.tensor(rd), seed, cfg_p,
                                         torch.tensor(alive), "v3")
    assert np.array_equal(seed_p.numpy().astype(np.uint32), np.asarray(seed_r))
    for k in ("rnode", "tri"):
        assert np.array_equal(port[k].numpy(), np.asarray(ref[k])), k
    hit = port["tri"].numpy() >= 0
    for k in ("t", "u", "v"):
        _close(port[k].numpy()[hit], np.asarray(ref[k])[hit], k)
    first = tpt.trace_closest(bvh_t, torch.tensor(ro), torch.tensor(rd), alive=torch.tensor(alive))
    retraced = first["tri"].numpy() != port["tri"].numpy()
    assert retraced.sum() > 50 and not (retraced & ~alive).any()
    n_tri = int(jf.prim_tri_count[jf.rn_prim[1]])
    assert (port["tri"].numpy()[port["rnode"].numpy() == 1] >= n_tri).any()  # a virtual row


def test_alpha_trace_shadow_matches_reference(foliage):
    """Shadow rays through the canopy without transmission: the alpha march
    (u >= opacity passes, a hit that does not pass blocks), its per-round
    draws and the final trace, on the live two thirds of the lanes."""
    jf, wb, scene_t, bvh_t, feats = foliage
    assert "transmission" not in feats
    n = 4096
    rng = np.random.default_rng(13)
    pos = rng.uniform([-3.0, 0.05, -3.0], [3.0, 0.2, 3.0], size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd[:, 1] = np.abs(rd[:, 1]) + 0.5
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    dist = np.where(np.arange(n) % 2 == 0, tpt.INFINITE, 3.0).astype(np.float32)
    alive = rng.random(n) > 1 / 3
    seed = _seed(n, 4)
    cfg_r = jpt.RenderConfig(features=feats, alpha_any=True, traversal="wavefront")
    cfg_p = tpt.RenderConfig(features=feats, alpha_any=True)
    ref, seed_r = jpt._trace_shadow(as_device(jf), as_device(wb), jnp.asarray(pos), jnp.asarray(rd),
                                    jnp.asarray(dist), jnp.asarray(seed.numpy().astype(np.uint32)), cfg_r)
    port, seed_p = tpt._trace_shadow(scene_t, bvh_t, torch.tensor(pos), torch.tensor(rd), torch.tensor(dist),
                                     seed, cfg_p, alive=torch.tensor(alive))
    assert np.array_equal(seed_p.numpy().astype(np.uint32), np.asarray(seed_r))
    _close(port.numpy()[alive], np.asarray(ref)[alive], "alpha shadow factor")
    t = port.numpy()[alive].max(-1)
    assert (t == 0).any() and (t == 1).any() and np.isin(t, (0.0, 1.0)).all()


_FRAMES = {}  # (scene path, package, level) -> tests/test_torch_frame.py's frames: each rendered once a run


def _frames_at_level(path, package, level):
    """Frames (48x32, spp 1, depth 3, the sky) of the scene at path from the
    JAX renderer ("jax") or the port's ("torch") at one acceleration level:
    "subtri" (the renderer's own classes), "whole" (VKGR_OMM_SUBTRI=0, which
    both renderers read) or "none" (_alpha_classes returning (None, None),
    what both return for an all-OPAQUE scene), the same override on each.
    Returns (frames, renderer)."""
    key = (path, package, level)
    if key not in _FRAMES:
        with pytest.MonkeyPatch.context() as mp:
            mp.delenv("VKGR_OMM_SUBTRI", raising=False)
            if level == "whole":
                mp.setenv("VKGR_OMM_SUBTRI", "0")
            if package == "jax":
                r = JaxRenderer(W, H, spp=1, max_depth=3)
            else:
                r = GltfRenderer(W, H, spp=1, max_depth=3, device="cpu")
            if level == "none":
                r._alpha_classes = lambda: (None, None)
            _FRAMES[key] = (_render(r, path, None), r)
    return _FRAMES[key]


@pytest.fixture(scope="module")
def blend_foliage(tmp_path_factory):
    """The 64-card foliage stand-in with its BLEND gradient cards and panes."""
    return _path("foliage", tmp_path_factory.mktemp("blend_foliage"))


@pytest.mark.parametrize("name,level", [("quads", "subtri"), ("foliage", "subtri"), ("foliage", "whole"),
                                        ("foliage", "none")])
@pytest.mark.usefixtures("one_torch_thread")
def test_alpha_frames_match_jax_renderer(name, level, blend_foliage, tmp_path):
    """Whole frames of the masked quads and of the foliage stand-in (MASK
    and BLEND materials) against the JAX renderer's at the same
    acceleration level (subtri, whole, none), each on its own RNG stream,
    at tests/test_torch_frame.py's thresholds."""
    path = blend_foliage if name == "foliage" else _path(name, tmp_path)
    ref, _ = _frames_at_level(path, "jax", level)
    port, r = _frames_at_level(path, "torch", level)
    assert r._config().alpha_any
    rows, src = r.bvh.attr_rnode.shape[0], r.flat.tri_idx.shape[0]
    assert {"subtri": rows > src, "whole": r.bvh.num_world_tris < src, "none": r.bvh.num_world_tris == src}[level]
    _assert_frames_agree(ref, port)


@pytest.mark.usefixtures("one_torch_thread")
def test_levels_differ_on_blend_foliage_as_in_the_reference(blend_foliage):
    """tests/test_omm.py:130's claim (the levels agree within 2e-3) does
    not hold for the JAX renderer on the foliage stand-in's BLEND surfaces:
    culling shifts which alpha round, and so which uniform, decides a BLEND
    surface (ROADMAP C). The port's whole and none frames differ from its
    subtri frame on the same pixels as the reference's: the masks of pixels
    past 2e-3 (the last frame's image) agree on at least 99% of pixels, and
    the reference's masks are not empty."""
    for level in ("whole", "none"):
        past = {}
        for package in ("jax", "torch"):
            img = _frames_at_level(blend_foliage, package, level)[0][-1][0]
            base = _frames_at_level(blend_foliage, package, "subtri")[0][-1][0]
            past[package] = np.abs(img - base).max(-1) > 2e-3
        assert past["jax"].any(), f"the reference's {level} frame agrees with its subtri frame"
        assert (past["jax"] == past["torch"]).mean() >= 0.99, (level, past["jax"].sum(), past["torch"].sum())


def _level_image(path, level, frames=3):
    r = GltfRenderer(32, 32, spp=1, max_depth=2, device="cpu")
    if level == "none":
        r._alpha_classes = lambda: (None, None)
    elif level == "whole":
        orig = r._alpha_classes
        r._alpha_classes = lambda: (orig()[0], None)
    r.create_scene(path)
    for _ in range(frames):
        r.on_render()
    return r


def _mask_only(path):
    """The scene at path with its BLEND materials made MASK (cutoff 0.5)."""
    import json

    g = json.loads(open(path).read())
    for m in g["materials"]:
        if m.get("alphaMode") == "BLEND":
            m["alphaMode"] = "MASK"
    open(path, "w").write(json.dumps(g))
    return path


@pytest.mark.parametrize("name", ["quads", "foliage_mask"])
def test_acceleration_levels_agree(name, tmp_path):
    """tests/test_omm.py:130 on the port: the frames of the subtri, whole
    and unclassified builds agree within 2e-3, and the classified builds
    hold fewer or split rows. This holds where every alpha decision is
    independent of its uniform (MASK opacity is 0 or 1) and no ray meets
    more than alpha_rounds rejecting surfaces: so the foliage stand-in at
    64 cards with its BLEND materials made MASK. With BLEND surfaces, or
    past the rounds, culling shifts which round (and so which uniform)
    decides a surface, and the levels differ on some pixels in the
    reference too (ROADMAP C)."""
    path = _path(name.split("_")[0], tmp_path)
    if name == "foliage_mask":
        path = _mask_only(path)
    runs = {level: _level_image(path, level) for level in ("subtri", "whole", "none")}
    assert (runs["none"].bvh.attr_alpha_class == tomm.ALPHA_MIXED).all()
    assert (runs["whole"].bvh.attr_alpha_class != tomm.ALPHA_MIXED).any()
    assert runs["whole"].bvh.num_world_tris < runs["none"].bvh.num_world_tris
    assert runs["subtri"].bvh.attr_rnode.shape[0] > runs["none"].bvh.attr_rnode.shape[0]
    imgs = {level: r.image_linear() for level, r in runs.items()}
    assert np.isfinite(imgs["subtri"]).all() and imgs["subtri"].mean() > 0.01
    np.testing.assert_allclose(imgs["whole"], imgs["none"], atol=2e-3)
    np.testing.assert_allclose(imgs["subtri"], imgs["none"], atol=2e-3)


def test_mask_to_opaque_edit_rebuilds_and_unculls(tmp_path, monkeypatch):
    """Flipping the MASK material to OPAQUE moves the classes: the sync
    rebuilds (one host BVH build) and the culled triangle and the split are
    undone; an edit that moves no class (roughness) rebuilds nothing."""
    from vk_gltf_renderer_tpu_torch import renderer as trenderer

    builds = []
    orig = trenderer.build_world_bvh
    monkeypatch.setattr(trenderer, "build_world_bvh", lambda *a, **k: builds.append(1) or orig(*a, **k))
    r = GltfRenderer(16, 16, spp=1, max_depth=2, device="cpu")
    r.create_scene(make_masked_quads(str(tmp_path)))
    assert len(builds) == 1 and r.bvh.attr_rnode.shape[0] > 3 and r.bvh.num_world_tris != 3
    r.scene.model.materials[0].setdefault("pbrMetallicRoughness", {})["roughnessFactor"] = 0.3
    r.scene.mark_dirty(DirtyFlags.MATERIALS)
    assert r.sync_scene_changes() and len(builds) == 1
    r.scene.model.materials[0]["alphaMode"] = "OPAQUE"
    r.scene.mark_dirty(DirtyFlags.MATERIALS)
    assert r.sync_scene_changes() and len(builds) == 2
    assert r.bvh.num_world_tris == 3 and r.bvh.attr_rnode.shape == (3,)
    assert r._alpha_cls is None and not r._config().alpha_any
    r.on_render()
    assert np.isfinite(r.image_linear()).all()


def test_whole_classes_under_omm_subtri_0(tmp_path, monkeypatch):
    """VKGR_OMM_SUBTRI=0 keeps whole-triangle classes (no virtual rows), as
    in the reference; an all-OPAQUE scene builds no classes at all."""
    monkeypatch.setenv("VKGR_OMM_SUBTRI", "0")
    r = GltfRenderer(16, 16, spp=1, max_depth=2, device="cpu")
    r.create_scene(make_masked_quads(str(tmp_path)))
    assert r._subtri_cells is None and r.bvh.num_world_tris == 2 and r.bvh.attr_rnode.shape == (3,)
    r.scene.model.materials[0]["alphaMode"] = "OPAQUE"
    r.rebuild_device_scene()
    assert r._alpha_classes() == (None, None) and r.bvh.num_world_tris == 3


def test_virtual_ids_survive_every_plain_walk(foliage):
    """On the split foliage tables every traversal family's plain walk
    (BVH4, BVH2, BVH16, the lane walk, the split BVH4 and binary walks and
    the wavefront walk) returns the virtual tri ids unchanged: the same
    closest-hit t bit for bit and the same (rnode, tri) but for equal-t
    ties, some of them past their primitive's triangle count."""
    from vk_gltf_renderer_tpu_torch.convert import SPLIT_FAMILIES, add_kernel_tables_to_device
    from vk_gltf_renderer_tpu_torch.ops import intersect

    jf, wb, _, _, _ = foliage
    _, bvh, _ = from_reference(None, wb, None, "cpu")  # the reference's tables, every family
    add_kernel_tables_to_device(bvh, wb, "cpu", {"bvh4_multipop"})
    assert set(SPLIT_FAMILIES) <= set(bvh.stack_need) | {"wavefront"}
    n = 2048
    ro, rd = _canopy_rays(n, 17)
    ro_t, rd_t = torch.tensor(ro), torch.tensor(rd)
    comps = intersect.soa_columns(ro_t, rd_t)
    tmin, tmax = torch.zeros(n), torch.full((n,), tpt.INFINITE)
    base = intersect.intersect_rays_soa(bvh, *comps, tmin, tmax, kernel="v3")
    hit = base["tri"] >= 0
    n_tri = torch.tensor(jf.prim_tri_count[jf.rn_prim])[base["rnode"].clamp(min=0).long()]
    assert int((hit & (base["tri"] >= n_tri)).sum()) > 20
    outs = {k: intersect.intersect_rays_soa(bvh, *comps, tmin, tmax, kernel=k)
            for k in ("v2", "v6", "lane", "v5", "v7", "v8")}
    outs["packet4"] = intersect.intersect_rays_packet(bvh, ro_t, rd_t, wide=True)
    outs["v1"] = intersect.intersect_rays_packet(bvh, ro_t, rd_t, v2=False)
    outs["wavefront"] = intersect.intersect_rays_wavefront(bvh, ro_t, rd_t)
    for name, o in outs.items():
        assert torch.equal(o["tri"] >= 0, hit), name
        assert _same(o["t"], base["t"]), name
        same = (o["tri"] == base["tri"]) & (o["rnode"] == base["rnode"])
        assert int((~same).sum()) <= n // 200, name
    assert ttrav.INFINITE == tpt.INFINITE


def _same(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_check_supported_takes_alpha_and_the_plane():
    """Alpha (A5), the infinite plane (A8), the denoiser guides and TAA
    jitter (A7), batched spp and primary-hit seeding (A12) no longer raise;
    with alpha the renderer leaves seeding off, and the seeding's tables are
    named only when it is on."""
    tpt.RenderConfig(alpha_any=True, use_infinite_plane=True, plane_shadow_catcher=True).check_supported()
    tpt.RenderConfig(alpha_any=True, denoise_guides=True, taa_jitter=True).check_supported()
    for kw in ({"spp_batch": True, "spp": 2}, {"primary_seed": True}):
        tpt.RenderConfig(alpha_any=True, **kw).check_supported()
    assert "primary_seed" in tpt.RenderConfig(primary_seed=True).kernel_tables()
    assert "primary_seed" not in tpt.RenderConfig(alpha_any=True).kernel_tables()
    assert tpt.RenderConfig().alpha_rounds == jpt.RenderConfig().alpha_rounds == 4
    assert WORLD_FIELDS  # the fields _assert_world_bvh_same compares
