"""VKGR_BVH=sbvh on the port: the spatial-split builder against the JAX
package's, every traversal family on its tables, and frames.

The builder (_build_sbvh, _clip_tri_slab) and _emit2ref are source-equal
copies, so every table of the port's WorldBvh equals the reference's
exactly, emit2ref and the kernel tables of add_kernel_tables included. The
scene is scenes.make_sliver_soup: long thin triangles whose object-split
children overlap, so spatial splits duplicate references (its 1,500
triangles make 2,250 tris rows, the reference's cap of 1.5x), and every
table family carries repeated triangles.

Each family's plain walk on the SBVH tables finds the port's brute-force
closest hits (the brute oracle intersects in object space: t to 1e-4) and
the SAH tables' hits: t bit for bit (every copy is the whole triangle, so
a hit's t does not depend on which copy the walk met), ids equal except
where two triangles tie at one t; any-hit occlusion equal. Frames: the
port's SBVH frame against the JAX package's SBVH frame at the thresholds
of tests/test_torch_frame.py, and against the port's SAH frame, equal
except at tie pixels."""

import inspect
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))

from vk_gltf_renderer_tpu.models import Scene  # noqa: E402
from vk_gltf_renderer_tpu.ops import bvh_flatten as jbvh  # noqa: E402
from vk_gltf_renderer_tpu.ops import flat as jflat  # noqa: E402
from vk_gltf_renderer_tpu.renderer import GltfRenderer as JaxRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch.convert import SPLIT_FAMILIES, add_kernel_tables_to_device, bvh_to_device  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import bvh_flatten as tbvh  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import flat as tflat  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import pathtrace as tpt  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse as ttrav  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops.intersect import (ROUTES, intersect_rays_packet, intersect_rays_soa,  # noqa: E402
                                                      intersect_rays_wavefront, soa_columns)
from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch.scenes import make_sliver_soup  # noqa: E402
from test_torch_frame import _assert_frames_agree, _render, H, W, DEPTH  # noqa: E402
from test_torch_seed_batch import _assert_equal_but_ties  # noqa: E402
from test_torch_host import WORLD_FIELDS, _assert_same, _assert_world_bvh_same, _editor  # noqa: E402
from test_torch_traverse import _rays  # noqa: E402
from torch_test_helpers import one_torch_thread, share_native_builder  # noqa: E402, F401 (a fixture)

share_native_builder()

ALL_TABLES = {"bvh2", "bvh16", "lane", "bvh4_sidecar"}
# every packet kernel name, one per table family, and the split and wavefront traversals
WALKS = ["v3", "v5", "v7", "v8", "v2", "v6", "lane", "packet4", "v1", "wavefront"]


def _soup_scene(tmp_path):
    sc = Scene()
    sc.load(make_sliver_soup(str(tmp_path)))
    return sc


@pytest.fixture(scope="module")
def soup(tmp_path_factory):
    """(flat, SBVH WorldBvh, its CPU DeviceBvh, SAH WorldBvh, its DeviceBvh)."""
    sc = _soup_scene(tmp_path_factory.mktemp("soup"))
    flat = tflat.build_scene_flat(sc)
    mp = pytest.MonkeyPatch()
    mp.setenv("VKGR_BVH", "sbvh")
    try:
        sb = tbvh.add_kernel_tables(tbvh.build_world_bvh(flat), ALL_TABLES)
    finally:
        mp.undo()
    sah = tbvh.add_kernel_tables(tbvh.build_world_bvh(flat), ALL_TABLES)
    devs = [add_kernel_tables_to_device(bvh_to_device(wb, "cpu"), wb, "cpu",
                                        set(SPLIT_FAMILIES) | {"bvh4_multipop"}) for wb in (sb, sah)]
    return flat, sb, devs[0], sah, devs[1]


@pytest.mark.parametrize("name", ["_build_sbvh", "_clip_tri_slab", "_emit2ref"])
def test_copies_are_source_equal(name):
    assert inspect.getsource(getattr(tbvh, name)) == inspect.getsource(getattr(jbvh, name))


@pytest.mark.parametrize("scene", ["soup", "editor"])
def test_sbvh_world_bvh_equals_reference(scene, tmp_path, monkeypatch):
    """Every field and kernel table of the port's SBVH WorldBvh equals the
    reference's, emit2ref included; the soup duplicates references."""
    monkeypatch.setenv("VKGR_BVH", "sbvh")
    sc = _soup_scene(tmp_path) if scene == "soup" else _editor(tmp_path)
    ref = jbvh.build_world_bvh(jflat.build_scene_flat(sc))
    port = tbvh.add_kernel_tables(tbvh.build_world_bvh(tflat.build_scene_flat(sc)),
                                  ALL_TABLES)
    _assert_world_bvh_same(ref, port)
    for k in ("nodes16_fi", "map16", "lane_pages", "lane_geo_idx", "nodes4_sc", "nodes_fi"):
        _assert_same(getattr(ref, k), getattr(port, k), k)
    assert port.builder == "sbvh" and port.root_code == ref.root_code
    nrefs = port.tris.shape[0] - tbvh.LEAF_SIZE
    if scene == "soup":
        assert nrefs == 2250 and port.num_world_tris == 1500
        # every triangle has a row, and emit2ref names one of its rows
        assert set(port.wtri_tri[:nrefs].tolist()) == set(range(1500))
        rows = port.emit2ref[port.wtri_tri[:nrefs]]
        assert (port.wtri_tri[rows] == port.wtri_tri[:nrefs]).all()
    assert "emit2ref" in WORLD_FIELDS


def test_sbvh_routing_and_cap(tmp_path, monkeypatch):
    """sbvh takes the spatial-split builder up to 300,000 triangles and the
    native SAH above (the reference's cap), recording which ran."""
    flat = tflat.build_scene_flat(_soup_scene(tmp_path))
    monkeypatch.setenv("VKGR_BVH", "sbvh")
    assert tbvh.build_world_bvh(flat).builder == "sbvh"
    monkeypatch.setattr(tbvh, "_SAH_NUMPY_MAX_TRIS", 1000)
    above = tbvh.build_world_bvh(flat)
    monkeypatch.delenv("VKGR_BVH")
    sah = tbvh.build_world_bvh(flat)
    assert above.builder == sah.builder == "sah"
    assert np.array_equal(above.nodes4_fi, sah.nodes4_fi) and np.array_equal(above.emit2ref, sah.emit2ref)


def _walk(dev, ro, rd, tmax, walk, anyhit=False):
    ro_t, rd_t = torch.tensor(ro), torch.tensor(rd)
    n = ro.shape[0]
    tmin = torch.zeros(n)
    tmax_t = torch.tensor(tmax)
    if walk == "packet4":
        out = intersect_rays_packet(dev, ro_t, rd_t, tmin, tmax_t, anyhit=anyhit, wide=True)
    elif walk == "v1":
        out = intersect_rays_packet(dev, ro_t, rd_t, tmin, tmax_t, anyhit=anyhit, wide=False)
    elif walk == "wavefront":
        out = intersect_rays_wavefront(dev, ro_t, rd_t, tmin, tmax_t)
    else:
        out = intersect_rays_soa(dev, *soa_columns(ro_t, rd_t), tmin, tmax_t, anyhit=anyhit, kernel=walk)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("walk", WALKS)
def test_walks_on_sbvh_tables_find_the_closest_hits(soup, walk):
    flat, sb, dev_sb, sah, dev_sah = soup
    ro, rd, tmax = _rays(sb, 512, seed=21)
    got = _walk(dev_sb, ro, rd, tmax, walk)
    ref = _walk(dev_sah, ro, rd, tmax, walk)
    hit = ref["tri"] >= 0
    assert hit.sum() > 150
    assert np.array_equal(got["t"].view(np.int32), ref["t"].view(np.int32))
    same = (got["tri"] == ref["tri"]) & (got["rnode"] == ref["rnode"])
    assert same.mean() > 0.99  # ties only
    brute = {k: v.numpy() for k, v in ttrav.intersect_brute(flat, torch.tensor(ro), torch.tensor(rd)).items()}
    live = tmax > 0
    bhit = brute["t"] < 1e30
    assert ((got["tri"] >= 0)[live] == bhit[live]).all()
    np.testing.assert_allclose(got["t"][live & bhit], brute["t"][live & bhit], rtol=1e-4, atol=1e-4)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("walk", ["v3", "v5", "v7", "v8", "v2", "v6", "lane", "packet4", "v1"])
def test_any_hit_on_sbvh_tables(soup, walk):
    """Segments ending halfway to the closest hit or past it: occlusion
    on the SBVH tables equals the SAH tables'."""
    _, sb, dev_sb, _, dev_sah = soup
    ro, rd, tmax = _rays(sb, 512, seed=22)
    closest = _walk(dev_sah, ro, rd, tmax, "v3")
    hit = closest["tri"] >= 0
    tmax = np.where(hit, closest["t"] * np.where(np.arange(512) % 2, 1.5, 0.5), tmax).astype(np.float32)
    got = _walk(dev_sb, ro, rd, tmax, walk, anyhit=True)
    ref = _walk(dev_sah, ro, rd, tmax, walk, anyhit=True)
    occ = ref["tri"] >= 0
    assert occ.sum() > 60 and (occ <= hit).all()
    assert ((got["tri"] >= 0) == occ).all()


def test_stack_needs_fit_on_sbvh_tables(soup):
    """Every family's stack need on the (deeper) SBVH tables, within its
    kernel's capacity."""
    from vk_gltf_renderer_tpu_torch.ops.intersect import STACK_CAPACITY

    _, sb, dev_sb, sah, dev_sah = soup
    for family, need in dev_sb.stack_need.items():
        assert need <= STACK_CAPACITY[family], family
    assert set(dev_sb.stack_need) >= set(ROUTES.values()) - {"lane"}
    assert dev_sb.stack_need["bvh4"] >= dev_sah.stack_need["bvh4"] - 2


@pytest.mark.usefixtures("one_torch_thread")
def test_sbvh_frames_match_jax_and_the_sah_frames(tmp_path, monkeypatch):
    path = make_sliver_soup(str(tmp_path))
    sah = _render(GltfRenderer(W, H, spp=1, max_depth=DEPTH, device="cpu"), path, None)
    monkeypatch.setenv("VKGR_BVH", "sbvh")
    ref = _render(JaxRenderer(W, H, spp=1, max_depth=DEPTH), path, None)
    r = GltfRenderer(W, H, spp=1, max_depth=DEPTH, device="cpu")
    port = _render(r, path, None)
    assert r.bvh.builder == "sbvh" and r.bvh.tris.shape[0] - 8 > r.bvh.num_world_tris
    _assert_frames_agree(ref, port)
    for (img_s, aux_s), (img_p, aux_p) in zip(sah, port, strict=True):
        same = (aux_s["first_tri"] == aux_p["first_tri"]) & (aux_s["first_rnode"] == aux_p["first_rnode"])
        assert same.mean() >= 0.999
        # paths that part at a tie differ wholesale; the rest are the same paths
        close = (np.abs(img_s - img_p) <= 1e-5 * (1 + np.abs(img_s))).all(axis=-1)
        assert close.mean() >= 0.99


SEED_W, SEED_H, SEED_DEPTH = 96, 64, 3  # slivers thinner than a 48x32 pixel keep few seeds


def _seed_frames(renderer, path, n=3):
    renderer.create_scene(path)
    out = []
    for _ in range(n):
        aux = renderer.on_render()
        out.append((np.array(renderer.image_linear()), {k: np.asarray(v.cpu() if hasattr(v, "cpu") else v)
                                                        for k, v in aux.items()}))
    return out


@pytest.mark.usefixtures("one_torch_thread")
def test_seeded_sbvh_frames_equal_unseeded_and_the_jax_seeded_frames(tmp_path, monkeypatch):
    """Seeding on the soup's SBVH tables, where emit2ref names one of a
    triangle's several rows: the seeded frames equal the unseeded ones except
    at ties, and a frame seeded from its own first hits (the same jitter)
    keeps every seed, at 96x64. The seeded frames agree with the JAX
    package's seeded SBVH frames at the frame tests' size and thresholds
    (at 96x64 one grazing sliver pixel's first hit differs between XLA's
    contracted products and torch's, seeded or not, and its path's length
    with it, so the rays counts part by 2)."""
    path = make_sliver_soup(str(tmp_path))
    monkeypatch.setenv("VKGR_BVH", "sbvh")
    plain = _seed_frames(GltfRenderer(SEED_W, SEED_H, spp=1, max_depth=SEED_DEPTH, device="cpu"), path)
    monkeypatch.setenv("VKGR_PRIMARY_SEED", "1")
    calls = []
    seed_hits = tpt._primary_seed_hits

    def kept(bvh, ro, rd, prev_ref):
        out = seed_hits(bvh, ro, rd, prev_ref)
        calls.append((prev_ref.clone(), out[5].clone()))
        return out

    monkeypatch.setattr(tpt, "_primary_seed_hits", kept)
    r = GltfRenderer(SEED_W, SEED_H, spp=1, max_depth=SEED_DEPTH, device="cpu")
    seeded = _seed_frames(r, path)
    wb = r.bvh
    assert r._config().primary_seed and wb.builder == "sbvh" and wb.tris.shape[0] - 8 > wb.num_world_tris
    n_rows = np.bincount(wb.wtri_tri[wb.wtri_tri >= 0], minlength=wb.num_world_tris)

    def copies(prev_ref, valid):  # kept seeds on a row of a triangle that has other rows
        ref = prev_ref.numpy()[valid.numpy()]
        return int((n_rows[wb.wtri_tri[ref]] > 1).sum())

    assert not calls[0][1].any() and sum(copies(*c) for c in calls[1:]) >= 10
    _assert_equal_but_ties(plain, seeded)
    jax_seeded = _render(JaxRenderer(W, H, spp=1, max_depth=DEPTH), path, None)
    _assert_frames_agree(jax_seeded, _render(GltfRenderer(W, H, spp=1, max_depth=DEPTH, device="cpu"), path, None))

    # the same frame again, seeded from its own first hits: every hit's seed stands
    cfg = r._config()
    frame = r._frame_inputs(cfg)
    unseeded_cfg = tpt.RenderConfig(**{**cfg.__dict__, "primary_seed": False})
    base, aux = tpt.render_frame_flat(r.dev_scene, r.dev_bvh, r._env(), frame, unseeded_cfg)
    frame["prev_first_rnode"], frame["prev_first_tri"] = aux["first_rnode"], aux["first_tri"]
    again, aux2 = tpt.render_frame_flat(r.dev_scene, r.dev_bvh, r._env(), frame, cfg)
    prev_ref, valid = calls[-1]
    assert torch.equal(valid, aux["first_tri"] >= 0) and copies(prev_ref, valid) >= 20
    assert torch.equal(aux2["first_tri"], aux["first_tri"]) and torch.equal(again, base)
