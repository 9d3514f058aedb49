"""The port's CUDA kernels against their plain torch versions, on the card.

Marked `cuda`: each test skips without an NVIDIA GPU (decided inside the
fixture, never at import). Run them on the card with
`python -m pytest --noconftest tests/test_torch_cuda.py` (tests/conftest.py
imports jax, which the card's machine lacks); chip_smoke.py runs the same
comparisons at the main path's shapes."""

import tempfile

import numpy as np
import pytest
import torch

from vk_gltf_renderer_tpu_torch.convert import add_kernel_tables_to_device, bvh_to_device
from vk_gltf_renderer_tpu_torch.models import Scene
from vk_gltf_renderer_tpu_torch.ops import gather as tgather
from vk_gltf_renderer_tpu_torch.ops import lane_traverse as tlane
from vk_gltf_renderer_tpu_torch.ops import megakernel as tmega
from vk_gltf_renderer_tpu_torch.ops import traverse as ttrav
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh2 as tb2
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4_leafqueue as tblq
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4_multipop as tbmp
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4_sidecar as tbsc
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh16 as tb16
from vk_gltf_renderer_tpu_torch.ops.bvh_flatten import add_kernel_tables, build_world_bvh
from vk_gltf_renderer_tpu_torch.ops.flat import build_scene_flat
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh2_split as tb2s
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4_split as tb4s
from vk_gltf_renderer_tpu_torch.ops.intersect import intersect_rays_packet, intersect_rays_soa
from vk_gltf_renderer_tpu_torch.probes import nodefetch as tnf
from vk_gltf_renderer_tpu_torch.probes import visit as tvis
from vk_gltf_renderer_tpu_torch.scenes import make_helmet_standin, write_large_glb

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _helmet_bvh():
    with tempfile.TemporaryDirectory() as d:
        sc = Scene()
        sc.load(make_helmet_standin(d))
        return build_world_bvh(build_scene_flat(sc))


@pytest.mark.parametrize("anyhit", [False, True])
def test_traversal_kernel_matches_plain(cuda, anyhit):
    wb = _helmet_bvh()
    bvh = bvh_to_device(wb, cuda)
    rng = np.random.default_rng(31)
    n = 20000
    lo, hi = wb.nodes_self[0, 0:3], wb.nodes_self[0, 3:6]
    ro = (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmax = np.full(n, 3.0 if anyhit else 1e32, np.float32)
    tmax[::101] = -1.0
    comps = [torch.tensor(np.ascontiguousarray(a), device=cuda) for a in (*ro.T, *rd.T)]
    args = (*comps, torch.zeros(n, device=cuda), torch.tensor(tmax, device=cuda))
    launches = tb4.COUNTER.launches
    tb4.OVERFLOW.reset()
    k = intersect_rays_soa(bvh, *args, anyhit=anyhit, kernel="v3")
    torch.cuda.synchronize()
    assert tb4.COUNTER.launches == launches + 1
    from vk_gltf_renderer_tpu_torch.ops.traverse import traverse_bvh4_plain

    t, rn, tri, u, v, dropped = traverse_bvh4_plain(bvh.nodes4_fi, bvh.tris128, bvh.root4_code, *args,
                                                    anyhit=anyhit)
    assert dropped == 0 and tb4.OVERFLOW.total() == 0
    hit = tri >= 0
    assert torch.equal(k["tri"] >= 0, hit)
    if not anyhit:
        same = (k["tri"] == tri) & (k["rnode"] == rn)
        tie = torch.isclose(k["t"], torch.where(hit, t, k["t"]), rtol=1e-6, atol=0)
        assert bool((same | tie).all())
        torch.testing.assert_close(k["t"][hit], t[hit], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(k["u"][same & hit], u[same & hit], rtol=0, atol=1e-5)


def _terrain_bvh():
    with tempfile.TemporaryDirectory() as d:
        write_large_glb(d + "/terrain.glb", target_tris=40_000, grid=4)
        sc = Scene()
        sc.load(d + "/terrain.glb")
        return build_world_bvh(build_scene_flat(sc))


# kernel value -> (wrapper module, plain version, DeviceBvh tables, root code attribute)
NEW = {
    "v2": (tb2, ttrav.traverse_bvh2_plain, ("nodes_fi", "tris128"), "root_code"),
    "v6": (tb16, ttrav.traverse_bvh16_plain, ("nodes16_fi", "tris128"), None),
    "lane": (tlane, ttrav.traverse_lanes_plain, ("lane_entries",), None),
    "v5": (tbmp, ttrav.traverse_bvh4_multipop_plain, ("nodes4_fi", "tris128"), "root4_code"),
    "v7": (tbsc, ttrav.traverse_bvh4_sidecar_plain, ("nodes4_fi", "nodes4_sc", "tris128"),
           "root4_code"),
    "v8": (tblq, ttrav.traverse_bvh4_leafqueue_plain, ("nodes4_fi", "tris128"), "root4_code"),
}
TABLES = {"bvh2", "bvh16", "lane", "bvh4_sidecar", "bvh4_multipop"}


@pytest.mark.parametrize("scene", ["helmet", "terrain"])
@pytest.mark.parametrize("kernel", sorted(NEW))
@pytest.mark.parametrize("anyhit", [False, True])
def test_new_traversal_kernels_match_plain(cuda, scene, kernel, anyhit):
    """BVH2, BVH16, the lane walk and the BVH4 variants v5, v7 and v8
    against their plain versions on the card: ids equal except on equal-t
    ties, t/u/v within 1e-5, occlusion equal, nothing dropped, one launch
    counted."""
    wb = add_kernel_tables(_helmet_bvh() if scene == "helmet" else _terrain_bvh(), TABLES)
    bvh = add_kernel_tables_to_device(bvh_to_device(wb, cuda), wb, cuda, TABLES)
    mod, plain, tables, root = NEW[kernel]
    rng = np.random.default_rng(33)
    n = 20000
    lo, hi = wb.nodes_self[0, 0:3], wb.nodes_self[0, 3:6]
    ro = (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmax = np.full(n, 1.0 if anyhit else 1e32, np.float32)
    tmax[::101] = -1.0
    comps = [torch.tensor(np.ascontiguousarray(a), device=cuda) for a in (*ro.T, *rd.T)]
    args = (*comps, torch.zeros(n, device=cuda), torch.tensor(tmax, device=cuda))
    launches = mod.COUNTER.launches
    mod.OVERFLOW.reset()
    k = intersect_rays_soa(bvh, *args, anyhit=anyhit, kernel=kernel)
    torch.cuda.synchronize()
    assert mod.COUNTER.launches == launches + 1
    tables = [getattr(bvh, name) for name in tables]
    if kernel != "lane":
        tables.append(getattr(bvh, root) if root else 0)
    t, rn, tri, u, v, dropped = plain(*tables, *args, anyhit=anyhit)
    assert dropped == 0 and mod.OVERFLOW.total() == 0
    hit = tri >= 0
    assert int(hit.sum()) > 100
    assert torch.equal(k["tri"] >= 0, hit)
    if not anyhit:
        same = (k["tri"] == tri) & (k["rnode"] == rn)
        tie = torch.isclose(k["t"], torch.where(hit, t, k["t"]), rtol=1e-6, atol=0)
        assert bool((same | tie).all())
        torch.testing.assert_close(k["t"][hit], t[hit], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(k["u"][same & hit], u[same & hit], rtol=0, atol=1e-5)
        torch.testing.assert_close(k["v"][same & hit], v[same & hit], rtol=0, atol=1e-5)


def test_gather_kernel_matches_plain(cuda):
    rng = np.random.default_rng(32)
    tab = torch.tensor(rng.normal(size=(4, 8192)).astype(np.float32), device=cuda)
    idx = torch.tensor(rng.integers(0, 8192, 100_003).astype(np.int32), device=cuda)
    launches = tgather.COUNTER.launches
    out = tgather.gather_channels(tab, idx)
    assert tgather.COUNTER.launches == launches + 1
    assert torch.equal(out, tgather.gather_channels_plain(tab, idx))
    assert torch.equal(tgather.gather_channels(tab[2:4], idx), tab[2:4][:, idx.long()])


@pytest.mark.parametrize("scene", ["helmet", "terrain"])
def test_megakernel_matches_wavefront_and_plain(cuda, scene):
    """render_mega (csrc/megakernel.cu) against render_wavefront (one
    traverse_bvh4 launch per bounce) and against its plain version, depth
    3: the same arithmetic in the same order, so radiance and t are equal
    except on equal-t ties (which change neither); nothing dropped."""
    wb = _helmet_bvh() if scene == "helmet" else _terrain_bvh()
    rng = np.random.default_rng(34)
    n = 20000
    lo, hi = wb.nodes_self[0, 0:3], wb.nodes_self[0, 3:6]
    ro = (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    seeds = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    packed = tmega.pack_rays(ro, rd, seeds, device=cuda)[:3]
    tables = (torch.tensor(wb.nodes4_fi, device=cuda), torch.tensor(wb.tris128, device=cuda))
    launches = tmega.COUNTER.launches
    tmega.OVERFLOW.reset()
    mega = tmega.render_mega(*tables, *packed, depth=3, root_code=wb.root4_code)
    torch.cuda.synchronize()
    assert tmega.COUNTER.launches == launches + 1
    wave = tmega.render_wavefront(*tables, *packed, depth=3, root_code=wb.root4_code)
    plain = tmega.render_mega_plain(*tables, *packed, depth=3, root_code=wb.root4_code)
    assert tmega.OVERFLOW.total() == 0
    assert torch.equal(mega, wave) and torch.equal(mega, plain)
    rad = mega[:, 0].reshape(-1)[:n]
    assert bool((rad > 0).any()) and bool((rad == 0).any())


# split kernel -> (wrapper module, plain version, DeviceBvh tables, table family)
SPLIT = {
    "packet4": (tb4s, ttrav.traverse_bvh4_split_plain, ("nodes4_f", "nodes4_i", "tris"),
                "bvh4_split"),
    "v1": (tb2s, ttrav.traverse_bvh2_split_plain, ("nodes_f", "nodes_i", "tris"), "bvh2_split"),
}


@pytest.mark.parametrize("scene", ["helmet", "terrain"])
@pytest.mark.parametrize("kernel", sorted(SPLIT))
def test_split_traversal_kernels_match_plain(cuda, scene, kernel):
    """The packet4 and v1 kernels through intersect_rays_packet against
    their plain versions on the card: ids equal except on equal-t ties,
    t/u/v within 1e-5, nothing dropped, one launch counted; anyhit=True
    returns the closest hit (neither kernel has an any-hit mode)."""
    mod, plain, tables, family = SPLIT[kernel]
    wb = _helmet_bvh() if scene == "helmet" else _terrain_bvh()
    bvh = add_kernel_tables_to_device(bvh_to_device(wb, cuda), wb, cuda, {family})
    rng = np.random.default_rng(35)
    n = 20000
    lo, hi = wb.nodes_self[0, 0:3], wb.nodes_self[0, 3:6]
    ro = (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmax = np.full(n, 1e32, np.float32)
    tmax[::101] = -1.0
    ro_t, rd_t, tmax_t = (torch.tensor(a, device=cuda) for a in (ro, rd, tmax))
    kw = {"wide": True} if kernel == "packet4" else {"v2": False}
    launches = mod.COUNTER.launches
    mod.OVERFLOW.reset()
    k = intersect_rays_packet(bvh, ro_t, rd_t, 0.0, tmax_t, **kw)
    torch.cuda.synchronize()
    assert mod.COUNTER.launches == launches + 1
    k_any = intersect_rays_packet(bvh, ro_t, rd_t, 0.0, tmax_t, anyhit=True, **kw)
    assert all(torch.equal(k[f], k_any[f]) for f in k)
    comps = [ro_t[:, c].contiguous() for c in range(3)] + [rd_t[:, c].contiguous() for c in range(3)]
    t, _, row, u, v, dropped = plain(*(getattr(bvh, name) for name in tables), *comps,
                                     torch.zeros(n, device=cuda), tmax_t)
    assert dropped == 0 and mod.OVERFLOW.total() == 0
    hit = row >= 0
    assert int(hit.sum()) > 100 and torch.equal(k["tri"] >= 0, hit)
    safe = row.clamp(min=0).long()
    same = (k["tri"] == bvh.wtri_tri[safe]) & (k["rnode"] == bvh.wtri_rnode[safe])
    tie = torch.isclose(k["t"], torch.where(hit, t, k["t"]), rtol=1e-6, atol=0)
    assert bool((same | tie | ~hit).all())
    torch.testing.assert_close(k["t"][hit], t[hit], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(k["u"][same & hit], u[same & hit], rtol=0, atol=1e-5)
    torch.testing.assert_close(k["v"][same & hit], v[same & hit], rtol=0, atol=1e-5)


@pytest.mark.parametrize("variant", tnf.VARIANTS)
def test_probe_nodefetch_matches_plain(cuda, variant):
    """The node-fetch kernel computes the plain version's float32 ops in
    the same order (no contraction: -fmad=false): equal, for every variant
    name and on a random-cycle table."""
    tab, start, rox = tnf.tpu_inputs(cuda)
    launches = tnf.COUNTER.launches
    out = tnf.probe_nodefetch(tnf.variant_table(tab, variant), start, rox, 256)
    assert tnf.COUNTER.launches == launches + 1
    assert torch.equal(out, tnf.probe_nodefetch_plain(tab, start, rox, 256))
    tab, start, rox = tnf.chain_inputs(100_003, cuda, seed=3)
    plain = tnf.probe_nodefetch_plain(tab, start, rox, 256)
    assert torch.equal(tnf.probe_nodefetch(tab, start, rox, 256), plain)
    assert torch.equal(tnf.probe_nodefetch(tab, start, rox, 256, block=32), plain)


@pytest.mark.parametrize("variant", sorted(tvis.VARIANTS))
def test_probe_visit_matches_plain(cuda, variant):
    fi, sc = (torch.tensor(a, device=cuda) for a in tvis.make_tables())
    ro = torch.tensor(tvis.make_rays(), device=cuda)
    launches = tvis.COUNTER.launches
    out = tvis.probe_visit(fi, sc, ro, 512, variant)
    assert tvis.COUNTER.launches == launches + 1
    assert torch.equal(out, tvis.probe_visit_plain(fi, sc, ro, 512, variant))
