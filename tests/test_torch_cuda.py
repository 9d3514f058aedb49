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
from vk_gltf_renderer_tpu_torch.probes import stream_dma as tsd
from vk_gltf_renderer_tpu_torch.probes import uarch as tua
from vk_gltf_renderer_tpu_torch.probes import visit as tvis
from vk_gltf_renderer_tpu_torch.scenes import make_foliage_standin, make_helmet_standin, write_large_glb
from torch_test_helpers import deep_chain, deep_chain_bvh4, deep_chain_rays, deep_chain_split

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


def _foliage_bvh(cards=1024):
    """The foliage stand-in's culled and split tables (subtriangle classes):
    virtual tri ids past each primitive's triangle count."""
    from vk_gltf_renderer_tpu_torch.ops.omm import classify_attr_alpha, classify_subtri

    with tempfile.TemporaryDirectory() as d:
        sc = Scene()
        sc.load(make_foliage_standin(d, cards=cards))
        flat = build_scene_flat(sc)
        cls = classify_attr_alpha(flat)
        return build_world_bvh(flat, tri_class=cls, subtri_cells=classify_subtri(flat, cls))


SCENE_BVH = {"helmet": _helmet_bvh, "terrain": _terrain_bvh, "foliage": _foliage_bvh}


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


@pytest.mark.parametrize("scene", ["helmet", "terrain", "foliage"])
@pytest.mark.parametrize("kernel", sorted(NEW))
@pytest.mark.parametrize("anyhit", [False, True])
def test_new_traversal_kernels_match_plain(cuda, scene, kernel, anyhit):
    """BVH2, BVH16, the lane walk and the BVH4 variants v5, v7 and v8
    against their plain versions on the card: ids equal except on equal-t
    ties, t/u/v within 1e-5, occlusion equal, nothing dropped, one launch
    counted."""
    wb = add_kernel_tables(SCENE_BVH[scene](), TABLES)
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


def _bvh4_tables(wb, cuda):
    """DeviceBvh of wb with the v7 sidecar, the yardstick of traverse_bvh4."""
    wb = add_kernel_tables(wb, {"bvh4_sidecar"})
    return add_kernel_tables_to_device(bvh_to_device(wb, cuda), wb, cuda, {"bvh4_sidecar"})


def _inside_rays(wb, n, seed, cuda):
    """n incoherent rays from random points inside the scene bounds, as
    the 8 [N] components with tmin 0 and tmax 1e32."""
    rng = np.random.default_rng(seed)
    lo, hi = wb.nodes_self[0, 0:3], wb.nodes_self[0, 3:6]
    ro = (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    comps = [torch.tensor(np.ascontiguousarray(a), device=cuda) for a in (*ro.T, *rd.T)]
    return [*comps, torch.zeros(n, device=cuda), torch.full((n,), 1e32, device=cuda)]


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _bvh4_against_v7(bvh, args, anyhit, root=None):
    """traverse_bvh4 against v7 on the same lanes: bit for bit in all five
    outputs, one launch counted, nothing dropped. Returns its outputs."""
    root = bvh.root4_code if root is None else root
    tb4.OVERFLOW.reset()
    tbsc.OVERFLOW.reset()
    ref = tbsc.traverse_bvh4_sidecar(bvh.nodes4_fi, bvh.nodes4_sc, bvh.tris128, root, *args,
                                     anyhit=anyhit)
    launches = tb4.COUNTER.launches
    out = tb4.traverse_bvh4(bvh.nodes4_fi, bvh.tris128, root, *args, anyhit=anyhit)
    torch.cuda.synchronize()
    assert tb4.COUNTER.launches == launches + 1
    assert all(_same_bits(o, r) for o, r in zip(out, ref))
    assert tb4.OVERFLOW.total() == 0 and tbsc.OVERFLOW.total() == 0
    return out


def _against_plain(bvh, args, anyhit, out, root=None):
    """The kernel's outputs against the plain version's, at the tolerances
    of test_traversal_kernel_matches_plain; returns the hit mask."""
    root = bvh.root4_code if root is None else root
    t, rn, tri, u, v, dropped = ttrav.traverse_bvh4_plain(bvh.nodes4_fi, bvh.tris128, root, *args,
                                                          anyhit=anyhit)
    kt, krn, ktri, ku, kv = out
    assert dropped == 0
    hit = tri >= 0
    assert torch.equal(ktri >= 0, hit)
    if not anyhit:
        same = (ktri == tri) & (krn == rn)
        tie = torch.isclose(kt, torch.where(hit, t, kt), rtol=1e-6, atol=0)
        assert bool((same | tie).all())
        torch.testing.assert_close(kt[hit], t[hit], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(ku[same & hit], u[same & hit], rtol=0, atol=1e-5)
        torch.testing.assert_close(kv[same & hit], v[same & hit], rtol=0, atol=1e-5)
    return hit


def _assert_dead(out, tmax, dead):
    """(tmax, -1, -1, 0, 0) bit for bit on the dead lanes."""
    kt, krn, ktri, ku, kv = out
    assert _same_bits(kt[dead], tmax[dead])
    assert bool((krn[dead] == -1).all() and (ktri[dead] == -1).all())
    for f in (ku, kv):
        assert torch.equal(f[dead].view(torch.int32), torch.zeros_like(f[dead].view(torch.int32)))


@pytest.mark.parametrize("anyhit", [False, True])
def test_bvh4_kernel_on_the_foliage_tables(cuda, anyhit):
    """traverse_bvh4 on the culled and split foliage tables: bit for bit
    with v7, against its plain walk, nothing dropped, and closest hits on
    virtual rows (tri ids past their primitive's count) returned as the
    tables hold them."""
    wb = _foliage_bvh()
    bvh = _bvh4_tables(wb, cuda)
    args = _inside_rays(wb, 50_000, 54, cuda)
    if anyhit:
        args[7] = torch.full_like(args[7], 0.5)
    out = _bvh4_against_v7(bvh, args, anyhit)
    hit = _against_plain(bvh, args, anyhit, out)
    assert int(hit.sum()) > 1000
    if not anyhit:
        # a virtual row's hit row bakes its parent: attr_tri differs from the hit's tri id
        rnode, tri = out[1].clamp(min=0).long(), out[2].clamp(min=0).long()
        row = torch.tensor(wb.rn_attr_base, device=cuda).long()[rnode] + tri
        virtual = hit & (torch.tensor(wb.attr_tri, device=cuda).long()[row] != tri)
        assert int(virtual.sum()) > 100


@pytest.mark.parametrize("anyhit", [False, True])
def test_bvh4_kernel_on_a_dead_lane_mix(cuda, anyhit):
    """A helmet ray set in which 98% of the lanes are dead and scattered
    (tmax -1, a tenth of them NaN), as in the main path's bounces: the
    kernel equals v7 bit for bit and the plain version within tolerance."""
    wb = _helmet_bvh()
    bvh = _bvh4_tables(wb, cuda)
    n = 200_000
    args = _inside_rays(wb, n, 36, cuda)
    g = torch.Generator(device="cpu").manual_seed(36)
    live = (torch.rand(n, generator=g) < 0.02).to(cuda)
    nan = (torch.rand(n, generator=g) < 0.1).to(cuda)
    tmax = torch.where(live, 3.0 if anyhit else 1e32, torch.where(nan, float("nan"), -1.0))
    args[7] = tmax.contiguous()
    out = _bvh4_against_v7(bvh, args, anyhit)
    hit = _against_plain(bvh, args, anyhit, out)
    assert int(hit.sum()) > 500 and not bool(hit[~live].any())
    _assert_dead(out, tmax, ~live)


@pytest.mark.parametrize("size", ["1", "1000", "past_one_pass"])
@pytest.mark.parametrize("anyhit", [False, True])
def test_bvh4_kernel_lane_counts(cuda, size, anyhit):
    """n = 1, 1000 and more lanes than the persistent grid holds threads
    (2048 per SM, the most an SM keeps resident): all live, equal to v7
    bit for bit and to the plain version."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = {"1": 1, "1000": 1000, "past_one_pass": 2048 * sms + 333}[size]
    wb = _helmet_bvh()
    bvh = _bvh4_tables(wb, cuda)
    args = _inside_rays(wb, n, 37, cuda)
    if anyhit:
        args[7] = torch.full((n,), 3.0, device=cuda)
    out = _bvh4_against_v7(bvh, args, anyhit)
    hit = _against_plain(bvh, args, anyhit, out)
    assert n < 1000 or int(hit.sum()) > n // 10


def test_bvh4_kernel_without_live_lanes(cuda):
    """No live lane (tmax -1, -inf or NaN): every lane reads (tmax, -1, -1,
    0, 0), the NaN's bits included, in the kernel and in v7."""
    wb = _helmet_bvh()
    bvh = _bvh4_tables(wb, cuda)
    n = 5000
    args = _inside_rays(wb, n, 38, cuda)
    tmax = torch.tensor([-1.0, float("-inf"), float("nan"), -0.5], device=cuda).repeat(n // 4)
    args[7] = tmax.contiguous()
    for anyhit in (False, True):
        out = _bvh4_against_v7(bvh, args, anyhit)
        _assert_dead(out, tmax, torch.ones(n, dtype=torch.bool, device=cuda))


@pytest.mark.parametrize("anyhit", [False, True])
def test_bvh4_kernel_on_the_leaf_root_scene(cuda, anyhit):
    """The 2-triangle plane whose binary root is a leaf (BVH4 root row 0
    with one leaf child), and the same leaf passed as a negative root code:
    there a lane with tmin < t < tmax < 0 can still hit, so only lanes with
    !(tmin < tmax) are skipped. The kernel equals v7 and the plain
    version."""
    from vk_gltf_renderer_tpu_torch.models.editor import SceneEditor
    from vk_gltf_renderer_tpu_torch.scenes import _empty_scene

    sc = _empty_scene()
    SceneEditor(sc).add_primitive("plane")
    sc.parse_scene()
    wb = build_world_bvh(build_scene_flat(sc))
    assert wb.nodes4_fi.shape[0] == 1
    bvh = _bvh4_tables(wb, cuda)
    n = 4096
    rng = np.random.default_rng(39)
    xz = rng.uniform(-1.2, 1.2, size=(n, 2)).astype(np.float32)
    up = rng.random(n) < 0.5  # half the rays start above the plane, half below
    ro = np.stack([xz[:, 0], np.where(up, 1.0, -1.0), xz[:, 1]], 1).astype(np.float32)
    rd = np.tile(np.float32([0.0, -1.0, 0.0]), (n, 1))  # down: the plane (y = 0) at t = +1 or -1
    tmin = np.where(up, 0.0, -3.0).astype(np.float32)
    tmax = np.where(up, 1e32, -0.5).astype(np.float32)
    tmax[::5] = -1.0
    tmax[3::10] = -4.0  # tmin > tmax: dead even at a leaf root
    comps = [torch.tensor(np.ascontiguousarray(a), device=cuda) for a in (*ro.T, *rd.T)]
    args = [*comps, torch.tensor(tmin, device=cuda), torch.tensor(tmax, device=cuda)]
    leaf = int(bvh.nodes4_fi[0, 24:28].min())
    assert leaf < 0
    for root in (bvh.root4_code, leaf):
        out = _bvh4_against_v7(bvh, args, anyhit, root)
        hit = _against_plain(bvh, args, anyhit, out, root)
        below = torch.tensor(~up, device=cuda)
        assert int(hit.sum()) > 100
        # a lane below the plane hits only through the leaf root (the root row's slab test
        # floors tnear at 0), and one with tmin > tmax never does
        assert bool(hit[below].any()) == (root < 0)
        assert not bool(hit[torch.tensor(tmax == -4.0, device=cuda)].any())


@pytest.mark.parametrize("anyhit", [False, True])
def test_bvh4_kernel_counts_overflow(cuda, anyhit):
    """A tree deeper than the 64-entry stack (torch_test_helpers.
    deep_chain_bvh4: 3 pushes dropped a live ray) drops pushes and counts
    them in the kernel, in v7 and in the plain version alike, with equal
    outputs (as test_torch_traverse.py::test_stack_overflow_is_counted)."""
    fi, sc, tr = (torch.tensor(a, device=cuda) for a in deep_chain_bvh4())
    rays = [torch.tensor(a, device=cuda) for a in deep_chain_rays(4096, seed=40)]
    rays[7][::5] = -1.0
    live = int((rays[7] >= 0).sum())
    tb4.OVERFLOW.reset()
    tbsc.OVERFLOW.reset()
    try:
        out = tb4.traverse_bvh4(fi, tr, 0, *rays, anyhit=anyhit)
        ref = tbsc.traverse_bvh4_sidecar(fi, sc, tr, 0, *rays, anyhit=anyhit)
        assert tb4.OVERFLOW.total() == tbsc.OVERFLOW.total() == 3 * live
    finally:
        tb4.OVERFLOW.reset()
        tbsc.OVERFLOW.reset()
    assert all(_same_bits(o, r) for o, r in zip(out, ref))
    *plain, dropped = ttrav.traverse_bvh4_plain(fi.cpu(), tr.cpu(), 0, *(r.cpu() for r in rays),
                                                anyhit=anyhit)
    assert dropped == 3 * live
    assert all(_same_bits(o.cpu(), p) for o, p in zip(out, plain))


# the other kernels with live-lane compaction (csrc/live_lanes.cuh): kernel value -> (wrapper
# module, call(bvh, args, anyhit, root), plain call(...) on the same arguments, the root a call
# gets by default)
COMPACTING = {
    "lane": (tlane, lambda bvh, args, anyhit, root: tlane.traverse_lanes(bvh.lane_entries, *args, anyhit=anyhit),
             lambda bvh, args, anyhit, root: ttrav.traverse_lanes_plain(bvh.lane_entries, *args, anyhit=anyhit),
             lambda bvh: None),
    "v5": (tbmp, lambda bvh, args, anyhit, root: tbmp.traverse_bvh4_multipop(bvh.nodes4_fi, bvh.tris128, root,
                                                                             *args, anyhit=anyhit),
           lambda bvh, args, anyhit, root: ttrav.traverse_bvh4_multipop_plain(bvh.nodes4_fi, bvh.tris128, root,
                                                                              *args, anyhit=anyhit),
           lambda bvh: bvh.root4_code),
    "v2": (tb2, lambda bvh, args, anyhit, root: tb2.traverse_bvh2(bvh.nodes_fi, bvh.tris128, root, *args,
                                                                  anyhit=anyhit),
           lambda bvh, args, anyhit, root: ttrav.traverse_bvh2_plain(bvh.nodes_fi, bvh.tris128, root, *args,
                                                                     anyhit=anyhit),
           lambda bvh: bvh.root_code),
    # v6 walks from row 0
    "v6": (tb16, lambda bvh, args, anyhit, root: tb16.traverse_bvh16(bvh.nodes16_fi, bvh.tris128, *args,
                                                                     anyhit=anyhit),
           lambda bvh, args, anyhit, root: ttrav.traverse_bvh16_plain(bvh.nodes16_fi, bvh.tris128, 0, *args,
                                                                      anyhit=anyhit),
           lambda bvh: 0),
    "v7": (tbsc, lambda bvh, args, anyhit, root: tbsc.traverse_bvh4_sidecar(bvh.nodes4_fi, bvh.nodes4_sc,
                                                                            bvh.tris128, root, *args,
                                                                            anyhit=anyhit),
           lambda bvh, args, anyhit, root: ttrav.traverse_bvh4_sidecar_plain(bvh.nodes4_fi, bvh.nodes4_sc,
                                                                             bvh.tris128, root, *args,
                                                                             anyhit=anyhit),
           lambda bvh: bvh.root4_code),
    "v8": (tblq, lambda bvh, args, anyhit, root: tblq.traverse_bvh4_leafqueue(bvh.nodes4_fi, bvh.tris128, root,
                                                                              *args, anyhit=anyhit),
           lambda bvh, args, anyhit, root: ttrav.traverse_bvh4_leafqueue_plain(bvh.nodes4_fi, bvh.tris128, root,
                                                                               *args, anyhit=anyhit),
           lambda bvh: bvh.root4_code),
}


def _compacting_tables(wb, cuda):
    """DeviceBvh of wb with the lane entries, v5's stack need, the BVH2
    and BVH16 rows and the v7 sidecar."""
    fam = {"lane", "bvh4_multipop", "bvh2", "bvh16", "bvh4_sidecar"}
    wb = add_kernel_tables(wb, fam)
    return add_kernel_tables_to_device(bvh_to_device(wb, cuda), wb, cuda, fam)


def _compacting_against_plain(kernel, bvh, args, anyhit, root=None):
    """A kernel of COMPACTING against its plain version on the same lanes
    (ids equal except on equal-t ties, t/u/v within 1e-5, occlusion equal),
    one launch counted, nothing dropped; v5's and v8's closest-hit t also
    equals traverse_bvh4's bit for bit on every lane (their any-hit
    occlusion is the plain version's, which is traverse_bvh4's), and v7's
    five outputs equal traverse_bvh4's bit for bit, closest and any hit.
    Returns (outputs, hit)."""
    mod, call, plain, default_root = COMPACTING[kernel]
    root = default_root(bvh) if root is None else root
    mod.OVERFLOW.reset()
    launches = mod.COUNTER.launches
    out = call(bvh, args, anyhit, root)
    torch.cuda.synchronize()
    assert mod.COUNTER.launches == launches + 1 and mod.OVERFLOW.total() == 0
    t, rn, tri, u, v, dropped = plain(bvh, args, anyhit, root)
    kt, krn, ktri, ku, kv = out
    assert dropped == 0
    if kernel == "v7":
        ref = tb4.traverse_bvh4(bvh.nodes4_fi, bvh.tris128, root, *args, anyhit=anyhit)
        assert all(_same_bits(o, r) for o, r in zip(out, ref))
    hit = tri >= 0
    assert torch.equal(ktri >= 0, hit)
    if not anyhit:
        same = (ktri == tri) & (krn == rn)
        tie = torch.isclose(kt, torch.where(hit, t, kt), rtol=1e-6, atol=0)
        assert bool((same | tie).all())
        torch.testing.assert_close(kt[hit], t[hit], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(ku[same & hit], u[same & hit], rtol=0, atol=1e-5)
        torch.testing.assert_close(kv[same & hit], v[same & hit], rtol=0, atol=1e-5)
        if kernel in ("v5", "v8"):
            ref = tb4.traverse_bvh4(bvh.nodes4_fi, bvh.tris128, root, *args)
            assert _same_bits(kt, ref[0])
    return out, hit


@pytest.mark.parametrize("kernel", sorted(COMPACTING))
@pytest.mark.parametrize("anyhit", [False, True])
def test_compacting_kernel_on_a_dead_lane_mix(cuda, kernel, anyhit):
    """The kernels of COMPACTING on a helmet lane set in which 98% of the lanes
    are dead and scattered (tmax -1, a tenth of them NaN): against the
    plain version, and (tmax, -1, -1, 0, 0) bit for bit on the dead lanes."""
    wb = _helmet_bvh()
    bvh = _compacting_tables(wb, cuda)
    n = 200_000
    args = _inside_rays(wb, n, 46, cuda)
    g = torch.Generator(device="cpu").manual_seed(46)
    live = (torch.rand(n, generator=g) < 0.02).to(cuda)
    nan = (torch.rand(n, generator=g) < 0.1).to(cuda)
    tmax = torch.where(live, 3.0 if anyhit else 1e32, torch.where(nan, float("nan"), -1.0))
    args[7] = tmax.contiguous()
    out, hit = _compacting_against_plain(kernel, bvh, args, anyhit)
    assert int(hit.sum()) > 500 and not bool(hit[~live].any())
    _assert_dead(out, tmax, ~live)


@pytest.mark.parametrize("kernel", sorted(COMPACTING))
@pytest.mark.parametrize("size", ["1", "1000", "past_one_pass"])
@pytest.mark.parametrize("anyhit", [False, True])
def test_compacting_kernel_lane_counts(cuda, kernel, size, anyhit):
    """n = 1, 1000 and more lanes than the persistent grid holds threads
    (2048 per SM): all live, against the plain version."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = {"1": 1, "1000": 1000, "past_one_pass": 2048 * sms + 333}[size]
    wb = _helmet_bvh()
    bvh = _compacting_tables(wb, cuda)
    args = _inside_rays(wb, n, 47, cuda)
    if anyhit:
        args[7] = torch.full((n,), 3.0, device=cuda)
    _, hit = _compacting_against_plain(kernel, bvh, args, anyhit)
    assert n < 1000 or int(hit.sum()) > n // 10


@pytest.mark.parametrize("kernel", sorted(COMPACTING))
def test_compacting_kernel_without_live_lanes(cuda, kernel):
    """No live lane (tmax -1, -inf, NaN or -0.5): every lane reads (tmax,
    -1, -1, 0, 0), the NaN's bits included."""
    wb = _helmet_bvh()
    bvh = _compacting_tables(wb, cuda)
    n = 5000
    args = _inside_rays(wb, n, 48, cuda)
    tmax = torch.tensor([-1.0, float("-inf"), float("nan"), -0.5], device=cuda).repeat(n // 4)
    args[7] = tmax.contiguous()
    for anyhit in (False, True):
        out, _ = _compacting_against_plain(kernel, bvh, args, anyhit)
        _assert_dead(out, tmax, torch.ones(n, dtype=torch.bool, device=cuda))


@pytest.mark.parametrize("kernel", sorted(COMPACTING))
@pytest.mark.parametrize("anyhit", [False, True])
def test_compacting_kernel_on_the_leaf_root_scene(cuda, kernel, anyhit):
    """The 2-triangle plane whose binary root is a leaf, rays from above
    and below with tmin -3 below: v5, v7 and v8 from the BVH4 root row and
    from the leaf passed as a negative root code (there a lane with tmin < t
    < tmax < 0 hits, as in BVH4), v2 from its leaf root code (the same), v6 from
    its row 0 (internal: one leaf child), and the lane walk, whose tree
    starts with the triangle entries and which skips every lane with
    tmax < 0."""
    from vk_gltf_renderer_tpu_torch.models.editor import SceneEditor
    from vk_gltf_renderer_tpu_torch.scenes import _empty_scene

    sc = _empty_scene()
    SceneEditor(sc).add_primitive("plane")
    sc.parse_scene()
    wb = build_world_bvh(build_scene_flat(sc))
    bvh = _compacting_tables(wb, cuda)
    n = 4096
    rng = np.random.default_rng(49)
    xz = rng.uniform(-1.2, 1.2, size=(n, 2)).astype(np.float32)
    up = rng.random(n) < 0.5
    ro = np.stack([xz[:, 0], np.where(up, 1.0, -1.0), xz[:, 1]], 1).astype(np.float32)
    rd = np.tile(np.float32([0.0, -1.0, 0.0]), (n, 1))
    tmin = np.where(up, 0.0, -3.0).astype(np.float32)
    tmax = np.where(up, 1e32, -0.5).astype(np.float32)
    tmax[::5] = -1.0
    tmax[3::10] = -4.0
    comps = [torch.tensor(np.ascontiguousarray(a), device=cuda) for a in (*ro.T, *rd.T)]
    args = [*comps, torch.tensor(tmin, device=cuda), torch.tensor(tmax, device=cuda)]
    below = torch.tensor(~up, device=cuda)
    leaf = int(bvh.nodes4_fi[0, 24:28].min())
    assert bvh.root_code < 0
    for root in {"v5": (bvh.root4_code, leaf), "v7": (bvh.root4_code, leaf), "v8": (bvh.root4_code, leaf),
                 "v2": (bvh.root_code,)}.get(kernel, (None,)):
        _, hit = _compacting_against_plain(kernel, bvh, args, anyhit, root)
        assert int(hit.sum()) > 100
        assert bool(hit[below].any()) == (root is not None and root < 0)


@pytest.mark.parametrize("anyhit", [False, True])
def test_v5_kernel_counts_overflow(cuda, anyhit):
    """torch_test_helpers.deep_chain_bvh4(24, stubs=True), whose v5 walk
    outgrows the 128-entry stack: the kernel drops and counts the plain
    version's 8 pushes a live ray, with outputs equal bit for bit."""
    fi, _, tr = (torch.tensor(a, device=cuda) for a in deep_chain_bvh4(24, stubs=True))
    rays = [torch.tensor(a, device=cuda) for a in deep_chain_rays(4096, seed=50)]
    rays[7][::5] = -1.0
    live = int((rays[7] >= 0).sum())
    tbmp.OVERFLOW.reset()
    try:
        out = tbmp.traverse_bvh4_multipop(fi, tr, 0, *rays, anyhit=anyhit)
        assert tbmp.OVERFLOW.total() == 8 * live
    finally:
        tbmp.OVERFLOW.reset()
    *plain, dropped = ttrav.traverse_bvh4_multipop_plain(fi.cpu(), tr.cpu(), 0, *(r.cpu() for r in rays),
                                                         anyhit=anyhit)
    assert dropped == 8 * live
    assert all(_same_bits(o.cpu(), p) for o, p in zip(out, plain))


@pytest.mark.parametrize("kernel,levels,per_ray", [("v2", 140, 12), ("v6", 24, 15)])
@pytest.mark.parametrize("anyhit", [False, True])
def test_bvh2_and_bvh16_kernels_count_overflow(cuda, kernel, levels, per_ray, anyhit):
    """torch_test_helpers.deep_chain, whose walk outgrows the BVH2 kernel's
    128-entry and the BVH16 kernel's 256-entry stack: the kernel drops and
    counts the plain version's pushes (12 and 15 a live ray), with outputs
    equal bit for bit."""
    arity, mod = {"v2": (2, tb2), "v6": (16, tb16)}[kernel]
    nodes, tr = (torch.tensor(a, device=cuda) for a in deep_chain(levels, arity))
    rays = [torch.tensor(a, device=cuda) for a in deep_chain_rays(4096, seed=51)]
    rays[7][::5] = -1.0
    live = int((rays[7] >= 0).sum())
    mod.OVERFLOW.reset()
    try:
        if kernel == "v2":
            out = tb2.traverse_bvh2(nodes, tr, 0, *rays, anyhit=anyhit)
        else:
            out = tb16.traverse_bvh16(nodes, tr, *rays, anyhit=anyhit)
        assert mod.OVERFLOW.total() == per_ray * live
    finally:
        mod.OVERFLOW.reset()
    plain = {"v2": ttrav.traverse_bvh2_plain, "v6": ttrav.traverse_bvh16_plain}[kernel]
    *ref, dropped = plain(nodes.cpu(), tr.cpu(), 0, *(r.cpu() for r in rays), anyhit=anyhit)
    assert dropped == per_ray * live
    assert all(_same_bits(o.cpu(), p) for o, p in zip(out, ref))


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
@pytest.mark.parametrize("depth", [1, 2, 5])
def test_megakernel_matches_wavefront_and_plain(cuda, scene, depth):
    """render_mega (csrc/megakernel.cu) against render_wavefront (one
    traverse_bvh4 launch per bounce) and against its plain version at
    depths 1, 2 and 5, on more paths than the persistent grid holds threads
    (2048 per SM), so that lanes refill: the same walk and arithmetic in
    the same order, so radiance and t are equal bit for bit on every ray;
    nothing dropped."""
    wb = _helmet_bvh() if scene == "helmet" else _terrain_bvh()
    rng = np.random.default_rng(34)
    n = 2048 * torch.cuda.get_device_properties(cuda).multi_processor_count + 333
    lo, hi = wb.nodes_self[0, 0:3], wb.nodes_self[0, 3:6]
    ro = (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    seeds = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    packed = tmega.pack_rays(ro, rd, seeds, device=cuda)[:3]
    tables = (torch.tensor(wb.nodes4_fi, device=cuda), torch.tensor(wb.tris128, device=cuda))
    launches = tmega.COUNTER.launches
    tmega.OVERFLOW.reset()
    mega = tmega.render_mega(*tables, *packed, depth=depth, root_code=wb.root4_code)
    torch.cuda.synchronize()
    assert tmega.COUNTER.launches == launches + 1
    wave = tmega.render_wavefront(*tables, *packed, depth=depth, root_code=wb.root4_code)
    plain = tmega.render_mega_plain(*tables, *packed, depth=depth, root_code=wb.root4_code)
    assert tmega.OVERFLOW.total() == 0
    assert _same_bits(mega, wave) and _same_bits(mega, plain)
    rad = mega[:, 0].reshape(-1)[:n]
    assert bool((rad > 0).any()) and bool((rad == 0).any())


# split kernel -> (wrapper module, plain version, DeviceBvh tables, table family)
SPLIT = {
    "packet4": (tb4s, ttrav.traverse_bvh4_split_plain, ("nodes4_f", "nodes4_i", "tris"),
                "bvh4_split"),
    "v1": (tb2s, ttrav.traverse_bvh2_split_plain, ("nodes_f", "nodes_i", "tris"), "bvh2_split"),
}


@pytest.mark.parametrize("scene", ["helmet", "terrain", "foliage"])
@pytest.mark.parametrize("kernel", sorted(SPLIT))
def test_split_traversal_kernels_match_plain(cuda, scene, kernel):
    """The packet4 and v1 kernels through intersect_rays_packet against
    their plain versions on the card: ids equal except on equal-t ties,
    t/u/v within 1e-5, nothing dropped, one launch counted; anyhit=True
    returns the closest hit (neither kernel has an any-hit mode)."""
    mod, plain, tables, family = SPLIT[kernel]
    wb = SCENE_BVH[scene]()
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


# lane mix -> (share of live lanes, the dead lanes' tmax): all live, 0.1% live with tmax -1,
# no live lane (-1, -inf, -0.5), 10% live with NaN
LANE_MIXES = {"all_live": (1.0, (-1.0,)), "sparse": (0.001, (-1.0,)),
              "dead_only": (0.0, (-1.0, float("-inf"), -0.5)), "nan": (0.1, (float("nan"),))}


def _lane_mix(wb, mix, anyhit, cuda):
    """200,000 helmet lanes (_inside_rays) of LANE_MIXES[mix]; live lanes
    get tmax 3 for any hit, else 1e32. Returns (args, live mask)."""
    share, dead_tmax = LANE_MIXES[mix]
    n = 200_000
    args = _inside_rays(wb, n, 52, cuda)
    g = torch.Generator(device="cpu").manual_seed(52)
    live = (torch.rand(n, generator=g) < share).to(cuda)
    dead = torch.tensor(dead_tmax, device=cuda).repeat(n // len(dead_tmax) + 1)[:n]
    args[7] = torch.where(live, 3.0 if anyhit else 1e32, dead).contiguous()
    return args, live


@pytest.mark.parametrize("mix", sorted(LANE_MIXES))
def test_packet4_kernel_on_lane_mixes_equals_plain(cuda, mix):
    """The packet4 kernel (csrc/traverse_bvh4_split.cu) on helmet lanes all
    live, 0.1% live, none live, and 10% live among NaN lanes: its five
    outputs equal traverse_bvh4_split_plain's bit for bit on every lane
    (the same order and arithmetic), the dead lanes read (tmax, -1, -1, 0,
    0), one launch counted, nothing dropped."""
    wb = add_kernel_tables(_helmet_bvh(), {"bvh4_split"})
    bvh = add_kernel_tables_to_device(bvh_to_device(wb, cuda), wb, cuda, {"bvh4_split"})
    args, live = _lane_mix(wb, mix, False, cuda)
    tables = (bvh.nodes4_f, bvh.nodes4_i, bvh.tris)
    tb4s.OVERFLOW.reset()
    launches = tb4s.COUNTER.launches
    out = tb4s.traverse_bvh4_split(*tables, *args)
    torch.cuda.synchronize()
    assert tb4s.COUNTER.launches == launches + 1 and tb4s.OVERFLOW.total() == 0
    *plain, dropped = ttrav.traverse_bvh4_split_plain(*tables, *args)
    assert dropped == 0
    assert all(_same_bits(o, p) for o, p in zip(out, plain))
    _assert_dead(out, args[7], ~live)
    assert int((out[2] >= 0).sum()) >= int(live.sum()) // 10


def _v1_against_plain(bvh, args):
    """The v1 kernel (csrc/traverse_bvh2_split.cu) against its plain
    version on the same lanes: all five outputs bit for bit (the same
    order and arithmetic), one launch counted, nothing dropped. Returns
    its outputs."""
    tables = (bvh.nodes_f, bvh.nodes_i, bvh.tris)
    tb2s.OVERFLOW.reset()
    launches = tb2s.COUNTER.launches
    out = tb2s.traverse_bvh2_split(*tables, *args, root_leaf=bvh.bvh2_split_root_leaf)
    torch.cuda.synchronize()
    assert tb2s.COUNTER.launches == launches + 1 and tb2s.OVERFLOW.total() == 0
    *plain, dropped = ttrav.traverse_bvh2_split_plain(*tables, *args)
    assert dropped == 0
    assert all(_same_bits(o, p) for o, p in zip(out, plain))
    return out


def _v1_tables(wb, cuda):
    return add_kernel_tables_to_device(bvh_to_device(wb, cuda), wb, cuda, {"bvh2_split"})


@pytest.mark.parametrize("mix", sorted(LANE_MIXES))
def test_v1_kernel_on_lane_mixes_equals_plain(cuda, mix):
    """The v1 kernel on helmet lanes all live, 0.1% live (the rest tmax
    -1), none live, and 10% live among NaN lanes: bit for bit against its
    plain version, the dead lanes (tmax, -1, -1, 0, 0)."""
    wb = _helmet_bvh()
    bvh = _v1_tables(wb, cuda)
    assert not bvh.bvh2_split_root_leaf
    args, live = _lane_mix(wb, mix, False, cuda)
    out = _v1_against_plain(bvh, args)
    _assert_dead(out, args[7], ~live)
    assert int((out[2] >= 0).sum()) >= int(live.sum()) // 10


@pytest.mark.parametrize("size", ["1", "1000", "past_one_pass"])
def test_v1_kernel_lane_counts(cuda, size):
    """n = 1, 1000 and more lanes than the persistent grid holds threads
    (2048 per SM): all live, bit for bit against the plain version."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = {"1": 1, "1000": 1000, "past_one_pass": 2048 * sms + 333}[size]
    wb = _helmet_bvh()
    out = _v1_against_plain(_v1_tables(wb, cuda), _inside_rays(wb, n, 53, cuda))
    assert n < 1000 or int((out[2] >= 0).sum()) > n // 10


def test_v1_kernel_on_the_leaf_root_scene(cuda):
    """The 2-triangle plane whose node 0 is a leaf, rays from above and
    below (tmin -3 below): bit for bit against the plain version. A lane
    from below with tmax -0.5 is live (tmin < tmax) and hits the plane at
    t = -1; the lanes with !(tmax >= 0) and !(tmin < tmax) are dead."""
    from vk_gltf_renderer_tpu_torch.models.editor import SceneEditor
    from vk_gltf_renderer_tpu_torch.scenes import _empty_scene

    sc = _empty_scene()
    SceneEditor(sc).add_primitive("plane")
    sc.parse_scene()
    wb = build_world_bvh(build_scene_flat(sc))
    bvh = _v1_tables(wb, cuda)
    assert bvh.bvh2_split_root_leaf
    n = 4096
    rng = np.random.default_rng(54)
    xz = rng.uniform(-0.9, 0.9, size=(n, 2)).astype(np.float32)
    up = rng.random(n) < 0.5
    ro = np.stack([xz[:, 0], np.where(up, 1.0, -1.0), xz[:, 1]], 1).astype(np.float32)
    rd = np.tile(np.float32([0.0, -1.0, 0.0]), (n, 1))
    tmin = np.where(up, 0.0, -3.0).astype(np.float32)
    tmax = np.where(up, 1e32, -0.5).astype(np.float32)
    tmax[::5] = -1.0
    tmax[3::10] = -4.0
    comps = [torch.tensor(np.ascontiguousarray(a), device=cuda) for a in (*ro.T, *rd.T)]
    args = [*comps, torch.tensor(tmin, device=cuda), torch.tensor(tmax, device=cuda)]
    out = _v1_against_plain(bvh, args)
    behind = torch.tensor(~up & (tmax == -0.5), device=cuda)
    assert int(behind.sum()) > 100 and bool((out[2][behind] >= 0).all())
    dead = torch.tensor(~(tmax >= 0) & ~(tmin < tmax), device=cuda)
    assert int(dead.sum()) > 100
    _assert_dead(out, args[7], dead)


def test_v1_kernel_counts_overflow(cuda):
    """torch_test_helpers.deep_chain_split(140), whose walk outgrows the v1
    kernel's 128-entry stack: the kernel drops and counts the plain
    version's 12 pushes a live ray, with outputs equal bit for bit."""
    nodes_f, nodes_i, tris = (torch.tensor(a, device=cuda) for a in deep_chain_split(140))
    rays = [torch.tensor(a, device=cuda) for a in deep_chain_rays(4096, seed=55)]
    rays[7][::5] = -1.0
    live = int((rays[7] >= 0).sum())
    tb2s.OVERFLOW.reset()
    try:
        out = tb2s.traverse_bvh2_split(nodes_f, nodes_i, tris, *rays, root_leaf=False)
        assert tb2s.OVERFLOW.total() == 12 * live
    finally:
        tb2s.OVERFLOW.reset()
    *ref, dropped = ttrav.traverse_bvh2_split_plain(nodes_f.cpu(), nodes_i.cpu(), tris.cpu(),
                                                    *(r.cpu() for r in rays))
    assert dropped == 12 * live
    assert all(_same_bits(o.cpu(), p) for o, p in zip(out, ref))
    assert bool((out[2] == -1).all())


@pytest.mark.parametrize("mix", sorted(LANE_MIXES))
@pytest.mark.parametrize("anyhit", [False, True])
def test_v7_kernel_on_lane_mixes_equals_bvh4_and_plain(cuda, mix, anyhit):
    """v7 (csrc/traverse_bvh4_sidecar.cu) on the lane mixes of
    test_packet4_kernel_on_lane_mixes_equals_plain, closest and any hit:
    its five outputs equal traverse_bvh4's and the plain version's
    (traverse_bvh4_sidecar_plain) bit for bit on every lane, the dead lanes
    read (tmax, -1, -1, 0, 0), nothing dropped."""
    wb = _helmet_bvh()
    bvh = _bvh4_tables(wb, cuda)
    args, live = _lane_mix(wb, mix, anyhit, cuda)
    out = _bvh4_against_v7(bvh, args, anyhit)
    *plain, dropped = ttrav.traverse_bvh4_sidecar_plain(bvh.nodes4_fi, bvh.nodes4_sc, bvh.tris128,
                                                        bvh.root4_code, *args, anyhit=anyhit)
    assert dropped == 0
    assert all(_same_bits(o, p) for o, p in zip(out, plain))
    _assert_dead(out, args[7], ~live)
    assert int((out[2] >= 0).sum()) >= int(live.sum()) // 10


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


@pytest.mark.parametrize("copy", tsd.COPIES)
@pytest.mark.parametrize("variant", tsd.VARIANTS)
def test_probe_stream_dma_matches_plain(cuda, variant, copy):
    """Integer-valued pages: every copy construct's sums equal the plain
    version's, at the TPU probe's size and with one stream per SM."""
    tab = torch.tensor(tsd.pages(variant), device=cuda)
    launches = tsd.COUNTER.launches
    out = tsd.probe_stream_dma(tab, variant, copy)
    assert tsd.COUNTER.launches == launches + 1
    assert torch.equal(out, tsd.probe_stream_dma_plain(tab, variant))
    big = tsd.card_table(tsd.TERRAIN_BYTES, tsd.fields_of(variant), cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    out = tsd.probe_stream_dma(big, variant, copy, blocks=sms, steps=100)
    assert torch.equal(out, tsd.probe_stream_dma_plain(big, variant, sms, 100))


@pytest.mark.parametrize("op", tua.OPS)
def test_probe_uarch_matches_plain(cuda, op):
    """Each micro-op's accumulator equals the plain version's on CPU copies
    of the inputs (the card computes the same float32 ops in the same
    order), and the loop took cycles."""
    tab, big, big128 = (torch.tensor(x) for x in tua.inputs())
    b = tua.table_of(op, big, big128)
    launches = tua.COUNTER.launches
    out, cycles = tua.probe_uarch(op, tab.to(cuda), b.to(cuda), 2000)
    assert tua.COUNTER.launches == launches + 1
    assert torch.equal(out.cpu(), tua.probe_uarch_plain(op, tab, b, 2000))
    assert int(cycles.item()) >= 2000


# ------------------------------------------------------------ what a viewer shows, card against CPU


def _frame_outputs(device, scene, setup, frames, outputs):
    """Render `frames` frames of a 96x64 GltfRenderer on `device` after
    setup(r); returns outputs(r, aux) of the last frame as numpy arrays."""
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    r = GltfRenderer(96, 64, spp=1, max_depth=5, device=device)
    setup(r)
    r.create_scene(scene)
    for _ in range(frames):
        aux = r.on_render()
    return {k: np.asarray(v.cpu() if hasattr(v, "cpu") else v) for k, v in outputs(r, aux).items()}


def _agree_card_cpu(card, cpu, ids=("first_rnode",)):
    """chip_smoke.py phase 5's thresholds: ids equal on >= 99.9% of pixels,
    every other output within 1e-3 * (1 + |cpu|) on >= 99% of its pixels."""
    for k, ref in cpu.items():
        got = card[k]
        assert got.shape == ref.shape and np.isfinite(got.astype(np.float64)).all(), k
        if k in ids:
            assert (got == ref).mean() >= 0.999, k
        else:
            px = ref.shape[0] * ref.shape[1] if ref.ndim == 3 else ref.shape[0]  # [H,W,C] or [N(,C)]
            close = (np.abs(got - ref) <= 1e-3 * (1 + np.abs(ref))).reshape(px, -1).all(-1)
            assert close.mean() >= 0.99, (k, close.mean())


def _guided(r):
    r.denoise_guides = True
    r.animate = True


def _upscaled(r):
    r.upscale = 2


VIEWER_CASES = {
    "guided_brainstem": ("brainstem", _guided, 2, lambda r, aux: {
        **{k: aux[k] for k in ("first_rnode", "spec_albedo", "spec_hitdist", "first_pos_prev", "lum_moments")},
        "image": r.image_linear(), "denoised": r.image_denoised()}),
    "upscale2_helmet": ("helmet", _upscaled, 2, lambda r, aux: {"first_rnode": aux["first_rnode"],
                                                                "history": r._history_hi}),
    "preview_helmet": ("helmet", lambda r: setattr(r, "render_system", 1), 1,
                       lambda r, aux: {"first_rnode": aux["first_rnode"], "image": r.image_linear()}),
    "wireframe_helmet": ("helmet", lambda r: (setattr(r, "render_system", 1), setattr(r, "wireframe", True)), 1,
                         lambda r, aux: {"first_rnode": aux["first_rnode"], "image": r.image_linear()}),
}


@pytest.mark.parametrize("case", sorted(VIEWER_CASES))
def test_viewer_frames_card_match_cpu(cuda, case):
    """The guided brainstem frame (guides, moments, image_denoised), two
    upscale-2 frames (the TAAU history) and the sky and wireframe preview
    frames of the helmet: on the card (the traversal kernel) against the
    port's plain CPU path."""
    from vk_gltf_renderer_tpu_torch.scenes import make_brainstem

    name, setup, frames, outputs = VIEWER_CASES[case]
    with tempfile.TemporaryDirectory() as d:
        scene = make_brainstem(d) if name == "brainstem" else make_helmet_standin(d)
        launches = tb4.COUNTER.launches
        card = _frame_outputs(cuda, scene, setup, frames, outputs)
        assert tb4.COUNTER.launches > launches
        _agree_card_cpu(card, _frame_outputs("cpu", scene, setup, frames, outputs))


# ------------------------------------------------------------ the editor and the viewer, card against CPU


def test_scripted_viewer_card_matches_cpu(cuda):
    """chip_smoke.py phase 19 (c) at 32x32: the viewer's key script (orbit,
    grid, gizmo, an edit and its undo, a pick, the denoised display, the
    preview) on the card and on the CPU, every key-frame's accumulation and
    first-hit ids at the frame thresholds (the preview shading with the
    card's IBL products on both: ROADMAP C), the same pick, and every card
    key-frame launching traverse_bvh4 and, under the HDR, gather_channels."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from vk_gltf_renderer_tpu_torch.scenes import write_synthetic_hdr

    with tempfile.TemporaryDirectory() as d:
        scene = make_helmet_standin(d)
        hdr = write_synthetic_hdr(d + "/sky.hdr", 32, 64)
        px, pick = chip_smoke._pick_pixel(scene, hdr, 32)
        argv = ["--scenefile", scene, "--hdr", hdr, "--size", "32", "--maxDepth", "2",
                "--keys", chip_smoke._viewer_keys(px)]
        card_out, card, ibl = chip_smoke._viewer_run(argv, cuda)
        cpu_out, cpu, _ = chip_smoke._viewer_run(argv, "cpu", ibl=ibl)
    assert pick is not None and f"gizmo pick -> {pick}" in card_out and f"gizmo pick -> {pick}" in cpu_out
    assert len(card) == len(cpu) > 5
    assert all(fr["traverse_bvh4"] > 0 and fr["gather_channels"] > 0 for fr in card)
    for g, c in zip(card, cpu):
        chip_smoke._require_agree("scripted viewer key-frame", g["first"], c["first"])


# ------------------------------------------------------------ textures and devices (chip_smoke.py phase 20)

# container -> the file name its image takes
TEXTURE_CONTAINERS = {"png": "base.png", "dds_bgra8": "base.dds", "ktx2_rgba8": "base.ktx2",
                      "ktx2_zlib": "base_z.ktx2", "jpeg_420": "base.jpg", "dds_bc1": "bc1.dds",
                      "ktx2_etc1s": "etc1s.ktx2"}
LOSSLESS = ("dds_bgra8", "ktx2_rgba8", "ktx2_zlib")


def _texture_bytes(kind, img):
    from vk_gltf_renderer_tpu_torch import scenes
    from vk_gltf_renderer_tpu_torch.ops.jpeg import encode_jpeg
    from vk_gltf_renderer_tpu_torch.utils.png import encode_png

    return {"png": lambda: encode_png(img), "dds_bgra8": lambda: scenes.dds_bgra8(img),
            "ktx2_rgba8": lambda: scenes.ktx2_rgba8(img), "ktx2_zlib": lambda: scenes.ktx2_rgba8(img, 1),
            "jpeg_420": lambda: encode_jpeg(img), "dds_bc1": lambda: scenes.dds_bc1(img),
            "ktx2_etc1s": lambda: scenes.ktx2_etc1s(img)}[kind]()


def _textured_frame(device, scene, hdr, w=96, h=64):
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    r = GltfRenderer(w, h, spp=1, max_depth=5, device=device)
    r.create_scene(scene)
    r.create_hdr(hdr)
    aux = r.on_render()
    return {"first_rnode": aux["first_rnode"].cpu().numpy(), "image": r.image_linear()}


@pytest.mark.parametrize("kind", sorted(set(TEXTURE_CONTAINERS) - {"png"}))
def test_textured_frames_card(cuda, kind):
    """chip_smoke.py phase 20 (b) at 96x64: the helmet with its base colour
    in each container; a lossless container's card frame equals the PNG
    texture's card frame bit for bit, a lossy one's agrees with the CPU
    frame at phase 5's thresholds."""
    from vk_gltf_renderer_tpu_torch import scenes

    img = scenes.texture_image(128, seed=2)
    with tempfile.TemporaryDirectory() as d:
        hdr = scenes.write_synthetic_hdr(d + "/sky.hdr", 32, 64)
        scene = scenes.helmet_with_texture(d, _texture_bytes(kind, img), TEXTURE_CONTAINERS[kind])
        launches = (tb4.COUNTER.launches, tgather.COUNTER.launches)
        card = _textured_frame(cuda, scene, hdr)
        assert tb4.COUNTER.launches > launches[0] and tgather.COUNTER.launches > launches[1]
        if kind in LOSSLESS:
            png = scenes.helmet_with_texture(d, _texture_bytes("png", img), TEXTURE_CONTAINERS["png"])
            ref = _textured_frame(cuda, png, hdr)
            assert all(np.array_equal(card[k], ref[k]) for k in card)
        else:
            _agree_card_cpu(card, _textured_frame("cpu", scene, hdr))


@pytest.mark.parametrize("shards", [2, 4])
def test_render_mesh_on_the_card_equals_on_render(cuda, shards):
    """chip_smoke.py phase 20 (d) at 256x128: render_mesh over the card
    named `shards` times gives on_render's accumulation, per-pixel outputs
    and ray count bit for bit, frame after frame."""
    from vk_gltf_renderer_tpu_torch import scenes
    from vk_gltf_renderer_tpu_torch.parallel import render_mesh
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    with tempfile.TemporaryDirectory() as d:
        hdr = scenes.write_synthetic_hdr(d + "/sky.hdr", 32, 64)
        scene = make_helmet_standin(d)
        rs = []
        for _ in range(2):
            r = GltfRenderer(256, 128, spp=1, max_depth=5, device=cuda)
            r.create_scene(scene)
            r.create_hdr(hdr)
            rs.append(r)
        for _ in range(2):
            ref = rs[0].on_render()
            aux = render_mesh(rs[1], [cuda] * shards)
            assert torch.equal(rs[0].accum, rs[1].accum)
            assert all(torch.equal(aux[k], ref[k]) for k in ref)


# ------------------------------------------------------------ SBVH, seeding, batching (chip_smoke.py phase 21)

def _sbvh_soup(device):
    """The sliver soup under VKGR_BVH=sbvh (duplicated references) with every
    kernel family's tables on device, and its host WorldBvh."""
    import os

    from vk_gltf_renderer_tpu_torch.convert import SPLIT_FAMILIES
    from vk_gltf_renderer_tpu_torch.scenes import make_sliver_soup

    with tempfile.TemporaryDirectory() as d:
        sc = Scene()
        sc.load(make_sliver_soup(d))
    os.environ["VKGR_BVH"] = "sbvh"
    try:
        wb = build_world_bvh(build_scene_flat(sc))
    finally:
        del os.environ["VKGR_BVH"]
    assert wb.builder == "sbvh" and wb.tris.shape[0] - 8 > wb.num_world_tris
    add_kernel_tables(wb, {"bvh2", "bvh16", "lane", "bvh4_sidecar"})
    families = set(SPLIT_FAMILIES) | {"bvh4_multipop"}
    return wb, add_kernel_tables_to_device(bvh_to_device(wb, device), wb, device, families), \
        add_kernel_tables_to_device(bvh_to_device(wb, "cpu"), wb, "cpu", families)


@pytest.mark.parametrize("kernel", ["v3", "v9", "v5", "v7", "v8", "v2", "v6", "lane", "packet4", "v1"])
@pytest.mark.parametrize("anyhit", [False, True])
def test_kernels_on_sbvh_tables_match_plain(cuda, kernel, anyhit):
    """chip_smoke.py phase 21 (a) on the sliver soup: every traversal
    kernel on tables with repeated triangles equals its plain walk (t bit
    for bit, ids but for ties; occlusion equal)."""
    wb, dev, host = _sbvh_soup(cuda)
    rng = np.random.default_rng(41)
    n = 4096
    lo, hi = wb.nodes_self[0, 0:3], wb.nodes_self[0, 3:6]
    ro = (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmax = np.full(n, 3.0 if anyhit else 1e32, np.float32)
    out = []
    for bvh, device in ((dev, cuda), (host, "cpu")):
        args = [torch.tensor(a, device=device) for a in (ro, rd)]
        tmin, tm = torch.zeros(n, device=device), torch.tensor(tmax, device=device)
        if kernel in ("packet4", "v1"):
            h = intersect_rays_packet(bvh, *args, tmin, tm, anyhit=anyhit, wide=kernel == "packet4")
        else:
            cols = [c.contiguous() for a in args for c in a.T]
            h = intersect_rays_soa(bvh, *cols, tmin, tm, anyhit=anyhit, kernel=kernel)
        out.append({k: v.cpu().numpy() for k, v in h.items()})
    card, plain = out
    assert ((card["tri"] >= 0) == (plain["tri"] >= 0)).all()
    assert (plain["tri"] >= 0).sum() > 100
    if not anyhit:
        assert np.array_equal(card["t"].view(np.int32), plain["t"].view(np.int32))
        assert ((card["tri"] == plain["tri"]) | (card["t"] == plain["t"])).all()


def test_seeded_frames_card_equal_unseeded(cuda, monkeypatch):
    """chip_smoke.py phase 21 (b) at 128x96: 4 seeded frames equal the
    unseeded ones but where two triangles tie at the seed's t."""
    from vk_gltf_renderer_tpu_torch import scenes
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    with tempfile.TemporaryDirectory() as d:
        hdr = scenes.write_synthetic_hdr(d + "/sky.hdr", 32, 64)
        scene = make_helmet_standin(d)
        frames = []
        for seed in ("0", "1"):
            monkeypatch.setenv("VKGR_PRIMARY_SEED", seed)
            r = GltfRenderer(128, 96, spp=1, max_depth=5, device=cuda)
            r.create_scene(scene)
            r.create_hdr(hdr)
            frames.append([(r.on_render()["first_tri"].cpu().numpy(), r.image_linear()) for _ in range(4)])
        for (ta, ia), (tb, ib) in zip(*frames):
            same = ta == tb
            assert same.mean() >= 0.999
            assert np.array_equal(ia.reshape(-1, 3)[same], ib.reshape(-1, 3)[same])


def test_seeded_frames_card_after_deleting_a_render_node(cuda, monkeypatch):
    """The seeds of the frame before a deletion name the deleted render
    node, past the new rn_attr_base: clamped, they raise no device-side
    assert, and the frames stay the unseeded ones but at ties."""
    from vk_gltf_renderer_tpu_torch import scenes
    from vk_gltf_renderer_tpu_torch.models.editor import SceneEditor
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    with tempfile.TemporaryDirectory() as d:
        hdr = scenes.write_synthetic_hdr(d + "/sky.hdr", 32, 64)
        scene = make_helmet_standin(d)
        frames = []
        for seed in ("0", "1"):
            monkeypatch.setenv("VKGR_PRIMARY_SEED", seed)
            r = GltfRenderer(128, 96, spp=1, max_depth=5, device=cuda)
            r.create_scene(scene)
            r.create_hdr(hdr)
            out = []
            for i in range(4):
                if i == 2:  # the plate, render node 1 of 2, goes
                    assert r.dev_bvh.rn_attr_base.shape[0] == 2 and (r._prev_first[0] == 1).any()
                    SceneEditor(r.scene).delete_node(1)
                out.append((r.on_render()["first_tri"].cpu().numpy(), r.image_linear()))
            torch.cuda.synchronize()
            frames.append(out)
        assert r.dev_bvh.rn_attr_base.shape[0] == 1
        for (ta, ia), (tb, ib) in zip(*frames):
            same = ta == tb
            assert same.mean() >= 0.999
            assert np.array_equal(ia.reshape(-1, 3)[same], ib.reshape(-1, 3)[same])


def test_batched_frames_card_match_cpu(cuda, monkeypatch):
    """chip_smoke.py phase 21 (c) at 96x64: spp 4 batched on the card agrees
    with the port's CPU frame at phase 5's thresholds, in one
    traverse_bvh4 launch a trace (10 a frame at depth 5, not 40)."""
    from vk_gltf_renderer_tpu_torch import scenes

    monkeypatch.setenv("VKGR_SPP_BATCH", "1")
    with tempfile.TemporaryDirectory() as d:
        hdr = scenes.write_synthetic_hdr(d + "/sky.hdr", 32, 64)
        scene = make_helmet_standin(d)
        from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

        def frame(device):
            r = GltfRenderer(96, 64, spp=4, max_depth=5, device=device)
            r.create_scene(scene)
            r.create_hdr(hdr)
            aux = r.on_render()
            return {"first_rnode": aux["first_rnode"].cpu().numpy(), "image": r.image_linear()}

        before = tb4.COUNTER.launches
        card = frame(cuda)
        assert 0 < tb4.COUNTER.launches - before <= 10
        _agree_card_cpu(card, frame("cpu"))
