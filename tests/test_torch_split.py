"""Port split-table traversals: the packet4 walk (traverse_bvh4_split_plain,
the plain version of csrc/traverse_bvh4_split.cu) and the v1 walk
(traverse_bvh2_split_plain, csrc/traverse_bvh2_split.cu) through the port's
intersect_rays_packet, against the reference's intersect_rays_packet in
interpret mode (wide=True: traverse_packets4; v2=False: traverse_packets),
as tests/test_bvh.py runs it; and the port's wavefront walk against the
reference's intersect_rays_wavefront, which runs as it is on the CPU. Both
are also held against the brute-force oracle.

Tolerances (as tests/test_torch_traverse.py): t and u/v within 1e-5; u/v
within 1e-4 on the terrain and the helmet, whose small triangles carry
~100x the absolute rounding of unit-size ones and where XLA:CPU rounds u
and v otherwise than torch (see test_torch_traverse.py's terrain test).
Measured on these rays: up to 4.9e-5 on the terrain, and the port's
fused BVH4 walk (v3) shows the same 4.9e-5 on the same ray against the
reference's v3, while the split walks' u/v equal the port's own fused
walks' bit for bit wherever the ids agree (asserted below). Ids equal except on
equal-t ties, which the reference's packet-majority near order and the
port's per-ray order may resolve differently. Neither split kernel has an
any-hit mode: with anyhit=True both sides return the closest hit with its
real t.

Scenes: the editor scene, the helmet stand-in, a 2x2 grid of the terrain
patches (8,192 triangles) and a 2-triangle scene whose root is a leaf."""

import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import baseline_standins  # noqa: E402
from vk_gltf_renderer_tpu.models import Scene  # noqa: E402
from vk_gltf_renderer_tpu.models.editor import SceneEditor  # noqa: E402
from vk_gltf_renderer_tpu.ops.bvh_flatten import build_world_bvh  # noqa: E402
from vk_gltf_renderer_tpu.ops.flat import build_scene_flat  # noqa: E402
from vk_gltf_renderer_tpu.ops.pallas_traverse import intersect_rays_packet as ref_packet  # noqa: E402
from vk_gltf_renderer_tpu.ops.traverse_wavefront import (  # noqa: E402
    intersect_rays_wavefront as ref_wavefront,
    traverse_wavefront as ref_traverse_wavefront,
)
from vk_gltf_renderer_tpu_torch.convert import (  # noqa: E402
    SPLIT_FAMILIES,
    add_kernel_tables_to_device,
    bvh_to_device,
    from_reference,
)
from vk_gltf_renderer_tpu_torch.ops import bvh_flatten as tbvh  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import flat as tflat  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse as ttrav  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh2_split as tb2s  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4_split as tb4s  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse_wavefront as twave  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops.intersect import (  # noqa: E402
    STACK_CAPACITY,
    intersect_rays_packet,
    intersect_rays_soa,
    intersect_rays_wavefront,
)
from vk_gltf_renderer_tpu_torch.scenes import write_large_glb  # noqa: E402
from torch_test_helpers import (  # noqa: E402, F401 (a fixture)
    deep_chain_rays,
    deep_chain_split,
    one_torch_thread,
    share_native_builder,
)

share_native_builder()

INF = 1e30
SCENES = ["editor", "helmet", "terrain", "few"]


def _editor_scene():
    sc = baseline_standins._empty_scene()
    ed = SceneEditor(sc)
    ed.add_primitive("sphere", segments=12)
    cube = ed.add_primitive("cube")
    ed.set_translation(cube, [2.0, 0.5, -1.0])
    plate = ed.add_primitive("plane")
    ed.set_translation(plate, [0.0, -1.2, 0.0])
    ed.set_scale(plate, [3.0, 1.0, 3.0])
    sc.parse_scene()
    return sc


def _build(sc):
    flat = build_scene_flat(sc)
    wb = build_world_bvh(flat)
    _, bvh_t, _ = from_reference(None, wb, None, "cpu")
    return flat, wb, bvh_t


@pytest.fixture(scope="module")
def editor():
    return _build(_editor_scene())


@pytest.fixture(scope="module")
def helmet(tmp_path_factory):
    sc = Scene()
    sc.load(baseline_standins.make_helmet(str(tmp_path_factory.mktemp("helmet"))))
    return _build(sc)


@pytest.fixture(scope="module")
def terrain(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("terrain") / "terrain.glb")
    assert write_large_glb(p, target_tris=8000, grid=2) == 8192
    sc = Scene()
    sc.load(p)
    return _build(sc)


@pytest.fixture(scope="module")
def few():
    sc = baseline_standins._empty_scene()
    SceneEditor(sc).add_primitive("plane")
    sc.parse_scene()
    flat, wb, bvh_t = _build(sc)
    assert wb.num_world_tris <= 8 and wb.nodes_i[0, 3] > 0  # the root is a leaf
    return flat, wb, bvh_t


def _aimed_rays(wb, n, seed):
    """Half the rays from a sphere around the scene aimed at random points
    of its box, half incoherent rays from inside it; a few dead lanes
    (tmax = -1)."""
    rng = np.random.default_rng(seed)
    lo, hi = wb.nodes_self[0, 0:3], wb.nodes_self[0, 3:6]
    c = (lo + hi) / 2
    r = float(np.linalg.norm(hi - lo))
    d = rng.normal(size=(n // 2, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro1 = c + d * r
    rd1 = lo + rng.random((n // 2, 3)) * (hi - lo) - ro1
    rd1 /= np.linalg.norm(rd1, axis=1, keepdims=True)
    ro2 = lo + rng.random((n - n // 2, 3)) * (hi - lo)
    rd2 = rng.normal(size=(n - n // 2, 3))
    rd2 /= np.linalg.norm(rd2, axis=1, keepdims=True)
    ro = np.concatenate([ro1, ro2]).astype(np.float32)
    rd = np.concatenate([rd1, rd2]).astype(np.float32)
    tmax = np.full(n, 1e32, np.float32)
    tmax[::97] = -1.0
    return ro, rd, tmax


def _port(fn, bvh_t, ro, rd, tmax, **kw):
    out = fn(bvh_t, torch.tensor(ro), torch.tensor(rd), 0.0, torch.tensor(tmax), **kw)
    return {k: v.numpy() for k, v in out.items()}


def _port_soa(bvh_t, ro, rd, tmax, kernel):
    c = [torch.tensor(np.ascontiguousarray(a)) for a in (*ro.T, *rd.T)]
    out = intersect_rays_soa(bvh_t, *c, torch.zeros(ro.shape[0]), torch.tensor(tmax), kernel=kernel)
    return {k: v.numpy() for k, v in out.items()}


def _ref(fn, wb, ro, rd, tmax, **kw):
    n = ro.shape[0]
    out = fn(wb, jnp.asarray(ro), jnp.asarray(rd), jnp.zeros(n), jnp.asarray(tmax), **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_closest_equal(port, ref, uv_atol=1e-5):
    hit = ref["tri"] >= 0
    assert ((port["tri"] >= 0) == hit).all()
    np.testing.assert_allclose(port["t"], ref["t"], rtol=1e-5, atol=1e-5)
    same = (port["tri"] == ref["tri"]) & (port["rnode"] == ref["rnode"])
    # ids may differ only on equal-t ties
    tie = np.isclose(port["t"], ref["t"], rtol=1e-6, atol=0)
    assert (same | tie).all()
    np.testing.assert_allclose(port["u"][same & hit], ref["u"][same & hit], atol=uv_atol)
    np.testing.assert_allclose(port["v"][same & hit], ref["v"][same & hit], atol=uv_atol)


def _split_kw(wide):
    return {"wide": True} if wide else {"v2": False}


@pytest.mark.parametrize("wide", [True, False], ids=["packet4", "v1"])
@pytest.mark.parametrize("scene", SCENES)
def test_split_kernels_match_reference_kernel(scene, wide, request):
    """Closest hit, then anyhit=True on finite segments: both sides trace
    closest hit with the real t (neither kernel has an any-hit mode)."""
    _, wb, bvh_t = request.getfixturevalue(scene)
    n = 256 if scene == "helmet" else 512
    ro, rd, tmax = _aimed_rays(wb, n, seed=41)
    uv_atol = 1e-5 if scene in ("editor", "few") else 1e-4
    port = _port(intersect_rays_packet, bvh_t, ro, rd, tmax, **_split_kw(wide))
    ref = _ref(ref_packet, wb, ro, rd, tmax, interpret=True, **_split_kw(wide))
    assert (ref["tri"] >= 0).sum() > n // 10
    _assert_closest_equal(port, ref, uv_atol)
    assert (port["t"][tmax < 0] == 1e32).all() and (port["tri"][tmax < 0] == -1).all()
    # the same triangle test as the port's fused walk of the same arity
    fused = _port_soa(bvh_t, ro, rd, tmax, "v3" if wide else "v2")
    same = (fused["tri"] == port["tri"]) & (fused["rnode"] == port["rnode"]) & (port["tri"] >= 0)
    assert same.mean() > 0.9 * (port["tri"] >= 0).mean()
    for k in ("t", "u", "v"):
        assert np.array_equal(fused[k][same], port[k][same]), k

    # shadow-like segments of random length, up to twice the scene's diagonal
    diag = float(np.linalg.norm(wb.nodes_self[0, 3:6] - wb.nodes_self[0, 0:3]))
    seg = np.where(tmax > 0, np.random.default_rng(40).uniform(0.05, 2.0, n) * diag,
                   tmax).astype(np.float32)
    port_a = _port(intersect_rays_packet, bvh_t, ro, rd, seg, anyhit=True, **_split_kw(wide))
    ref_a = _ref(ref_packet, wb, ro, rd, seg, interpret=True, anyhit=True, **_split_kw(wide))
    closest = _port(intersect_rays_packet, bvh_t, ro, rd, seg, **_split_kw(wide))
    _assert_closest_equal(port_a, ref_a, uv_atol)
    for k in port_a:
        assert np.array_equal(port_a[k], closest[k]), k
    occ = port_a["tri"] >= 0
    assert 0 < occ.sum() < n and (port_a["t"][occ] > 0).all()


@pytest.mark.parametrize("wide", [True, False], ids=["packet4", "v1"])
@pytest.mark.parametrize("scene", ["editor", "terrain", "few"])
def test_split_kernels_match_brute_oracle(scene, wide, request):
    flat, wb, bvh_t = request.getfixturevalue(scene)
    ro, rd, tmax = _aimed_rays(wb, 256, seed=42)
    tmax[:] = 1e32
    port = _port(intersect_rays_packet, bvh_t, ro, rd, tmax, **_split_kw(wide))
    ref = {k: v.numpy() for k, v in ttrav.intersect_brute(flat, torch.tensor(ro),
                                                          torch.tensor(rd)).items()}
    hit = ref["t"] < INF
    assert hit.sum() > 20
    assert ((port["t"] < INF) == hit).all()
    # object-space oracle against world-space tables: 1e-4 (tests/test_bvh.py)
    np.testing.assert_allclose(port["t"][hit], ref["t"][hit], rtol=1e-4, atol=1e-4)
    same = (port["tri"] == ref["tri"]) & (port["rnode"] == ref["rnode"])
    tie = np.isclose(port["t"], ref["t"], rtol=1e-5, atol=0)
    assert (same | tie).all()


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.usefixtures("one_torch_thread")
def test_wavefront_matches_reference(scene, request):
    _, wb, bvh_t = request.getfixturevalue(scene)
    ro, rd, tmax = _aimed_rays(wb, 512, seed=43)
    port = _port(intersect_rays_wavefront, bvh_t, ro, rd, tmax)
    ref = _ref(ref_wavefront, wb, ro, rd, tmax)
    assert (ref["tri"] >= 0).sum() > 50
    # u/v: 2e-4 on the small-triangle scenes, where the reference's jitted
    # XLA:CPU walk rounds u and v otherwise than torch (measured: 1.1e-4 on
    # one helmet ray of 272, relative 1.4e-3 on an ill-conditioned hit);
    # the port's own walks agree bit for bit, as asserted next
    _assert_closest_equal(port, ref, 1e-5 if scene in ("editor", "few") else 2e-4)
    fused = _port_soa(bvh_t, ro, rd, tmax, "v3")
    same = (fused["tri"] == port["tri"]) & (port["tri"] >= 0)
    for k in ("t", "u", "v"):
        assert np.array_equal(fused[k][same], port[k][same]), k
    # the same per-ray order on both sides: every id equal
    assert np.array_equal(port["tri"], ref["tri"]) and np.array_equal(port["rnode"], ref["rnode"])
    assert (port["t"][tmax < 0] == 1e32).all()


@pytest.mark.parametrize("max_steps", [5, 45, 140])
@pytest.mark.usefixtures("one_torch_thread")
def test_wavefront_step_cap_cuts_where_the_reference_cuts(terrain, max_steps):
    """A ray still walking at the cap returns its best hit so far: the
    port's walk stops at the same step as the reference's, whether the cap
    is a multiple of its check interval or not."""
    _, wb, bvh_t = terrain
    ro, rd, tmax = _aimed_rays(wb, 512, seed=44)
    n = ro.shape[0]
    ref = ref_traverse_wavefront(jnp.asarray(wb.nodes_self), jnp.asarray(wb.nodes_i),
                                 jnp.asarray(wb.tris), jnp.asarray(ro), jnp.asarray(rd),
                                 jnp.zeros(n), jnp.asarray(tmax), max_steps=max_steps)
    port = twave.traverse_wavefront(bvh_t.nodes_self, bvh_t.nodes_i, bvh_t.tris, torch.tensor(ro),
                                    torch.tensor(rd), torch.zeros(n), torch.tensor(tmax),
                                    max_steps=max_steps)
    full = twave.traverse_wavefront(bvh_t.nodes_self, bvh_t.nodes_i, bvh_t.tris, torch.tensor(ro),
                                    torch.tensor(rd), torch.zeros(n), torch.tensor(tmax))
    assert np.array_equal(port[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-5)
    # the cap cut some walks short: fewer hits than the uncapped walk
    assert int((port[1] >= 0).sum()) < int((full[1] >= 0).sum())


@pytest.mark.parametrize("wide", [True, False], ids=["packet4", "v1"])
def test_split_walks_count_visits_and_drops(editor, wide):
    """The plain split walks count their visits (node rows, tris rows) and
    count pushes dropped on a stack too shallow for the tree."""
    _, wb, bvh_t = editor
    ro, rd, tmax = _aimed_rays(wb, 256, seed=45)
    rays = (*(torch.tensor(np.ascontiguousarray(a)) for a in (*ro.T, *rd.T)), torch.zeros(256),
            torch.tensor(tmax))
    if wide:
        plain, tables, name = (ttrav.traverse_bvh4_split_plain,
                               (bvh_t.nodes4_f, bvh_t.nodes4_i, bvh_t.tris), "STACK_DEPTH_SPLIT4")
    else:
        plain, tables, name = (ttrav.traverse_bvh2_split_plain,
                               (bvh_t.nodes_f, bvh_t.nodes_i, bvh_t.tris), "STACK_DEPTH_SPLIT2")
    stats = {}
    t, rn, row, u, v, dropped = plain(*tables, *rays, stats=stats)
    assert dropped == 0 and int((row >= 0).sum()) > 50 and bool((rn == -1).all())
    assert 0 < int(stats["node_rows"].sum()) <= tables[0].shape[0]
    assert stats["tris"] >= int(stats["leaf_rows"].sum()) > 0
    assert stats["internal"] > 0 and stats["leaf"] > 0
    if not wide:  # v1: a popped node's box row is read only where the node is internal
        metas = stats["leaf_node_rows"]
        assert int(metas.sum()) > 0 and not bool((metas & stats["node_rows"]).any())
        assert int((metas | stats["node_rows"]).sum()) <= tables[1].shape[0]
    full = getattr(ttrav, name)
    try:
        setattr(ttrav, name, 2)
        *_, dropped = plain(*tables, *rays)
    finally:
        setattr(ttrav, name, full)
    assert dropped > 0


def _down_rays(n, seed):
    """Rays straight down onto the few scene's plane (y = 0), half from
    above (the plane at t = +1, tmin 0) and half from below (at t = -1,
    behind the origin, tmin -3); returns (ro, rd, tmin, up)."""
    rng = np.random.default_rng(seed)
    xz = rng.uniform(-0.9, 0.9, size=(n, 2)).astype(np.float32)
    up = rng.random(n) < 0.5
    ro = np.stack([xz[:, 0], np.where(up, 1.0, -1.0), xz[:, 1]], 1).astype(np.float32)
    rd = np.tile(np.float32([0.0, -1.0, 0.0]), (n, 1))
    return ro, rd, np.where(up, 0.0, -3.0).astype(np.float32), up


@pytest.mark.parametrize("scene", ["editor", "terrain", "few"])
def test_plain_packet4_dead_lane_rule(scene, request):
    """The dead-lane rule that the compaction of csrc/traverse_bvh4_split.cu
    relies on, in its plain version: every lane with tmax -1, -0.0, -0.5
    or NaN returns (tmax, -1, row -1, 0, 0) bit for bit, though the scene's
    missing children carry code -1 and an inverted box (lo = +3e38, hi =
    -3e38), whose slab test gives tnear 0 and tfar tmax: a negative or NaN
    tmax enters it no more than a real box. The walk starts at row 0, whose
    slab tests floor tnear at 0, so even the few scene's plane behind the
    origin (t = -1, in (tmin, tmax) = (-3, -0.5)) is never reached. -0.0
    passes tmax >= 0 and is walked by the kernel, with the same result.
    intersect_rays_packet(wide=True) turns each such lane into t = 1e32
    and ids -1."""
    _, wb, bvh_t = request.getfixturevalue(scene)
    codes = bvh_t.nodes4_i[:, 0:4]
    boxes = bvh_t.nodes4_f[:, 0:24].reshape(-1, 4, 6)
    missing = codes == -1
    assert bool(missing.any()) and bool((boxes[missing][:, 0:3] > boxes[missing][:, 3:6]).all())
    n = 512
    if scene == "few":
        ro, rd, tmin, up = _down_rays(n, seed=48)
    else:
        ro, rd, _ = _aimed_rays(wb, n, seed=48)
        tmin, up = np.zeros(n, np.float32), np.ones(n, bool)
    tmax = np.full(n, 1e32, np.float32)
    tmax[1::4] = -1.0
    tmax[2::8] = np.nan
    tmax[3::8] = -0.0
    tmax[5::16] = -0.5
    dead = np.signbit(tmax) | np.isnan(tmax)
    rays = (*(torch.tensor(np.ascontiguousarray(a)) for a in (*ro.T, *rd.T)), torch.tensor(tmin),
            torch.tensor(tmax))
    t, rn, row, u, v, dropped = ttrav.traverse_bvh4_split_plain(bvh_t.nodes4_f, bvh_t.nodes4_i, bvh_t.tris,
                                                                *rays)
    assert dropped == 0 and dead.sum() > 250 and np.isnan(tmax[dead]).sum() > 60
    assert np.array_equal(t.numpy()[dead].view(np.int32), tmax[dead].view(np.int32))
    for ids in (rn, row):
        assert (ids.numpy()[dead] == -1).all()
    for f in (u, v):
        assert np.array_equal(f.numpy()[dead].view(np.int32), np.zeros(dead.sum(), np.int32))
    assert (row.numpy()[~dead] >= 0).sum() > 20
    behind = (tmax == -0.5) & ~up  # the plane at t = -1 lies in (tmin, tmax)
    assert behind.sum() > 10 or scene != "few"
    port = intersect_rays_packet(bvh_t, torch.tensor(ro), torch.tensor(rd), torch.tensor(tmin), torch.tensor(tmax),
                                 wide=True)
    dead_t = torch.tensor(dead)
    assert bool((port["t"][dead_t] == 1e32).all() and (port["tri"][dead_t] == -1).all())
    assert bool((port["rnode"][dead_t] == -1).all())


@pytest.mark.parametrize("scene", ["editor", "terrain", "few"])
def test_plain_v1_dead_lane_rule(scene, request):
    """The dead-lane rule that the compaction of csrc/traverse_bvh2_split.cu
    relies on, in its plain version, with tmax -1, -0.0, -0.5, -4 or NaN.
    Where node 0 is internal (editor, terrain) every lane with !(tmax >=
    0) is dead: node 0's slab tests floor tnear at 0 and cap tfar at tmax,
    so the walk enters no child, and the lane returns (tmax, -1, row -1,
    0, 0) bit for bit (so does -0.0, which the kernel walks). Where node 0
    is a leaf (the few scene) its triangles accept any t in (tmin, tmax):
    the rays from below (tmin -3) with tmax -0.5 hit the plane at t = -1,
    so a lane is dead only where also !(tmin < tmax), and every such lane
    returns (tmax, -1, -1, 0, 0). DeviceBvh.bvh2_split_root_leaf says
    which rule the kernel's compaction applies; intersect_rays_packet(
    v2=False) turns each dead lane into t = 1e32 and ids -1."""
    _, wb, bvh_t = request.getfixturevalue(scene)
    root_leaf = bool(wb.nodes_i[0, 3] > 0)
    assert root_leaf == (scene == "few") == bvh_t.bvh2_split_root_leaf
    n = 512
    if scene == "few":
        ro, rd, tmin, up = _down_rays(n, seed=49)
    else:
        ro, rd, _ = _aimed_rays(wb, n, seed=49)
        tmin, up = np.zeros(n, np.float32), np.ones(n, bool)
    tmax = np.full(n, 1e32, np.float32)
    tmax[1::4] = -1.0
    tmax[2::8] = np.nan
    tmax[3::8] = -0.0
    tmax[5::16] = -0.5
    tmax[7::16] = -4.0  # below the tmin of the rays from below
    compacted = ~(tmax >= 0)  # the lanes compact_lanes drops
    dead = np.signbit(tmax) | np.isnan(tmax)  # -0.0 too: the kernel walks it, with the same result
    if root_leaf:
        compacted &= ~(tmin < tmax)
        dead &= ~(tmin < tmax)
    assert not (compacted & ~dead).any()
    rays = (*(torch.tensor(np.ascontiguousarray(a)) for a in (*ro.T, *rd.T)), torch.tensor(tmin),
            torch.tensor(tmax))
    t, rn, row, u, v, dropped = ttrav.traverse_bvh2_split_plain(bvh_t.nodes_f, bvh_t.nodes_i, bvh_t.tris,
                                                                *rays)
    assert dropped == 0 and compacted.sum() > 60 and np.isnan(tmax[compacted]).sum() > 30
    assert np.array_equal(t.numpy()[dead].view(np.int32), tmax[dead].view(np.int32))
    for ids in (rn, row):
        assert (ids.numpy()[dead] == -1).all()
    for f in (u, v):
        assert np.array_equal(f.numpy()[dead].view(np.int32), np.zeros(dead.sum(), np.int32))
    assert (row.numpy()[~dead] >= 0).sum() > 20
    behind = (tmax == -0.5) & ~up  # the plane at t = -1 lies in (tmin, tmax)
    if scene == "few":
        assert behind.sum() >= 8 and (row.numpy()[behind] >= 0).all()
    port = intersect_rays_packet(bvh_t, torch.tensor(ro), torch.tensor(rd), torch.tensor(tmin), torch.tensor(tmax),
                                 v2=False)
    dead_t = torch.tensor(dead)
    assert bool((port["t"][dead_t] == 1e32).all() and (port["tri"][dead_t] == -1).all())
    assert bool((port["rnode"][dead_t] == -1).all())


def _soa(ro, rd, tmax):
    return (*(torch.tensor(np.ascontiguousarray(a)) for a in (*ro.T, *rd.T)), torch.zeros(ro.shape[0]),
            torch.tensor(tmax))


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("scene", SCENES)
def test_plain_v1_descend_changes_no_output(scene, request):
    """The plain v1 walk with descend (the kernel's: the nearer entered
    child walked next from a register, only the far one pushed) and
    without (the kernel before, which pushed both and popped the nearer)
    give the same five outputs bit for bit and drop nothing; both equal
    the plain BVH2 walk over the fused rows of the same binary tree
    (traverse_bvh2_plain, csrc/traverse_bvh2.cu), which visits it in the
    same near-first order and tests the same triangles in the same leaf
    order: t, u and v bit for bit and (rnode, tri) after the row's
    resolution on every lane."""
    _, wb, bvh_t = request.getfixturevalue(scene)
    ro, rd, tmax = _aimed_rays(wb, 512, seed=50)
    rays = _soa(ro, rd, tmax)
    tables = (bvh_t.nodes_f, bvh_t.nodes_i, bvh_t.tris)
    *desc, dropped = ttrav.traverse_bvh2_split_plain(*tables, *rays)
    *push_both, dropped_before = ttrav.traverse_bvh2_split_plain(*tables, *rays, descend=False)
    assert dropped == dropped_before == 0
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(desc, push_both))
    t, _, row, u, v = desc
    assert int((row >= 0).sum()) > 50
    t2, rn2, tri2, u2, v2, dropped2 = ttrav.traverse_bvh2_plain(bvh_t.nodes_fi, bvh_t.tris128, bvh_t.root_code,
                                                                *rays)
    assert dropped2 == 0
    for a, b in ((t, t2), (u, u2), (v, v2)):
        assert torch.equal(_bits(a), _bits(b))
    safe = row.clamp(min=0).long()
    assert torch.equal(torch.where(row >= 0, bvh_t.wtri_rnode[safe], -1), rn2)
    assert torch.equal(torch.where(row >= 0, bvh_t.wtri_tri[safe], -1), tri2)


@pytest.mark.parametrize("scene", SCENES)
def test_v1_stack_need_counts_the_descending_walk(scene, request, monkeypatch):
    """split_stack_need(wb, 1), the check before a v1 launch, counts the
    kernel's descending walk: it equals bvh_flatten.stack_need of the
    fused BVH2 rows of the same tree with descend=True, one entry less
    than the push-both walk's need where node 0 is internal. On stacks
    shrunk below it the plain v1 walk drops exactly the pushes the plain
    BVH2 walk drops (the accounting of both kernels), with t equal bit for
    bit, and on a stack of its need none."""
    _, wb, bvh_t = request.getfixturevalue(scene)
    need = tbvh.split_stack_need(wb, 1)
    assert need == bvh_t.stack_need["bvh2_split"]
    assert need == tbvh.stack_need(bvh_t.nodes_fi.numpy(), 1, bvh_t.root_code, descend=True)
    if bvh_t.root_code >= 0:
        assert need == tbvh.stack_need(bvh_t.nodes_fi.numpy(), 1, bvh_t.root_code) - 1
    ro, rd, tmax = _aimed_rays(wb, 512, seed=51)
    rays = _soa(ro, rd, tmax)
    drops = []
    for depth in (need, 3, 1):
        monkeypatch.setattr(ttrav, "STACK_DEPTH_SPLIT2", depth)
        monkeypatch.setattr(ttrav, "STACK_DEPTH2", depth)
        t, *_, dropped = ttrav.traverse_bvh2_split_plain(bvh_t.nodes_f, bvh_t.nodes_i, bvh_t.tris, *rays)
        t2, *_, dropped2 = ttrav.traverse_bvh2_plain(bvh_t.nodes_fi, bvh_t.tris128, bvh_t.root_code, *rays)
        assert dropped == dropped2 and torch.equal(_bits(t), _bits(t2))
        drops.append(dropped)
    assert drops[0] == 0
    assert (drops[2] > drops[1] > 0) == (scene != "few")  # the few scene's leaf root pushes nothing


@pytest.mark.parametrize("levels,per_ray", [(128, 0), (129, 1), (140, 12)])
def test_plain_v1_counts_overflow_on_a_deep_chain(levels, per_ray):
    """torch_test_helpers.deep_chain_split through the CPU wrapper: the
    descending v1 walk's stack grows by 1 a node (the far leaf), so past
    128 nodes every live ray drops per_ray pushes (one a node from node
    128 on; dead lanes none), where split_stack_need says the stack is too
    small; nothing is hit. The walk before (descend=False) pushed both
    children: it drops the near child of node 127 and so loses the rest of
    the chain, one push a live ray from 128 nodes on."""
    nodes_f, nodes_i, tris = (torch.tensor(a) for a in deep_chain_split(levels))
    rays = [torch.tensor(a) for a in deep_chain_rays(300, seed=52)]
    rays[7][::5] = -1.0
    live = int((rays[7] >= 0).sum())
    need = tbvh.split_stack_need(SimpleNamespace(nodes_i=nodes_i.numpy()), 1)
    assert need == levels and (need > ttrav.STACK_DEPTH_SPLIT2) == (per_ray > 0)
    tb2s.OVERFLOW.reset()
    t, _, row, _, _ = tb2s.traverse_bvh2_split(nodes_f, nodes_i, tris, *rays)
    assert tb2s.OVERFLOW.total() == per_ray * live
    tb2s.OVERFLOW.reset()
    assert (row == -1).all() and torch.equal(t, rays[7])
    *_, dropped = ttrav.traverse_bvh2_split_plain(nodes_f, nodes_i, tris, *rays, descend=False)
    assert dropped == live * (levels >= 128)


@pytest.mark.parametrize("scene", ["editor", "few"])
def test_v1_wrapper_passes_the_root_leaf_and_its_scratch(scene, request, monkeypatch):
    """intersect_rays_packet(v2=False) hands the v1 wrapper the host's
    bvh2_split_root_leaf (0 for the editor's internal node 0, 1 for the
    few scene's leaf), which the wrapper passes to the C entry as its one
    scalar, with the compaction's scratch (traverse_launch.list_scratch),
    and without a read of the device tables."""
    from vk_gltf_renderer_tpu_torch.ops import traverse_launch

    _, wb, bvh_t = request.getfixturevalue(scene)
    passed = []
    real = tb2s.run_traversal

    def record(name, counter, overflow, plain, tables, scalars, rays, anyhit, extra=None):
        passed.append((scalars, extra))
        return real(name, counter, overflow, plain, tables, scalars, rays, anyhit, extra=extra)

    monkeypatch.setattr(tb2s, "run_traversal", record)
    ro, rd, tmax = _aimed_rays(wb, 16, seed=53)
    _port(intersect_rays_packet, bvh_t, ro, rd, tmax, v2=False)
    assert passed == [((int(scene == "few"),), traverse_launch.list_scratch)]


@pytest.mark.parametrize("scene", SCENES)
def test_split_stack_need_fits_and_nothing_drops(scene, request):
    """The split walks' stack needs fit their kernels' stacks, and the
    wrappers drop nothing on these scenes."""
    _, wb, bvh_t = request.getfixturevalue(scene)
    for family in ("bvh4_split", "bvh2_split"):
        assert 1 <= bvh_t.stack_need[family] <= STACK_CAPACITY[family], family
    # the packet4 walk pushes what the fused BVH4 walk pushes
    assert bvh_t.stack_need["bvh4_split"] == bvh_t.stack_need["bvh4"]
    ro, rd, tmax = _aimed_rays(wb, 512, seed=46)
    for mod in (tb4s, tb2s):
        mod.OVERFLOW.reset()
    for wide in (True, False):
        _port(intersect_rays_packet, bvh_t, ro, rd, tmax, **_split_kw(wide))
    assert tb4s.OVERFLOW.total() == 0 and tb2s.OVERFLOW.total() == 0


def test_split_tables_are_uploaded_only_when_selected(editor, few):
    """bvh_to_device uploads no split table; add_kernel_tables_to_device
    uploads exactly those of the named family; a traversal whose tables are
    missing raises instead of falling back."""
    _, wb, _ = few
    ro, rd, tmax = _aimed_rays(wb, 8, seed=47)
    wbt = tbvh.build_world_bvh(tflat.build_scene_flat(_editor_scene()))
    bare = bvh_to_device(wbt, "cpu")
    names = ("nodes_i", "nodes_f", "nodes_self", "tris", "wtri_rnode", "wtri_tri", "nodes4_i",
             "nodes4_f")
    assert all(getattr(bare, k) is None for k in names)
    for kw in ({"wide": True}, {"v2": False}):
        with pytest.raises(ValueError, match="add_kernel_tables"):
            _port(intersect_rays_packet, bare, ro, rd, tmax, **kw)
    with pytest.raises(ValueError, match="wavefront"):
        _port(intersect_rays_wavefront, bare, ro, rd, tmax)
    expect = {"bvh4_split": {"nodes4_i", "nodes4_f"}, "bvh2_split": {"nodes_i", "nodes_f"},
              "wavefront": {"nodes_i", "nodes_self"}}
    for family in SPLIT_FAMILIES:
        dev = add_kernel_tables_to_device(bvh_to_device(wbt, "cpu"), wbt, "cpu", {family})
        present = {k for k in names if getattr(dev, k) is not None}
        assert present == expect[family] | {"tris", "wtri_rnode", "wtri_tri"}, family
        assert dev.nodes_i is None or dev.nodes_i.dtype == torch.int32
    _, _, bvh_t = editor
    assert all(getattr(bvh_t, k) is not None for k in names)  # from_reference carries them


@pytest.mark.parametrize("wide", [True, False], ids=["packet4", "v1"])
def test_split_wrappers_refuse_other_devices(editor, wide):
    _, _, bvh_t = editor
    rays = [torch.zeros(8, device="meta") for _ in range(8)]
    with pytest.raises(ValueError):
        if wide:
            tb4s.traverse_bvh4_split(bvh_t.nodes4_f, bvh_t.nodes4_i, bvh_t.tris, *rays)
        else:
            tb2s.traverse_bvh2_split(bvh_t.nodes_f, bvh_t.nodes_i, bvh_t.tris, *rays)
