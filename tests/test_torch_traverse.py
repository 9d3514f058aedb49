"""Port traversal: the plain traversals (the CUDA kernels' plain torch
versions) against the reference's Pallas kernels in interpret mode (v3 =
traverse_packets3, v9 = traverse_packets9, v2 = traverse_packets2, v6 =
traverse_packets6, lane / lane_stream = traverse_lanes / _stream, v5 =
traverse_packets5, v7 = traverse_packets3 with its sidecar, v8 =
traverse_packets8) and against both brute-force oracles, closest hit and
any hit (as tests/test_bvh.py does for the reference's own kernels). The
v5 and v8 plain versions follow their kernels' schedules (pop groups; the
leaf queue and its gate), so these cases run that control flow.

Tolerances: the kernels share the arithmetic exactly, so t/u/v agree to
float32 rounding (1e-5); ids agree except where two triangles hit at the
same t, which any traversal order may resolve either way. The lane kernels
test triangles against edges precomputed on the host (the stack kernels
subtract v1 - v0 in the kernel), an ulp-level difference that the same
1e-5 and the equal-t allowance cover. Against the brute oracles, which
intersect in object space, t agrees to 1e-4 as in tests/test_bvh.py.

Scenes: the editor scene, the helmet stand-in, a 2x2 grid of the terrain
patches of scenes.write_large_glb (8,192 triangles) and a 2-triangle scene
whose BVH root is a leaf (the root-is-leaf branches of every builder)."""

import sys
from pathlib import Path

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
from vk_gltf_renderer_tpu.ops.pallas_traverse import intersect_rays_packet_soa  # noqa: E402
from vk_gltf_renderer_tpu.ops.traverse import as_device, intersect_brute  # noqa: E402
from vk_gltf_renderer_tpu_torch.convert import add_kernel_tables_to_device, from_reference  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import bvh_flatten as tbvh  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import lane_traverse as tlane  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse as ttrav  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh2 as tb2  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4_leafqueue as tblq  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4_multipop as tbmp  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4_sidecar as tbsc  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh16 as tb16  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops.pathtrace import RenderConfig  # noqa: E402
from vk_gltf_renderer_tpu_torch.scenes import write_large_glb  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops.intersect import intersect_rays_soa  # noqa: E402
from torch_test_helpers import deep_chain, deep_chain_bvh4, deep_chain_rays, share_native_builder  # noqa: E402

_SYS_PATH = list(sys.path)
try:
    import bvh4_tuning  # noqa: E402 (its import puts the repository root on sys.path)
finally:
    sys.path[:] = _SYS_PATH

share_native_builder()

INF = 1e30
BVH4_VARIANTS = ["v5", "v7", "v8"]
NEW_KERNELS = ["v2", "v6", "lane", "lane_stream"] + BVH4_VARIANTS
WRAPPERS = {"v2": tb2, "v3": tb4, "v6": tb16, "lane": tlane, "v5": tbmp, "v7": tbsc, "v8": tblq}


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


def _rays(wb, n, seed):
    """Half inward rays from a sphere around the scene, half incoherent
    rays from inside its bounds; a few dead lanes (tmax = -1)."""
    rng = np.random.default_rng(seed)
    lo, hi = wb.nodes_self[0, 0:3], wb.nodes_self[0, 3:6]
    c = (lo + hi) / 2
    r = float(np.linalg.norm(hi - lo))
    d = rng.normal(size=(n // 2, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro1, rd1 = c + d * r, -d
    ro2 = lo + rng.random((n - n // 2, 3)) * (hi - lo)
    rd2 = rng.normal(size=(n - n // 2, 3))
    rd2 /= np.linalg.norm(rd2, axis=1, keepdims=True)
    ro = np.concatenate([ro1, ro2]).astype(np.float32)
    rd = np.concatenate([rd1, rd2]).astype(np.float32)
    tmax = np.full(n, 1e32, np.float32)
    tmax[::97] = -1.0
    return ro, rd, tmax


def _aimed_rays(wb, n, seed):
    """As _rays, but the outer half aims at random points of the scene box
    instead of its centre (which on the plane and the terrain lies on a
    triangle edge or in a gap between patches)."""
    ro, rd, tmax = _rays(wb, n, seed)
    rng = np.random.default_rng(seed + 1000)
    lo, hi = wb.nodes_self[0, 0:3], wb.nodes_self[0, 3:6]
    target = lo + rng.random((n // 2, 3)) * (hi - lo)
    d = target - ro[: n // 2]
    rd[: n // 2] = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return ro, rd, tmax


@pytest.fixture(scope="module")
def editor():
    sc = _editor_scene()
    flat, wb, bvh_t = _build(sc)
    assert wb.nodes4_fi.shape[0] > 2  # a real multi-level BVH4
    return flat, wb, bvh_t


def _to_port(wb):
    """The reference's WorldBvh on the port's CPU device, with the v5
    walk's stack need (the reference's tables already carry nodes4_sc)."""
    _, bvh_t, _ = from_reference(None, wb, None, "cpu")
    return add_kernel_tables_to_device(bvh_t, wb, "cpu", {"bvh4_multipop"})


def _build(sc):
    flat = build_scene_flat(sc)
    wb = build_world_bvh(flat)
    return flat, wb, _to_port(wb)


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


@pytest.fixture(scope="module")
def helmet(tmp_path_factory):
    sc = Scene()
    sc.load(baseline_standins.make_helmet(str(tmp_path_factory.mktemp("helmet"))))
    return _build(sc)


def _port(bvh_t, ro, rd, tmax, anyhit=False, kernel="v3"):
    c = [torch.tensor(np.ascontiguousarray(a)) for a in (*ro.T, *rd.T)]
    n = ro.shape[0]
    out = intersect_rays_soa(bvh_t, *c, torch.zeros(n), torch.tensor(tmax), anyhit=anyhit,
                             kernel=kernel)
    return {k: v.numpy() for k, v in out.items()}


def _ref_packet(wb, ro, rd, tmax, kernel, anyhit=False):
    n = ro.shape[0]
    args = [jnp.asarray(ro[:, 0]), jnp.asarray(ro[:, 1]), jnp.asarray(ro[:, 2]),
            jnp.asarray(rd[:, 0]), jnp.asarray(rd[:, 1]), jnp.asarray(rd[:, 2]),
            jnp.zeros(n), jnp.asarray(tmax)]
    out = intersect_rays_packet_soa(wb, *args, interpret=True, tiles=1, kernel=kernel, anyhit=anyhit)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_closest_equal(port, ref, wb, ro, rd, uv_atol=1e-5):
    hit = ref["tri"] >= 0
    assert ((port["tri"] >= 0) == hit).all()
    np.testing.assert_allclose(port["t"], ref["t"], rtol=1e-5, atol=1e-5)
    same = (port["tri"] == ref["tri"]) & (port["rnode"] == ref["rnode"])
    # ids may differ only on equal-t ties
    tie = np.isclose(port["t"], ref["t"], rtol=1e-6, atol=0)
    assert (same | tie).all()
    np.testing.assert_allclose(port["u"][same & hit], ref["u"][same & hit], atol=uv_atol)
    np.testing.assert_allclose(port["v"][same & hit], ref["v"][same & hit], atol=uv_atol)


@pytest.mark.parametrize("kernel", ["v3", "v9"] + NEW_KERNELS)
def test_plain_closest_hit_matches_packet_kernel(editor, kernel):
    _, wb, bvh_t = editor
    ro, rd, tmax = _rays(wb, 1024, seed=11)
    port = _port(bvh_t, ro, rd, tmax, kernel=kernel)
    ref = _ref_packet(wb, ro, rd, tmax, kernel)
    assert (ref["tri"] >= 0).sum() > 300
    _assert_closest_equal(port, ref, wb, ro, rd)
    assert (port["t"][tmax < 0] == 1e32).all() and (port["tri"][tmax < 0] == -1).all()


@pytest.mark.parametrize("kernel", ["v3", "v9"] + NEW_KERNELS)
def test_plain_any_hit_matches_packet_kernel(editor, kernel):
    _, wb, bvh_t = editor
    ro, rd, tmax = _rays(wb, 1024, seed=12)
    tmax = np.where(tmax > 0, np.float32(2.5), tmax)  # finite shadow segments
    port = _port(bvh_t, ro, rd, tmax, anyhit=True, kernel=kernel)
    ref = _ref_packet(wb, ro, rd, tmax, kernel, anyhit=True)
    occ = ref["tri"] >= 0
    assert 100 < occ.sum() < 1000
    assert ((port["tri"] >= 0) == occ).all()
    assert set(np.unique(port["t"])) <= {0.0, np.float32(1e32)}
    assert ((port["t"] == 0.0) == occ).all()


@pytest.mark.parametrize("scene", ["editor", "helmet"])
def test_plain_matches_brute_oracles(scene, request):
    flat, wb, bvh_t = request.getfixturevalue(scene)
    ro, rd, tmax = _rays(wb, 256, seed=13)
    tmax[:] = 1e32
    port = _port(bvh_t, ro, rd, tmax)
    ref = intersect_brute(as_device(flat), jnp.asarray(ro), jnp.asarray(rd))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    brute_t = ttrav.intersect_brute(flat, torch.tensor(ro), torch.tensor(rd))
    brute_t = {k: v.numpy() for k, v in brute_t.items()}
    hit = ref["t"] < INF
    assert hit.sum() > 50
    # the port's brute oracle is the reference's, in torch
    assert (brute_t["tri"] == ref["tri"]).all() and (brute_t["rnode"] == ref["rnode"]).all()
    np.testing.assert_allclose(brute_t["t"], ref["t"], rtol=1e-5)
    # the traversal finds the brute oracle's hits (object vs world space: 1e-4)
    assert ((port["t"] < INF) == hit).all()
    np.testing.assert_allclose(port["t"][hit], ref["t"][hit], rtol=1e-4, atol=1e-4)
    same = port["tri"] == ref["tri"]
    tie = np.isclose(port["t"], ref["t"], rtol=1e-5, atol=0)
    assert (same | tie).all()


def test_no_stack_overflow(helmet):
    _, wb, bvh_t = helmet
    tb4.OVERFLOW.reset()
    ro, rd, tmax = _rays(wb, 2048, seed=14)
    _port(bvh_t, ro, rd, tmax)
    _port(bvh_t, ro, rd, tmax, anyhit=True)
    assert tb4.OVERFLOW.total() == 0


def test_stack_overflow_is_counted(editor):
    """A stack too shallow for the tree drops pushes and counts them."""
    _, wb, bvh_t = editor
    ro, rd, tmax = _rays(wb, 256, seed=15)
    full = ttrav.STACK_DEPTH
    try:
        ttrav.STACK_DEPTH = 2
        *_, dropped = ttrav.traverse_bvh4_plain(
            bvh_t.nodes4_fi, bvh_t.tris128, bvh_t.root4_code,
            *(torch.tensor(np.ascontiguousarray(a)) for a in (*ro.T, *rd.T)),
            torch.zeros(256), torch.tensor(tmax))
    finally:
        ttrav.STACK_DEPTH = full
    assert dropped > 0


def test_wrapper_refuses_other_devices(editor):
    """Only CPU tensors take the plain version; anything else that is not
    CUDA raises instead of falling back."""
    _, _, bvh_t = editor
    rays = [torch.zeros(8, device="meta") for _ in range(8)]
    with pytest.raises(ValueError):
        tb4.traverse_bvh4(bvh_t.nodes4_fi, bvh_t.tris128, 0, *rays)


def _soa(ro, rd, tmin, tmax):
    return (*(torch.tensor(np.ascontiguousarray(a)) for a in (*ro.T, *rd.T)), torch.tensor(tmin),
            torch.tensor(tmax))


def _dead_mix(wb, n, seed):
    """_aimed_rays in which ~2% of the lanes, scattered, are live and the
    rest carry tmax = -1, as in the renderer's bounce and shadow launches
    (ops/pathtrace.trace_closest)."""
    ro, rd, _ = _aimed_rays(wb, n, seed)
    live = np.random.default_rng(seed + 7).random(n) < 0.02
    return ro, rd, np.where(live, np.float32(1e32), np.float32(-1.0))


@pytest.mark.parametrize("anyhit", [False, True])
def test_plain_bvh4_returns_tmax_on_dead_lanes(editor, anyhit):
    """The raw plain BVH4 walk returns (tmax, -1, -1, 0, 0) exactly on every
    lane with tmax -1 or NaN (the rule csrc/traverse_bvh4.cu's compaction
    relies on to skip those lanes), and intersect_rays_soa turns such a
    lane into t = 1e32 with ids -1."""
    _, wb, bvh_t = editor
    n = 512
    ro, rd, tmax = _aimed_rays(wb, n, seed=24)
    if anyhit:
        tmax[:] = 2.5
    tmax[1::3] = -1.0
    tmax[2::7] = np.nan
    dead = ~(tmax >= 0)
    t, rn, tri, u, v, dropped = ttrav.traverse_bvh4_plain(
        bvh_t.nodes4_fi, bvh_t.tris128, bvh_t.root4_code, *_soa(ro, rd, np.zeros(n, np.float32), tmax),
        anyhit=anyhit)
    assert dropped == 0 and dead.sum() > 200 and np.isnan(tmax).sum() > 40
    assert np.array_equal(t.numpy()[dead].view(np.int32), tmax[dead].view(np.int32))
    for ids in (rn, tri):
        assert (ids.numpy()[dead] == -1).all()
    for f in (u, v):
        assert np.array_equal(f.numpy()[dead].view(np.int32), np.zeros(dead.sum(), np.int32))
    assert (tri.numpy()[~dead] >= 0).sum() > 30  # the live lanes of the same rays hit
    port = _port(bvh_t, ro, rd, tmax, anyhit=anyhit)
    assert (port["t"][dead] == 1e32).all() and (port["tri"][dead] == -1).all()
    assert (port["rnode"][dead] == -1).all()


@pytest.mark.parametrize("anyhit", [False, True])
@pytest.mark.parametrize("kernel", ["v3", "v9", "v5", "lane"])
def test_dead_lane_mix_matches_packet_kernel(editor, kernel, anyhit):
    """On a lane mix with ~98% of the lanes dead and scattered, the port's
    traversal equals the reference's kernel of the same name
    (traverse_packets3 / traverse_packets9, traverse_packets5, traverse_lanes;
    interpret mode): closest hit as
    test_plain_closest_hit_matches_packet_kernel, any hit by occlusion."""
    _, wb, bvh_t = editor
    ro, rd, tmax = _dead_mix(wb, 4096, seed=25)
    if anyhit:
        tmax = np.where(tmax > 0, np.float32(2.5), tmax)
    live = tmax >= 0
    assert 40 < live.sum() < 130
    port = _port(bvh_t, ro, rd, tmax, anyhit=anyhit, kernel=kernel)
    ref = _ref_packet(wb, ro, rd, tmax, kernel, anyhit=anyhit)
    hit = ref["tri"] >= 0
    assert 10 < hit.sum() and not hit[~live].any()
    if anyhit:
        assert ((port["tri"] >= 0) == hit).all() and ((port["t"] == 0.0) == hit).all()
    else:
        _assert_closest_equal(port, ref, wb, ro, rd)
    assert (port["t"][~live] == 1e32).all() and (port["tri"][~live] == -1).all()


def _cu_constants(*names):
    """constexpr int constants of the named csrc/ files."""
    import re

    from vk_gltf_renderer_tpu_torch import cuda_lib

    src = "".join((cuda_lib._CSRC / name).read_text() for name in names)
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_bvh4_scratch_and_stack_match_the_kernel():
    """The wrapper's scratch header is csrc/live_lanes.cuh's (the
    compaction csrc/traverse_bvh4.cu shares), and scratch_words holds it
    and one list entry per lane; the kernel's compiled stack capacity (of
    bvh4::step in traverse_bvh.cuh, the walk it shares with the
    megakernel) is the plain version's STACK_DEPTH."""
    from vk_gltf_renderer_tpu_torch.ops import traverse_launch

    consts = _cu_constants("traverse_bvh4.cu", "live_lanes.cuh", "traverse_bvh.cuh")
    assert consts["kScratchHeader"] == traverse_launch.SCRATCH_HEADER
    assert consts["kStackCap"] == ttrav.STACK_DEPTH == 64
    assert [traverse_launch.scratch_words(n) for n in (0, 1, 1000)] == [4, 5, 1004]
    assert tb4.list_scratch is traverse_launch.list_scratch


def test_lane_and_v5_constants_match_the_kernels():
    """csrc/traverse_lanes.cu's window is the plain version's LANE_WINDOW
    (one entry a load round), csrc/traverse_bvh4_multipop.cu's pop group and
    compiled stack are MULTIPOP and STACK_DEPTH_MULTIPOP, and both wrappers
    pass the compaction's scratch (traverse_launch.list_scratch)."""
    lanes = _cu_constants("traverse_lanes.cu")
    assert lanes["kWindow"] == ttrav.LANE_WINDOW == 1 and ttrav.LANE_WINDOW in ttrav.LANE_WINDOWS
    assert lanes["kFields"] == tlane.FIELDS
    v5 = _cu_constants("traverse_bvh4_multipop.cu")
    assert v5["kMultipop"] == ttrav.MULTIPOP == 4
    assert v5["kStack"] == ttrav.STACK_DEPTH_MULTIPOP == 128
    assert v5["kMultipop"] % v5["kRayLanes"] == 0
    from vk_gltf_renderer_tpu_torch.ops import traverse_launch

    assert tlane.list_scratch is tbmp.list_scratch is traverse_launch.list_scratch


def _assert_variant_fits(kernel, name):
    """variant_sources of one bvh4_tuning.py variant applies to csrc/ as it
    is: every substitution matches once, the variant changes some file
    (the unchanged "source" aside), and a file in which its first anchor
    appears twice is refused."""
    files = bvh4_tuning._files(kernel)
    out = bvh4_tuning.variant_sources(kernel, name)
    changed = any(text != files[f] for f, text in out.items())
    assert changed == (name != "source")
    for old, new, *where in bvh4_tuning.VARIANTS[kernel][name]:
        assert new in out[where[0] if where else kernel]
    if name != "source":
        old, _, *where = bvh4_tuning.VARIANTS[kernel][name][0]
        first = old[0] if isinstance(old, tuple) else old
        target = where[0] if where else kernel
        twice = dict(files, **{target: files[target].replace(first, first + first)})
        with pytest.raises(ValueError, match="exactly once"):
            bvh4_tuning.variant_sources(kernel, name, twice)


@pytest.mark.parametrize("kernel,name", [(k, n) for k in bvh4_tuning.VARIANTS for n in bvh4_tuning.VARIANTS[k]])
def test_tuning_variant_fits_the_kernel_source(kernel, name):
    """Each ablation and tuning variant in bvh4_tuning.py fits the source it
    edits (_assert_variant_fits): the kernel's file, or a header of csrc/
    (live_lanes.cuh, traverse_bvh.cuh, sidecar_walk.cuh), and for "every
    element off" the generic walk before the redesign
    (bvh4_tuning.GENERIC) put back before the kernel's entry point."""
    _assert_variant_fits(kernel, name)


@pytest.mark.parametrize("kernel", sorted(bvh4_tuning.VARIANTS))
def test_tuning_variants_carry_test_leaf_where_they_call_it(kernel):
    """No kernel of the library calls the generic walk's one-triangle-at-a-
    time leaf test, and csrc/ no longer defines it (every walk, v1's since
    its redesign, tests leaves with the batched leaf of traverse_bvh.cuh).
    Each bvh4_tuning.py variant of `kernel` that calls test_leaf (its
    "whole-row loads off", "batched leaf off" and "every element off"
    variants) carries the definition: GENERIC's in namespace before, or
    RESTORE_TEST_LEAF's in traverse_bvh.cuh; else its build would fail on
    the card."""
    import re

    from vk_gltf_renderer_tpu_torch import cuda_lib

    call = re.compile(r"(?<!bool )\btest_leaf(?:<\w+>)?\(")
    for path in cuda_lib._CSRC.glob("*.cu*"):
        text = path.read_text()
        assert not call.search(text) and "bool test_leaf(" not in text, path.name
    files = bvh4_tuning._files(kernel)
    callers = 0
    for name in bvh4_tuning.VARIANTS[kernel]:
        out = bvh4_tuning.variant_sources(kernel, name, files)
        text = "".join(out.get(f, files[f]) for f in files)
        if call.search(text):
            callers += 1
            assert "bool test_leaf(" in text, name
    assert callers > 0 or kernel == "traverse_lanes.cu"


def test_v1_constants_match_the_kernel():
    """csrc/traverse_bvh2_split.cu's compiled stack is the plain version's
    STACK_DEPTH_SPLIT2, and its C entry takes the root_leaf scalar after
    the three tables and the scratch before the stream
    (cuda_lib._SIGNATURES)."""
    import ctypes

    from vk_gltf_renderer_tpu_torch import cuda_lib

    assert _cu_constants("traverse_bvh2_split.cu")["kStack"] == ttrav.STACK_DEPTH_SPLIT2 == 128
    sig = cuda_lib._SIGNATURES["vkgr_traverse_bvh2_split"]
    assert len(sig) == 3 + 1 + 8 + 1 + 5 + 3 and sig[3] is ctypes.c_int and sig[12] is ctypes.c_int
    src = (cuda_lib._CSRC / "traverse_bvh2_split.cu").read_text()
    assert "const float* tris, int root_leaf, const float* rox" in src
    assert "unsigned int* overflow, int* scratch, void* stream)" in src


def test_sidecar_walk_constants_match_the_kernels(monkeypatch):
    """The walk that v7 and packet4 share (csrc/sidecar_walk.cuh) holds the
    plain versions' STACK_DEPTH and STACK_DEPTH_SPLIT4 entries, both
    kernels include it, and both wrappers pass the compaction's scratch
    (traverse_launch.list_scratch)."""
    from vk_gltf_renderer_tpu_torch import cuda_lib
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4_split as tb4s
    from vk_gltf_renderer_tpu_torch.ops import traverse_launch

    assert _cu_constants("sidecar_walk.cuh")["kStackCap"] == ttrav.STACK_DEPTH == ttrav.STACK_DEPTH_SPLIT4 == 64
    for name in ("traverse_bvh4_sidecar.cu", "traverse_bvh4_split.cu"):
        assert '#include "sidecar_walk.cuh"' in (cuda_lib._CSRC / name).read_text()
    passed = {}

    def record(name, *args, extra=None):
        passed[name] = extra

    monkeypatch.setattr(tbsc, "run_traversal", record)
    monkeypatch.setattr(tb4s, "run_traversal", record)
    rays = [torch.zeros(1)] * 8
    tbsc.traverse_bvh4_sidecar(torch.zeros(1, 32), torch.zeros(1, 8, dtype=torch.int32), torch.zeros(1, 128), 0,
                               *rays)
    tb4s.traverse_bvh4_split(torch.zeros(1, 32), torch.zeros(1, 8, dtype=torch.int32), torch.zeros(9, 16), *rays)
    assert passed == {"traverse_bvh4_sidecar": traverse_launch.list_scratch,
                      "traverse_bvh4_split": traverse_launch.list_scratch}


def test_leafqueue_and_megakernel_constants_match_the_kernels(monkeypatch):
    """csrc/traverse_bvh4_leafqueue.cu's (v8) compiled stack and queue are
    the plain version's STACK_DEPTH and LEAF_QUEUE, its gate is 4 below the
    queue (an internal visit queues at most 4 leaves), and its wrapper
    passes the compaction's scratch (traverse_launch.list_scratch);
    csrc/megakernel.cu walks with traverse_bvh4.cu's step (bvh4::step),
    whose stack the megakernel's plain version (the plain BVH4 walk) has
    too."""
    from vk_gltf_renderer_tpu_torch import cuda_lib
    from vk_gltf_renderer_tpu_torch.ops import traverse_launch

    v8 = _cu_constants("traverse_bvh4_leafqueue.cu")
    assert v8["kStackInternal"] == ttrav.STACK_DEPTH == 64 and v8["kQueue"] == ttrav.LEAF_QUEUE == 16
    assert "constexpr int kGate = kQueue - 4;" in (cuda_lib._CSRC / "traverse_bvh4_leafqueue.cu").read_text()
    mega = (cuda_lib._CSRC / "megakernel.cu").read_text()
    assert "bvh4::step(" in mega and "int stack[bvh4::kStackCap];" in mega
    assert _cu_constants("traverse_bvh.cuh")["kStackCap"] == ttrav.STACK_DEPTH
    passed = {}

    def record(name, *args, extra=None):
        passed[name] = extra

    monkeypatch.setattr(tblq, "run_traversal", record)
    tblq.traverse_bvh4_leafqueue(torch.zeros(1, 32), torch.zeros(1, 128), 0, *[torch.zeros(1)] * 8)
    assert passed == {"traverse_bvh4_leafqueue": traverse_launch.list_scratch}


@pytest.mark.parametrize("anyhit", [False, True])
@pytest.mark.parametrize("scene,root", [("editor", "root"), ("few", "root"), ("few", "leaf")])
def test_plain_leafqueue_dead_lane_rule(scene, root, anyhit, request):
    """The dead-lane rule that the compaction of
    csrc/traverse_bvh4_leafqueue.cu (v8) relies on, in its plain version.
    From an internal root (the editor's, and the few scene's BVH4 row 0
    with its one leaf child) every lane with !(tmax >= 0), NaN and -inf
    included, returns (tmax, -1, -1, 0, 0) exactly whatever its other
    inputs, even where a triangle lies behind the origin in (tmin, tmax)
    (the few scene's rays from below, tmin -3, tmax -0.5): the root is
    visited with t_best = tmax and enters no child, so nothing is pushed
    or queued. The few scene's leaf passed as a negative root code goes
    straight to the queue, and there such a lane does hit that triangle,
    so a lane is dead only where also !(tmin < tmax), and every such lane
    returns (tmax, -1, -1, 0, 0)."""
    _, wb, bvh_t = request.getfixturevalue(scene)
    n = 512
    if scene == "few":
        ro, rd, tmin, up = _leaf_root_rays(n, seed=28)
    else:
        ro, rd, _ = _aimed_rays(wb, n, seed=28)
        tmin, up = np.zeros(n, np.float32), np.ones(n, bool)
    tmax = np.full(n, 2.5 if anyhit else 1e32, np.float32)
    tmax[1::4] = -0.5
    tmax[2::8] = np.nan
    tmax[3::8] = -np.inf
    tmax[5::16] = -4.0  # below tmin in the few scene's rays from below
    code = int(bvh_t.root4_code) if root == "root" else int(bvh_t.nodes4_fi[0, 24:28].min())
    assert (code < 0) == (root == "leaf")
    t, rn, tri, u, v, dropped = ttrav.traverse_bvh4_leafqueue_plain(bvh_t.nodes4_fi, bvh_t.tris128, code,
                                                                    *_soa(ro, rd, tmin, tmax), anyhit=anyhit)
    dead = ~(tmax >= 0)
    if code < 0:
        dead &= ~(tmin < tmax)
    assert dropped == 0 and dead.sum() > 60 and np.isnan(tmax[dead]).sum() > 40
    assert np.array_equal(t.numpy()[dead].view(np.int32), tmax[dead].view(np.int32))
    for ids in (rn, tri):
        assert (ids.numpy()[dead] == -1).all()
    for f in (u, v):
        assert np.array_equal(f.numpy()[dead].view(np.int32), np.zeros(dead.sum(), np.int32))
    assert (tri.numpy()[~dead] >= 0).sum() > 20
    behind = (tmax == -0.5) & ~up  # the plane at t = -1 lies in (tmin, tmax)
    assert (tri.numpy()[behind] >= 0).all() if code < 0 else not (tri.numpy()[behind] >= 0).any()
    assert behind.sum() > 20 or scene != "few"


def test_bvh2_and_bvh16_constants_match_the_kernels(monkeypatch):
    """csrc/traverse_bvh2.cu's and csrc/traverse_bvh16.cu's compiled stacks
    are the plain versions' STACK_DEPTH2 and STACK_DEPTH16; v6's group of
    threads a ray divides a warp and is the one its comment describes; both
    wrappers pass the compaction's scratch (traverse_launch.list_scratch)."""
    import re

    from vk_gltf_renderer_tpu_torch import cuda_lib
    from vk_gltf_renderer_tpu_torch.ops import traverse_launch

    assert _cu_constants("traverse_bvh2.cu")["kStack"] == ttrav.STACK_DEPTH2 == 128
    v6 = _cu_constants("traverse_bvh16.cu")
    assert v6["kStack"] == ttrav.STACK_DEPTH16 == 256
    lanes = v6["kRayLanes"]
    assert 32 % lanes == 0 and 16 % lanes == 0 and ttrav.LEAF_SLOTS % lanes == 0
    src = (cuda_lib._CSRC / "traverse_bvh16.cu").read_text()
    said = re.search(r"group of kRayLanes = (\d+) threads walks one ray \((\d+) rays a warp\)", src)
    assert said and (int(said.group(1)), int(said.group(2))) == (lanes, 32 // lanes)
    passed = {}

    def record(name, *args, extra=None):
        passed[name] = extra

    monkeypatch.setattr(tb2, "run_traversal", record)
    monkeypatch.setattr(tb16, "run_traversal", record)
    rays = [torch.zeros(1)] * 8
    tb2.traverse_bvh2(torch.zeros(1, 16), torch.zeros(1, 128), 0, *rays)
    tb16.traverse_bvh16(torch.zeros(1, 128), torch.zeros(1, 128), *rays)
    assert passed == {"traverse_bvh2": traverse_launch.list_scratch,
                      "traverse_bvh16": traverse_launch.list_scratch}


@pytest.mark.parametrize("anyhit", [False, True])
@pytest.mark.parametrize("kernel,scene", [("v2", "editor"), ("v2", "few"), ("v6", "editor"), ("v6", "few")])
def test_plain_bvh2_and_bvh16_dead_lane_rule(kernel, scene, anyhit, request):
    """The dead-lane rule that the compaction of csrc/traverse_bvh2.cu and
    csrc/traverse_bvh16.cu relies on, in their plain versions. v6 walks
    from row 0, which is internal even in the few scene (one row with one
    leaf child), and v2 from the editor's internal root: every lane with
    !(tmax >= 0), NaN and -inf included, returns (tmax, -1, -1, 0, 0)
    exactly, even where a triangle lies behind the origin in (tmin, tmax)
    (the few scene's rays from below, tmin -3, tmax -0.5). v2 from the few
    scene's leaf root accepts that triangle, so there a lane is dead only
    where also !(tmin < tmax), and every such lane returns (tmax, -1, -1,
    0, 0)."""
    _, wb, bvh_t = request.getfixturevalue(scene)
    n = 512
    if scene == "few":
        ro, rd, tmin, up = _leaf_root_rays(n, seed=27)
    else:
        ro, rd, _ = _aimed_rays(wb, n, seed=27)
        tmin, up = np.zeros(n, np.float32), np.ones(n, bool)
    tmax = np.full(n, 2.5 if anyhit else 1e32, np.float32)
    tmax[1::4] = -0.5
    tmax[2::8] = np.nan
    tmax[3::8] = -np.inf
    tmax[5::16] = -4.0  # below tmin in the few scene's rays from below
    rays = _soa(ro, rd, tmin, tmax)
    if kernel == "v2":
        root = bvh_t.root_code
        assert (root < 0) == (scene == "few")
        t, rn, tri, u, v, dropped = ttrav.traverse_bvh2_plain(bvh_t.nodes_fi, bvh_t.tris128, root, *rays,
                                                              anyhit=anyhit)
    else:
        root = 0
        t, rn, tri, u, v, dropped = ttrav.traverse_bvh16_plain(bvh_t.nodes16_fi, bvh_t.tris128, 0, *rays,
                                                               anyhit=anyhit)
    dead = ~(tmax >= 0)
    if root < 0:
        dead &= ~(tmin < tmax)
    assert dropped == 0 and dead.sum() > 60 and np.isnan(tmax[dead]).sum() > 40
    assert np.array_equal(t.numpy()[dead].view(np.int32), tmax[dead].view(np.int32))
    for ids in (rn, tri):
        assert (ids.numpy()[dead] == -1).all()
    for f in (u, v):
        assert np.array_equal(f.numpy()[dead].view(np.int32), np.zeros(dead.sum(), np.int32))
    assert (tri.numpy()[~dead] >= 0).sum() > 20
    behind = (tmax == -0.5) & ~up  # the plane at t = -1 lies in (tmin, tmax)
    assert (tri.numpy()[behind] >= 0).all() if root < 0 else not (tri.numpy()[behind] >= 0).any()
    assert behind.sum() > 20 or scene != "few"


@pytest.mark.parametrize("kernel,levels,per_ray", [("v2", 128, 0), ("v2", 129, 1), ("v2", 140, 12),
                                                   ("v6", 17, 0), ("v6", 18, 15), ("v6", 24, 15)])
def test_plain_bvh2_and_bvh16_count_overflow_on_a_deep_chain(kernel, levels, per_ray):
    """torch_test_helpers.deep_chain through the CPU wrappers: the BVH2
    walk's stack grows by 1 a row (the far leaf; it descends into the next
    row) and the BVH16 walk's by 15, so past 128 and 17 rows every live ray
    drops per_ray pushes (BVH2: one a row from row 128 on; dead lanes
    none), where bvh_flatten.stack_need says the stack is too small;
    nothing is hit."""
    arity, mod, call = {"v2": (2, tb2, lambda n, tr, r: tb2.traverse_bvh2(n, tr, 0, *r)),
                        "v6": (16, tb16, lambda n, tr, r: tb16.traverse_bvh16(n, tr, *r))}[kernel]
    nodes, tr = (torch.tensor(a) for a in deep_chain(levels, arity))
    rays = [torch.tensor(a) for a in deep_chain_rays(300, seed=43)]
    rays[7][::5] = -1.0
    live = int((rays[7] >= 0).sum())
    capacity = {"v2": ttrav.STACK_DEPTH2, "v6": ttrav.STACK_DEPTH16}[kernel]
    need = tbvh.stack_need(nodes.numpy(), arity.bit_length() - 1, 0, descend=kernel == "v2")
    assert need == levels * (arity - 1) + (kernel == "v6") and (need > capacity) == (per_ray > 0)
    mod.OVERFLOW.reset()
    t, _, tri, _, _ = call(nodes, tr, rays)
    assert mod.OVERFLOW.total() == per_ray * live
    mod.OVERFLOW.reset()
    assert (tri == -1).all() and torch.equal(t, rays[7])


def test_bvh2_stack_need_of_the_descending_walk(editor):
    """stack_need(descend=True), the check before a BVH2 launch, is one
    entry less than the push-every-child walk's need and bounds the
    deepest stack of a walk that keeps its next child out of the stack
    (pushes every real child but the last, walks that one next)."""
    _, wb, _ = editor
    nodes = np.asarray(wb.nodes_fi)
    need = tbvh.stack_need(nodes, 1, wb.root_code, descend=True)
    assert need == tbvh.stack_need(nodes, 1, wb.root_code) - 1 > 1
    deepest, stack, e = 0, [], wb.root_code
    while True:
        kids = [] if e < 0 else [int(nodes[e, 12 + s]) for s in range(2) if nodes[e, 6 * s] < 1e38]
        stack += kids[:-1]
        deepest = max(deepest, len(stack))
        if kids:
            e = kids[-1]
        elif stack:
            e = stack.pop()
        else:
            break
    assert 1 < deepest <= need


@pytest.mark.parametrize("levels", [21, 22, 24])
def test_plain_bvh4_counts_overflow_on_a_deep_chain(levels):
    """torch_test_helpers.deep_chain_bvh4 through the CPU wrapper: a live
    ray's stack needs 3 entries a row, so 21 rows fit the 64 entries and
    from 22 rows on every live ray drops 3 pushes (dead lanes none), in
    the BVH4 walk and in v7's; nothing is hit."""
    fi, sc, tr = (torch.tensor(a) for a in deep_chain_bvh4(levels))
    rays = [torch.tensor(a) for a in deep_chain_rays(300, seed=41)]
    rays[7][::5] = -1.0
    live = int((rays[7] >= 0).sum())
    want = 0 if levels < 22 else 3 * live
    tb4.OVERFLOW.reset()
    t, _, tri, _, _ = tb4.traverse_bvh4(fi, tr, 0, *rays)
    assert tb4.OVERFLOW.total() == want
    tb4.OVERFLOW.reset()
    assert (tri == -1).all() and torch.equal(t, rays[7])
    *_, dropped = ttrav.traverse_bvh4_sidecar_plain(fi, sc, tr, 0, *rays)
    assert dropped == want


@pytest.mark.parametrize("scene", ["terrain", "few"])
@pytest.mark.parametrize("kernel", ["v2", "v6", "lane"] + BVH4_VARIANTS)
def test_new_kernels_match_packet_kernel_on_terrain_and_leaf_root(scene, kernel, request):
    """Closest and any hit of BVH2, BVH16, the lane walk and the BVH4
    variants v5, v7 and v8 against the reference's kernel of the same name
    on the terrain grid and on the root-is-leaf scene.

    u/v tolerance 3e-5 on the terrain: its triangles are ~0.011 units
    across, so u and v (ratios of products of edge components) carry ~100x
    the absolute rounding of the editor's unit-size triangles, and the
    reference's interpret-mode arithmetic on XLA:CPU rounds differently
    from torch's (measured max 1.06e-5 on these rays, the same for the BVH4
    kernel v3). t keeps 1e-5."""
    _, wb, bvh_t = request.getfixturevalue(scene)
    ro, rd, tmax = _aimed_rays(wb, 512, seed=16)
    port = _port(bvh_t, ro, rd, tmax, kernel=kernel)
    ref = _ref_packet(wb, ro, rd, tmax, kernel)
    assert (ref["tri"] >= 0).sum() > 50
    _assert_closest_equal(port, ref, wb, ro, rd, uv_atol=3e-5 if scene == "terrain" else 1e-5)
    tmax = np.where(tmax > 0, np.float32(0.3), tmax)
    port = _port(bvh_t, ro, rd, tmax, anyhit=True, kernel=kernel)
    ref = _ref_packet(wb, ro, rd, tmax, kernel, anyhit=True)
    assert ((port["tri"] >= 0) == (ref["tri"] >= 0)).all()
    assert ((port["t"] == 0.0) == (ref["tri"] >= 0)).all()


@pytest.mark.parametrize("scene", ["editor", "terrain", "few"])
@pytest.mark.parametrize("kernel", ["v2", "v6", "lane"] + BVH4_VARIANTS)
def test_new_kernels_match_brute_oracle(scene, kernel, request):
    flat, wb, bvh_t = request.getfixturevalue(scene)
    ro, rd, tmax = _aimed_rays(wb, 256, seed=17)
    tmax[:] = 1e32
    port = _port(bvh_t, ro, rd, tmax, kernel=kernel)
    ref = ttrav.intersect_brute(flat, torch.tensor(ro), torch.tensor(rd))
    ref = {k: v.numpy() for k, v in ref.items()}
    hit = ref["t"] < INF
    assert hit.sum() > 20
    assert ((port["t"] < INF) == hit).all()
    np.testing.assert_allclose(port["t"][hit], ref["t"][hit], rtol=1e-4, atol=1e-4)
    same = port["tri"] == ref["tri"]
    tie = np.isclose(port["t"], ref["t"], rtol=1e-5, atol=0)
    assert (same | tie).all()


@pytest.mark.parametrize("scene", ["helmet", "terrain", "few"])
def test_no_overflow_in_any_kernel(scene, request):
    """Every plain version counts dropped work; none drops any on these
    scenes, and every tree fits its kernel's stack."""
    _, wb, bvh_t = request.getfixturevalue(scene)
    from vk_gltf_renderer_tpu_torch.ops.intersect import STACK_CAPACITY

    assert set(bvh_t.stack_need) == set(STACK_CAPACITY)
    for family, need in bvh_t.stack_need.items():
        assert 1 <= need <= STACK_CAPACITY[family], (family, need)
    # v8's stack holds internal codes only; v5's pop groups need more
    assert bvh_t.stack_need["bvh4_leafqueue"] <= bvh_t.stack_need["bvh4"]
    assert bvh_t.stack_need["bvh4_multipop"] >= bvh_t.stack_need["bvh4"]
    ro, rd, tmax = _aimed_rays(wb, 1024, seed=18)
    for mod in WRAPPERS.values():
        mod.OVERFLOW.reset()
    for kernel in WRAPPERS:
        _port(bvh_t, ro, rd, tmax, kernel=kernel)
        _port(bvh_t, ro, rd, np.where(tmax > 0, np.float32(1.0), tmax), anyhit=True, kernel=kernel)
    assert {k: m.OVERFLOW.total() for k, m in WRAPPERS.items()} == {k: 0 for k in WRAPPERS}


@pytest.mark.parametrize("kernel", ["v2", "v6", "v5", "v7", "v8"])
def test_stack_overflow_is_counted_per_arity(editor, kernel):
    """A stack too shallow for the tree drops pushes and counts them."""
    _, wb, bvh_t = editor
    ro, rd, tmax = _rays(wb, 256, seed=15)
    name = {"v2": "STACK_DEPTH2", "v6": "STACK_DEPTH16", "v5": "STACK_DEPTH_MULTIPOP",
            "v7": "STACK_DEPTH", "v8": "STACK_DEPTH"}[kernel]
    full = getattr(ttrav, name)
    tables = {"v2": (bvh_t.nodes_fi, bvh_t.tris128, bvh_t.root_code),
              "v6": (bvh_t.nodes16_fi, bvh_t.tris128, 0),
              "v5": (bvh_t.nodes4_fi, bvh_t.tris128, bvh_t.root4_code),
              "v7": (bvh_t.nodes4_fi, bvh_t.nodes4_sc, bvh_t.tris128, bvh_t.root4_code),
              "v8": (bvh_t.nodes4_fi, bvh_t.tris128, bvh_t.root4_code)}[kernel]
    plain = {"v2": ttrav.traverse_bvh2_plain, "v6": ttrav.traverse_bvh16_plain,
             "v5": ttrav.traverse_bvh4_multipop_plain, "v7": ttrav.traverse_bvh4_sidecar_plain,
             "v8": ttrav.traverse_bvh4_leafqueue_plain}[kernel]
    try:
        setattr(ttrav, name, 2)
        *_, dropped = plain(*tables,
                            *(torch.tensor(np.ascontiguousarray(a)) for a in (*ro.T, *rd.T)),
                            torch.zeros(256), torch.tensor(tmax))
    finally:
        setattr(ttrav, name, full)
    assert dropped > 0


def test_lane_walk_counts_links_that_do_not_advance(editor):
    """A malformed lane table (a link pointing back) ends the ray and is
    counted instead of looping."""
    _, wb, bvh_t = editor
    entries = bvh_t.lane_entries.clone()
    entries[1:, 9] = 0.0  # every skip / next pointer back to the root
    ro, rd, tmax = _rays(wb, 64, seed=19)
    *_, bad = ttrav.traverse_lanes_plain(
        entries, *(torch.tensor(np.ascontiguousarray(a)) for a in (*ro.T, *rd.T)),
        torch.zeros(64), torch.tensor(tmax))
    assert bad > 0


@pytest.mark.parametrize("scene", ["editor", "terrain"])
def test_leaf_queue_gate_engages_and_drops_nothing(scene, request):
    """A v8 queue shrunk to 5 entries makes the producer gate pause the
    internal pops; nothing is dropped and every hit equals the BVH4
    walk's. A queue of 4 could not take one internal visit and is refused."""
    _, wb, bvh_t = request.getfixturevalue(scene)
    ro, rd, tmax = _aimed_rays(wb, 512, seed=22)
    rays = (*(torch.tensor(np.ascontiguousarray(a)) for a in (*ro.T, *rd.T)), torch.zeros(512),
            torch.tensor(tmax))
    tables = (bvh_t.nodes4_fi, bvh_t.tris128, bvh_t.root4_code)
    ref = ttrav.traverse_bvh4_plain(*tables, *rays)
    full = ttrav.LEAF_QUEUE
    stats = {}
    try:
        ttrav.LEAF_QUEUE = 5
        out = ttrav.traverse_bvh4_leafqueue_plain(*tables, *rays, stats=stats)
        ttrav.LEAF_QUEUE = 4
        with pytest.raises(ValueError, match="leaf queue"):
            ttrav.traverse_bvh4_leafqueue_plain(*tables, *rays)
    finally:
        ttrav.LEAF_QUEUE = full
    assert stats["gated"] > 0 and out[5] == 0
    assert int((ref[2] >= 0).sum()) > 50
    assert torch.equal(out[2], ref[2]) and torch.equal(out[0], ref[0])


@pytest.mark.parametrize("kernel", BVH4_VARIANTS)
def test_bvh4_variants_are_routed(editor, kernel):
    """v5, v7 and v8 pass the renderer's check and read their own family."""
    from vk_gltf_renderer_tpu_torch.ops.intersect import ROUTES

    for cfg in (RenderConfig(primary_kernel=kernel), RenderConfig(packet_kernel=kernel)):
        cfg.check_supported()
        assert ROUTES[kernel] in cfg.kernel_tables()
    assert len({ROUTES[k] for k in ("v3", *BVH4_VARIANTS)}) == 4


def test_visit_counts(editor):
    """The plain walks' visit counters: every walk of one tree touches
    rows of it, v5 and v8 visit what the BVH4 walk visits or more, and
    the counts add up over calls."""
    _, wb, bvh_t = editor
    ro, rd, tmax = _aimed_rays(wb, 256, seed=23)
    rays = (*(torch.tensor(np.ascontiguousarray(a)) for a in (*ro.T, *rd.T)), torch.zeros(256),
            torch.tensor(tmax))
    tables = (bvh_t.nodes4_fi, bvh_t.tris128, bvh_t.root4_code)
    counts = {}
    for name, plain in (("v3", ttrav.traverse_bvh4_plain), ("v5", ttrav.traverse_bvh4_multipop_plain),
                        ("v8", ttrav.traverse_bvh4_leafqueue_plain)):
        stats = {}
        plain(*tables, *rays, stats=stats)
        assert 0 < int(stats["node_rows"].sum()) <= bvh_t.nodes4_fi.shape[0]
        assert 0 < int(stats["leaf_rows"].sum()) <= bvh_t.tris128.shape[0]
        assert stats["tris"] >= stats["leaf"] > 0
        counts[name] = stats["internal"] + stats["leaf"]
        plain(*tables, *rays, stats=stats)
        assert stats["internal"] + stats["leaf"] == 2 * counts[name]
    assert counts["v5"] >= counts["v3"] and counts["v8"] >= counts["v3"]
    lanes = {}
    ttrav.traverse_lanes_plain(bvh_t.lane_entries, *rays, stats=lanes)
    assert lanes["entries"] >= int(lanes["entry_rows"].sum()) > 0


@pytest.mark.parametrize("traversal,families", [("packet", {"bvh4"}), ("packet4", {"bvh4_split"}),
                                                 ("wavefront", {"wavefront"})])
def test_every_traversal_passes_the_check(traversal, families):
    """Each VKGR_TRAVERSAL value passes the renderer's check and reads its
    own tables; packet4 and wavefront do not read the kernel names."""
    cfg = RenderConfig(traversal=traversal)
    cfg.check_supported()
    assert cfg.kernel_tables() == families
    if traversal != "packet":
        assert RenderConfig(traversal=traversal, primary_kernel="v6",
                            packet_kernel="lane").kernel_tables() == families


@pytest.mark.parametrize("traversal", ["packet2", "Packet4", ""])
def test_unknown_traversal_raises(traversal):
    with pytest.raises(ValueError, match="unknown traversal"):
        RenderConfig(traversal=traversal).check_supported()


def test_unknown_kernel_and_missing_table_raise(editor, few):
    _, wb, bvh_t = editor
    ro, rd, tmax = _rays(wb, 8, seed=21)
    with pytest.raises(ValueError, match="unknown traversal kernel"):
        _port(bvh_t, ro, rd, tmax, kernel="v4")
    _, bare, _ = from_reference(None, tbvh.build_world_bvh(few[0]), None, "cpu")
    assert bare.nodes_fi is None and bare.nodes16_fi is None and bare.lane_entries is None
    assert bare.nodes4_sc is None and "bvh4_multipop" not in bare.stack_need
    for kernel in ("v2", "v6", "lane", "v5", "v7"):
        with pytest.raises(ValueError, match="add_kernel_tables"):
            _port(bare, ro, rd, tmax, kernel=kernel)


@pytest.mark.parametrize("kernel", ["v2", "v6", "lane"] + BVH4_VARIANTS)
def test_new_wrappers_refuse_other_devices(editor, kernel):
    _, _, bvh_t = editor
    rays = [torch.zeros(8, device="meta") for _ in range(8)]
    with pytest.raises(ValueError):
        if kernel == "v5":
            tbmp.traverse_bvh4_multipop(bvh_t.nodes4_fi, bvh_t.tris128, 0, *rays)
        elif kernel == "v7":
            tbsc.traverse_bvh4_sidecar(bvh_t.nodes4_fi, bvh_t.nodes4_sc, bvh_t.tris128, 0, *rays)
        elif kernel == "v8":
            tblq.traverse_bvh4_leafqueue(bvh_t.nodes4_fi, bvh_t.tris128, 0, *rays)
        elif kernel == "v2":
            tb2.traverse_bvh2(bvh_t.nodes_fi, bvh_t.tris128, 0, *rays)
        elif kernel == "v6":
            tb16.traverse_bvh16(bvh_t.nodes16_fi, bvh_t.tris128, *rays)
        else:
            tlane.traverse_lanes(bvh_t.lane_entries, *rays)


def test_share_native_builder_points_the_reference_at_the_port_build():
    """torch_test_helpers.share_native_builder (called at this module's
    import) points the reference's native cache at the port's build
    directory, where the port built the library atomically; the reference
    loads that file and builds nothing of its own."""
    from vk_gltf_renderer_tpu import native as jnative
    from vk_gltf_renderer_tpu_torch import native as tnative

    assert jnative._CACHE == tnative._CACHE == ROOT / "build" / "native"
    path = jnative._build_lib()
    assert path.parent == tnative._CACHE and path.stat().st_size > 0
    assert jnative.get_lib() is not None and tnative.get_lib() is not None
    assert not list(tnative._CACHE.glob("*.tmp"))


def _leaf_root_rays(n, seed):
    """Rays straight down onto the few scene's plane (y = 0), half from
    above (the plane at t = +1, tmin 0) and half from below (at t = -1,
    behind the origin, tmin -3); returns (ro, rd, tmin, up)."""
    rng = np.random.default_rng(seed)
    xz = rng.uniform(-0.9, 0.9, size=(n, 2)).astype(np.float32)
    up = rng.random(n) < 0.5
    ro = np.stack([xz[:, 0], np.where(up, 1.0, -1.0), xz[:, 1]], 1).astype(np.float32)
    rd = np.tile(np.float32([0.0, -1.0, 0.0]), (n, 1))
    return ro, rd, np.where(up, 0.0, -3.0).astype(np.float32), up


@pytest.mark.parametrize("anyhit", [False, True])
@pytest.mark.parametrize("scene", ["editor", "few"])
def test_plain_lane_walk_dead_lane_rule(scene, anyhit, request):
    """The lane walk's dead-lane rule, which csrc/traverse_lanes.cu's
    compaction relies on: every lane with !(tmax >= 0) returns (tmax, -1,
    -1, 0, 0) exactly. A negative tmax starts at the end, even where the
    lane tree's root is a triangle entry and a triangle lies in (tmin,
    tmax) behind the origin (the few scene: the BVH4 walk from its leaf
    root accepts it there); a NaN tmax walks entries but enters no box and
    accepts no triangle. A zero tmax is live: it walks, and agrees with the
    reference's lane kernel (interpret mode), which accepts a hit behind
    the origin for it."""
    _, wb, bvh_t = request.getfixturevalue(scene)
    n = 512
    if scene == "few":
        ro, rd, tmin, up = _leaf_root_rays(n, seed=26)
    else:
        ro, rd, _ = _aimed_rays(wb, n, seed=26)
        tmin, up = np.zeros(n, np.float32), np.ones(n, bool)
    tmax = np.full(n, 2.5 if anyhit else 1e32, np.float32)
    tmax[1::4] = -0.5
    tmax[2::8] = np.nan
    tmax[3::8] = -np.inf
    tmax[5::16] = 0.0
    dead = ~(tmax >= 0)
    rays = _soa(ro, rd, tmin, tmax)
    t, rn, tri, u, v, bad = ttrav.traverse_lanes_plain(bvh_t.lane_entries, *rays, anyhit=anyhit)
    assert bad == 0 and dead.sum() > 200 and np.isnan(tmax).sum() > 50
    assert np.array_equal(t.numpy()[dead].view(np.int32), tmax[dead].view(np.int32))
    for ids in (rn, tri):
        assert (ids.numpy()[dead] == -1).all()
    for f in (u, v):
        assert np.array_equal(f.numpy()[dead].view(np.int32), np.zeros(dead.sum(), np.int32))
    assert (tri.numpy()[~dead] >= 0).sum() > 20
    nan = np.isnan(tmax)
    stats = {}
    ttrav.traverse_lanes_plain(bvh_t.lane_entries, *(c[torch.tensor(nan)] for c in rays), anyhit=anyhit,
                               stats=stats)
    assert stats["entries"] >= nan.sum()  # NaN lanes walk, and still return their tmax
    zero = tmax == 0.0
    args = [jnp.asarray(a) for a in (*ro.T, *rd.T, tmin, tmax)]
    ref = intersect_rays_packet_soa(wb, *args, interpret=True, tiles=1, kernel="lane", anyhit=anyhit)
    ref_tri = np.asarray(ref["tri"])
    assert ((ref_tri >= 0) == (tri.numpy() >= 0)).all() and not (ref_tri[dead] >= 0).any()
    assert (ref_tri[zero] == tri.numpy()[zero]).all()
    if scene == "few":
        assert (tri.numpy()[zero & ~up] >= 0).all()  # live at tmax 0: the plane at t = -1 is accepted
        behind = (tmax == -0.5) & ~up
        leaf = int(bvh_t.nodes4_fi[0, 24:28].min())
        bvh4 = ttrav.traverse_bvh4_plain(bvh_t.nodes4_fi, bvh_t.tris128, leaf, *rays, anyhit=anyhit)
        assert behind.sum() > 20 and (bvh4[2].numpy()[behind] >= 0).all()
        assert (tri.numpy()[behind] == -1).all()


def test_lane_walk_counts_steps_and_load_rounds(terrain):
    """The plain lane walk's counters on the terrain: box and triangle
    entries add up to the visits, most steps go to the next entry, and the
    kernel's dependent load rounds equal the visits with a window of one
    entry and fall as the window grows (LANE_WINDOWS)."""
    _, wb, bvh_t = terrain
    ro, rd, tmax = _aimed_rays(wb, 1024, seed=27)
    stats = {}
    ttrav.traverse_lanes_plain(bvh_t.lane_entries, *_soa(ro, rd, np.zeros(1024, np.float32), tmax), stats=stats)
    entries, rounds = stats["entries"], stats["rounds"]
    assert stats["box_entries"] + stats["tri_entries"] == entries > 10_000
    assert stats["box_entries"] > 0 and stats["tri_entries"] > 0
    assert entries / 2 < stats["plus_one"] < entries
    assert list(rounds) == list(ttrav.LANE_WINDOWS)
    assert rounds[1] == entries
    assert entries / 2 <= rounds[2] < entries and rounds[ttrav.LANE_WINDOW] == entries
    assert rounds[8] <= rounds[4] <= rounds[2]


def test_v5_nearest_on_top_visits_no_more_than_the_old_order(terrain):
    """v5's order (the nearest member's children on top, the group tested
    against the t_best it was popped with) against the reference's order
    (nearest_on_top=False) on the terrain: no more internal or leaf visits,
    the same closest-hit t on every ray and ids except at equal-t ties,
    and the same occlusion."""
    _, wb, bvh_t = terrain
    ro, rd, tmax = _aimed_rays(wb, 1024, seed=28)
    tables = (bvh_t.nodes4_fi, bvh_t.tris128, bvh_t.root4_code)
    rays = _soa(ro, rd, np.zeros(1024, np.float32), tmax)
    new, old = {}, {}
    a = ttrav.traverse_bvh4_multipop_plain(*tables, *rays, stats=new)
    b = ttrav.traverse_bvh4_multipop_plain(*tables, *rays, stats=old, nearest_on_top=False)
    assert a[5] == b[5] == 0
    assert new["internal"] <= old["internal"] and new["leaf"] <= old["leaf"]
    assert new["internal"] + new["leaf"] < old["internal"] + old["leaf"]
    assert torch.equal(a[0], b[0]) and int((a[2] >= 0).sum()) > 200
    assert bool(((a[2] == b[2]) | (a[0] == b[0])).all())
    shadow = np.where(tmax > 0, np.float32(0.3), tmax)
    rays = _soa(ro, rd, np.zeros(1024, np.float32), shadow)
    a = ttrav.traverse_bvh4_multipop_plain(*tables, *rays, anyhit=True)
    b = ttrav.traverse_bvh4_multipop_plain(*tables, *rays, anyhit=True, nearest_on_top=False)
    assert torch.equal(a[2] >= 0, b[2] >= 0) and int((a[2] >= 0).sum()) > 50


@pytest.mark.parametrize("scene", ["editor", "helmet", "terrain", "few"])
def test_v5_stack_need_fits_the_compiled_stack(scene, request):
    """multipop_stack_need under the new push order is within the v5
    kernel's compiled stack (STACK_DEPTH_MULTIPOP, kStack of
    csrc/traverse_bvh4_multipop.cu) on every scene, and at least what one
    pop a step needs."""
    _, wb, bvh_t = request.getfixturevalue(scene)
    need = tbvh.multipop_stack_need(wb.nodes4_fi, wb.root4_code, ttrav.MULTIPOP)
    assert need == bvh_t.stack_need["bvh4_multipop"] <= ttrav.STACK_DEPTH_MULTIPOP
    assert need >= tbvh.multipop_stack_need(wb.nodes4_fi, wb.root4_code, 1)


@pytest.mark.parametrize("levels,want", [(10, 0), (11, 4), (24, 8)])
def test_plain_v5_counts_overflow_on_a_stub_chain(levels, want):
    """torch_test_helpers.deep_chain_bvh4(stubs=True) through the CPU
    wrapper: the v5 walk's stack grows by 12 a row, so 10 rows fit its 128
    entries and from 11 rows on every live ray drops pushes (4, then 8
    once the next chain row is itself dropped), dead lanes none; nothing
    is hit."""
    fi, _, tr = (torch.tensor(a) for a in deep_chain_bvh4(levels, stubs=True))
    rays = [torch.tensor(a) for a in deep_chain_rays(300, seed=42)]
    rays[7][::5] = -1.0
    live = int((rays[7] >= 0).sum())
    tbmp.OVERFLOW.reset()
    t, _, tri, _, _ = tbmp.traverse_bvh4_multipop(fi, tr, 0, *rays)
    assert tbmp.OVERFLOW.total() == want * live
    tbmp.OVERFLOW.reset()
    assert (tri == -1).all() and torch.equal(t, rays[7])
