"""Port traversal: the plain BVH4 traversal (the CUDA kernel's plain torch
version) against the reference's packet kernels in Pallas interpret mode
(v3 = traverse_packets3, v9 = traverse_packets9) and against both
brute-force oracles, closest hit and any hit (as tests/test_bvh.py does
for the reference's own kernels).

Tolerances: the kernels share the arithmetic exactly, so t/u/v agree to
float32 rounding (1e-5); ids agree except where two triangles hit at the
same t, which any traversal order may resolve either way. Against the
brute oracles, which intersect in object space, t agrees to 1e-4 as in
tests/test_bvh.py."""

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
from vk_gltf_renderer_tpu_torch.convert import from_reference  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse as ttrav  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4  # noqa: E402

INF = 1e30


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


@pytest.fixture(scope="module")
def editor():
    sc = _editor_scene()
    flat = build_scene_flat(sc)
    wb = build_world_bvh(flat)
    assert wb.nodes4_fi.shape[0] > 2  # a real multi-level BVH4
    _, bvh_t, _ = from_reference(None, wb, None, "cpu")
    return flat, wb, bvh_t


@pytest.fixture(scope="module")
def helmet(tmp_path_factory):
    sc = Scene()
    sc.load(baseline_standins.make_helmet(str(tmp_path_factory.mktemp("helmet"))))
    flat = build_scene_flat(sc)
    wb = build_world_bvh(flat)
    _, bvh_t, _ = from_reference(None, wb, None, "cpu")
    return flat, wb, bvh_t


def _port(bvh_t, ro, rd, tmax, anyhit=False):
    c = [torch.tensor(np.ascontiguousarray(a)) for a in (*ro.T, *rd.T)]
    n = ro.shape[0]
    out = tb4.intersect_rays_soa(bvh_t, *c, torch.zeros(n), torch.tensor(tmax), anyhit=anyhit)
    return {k: v.numpy() for k, v in out.items()}


def _ref_packet(wb, ro, rd, tmax, kernel, anyhit=False):
    n = ro.shape[0]
    args = [jnp.asarray(ro[:, 0]), jnp.asarray(ro[:, 1]), jnp.asarray(ro[:, 2]),
            jnp.asarray(rd[:, 0]), jnp.asarray(rd[:, 1]), jnp.asarray(rd[:, 2]),
            jnp.zeros(n), jnp.asarray(tmax)]
    out = intersect_rays_packet_soa(wb, *args, interpret=True, tiles=1, kernel=kernel, anyhit=anyhit)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_closest_equal(port, ref, wb, ro, rd):
    hit = ref["tri"] >= 0
    assert ((port["tri"] >= 0) == hit).all()
    np.testing.assert_allclose(port["t"], ref["t"], rtol=1e-5, atol=1e-5)
    same = (port["tri"] == ref["tri"]) & (port["rnode"] == ref["rnode"])
    # ids may differ only on equal-t ties
    tie = np.isclose(port["t"], ref["t"], rtol=1e-6, atol=0)
    assert (same | tie).all()
    np.testing.assert_allclose(port["u"][same & hit], ref["u"][same & hit], atol=1e-5)
    np.testing.assert_allclose(port["v"][same & hit], ref["v"][same & hit], atol=1e-5)


@pytest.mark.parametrize("kernel", ["v3", "v9"])
def test_plain_closest_hit_matches_packet_kernel(editor, kernel):
    _, wb, bvh_t = editor
    ro, rd, tmax = _rays(wb, 1024, seed=11)
    port = _port(bvh_t, ro, rd, tmax)
    ref = _ref_packet(wb, ro, rd, tmax, kernel)
    assert (ref["tri"] >= 0).sum() > 300
    _assert_closest_equal(port, ref, wb, ro, rd)
    assert (port["t"][tmax < 0] == 1e32).all() and (port["tri"][tmax < 0] == -1).all()


@pytest.mark.parametrize("kernel", ["v3", "v9"])
def test_plain_any_hit_matches_packet_kernel(editor, kernel):
    _, wb, bvh_t = editor
    ro, rd, tmax = _rays(wb, 1024, seed=12)
    tmax = np.where(tmax > 0, np.float32(2.5), tmax)  # finite shadow segments
    port = _port(bvh_t, ro, rd, tmax, anyhit=True)
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
    tb4.reset_stack_overflows()
    ro, rd, tmax = _rays(wb, 2048, seed=14)
    _port(bvh_t, ro, rd, tmax)
    _port(bvh_t, ro, rd, tmax, anyhit=True)
    assert tb4.stack_overflows() == 0


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
