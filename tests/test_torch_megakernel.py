"""The port's bounce-loop megakernel path against the reference's
(vk_gltf_renderer_tpu/ops/megakernel.py) on the CPU: render_wavefront of
the port, which on CPU tensors runs the plain BVH4 walk and is
render_mega's plain version, against the reference's render_mega and
render_wavefront in interpret mode.

Scenes: the editor scene (sphere, cube, plate) and the 8,192-triangle
terrain grid (scenes.write_large_glb, grid 2), each written to one glTF
file and loaded through both packages' own loaders and builders.

Tolerances: both sides run the same float32 operations in the same order
(the LCG in uint32 on one side and int64 masked to 32 bits on the other),
but the reference normalises with lax.rsqrt and XLA:CPU fuses the
interpret-mode arithmetic its own way, so a direction or a hit point may
differ in the last bit. Radiance must then be equal except on rays whose
hit flips under such a change: at most 1% of the rays, counted and
reported. Where radiance agrees, the last t agrees to 1e-5 relative."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import baseline_standins  # noqa: E402
from vk_gltf_renderer_tpu.models import Scene as JaxScene  # noqa: E402
from vk_gltf_renderer_tpu.models.editor import SceneEditor  # noqa: E402
from vk_gltf_renderer_tpu.ops import megakernel as jmega  # noqa: E402
from vk_gltf_renderer_tpu.ops.bvh_flatten import build_world_bvh as jax_world_bvh  # noqa: E402
from vk_gltf_renderer_tpu.ops.flat import build_scene_flat as jax_scene_flat  # noqa: E402
from vk_gltf_renderer_tpu.ops.pallas_traverse import traverse_packets3  # noqa: E402
from vk_gltf_renderer_tpu.ops.traverse import as_device  # noqa: E402
from vk_gltf_renderer_tpu_torch.models import Scene  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import megakernel as tmega  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops.bvh_flatten import build_world_bvh  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops.flat import build_scene_flat  # noqa: E402
from vk_gltf_renderer_tpu_torch.scenes import write_large_glb  # noqa: E402
from torch_test_helpers import share_native_builder  # noqa: E402

share_native_builder()

FLIP_SHARE = 0.01


def _editor_gltf(path):
    sc = baseline_standins._empty_scene()
    ed = SceneEditor(sc)
    ed.add_primitive("sphere", segments=12)
    cube = ed.add_primitive("cube")
    ed.set_translation(cube, [2.0, 0.5, -1.0])
    plate = ed.add_primitive("plane")
    ed.set_translation(plate, [0.0, -1.2, 0.0])
    ed.set_scale(plate, [3.0, 1.0, 3.0])
    sc.parse_scene()
    sc.save(path)
    return str(path)


@pytest.fixture(scope="module", params=["editor", "terrain"])
def scene(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(request.param)
    if request.param == "editor":
        path = _editor_gltf(d / "editor.gltf")
    else:
        path = str(d / "terrain.glb")
        write_large_glb(path, target_tris=8000, grid=2)
    js = JaxScene()
    js.load(path)
    ref = as_device(jax_world_bvh(jax_scene_flat(js)))
    ts = Scene()
    ts.load(path)
    port = build_world_bvh(build_scene_flat(ts))
    return ref, port


def _rays(port, n, seed):
    """Origins on the upper half of a sphere around the scene, aimed at
    random points of its box; numpy uint32 seeds."""
    rng = np.random.default_rng(seed)
    lo, hi = port.nodes_self[0, 0:3], port.nodes_self[0, 3:6]
    c, r = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 1] = np.abs(d[:, 1])
    ro = (c + d * r).astype(np.float32)
    rd = lo + rng.random((n, 3)) * (hi - lo) - ro
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    seeds = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    return ro, rd, seeds


def _port_inputs(port, ro, rd, seeds):
    ro_p, rd_p, seeds_p, n = tmega.pack_rays(ro, rd, seeds, device="cpu")
    return (torch.tensor(port.nodes4_fi), torch.tensor(port.tris128), ro_p, rd_p, seeds_p), n


def test_pack_rays_matches_reference(scene):
    _, port = scene
    ro, rd, seeds = _rays(port, 1500, seed=1)
    (_, _, ro_p, rd_p, seeds_p), n = _port_inputs(port, ro, rd, seeds)
    ref = jmega.pack_rays(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(seeds))
    assert n == ref[3] == 1500
    assert np.array_equal(ro_p.numpy(), np.asarray(ref[0]))
    assert np.array_equal(rd_p.numpy(), np.asarray(ref[1]))
    assert np.array_equal(seeds_p.numpy().view(np.uint32), np.asarray(ref[2]))


@pytest.mark.parametrize("arm", ["mega", "wavefront"])
def test_wavefront_matches_reference_arms(scene, arm):
    ref_bvh, port = scene
    ro, rd, seeds = _rays(port, 2048, seed=2)
    depth = 3
    args, n = _port_inputs(port, ro, rd, seeds)
    out = tmega.render_wavefront(*args, depth=depth, root_code=port.root4_code).numpy()
    assert np.array_equal(out, tmega.render_mega(*args, depth=depth, root_code=port.root4_code).numpy())
    ro_j, rd_j, seeds_j, _ = jmega.pack_rays(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(seeds))
    fn = jmega.render_mega if arm == "mega" else jmega.render_wavefront
    ref = np.asarray(fn(ref_bvh.nodes4_fi, ref_bvh.tris128, ro_j, rd_j, seeds_j, depth=depth,
                        root_code=ref_bvh.root4_code, interpret=True))
    rad, rad_ref = out[:, 0].reshape(-1)[:n], ref[:, 0].reshape(-1)[:n]
    t, t_ref = out[:, 1].reshape(-1)[:n], ref[:, 1].reshape(-1)[:n]
    flips = rad != rad_ref
    print(f"{arm}: {int(flips.sum())} of {n} rays flip")
    assert flips.sum() <= FLIP_SHARE * n
    np.testing.assert_allclose(t[~flips], t_ref[~flips], rtol=1e-5, atol=1e-5)
    # a real path: rays escape at every depth, so radiance takes the
    # values SKY * ALBEDO^k, and dead lanes carry the -1 sentinel
    for value in (0.0, tmega.SKY * tmega.ALBEDO, tmega.SKY):
        assert np.isclose(rad, value, rtol=0, atol=1e-6).any(), value
    assert (t == -1.0).any() and (t == np.float32(1e30)).any()


@pytest.mark.parametrize("depth", [1, 3])
def test_plain_on_permuted_rays_matches_reference(scene, depth):
    """The premise of the megakernel's refill by path (csrc/megakernel.cu's
    lanes take paths in any order): each path's output depends only on its
    own inputs. render_mega_plain on a permutation of the rays equals the
    same permutation of its output on the rays in order bit for bit, and
    of the reference's render_mega (interpret mode) at
    test_wavefront_matches_reference_arms's tolerances, at depths 1 and 3,
    with paths that end at every bounce (stats["ended"])."""
    ref_bvh, port = scene
    n = 2048
    ro, rd, seeds = _rays(port, n, seed=5)
    perm = np.random.default_rng(5).permutation(n)
    args, n_in_order = _port_inputs(port, ro, rd, seeds)
    args_perm, n_perm = _port_inputs(port, ro[perm], rd[perm], seeds[perm])
    assert n_in_order == n_perm == n  # 2 packets of 1024 rays, no padding
    stats = {}
    out = tmega.render_mega_plain(*args_perm, depth=depth, root_code=port.root4_code, stats=stats).numpy()
    in_order = tmega.render_mega_plain(*args, depth=depth, root_code=port.root4_code).numpy()
    rad, t = (out[:, c].reshape(-1) for c in (0, 1))
    assert np.array_equal(rad.view(np.int32), in_order[:, 0].reshape(-1)[perm].view(np.int32))
    assert np.array_equal(t.view(np.int32), in_order[:, 1].reshape(-1)[perm].view(np.int32))
    ro_j, rd_j, seeds_j, _ = jmega.pack_rays(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(seeds))
    ref = np.asarray(jmega.render_mega(ref_bvh.nodes4_fi, ref_bvh.tris128, ro_j, rd_j, seeds_j, depth=depth,
                                       root_code=ref_bvh.root4_code, interpret=True))
    rad_ref, t_ref = (ref[:, c].reshape(-1)[:n][perm] for c in (0, 1))
    flips = rad != rad_ref
    print(f"depth {depth}: {int(flips.sum())} of {n} rays flip; paths ended by bounce {stats['ended']}")
    assert flips.sum() <= FLIP_SHARE * n
    np.testing.assert_allclose(t[~flips], t_ref[~flips], rtol=1e-5, atol=1e-5)
    ended = stats["ended"]
    assert len(ended) == depth and sum(ended) == n and min(ended) > 0


def test_depth1_equals_single_trace(scene):
    """depth 1 == one traversal + one shade step (the reference's
    test_mega_depth1_equals_single_trace)."""
    ref_bvh, port = scene
    ro, rd, seeds = _rays(port, 1024, seed=3)
    args, n = _port_inputs(port, ro, rd, seeds)
    rad = tmega.render_mega(*args, depth=1, root_code=port.root4_code)[:, 0].reshape(-1)[:n]
    ro_j, rd_j, _, _ = jmega.pack_rays(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(seeds))
    out_t = traverse_packets3(ref_bvh.nodes4_fi, ref_bvh.tris128, ro_j, rd_j, ref_bvh.root4_code,
                              tiles=1, interpret=True)
    tri = np.asarray(out_t)[:, 2].reshape(-1)[:n]
    assert 0 < (tri >= 0).sum() < n
    np.testing.assert_array_equal(rad.numpy(), np.where(tri >= 0, 0.0, tmega.SKY).astype(np.float32))


def test_lcg_matches_reference_uint32():
    """The int64-masked LCG and cube map equal the reference's uint32 ones
    on seeds across the whole uint32 range."""
    seeds = np.array([0, 1, 12345, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    dx, dy, dz, s = jmega._cube_dir(jnp.asarray(seeds))
    pdx, pdy, pdz, ps = tmega._cube_dir(torch.tensor(seeds.astype(np.int64)))
    assert np.array_equal(ps.numpy().astype(np.uint32), np.asarray(s))
    for a, b in ((pdx, dx), (pdy, dy), (pdz, dz)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-7, atol=0)


def test_render_mega_refuses_other_devices(scene):
    _, port = scene
    ro, rd, seeds = _rays(port, 8, seed=4)
    args, _ = _port_inputs(port, ro, rd, seeds)
    with pytest.raises(ValueError):
        tmega.render_mega(*(a.to("meta") for a in args), depth=2)
