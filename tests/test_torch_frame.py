"""Whole frames: the port's GltfRenderer against the JAX GltfRenderer on the
CPU (which runs the reference's non-compact path with its portable
traversal), same scene, camera, environment and frame indices.

Requirements and why they hold: every lane carries the same RNG stream
(xxhash32(px, py, frame)), and each operation is the same float32
operation in the same order, so paths only part where a last-ulp
difference flips a discrete decision (a triangle edge, an equal-t tie, a
lobe or roulette threshold) — rare, and then that pixel differs wholesale.
So: first-hit ids equal on >= 99.9% of pixels, >= 99% of pixels within
1e-3 * (1 + |ref|) in every channel, each channel's image mean within 1e-3
relative, and the ray counts equal.

The terrain tests render the 8,192-triangle terrain grid
(scenes.write_large_glb, grid=2) under each traversal-kernel selection of
the port (VKGR_PRIMARY_KERNEL, VKGR_PACKET_KERNEL) and under
VKGR_TRAVERSAL=packet4 and wavefront against one JAX reference render (its
CPU path traverses without kernels, through the wavefront walk), at the
same thresholds; the helmet + HDR frame is also rendered under packet4."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import baseline_standins  # noqa: E402
from vk_gltf_renderer_tpu.renderer import GltfRenderer as JaxRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch.scenes import write_large_glb, write_synthetic_hdr  # noqa: E402
from torch_test_helpers import one_torch_thread, share_native_builder  # noqa: E402, F401 (a fixture)

share_native_builder()

W, H, DEPTH, FRAMES = 48, 32, 5, 2


def _render(renderer, scene_path, hdr_path):
    renderer.create_scene(scene_path)
    if hdr_path is not None:
        renderer.create_hdr(hdr_path)
    out = []
    for _ in range(FRAMES):
        aux = renderer.on_render()
        aux = {k: np.asarray(v.cpu() if hasattr(v, "cpu") else v) for k, v in aux.items()}
        out.append((np.array(renderer.image_linear()), aux))
    return out


def _tiny_path(tmp_path):
    from __graft_entry__ import _tiny_scene

    p = tmp_path / "tiny.gltf"
    _tiny_scene().save(p)
    return str(p)


def _helmet_path(tmp_path):
    return baseline_standins.make_helmet(str(tmp_path))


def _assert_frames_agree(ref, port):
    for frame, ((img_r, aux_r), (img_p, aux_p)) in enumerate(zip(ref, port, strict=True)):
        assert img_p.shape == (H, W, 3) and np.isfinite(img_p).all()
        assert img_p.mean() > 0.01, "black frame"
        ids_equal = (aux_p["first_rnode"] == aux_r["first_rnode"]) & (aux_p["first_tri"] == aux_r["first_tri"])
        assert ids_equal.mean() >= 0.999, (frame, ids_equal.mean())
        close = (np.abs(img_p - img_r) <= 1e-3 * (1.0 + np.abs(img_r))).all(axis=-1)
        assert close.mean() >= 0.99, (frame, close.mean())
        m_p, m_r = img_p.mean(axis=(0, 1)), img_r.mean(axis=(0, 1))
        np.testing.assert_allclose(m_p, m_r, rtol=1e-3, err_msg=f"frame {frame} channel means")
        assert float(aux_p["rays"]) == float(aux_r["rays"]) > W * H


@pytest.mark.parametrize("scene,env", [("helmet", "hdr"), ("tiny", "sky")])
def test_frame_matches_jax_renderer(scene, env, tmp_path):
    path = (_helmet_path if scene == "helmet" else _tiny_path)(tmp_path)
    hdr = write_synthetic_hdr(tmp_path / "env.hdr", 64, 128) if env == "hdr" else None
    ref = _render(JaxRenderer(W, H, spp=1, max_depth=DEPTH), path, hdr)
    port = _render(GltfRenderer(W, H, spp=1, max_depth=DEPTH, device="cpu"), path, hdr)
    _assert_frames_agree(ref, port)


@pytest.fixture(scope="module")
def terrain_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("terrain")
    path = str(d / "terrain.glb")
    write_large_glb(path, target_tris=8000, grid=2)
    hdr = write_synthetic_hdr(d / "env.hdr", 64, 128)
    return path, hdr, _render(JaxRenderer(W, H, spp=1, max_depth=DEPTH), path, hdr)


@pytest.mark.parametrize("primary,packet", [("v3", "v9"), ("v2", "v2"), ("v6", "v6"),
                                            ("lane", "lane_stream"), ("v5", "v5"), ("v7", "v7"),
                                            ("v3", "v8")])
def test_terrain_frame_matches_jax_renderer_per_kernel(primary, packet, terrain_ref, monkeypatch):
    path, hdr, ref = terrain_ref
    monkeypatch.setenv("VKGR_PRIMARY_KERNEL", primary)
    monkeypatch.setenv("VKGR_PACKET_KERNEL", packet)
    r = GltfRenderer(W, H, spp=1, max_depth=DEPTH, device="cpu")
    port = _render(r, path, hdr)
    cfg = r._config()
    assert (cfg.primary_kernel, cfg.packet_kernel) == (primary, packet)
    # exactly the tables the selection reads were built
    families = cfg.kernel_tables()
    assert (r.dev_bvh.nodes_fi is not None) == ("bvh2" in families)
    assert (r.dev_bvh.nodes16_fi is not None) == ("bvh16" in families)
    assert (r.dev_bvh.lane_entries is not None) == ("lane" in families)
    assert (r.dev_bvh.nodes4_sc is not None) == ("bvh4_sidecar" in families)
    assert ("bvh4_multipop" in r.dev_bvh.stack_need) == ("bvh4_multipop" in families)
    _assert_frames_agree(ref, port)


SPLIT_TABLES = ("nodes_i", "nodes_f", "nodes_self", "nodes4_i", "nodes4_f")


@pytest.mark.parametrize("traversal,tables", [("packet4", {"nodes4_i", "nodes4_f"}),
                                              ("wavefront", {"nodes_i", "nodes_self"})])
@pytest.mark.usefixtures("one_torch_thread")
def test_terrain_frame_matches_jax_renderer_per_traversal(traversal, tables, terrain_ref, monkeypatch):
    """VKGR_TRAVERSAL=packet4 (the split BVH4 kernel for every trace) and
    wavefront (the stackless walk) against the same JAX frames, whose CPU
    path is itself the wavefront walk; each builds only its own tables."""
    path, hdr, ref = terrain_ref
    monkeypatch.setenv("VKGR_TRAVERSAL", traversal)
    monkeypatch.setenv("VKGR_PRIMARY_KERNEL", "v6")  # not read by either traversal
    r = GltfRenderer(W, H, spp=1, max_depth=DEPTH, device="cpu")
    port = _render(r, path, hdr)
    assert r._config().traversal == traversal
    assert {k for k in SPLIT_TABLES if getattr(r.dev_bvh, k) is not None} == tables
    assert r.dev_bvh.tris is not None and r.dev_bvh.wtri_rnode is not None
    assert r.dev_bvh.nodes16_fi is None and r.dev_bvh.nodes_fi is None
    _assert_frames_agree(ref, port)


def test_helmet_hdr_frame_matches_jax_renderer_under_packet4(tmp_path, monkeypatch):
    path = _helmet_path(tmp_path)
    hdr = write_synthetic_hdr(tmp_path / "env.hdr", 64, 128)
    ref = _render(JaxRenderer(W, H, spp=1, max_depth=DEPTH), path, hdr)
    monkeypatch.setenv("VKGR_TRAVERSAL", "packet4")
    r = GltfRenderer(W, H, spp=1, max_depth=DEPTH, device="cpu")
    port = _render(r, path, hdr)
    assert r.dev_bvh.nodes4_i is not None and r.dev_bvh.nodes_self is None
    _assert_frames_agree(ref, port)


def test_entry_points_default_to_the_card():
    """The renderer, the megakernel's ray packing and the front ends
    (headless, the benchmark harness's headless and run, the bench entry)
    run on the card unless the caller asks for the CPU."""
    import inspect

    from vk_gltf_renderer_tpu_torch import bench_impl, headless
    from vk_gltf_renderer_tpu_torch.benchmark import __main__ as benchmark
    from vk_gltf_renderer_tpu_torch.ops.megakernel import pack_rays

    assert inspect.signature(GltfRenderer).parameters["device"].default == "cuda"
    assert inspect.signature(pack_rays).parameters["device"].default == "cuda"
    assert headless.build_parser().parse_args([]).device == "cuda"
    assert bench_impl.build_parser().parse_args([]).device == "cuda"
    for argv in (["headless", "--scene", "x.gltf"], ["run", "x.cfg"]):
        assert benchmark.build_parser().parse_args(argv).device == "cuda"


@pytest.mark.usefixtures("one_torch_thread")
def test_selection_change_builds_tables_and_unported_names_raise(tmp_path, monkeypatch):
    r = GltfRenderer(16, 12, spp=1, max_depth=2, device="cpu")
    r.create_scene(_tiny_path(tmp_path))
    assert r.dev_bvh.nodes16_fi is None
    monkeypatch.setenv("VKGR_PACKET_KERNEL", "v6")
    r.on_render()
    assert r.dev_bvh.nodes16_fi is not None and r.dev_bvh.nodes_fi is None
    assert r.dev_bvh.nodes4_sc is None
    for var, value in (("VKGR_PACKET_KERNEL", "v8"), ("VKGR_PRIMARY_KERNEL", "v5"),
                       ("VKGR_PRIMARY_KERNEL", "v7")):
        with monkeypatch.context() as m:
            m.setenv(var, value)
            r.on_render()
    assert r.dev_bvh.nodes4_sc is not None and "bvh4_multipop" in r.dev_bvh.stack_need
    # the split traversals render and add their own tables; a traversal
    # that is not ported (no such value in the reference) raises
    for value, tables in (("packet4", ("nodes4_i", "nodes4_f")), ("wavefront", ("nodes_self",))):
        assert all(getattr(r.dev_bvh, k) is None for k in tables)
        with monkeypatch.context() as m:
            m.setenv("VKGR_TRAVERSAL", value)
            r.on_render()
        assert all(getattr(r.dev_bvh, k) is not None for k in tables)
    for value in ("packet2", "Wavefront"):
        with monkeypatch.context() as m:
            m.setenv("VKGR_TRAVERSAL", value)
            with pytest.raises(ValueError, match="unknown traversal"):
                r.on_render()


def test_save_image_writes_png(tmp_path):
    from vk_gltf_renderer_tpu_torch.utils.png import read_png

    r = GltfRenderer(16, 12, spp=1, max_depth=2, device="cpu")
    r.create_scene(_tiny_path(tmp_path))
    r.on_render()
    r.save_image(tmp_path / "out.png")
    img = read_png((tmp_path / "out.png").read_bytes())
    assert img.shape == (12, 16, 3) and img.max() > 0
    assert np.array_equal(img, (np.clip(r.image_tonemapped(), 0, 1) * 255).astype(np.uint8))
