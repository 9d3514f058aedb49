"""parallel/ on the CPU: one frame with its rows split over devices and
over processes.

- render_mesh over ["cpu"] * k (k = 2, 4, 8; one device named k times
  renders k shards in turn) gives on_render's accumulation and per-pixel
  outputs bit for bit, with the same ray count, frame after frame; and the
  frame agrees with the JAX package's unsharded render at
  tests/test_torch_frame.py's thresholds.
- With renderer.adaptive set, render_mesh retargets spp through
  AdaptiveSampler.update_global with the summed ray count.
- The replicas of the device tables are dropped when the tables change.
- Two processes (`python -m vk_gltf_renderer_tpu_torch.parallel.multihost`,
  gloo on the CPU) each render half the rows; each requires its shard to
  equal its own unsharded frame bit for bit and the ranks' adaptive spp
  sequences to agree, and prints a MULTIHOST_OK line within 120 s."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vk_gltf_renderer_tpu.renderer import GltfRenderer as JaxRenderer
from vk_gltf_renderer_tpu_torch.parallel import render_mesh
from vk_gltf_renderer_tpu_torch.parallel.mesh import row_shards
from vk_gltf_renderer_tpu_torch.renderer import AdaptiveSampler, GltfRenderer
from vk_gltf_renderer_tpu_torch.scenes import helmet_with_texture, texture_image, write_synthetic_hdr
from vk_gltf_renderer_tpu_torch.ops.jpeg import encode_jpeg
from torch_test_helpers import one_torch_thread, share_native_builder  # noqa: F401 (a fixture)

share_native_builder()

ROOT = Path(__file__).resolve().parent.parent
W, H, DEPTH, FRAMES = 48, 32, 5, 2


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The helmet stand-in with a JPEG base colour, under the synthetic HDR."""
    d = tmp_path_factory.mktemp("mesh")
    path = helmet_with_texture(str(d), encode_jpeg(texture_image(64, seed=4)), "base.jpg")
    return path, write_synthetic_hdr(d / "env.hdr", 64, 128)


def _renderer(scene, cls=GltfRenderer, **kw):
    path, hdr = scene
    r = cls(W, H, spp=1, max_depth=DEPTH, **kw)
    r.create_scene(path)
    r.create_hdr(hdr)
    return r


@pytest.fixture(scope="module")
def unsharded(scene):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = _renderer(scene, device="cpu")
        frames = [(r.on_render(), r.accum.clone()) for _ in range(FRAMES)]
    finally:
        torch.set_num_threads(n)
    return frames


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.usefixtures("one_torch_thread")
def test_render_mesh_equals_on_render_bit_for_bit(k, scene, unsharded):
    r = _renderer(scene, device="cpu")
    for frame, (aux_ref, accum_ref) in enumerate(unsharded):
        aux = render_mesh(r, ["cpu"] * k)
        assert torch.equal(r.accum, accum_ref), (k, frame, int((r.accum != accum_ref).any(1).sum()))
        assert float(aux["rays"]) == float(aux_ref["rays"]) > W * H
        assert sorted(aux) == sorted(aux_ref)
        for key in aux_ref:
            assert torch.equal(aux[key], aux_ref[key]), (k, frame, key)
    assert r.frame_idx == FRAMES and r.total_samples == FRAMES


@pytest.mark.usefixtures("one_torch_thread")
def test_render_mesh_agrees_with_the_jax_renderer(scene):
    ref = _renderer(scene, JaxRenderer)
    r = _renderer(scene, device="cpu")
    for frame in range(FRAMES):
        aux_r = ref.on_render()
        aux_p = render_mesh(r, ["cpu"] * 4)
        img_r, img_p = np.asarray(ref.image_linear()), r.image_linear()
        ids = ((aux_p["first_rnode"].numpy() == np.asarray(aux_r["first_rnode"]))
               & (aux_p["first_tri"].numpy() == np.asarray(aux_r["first_tri"])))
        assert ids.mean() >= 0.999, (frame, ids.mean())
        close = (np.abs(img_p - img_r) <= 1e-3 * (1.0 + np.abs(img_r))).all(axis=-1)
        assert close.mean() >= 0.99, (frame, close.mean())
        np.testing.assert_allclose(img_p.mean(axis=(0, 1)), img_r.mean(axis=(0, 1)), rtol=1e-3)
        assert float(aux_p["rays"]) == float(aux_r["rays"])


@pytest.mark.usefixtures("one_torch_thread")
def test_render_mesh_adaptive_calls_update_global(scene, monkeypatch):
    calls = []
    update = AdaptiveSampler.update_global

    def spy(self, rays, wall_ms):
        calls.append((rays, wall_ms))
        return update(self, rays, wall_ms)

    monkeypatch.setattr(AdaptiveSampler, "update_global", spy)
    r = _renderer(scene, device="cpu")
    r.adaptive = AdaptiveSampler(target_fps=10)
    for _ in range(3):
        aux = render_mesh(r, ["cpu"] * 2)
        assert r.spp == r.adaptive.spp in AdaptiveSampler.BUCKETS
    assert len(calls) == 3 and all(rays > 0 and ms > 0 for rays, ms in calls)
    assert calls[-1][0] == float(aux["rays"])


def test_row_shards_must_divide():
    assert row_shards(1080, 2) == [(0, 540), (540, 540)]
    assert row_shards(24, 8)[-1] == (21, 3)
    with pytest.raises(ValueError, match="divide"):
        row_shards(32, 3)


@pytest.mark.usefixtures("one_torch_thread")
def test_replicas_are_dropped_when_the_tables_change(scene):
    r = _renderer(scene, device="cpu")
    copy = r.dev_bvh.to("cpu")
    assert copy.refit is None and torch.equal(copy.nodes4_fi, r.dev_bvh.nodes4_fi)
    assert copy.stack_need == r.dev_bvh.stack_need and copy.stack_need is not r.dev_bvh.stack_need
    sc = r.dev_scene.to("cpu")
    assert torch.equal(sc.tex_quads, r.dev_scene.tex_quads) and sc.num_lights == r.dev_scene.num_lights
    for change in ("rebuild", "refit", "hdr"):
        r.replicas["stale"] = object()
        if change == "rebuild":
            r.rebuild_device_scene()
        elif change == "refit":
            r.scene.model.nodes[0].setdefault("translation", [0.0, 0.0, 0.0])[1] += 0.1
            from vk_gltf_renderer_tpu_torch.models.scene import DirtyFlags

            r.scene.mark_dirty(DirtyFlags.NODE_TRANSFORMS)
            assert r.sync_scene_changes()
        else:
            r.create_hdr(scene[1])
        assert r.replicas == {}, change


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_render_multihost(scene, tmp_path):
    path, hdr = scene
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vk_gltf_renderer_tpu_torch.parallel.multihost", "--rank", str(rank),
         "--world", "2", "--port", str(port), "--scene", path, "--hdr", hdr, "--size", "40", "24",
         "--depth", "3", "--backend", "gloo", "--device", "cpu"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        assert f"MULTIHOST_OK rank={rank} world=2 backend=gloo" in out, out[-4000:]
    assert "rows=[0]" in outs[0] and "rows=[12]" in outs[1]
