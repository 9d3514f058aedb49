"""Primary-hit seeding (VKGR_PRIMARY_SEED) and spp-batched frames
(VKGR_SPP_BATCH) on the port, against the JAX package on the CPU.

Seeding: _primary_seed_hits re-verifies a tris row against the current
triangle as the reference's does (tests/test_bvh.py's test is the model):
the traced hits' own rows, rows of triangles the rays miss, and -1. Seeded
frames equal unseeded ones but where two triangles tie at the seed's t,
before and after a node edit (the seed is re-verified, never invalidated),
and agree with the JAX package's seeded frames at the thresholds of
tests/test_torch_frame.py. A scene with a MASK or BLEND material leaves
seeding off.

Batching: the port's batched frame and aux (the non-compact branch of the
reference's _render_frame_spp_batched: sample block 0's first-hit aux,
lum_moments over every sample, rays over every lane) against the JAX
batched frame on the helmet stand-in (tests/test_spp_batch.py needs an
asset that is not in the repository); with frame["px"] the scan path is
taken, as in the reference."""

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
from vk_gltf_renderer_tpu.ops import pathtrace as jpt  # noqa: E402
from vk_gltf_renderer_tpu.ops.bvh_flatten import build_world_bvh  # noqa: E402
from vk_gltf_renderer_tpu.ops.flat import build_scene_flat  # noqa: E402
from vk_gltf_renderer_tpu.renderer import GltfRenderer as JaxRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch.convert import from_reference  # noqa: E402
from vk_gltf_renderer_tpu_torch.models.editor import SceneEditor  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import pathtrace as tpt  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops.intersect import intersect_rays_soa, soa_columns  # noqa: E402
from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch.scenes import make_masked_quads, write_synthetic_hdr  # noqa: E402
from test_torch_frame import _assert_frames_agree  # noqa: E402
from torch_test_helpers import one_torch_thread, share_native_builder  # noqa: E402, F401 (a fixture)

share_native_builder()

W, H, DEPTH = 48, 32, 5


@pytest.fixture(scope="module")
def helmet(tmp_path_factory):
    d = tmp_path_factory.mktemp("helmet")
    return baseline_standins.make_helmet(str(d)), write_synthetic_hdr(d / "env.hdr", 64, 128)


def test_primary_seed_hits_equal_the_reference(helmet):
    sc = Scene()
    sc.load(helmet[0])
    wb = build_world_bvh(build_scene_flat(sc))
    _, dev, _ = from_reference(None, wb, None, "cpu")
    rng = np.random.default_rng(5)
    n = 512
    lo, hi = wb.nodes_self[0, 0:3], wb.nodes_self[0, 3:6]
    c, r = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro, rd = (c + d * r).astype(np.float32), (-d).astype(np.float32)
    ro_t, rd_t = torch.tensor(ro), torch.tensor(rd)
    h = intersect_rays_soa(dev, *soa_columns(ro_t, rd_t), torch.zeros(n), torch.full((n,), 1e32))
    hit = (h["tri"] >= 0).numpy()
    assert hit.sum() > 100
    row = (np.asarray(wb.rn_attr_base)[np.maximum(h["rnode"].numpy(), 0)] + np.maximum(h["tri"].numpy(), 0))
    own = np.where(hit, np.asarray(wb.emit2ref)[np.clip(row, 0, wb.emit2ref.shape[0] - 1)], -1).astype(np.int32)
    garbage = rng.integers(0, wb.num_world_tris, n).astype(np.int32)
    garbage[::7] = -1
    for refs in (own, garbage):
        port = tpt._primary_seed_hits(dev, ro_t, rd_t, torch.tensor(refs))
        ref = jpt._primary_seed_hits(wb, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(refs))
        valid = np.asarray(ref[5])
        assert np.array_equal(port[5].numpy(), valid)
        for k in (1, 2):  # rnode, tri
            assert np.array_equal(port[k].numpy()[valid], np.asarray(ref[k])[valid])
        # XLA's CPU build contracts the products into FMAs, torch rounds each: t to 1e-5
        # relative, u and v (differences of nearly equal products) to 5e-5
        np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]), rtol=1e-5)
        for k in (3, 4):
            np.testing.assert_allclose(port[k].numpy()[valid], np.asarray(ref[k])[valid], atol=5e-5)
    # the traced hits re-derive themselves
    port = tpt._primary_seed_hits(dev, ro_t, rd_t, torch.tensor(own))
    assert np.array_equal(port[5].numpy(), hit)
    np.testing.assert_allclose(port[0].numpy()[hit], h["t"].numpy()[hit], rtol=1e-5)
    assert np.array_equal(port[2].numpy()[hit], h["tri"].numpy()[hit])


EDITS = {
    # node 0 moves: a device refit at the next on_render, the render nodes stay
    "move": lambda ed: ed.set_translation(0, [0.05, 0.02, 0.0]),
    # the plate, the highest render node, goes: a rebuild with one render node fewer, under
    # last frame's seeds that still name it
    "delete": lambda ed: ed.delete_node(1),
}


def _frames(r, path, hdr, n, edit_at=None, edit="move"):
    """n frames of a fresh scene; at frame edit_at, EDITS[edit] is applied
    first."""
    r.create_scene(path)
    r.create_hdr(hdr)
    out = []
    for i in range(n):
        if i == edit_at:
            EDITS[edit](SceneEditor(r.scene))
        aux = r.on_render()
        out.append((np.array(r.image_linear()), {k: np.asarray(v.cpu() if hasattr(v, "cpu") else v)
                                                 for k, v in aux.items()}))
    return out


def _assert_equal_but_ties(a, b):
    for (img_a, aux_a), (img_b, aux_b) in zip(a, b, strict=True):
        same = (aux_a["first_tri"] == aux_b["first_tri"]) & (aux_a["first_rnode"] == aux_b["first_rnode"])
        assert same.mean() >= 0.999
        assert np.array_equal(img_a.reshape(-1, 3)[same.reshape(-1)], img_b.reshape(-1, 3)[same.reshape(-1)])


@pytest.mark.usefixtures("one_torch_thread")
def test_seeded_frames_equal_unseeded_and_the_jax_seeded_frames(helmet, monkeypatch):
    path, hdr = helmet
    plain = _frames(GltfRenderer(W, H, spp=1, max_depth=DEPTH, device="cpu"), path, hdr, 4)
    monkeypatch.setenv("VKGR_PRIMARY_SEED", "1")
    r = GltfRenderer(W, H, spp=1, max_depth=DEPTH, device="cpu")
    seeded = _frames(r, path, hdr, 4)
    assert r._config().primary_seed and r.dev_bvh.tris is not None and r._prev_first is not None
    _assert_equal_but_ties(plain, seeded)
    jax_seeded = _frames(JaxRenderer(W, H, spp=1, max_depth=DEPTH), path, hdr, 4)
    _assert_frames_agree(jax_seeded, seeded)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("edit", sorted(EDITS))
def test_seeded_frames_after_a_node_edit(helmet, edit, monkeypatch):
    """An edit changes the triangles under last frame's seeds: a refit moves
    them, a deletion takes a render node away (its stale rnode lies past the
    new rn_attr_base and is clamped, as the reference's gather clamps). The
    seeds are re-verified against the current rows, and the frames stay the
    unseeded ones."""
    path, hdr = helmet
    out = []
    for seed in ("0", "1"):
        monkeypatch.setenv("VKGR_PRIMARY_SEED", seed)
        r = GltfRenderer(W, H, spp=1, max_depth=DEPTH, device="cpu")
        out.append(_frames(r, path, hdr, 4, edit_at=2, edit=edit))
    if edit == "delete":
        assert (out[1][1][1]["first_rnode"] == 1).any()  # the seeds of frame 2 name the deleted node
        assert r.dev_bvh.rn_attr_base.shape[0] == 1 and (out[1][3][1]["first_rnode"] <= 0).all()
    _assert_equal_but_ties(*out)


def test_alpha_scenes_leave_seeding_off(tmp_path, monkeypatch):
    monkeypatch.setenv("VKGR_PRIMARY_SEED", "1")
    r = GltfRenderer(16, 8, spp=1, max_depth=2, device="cpu")
    r.create_scene(make_masked_quads(str(tmp_path)))
    cfg = r._config()
    assert cfg.alpha_any and not cfg.primary_seed
    r.on_render()
    assert "prev_first_rnode" not in r._frame_inputs(cfg)
    monkeypatch.setenv("VKGR_PRIMARY_SEED", "0")
    r2 = GltfRenderer(16, 8, spp=1, max_depth=2, device="cpu")
    r2.create_scene(baseline_standins.make_helmet(str(tmp_path)))
    assert not r2._config().primary_seed
    monkeypatch.setenv("VKGR_PRIMARY_SEED", "1")
    assert r2._config().primary_seed
    # a pixel-count change restarts the seeds at -1
    r2.on_render()
    r2.on_render()
    r2.width, r2.height = 8, 8
    fr = r2._frame_inputs(r2._config())
    assert fr["prev_first_rnode"].shape == (64,) and (fr["prev_first_rnode"] == -1).all()


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("guides", [False, True])
def test_batched_frames_match_the_jax_batched_frames(helmet, guides, monkeypatch):
    path, hdr = helmet
    monkeypatch.setenv("VKGR_SPP_BATCH", "1")
    out = []
    for cls, kw in ((JaxRenderer, {}), (GltfRenderer, {"device": "cpu"})):
        r = cls(W, H, spp=4, max_depth=DEPTH, **kw)
        r.denoise_guides = guides
        out.append(_frames(r, path, hdr, 2))
    ref, port = out
    _assert_frames_agree(ref, port)
    for (_, aux_r), (_, aux_p) in zip(ref, port, strict=True):
        assert set(aux_p) == set(aux_r) - {"rays"} | {"rays"}
        for k in ("albedo", "normal", "first_pos") + (("spec_albedo", "lum_moments", "spec_hitdist") if guides else ()):
            close = np.isclose(aux_p[k], aux_r[k], rtol=1e-3, atol=1e-3)
            assert close.mean() >= 0.99, k


@pytest.mark.usefixtures("one_torch_thread")
def test_batched_frame_differs_from_the_scan_and_shards_take_the_scan(helmet):
    path, hdr = helmet
    r = GltfRenderer(W, H, spp=4, max_depth=DEPTH, device="cpu")
    r.create_scene(path)
    r.create_hdr(hdr)
    cfg = r._config()
    frame = r._frame_inputs(cfg)
    batched_cfg = tpt.RenderConfig(**{**cfg.__dict__, "spp_batch": True})
    scan, aux_s = tpt.render_frame_flat(r.dev_scene, r.dev_bvh, r._env(), frame, cfg)
    batched, aux_b = tpt.render_frame_flat(r.dev_scene, r.dev_bvh, r._env(), frame, batched_cfg)
    assert not torch.equal(scan, batched)  # other sample streams
    np.testing.assert_allclose(batched.mean(0).numpy(), scan.mean(0).numpy(), rtol=0.05)
    assert torch.equal(aux_s["first_tri"], aux_b["first_tri"]) or (aux_s["first_tri"] == aux_b["first_tri"]).float().mean() > 0.95
    # with px / py (a shard) the batched config renders the scan path
    rows = torch.arange(4, 9)
    px = torch.arange(W).repeat(rows.numel())
    py = rows.repeat_interleave(W)
    shard = dict(frame, px=px, py=py, accum=torch.zeros(px.numel(), 3))
    a, _ = tpt.render_frame_flat(r.dev_scene, r.dev_bvh, r._env(), shard, cfg)
    b, _ = tpt.render_frame_flat(r.dev_scene, r.dev_bvh, r._env(), shard, batched_cfg)
    assert torch.equal(a, b) and not torch.equal(b, batched.reshape(H, W, 3)[4:9].reshape(-1, 3))
