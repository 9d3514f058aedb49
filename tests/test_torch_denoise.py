"""Denoiser guides, denoising, temporal reprojection, TAA upscaling, the
selection outline and picking: the port's functions against the JAX
package's on the CPU, and the port's renderer against the JAX renderer.

Module functions take the same seeded numpy inputs: denoise within
1e-4 * (1 + |ref|) on every pixel (its 5 iterations chain 125 weighted taps
of pow/exp whose last ulp XLA and torch round differently);
spatial_variance, motion_vectors, temporal_accumulate and temporal_upscale
within 1e-5 * (1 + |ref|); halton23 and silhouette exactly;
_env_brdf_approx2 within 1e-6. The properties of tests/test_tools.py and
tests/test_upscale.py run on the port too.

Whole frames (48x32, depth 5, in-repo scenes) are held to
tests/test_torch_frame.py's thresholds: first-hit ids equal on >= 99.9% of
pixels, >= 99% of pixels within 1e-3 * (1 + |ref|) in every channel, each
channel's mean within 1e-3 relative, ray counts equal; the guides, the
luminance moments and the denoised, upscaled and outlined images at the
same per-pixel threshold. Picks are equal."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import baseline_standins  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from vk_gltf_renderer_tpu.models.editor import SceneEditor as JEditor  # noqa: E402
from vk_gltf_renderer_tpu.ops import denoise as jden  # noqa: E402
from vk_gltf_renderer_tpu.ops import pathtrace as jpt  # noqa: E402
from vk_gltf_renderer_tpu.ops import postfx as jpost  # noqa: E402
from vk_gltf_renderer_tpu.ops import temporal as jtemp  # noqa: E402
from vk_gltf_renderer_tpu.ops import upscale as jup  # noqa: E402
from vk_gltf_renderer_tpu.renderer import GltfRenderer as JaxRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch.models.editor import SceneEditor  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import denoise as tden  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import pathtrace as tpt  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import postfx as tpost  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import temporal as ttemp  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import upscale as tup  # noqa: E402
from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch.scenes import make_brainstem, write_synthetic_hdr  # noqa: E402
from vk_gltf_renderer_tpu_torch.utils import mathutil as mu  # noqa: E402
from torch_test_helpers import one_torch_thread, share_native_builder  # noqa: E402, F401 (a fixture)

share_native_builder()

W, H, DEPTH = 48, 32, 5


def _np(x):
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def _within(port, ref, tol):
    port, ref = _np(port).astype(np.float64), _np(ref).astype(np.float64)
    assert port.shape == ref.shape
    bad = np.abs(port - ref) > tol * (1.0 + np.abs(ref))
    assert not bad.any(), (int(bad.sum()), float(np.abs(port - ref).max()))


def _guides(seed, h=24, w=32):
    """Seeded radiance, albedo, normal, depth, valid and variance images."""
    rng = np.random.default_rng(seed)
    rad = rng.gamma(2.0, 0.3, (h, w, 3)).astype(np.float32)
    albedo = rng.uniform(0.05, 1.0, (h, w, 3)).astype(np.float32)
    normal = rng.normal(size=(h, w, 3)) + np.array([0.0, 0.0, 3.0])
    normal = (normal / np.linalg.norm(normal, axis=-1, keepdims=True)).astype(np.float32)
    depth = rng.uniform(1.0, 5.0, (h, w)).astype(np.float32)
    valid = rng.random((h, w)) > 0.15
    variance = rng.gamma(1.0, 0.05, (h, w)).astype(np.float32)
    return rad, albedo, normal, depth, valid, variance


# ------------------------------------------------------------ the functions


@pytest.mark.parametrize("case", ["fixed_sigma", "variance", "variance_floor"])
def test_denoise_matches_jax(case):
    rad, albedo, normal, depth, valid, variance = _guides(1)
    kw = {} if case == "fixed_sigma" else {"variance": variance}
    if case == "variance_floor":
        kw["sigma_floor"] = 4.0 * float(np.exp(-3 / 12.0))
    ref = jden.denoise(*map(jnp.asarray, (rad, albedo, normal, depth, valid)),
                       **{k: (jnp.asarray(v) if k == "variance" else v) for k, v in kw.items()})
    port = tden.denoise(*map(torch.from_numpy, (rad, albedo, normal, depth, valid)),
                        **{k: (torch.from_numpy(v) if k == "variance" else v) for k, v in kw.items()})
    _within(port, ref, 1e-4)
    # sky pixels pass through untouched
    np.testing.assert_array_equal(_np(port)[~valid], rad[~valid])


def test_spatial_variance_matches_jax():
    lum = np.random.default_rng(2).gamma(2.0, 0.3, (24, 32)).astype(np.float32)
    _within(tden.spatial_variance(torch.from_numpy(lum)), jden.spatial_variance(jnp.asarray(lum)), 1e-5)


def _view_projs():
    """Two perspective view-projections of a camera that moved a little."""
    proj = mu.perspective(np.radians(45.0), W / H, 0.01, 100.0)
    vps = [proj @ mu.look_at(np.array(eye), np.zeros(3), np.array([0.0, 1.0, 0.0]))
           for eye in ((0.3, 0.4, 4.0), (0.35, 0.38, 3.9))]
    return [vp.astype(np.float32) for vp in vps]


@pytest.mark.parametrize("with_prev", [False, True])
def test_motion_vectors_match_jax(with_prev):
    rng = np.random.default_rng(3)
    pos = rng.uniform(-1.0, 1.0, (H, W, 3)).astype(np.float32)
    solid = rng.random((H, W)) > 0.2
    prev = (pos + rng.normal(0.0, 0.05, pos.shape)).astype(np.float32) if with_prev else None
    prev_vp, cur_vp = _view_projs()
    ref = jtemp.motion_vectors(jnp.asarray(pos), jnp.asarray(solid), jnp.asarray(prev_vp), jnp.asarray(cur_vp),
                               W, H, first_pos_prev=None if prev is None else jnp.asarray(prev))
    port = ttemp.motion_vectors(torch.from_numpy(pos), torch.from_numpy(solid), torch.from_numpy(prev_vp),
                                torch.from_numpy(cur_vp), W, H,
                                first_pos_prev=None if prev is None else torch.from_numpy(prev))
    _within(port, ref, 1e-5)


def test_temporal_accumulate_matches_jax():
    rng = np.random.default_rng(4)
    cur = rng.gamma(2.0, 0.3, (H, W, 3)).astype(np.float32)
    hist = rng.gamma(2.0, 0.3, (H, W, 3)).astype(np.float32)
    motion = rng.normal(0.0, 3.0, (H, W, 2)).astype(np.float32)
    valid = rng.random((H, W)) > 0.1
    ref = jtemp.temporal_accumulate(*map(jnp.asarray, (cur, hist, motion, valid)))
    _within(ttemp.temporal_accumulate(*map(torch.from_numpy, (cur, hist, motion, valid))), ref, 1e-5)


@pytest.mark.parametrize("history", [False, True])
def test_temporal_upscale_matches_jax(history):
    rng = np.random.default_rng(5)
    cur = rng.gamma(2.0, 0.3, (16, 24, 3)).astype(np.float32)
    motion = rng.normal(0.0, 1.5, (16, 24, 2)).astype(np.float32)
    hist = None
    if history:
        hist = np.concatenate([rng.gamma(2.0, 0.3, (32, 48, 3)), rng.uniform(0.0, 30.0, (32, 48, 1))],
                              -1).astype(np.float32)
    jit = tup.halton23(5)
    ref = jup.temporal_upscale(jnp.asarray(cur), jnp.asarray(motion), jnp.asarray(jit),
                               None if hist is None else jnp.asarray(hist), 2)
    port = tup.temporal_upscale(torch.from_numpy(cur), torch.from_numpy(motion), jit,
                                None if hist is None else torch.from_numpy(hist), 2)
    assert tuple(port.shape) == (32, 48, 4)
    _within(port, ref, 1e-5)


def test_halton23_equals_jax():
    for i in range(64):
        np.testing.assert_array_equal(tup.halton23(i), jup.halton23(i))


def test_silhouette_equals_jax():
    rng = np.random.default_rng(6)
    oid = rng.integers(-1, 5, (H, W)).astype(np.int32)
    oid[8:20, 10:30] = 2
    mask = np.array([False, True, True, False, False])
    img = rng.random((H, W, 3)).astype(np.float32)
    ref = jpost.silhouette(jnp.asarray(oid), jnp.asarray(mask), jnp.asarray(img))
    port = tpost.silhouette(torch.from_numpy(oid), torch.from_numpy(mask), torch.from_numpy(img))
    np.testing.assert_array_equal(_np(port), _np(ref))


def test_env_brdf_approx2_matches_jax():
    rng = np.random.default_rng(7)
    spec = rng.uniform(0.0, 1.0, (4096, 3)).astype(np.float32)
    alpha = rng.uniform(0.0, 1.0, 4096).astype(np.float32)
    nov = rng.uniform(-1.0, 1.0, 4096).astype(np.float32)
    ref = jpt._env_brdf_approx2(jnp.asarray(spec), jnp.asarray(alpha), jnp.asarray(nov))
    port = tpt._env_brdf_approx2(torch.from_numpy(spec), torch.from_numpy(alpha), torch.from_numpy(nov))
    np.testing.assert_allclose(_np(port), _np(ref), rtol=0, atol=1e-6)


# ------------------------------------------------------------ properties (tests/test_tools.py, test_upscale.py)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_denoise_reduces_variance_preserves_mean():
    rng = np.random.default_rng(0)
    h = w = 32
    noisy = (np.full((h, w, 3), 0.5) + rng.normal(0, 0.2, (h, w, 3))).astype(np.float32)
    albedo = np.full((h, w, 3), 0.8, np.float32)
    normal = np.tile(np.array([0, 0, 1], np.float32), (h, w, 1))
    out = tden.denoise(*_t(noisy, albedo, normal, np.ones((h, w), np.float32), np.ones((h, w), bool))).numpy()
    assert out.var() < noisy.var() * 0.2
    assert abs(out.mean() - noisy.mean()) < 0.02


def test_denoise_preserves_edges():
    h = w = 32
    img = np.zeros((h, w, 3), np.float32)
    img[:, 16:] = 1.0
    normal = np.tile(np.array([0, 0, 1.0], np.float32), (h, w, 1))
    normal[:, 16:] = [1, 0, 0]  # the normal edge coincides with the color edge
    depth = np.ones((h, w), np.float32)
    depth[:, 16:] = 5.0
    out = tden.denoise(*_t(img, np.ones_like(img), normal, depth, np.ones((h, w), bool))).numpy()
    assert out[:, :14].mean() < 0.05 and out[:, 18:].mean() > 0.95


def test_silhouette_outline():
    oid = np.full((16, 16), -1, np.int32)
    oid[4:12, 4:12] = 0
    out = tpost.silhouette(*_t(oid, np.array([True]), np.zeros((16, 16, 3), np.float32))).numpy()
    assert out[4, 4].sum() > 0 and out[8, 8].sum() == 0 and out[0, 0].sum() == 0


def test_motion_vectors_static_camera_zero():
    pos = np.random.default_rng(0).normal(size=(8, 8, 3)).astype(np.float32)
    vp = np.eye(4, dtype=np.float32)
    mv = ttemp.motion_vectors(*_t(pos, np.ones((8, 8), bool), vp, vp), 8, 8)
    np.testing.assert_allclose(mv.numpy(), 0.0, atol=1e-4)


def test_temporal_accumulate_converges_and_rejects():
    rng = np.random.default_rng(1)
    clean = np.full((16, 16, 3), 0.5, np.float32)
    motion = np.zeros((16, 16, 2), np.float32)
    valid = np.ones((16, 16), bool)
    hist = clean + rng.normal(0, 0.01, clean.shape).astype(np.float32)
    cur = clean + rng.normal(0, 0.2, clean.shape).astype(np.float32)
    out = ttemp.temporal_accumulate(*_t(cur, hist, motion, valid)).numpy()
    assert np.abs(out - clean).mean() < np.abs(cur - clean).mean()
    out2 = ttemp.temporal_accumulate(*_t(cur, np.full_like(clean, 5.0), motion, valid)).numpy()
    assert np.abs(out2 - clean).mean() < 0.5  # the clamp rejected the stale history


def test_temporal_reprojection_shifts_history():
    h = w = 16
    hist = np.zeros((h, w, 3), np.float32)
    hist[:, 4] = 1.0
    cur = np.zeros((h, w, 3), np.float32)
    cur[:, 6] = 1.0
    motion = np.zeros((h, w, 2), np.float32)
    motion[..., 0] = -2.0  # the history sits 2 px left
    out = ttemp.temporal_accumulate(*_t(cur, hist, motion, np.ones((h, w), bool)), alpha=0.5).numpy()
    assert out[:, 6].mean() > 0.7 and out[:, 4].mean() < 0.2


def test_halton_sequence_properties():
    pts = np.array([tup.halton23(i) for i in range(64)])
    assert pts.shape == (64, 2) and (pts >= 0).all() and (pts < 1).all()
    assert len({(a, b) for a, b in (pts[:16] >= 0.5).astype(int)}) == 4


def _analytic(xs, ys):
    return np.stack([0.5 + 0.5 * np.sin(xs * 0.9) * np.cos(ys * 0.7), 0.5 + 0.5 * np.cos(xs * 0.5 + ys * 0.3),
                     0.5 + 0.5 * np.sin((xs + ys) * 0.4)], axis=-1).astype(np.float32)


def test_taau_converges_past_bilinear():
    h, w, scale = 24, 32, 2
    dy, dx = np.meshgrid(np.arange(h * scale), np.arange(w * scale), indexing="ij")
    truth = _analytic((dx + 0.5) / scale, (dy + 0.5) / scale)
    ly, lx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    motion = torch.zeros((h, w, 2))
    hist = None
    for f in range(24):
        j = tup.halton23(f)
        hist = tup.temporal_upscale(torch.from_numpy(_analytic(lx + j[0], ly + j[1])), motion, j, hist, scale)
    rmse_taau = float(np.sqrt(np.mean((hist[..., :3].numpy() - truth) ** 2)))
    base = tup.temporal_upscale(torch.from_numpy(_analytic(lx + 0.5, ly + 0.5)), motion,
                                np.float32([0.5, 0.5]), None, scale)
    rmse_bilinear = float(np.sqrt(np.mean((base[..., :3].numpy() - truth) ** 2)))
    assert rmse_taau < 0.6 * rmse_bilinear and rmse_taau < 0.02, (rmse_taau, rmse_bilinear)


@pytest.mark.parametrize("case", ["disocclusion", "stale"])
def test_taau_history_rejection(case):
    """History reprojected out of the frame falls back to the current
    frame; in-bounds stale history is clamped to the neighbourhood."""
    h, w, scale = 8, 8, 2
    value = 0.25 if case == "disocclusion" else 0.5
    cur = torch.full((h, w, 3), value)
    hist = torch.cat([torch.full((h * scale, w * scale, 3), 10.0 if case == "disocclusion" else 50.0),
                      torch.ones((h * scale, w * scale, 1))], -1)
    motion = torch.full((h, w, 2), 1e5 if case == "disocclusion" else 0.0)
    out = tup.temporal_upscale(cur, motion, np.float32([0.5, 0.5]), hist, scale)[..., :3].numpy()
    if case == "disocclusion":
        np.testing.assert_allclose(out, 0.25, atol=1e-5)
    else:
        assert float(out.max()) < 0.51


# ------------------------------------------------------------ the renderer


def _aux_np(aux):
    return {k: _np(v) for k, v in aux.items()}


def _assert_agree(tag, port, ref, w=W, h=H, ids=None):
    """tests/test_torch_frame.py's per-pixel threshold (>= 99% of pixels
    within 1e-3 * (1 + |ref|) in every channel) and its channel-mean one
    for an [H,W,C] or [H*W(,C)] image."""
    port = _np(port).astype(np.float64).reshape(h * w, -1)
    ref = _np(ref).astype(np.float64).reshape(h * w, -1)
    assert np.isfinite(port).all(), tag
    close = (np.abs(port - ref) <= 1e-3 * (1.0 + np.abs(ref))).all(axis=-1)
    assert close.mean() >= 0.99, (tag, close.mean())
    np.testing.assert_allclose(port.mean(axis=0), ref.mean(axis=0), rtol=1e-3, atol=1e-6, err_msg=tag)


def _assert_frame(tag, port, ref, rays=True):
    """A frame's image, first-hit ids and ray count."""
    (img_p, aux_p), (img_r, aux_r) = port, ref
    assert img_p.mean() > 0.01, f"{tag}: black frame"
    ids = (aux_p["first_rnode"] == aux_r["first_rnode"]) & (aux_p.get("first_tri", 0) == aux_r.get("first_tri", 0))
    assert ids.mean() >= 0.999, (tag, ids.mean())
    _assert_agree(tag, img_p, img_r)
    if rays:
        assert float(aux_p["rays"]) == float(aux_r["rays"]) > W * H


def _guided(r, path):
    r.denoise_guides = True
    r.create_scene(path)
    r.animate = True


@pytest.mark.usefixtures("one_torch_thread")
def test_guided_brainstem_frames_match_jax_renderer(tmp_path):
    """Three animated brainstem frames with the guides on: each frame's
    image, ids, guides and luminance moments, then image_denoised()
    (temporal: from the second frame on it reprojects the previous one)."""
    path = make_brainstem(str(tmp_path))
    out = {}
    for name, r in (("ref", JaxRenderer(W, H, spp=1, max_depth=DEPTH)),
                    ("port", GltfRenderer(W, H, spp=1, max_depth=DEPTH, device="cpu"))):
        _guided(r, path)
        frames = []
        for _ in range(3):
            aux = _aux_np(r.on_render())
            frames.append((np.array(r.image_linear()), aux, np.asarray(r.image_denoised(temporal=True))))
        out[name] = frames
    for f, ((img_p, aux_p, den_p), (img_r, aux_r, den_r)) in enumerate(zip(out["port"], out["ref"])):
        _assert_frame(f"frame {f}", (img_p, aux_p), (img_r, aux_r))
        for key in ("spec_albedo", "spec_hitdist", "first_pos_prev", "lum_moments"):
            _assert_agree(f"frame {f} {key}", aux_p[key], aux_r[key])
        _assert_agree(f"frame {f} denoised", den_p, den_r)
        hd = aux_p["spec_hitdist"]
        assert ((hd == 65504.0) | (hd < 1e4)).all() and (aux_p["spec_albedo"][~aux_p["solid"]] == 0).all()
        # the moments of one sample are (L, L^2) of the frame's radiance
        np.testing.assert_allclose(aux_p["lum_moments"][:, 1], aux_p["lum_moments"][:, 0] ** 2, rtol=1e-5)


@pytest.mark.usefixtures("one_torch_thread")
def test_guided_spp2_frames_match_jax_renderer(tmp_path):
    """The helmet under the HDR at spp 2, two static frames: the guides of
    sample 0, the luminance moments summed over both samples and, from the
    second frame on (4 samples), image_denoised on the accumulated moments'
    variance rather than the spatial fallback."""
    path = baseline_standins.make_helmet(str(tmp_path))
    hdr = write_synthetic_hdr(tmp_path / "env.hdr", 64, 128)
    out = {}
    for name, r in (("ref", JaxRenderer(W, H, spp=2, max_depth=DEPTH)),
                    ("port", GltfRenderer(W, H, spp=2, max_depth=DEPTH, device="cpu"))):
        r.denoise_guides = True
        r.create_scene(path)
        r.create_hdr(hdr)
        frames = []
        for _ in range(2):
            aux = _aux_np(r.on_render())
            frames.append((np.array(r.image_linear()), aux, np.asarray(r.image_denoised(temporal=False))))
        out[name] = frames
        assert r.total_samples == 4
    for f, ((img_p, aux_p, den_p), (img_r, aux_r, den_r)) in enumerate(zip(out["port"], out["ref"])):
        _assert_frame(f"frame {f}", (img_p, aux_p), (img_r, aux_r))
        for key in ("spec_albedo", "spec_hitdist", "first_pos_prev", "lum_moments"):
            _assert_agree(f"frame {f} {key}", aux_p[key], aux_r[key])
        _assert_agree(f"frame {f} denoised", den_p, den_r)
    # two samples' moments: E[L^2] >= E[L]^2 per pixel
    m = out["port"][0][1]["lum_moments"]
    assert (m[:, 1] * 2 >= m[:, 0] ** 2 * (1 - 1e-5)).all() and not np.array_equal(m[:, 1], m[:, 0] ** 2)


@pytest.mark.usefixtures("one_torch_thread")
def test_guides_leave_the_frame_unchanged(tmp_path):
    """The guides draw no random number and change no path: with them on,
    the image and every aux key the unguided frame has are bit for bit the
    unguided frame's."""
    path = baseline_standins.make_helmet(str(tmp_path))
    outs = []
    for guides in (False, True):
        r = GltfRenderer(W, H, spp=2, max_depth=DEPTH, device="cpu")
        r.denoise_guides = guides
        r.create_scene(path)
        aux = r.on_render()
        outs.append((r.accum.clone(), aux))
    (acc0, aux0), (acc1, aux1) = outs
    assert torch.equal(acc0, acc1)
    assert set(aux1) - set(aux0) == {"spec_albedo", "spec_hitdist", "first_pos_prev", "lum_moments"}
    assert all(torch.equal(aux0[k], aux1[k]) for k in aux0)


def _move_ball(editor_cls, r, by):
    ed = editor_cls(r.scene)
    nid = r.scene.render_nodes[0].ref_node_id
    t = list(r.scene.model.nodes[nid].get("translation", [0.0, 0.0, 0.0]))
    ed.set_translation(nid, [t[0] + by[0], t[1] + by[1], t[2] + by[2]])


@pytest.mark.usefixtures("one_torch_thread")
def test_moved_instance_first_pos_prev_matches_jax_renderer(tmp_path):
    """tests/test_render.py::test_instance_motion_vectors on the helmet
    stand-in: the sphere moves +0.3 in x through SceneEditor between two
    frames; on the pixels that hit it first_pos - first_pos_prev is the
    translation, and the guides agree with the JAX renderer's."""
    path = baseline_standins.make_helmet(str(tmp_path))
    out = {}
    for name, r, editor in (("ref", JaxRenderer(W, H, spp=1, max_depth=2), JEditor),
                            ("port", GltfRenderer(W, H, spp=1, max_depth=2, device="cpu"), SceneEditor)):
        r.denoise_guides = True
        r.create_scene(path)
        r.on_render()
        _move_ball(editor, r, (0.3, 0.0, 0.0))
        out[name] = _aux_np(r.on_render())
    port, ref = out["port"], out["ref"]
    ball = port["first_rnode"] == 0
    assert ball.sum() > 10
    d = port["first_pos"][ball] - port["first_pos_prev"][ball]
    np.testing.assert_allclose(d, np.broadcast_to([0.3, 0.0, 0.0], d.shape), atol=1e-3)
    plate = port["first_rnode"] == 1
    np.testing.assert_allclose(port["first_pos_prev"][plate], port["first_pos"][plate], atol=1e-5)
    for key in ("first_pos", "first_pos_prev"):
        _assert_agree(key, port[key], ref[key])


@pytest.mark.usefixtures("one_torch_thread")
def test_upscale_frames_match_jax_renderer(tmp_path):
    """upscale 2: four 24x16 frames at the Halton jitter, each folded into
    the 48x32 TAAU history; image_upscaled() after each frame."""
    path = baseline_standins.make_helmet(str(tmp_path))
    out = {}
    for name, r in (("ref", JaxRenderer(W // 2, H // 2, spp=1, max_depth=DEPTH)),
                    ("port", GltfRenderer(W // 2, H // 2, spp=1, max_depth=DEPTH, device="cpu"))):
        r.upscale = 2
        r.create_scene(path)
        frames = []
        for _ in range(4):
            r.on_render()
            assert r.total_samples == 0
            frames.append(np.asarray(r.image_upscaled()))
        out[name] = frames
    for f, (up_p, up_r) in enumerate(zip(out["port"], out["ref"])):
        assert up_p.shape == (H, W, 3) and up_p.mean() > 0.01
        _assert_agree(f"upscaled frame {f}", up_p, up_r)


def _selectable_helmet(tmp_path):
    """The helmet stand-in with its plate node marked unselectable
    (KHR_node_selectability)."""
    path = Path(baseline_standins.make_helmet(str(tmp_path)))
    g = json.loads(path.read_text())
    g["nodes"][1]["extensions"] = {"KHR_node_selectability": {"selectable": False}}
    g["extensionsUsed"] = g.get("extensionsUsed", []) + ["KHR_node_selectability"]
    out = path.with_name("helmet_select.gltf")
    out.write_text(json.dumps(g))
    return str(out)


@pytest.mark.usefixtures("one_torch_thread")
def test_pick_and_silhouette_match_jax_renderer(tmp_path):
    """pick() on a 4x4 pixel grid (the sphere, the unselectable plate
    giving -1, the sky) equals the JAX renderer's, and so does
    image_with_silhouette() with the sphere selected."""
    path = _selectable_helmet(tmp_path)
    rs = {"ref": JaxRenderer(W, H, spp=1, max_depth=2),
          "port": GltfRenderer(W, H, spp=1, max_depth=2, device="cpu")}
    for r in rs.values():
        r.create_scene(path)
        r.on_render()
        r.selection = {0}
    assert rs["port"].scene.model.nodes[1]["name"] == "plate"
    grid = [(x, y) for x in (12, 19, 23, 29) for y in (14, 16, 18, 25)]  # around the sphere
    picks = [rs["port"].pick(x, y) for x, y in grid]
    assert picks == [rs["ref"].pick(x, y) for x, y in grid]
    assert {0, -1} <= set(picks)
    # the plate is hit but not selectable
    aux = _aux_np(rs["port"]._last_aux)["first_rnode"].reshape(H, W)
    assert any(aux[y, x] == 1 and p == -1 for (x, y), p in zip(grid, picks))
    sil_p, sil_r = rs["port"].image_with_silhouette(), rs["ref"].image_with_silhouette()
    _assert_agree("silhouette", sil_p, sil_r)
    assert (np.abs(sil_p - rs["port"].image_tonemapped()).max(axis=-1) > 0).sum() > 10
