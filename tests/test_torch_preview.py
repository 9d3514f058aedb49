"""The preview renderer (render_system 1) and its IBL prefilter: the port
against the JAX package on the CPU.

build_ibl: under the sky every product within 1e-4 * (1 + |ref|). Under
the HDR the irradiance and the BRDF LUT are too; the glossy chain is
within it on >= 96% of its texels and on every level's mean: its level-0
texel centres (and many of its GGX sample directions) fall exactly on
texel edges of the 64x128 sampling map, where a last-ulp difference of
atan2 / acos between XLA and torch picks the neighbouring texel (3% of
those lookups on the synthetic sky). The preview's shading is held apart
from the prefilter by handing it the JAX products (convert.ibl_to_device):
then >= 99.9% of pixels within 1e-4 * (1 + |ref|).

Whole preview frames through the renderers (48x32): the helmet stand-in
under the sky and the HDR, with and without the wireframe overlay, the
materials stand-in (its transmission spheres take the continuation
trace) and the foliage stand-in (its BLEND panes composite over the next
surface), at tests/test_torch_frame.py's thresholds: first-hit ids equal
on >= 99.9% of pixels, >= 99% of pixels within 1e-3 * (1 + |ref|), each
channel's mean within 1e-3 relative, ray counts equal. The properties of
tests/test_preview.py (which needs the absent Box.glb) run on the port
with scenes built in the test."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import baseline_standins  # noqa: E402
from vk_gltf_renderer_tpu.ops import hdr as jhdr  # noqa: E402
from vk_gltf_renderer_tpu.ops import ibl as jibl  # noqa: E402
from vk_gltf_renderer_tpu.ops.preview import make_preview_fn  # noqa: E402
from vk_gltf_renderer_tpu.ops.sky import SkyParams as JSkyParams  # noqa: E402
from vk_gltf_renderer_tpu.renderer import GltfRenderer as JaxRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch.convert import env_to_device, ibl_to_device  # noqa: E402
from vk_gltf_renderer_tpu_torch.models.editor import SceneEditor  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import ibl as tibl  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops.preview import render_preview  # noqa: E402
from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer, fit_camera  # noqa: E402
from vk_gltf_renderer_tpu_torch.scenes import (_empty_scene, make_foliage_standin,  # noqa: E402
                                                make_materials_standin, write_synthetic_hdr)
from torch_test_helpers import one_torch_thread, share_native_builder  # noqa: E402, F401 (a fixture)

share_native_builder()

W, H = 48, 32


def _np(x):
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def _close(port, ref, tol):
    port, ref = _np(port).astype(np.float64), _np(ref).astype(np.float64)
    assert port.shape == ref.shape
    return np.abs(port - ref) <= tol * (1.0 + np.abs(ref))


@pytest.mark.parametrize("env_kind", ["sky", "hdr"])
def test_build_ibl_matches_jax(env_kind, tmp_path):
    if env_kind == "sky":
        env = JSkyParams().as_arrays()
    else:
        env = jhdr.load_hdr_environment(write_synthetic_hdr(tmp_path / "env.hdr", 64, 128))
    ref = jibl.build_ibl(env, env_kind)
    port = tibl.build_ibl(env_to_device({k: np.asarray(v) for k, v in env.items()}, "cpu"), env_kind)
    assert {k: tuple(v.shape) for k, v in port.items()} == {
        "irr": (16, 32, 3), "spec": (5, 32, 64, 3), "brdf": (32, 32, 2)}
    for key in ("irr", "brdf") if env_kind == "hdr" else ("irr", "spec", "brdf"):
        assert _close(port[key], ref[key], 1e-4).all(), key
    if env_kind == "hdr":
        assert _close(port["spec"], ref["spec"], 1e-4).mean() >= 0.96
        for level in range(5):
            np.testing.assert_allclose(_np(port["spec"][level]).mean(), _np(ref["spec"][level]).mean(),
                                       rtol=1e-4)


def _pair(tmp_path, scene, env, render_system=1, wireframe=False):
    """The JAX and the port's renderer (48x32) on the same scene."""
    out = []
    for r in (JaxRenderer(W, H, spp=1, max_depth=2, render_system=render_system),
              GltfRenderer(W, H, spp=1, max_depth=2, device="cpu", render_system=render_system)):
        r.wireframe = wireframe
        r.create_scene(scene)
        if env == "hdr":
            r.create_hdr(str(tmp_path / "env.hdr"))
        out.append(r)
    return out


def _scene(name, tmp_path):
    write_synthetic_hdr(tmp_path / "env.hdr", 64, 128)
    if name == "materials":
        return make_materials_standin(str(tmp_path))
    if name == "foliage":
        return make_foliage_standin(str(tmp_path), cards=64)
    return baseline_standins.make_helmet(str(tmp_path))


@pytest.mark.parametrize("ibl", [True, False])
@pytest.mark.usefixtures("one_torch_thread")
def test_render_preview_with_the_reference_ibl_matches_jax(ibl, tmp_path):
    """ops/preview.render_preview on the port's tables with the JAX
    renderer's IBL products (or none: the hemisphere fallback) against the
    JAX preview of the same frame, helmet under the HDR."""
    ref_r, port_r = _pair(tmp_path, _scene("helmet", tmp_path), "hdr")
    frame_j = ref_r._frame_inputs()
    frame_t = port_r._frame_inputs()
    if ibl:
        frame_j["ibl"] = ref_r._ensure_ibl()
        frame_t["ibl"] = ibl_to_device({k: np.asarray(v) for k, v in frame_j["ibl"].items()}, "cpu")
    rgb_r, aux_r = make_preview_fn(ref_r._config())(ref_r.flat, ref_r.bvh, ref_r._env_arrays(), frame_j)
    rgb_p, aux_p = render_preview(port_r.dev_scene, port_r.dev_bvh, port_r._env(), frame_t, port_r._config())
    assert _close(rgb_p, rgb_r, 1e-4).all(axis=-1).mean() >= 0.999
    np.testing.assert_array_equal(_np(aux_p["first_rnode"]), _np(aux_r["first_rnode"]))
    assert float(aux_p["rays"]) == float(aux_r["rays"]) > W * H


CASES = {"helmet_sky": ("helmet", "sky", False), "helmet_hdr": ("helmet", "hdr", False),
         "wireframe_sky": ("helmet", "sky", True), "wireframe_hdr": ("helmet", "hdr", True),
         "materials": ("materials", "sky", False), "foliage": ("foliage", "hdr", False)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.usefixtures("one_torch_thread")
def test_preview_frames_match_jax_renderer(case, tmp_path):
    """Two preview frames through on_render: each replaces the
    accumulation, and each agrees with the JAX renderer's."""
    scene, env, wire = CASES[case]
    rs = _pair(tmp_path, _scene(scene, tmp_path), env, wireframe=wire)
    if scene == "materials":
        assert "transmission" in rs[1]._config().features
    if scene == "foliage":
        assert rs[1]._config().alpha_any
    for f in range(2):
        aux_r, aux_p = (r.on_render() for r in rs)
        img_r, img_p = np.array(rs[0].image_linear()), rs[1].image_linear()
        assert img_p.shape == (H, W, 3) and np.isfinite(img_p).all() and img_p.mean() > 0.01
        ids = _np(aux_p["first_rnode"]) == _np(aux_r["first_rnode"])
        assert ids.mean() >= 0.999, (f, ids.mean())
        assert _close(img_p, img_r, 1e-3).all(axis=-1).mean() >= 0.99, f
        np.testing.assert_allclose(img_p.mean(axis=(0, 1)), img_r.mean(axis=(0, 1)), rtol=1e-3)
        assert float(aux_p["rays"]) == float(aux_r["rays"]) > W * H
        assert rs[1].total_samples == f + 1
    # the frames do not accumulate: the image is the last frame's
    frame = rs[1]._frame_inputs()
    frame["ibl"] = rs[1]._ensure_ibl()
    rgb, _ = render_preview(rs[1].dev_scene, rs[1].dev_bvh, rs[1]._env(), frame, rs[1]._config())
    assert torch.equal(rgb.reshape(H, W, 3), rs[1].accum.reshape(H, W, 3))


# ------------------------------------------------------------ properties (tests/test_preview.py)


def _two_planes(front_material: dict, extension=None):
    """A small front square before a big red back wall, both facing +Z."""
    sc = _empty_scene()
    ed = SceneEditor(sc)
    front = ed.add_primitive("plane")
    back = ed.add_primitive("plane")
    half = float(np.sin(np.pi / 4))
    for nid in (front, back):
        ed.set_rotation(nid, [half, 0.0, 0.0, float(np.cos(np.pi / 4))])
    ed.set_translation(front, [0.0, 0.0, 1.0])
    ed.set_scale(front, [0.6, 0.6, 0.6])
    ed.set_translation(back, [0.0, 0.0, -1.0])
    ed.set_scale(back, [4.0, 4.0, 4.0])
    m_front = len(sc.model.materials)  # after the planes' default material
    sc.model.materials.append(front_material)
    sc.model.materials.append(_material([1.0, 0.0, 0.0, 1.0], 1.0))
    ed.set_material(front, 0, m_front)
    ed.set_material(back, 0, m_front + 1)
    if extension:
        sc.model.gltf.setdefault("extensionsUsed", []).append(extension)
    sc.parse_scene()
    return sc


def _preview(sc, wireframe=False):
    r = GltfRenderer(48, 48, spp=1, max_depth=2, device="cpu", render_system=1)
    r.scene = sc
    cam = fit_camera(sc)
    cam.eye, cam.center = np.array([0.0, 0.0, 6.0]), np.zeros(3)
    r.camera = cam
    r.wireframe = wireframe
    r.rebuild_device_scene()
    r.on_render()
    return r.image_linear()


def _material(color, rough, **extra):
    return {"pbrMetallicRoughness": {"baseColorFactor": color, "roughnessFactor": rough, "metallicFactor": 0.0},
            **extra}


@pytest.mark.usefixtures("one_torch_thread")
def test_preview_transmission_shows_surface_behind():
    glass = _material([1.0, 1.0, 1.0, 1.0], 0.05,
                      extensions={"KHR_materials_transmission": {"transmissionFactor": 1.0}})
    c_g = _preview(_two_planes(glass, "KHR_materials_transmission"))[20:28, 20:28].mean(axis=(0, 1))
    c_o = _preview(_two_planes(_material([1.0, 1.0, 1.0, 1.0], 0.05)))[20:28, 20:28].mean(axis=(0, 1))
    assert c_g[0] > c_g[1] * 1.5 and c_g[0] > c_g[2] * 1.5  # the red wall through the glass
    assert abs(c_o[1] - c_o[2]) < 0.25 * max(c_o[1], c_o[2], 1e-3)


@pytest.mark.usefixtures("one_torch_thread")
def test_preview_blend_composites_over_background():
    img = _preview(_two_planes(_material([0.0, 0.0, 1.0, 0.3], 1.0, alphaMode="BLEND")))
    img2 = _preview(_two_planes(_material([0.0, 0.0, 1.0, 1.0], 1.0)))
    c, c2 = img[20:28, 20:28].mean(axis=(0, 1)), img2[20:28, 20:28].mean(axis=(0, 1))
    assert np.isfinite(img).all() and c[0] > 0.05 and c[0] > c2[0] + 0.02


@pytest.mark.usefixtures("one_torch_thread")
def test_preview_wireframe_darkens_edges():
    opaque = _material([1.0, 1.0, 1.0, 1.0], 1.0)
    plain, wire = _preview(_two_planes(opaque)), _preview(_two_planes(opaque), wireframe=True)
    assert np.isfinite(wire).all() and (wire <= plain + 1e-5).all()
    changed = (np.abs(wire - plain).max(axis=-1) > 1e-3).mean()
    assert 0.001 < changed < 0.6
