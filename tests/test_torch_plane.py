"""The infinite plane, its shadow catcher and depth of field in the port
against the JAX package, on the CPU: whole frames of the helmet stand-in
under the HDR with the plane (catcher off and on), the foliage stand-in
with the catcher (its shadow rays take the alpha march), a depth-of-field
frame, and `headless --infinitePlane 1 --infinitePlaneShadowCatcher 1
--device cpu` against the reference's headless run; the renderer's plane
attributes reach RenderConfig as the reference's do, and the settings
store keeps the plane flags.

Frames agree at tests/test_torch_frame.py's thresholds (ids on >= 99.9%
of pixels, >= 99% of pixels within 1e-3 * (1 + |ref|), channel means
within 1e-3 relative, ray counts equal); the headless PNGs at their 8-bit
form (tests/test_torch_frontends.py: >= 99% of pixels within one code
value, channel means within 0.5)."""

import numpy as np
import pytest

from vk_gltf_renderer_tpu import headless as jheadless  # noqa: E402
from vk_gltf_renderer_tpu.renderer import GltfRenderer as JaxRenderer  # noqa: E402
from vk_gltf_renderer_tpu.utils import settings as jsettings  # noqa: E402
from vk_gltf_renderer_tpu_torch import headless  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import pathtrace as tpt  # noqa: E402
from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch.scenes import (make_foliage_standin, make_helmet_standin,  # noqa: E402
                                                write_synthetic_hdr)
from vk_gltf_renderer_tpu_torch.utils import settings  # noqa: E402
from vk_gltf_renderer_tpu_torch.utils.png import read_png  # noqa: E402
from test_torch_frame import _assert_frames_agree, _render  # noqa: E402
from test_torch_frontends import _run  # noqa: E402
from torch_test_helpers import one_torch_thread, share_native_builder  # noqa: E402, F401 (a fixture)

share_native_builder()

W, H, DEPTH = 48, 32, 5
PLANE_Y = -1.05  # between the helmet stand-in's plate (y = -1.1) and its sphere


def _both(scene, hdr, setup):
    """test_torch_frame._render of both renderers, each set up by setup(renderer)
    before the scene loads; returns (the reference's, the port's, the port's
    renderer)."""
    out = []
    for r in (JaxRenderer(W, H, spp=1, max_depth=DEPTH), GltfRenderer(W, H, spp=1, max_depth=DEPTH, device="cpu")):
        setup(r)
        out.append(_render(r, scene, hdr))
    return out[0], out[1], r


def _plane(height, catcher, darken=0.0):
    def setup(r):
        r.use_infinite_plane = True
        r.plane_height = height
        r.plane_shadow_catcher = catcher
        r.shadow_catcher_darken = darken
    return setup


@pytest.mark.parametrize("catcher", [False, True])
@pytest.mark.usefixtures("one_torch_thread")
def test_plane_frames_match_jax_renderer(catcher, tmp_path):
    """The helmet stand-in under the HDR above the plane y = -1.05: a
    default PBR plane (catcher off), or an invisible one that shows the
    environment darkened where occluded (catcher on)."""
    scene = make_helmet_standin(str(tmp_path))
    hdr = write_synthetic_hdr(tmp_path / "env.hdr", 64, 128)
    ref, port, r = _both(scene, hdr, _plane(PLANE_Y, catcher))
    cfg = r._config()
    assert cfg.use_infinite_plane and cfg.plane_shadow_catcher == catcher and cfg.plane_height == PLANE_Y
    _assert_frames_agree(ref, port)
    plain = GltfRenderer(W, H, spp=1, max_depth=DEPTH, device="cpu")
    plain.create_scene(scene)
    plain.create_hdr(hdr)
    plain.on_render()
    assert np.abs(plain.image_linear() - port[0][0]).max() > 0.05  # the plane changed the frame


@pytest.mark.usefixtures("one_torch_thread")
def test_catcher_on_an_alpha_scene_matches_jax_renderer(tmp_path):
    """The foliage stand-in (64 cards) with the catcher at y = 0.5 and
    darkening 0.5 under the sky: the shadow rays take the alpha march,
    which the reference runs on every lane, so the catcher darkens plane
    lanes without a next event too (a light sample below the plane meets
    the ground)."""
    scene = make_foliage_standin(str(tmp_path), cards=64)
    ref, port, r = _both(scene, None, _plane(0.5, True, darken=0.5))
    assert r._config().alpha_any and tpt._marches(r._config())
    _assert_frames_agree(ref, port)


@pytest.mark.usefixtures("one_torch_thread")
def test_depth_of_field_frame_matches_jax_renderer(tmp_path):
    """A thin-lens frame (aperture 0.05, focal distance from the camera to
    its target) of the helmet stand-in under the HDR: the lens samples
    after the AA jitter, in the reference's order."""
    def setup(r):
        r.aperture = 0.05

    scene = make_helmet_standin(str(tmp_path))
    hdr = write_synthetic_hdr(tmp_path / "env.hdr", 64, 128)
    ref, port, r = _both(scene, hdr, setup)
    assert r._config().aperture == 0.05 and r._config().focal_distance > 0
    _assert_frames_agree(ref, port)


def test_plane_fields_reach_render_config_as_the_reference():
    """The renderer's plane attributes give the reference's RenderConfig
    plane fields, and the material defaults are the reference's."""
    port, ref = GltfRenderer(8, 8, device="cpu"), JaxRenderer(8, 8)
    for r in (port, ref):
        r.use_infinite_plane, r.plane_height, r.plane_shadow_catcher = True, 0.25, True
        r.shadow_catcher_darken = 0.3
        r.camera = None
    fields = ("use_infinite_plane", "plane_height", "plane_shadow_catcher", "plane_base_color", "plane_metallic",
              "plane_roughness", "shadow_catcher_darken")
    port.scene.parse_scene()
    cfg_p = port._config()
    from vk_gltf_renderer_tpu.ops import pathtrace as jpt

    cfg_r = jpt.RenderConfig(use_infinite_plane=True, plane_height=0.25, plane_shadow_catcher=True,
                             shadow_catcher_darken=0.3)
    assert {f: getattr(cfg_p, f) for f in fields} == {f: getattr(cfg_r, f) for f in fields}


@pytest.mark.usefixtures("one_torch_thread")
def test_headless_infinite_plane_matches_jax_headless(tmp_path, capsys, monkeypatch):
    """--infinitePlane 1 --infinitePlaneDistance -1.05
    --infinitePlaneShadowCatcher 1 on the helmet stand-in under the HDR:
    the record and the PNG against the reference's headless run, and the
    port's settings store keeps the three flags for the next run."""
    monkeypatch.setenv("VKGR_SETTINGS", str(tmp_path / "settings.json"))
    scene = make_helmet_standin(str(tmp_path))
    hdr = write_synthetic_hdr(tmp_path / "env.hdr", 64, 128)
    argv = ["--headless", "--scenefile", scene, "--hdrfile", hdr, "--envSystem", "1", "--size", str(W), str(H),
            "--frames", "3", "--ptDepth", str(DEPTH), "--infinitePlane", "1", "--infinitePlaneDistance",
            str(PLANE_Y), "--infinitePlaneShadowCatcher", "1"]
    _, ref = _run(jheadless.main, argv + ["--output", str(tmp_path / "ref.png")], capsys)
    (tmp_path / "settings.json").unlink()
    _, rec = _run(headless.main, argv + ["--output", str(tmp_path / "port.png"), "--device", "cpu"], capsys)
    assert rec.keys() == ref.keys()
    for k in ("frames", "spp", "triangles", "width", "height", "max_depth", "env", "renderer"):
        assert rec[k] == ref[k], k
    img_r = read_png((tmp_path / "ref.png").read_bytes()).astype(np.int32)
    img_p = read_png((tmp_path / "port.png").read_bytes()).astype(np.int32)
    assert img_p.shape == img_r.shape == (H, W, 3) and img_p.mean() > 2
    close = (np.abs(img_p - img_r) <= 1).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(img_p.mean(axis=(0, 1)), img_r.mean(axis=(0, 1)), atol=0.5)
    saved = settings.load_settings()["flags"]
    assert (saved["infinitePlane"], saved["infinitePlaneDistance"], saved["infinitePlaneShadowCatcher"]) == (
        1, PLANE_Y, 1)
    assert settings.PERSISTED == jsettings.PERSISTED
    args = headless.build_parser().parse_args(["--scenefile", scene])
    settings.apply_saved_settings(args, ["--scenefile", scene])
    assert (args.infinitePlane, args.infinitePlaneDistance, args.infinitePlaneShadowCatcher) == (1, PLANE_Y, 1)
