"""The port's viewer-side modules and front ends against the JAX package's,
on the CPU: the grid and gizmo overlays (torch on the frame's device)
against the reference's numpy within 1e-5, inspect_cli's printouts,
EditShell scripts (printed lines, saved glTF) and its render, a scripted
TerminalViewer (status line, tree pane, the local verbs' output, tab
completion, frame_u8), and the adaptive sampler. Then what the port adds:
its front ends default to the card, and the three catches that keep a
shell alive on bad input let every error of the renderer through.

Frames agree at the 8-bit form of tests/test_torch_frame.py's thresholds
(as tests/test_torch_frontends.py holds headless PNGs): >= 99% of pixels
within 1 code value in every channel, and each channel's mean within 0.5
code values."""

import contextlib
import io
import types

import numpy as np
import pytest
import torch

from vk_gltf_renderer_tpu import edit_cli as jedit
from vk_gltf_renderer_tpu import inspect_cli as jinspect
from vk_gltf_renderer_tpu import viewer as jviewer
from vk_gltf_renderer_tpu.gizmo import Mode as JMode
from vk_gltf_renderer_tpu.models import Scene as JScene
from vk_gltf_renderer_tpu.ops import gizmo_draw as jdraw
from vk_gltf_renderer_tpu.ops import grid as jgrid
from vk_gltf_renderer_tpu.renderer import AdaptiveSampler as JSampler
from vk_gltf_renderer_tpu_torch import edit_cli, inspect_cli, viewer
from vk_gltf_renderer_tpu_torch import renderer as trenderer
from vk_gltf_renderer_tpu_torch.gizmo import Mode
from vk_gltf_renderer_tpu_torch.models import Scene
from vk_gltf_renderer_tpu_torch.ops import gizmo_draw, grid
from vk_gltf_renderer_tpu_torch.renderer import AdaptiveSampler, GltfRenderer
from vk_gltf_renderer_tpu_torch.scenes import make_brainstem, make_helmet_standin, write_synthetic_hdr
from vk_gltf_renderer_tpu_torch.utils.png import read_png
from torch_test_helpers import one_torch_thread, share_native_builder  # noqa: F401 (a fixture)

share_native_builder()

H, W = 48, 64  # the overlays' image


def _image():
    return np.random.default_rng(5).random((H, W, 3)).astype(np.float32)


# camera label -> (eye, center, yfov); "above" looks over the horizon (no plane hit)
GRID_CAMERAS = {"down": ((0.0, 2.0, 5.0), (0.0, 0.0, 0.0), 0.8),
                "oblique": ((3.0, 1.5, -4.0), (0.2, 0.1, 0.3), 1.0),
                "above": ((0.0, 2.0, 5.0), (0.0, 50.0, 0.0), 0.4)}


@pytest.mark.parametrize("depth", [False, True])
@pytest.mark.parametrize("camera", sorted(GRID_CAMERAS))
def test_grid_overlay_matches_the_original(camera, depth):
    eye, center, yfov = (np.asarray(v, np.float64) if isinstance(v, tuple) else v for v in GRID_CAMERAS[camera])
    img = _image()
    scene_depth = None
    if depth:
        rng = np.random.default_rng(9)
        scene_depth = rng.random((H, W)) * 8.0
        scene_depth[rng.random((H, W)) < 0.3] = np.inf
    up = np.array([0.0, 1.0, 0.0])
    ref = jgrid.grid_overlay(img, eye, center, up, yfov, scene_depth=scene_depth)
    port = grid.grid_overlay(torch.tensor(img), eye, center, up, yfov,
                             scene_depth=None if scene_depth is None else torch.tensor(scene_depth.reshape(-1)))
    assert port.dtype == torch.float32 and port.shape == (H, W, 3)
    assert np.abs(port.numpy() - ref).max() <= 1e-5
    assert (np.abs(ref - img).max() > 0.05) == (camera != "above")


# label -> (mode, active handle, pivot); "behind" puts the pivot behind the camera
GIZMO_CASES = {
    "translate": ("translate", None, (0.1, 0.2, -0.1)),
    "translate_active_plane": ("translate", 3, (0.1, 0.2, -0.1)),
    "rotate": ("rotate", None, (0.1, 0.2, -0.1)),
    "rotate_active_ring": ("rotate", 7, (0.1, 0.2, -0.1)),
    "scale": ("scale", None, (0.1, 0.2, -0.1)),
    "scale_active_uniform": ("scale", 9, (0.1, 0.2, -0.1)),
    "behind": ("translate", 0, (4.0, 3.0, 8.0)),
}


@pytest.mark.parametrize("case", sorted(GIZMO_CASES))
def test_gizmo_overlay_matches_the_original(case):
    mode, active, pivot = GIZMO_CASES[case]
    img = _image()
    eye, center, up = np.array([2.0, 1.5, 4.0]), np.zeros(3), np.array([0.0, 1.0, 0.0])
    q, _ = np.linalg.qr(np.random.default_rng(2).normal(size=(3, 3)))
    for axes in (np.eye(3), q):
        ref = jdraw.gizmo_overlay(img, eye, center, up, 0.9, np.asarray(pivot), axes, JMode(mode), active=active)
        port = gizmo_draw.gizmo_overlay(torch.tensor(img), eye, center, up, 0.9, np.asarray(pivot), axes, Mode(mode),
                                        active=active)
        assert port.dtype == torch.float32 and np.abs(port.numpy() - ref).max() <= 1e-5
        assert (np.abs(ref - img).max() > 0.2) == (case != "behind")
    assert gizmo_draw.auto_size(eye, pivot, 0.9) == jdraw.auto_size(eye, pivot, 0.9)


def _scene_file(name, tmp_path):
    return make_brainstem(str(tmp_path)) if name == "brainstem" else make_helmet_standin(str(tmp_path))


def _printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


@pytest.mark.parametrize("flags", ["", "--lights --animations --xmp", "--stats --tree --materials --validate"])
@pytest.mark.parametrize("scene", ["helmet", "brainstem"])
def test_inspect_cli_matches_the_original(scene, flags, tmp_path):
    argv = [_scene_file(scene, tmp_path)] + flags.split()
    ref, port = _printed(jinspect.main, argv), _printed(inspect_cli.main, argv)
    assert port == ref and ref[1].strip()


SHELL_SCRIPT = [
    "tree", "flat", "find e", "inspect 0", "matget 0", "materials", "stats", "lights", "cameras",
    "add cube", "translate 2 1 0.5 0", "translate 2 1 0.75 0", "rotate 2 0 0.38268343 0 0.9238795",
    "scale 2 2 2 2", "rename 2 Box A", "matset 0 baseColorFactor 0.1 0.9 0.1 1", "matset 0 unlit 1",
    "matset 0 unlit 0", "matset 1 pbrMetallicRoughness.roughnessFactor 0.3", "matset 0 ior 1 2",
    "matfields", "light spot 0", "lightset 0 intensity 40", "duplicate 2", "delete 3", "undo", "redo",
    "undo", "undo", "reparent 2 0", "visible 1 0", "material 0 0 1", "anims", "variants", "add sphere 0",
    "inspect 99", "translate x 1 2 3", "matset 0 baseColorFactor 1", "frobnicate", "# a comment", "",
    "undo", "redo", "undo", "undo", "undo", "help",
]


@pytest.mark.parametrize("scene", ["helmet", "brainstem"])
def test_edit_shell_script_matches_the_original(scene, tmp_path):
    """One script, good and bad lines, through both shells on the same file:
    the same printed lines, then the same saved glTF."""
    path = _scene_file(scene, tmp_path)
    outs = {}
    for name, (SceneCls, make_shell) in {"jax": (JScene, jedit.EditShell),
                                         "port": (Scene, lambda s: edit_cli.EditShell(s, device="cpu"))}.items():
        sc = SceneCls()
        sc.load(path)
        sh = make_shell(sc)
        lines = [_printed(sh.run_line, line) for line in SHELL_SCRIPT]
        saved = tmp_path / f"{name}.glb"
        _printed(sh.run_line, f"save {saved}")
        outs[name] = (lines, saved.read_bytes())
    assert outs["port"] == outs["jax"]
    printed = "".join(out for _, out in outs["port"][0])
    assert printed.count("error: ") == 4 and "unknown command 'frobnicate'" in printed


def _assert_u8_agree(port, ref):
    port, ref = port.astype(np.int32), ref.astype(np.int32)
    assert port.shape == ref.shape and port.mean() > 2, "black frame"
    close = (np.abs(port - ref) <= 1).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(port.mean(axis=(0, 1)), ref.mean(axis=(0, 1)), atol=0.5)


@pytest.mark.usefixtures("one_torch_thread")
def test_edit_shell_render_matches_the_original(tmp_path):
    """cmd_render at 32x24 after an edit, through edit_cli.main on the CPU,
    against the JAX shell's render. The reference's cmd_render fits the
    camera to the bounds of the last parse, from before the edit; the port
    parses first (ROADMAP C), so the reference renders the edited scene
    after a parse here."""
    path = _scene_file("helmet", tmp_path)
    cmds = ["translate 0 0 0.25 0", f"render {tmp_path / 'port.png'} 32 24"]
    rc, out = _printed(edit_cli.main, [path, "--device", "cpu"] + [a for c in cmds for a in ("-c", c)])
    sc = JScene()
    sc.load(path)
    sh = jedit.EditShell(sc)
    _printed(sh.run_line, cmds[0])
    sc.parse_scene()
    _printed(sh.run_line, f"render {tmp_path / 'ref.png'} 32 24")
    assert rc == 0 and out.endswith(f"rendered {tmp_path / 'port.png'}\n")
    _assert_u8_agree(read_png((tmp_path / "port.png").read_bytes()), read_png((tmp_path / "ref.png").read_bytes()))


def test_edit_shell_render_after_undo_equals_the_first(tmp_path):
    """Every render is frame 0 of a fresh renderer fitted to the scene as
    edited: render, translate and render, undo and render gives the first
    PNG again, byte for byte (the reference's stale fit does not)."""
    path = _scene_file("helmet", tmp_path)
    png = {k: tmp_path / f"{k}.png" for k in ("before", "moved", "undone")}
    cmds = [f"render {png['before']} 24 16", "translate 0 0 0.25 0", f"render {png['moved']} 24 16", "undo",
            f"render {png['undone']} 24 16"]
    rc, _ = _printed(edit_cli.main, [path, "--device", "cpu"] + [a for c in cmds for a in ("-c", c)])
    data = {k: p.read_bytes() for k, p in png.items()}
    assert rc == 0 and data["undone"] == data["before"] != data["moved"]


def _type(v, line):
    assert v.handle_key(":")
    for ch in line:
        assert v.handle_key(ch)
    assert v.handle_key(";")


def _pick_pixel(v, module):
    """The pixel under 0.6 of the +X axis handle of the viewer's gizmo."""
    _, pivot, axes, size = v._gizmo_frame()
    cam = v.r.camera
    (tip,), (front,) = module._Camera(cam.eye, cam.center, cam.up, cam.yfov, v.r.width, v.r.width).project(
        pivot[None] + axes[0][None] * size * 0.6)
    assert front
    return f"{tip[0]:.2f} {tip[1]:.2f}"


def _drive(v, scene, draw):
    """A viewer run as steps; returns (log, frames). Each step's log
    entry: the status line, the tree pane, the last ':' verb's output, the
    tab candidates and the command buffer."""
    log, frames = [], []

    def note(frame=False):
        log.append((v.status(), v.tree_pane(), list(v._last_out), list(v._candidates), v._cmdbuf))
        if frame:
            frames.append(v.frame_u8())

    note(frame=True)
    for k in "aw+":
        v.handle_key(k)
    note(frame=True)
    if scene == "helmet":
        for k in "t]Gg":
            v.handle_key(k)
        note(frame=True)
        _type(v, f"gizmo pick {_pick_pixel(v, draw)}")
        _type(v, "gizmo space local")
        _type(v, "gizmo")
        note(frame=True)
        for line in ("rset", "rset exposure 1.5", "rset tonemapper nosuch", "rset depth x", "rset spp", "cam",
                     "cam fov 30", "cam dist 6", "cam eye 1 2 3", "cam nosuch", "aov normal", "aov depth"):
            _type(v, line)
            note()
        frames.append(v.frame_u8())
        for line in ("aov objectid", "aov off", "gizmo rotate", "gizmo scale"):
            _type(v, line)
            note()
        frames.append(v.frame_u8())
        for partial in ("matg", "matset 0 irid", "rset expo", "rset tonemapper ag", "gizmo s", "aov ", "cam "):
            v.handle_key(":")
            for ch in partial:
                v.handle_key(ch)
            v.handle_key("\t")
            note()
            v.handle_key("\x1b")
        v.handle_key("n")
        note(frame=True)
    else:
        for line in ("timeline", "timeline time 0.5", "timeline select 0", "timeline speed 2", "timeline play",
                     "timeline pause", "timeline nosuch", "timeline time x"):
            _type(v, line)
            note()
        v.handle_key("A")
        note(frame=True)
        note(frame=True)
        for k in "t]x":
            v.handle_key(k)
        note(frame=True)
        _type(v, "translate 0 0 0.3 0")
        _type(v, "undo")
        note(frame=True)
    return log, frames


@pytest.mark.parametrize("scene", ["helmet", "brainstem"])
@pytest.mark.usefixtures("one_torch_thread")
def test_terminal_viewer_matches_the_original(scene, tmp_path):
    path = _scene_file(scene, tmp_path)
    ref = _drive(jviewer.TerminalViewer(path, size=24, max_depth=2), scene, jdraw)
    port = _drive(viewer.TerminalViewer(path, size=24, max_depth=2, device="cpu"), scene, gizmo_draw)
    assert port[0] == ref[0]
    assert len(port[1]) == len(ref[1]) >= 4
    for p, r in zip(port[1], ref[1]):
        _assert_u8_agree(p, r)
    if scene == "helmet":
        assert any(entry[2] == ["gizmo translate space=local active=0"] for entry in port[0])


def test_scripted_viewer_writes_its_png(tmp_path):
    """viewer.main --keys on the CPU: the PNG written with utils/png.py, the
    final status line and the tree pane printed."""
    path = _scene_file("helmet", tmp_path)
    hdr = write_synthetic_hdr(tmp_path / "env.hdr", 32, 64)
    out = tmp_path / "v.png"
    rc, printed = _printed(viewer.main, ["--scenefile", path, "--hdr", hdr, "--size", "16", "--maxDepth", "2",
                                         "--device", "cpu", "--keys", "t]G:translate 1 0 0.1 0;p", "--output",
                                         str(out)])
    img = read_png(out.read_bytes())
    assert rc == 0 and img.shape == (16, 16, 3) and img.mean() > 2
    assert f"Saved {out}" in printed and "[preview +grid] frame" in printed and "> [1] plate" in printed


FRAME_TIMES = {
    "steady": [5.0] * 30,
    "slow_then_fast": [200.0] * 6 + [3.0] * 20 + [40.0] * 10,
    "noisy": list(np.random.default_rng(4).uniform(0.5, 90.0, 60)),
}


@pytest.mark.parametrize("target_fps", [60, 30, 10, 24])
@pytest.mark.parametrize("times", sorted(FRAME_TIMES))
def test_adaptive_sampler_matches_the_original(times, target_fps):
    """The same frame times give the same spp sequence, update with the
    per-frame time scaled by spp as a renderer would see it, and
    update_global with and without rays."""
    out = {}
    for name, cls in (("jax", JSampler), ("port", AdaptiveSampler)):
        a, g = cls(target_fps=target_fps), cls(target_fps=target_fps)
        seq = []
        for i, ms in enumerate(FRAME_TIMES[times]):
            seq.append((a.update(ms * a.spp), g.update_global(0.0 if i % 7 == 3 else 1e6, ms * g.spp)))
        out[name] = seq
    assert out["port"] == out["jax"]
    assert {s for pair in out["port"] for s in pair} <= set(AdaptiveSampler.BUCKETS)


def test_adaptive_hook_retargets_spp_from_the_frame_time(tmp_path, monkeypatch):
    """GltfRenderer.adaptive: each on_render reads the host clock around the
    frame and sets spp for the next one, as the sampler says."""
    clock = iter(np.arange(0.0, 100.0, 0.005))  # every read 5 ms later
    monkeypatch.setattr(trenderer, "time", types.SimpleNamespace(perf_counter=lambda: float(next(clock))))
    r = GltfRenderer(16, 12, spp=1, max_depth=1, device="cpu")
    r.create_scene(_scene_file("helmet", tmp_path))
    r.adaptive = AdaptiveSampler(target_fps=10)
    ref = JSampler(target_fps=10)
    spps = []
    for _ in range(4):
        r.on_render()
        spps.append(r.spp)
    assert spps == [ref.update(5.0 * ref.spp) for _ in range(4)] and spps[-1] > 1


def _failing_render(exc):
    def on_render(self):
        raise exc("device fault")

    return on_render


@pytest.mark.parametrize("exc", [RuntimeError, ValueError])
def test_edit_shell_lets_a_render_error_through(exc, tmp_path, monkeypatch):
    """edit_cli.run_line keeps the shell alive on bad input, but not when
    the renderer raises (a CUDA or kernel-library error is a RuntimeError;
    a ValueError from the renderer is no bad input either)."""
    sc = Scene()
    sc.load(_scene_file("helmet", tmp_path))
    sh = edit_cli.EditShell(sc, device="cpu")
    monkeypatch.setattr(GltfRenderer, "on_render", _failing_render(exc))
    rc, out = _printed(sh.run_line, f"render {tmp_path / 'x.png'} 8 8x")
    assert rc and out == "error: ValueError: invalid literal for int() with base 10: '8x'\n"
    with pytest.raises(exc, match="device fault"):
        sh.run_line(f"render {tmp_path / 'x.png'} 8 8")
    assert _printed(sh.run_line, "inspect 0")[1].startswith("node [0]")


@pytest.mark.parametrize("exc", [RuntimeError, ValueError])
def test_viewer_lets_a_resync_error_through(exc, tmp_path, monkeypatch):
    """The viewer's run_command does not catch sync_scene_changes (the
    device refit) after an edit-shell verb, and a local verb's error
    passes once the renderer has the work (:timeline time); a local verb's
    bad input still prints."""
    v = viewer.TerminalViewer(_scene_file("brainstem", tmp_path), size=8, max_depth=1, device="cpu")
    monkeypatch.setattr(GltfRenderer, "sync_scene_changes", _failing_render(exc))
    with pytest.raises(exc, match="device fault"):
        _type(v, "translate 0 0 0.3 0")
    _type(v, "timeline speed x")
    assert v._last_out == ["error: ValueError: could not convert string to float: 'x'"]
    with pytest.raises(exc, match="device fault"):
        _type(v, "timeline time 0.5")


@pytest.mark.parametrize("exc", [RuntimeError, ValueError])
def test_viewer_frame_lets_a_render_error_through(exc, tmp_path, monkeypatch):
    """A ':render' verb inside the viewer runs through the edit shell:
    its renderer's error propagates out of run_command too."""
    v = viewer.TerminalViewer(_scene_file("helmet", tmp_path), size=8, max_depth=1, device="cpu")
    monkeypatch.setattr(GltfRenderer, "on_render", _failing_render(exc))
    with pytest.raises(exc, match="device fault"):
        _type(v, f"render {tmp_path / 'x.png'} 8 8")


@pytest.mark.parametrize("front", ["edit_cli", "viewer"])
def test_front_ends_default_to_the_card(front, tmp_path, monkeypatch):
    """Without --device the shell and the viewer ask for CUDA, and raise
    where there is none; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _scene_file("helmet", tmp_path)
    argv = [path, "-c", "tree"] if front == "edit_cli" else ["--scenefile", path, "--keys", ""]
    main = edit_cli.main if front == "edit_cli" else viewer.main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _printed(main, argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        edit_cli.EditShell(Scene()) if front == "edit_cli" else viewer.TerminalViewer(path)
