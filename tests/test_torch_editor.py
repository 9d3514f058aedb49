"""The port's editing layer against the JAX package's, on the CPU: its
copies of models/validator.py, models/undo.py, models/compact.py,
models/obj_converter.py, utils/camera_manipulator.py and gizmo.py (every
function's and class's source, then behaviour), and utils/visual_validator.py,
which reads and writes PNG without Pillow.

Behaviour is held exactly: the same sequence of edits on both packages'
scenes gives equal glTF JSON and buffer bytes, validation gives the same
errors and warnings, the OBJ converter the same model, and the camera and
gizmo math the same float64 numbers (np.array_equal)."""

import inspect
import json

import numpy as np
import pytest
from PIL import Image

from vk_gltf_renderer_tpu import gizmo as jgizmo
from vk_gltf_renderer_tpu.models import Scene as JScene
from vk_gltf_renderer_tpu.models import compact as jcompact
from vk_gltf_renderer_tpu.models import gltf as jgltf
from vk_gltf_renderer_tpu.models import obj_converter as jobj
from vk_gltf_renderer_tpu.models import undo as jundo
from vk_gltf_renderer_tpu.models import validator as jvalidator
from vk_gltf_renderer_tpu.models.editor import SceneEditor as JEditor
from vk_gltf_renderer_tpu.utils import camera_manipulator as jcam
from vk_gltf_renderer_tpu.utils import visual_validator as jvv
from vk_gltf_renderer_tpu_torch import gizmo as tgizmo
from vk_gltf_renderer_tpu_torch.models import Scene as TScene
from vk_gltf_renderer_tpu_torch.models import compact as tcompact
from vk_gltf_renderer_tpu_torch.models import gltf as tgltf
from vk_gltf_renderer_tpu_torch.models import obj_converter as tobj
from vk_gltf_renderer_tpu_torch.models import undo as tundo
from vk_gltf_renderer_tpu_torch.models import validator as tvalidator
from vk_gltf_renderer_tpu_torch.models.editor import SceneEditor as TEditor
from vk_gltf_renderer_tpu_torch.scenes import make_helmet_standin
from vk_gltf_renderer_tpu_torch.utils import camera_manipulator as tcam
from vk_gltf_renderer_tpu_torch.utils import visual_validator as tvv

from conftest import make_triangle_gltf

# the JAX package's modules the port copies unchanged, and the port's copies
COPIES = {
    "models/validator.py": (jvalidator, tvalidator),
    "models/undo.py": (jundo, tundo),
    "models/compact.py": (jcompact, tcompact),
    "models/obj_converter.py": (jobj, tobj),
    "utils/camera_manipulator.py": (jcam, tcam),
    "gizmo.py": (jgizmo, tgizmo),
}

# one package's side of a comparison: Scene, SceneEditor, undo, compact, validator, obj, gizmo
SIDES = {
    "jax": dict(Scene=JScene, Editor=JEditor, gltf=jgltf, undo=jundo, compact=jcompact,
                validator=jvalidator, obj=jobj, gizmo=jgizmo),
    "port": dict(Scene=TScene, Editor=TEditor, gltf=tgltf, undo=tundo, compact=tcompact,
                 validator=tvalidator, obj=tobj, gizmo=tgizmo),
}


def _own(module):
    """Functions and classes defined in module, by name."""
    return {n: v for n, v in vars(module).items()
            if (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == module.__name__}


@pytest.mark.parametrize("path", sorted(COPIES))
def test_copied_editing_modules_match_the_originals(path):
    ref, port = COPIES[path]
    names = _own(ref)
    assert names and sorted(names) == sorted(_own(port)), path
    for n in names:
        assert inspect.getsource(getattr(port, n)) == inspect.getsource(getattr(ref, n)), (path, n)


def _triangle_scene(side):
    gltf, bufs = make_triangle_gltf()
    sc = side["Scene"]()
    sc.load_from_model(side["gltf"].load_model_from_json(gltf, bufs))
    sc.clear_dirty_flags()
    return sc


def _helmet_scene(side, tmp_path):
    sc = side["Scene"]()
    sc.load(make_helmet_standin(str(tmp_path)))
    return sc


def _state(sc):
    """What an edit sequence leaves: the glTF JSON and the buffers' bytes."""
    return json.dumps(sc.model.gltf, sort_keys=True, default=str), [bytes(b) for b in sc.model.buffers]


def _undo_transform(side, sc):
    stack = side["undo"].UndoStack(sc)
    stack.execute(side["undo"].TransformCommand(0, "translation", [2.0, 0.5, 0.0]))
    stack.execute(side["undo"].TransformCommand(1, "scale", [1.0, 2.0, 1.0]))
    log = [_state(sc)]
    log.append((stack.undo(), _state(sc)))
    log.append((stack.redo(), _state(sc)))
    log.append((stack.undo(), stack.undo(), stack.undo(), _state(sc)))
    return log


def _undo_merge(side, sc):
    """Continuous drags on one node merge into one entry; another key does not."""
    u = side["undo"]
    stack = u.UndoStack(sc)
    for x in (0.25, 0.5, 1.0):
        c = u.TransformCommand(0, "translation", [x, 0.0, 0.0])
        c.execute(sc)
        stack.push_executed(c)
    c = u.TransformCommand(0, "rotation", [0.0, 0.0, 0.38268343, 0.9238795])
    c.execute(sc)
    stack.push_executed(c)
    log = [len(stack._undo), _state(sc)]
    log.append((stack.undo(), _state(sc), stack.undo(), _state(sc), stack.can_undo, stack.can_redo))
    return log


def _undo_snapshots(side, sc):
    """Snapshot undo after add, duplicate and delete, and redo."""
    u = side["undo"]
    stack = u.UndoStack(sc)
    ed = side["Editor"]
    stack.execute(u.SnapshotCommand(action=lambda s: ed(s).add_primitive("cube"), label="add"))
    stack.execute(u.SnapshotCommand(action=lambda s: ed(s).duplicate_node(0), label="dup"))
    stack.execute(u.SnapshotCommand(action=lambda s: ed(s).delete_node(1), label="del"))
    log = [_state(sc)]
    for op in ("undo", "undo", "redo", "undo", "undo", "redo", "redo"):
        log.append((getattr(stack, op)(), _state(sc)))
    sc.parse_scene()
    log.append(len(sc.render_nodes))
    return log


def _undo_material(side, sc):
    u = side["undo"]
    stack = u.UndoStack(sc)
    stack.execute(u.MaterialCommand(material_id=0, updates={
        "pbrMetallicRoughness.baseColorFactor": [0.1, 0.9, 0.1, 1.0],
        "extensions.KHR_materials_ior.ior": 1.7, "emissiveFactor": [1.0, 0.5, 0.0]}))
    stack.execute(u.MaterialCommand(material_id=1, updates={"pbrMetallicRoughness.roughnessFactor": 0.2}))
    log = [_state(sc), int(sc.get_dirty_flags())]
    log.append((stack.undo(), _state(sc), stack.undo(), _state(sc), stack.redo(), _state(sc)))
    return log


def _undo_limit(side, sc):
    """The stack keeps its newest 200 entries; a new command clears redo."""
    u = side["undo"]
    stack = u.UndoStack(sc)
    for i in range(230):
        stack.execute(u.TransformCommand(i % 2, "scale" if i % 3 else "translation", [1.0 + i, 1.0, 1.0]))
    undone = 0
    while stack.undo():
        undone += 1
    log = [undone, _state(sc)]
    stack.redo()
    stack.execute(u.TransformCommand(0, "translation", [9.0, 9.0, 9.0]))
    log.append((stack.can_redo, _state(sc)))
    return log


UNDO_CASES = {"transform": _undo_transform, "merge": _undo_merge, "snapshots": _undo_snapshots,
              "material": _undo_material, "limit": _undo_limit}


@pytest.mark.parametrize("case", sorted(UNDO_CASES))
def test_undo_stack_matches_the_original(case, tmp_path):
    logs = {name: UNDO_CASES[case](side, _helmet_scene(side, tmp_path)) for name, side in SIDES.items()}
    assert logs["port"] == logs["jax"]
    if case == "limit":
        assert logs["port"][0] == 200


def _orphaned(side, tmp_path):
    """The helmet with a sphere added and deleted (its mesh, material and
    accessors left behind) and a texture-less material appended."""
    sc = _helmet_scene(side, tmp_path)
    ed = side["Editor"](sc)
    nid = ed.add_primitive("sphere", segments=6)
    ed.add_primitive("cube")
    ed.delete_node(nid)
    sc.model.materials.append({"name": "unused"})
    return sc


@pytest.mark.parametrize("scene", ["orphaned", "clean"])
def test_compact_matches_the_original(scene, tmp_path):
    out = {}
    for name, side in SIDES.items():
        sc = _orphaned(side, tmp_path) if scene == "orphaned" else _triangle_scene(side)
        counts = side["compact"].compact_model(sc.model)
        saved = side["compact"].compact_buffers(sc.model)
        v = side["validator"].validate_model(sc.model)
        sc.parse_scene()
        out[name] = (counts, saved, _state(sc), v.errors, v.warnings, len(sc.render_nodes))
    assert out["port"] == out["jax"]
    counts, saved = out["port"][:2]
    assert (saved > 0 and counts["meshes"] >= 1) if scene == "orphaned" else saved == 0


def _break(g, how):
    if how == "bad_indices":
        g["nodes"][0]["mesh"] = 99
        g["nodes"][0]["children"] = [7]
        g["scenes"][0]["nodes"].append(5)
    elif how == "overrun":
        g["accessors"][0]["count"] = 10_000
        g["bufferViews"][1]["byteLength"] = 4096
    elif how == "warnings":
        g["accessors"][1]["count"] = 2
        g["bufferViews"][1]["byteLength"] = 4
        g["meshes"].append({"primitives": []})
    elif how == "graph":
        g["nodes"].append({"children": [0]})
        g["nodes"][0]["children"] = [1]
        g["nodes"][0]["skin"] = 3
        g["meshes"][0]["primitives"][0]["material"] = 4
        g["meshes"][0]["primitives"][0]["attributes"] = {"NORMAL": 0}
        g["materials"][0]["normalTexture"] = {"index": 2}


@pytest.mark.parametrize("how", ["good", "bad_indices", "overrun", "warnings", "graph"])
def test_validate_model_matches_the_original(how):
    res = {}
    for name, side in SIDES.items():
        gltf, bufs = make_triangle_gltf()
        _break(gltf, how)
        v = side["validator"].validate_model(side["gltf"].load_model_from_json(gltf, bufs))
        res[name] = (v.valid, v.errors, v.warnings)
    assert res["port"] == res["jax"]
    assert res["port"][0] == (how in ("good", "warnings"))
    assert bool(res["port"][2]) == (how == "warnings")


def test_validate_model_on_the_helmet_matches(tmp_path):
    res = [(v.valid, v.errors, v.warnings) for v in (
        side["validator"].validate_model(_helmet_scene(side, tmp_path).model) for side in SIDES.values())]
    assert res[0] == res[1] and res[0][0]


OBJS = {
    "quad_mtl": ("mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                 "vn 0 0 1\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
                 "usemtl red\nf 1/1/1 2/2/1 3/3/1 4/4/1\n",
                 "newmtl red\nKd 1 0 0\nNs 10\nKe 0.5 0.2 0\n"),
    "groups_negative": ("mtllib m.mtl\n# two groups, negative indices, no normals\n"
                        "v 0 0 0\nv 2 0 0\nv 2 2 0\nv 0 2 1\nv 1 1 3\n"
                        "usemtl glass\nf -5 -4 -3\nf 1 3 4 5\n"
                        "usemtl default\nf 2//0 3 5\n",
                        "newmtl glass\nKd 0.2 0.4 0.9\nd 0.4\nNs 250\nnewmtl unused\nKd 1 1 1\n"),
}


@pytest.mark.parametrize("case", sorted(OBJS))
def test_load_obj_matches_the_original(case, tmp_path):
    obj, mtl = OBJS[case]
    (tmp_path / "m.mtl").write_text(mtl)
    (tmp_path / "t.obj").write_text(obj)
    res = {}
    for name, side in SIDES.items():
        model = side["obj"].load_obj(tmp_path / "t.obj")
        v = side["validator"].validate_model(model)
        sc = side["Scene"]()
        sc.load_from_model(model)
        res[name] = (json.dumps(model.gltf, sort_keys=True), [bytes(b) for b in model.buffers], v.errors,
                     side["obj"]._parse_mtl(tmp_path / "m.mtl"), len(sc.render_nodes))
    assert res["port"] == res["jax"]
    assert res["port"][2] == [] and res["port"][4] >= 1


def _camera_log(module, rc):
    m = module.CameraManipulator(eye=(1.0, 2.0, 5.0), center=(0.1, 0.2, -0.3))
    out = []
    for dx, dy, pan, dolly in ((0.3, -0.2, (0.05, 0.1), 0.2), (-1.2, 0.9, (-0.3, 0.0), -0.4), (2.5, 3.0, (0.0, -0.2), 0.9)):
        m.orbit(dx, dy)
        out.append((m.eye.copy(), m.center.copy()))
        m.pan(*pan)
        out.append((m.eye.copy(), m.center.copy()))
        m.dolly(dolly)
        out.append((m.eye.copy(), m.center.copy()))
    m.fit([-1.0, -0.5, -2.0], [3.0, 1.5, 0.5])
    out.append((m.eye.copy(), m.center.copy(), m.znear, m.zfar))
    out.append(json.dumps(m.to_gltf_node(), sort_keys=True))
    r = module.CameraManipulator.from_render_camera(rc)
    out.append((r.eye, r.center, r.up, r.yfov, r.znear, r.zfar))
    return out


def test_camera_manipulator_matches_the_original():
    class RenderCamera:
        eye, center, up = np.array([0.0, 1.0, 4.0]), np.zeros(3), np.array([0.0, 1.0, 0.0])
        yfov, znear, zfar = 0.7, 0.05, 0.0

    ref, port = _camera_log(jcam, RenderCamera), _camera_log(tcam, RenderCamera)
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        if isinstance(a, str):
            assert a == b
            continue
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y)), (a, b)


def test_visual_validator_matches_the_original(tmp_path):
    rng = np.random.default_rng(7)
    a = rng.random((16, 24, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.01, a.shape), 0, 1).astype(np.float32)
    assert tvv.rmse(a, b) == jvv.rmse(a, b)
    with pytest.raises(ValueError):
        tvv.rmse(a, b[:8])
    assert tvv.compare_screenshots(a, b) == jvv.compare_screenshots(a, b)
    # goldens: the port writes with utils/png.py, the reference with Pillow; each reads both
    gp, gj = tmp_path / "port.png", tmp_path / "jax.png"
    assert tvv.check_or_create_golden(a, gp)["created"] and jvv.check_or_create_golden(a, gj)["created"]
    assert gp.read_bytes() != gj.read_bytes()  # two encoders ...
    assert np.array_equal(tvv.load_image(gp), jvv.load_image(gj))  # ... one image
    for golden in (gp, gj):
        assert tvv.check_or_create_golden(b, golden) == jvv.check_or_create_golden(b, golden)
        assert tvv.compare_screenshots(str(golden), b) == jvv.compare_screenshots(str(golden), b)


@pytest.mark.parametrize("mode", ["L", "LA", "RGBA"])
def test_visual_validator_reads_pillow_pngs_as_rgb(mode, tmp_path):
    rng = np.random.default_rng(3)
    shape = (9, 13) if mode == "L" else (9, 13, len(mode))
    p = tmp_path / f"{mode}.png"
    Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode).save(p)
    assert np.array_equal(tvv.load_image(p), jvv.load_image(p))


def test_visual_validator_refuses_a_non_png(tmp_path):
    """A Pillow JPEG, refused before the port decoded JPEG, now reads as
    the reference's load_image reads it (within 1/255), and so does a BMP
    (exactly), refused before Pillow's other formats were ported; data
    that no reader claims is still refused."""
    rng = np.random.default_rng(5)
    p = tmp_path / "x.jpg"
    Image.fromarray(rng.integers(0, 256, (19, 27, 3), dtype=np.uint8)).save(p)
    port, ref = tvv.load_image(p), jvv.load_image(p)
    assert port.shape == ref.shape == (19, 27, 3)
    assert np.abs(port - ref).max() <= 1 / 255 + 1e-7
    q = tmp_path / "x.bmp"
    Image.fromarray(rng.integers(0, 256, (4, 5, 3), dtype=np.uint8)).save(q)
    assert np.array_equal(tvv.load_image(q), jvv.load_image(q))
    z = tmp_path / "x.xyz"
    z.write_bytes(b"neither PNG nor JPEG nor anything else\n")
    with pytest.raises(ValueError, match="cannot identify"):
        tvv.load_image(z)


def _gizmo_log(gz, scene, rays, mode, space):
    """pick_handle over seeded rays; then a drag of each picked handle
    (begin_drag, drag_delta unsnapped and snapped) applied through
    apply_delta to a node of the scene."""
    nid = 0
    pivot, axes = gz.handle_frame(scene, nid, gz.Space(space))
    out = [pivot, axes]
    snap = gz.Snap(translate=0.25, rotate_deg=15.0, scale=0.1)
    ed = SIDES["jax" if gz is jgizmo else "port"]["Editor"](scene)
    for (ro, rd), (ro1, rd1) in zip(rays[0::2], rays[1::2]):
        h = gz.pick_handle(ro, rd, pivot, axes, gz.Mode(mode), size=1.3)
        out.append(h)
        if h is None:
            continue
        st = gz.begin_drag(ro, rd, pivot, axes, h, size=1.3)
        out += [st.start_point, st.start_angle]
        for s in (gz.Snap(), snap):
            d = gz.drag_delta(st, ro1, rd1, s)
            out.append(json.dumps({k: np.asarray(v).tolist() for k, v in d.items()}, sort_keys=True))
            gz.apply_delta(ed, nid, d, snap=s)
            out.append(json.dumps(scene.model.nodes[nid], sort_keys=True))
    return out


@pytest.mark.parametrize("space", ["world", "local"])
@pytest.mark.parametrize("mode", ["translate", "rotate", "scale"])
def test_gizmo_math_matches_the_original(mode, space, tmp_path):
    rng = np.random.default_rng(11)
    rays = []
    for _ in range(64):
        target = rng.normal(size=3) * 0.9
        ro = target + np.array([0.3, 0.4, 4.0]) + rng.normal(size=3) * 0.5
        rd = target - ro
        rays.append((ro, rd / np.linalg.norm(rd)))
    logs = {}
    for name, side in SIDES.items():
        sc = _helmet_scene(side, tmp_path)
        ed = side["Editor"](sc)
        ed.set_rotation(0, [0.0, 0.38268343, 0.0, 0.9238795])
        ed.set_translation(0, [0.2, -0.1, 0.3])
        sc.parse_scene()
        logs[name] = _gizmo_log(side["gizmo"], sc, rays, mode, space)
    ref, port = logs["jax"], logs["port"]
    assert len(ref) == len(port) and sum(h is not None for h in ref[2:] if isinstance(h, (int, type(None)))) > 0
    for a, b in zip(ref, port):
        assert type(a) is type(b) and np.array_equal(np.asarray(a), np.asarray(b)), (a, b)
