"""In-repo scenes for the port's runs and tests.

make_helmet_standin writes the same glTF as the reference's
tools/baseline_standins.make_helmet (a checker-textured PBR sphere on a
rough plate, the DamagedHelmet feature role), but writes its checker
texture with utils/png.py, so it needs no Pillow. make_game_standin and
make_suite_standin write the same glTF as make_game (one sphere mesh
instanced 16 times over a board, clearcoat pieces and transmission +
volume glass: the ABeautifulGame role) and make_suite (transmission +
volume-scatter, dispersion and iridescence spheres: the material-suite
role), through the port's own models package. Both keep the reference
generators' material indices as they are: SceneEditor.add_primitive
appends a default material per primitive, so the game's pieces render
with those defaults and its "glass" mesh with the board material, and the
suite's second and third spheres take the default and the dispersive
material; its volume_scatter block names scatterColor, which the material
parser does not read. So neither scene shows glass, clearcoat or
iridescence on a surface, though each compiles those blocks in.
add_standin_lights adds a point, a spot and a directional light;
make_lit_game_standin is the game with them, and make_materials_standin a
board with nine spheres that do carry every material family the path
tracer shades (scattering, dispersive and thick glass, clearcoat,
iridescence, sheen, anisotropy, diffuse transmission with specular, and
unlit) under those lights.

make_brainstem writes the same files as tools/baseline_standins.make_brainstem
(the BrainStem role of BASELINE config 5): a 16-sided column of 64
triangles skinned to two joints, and a looping 2 s rotation clip on the
top joint.

make_masked_quads writes tests/test_omm.py's three MASK-textured
triangles (one over opaque texels, one over transparent ones, one across
the seam), the PNG written with utils/png.py instead of Pillow.
make_foliage_standin writes an alpha-tested canopy with no generator in
the reference, the role of Sponza's plants and Khronos' AlphaBlendModeTest:
leaf cards over an atlas whose quadrants classify MIXED (split into
cells), OPAQUE, TRANSPARENT (culled) and as an alpha gradient, blended
panes and an opaque ground.

write_large_glb writes the same bytes as tools/large_scene_demo.write_large_glb:
an instanced grid of displaced terrain patches with one untextured
metallic-roughness material (1,059,968 world triangles at the default
target_tris=1_050_000, grid=8), the scene whose BVH outgrows the H100's L2.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

from .models import Scene
from .models.editor import SceneEditor
from .models.gltf import load_model_from_json
from .utils.png import write_png


def _empty_scene():
    sc = Scene()
    sc.load_from_model(load_model_from_json(
        {"asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": []}]}, []))
    return sc


def checker_image(n=128, c0=(200, 60, 40), c1=(240, 230, 210)) -> np.ndarray:
    y, x = np.mgrid[0:n, 0:n]
    m = ((x // 16 + y // 16) % 2).astype(bool)
    return np.where(m[..., None], np.array(c1, np.uint8), np.array(c0, np.uint8)).astype(np.uint8)


def synthetic_sky(h=256, w=512, seed=0) -> np.ndarray:
    """Procedural lat-long HDR [h,w,3]: a horizon-to-zenith gradient over a
    darker ground, mild per-texel noise and a bright sun disk, all from a
    fixed numpy seed."""
    rng = np.random.default_rng(seed)
    v = (np.arange(h) + 0.5) / h  # 0 = zenith, 1 = nadir
    up = np.clip(1.0 - 2.0 * v, 0.0, 1.0)[:, None, None]
    zenith = np.array([0.25, 0.45, 0.9])
    horizon = np.array([0.9, 0.85, 0.8])
    ground = np.array([0.25, 0.22, 0.2])
    rgb = np.where((v < 0.5)[:, None, None], horizon * (1 - up) + zenith * up, ground)
    rgb = np.broadcast_to(rgb, (h, w, 3)) * (1.0 + 0.05 * rng.standard_normal((h, w, 1)))
    sy, sx = int(0.3 * h), int(0.6 * w)
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.where(((yy - sy) ** 2 + (xx - sx) ** 2 <= (h // 64 + 1) ** 2)[..., None],
                   np.array([800.0, 760.0, 700.0]), rgb)
    return np.maximum(rgb, 0.0).astype(np.float32)


def write_synthetic_hdr(path, h=256, w=512, seed=0) -> str:
    """synthetic_sky written as a Radiance .hdr with flat RGBE scanlines."""
    from .ops.hdr import write_hdr

    write_hdr(path, synthetic_sky(h, w, seed))
    return str(path)


def make_helmet_standin(out_dir) -> str:
    """Write helmet.gltf (+ .bin and helmet_baseColor.png) into out_dir;
    returns the .gltf path."""
    sc = _empty_scene()
    ed = SceneEditor(sc)
    ball = ed.add_primitive("sphere", segments=48, name="helmet")
    plate = ed.add_primitive("plane", name="plate")
    ed.set_translation(plate, [0.0, -1.1, 0.0])
    ed.set_scale(plate, [4.0, 1.0, 4.0])
    tex = os.path.join(out_dir, "helmet_baseColor.png")
    write_png(tex, checker_image())
    m = sc.model
    m.images.append({"uri": os.path.basename(tex)})
    m.gltf.setdefault("samplers", []).append({"wrapS": 10497, "wrapT": 10497})
    m.gltf.setdefault("textures", []).append({"source": 0, "sampler": 0})
    m.materials.append({
        "name": "helmet_pbr",
        "pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
            "metallicFactor": 0.6,
            "roughnessFactor": 0.35,
        },
    })
    m.materials.append({
        "name": "plate",
        "pbrMetallicRoughness": {"baseColorFactor": [0.3, 0.3, 0.32, 1.0],
                                 "roughnessFactor": 0.9, "metallicFactor": 0.0},
    })
    ed.set_material(ball, 0, 0)
    ed.set_material(plate, 0, 1)
    sc.parse_scene()
    p = os.path.join(out_dir, "helmet.gltf")
    sc.save(p)
    return p


def make_game_standin(out_dir) -> str:
    """Write game.gltf (+ .bin) into out_dir; returns the .gltf path."""
    sc = _empty_scene()
    ed = SceneEditor(sc)
    board = ed.add_primitive("plane", name="board")
    ed.set_scale(board, [4.0, 1.0, 4.0])
    piece0 = ed.add_primitive("sphere", segments=24, name="piece")
    m = sc.model
    m.materials.append({
        "name": "board",
        "pbrMetallicRoughness": {"baseColorFactor": [0.1, 0.1, 0.12, 1.0],
                                 "roughnessFactor": 0.4, "metallicFactor": 0.1},
    })
    m.materials.append({
        "name": "clearcoat_piece",
        "pbrMetallicRoughness": {"baseColorFactor": [0.7, 0.1, 0.05, 1.0],
                                 "roughnessFactor": 0.5, "metallicFactor": 0.0},
        "extensions": {"KHR_materials_clearcoat": {
            "clearcoatFactor": 1.0, "clearcoatRoughnessFactor": 0.08}},
    })
    m.materials.append({
        "name": "glass_piece",
        "pbrMetallicRoughness": {"baseColorFactor": [1.0, 1.0, 1.0, 1.0],
                                 "roughnessFactor": 0.02, "metallicFactor": 0.0},
        "extensions": {
            "KHR_materials_transmission": {"transmissionFactor": 1.0},
            "KHR_materials_ior": {"ior": 1.5},
            "KHR_materials_volume": {"thicknessFactor": 0.4,
                                     "attenuationColor": [0.8, 0.9, 1.0],
                                     "attenuationDistance": 2.0},
        },
    })
    ed.set_material(board, 0, 0)
    ed.set_material(piece0, 0, 1)
    ed.set_translation(piece0, [-1.5, 0.35, -1.5])
    ed.set_scale(piece0, [0.3, 0.3, 0.3])
    # 15 more node instances of the same mesh
    mesh_id = sc.model.nodes[piece0].get("mesh")
    for i in range(15):
        gx, gz = (i + 1) % 4, (i + 1) // 4
        nid = len(sc.model.nodes)
        sc.model.nodes.append({
            "name": f"piece_{i+1}", "mesh": mesh_id,
            "translation": [-1.5 + gx, 0.35, -1.5 + gz],
            "scale": [0.3, 0.3, 0.3],
        })
        sc.model.scenes[0]["nodes"].append(nid)
    # materials are per mesh in glTF: a clone of the mesh carries the glass,
    # and the pieces on even node indices take it
    glass_mesh = dict(sc.model.meshes[mesh_id])
    glass_mesh["primitives"] = [dict(p) for p in glass_mesh["primitives"]]
    glass_mesh["primitives"][0]["material"] = 2
    sc.model.meshes.append(glass_mesh)
    for i, node in enumerate(sc.model.nodes):
        if node.get("name", "").startswith("piece_") and i % 2 == 0:
            node["mesh"] = len(sc.model.meshes) - 1
    sc.parse_scene()
    p = os.path.join(out_dir, "game.gltf")
    sc.save(p)
    return p


def make_suite_standin(out_dir) -> str:
    """Write suite.gltf (+ .bin) into out_dir; returns the .gltf path."""
    sc = _empty_scene()
    ed = SceneEditor(sc)
    m = sc.model
    mats = [
        {"name": "scatter_glass",
         "pbrMetallicRoughness": {"baseColorFactor": [1, 1, 1, 1],
                                  "roughnessFactor": 0.0, "metallicFactor": 0.0},
         "extensions": {
             "KHR_materials_transmission": {"transmissionFactor": 1.0},
             "KHR_materials_ior": {"ior": 1.45},
             "KHR_materials_volume": {"thicknessFactor": 1.0,
                                      "attenuationColor": [0.9, 0.6, 0.4],
                                      "attenuationDistance": 1.0},
             "KHR_materials_volume_scatter": {
                 "scatterColor": [0.6, 0.7, 0.9], "scatterDistance": 0.8,
                 "scatterAnisotropy": 0.3},
         }},
        {"name": "dispersive",
         "pbrMetallicRoughness": {"baseColorFactor": [1, 1, 1, 1],
                                  "roughnessFactor": 0.0, "metallicFactor": 0.0},
         "extensions": {
             "KHR_materials_transmission": {"transmissionFactor": 1.0},
             "KHR_materials_ior": {"ior": 1.52},
             "KHR_materials_dispersion": {"dispersion": 0.25},
         }},
        {"name": "iridescent",
         "pbrMetallicRoughness": {"baseColorFactor": [0.2, 0.2, 0.2, 1],
                                  "roughnessFactor": 0.15, "metallicFactor": 1.0},
         "extensions": {
             "KHR_materials_iridescence": {
                 "iridescenceFactor": 1.0, "iridescenceIor": 1.8,
                 "iridescenceThicknessMaximum": 500.0},
         }},
    ]
    for i, mat in enumerate(mats):
        m.materials.append(mat)
        nid = ed.add_primitive("sphere", segments=32, name=mat["name"])
        ed.set_material(nid, 0, i)
        ed.set_translation(nid, [(i - 1) * 2.4, 0.0, 0.0])
    sc.parse_scene()
    p = os.path.join(out_dir, "suite.gltf")
    sc.save(p)
    return p


def add_standin_lights(editor) -> None:
    """A point light above the board, a spot light pointing down and a
    directional light from 45 degrees, through SceneEditor.add_light."""
    editor.add_light("point", intensity=40.0, translation=[0.5, 2.5, 0.5])
    spot = editor.add_light("spot", intensity=80.0, translation=[-1.0, 3.0, 1.0], inner_cone=0.3,
                            outer_cone=0.7)
    editor.set_rotation(spot, [-0.70710677, 0.0, 0.0, 0.70710677])  # node -z points down
    sun = editor.add_light("directional", intensity=2.0)
    editor.set_rotation(sun, [-0.38268343, 0.0, 0.0, 0.9238795])


def make_lit_game_standin(out_dir) -> str:
    """Write lit_game.gltf: the game stand-in with add_standin_lights."""
    sc = Scene()
    sc.load(make_game_standin(out_dir))
    add_standin_lights(SceneEditor(sc))
    sc.parse_scene()
    p = os.path.join(out_dir, "lit_game.gltf")
    sc.save(p)
    return p


_VOLUME = {"thicknessFactor": 1.0, "attenuationColor": [0.9, 0.6, 0.4], "attenuationDistance": 1.0}
MATERIALS_STANDIN = [
    {"name": "scatter_glass", "pbrMetallicRoughness": {"roughnessFactor": 0.0, "metallicFactor": 0.0},
     "extensions": {"KHR_materials_transmission": {"transmissionFactor": 1.0},
                    "KHR_materials_ior": {"ior": 1.45}, "KHR_materials_volume": _VOLUME,
                    "KHR_materials_volume_scatter": {"multiscatterColor": [0.6, 0.7, 0.9],
                                                     "scatterAnisotropy": 0.3}}},
    {"name": "dispersive_glass", "pbrMetallicRoughness": {"roughnessFactor": 0.0, "metallicFactor": 0.0},
     "extensions": {"KHR_materials_transmission": {"transmissionFactor": 1.0},
                    "KHR_materials_ior": {"ior": 1.52}, "KHR_materials_dispersion": {"dispersion": 0.25},
                    "KHR_materials_volume": {"thicknessFactor": 0.5, "attenuationColor": [0.95, 0.95, 0.9],
                                             "attenuationDistance": 2.0}}},
    {"name": "rough_glass", "pbrMetallicRoughness": {"roughnessFactor": 0.3, "metallicFactor": 0.0,
                                                     "baseColorFactor": [0.8, 0.95, 0.9, 1.0]},
     "extensions": {"KHR_materials_transmission": {"transmissionFactor": 0.9}}},
    {"name": "clearcoat", "pbrMetallicRoughness": {"baseColorFactor": [0.7, 0.1, 0.05, 1.0],
                                                   "roughnessFactor": 0.5, "metallicFactor": 0.0},
     "extensions": {"KHR_materials_clearcoat": {"clearcoatFactor": 1.0, "clearcoatRoughnessFactor": 0.08}}},
    {"name": "iridescent", "pbrMetallicRoughness": {"baseColorFactor": [0.2, 0.2, 0.2, 1.0],
                                                    "roughnessFactor": 0.15, "metallicFactor": 1.0},
     "extensions": {"KHR_materials_iridescence": {"iridescenceFactor": 1.0, "iridescenceIor": 1.8,
                                                  "iridescenceThicknessMaximum": 500.0}}},
    {"name": "sheen", "pbrMetallicRoughness": {"baseColorFactor": [0.2, 0.1, 0.3, 1.0],
                                               "roughnessFactor": 0.8, "metallicFactor": 0.0},
     "extensions": {"KHR_materials_sheen": {"sheenColorFactor": [0.9, 0.7, 0.8], "sheenRoughnessFactor": 0.5}}},
    {"name": "anisotropic", "pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.8, 0.6, 1.0],
                                                     "roughnessFactor": 0.4, "metallicFactor": 1.0},
     "extensions": {"KHR_materials_anisotropy": {"anisotropyStrength": 0.6, "anisotropyRotation": 0.5}}},
    {"name": "leaf", "pbrMetallicRoughness": {"baseColorFactor": [0.3, 0.6, 0.2, 1.0],
                                              "roughnessFactor": 0.4, "metallicFactor": 0.0},
     "extensions": {"KHR_materials_diffuse_transmission": {"diffuseTransmissionFactor": 0.6,
                                                           "diffuseTransmissionColorFactor": [0.9, 0.5, 0.2]},
                    "KHR_materials_specular": {"specularFactor": 0.5,
                                               "specularColorFactor": [1.0, 0.9, 0.8]}}},
    {"name": "unlit", "pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.9, 0.3, 1.0]},
     "extensions": {"KHR_materials_unlit": {}}},
]


def make_materials_standin(out_dir) -> str:
    """Write materials.gltf: a rough board with a 3 x 3 grid of spheres, one
    MATERIALS_STANDIN material each, and add_standin_lights."""
    sc = _empty_scene()
    ed = SceneEditor(sc)
    m = sc.model
    m.materials.append({"name": "board", "pbrMetallicRoughness": {
        "baseColorFactor": [0.5, 0.5, 0.55, 1.0], "roughnessFactor": 0.6, "metallicFactor": 0.0}})
    board = ed.add_primitive("plane", name="board", material=0)
    ed.set_scale(board, [3.0, 1.0, 3.0])
    for i, mat in enumerate(MATERIALS_STANDIN):
        m.materials.append(json.loads(json.dumps(mat)))
        nid = ed.add_primitive("sphere", segments=24, name=mat["name"], material=len(m.materials) - 1)
        ed.set_translation(nid, [(i % 3 - 1) * 1.3, 0.5, (i // 3 - 1) * 1.3])
        ed.set_scale(nid, [0.5, 0.5, 0.5])
    add_standin_lights(ed)
    sc.parse_scene()
    p = os.path.join(out_dir, "materials.gltf")
    sc.save(p)
    return p


def make_brainstem(out_dir) -> str:
    """A 2-bone skinned column and a looping rotation clip (reference
    tools/baseline_standins.make_brainstem); writes brainstem.gltf and
    brainstem.bin into out_dir and returns the .gltf path."""
    h, r, seg = 2.0, 0.4, 16
    ang = np.linspace(0, 2 * np.pi, seg, endpoint=False)
    ring = np.stack([np.cos(ang) * r, np.zeros(seg), np.sin(ang) * r], axis=1)
    pos = np.concatenate([ring, ring + [0, h / 2, 0], ring + [0, h, 0]]).astype(np.float32)
    idx = []
    for lvl in range(2):
        b0, b1 = lvl * seg, (lvl + 1) * seg
        for i in range(seg):
            j = (i + 1) % seg
            idx += [b0 + i, b0 + j, b1 + i, b0 + j, b1 + j, b1 + i]
    idx = np.asarray(idx, np.uint16)
    w_top = np.clip(pos[:, 1] / h, 0, 1)
    joints = np.zeros((pos.shape[0], 4), np.uint16)
    joints[:, 1] = 1
    weights = np.zeros((pos.shape[0], 4), np.float32)
    weights[:, 0] = 1 - w_top
    weights[:, 1] = w_top
    ibm = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    ibm[1, 1, 3] = -h  # joint 1 binds at the top
    ibm = ibm.transpose(0, 2, 1).copy()  # column-major on disk
    times = np.array([0.0, 1.0, 2.0], np.float32)
    s2 = float(np.sqrt(0.5))
    rots = np.array([[0, 0, 0, 1], [0, 0, s2, s2], [0, 0, 0, 1]], np.float32)

    buf = b"".join(a.tobytes() for a in (pos, idx, joints, weights, ibm, times, rots))
    views, accs, off = [], [], 0

    def add(arr, ctype, atype, **kw):
        nonlocal off
        views.append({"buffer": 0, "byteOffset": off, "byteLength": arr.nbytes})
        accs.append({"bufferView": len(views) - 1, "componentType": ctype,
                     "count": arr.shape[0], "type": atype, **kw})
        off += arr.nbytes
        return len(accs) - 1

    a_p = add(pos, 5126, "VEC3", min=pos.min(0).tolist(), max=pos.max(0).tolist())
    a_i = add(idx.reshape(-1, 1), 5123, "SCALAR")
    a_j = add(joints, 5123, "VEC4")
    a_w = add(weights, 5126, "VEC4")
    a_m = add(ibm, 5126, "MAT4")
    a_t = add(times.reshape(-1, 1), 5126, "SCALAR", min=[0.0], max=[2.0])
    a_r = add(rots, 5126, "VEC4")

    gltf = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": [
            {"name": "column", "mesh": 0, "skin": 0},
            {"name": "j_base", "children": [2]},
            {"name": "j_top", "translation": [0, h, 0]},
        ],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": a_p, "JOINTS_0": a_j, "WEIGHTS_0": a_w},
            "indices": a_i, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.75, 0.6, 0.5, 1.0], "roughnessFactor": 0.6,
            "metallicFactor": 0.0}, "doubleSided": True}],
        "skins": [{"joints": [1, 2], "inverseBindMatrices": a_m}],
        "animations": [{
            "name": "sway",
            "samplers": [{"input": a_t, "output": a_r, "interpolation": "LINEAR"}],
            "channels": [{"sampler": 0, "target": {"node": 2, "path": "rotation"}}],
        }],
        "accessors": accs,
        "bufferViews": views,
        "buffers": [{"uri": "brainstem.bin", "byteLength": len(buf)}],
    }
    with open(os.path.join(out_dir, "brainstem.bin"), "wb") as f:
        f.write(buf)
    p = os.path.join(out_dir, "brainstem.gltf")
    with open(p, "w") as f:
        json.dump(gltf, f)
    return p


def _write_gltf(out_dir, name, gltf, arrays, images=()) -> str:
    """Write name.gltf and name.bin into out_dir: `arrays` are (array,
    componentType, type) accessors in order, each in a bufferView of its
    own, and `images` PNG byte strings, each in a bufferView after them.
    gltf holds the rest of the document. Returns the .gltf path."""
    views, accs, chunks, off = [], [], [], 0
    for arr, ctype, atype in arrays:
        arr = np.ascontiguousarray(arr)
        extra = {"min": arr.min(0).tolist(), "max": arr.max(0).tolist()} if atype == "VEC3" else {}
        views.append({"buffer": 0, "byteOffset": off, "byteLength": arr.nbytes})
        accs.append({"bufferView": len(views) - 1, "componentType": ctype, "count": arr.shape[0],
                     "type": atype, **extra})
        chunks.append(arr.tobytes())
        off += arr.nbytes
    for png in images:
        pad = -off % 4
        chunks.append(b"\0" * pad)
        off += pad
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(png)})
        gltf.setdefault("images", []).append({"bufferView": len(views) - 1, "mimeType": "image/png"})
        chunks.append(png)
        off += len(png)
    buf = b"".join(chunks)
    gltf.update(asset={"version": "2.0"}, accessors=accs, bufferViews=views,
                buffers=[{"uri": name + ".bin", "byteLength": len(buf)}])
    with open(os.path.join(out_dir, name + ".bin"), "wb") as f:
        f.write(buf)
    p = os.path.join(out_dir, name + ".gltf")
    with open(p, "w") as f:
        json.dump(gltf, f)
    return p


def make_masked_quads(out_dir, alpha_mode="MASK", cutoff=0.5) -> str:
    """tests/test_omm.py's make_masked_quads, written into out_dir as
    masked_quads.gltf (+ .bin with the PNG): three separate triangles over a
    16x16 texture whose left half has alpha 1 and right half alpha 0; tri 0
    maps into the left half (OPAQUE), tri 1 into the right (TRANSPARENT),
    tri 2 across the seam (MIXED). Returns the .gltf path."""
    from .utils.png import encode_png

    tex = np.zeros((16, 16, 4), np.uint8)
    tex[:, :, 0] = 255
    tex[:, :8, 3] = 255  # left half opaque
    positions = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [2, 0, 0], [3, 0, 0], [2, 1, 0],
                          [4, 0, 0], [5, 0, 0], [4, 1, 0]], np.float32)
    uvs = np.array([[0.05, 0.1], [0.30, 0.1], [0.05, 0.9], [0.70, 0.1], [0.95, 0.1], [0.70, 0.9],
                    [0.30, 0.1], [0.70, 0.1], [0.30, 0.9]], np.float32)
    gltf = {
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1}, "indices": 2,
                                    "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}},
                       "alphaMode": alpha_mode, "alphaCutoff": cutoff}],
        "textures": [{"source": 0}],
    }
    return _write_gltf(out_dir, "masked_quads", gltf,
                       [(positions, 5126, "VEC3"), (uvs, 5126, "VEC2"),
                        (np.arange(9, dtype=np.uint16), 5123, "SCALAR")],
                       images=[encode_png(tex)])



def make_sliver_soup(out_dir, n=1500, seed=7) -> str:
    """n long thin triangles in a 10-unit cube (tests/test_bvh.py's
    spatial-split scene): one edge of 4 to 8 units along a random axis and
    one of at most 0.2, so the object-split children overlap and
    VKGR_BVH=sbvh duplicates references. One mesh, one grey material.
    Writes sliver_soup.gltf (+ .bin) into out_dir and returns its path."""
    rng = np.random.RandomState(seed)
    v0 = rng.rand(n, 3) * 10
    e_long = np.zeros((n, 3))
    e_long[np.arange(n), rng.randint(0, 3, n)] = 4.0 + rng.rand(n) * 4.0
    e_small = rng.rand(n, 3) * 0.2
    positions = np.stack([v0, v0 + e_long, v0 + e_small], axis=1).reshape(-1, 3).astype(np.float32)
    gltf = {
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorFactor": [0.7, 0.7, 0.7, 1.0],
                                                "metallicFactor": 0.0, "roughnessFactor": 0.6}}],
    }
    return _write_gltf(out_dir, "sliver_soup", gltf, [(positions, 5126, "VEC3")])

FOLIAGE_ATLAS = 256  # the leaf atlas' side, texels: four 128-texel quadrants
FOLIAGE_RAMP = 8  # texels over which the leaf's alpha falls from 1 to 0 at its edge
# quadrant -> (u0, v0) of its corner in the atlas, and its share of the cards
FOLIAGE_QUADRANTS = {"leaf": ((0.0, 0.0), 0.7), "bark": ((0.5, 0.0), 0.1), "empty": ((0.0, 0.5), 0.1),
                     "gradient": ((0.5, 0.5), 0.1)}


def foliage_atlas(seed=0) -> np.ndarray:
    """The foliage stand-in's RGBA atlas [256,256,4] uint8. Quadrants (u
    right, v down): an elliptical leaf whose alpha ramps from 1 to 0 over
    the 8 texels inside its edge (MIXED, split into cells), solid bark
    (OPAQUE), empty (TRANSPARENT, culled) and alpha rising from 0 to 1
    left to right (the BLEND material's)."""
    rng = np.random.default_rng(seed)
    q = FOLIAGE_ATLAS // 2
    y, x = np.mgrid[0:q, 0:q] + 0.5
    rx, ry = 0.36 * q, 0.26 * q
    d = np.sqrt(((x - q / 2) / rx) ** 2 + ((y - q / 2) / ry) ** 2)
    leaf_a = np.clip((1.0 - d) * ry / FOLIAGE_RAMP, 0.0, 1.0)
    green = np.array([0.22, 0.55, 0.16]) * (0.85 + 0.3 * rng.random((q, q, 1)))
    img = np.zeros((FOLIAGE_ATLAS, FOLIAGE_ATLAS, 4))
    img[:q, :q, :3], img[:q, :q, 3] = green, leaf_a
    img[:q, q:, :3], img[:q, q:, 3] = np.array([0.36, 0.25, 0.16]) * (0.8 + 0.4 * rng.random((q, q, 1))), 1.0
    img[q:, :q, :3] = 0.5
    img[q:, q:, :3], img[q:, q:, 3] = np.array([0.85, 0.6, 0.25]), x / q - 0.5 / q
    return np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def make_foliage_standin(out_dir, cards=16384, seed=0) -> str:
    """Write foliage.gltf (+ .bin with the atlas PNG) into out_dir: an opaque
    ground, `cards` leaf cards (a quad of 2 triangles each, centres, sizes
    and orientations from `seed` in a canopy 6 x 2 x 6 units above the
    ground) mapped each onto one quadrant of foliage_atlas with the shares
    of FOLIAGE_QUADRANTS, and 8 vertical BLEND panes (baseColorFactor alpha
    0.35) in a ring around the canopy's foot, and a camera in front of it.
    The leaf, bark and empty cards take a MASK material (cutoff 0.5), the
    gradient cards a BLEND one on the same atlas; both are double-sided.
    Returns the .gltf path."""
    from .utils.png import encode_png

    rng = np.random.default_rng(seed)
    names = list(FOLIAGE_QUADRANTS)
    quad = rng.choice(len(names), size=cards, p=[FOLIAGE_QUADRANTS[k][1] for k in names])
    centre = rng.uniform([-3.0, 1.0, -3.0], [3.0, 3.0, 3.0], size=(cards, 3))
    half = rng.uniform(0.12, 0.3, size=(cards, 1))
    # an orthonormal frame a card: a random normal and a random direction in its plane
    nrm = rng.normal(size=(cards, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    ref = np.where(np.abs(nrm[:, 1:2]) < 0.9, [[0.0, 1.0, 0.0]], [[1.0, 0.0, 0.0]])
    ax_u = np.cross(ref, nrm)
    ax_u /= np.linalg.norm(ax_u, axis=1, keepdims=True)
    ax_v = np.cross(nrm, ax_u)
    ang = rng.uniform(0.0, 2.0 * np.pi, size=(cards, 1))
    ax_u, ax_v = np.cos(ang) * ax_u + np.sin(ang) * ax_v, -np.sin(ang) * ax_u + np.cos(ang) * ax_v
    corners = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])
    pos = (centre[:, None] + half[:, None] * (corners[None, :, 0:1] * ax_u[:, None]
                                               + corners[None, :, 1:2] * ax_v[:, None]))
    inset = 2.0 / FOLIAGE_ATLAS  # keeps a quadrant's bilinear taps inside it
    uv0 = np.array([FOLIAGE_QUADRANTS[k][0] for k in names])[quad]
    uv = uv0[:, None] + inset + (corners[None] * 0.5 + 0.5) * (0.5 - 2.0 * inset)

    def card_mesh(sel):
        k = int(sel.sum())
        idx = (np.arange(k)[:, None] * 4 + np.array([0, 1, 2, 0, 2, 3])).reshape(-1)
        return (pos[sel].reshape(-1, 3).astype(np.float32), np.repeat(nrm[sel], 4, axis=0).astype(np.float32),
                uv[sel].reshape(-1, 2).astype(np.float32), idx.astype(np.uint32))

    def quads(c, a, b):
        """Quads centred at c [k,3] with half-axes a, b [k,3]: (pos, nrm, uv, idx)."""
        p = c[:, None] + corners[None, :, 0:1] * a[:, None] + corners[None, :, 1:2] * b[:, None]
        n = np.cross(a, b)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        k = c.shape[0]
        idx = (np.arange(k)[:, None] * 4 + np.array([0, 1, 2, 0, 2, 3])).reshape(-1)
        return (p.reshape(-1, 3).astype(np.float32), np.repeat(n, 4, axis=0).astype(np.float32),
                np.tile(corners * 0.5 + 0.5, (k, 1)).astype(np.float32), idx.astype(np.uint32))

    phi = np.arange(8) * (np.pi / 4.0)
    ring = np.stack([np.cos(phi), np.zeros(8), np.sin(phi)], axis=1)
    meshes = [
        quads(np.zeros((1, 3)), np.array([[6.0, 0.0, 0.0]]), np.array([[0.0, 0.0, -6.0]])),  # ground
        card_mesh(quad != names.index("gradient")),
        card_mesh(quad == names.index("gradient")),
        quads(ring * 4.0 + [0.0, 0.6, 0.0], np.cross(ring, [0.0, 1.0, 0.0]) * 0.5,
              np.tile([[0.0, 0.6, 0.0]], (8, 1))),  # panes
    ]
    arrays, prims = [], []
    for material, (p, n, t, i) in enumerate(meshes):
        a = len(arrays)
        arrays += [(p, 5126, "VEC3"), (n, 5126, "VEC3"), (t, 5126, "VEC2"), (i, 5125, "SCALAR")]
        prims.append({"attributes": {"POSITION": a, "NORMAL": a + 1, "TEXCOORD_0": a + 2}, "indices": a + 3,
                      "material": material})
    pitch = np.radians(-8.0) / 2.0  # the camera looks down the -z axis, tilted 8 degrees down
    gltf = {
        "scene": 0,
        "scenes": [{"nodes": [0, 1, 2, 3, 4]}],
        "nodes": [{"name": name, "mesh": k} for k, name in enumerate(("ground", "leaves", "gradient", "panes"))]
        + [{"name": "camera", "camera": 0, "translation": [0.0, 1.9, 6.0],
            "rotation": [float(np.sin(pitch)), 0.0, 0.0, float(np.cos(pitch))]}],
        "cameras": [{"type": "perspective", "perspective": {"yfov": 0.9, "aspectRatio": 16 / 9, "znear": 0.05,
                                                             "zfar": 100.0}}],
        "meshes": [{"name": name, "primitives": [prim]}
                   for name, prim in zip(("ground", "leaves", "gradient", "panes"), prims)],
        "materials": [
            {"name": "ground", "pbrMetallicRoughness": {"baseColorFactor": [0.35, 0.3, 0.24, 1.0],
                                                        "roughnessFactor": 0.9, "metallicFactor": 0.0}},
            {"name": "leaves", "alphaMode": "MASK", "alphaCutoff": 0.5, "doubleSided": True,
             "pbrMetallicRoughness": {"baseColorTexture": {"index": 0}, "roughnessFactor": 0.7,
                                      "metallicFactor": 0.0}},
            {"name": "gradient", "alphaMode": "BLEND", "doubleSided": True,
             "pbrMetallicRoughness": {"baseColorTexture": {"index": 0}, "roughnessFactor": 0.6,
                                      "metallicFactor": 0.0}},
            {"name": "panes", "alphaMode": "BLEND", "doubleSided": True,
             "pbrMetallicRoughness": {"baseColorFactor": [0.6, 0.8, 0.9, 0.35], "roughnessFactor": 0.1,
                                      "metallicFactor": 0.0}},
        ],
        "samplers": [{"wrapS": 10497, "wrapT": 10497}],
        "textures": [{"source": 0, "sampler": 0}],
    }
    return _write_gltf(out_dir, "foliage", gltf, arrays, images=[encode_png(foliage_atlas(seed))])


def _patch_mesh(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """One displaced-terrain patch: (n x n) quad grid -> 2*(n-1)^2 triangles."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-0.5, 0.5, n, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    # a few random sinusoids -> non-degenerate, BVH-unfriendly-enough terrain
    gy = np.zeros_like(gx)
    for _ in range(4):
        fx, fz = rng.uniform(2.0, 9.0, size=2)
        ph = rng.uniform(0, 2 * np.pi, size=2)
        gy += rng.uniform(0.02, 0.08) * np.sin(fx * gx * 2 * np.pi + ph[0]) * np.cos(
            fz * gz * 2 * np.pi + ph[1]
        )
    pos = np.stack([gx, gy.astype(np.float32), gz], axis=-1).reshape(-1, 3)
    i = np.arange(n * n, dtype=np.uint32).reshape(n, n)
    a, b, c, d = i[:-1, :-1], i[1:, :-1], i[:-1, 1:], i[1:, 1:]
    tris = np.concatenate(
        [np.stack([a, b, d], -1).reshape(-1, 3), np.stack([a, d, c], -1).reshape(-1, 3)]
    )
    return pos, tris.astype(np.uint32).reshape(-1)


def write_large_glb(path: str, target_tris: int = 1_050_000, grid: int = 8) -> int:
    """Grid of grid x grid instances of one patch mesh; returns world tris."""
    per_inst = target_tris // (grid * grid)
    n = int(np.sqrt(per_inst / 2)) + 2  # 2*(n-1)^2 >= per_inst approx
    pos, idx = _patch_mesh(n)
    tris_per = len(idx) // 3
    world_tris = tris_per * grid * grid

    pos_b = pos.tobytes()
    idx_b = idx.tobytes()
    bin_chunk = pos_b + idx_b
    nodes = []
    for gi in range(grid):
        for gj in range(grid):
            nodes.append(
                {
                    "mesh": 0,
                    "translation": [float(gi - grid / 2 + 0.5) * 1.1, 0.0,
                                    float(gj - grid / 2 + 0.5) * 1.1],
                }
            )
    gltf = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1,
                                    "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.7, 0.68, 0.62, 1.0], "roughnessFactor": 0.8}}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(pos), "type": "VEC3",
             "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
            {"bufferView": 1, "componentType": 5125, "count": len(idx), "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(pos_b)},
            {"buffer": 0, "byteOffset": len(pos_b), "byteLength": len(idx_b)},
        ],
        "buffers": [{"byteLength": len(bin_chunk)}],
    }
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    bin_chunk += b"\0" * (-len(bin_chunk) % 4)
    total = 12 + 8 + len(js) + 8 + len(bin_chunk)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942) + bin_chunk)
    return world_tris


# ------------------------------------------------------------------ texture containers
# The helmet's base colour in every container the port decodes (phase 20 of chip_smoke.py, the
# codec tests): a seeded image and writers for DDS (BGRA8, BC1), KTX2 (RGBA8, zlib, BasisLZ/ETC1S,
# UASTC, ASTC 4x4) and JPEG (ops/jpeg.encode_jpeg). The block encoders are simple (BC1: the
# block's per-channel min and max as endpoints; ETC1S: the block's mean colour and the best of
# the eight intensity tables; ASTC: one partition, CEM 8 with the per-channel min and max, a
# 4x4 grid of 12-level weights): they make valid files of a real image, not good ones.


def texture_image(n=2048, seed=0) -> np.ndarray:
    """A seeded RGB texture [n,n,3] uint8: smooth colour waves over a
    checker of 64-texel cells, with per-texel noise (the kind of content
    a base-colour map holds, so that a lossy codec has edges and gradients
    to keep)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    ph = rng.random(3).astype(np.float32) * 6.0
    img = np.stack([128 + 80 * np.sin(x / 53 + ph[0]) * np.cos(y / 41),
                    128 + 70 * np.sin((x + y) / 97 + ph[1]),
                    128 + 60 * np.cos(x / 29 - y / 71 + ph[2])], axis=-1)
    img += np.where((((x // 64) + (y // 64)) % 2 == 0)[..., None], 25.0, -25.0)
    img += rng.normal(0.0, 6.0, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def _rgba(img) -> np.ndarray:
    img = np.asarray(img, np.uint8)
    if img.shape[-1] == 4:
        return img
    return np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1)


def _dds_header(w, h, pf_flags, fourcc=b"\0\0\0\0", masks=(0, 0, 0, 0, 0)) -> bytes:
    head = b"DDS " + struct.pack("<I", 124) + struct.pack("<3I", 0x1007, h, w)
    head += b"\0" * (72 - 16)
    head += struct.pack("<2I4s", 32, pf_flags, fourcc) + struct.pack("<5I", *masks)
    return head + b"\0" * (128 - len(head))


def dds_bgra8(img) -> bytes:
    """An uncompressed 32-bit BGRA DDS file of an RGB(A) uint8 image."""
    rgba = _rgba(img)
    h, w = rgba.shape[:2]
    masks = (32, 0x00FF0000, 0x0000FF00, 0x000000FF, 0xFF000000)
    return _dds_header(w, h, 0x41, masks=masks) + rgba[..., [2, 1, 0, 3]].tobytes()


def bc1_blocks(img) -> bytes:
    """BC1 blocks of an RGB(A) uint8 image (sides multiples of 4): each
    block's per-channel max and min as the two 565 endpoints (four-colour
    mode), every texel the nearest of the four palette colours."""
    rgb = np.asarray(img, np.uint8)[..., :3].astype(np.int32)
    h, w = rgb.shape[:2]
    blk = rgb.reshape(h // 4, 4, w // 4, 4, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 3)

    def to565(c):
        return ((c[..., 0] * 31 + 127) // 255 << 11) | ((c[..., 1] * 63 + 127) // 255 << 5) | (
            (c[..., 2] * 31 + 127) // 255)

    def from565(c):
        return np.stack([((c >> 11) & 31) * 255 // 31, ((c >> 5) & 63) * 255 // 63, (c & 31) * 255 // 31], -1)

    c0, c1 = to565(blk.max(axis=1)), to565(blk.min(axis=1))
    swap = c0 < c1
    c0, c1 = np.where(swap, c1, c0), np.where(swap, c0, c1)
    p0, p1 = from565(c0), from565(c1)
    pal = np.stack([p0, p1, (2 * p0 + p1) // 3, (p0 + 2 * p1) // 3], axis=1)  # [N,4,3]
    err = ((blk[:, :, None, :] - pal[:, None, :, :]) ** 2).sum(-1)  # [N,16,4]
    idx = np.where((c0 == c1)[:, None], 0, err.argmin(-1)).astype(np.uint64)
    bits = (idx << (2 * np.arange(16, dtype=np.uint64))).sum(axis=1)
    words = c0.astype(np.uint64) | (c1.astype(np.uint64) << 16) | (bits << 32)
    return words.astype("<u8").tobytes()


def dds_bc1(img) -> bytes:
    """A DXT1 (BC1) DDS file of an RGB(A) uint8 image (bc1_blocks)."""
    h, w = np.asarray(img).shape[:2]
    return _dds_header(w, h, 0x4, b"DXT1") + bc1_blocks(img)


def _ktx2(vk_format, w, h, scheme, level0, level_len_uncompressed, color_model=0, sgd=b"") -> bytes:
    """A one-level KTX2 file with a minimal data format descriptor."""
    from .ops.dds import KTX2_MAGIC

    dfd_block = bytearray(24 + 16)
    struct.pack_into("<HH", dfd_block, 4, 2, len(dfd_block))
    dfd_block[8] = color_model
    dfd = struct.pack("<I", 4 + len(dfd_block)) + bytes(dfd_block)
    dfd_off = 80 + 24
    sgd_off = dfd_off + len(dfd)
    pad = -sgd_off % 8
    sgd_off += pad
    level_off = sgd_off + len(sgd)
    out = KTX2_MAGIC + struct.pack("<9I", vk_format, 1, w, h, 0, 0, 1, 1, scheme)
    out += struct.pack("<4I", dfd_off, len(dfd), 0, 0)
    out += struct.pack("<2Q", sgd_off if sgd else 0, len(sgd))
    out += struct.pack("<3Q", level_off, len(level0), level_len_uncompressed)
    return out + dfd + b"\0" * pad + sgd + level0


def ktx2_rgba8(img, zlib_level=None) -> bytes:
    """A KTX2 R8G8B8A8_SRGB file, its level zlib-supercompressed when
    zlib_level is given."""
    import zlib

    rgba = _rgba(img)
    h, w = rgba.shape[:2]
    raw = rgba.tobytes()
    if zlib_level is None:
        return _ktx2(43, w, h, 0, raw, len(raw))
    return _ktx2(43, w, h, 3, zlib.compress(raw, zlib_level), len(raw))


def ktx2_etc1s(img) -> bytes:
    """A BasisLZ/ETC1S KTX2 file of an RGB uint8 image (sides multiples
    of 4): one codebook endpoint and one selector row set a block, written
    by the port's copy of the reference's encoders (ops/basisu.py)."""
    from .ops import basisu

    rgb = np.asarray(img, np.uint8)[..., :3].astype(np.int32)
    h, w = rgb.shape[:2]
    nby, nbx = h // 4, w // 4
    blk = rgb.reshape(nby, 4, nbx, 4, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 3)
    color5 = np.clip((blk.mean(axis=1) * 31 / 255 + 0.5).astype(np.int32), 0, 31)
    base = (color5 << 3) | (color5 >> 2)  # [N,3]
    cand = np.clip(base[:, None, None, :] + basisu.ETC1_INTEN[None, :, :, None], 0, 255)  # [N,8,4,3]
    err = ((blk[:, :, None, None, :] - cand[:, None]) ** 2).sum(-1)  # [N,16,8,4]
    sel = err.argmin(-1)  # [N,16,8]
    inten = np.take_along_axis(err, sel[..., None], -1)[..., 0].sum(1).argmin(-1)  # [N]
    sel = sel[np.arange(sel.shape[0]), :, inten].reshape(-1, 4, 4)
    rows = (sel << (2 * np.arange(4))).sum(-1).astype(np.uint8)  # [N,4]: a row's 4 selectors
    # the codebooks: the distinct endpoints and selector row sets (a Huffman alphabet holds at
    # most 2^14 - 1 symbols, so a side of at most 504 texels always fits)
    ends, eidx = np.unique(np.concatenate([color5, inten[:, None]], axis=1), axis=0, return_inverse=True)
    sels, sidx = np.unique(rows, axis=0, return_inverse=True)
    ne, ns = ends.shape[0], sels.shape[0]
    if max(ne, ns) >= (1 << basisu.MAX_SYMS_LOG2) - 1:
        raise ValueError(f"ETC1S codebooks of {ne} endpoints and {ns} selectors do not fit")
    endpoints = basisu.encode_endpoints(ends[:, :3], ends[:, 3])
    selectors = basisu.encode_selectors(sels)
    tables = basisu.encode_tables(ne, ns)
    level0 = basisu.encode_slice(eidx.reshape(nby, nbx), sidx.reshape(nby, nbx), ne, ns)
    sgd = struct.pack("<HHIIII", ne, ns, len(endpoints), len(selectors), len(tables), 0)
    sgd += struct.pack("<IIIII", 0, 0, len(level0), 0, 0) + endpoints + selectors + tables
    return _ktx2(0, w, h, 1, level0, len(level0), color_model=163, sgd=sgd)


def astc_4x4_blocks(img) -> bytes:
    """ASTC 4x4 LDR blocks of an RGB uint8 image (sides multiples of 4):
    one partition, CEM 8 (RGB direct) with the block's per-channel min and
    max as endpoints, a full 4x4 grid of 12-level weights (each texel's
    projection on the endpoint axis), packed by the port's copy of the
    reference's encoder (ops/astc.encode_block)."""
    from .ops import astc

    wlevels = 12
    clevels = astc.color_levels_for_config(4, 4, wlevels, 1, 6)
    cq = [astc.quantize_color(v, clevels) for v in range(256)]
    wq = [astc.quantize_weight(v, wlevels) for v in range(65)]
    rgb = np.asarray(img, np.uint8)[..., :3].astype(np.float64)
    h, w = rgb.shape[:2]
    blk = rgb.reshape(h // 4, 4, w // 4, 4, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 3)
    lo, hi = blk.min(axis=1), blk.max(axis=1)
    axis = hi - lo
    t = ((blk - lo[:, None]) * axis[:, None]).sum(-1) / np.maximum((axis * axis).sum(-1), 1e-9)[:, None]
    wts = np.clip(np.rint(t * 64), 0, 64).astype(np.int64)
    lo_i, hi_i = lo.astype(np.int64), hi.astype(np.int64)
    out = []
    for b in range(blk.shape[0]):
        cvals = [cq[v] for pair in zip(lo_i[b], hi_i[b]) for v in pair]  # r0 r1 g0 g1 b0 b1
        out.append(astc.encode_block(4, 4, wlevels, [wq[v] for v in wts[b]], [8], cvals))
    return b"".join(out)


def ktx2_astc(blocks: bytes, w, h, uastc=False) -> bytes:
    """A KTX2 file of ASTC 4x4 blocks: VK_FORMAT_ASTC_4x4_SRGB_BLOCK, or
    vkFormat 0 with the UASTC colour model (whose LDR 4x4 payload is a
    stream of ASTC blocks) when uastc is set."""
    if uastc:
        return _ktx2(0, w, h, 0, blocks, len(blocks), color_model=166)
    return _ktx2(158, w, h, 0, blocks, len(blocks))


# glTF texture extension of each container's images
_TEXTURE_EXTENSION = {".dds": "MSFT_texture_dds", ".ktx2": "KHR_texture_basisu",
                      ".webp": "EXT_texture_webp"}


def _png_filter(rows: np.ndarray, bpp: int, ft: np.ndarray) -> np.ndarray:
    """Raw rows [h, stride] uint8 -> filtered rows [h, 1 + stride], row y
    with filter type ft[y] (0-4), each filter computed from the raw bytes
    on the rows that use it, all at once."""
    h, stride = rows.shape
    out = np.empty((h, stride + 1), np.uint8)
    out[:, 0] = ft
    for f in range(5):
        sel = np.flatnonzero(ft == f)
        if not len(sel):
            continue
        x = rows[sel].astype(np.int16)
        if f == 0:
            out[sel, 1:] = rows[sel]
            continue
        a = np.zeros_like(x)
        a[:, bpp:] = x[:, :-bpp]
        b = rows[sel - 1].astype(np.int16) * (sel > 0)[:, None] if f != 1 else None
        if f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) >> 1
        else:
            c = np.zeros_like(x)
            c[:, bpp:] = b[:, :-bpp]
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out[sel, 1:] = (x - pred).astype(np.uint8)
    return out


def png_file(samples, bits: int, ctype: int, interlace: bool = False, palette=None, trns: bytes | None = None,
             filters=0, level: int = 6, before_idat: bytes = b"") -> bytes:
    """A PNG of any bit depth and colour type PNG allows: samples [h, w,
    channels] (or [h, w]) of values below 2^bits; colour type 0 gray, 2
    RGB, 3 palette (palette [n, 3] uint8, PLTE), 4 gray+alpha, 6 RGBA;
    Adam7 when interlace; trns the tRNS chunk's bytes; filters one type
    (0-4) or a sequence cycled over each pass's rows; before_idat chunks
    (whole, with their CRCs) put before the image data."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, nsamp = s.shape
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
              (0, 1, 1, 2)) if interlace else ((0, 0, 1, 1),)
    bpp = max(1, bits * nsamp // 8)
    cycle = np.atleast_1d(np.asarray(filters, np.int64))
    data = []
    for x0, y0, dx, dy in passes:
        sub = s[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        ph, pw = sub.shape[:2]
        if bits == 16:
            rows = sub.astype(">u2").view(np.uint8).reshape(ph, -1)
        elif bits == 8:
            rows = sub.astype(np.uint8).reshape(ph, -1)
        else:
            fields = np.unpackbits(sub.astype(np.uint8).reshape(ph, pw, 1), axis=2)[..., 8 - bits:]
            rows = np.packbits(fields.reshape(ph, -1), axis=1)
        data.append(_png_filter(rows, bpp, cycle[np.arange(ph) % len(cycle)]))

    def chunk(cid, body):
        return struct.pack(">I", len(body)) + cid + body + struct.pack(">I", zlib.crc32(cid + body) & 0xFFFFFFFF)

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    raw = b"".join(d.tobytes() for d in data)
    return out + before_idat + chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b"")


def blp2_file(w, h, encoding, alpha_depth, alpha_encoding, palette: bytes, mip0: bytes, compression=1) -> bytes:
    """A BLP2 file: the header, mip 0's offset and length, the 1024-byte
    BGRA palette (present whatever the encoding), mip 0 (indices for
    encoding 1, DXT blocks for encoding 2 with alpha encoding 0, 1 or 7)."""
    off = 20 + 128 + len(palette)
    return (b"BLP2" + struct.pack("<ibbbbII", compression, encoding, alpha_depth, alpha_encoding, 0, w, h)
            + struct.pack("<16I", off, *([0] * 15)) + struct.pack("<16I", len(mip0), *([0] * 15)) + palette + mip0)


def ftex_file(w, h, fmt, payload: bytes, nformats=1) -> bytes:
    """An FTEX file of one mip: format 0 (DXT1 blocks) or 1 (RGB bytes)."""
    head = b"FTEX" + struct.pack("<5i", 1, w, h, 1, nformats) + struct.pack("<2i", fmt, 32)
    return head + struct.pack("<i", len(payload)) + payload


def msp_file(white) -> bytes:
    """A version 2 ("LinS") Windows Paint file of a bool image [h, w]
    (True white): each row in packets of up to 128 bytes, a run (0, n,
    value) where the packet's bytes are equal, else a literal (n, bytes)."""
    white = np.asarray(white, bool)
    h, w = white.shape
    rows = np.packbits(white, axis=1)
    stride = rows.shape[1]
    packets = []  # per packet column: (run?, literal bytes [h, n + 1], run bytes [h, 3])
    for lo in range(0, stride, 128):
        p = rows[:, lo : lo + 128]
        n = p.shape[1]
        lit = np.concatenate([np.full((h, 1), n, np.uint8), p], axis=1)
        run = np.stack([np.zeros(h, np.uint8), np.full(h, n, np.uint8), p[:, 0]], axis=1)
        packets.append(((p == p[:, :1]).all(axis=1), lit, run))
    rowlen = sum(np.where(same, 3, lit.shape[1]) for same, lit, _ in packets)
    body = b"".join((run[y] if same[y] else lit[y]).tobytes() for y in range(h) for same, lit, run in packets)
    words = [*struct.unpack("<2H", b"LinS"), w, h, 1, 1, 1, 1, w, h, 0, 0, 0, 0, 0, 0]
    check = 0
    for v in words:
        check ^= v
    words[12] = check  # the header's words XOR to zero
    return struct.pack("<16H", *words) + np.asarray(rowlen, "<u2").tobytes() + body


def im_rgb_file(img) -> bytes:
    """An IM file ("RGB image", line-interleaved: each row's R, G and B
    runs, the bottom row first) of an RGB uint8 image, Pillow's header
    padded to 512 bytes."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    head = b"Image type: RGB image\r\nImage size (x*y): %d*%d\r\nFile size (no of images): 1\r\n" % (w, h)
    return head + b"\0" * (511 - len(head)) + b"\x1a" + img[::-1].transpose(0, 2, 1).tobytes()


def im_file(image_type: bytes, w: int, h: int, body: bytes) -> bytes:
    """An IM file of `image_type` ("YCC", "RGB3", "L*12", ...) whose pixel
    bytes are `body`, Pillow's header padded to 512 bytes."""
    head = b"Image type: %s image\r\nImage size (x*y): %d*%d\r\nFile size (no of images): 1\r\n" % (image_type, w, h)
    return head + b"\0" * (511 - len(head)) + b"\x1a" + body


def im_bits(values, bits: int) -> bytes:
    """IM "L*j" rows: each row of `values` [h, w] (bottom row first) packed
    LSB first into whole bytes, as Pillow's bit decoder reads them."""
    v = np.asarray(values, np.uint64)[::-1]
    h, w = v.shape
    bitplanes = ((v[..., None] >> np.arange(bits, dtype=np.uint64)) & 1).astype(np.uint8).reshape(h, w * bits)
    pad = -(w * bits) % 8
    bitplanes = np.concatenate([bitplanes, np.zeros((h, pad), np.uint8)], axis=1)
    return np.packbits(bitplanes, axis=1, bitorder="little").tobytes()


def pixar_file(img) -> bytes:
    """A PIXAR raster (the layout Pillow reads: 14, 2) of RGB uint8 [h, w, 3]."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, 14, 2)
    return bytes(head) + img.tobytes()


def spider_file(values, big_endian=True) -> bytes:
    """A SPIDER 2D image of float32 [h, w], its header as Pillow's
    makeSpiderHeader writes it (labrec records of 4w bytes)."""
    v = np.asarray(values, np.float32)
    h, w = v.shape
    lenbyt = 4 * w
    labrec = -(-1024 // lenbyt)
    hdr = np.zeros(max(labrec * lenbyt // 4, 27), np.float32)
    for i, x in ((1, 1), (2, h), (3, h), (5, 1), (12, w), (13, labrec), (22, labrec * lenbyt), (23, lenbyt)):
        hdr[i - 1] = x
    bo = ">" if big_endian else "<"
    return hdr[: labrec * lenbyt // 4].astype(bo + "f4").tobytes() + v.astype(bo + "f4").tobytes()


def _fits_cards(cards) -> bytes:
    out = b"".join((k.ljust(8) + ("= " + v if v is not None else "")).ljust(80).encode() for k, v in cards)
    out += b"END".ljust(80)
    return out + b" " * (-len(out) % 2880)


def fits_file(values, bitpix: int, gzip_tile=False) -> bytes:
    """A FITS image [h, w] (top row first in `values`, stored bottom row
    first, big-endian, as the standard stores it) of BITPIX 8, 16, 32, -32
    or -64; with gzip_tile a tile-compressed BINTABLE ('GZIP_1') of four
    bytes a sample."""
    import gzip

    v = np.asarray(values)
    h, w = v.shape
    dtype = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    if not gzip_tile:
        body = v[::-1].astype(dtype).tobytes()
        return (_fits_cards([("SIMPLE", "T"), ("BITPIX", str(bitpix)), ("NAXIS", "2"), ("NAXIS1", str(w)),
                             ("NAXIS2", str(h))]) + body + b"\0" * (-len(body) % 2880))
    primary = _fits_cards([("SIMPLE", "T"), ("BITPIX", "8"), ("NAXIS", "0")])
    table = _fits_cards([("XTENSION", "'BINTABLE'"), ("BITPIX", "8"), ("NAXIS", "2"), ("NAXIS1", "8"), ("NAXIS2", "1"),
                         ("PCOUNT", "0"), ("GCOUNT", "1"), ("ZIMAGE", "T"), ("ZCMPTYPE", "'GZIP_1  '"),
                         ("ZBITPIX", str(bitpix)), ("ZNAXIS", "2"), ("ZNAXIS1", str(w)), ("ZNAXIS2", str(h))])
    samples = v[::-1].astype(">i4" if bitpix > 0 else ">f4").tobytes()  # Pillow reverses the rows
    return primary + table + bytes(8) + gzip.compress(samples, 6, mtime=0)


def mcidas_file(values, nbytes: int, prefix=0) -> bytes:
    """A McIDAS area file of [h, w] samples of nbytes (1, 2 or 4) each,
    big-endian, each row after `prefix` bytes."""
    v = np.asarray(values)
    h, w = v.shape
    word = np.zeros(64, ">i4")
    word[1] = 4
    word[8], word[9], word[10], word[13], word[14], word[33] = h, w, nbytes, 1, prefix, 256
    rows = v.astype({1: ">u1", 2: ">u2", 4: ">i4"}[nbytes]).view(np.uint8).reshape(h, w * nbytes)
    return word.tobytes() + np.concatenate([np.zeros((h, prefix), np.uint8), rows], axis=1).tobytes()


def gbr_file(img, version=2, comment=b"brush") -> bytes:
    """A GIMP brush of uint8 [h, w] ("L") or [h, w, 4] ("RGBA")."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    depth = 1 if img.ndim == 2 else 4
    comment = comment + b"\0"
    if version == 1:
        head = struct.pack(">5I", 20 + len(comment), 1, w, h, depth)
    else:
        head = struct.pack(">5I", 28 + len(comment), 2, w, h, depth) + b"GIMP" + struct.pack(">I", 25)
    return head + comment + img.tobytes()


def pcd_file(y, c1, c2, orientation=0) -> bytes:
    """A Kodak PhotoCD base image: luma [512, 768], C1 and C2 [256, 384],
    `orientation` the low bits of header byte 1538."""
    head = bytearray(96 * 2048)
    head[2048:2055] = b"PCD_IPI"
    head[2048 + 1538] = orientation
    groups = np.concatenate([np.asarray(y, np.uint8).reshape(256, 2 * 768), np.asarray(c1, np.uint8),
                             np.asarray(c2, np.uint8)], axis=1)
    return bytes(head) + groups.tobytes()


def fli_chunk(kind: int, payload: bytes) -> bytes:
    return struct.pack("<IH", 6 + len(payload), kind) + payload


def fli_file(w, h, chunks, magic=0xAF12) -> bytes:
    """An FLI (0xAF11) or FLC (0xAF12) animation of one frame made of
    `chunks` (fli_chunk's bytes)."""
    frame = b"".join(chunks)
    frame = struct.pack("<IHH8x", 16 + len(frame), 0xF1FA, len(chunks)) + frame
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 128 + len(frame), magic, 1, w, h, 8, 3, 5)
    return bytes(head) + frame


def fli_brun(idx) -> bytes:
    """An FLI BRUN chunk's payload: each row of uint8 indices as literal
    packets of up to 127 bytes (a negative count)."""
    idx = np.asarray(idx, np.uint8)
    h, w = idx.shape
    full, rest = divmod(w, 127)
    row = np.empty((h, 1 + full * 128 + (rest + 1 if rest else 0)), np.uint8)
    row[:, 0] = full + (1 if rest else 0)
    body = row[:, 1 : 1 + full * 128].reshape(h, full, 128)
    body[..., 0] = 256 - 127
    body[..., 1:] = idx[:, : full * 127].reshape(h, full, 127)
    if rest:
        row[:, 1 + full * 128] = 256 - rest
        row[:, 2 + full * 128 :] = idx[:, full * 127 :]
    return row.tobytes()


def fli_palette(palette, shift=0) -> bytes:
    """A COLOR chunk's payload: one packet of 256 entries (values >> shift)."""
    return struct.pack("<HBB", 1, 0, 0) + (np.asarray(palette, np.uint8) >> shift).astype(np.uint8).tobytes()


XV_PALETTE_LEVELS = ((np.arange(8) * 255) // 7, (np.arange(8) * 255) // 7, (np.arange(4) * 255) // 3)


def xvthumb_file(idx) -> bytes:
    """An XV thumbnail of 3-3-2 indices uint8 [h, w]."""
    idx = np.asarray(idx, np.uint8)
    h, w = idx.shape
    return (b"P7 332\n#XVVERSION:Version 2.28  Rev: 9/26/92\n#IMGINFO:%dx%d RGB\n#END_OF_COMMENTS\n%d %d 255\n"
            % (w, h, w, h)) + idx.tobytes()


def imt_file(gray) -> bytes:
    """An IM Tools image of uint8 [h, w]."""
    gray = np.asarray(gray, np.uint8)
    h, w = gray.shape
    return b"* IM Tools\nwidth %d\nheight %d\npixel n8\n\x0c" % (w, h) + gray.tobytes()


def iptc_field(record: int, tag: int, data: bytes) -> bytes:
    """One IPTC field of fewer than 32768 bytes."""
    return bytes([0x1C, record, tag]) + struct.pack(">H", len(data)) + data


def iptc_file(w, h, payload: bytes, layers=1, component=0, compression=1, band=None) -> bytes:
    """An IPTC record of a w x h image: (3, 60) layers and component, the
    size, the compression (1 raw, 5 JPEG), an optional band, then the
    payload in (8, 10) fields of up to 32767 bytes."""
    out = iptc_field(3, 60, bytes([layers, component])) + iptc_field(3, 20, struct.pack(">H", w))
    out += iptc_field(3, 30, struct.pack(">H", h)) + iptc_field(3, 120, bytes([compression]))
    if band is not None:
        out += iptc_field(3, 65, bytes([band]))
    return out + b"".join(iptc_field(8, 10, payload[i : i + 32767]) for i in range(0, len(payload), 32767))


def icns_rle(channel) -> bytes:
    """Apple's icon RLE of one channel (uint8, flat): runs of 3 or more as
    one count byte (0x80 + n - 3) and the value, the rest as literals of up
    to 128 bytes."""
    c = np.asarray(channel, np.uint8).reshape(-1)
    out, i, n = bytearray(), 0, len(c)
    change = np.flatnonzero(np.diff(c)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n]])
    lit = bytearray()

    def flush():
        for k in range(0, len(lit), 128):
            out.extend(bytes([len(lit[k : k + 128]) - 1]) + lit[k : k + 128])
        lit.clear()

    for a, b in zip(starts.tolist(), ends.tolist()):
        i = a
        while b - i >= 3:
            k = min(b - i, 130)
            if k < 3:
                break
            flush()
            out.extend(bytes([0x80 + k - 3, c[i]]))
            i += k
        lit.extend(c[i:b].tobytes())
    flush()
    return bytes(out)


def icns_literal_rle(channel) -> bytes:
    """Apple's icon RLE of one channel as literal packets of 128 (and one
    short one): the decoder's slowest input per byte, made without a loop."""
    c = np.asarray(channel, np.uint8).reshape(-1)
    full, rest = divmod(len(c), 128)
    body = np.empty((full, 129), np.uint8)
    body[:, 0] = 127
    body[:, 1:] = c[: full * 128].reshape(full, 128)
    return body.tobytes() + (bytes([rest - 1]) + c[full * 128 :].tobytes() if rest else b"")


def icns_file(blocks) -> bytes:
    """An ICNS of (type, data) blocks."""
    body = b"".join(t + struct.pack(">I", 8 + len(d)) + d for t, d in blocks)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


ZSTD_STRIP_BYTES = 196608  # a 2048 x 32, 512 x 128 or 256 x 256 RGB strip


def zstd_strip_pattern() -> np.ndarray:
    """The bytes of tests/data/images/zstd_strip.zst (a Zstandard frame the
    zstandard package wrote at level 19, with its checksum): integer
    bands, steps and a hashed texture, so that its literals, matches and
    repeat offsets are all used, made the same on every machine."""
    i = np.arange(ZSTD_STRIP_BYTES, dtype=np.int64)
    x, y, c = (i // 3) % 2048, i // (3 * 2048), i % 3
    hashed = np.where((x // 64) % 3 == 0, (i * 2654435761) >> 27, 0)
    v = (x // 16 + y // 4) * 29 + c * 37 + ((x * 7) ^ (y * 13)) % 23 + hashed
    return (v & 0xFF).astype(np.uint8)


def helmet_with_texture(out_dir, data: bytes, filename: str) -> str:
    """The helmet stand-in (make_helmet_standin, written into out_dir if
    absent) with its base colour image replaced by `data`, written to
    filename in out_dir, and that textured material on the sphere and the
    plate (in make_helmet_standin both keep the default materials
    add_primitive gave them, as the reference's generator does, so its
    texture is never sampled). A .dds or .ktx2 image is named through
    MSFT_texture_dds or KHR_texture_basisu and a .webp image through
    EXT_texture_webp, as such assets name theirs.
    Returns the path of helmet_<stem>.gltf."""
    base = os.path.join(out_dir, "helmet.gltf")
    if not os.path.exists(base):
        make_helmet_standin(out_dir)
    with open(base) as f:
        gltf = json.load(f)
    with open(os.path.join(out_dir, filename), "wb") as f:
        f.write(data)
    gltf["images"] = [{"uri": filename}]
    textured = next(i for i, m in enumerate(gltf["materials"]) if m.get("name") == "helmet_pbr")
    for mesh in gltf["meshes"]:
        for prim in mesh["primitives"]:
            prim["material"] = textured
    ext = _TEXTURE_EXTENSION.get(os.path.splitext(filename)[1].lower())
    if ext:
        gltf["textures"][0] = {"sampler": 0, "extensions": {ext: {"source": 0}}}
        gltf["extensionsUsed"] = sorted(set(gltf.get("extensionsUsed", [])) | {ext})
    p = os.path.join(out_dir, f"helmet_{os.path.splitext(filename)[0]}.gltf")
    with open(p, "w") as f:
        json.dump(gltf, f)
    return p
