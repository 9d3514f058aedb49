"""The port's material model against the JAX package on the same inputs:
evaluate_material for every extension block (one parametrised case per
block, each from a small glTF scene that uses it, several with a texture
on the block's own slots), bsdf_evaluate and bsdf_sample for every lobe
and for features=None, and the host copies compute_sheen_lut and the
game / suite stand-in writers.

Inputs are made with numpy from fixed seeds; scene tables are the
reference's, carried across with convert.from_reference. Float results
agree within 1e-5 relative and absolute (test_torch_shading._close): both
sides run the same float32 operations in the same order, the Airy
iridescence terms included (their phases reach ~1e4 rad; measured
difference 6e-7). One exception, with its cause: the BSDF sample's pdf and
weight on narrow lobes (alpha < 0.1) within 1e-3 relative, as
test_torch_shading.test_bsdf_sample: a last-ulp difference of k2 moves the
steep GGX peak by ~eps/alpha. Events, flags and host copies are exact."""

import json
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
from vk_gltf_renderer_tpu.models.editor import SceneEditor  # noqa: E402
from vk_gltf_renderer_tpu.models.materials import detect_scene_features  # noqa: E402
from vk_gltf_renderer_tpu.ops import bsdf as jbsdf  # noqa: E402
from vk_gltf_renderer_tpu.ops import hitstate as jhit  # noqa: E402
from vk_gltf_renderer_tpu.ops import materials_eval as jmat  # noqa: E402
from vk_gltf_renderer_tpu.ops import sheen_lut as jsheen  # noqa: E402
from vk_gltf_renderer_tpu.ops.bvh_flatten import build_world_bvh  # noqa: E402
from vk_gltf_renderer_tpu.ops.flat import build_scene_flat  # noqa: E402
from vk_gltf_renderer_tpu.ops.traverse import as_device  # noqa: E402
from vk_gltf_renderer_tpu_torch.convert import from_reference  # noqa: E402
from vk_gltf_renderer_tpu_torch.models import materials as tmaterials  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import bsdf as tbsdf  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import materials_eval as tmat  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import sheen_lut as tsheen  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops.pathtrace import trace_closest  # noqa: E402
from vk_gltf_renderer_tpu_torch.scenes import checker_image, make_game_standin, make_suite_standin  # noqa: E402
from vk_gltf_renderer_tpu_torch.utils.png import write_png  # noqa: E402
from test_torch_shading import _close, _dirs, _random_pbr  # noqa: E402
from torch_test_helpers import share_native_builder  # noqa: E402

share_native_builder()

TEX = {"index": 0}


def _ext(name, body, **pbr):
    mat = {"pbrMetallicRoughness": {"baseColorFactor": [0.8, 0.6, 0.4, 1.0], "metallicFactor": 0.3,
                                    "roughnessFactor": 0.45, **pbr},
           "extensions": {name: body}}
    return mat


VOLUME = {"thicknessFactor": 0.5, "attenuationColor": [0.8, 0.5, 0.3], "attenuationDistance": 1.5}
# block -> the materials of its scene (the sphere takes the first, the cube the last)
BLOCKS = {
    "specular_glossiness": [
        _ext("KHR_materials_pbrSpecularGlossiness",
             {"diffuseFactor": [0.6, 0.5, 0.4, 1.0], "specularFactor": [0.3, 0.2, 0.1],
              "glossinessFactor": 0.7, "specularGlossinessTexture": TEX}),
        _ext("KHR_materials_pbrSpecularGlossiness",
             {"diffuseFactor": [0.2, 0.5, 0.9, 1.0], "specularFactor": [0.02, 0.02, 0.02],
              "glossinessFactor": 0.4, "diffuseTexture": TEX}),
    ],
    "volume": [_ext("KHR_materials_volume", dict(VOLUME, thicknessTexture=TEX))],
    "specular": [_ext("KHR_materials_specular",
                      {"specularFactor": 0.7, "specularColorFactor": [0.9, 0.6, 0.3],
                       "specularTexture": TEX, "specularColorTexture": TEX})],
    "ior": [  # a thick and a thin-walled glass: only the thick one swaps inside
        {"extensions": {"KHR_materials_ior": {"ior": 1.7}, "KHR_materials_volume": VOLUME,
                        "KHR_materials_transmission": {"transmissionFactor": 1.0}}},
        {"extensions": {"KHR_materials_ior": {"ior": 1.33},
                        "KHR_materials_transmission": {"transmissionFactor": 1.0}}},
    ],
    "transmission": [_ext("KHR_materials_transmission",
                          {"transmissionFactor": 0.8, "transmissionTexture": TEX}, metallicFactor=0.0)],
    "volume_scatter": [{
        "extensions": {"KHR_materials_volume": VOLUME, "KHR_materials_transmission": {"transmissionFactor": 1.0},
                       "KHR_materials_volume_scatter": {"multiscatterColor": [0.6, 0.7, 0.9],
                                                        "scatterAnisotropy": 0.3}}},
        {"extensions": {"KHR_materials_volume": VOLUME,
                        "KHR_materials_volume_scatter": {"multiscatterColor": [0.0, 0.0, 0.0]}}},
    ],
    "clearcoat": [_ext("KHR_materials_clearcoat",
                       {"clearcoatFactor": 0.9, "clearcoatRoughnessFactor": 0.3, "clearcoatTexture": TEX,
                        "clearcoatRoughnessTexture": TEX, "clearcoatNormalTexture": TEX}),
                  _ext("KHR_materials_clearcoat", {"clearcoatFactor": 1.0})],
    "iridescence": [_ext("KHR_materials_iridescence",
                         {"iridescenceFactor": 0.9, "iridescenceIor": 1.8, "iridescenceThicknessMinimum": 120.0,
                          "iridescenceThicknessMaximum": 480.0, "iridescenceTexture": TEX,
                          "iridescenceThicknessTexture": TEX}),
                    _ext("KHR_materials_iridescence", {"iridescenceFactor": 1.0,
                                                       "iridescenceThicknessMaximum": 0.0})],
    "anisotropy": [_ext("KHR_materials_anisotropy",
                        {"anisotropyStrength": 0.6, "anisotropyRotation": 0.5, "anisotropyTexture": TEX}),
                   _ext("KHR_materials_anisotropy", {"anisotropyStrength": 0.8})],
    "sheen": [_ext("KHR_materials_sheen",
                   {"sheenColorFactor": [0.9, 0.7, 0.8], "sheenRoughnessFactor": 0.5,
                    "sheenColorTexture": TEX, "sheenRoughnessTexture": TEX})],
    "dispersion": [{"extensions": {"KHR_materials_dispersion": {"dispersion": 0.3},
                                   "KHR_materials_transmission": {"transmissionFactor": 1.0},
                                   "KHR_materials_ior": {"ior": 1.6}}}],
    "retroreflection": [_ext("KHR_materials_retroreflection",
                             {"retroreflectionFactor": 0.5, "retroreflectionTexture": TEX})],
    "diffuse_transmission": [_ext("KHR_materials_diffuse_transmission",
                                  {"diffuseTransmissionFactor": 0.6,
                                   "diffuseTransmissionColorFactor": [0.9, 0.4, 0.2],
                                   "diffuseTransmissionTexture": TEX,
                                   "diffuseTransmissionColorTexture": TEX})],
    "unlit": [_ext("KHR_materials_unlit", {}), {"pbrMetallicRoughness": {"roughnessFactor": 0.2}}],
}


def _uses_texture(mats):
    return TEX in [v for m in mats for e in m.get("extensions", {}).values() for v in e.values()]


def _block_scene(tmp, mats):
    """A sphere and a cube with the given materials; with the checker
    texture as image 0 when a material names it."""
    sc = baseline_standins._empty_scene()
    ed = SceneEditor(sc)
    ball = ed.add_primitive("sphere", segments=16)
    cube = ed.add_primitive("cube")
    ed.set_translation(cube, [2.0, 0.5, -1.0])
    m = sc.model
    if _uses_texture(mats):
        write_png(str(tmp / "checker.png"), checker_image(64))
        m.images.append({"uri": "checker.png"})
        m.gltf.setdefault("samplers", []).append({"wrapS": 10497, "wrapT": 10497})
        m.gltf.setdefault("textures", []).append({"source": 0, "sampler": 0})
    base = len(m.materials)  # after the editor's own default materials
    m.materials.extend(json.loads(json.dumps(mats)))
    ed.set_material(ball, 0, base)
    ed.set_material(cube, 0, base + len(mats) - 1)
    sc.parse_scene()
    path = tmp / "block.gltf"
    sc.save(path)
    loaded = Scene()
    loaded.load(path)
    return loaded


def _hits(wb, bvh_t, rng, n=2048):
    lo, hi = wb.nodes_self[0, 0:3], wb.nodes_self[0, 3:6]
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro = ((lo + hi) / 2 + d * np.linalg.norm(hi - lo)).astype(np.float32)
    rd = (-d + 0.3 * rng.normal(size=d.shape)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    h = trace_closest(bvh_t, torch.tensor(ro), torch.tensor(rd))
    keep = (h["tri"] >= 0).numpy()
    assert keep.sum() > 500
    return {k: v.numpy()[keep] for k, v in h.items()}, rd[keep]


@pytest.mark.parametrize("block", sorted(BLOCKS) + ["every"])
def test_evaluate_material_block(block, tmp_path):
    """One extension block (or, for "every", the union of all the blocks'
    materials in one scene, every block on) against the reference, with a
    random half of the lanes inside a medium."""
    if block == "every":
        mats = [m for b in sorted(BLOCKS) for m in BLOCKS[b]]
    else:
        mats = BLOCKS[block]
    sc = _block_scene(tmp_path, mats)
    feats = set(detect_scene_features(sc.model))
    if sc.model.images:
        feats.add("textured")
    feats = frozenset(feats)
    assert block == "every" or block in feats
    assert tmaterials.detect_scene_features(sc.model) == detect_scene_features(sc.model)
    flat = build_scene_flat(sc)
    wb = build_world_bvh(flat)
    scene_t, bvh_t, _ = from_reference(flat, wb, None, "cpu")
    rng = np.random.default_rng(31)
    h, rd = _hits(wb, bvh_t, rng)
    hs = jhit.get_hit_state_fused(jnp.asarray(wb.hit_attr), jnp.asarray(wb.rn_attr_base),
                                  {k: jnp.asarray(v) for k, v in h.items()}, jnp.asarray(rd))
    hs_t = {k: torch.tensor(np.asarray(v)) for k, v in hs.items()}
    if block == "every":  # every material on every lane
        mat_id = rng.integers(0, len(flat.materials["ior"]), rd.shape[0]).astype(np.int32)
    else:
        mat_id = flat.rn_material[np.maximum(h["rnode"], 0)].astype(np.int32)
    inside = rng.random(mat_id.shape) < 0.5
    lod = rng.uniform(0, 0.05, mat_id.shape).astype(np.float32)
    ref = jmat.evaluate_material(as_device(flat), jnp.asarray(mat_id), hs, features=feats,
                                 is_inside=jnp.asarray(inside), tex_lod=jnp.asarray(lod))
    port = tmat.evaluate_material(scene_t, torch.tensor(mat_id), hs_t, features=feats,
                                  is_inside=torch.tensor(inside), tex_lod=torch.tensor(lod))
    assert ref.keys() == port.keys()
    for k in ref:
        _close(port[k], ref[k], f"{block}: {k}")
    if block in ("ior", "every"):
        swapped = port["ior1"].numpy() != 1.0
        assert swapped.any() and (swapped <= inside).all()  # only inside, only thick volumes
    if block == "volume_scatter":
        assert (port["scatter_coefficient"].numpy() > 0).any()


LOBES = [frozenset(), frozenset({"transmission"}), frozenset({"clearcoat"}), frozenset({"sheen"}),
         frozenset({"diffuse_transmission"}), frozenset({"iridescence"}),
         frozenset({"transmission", "clearcoat", "sheen", "diffuse_transmission", "iridescence"}), None]
LOBE_IDS = ["base", "transmission", "clearcoat", "sheen", "diffuse_transmission", "iridescence", "all",
            "features_none"]


def _lobe_inputs(seed, n, smooth_frac=0.0):
    rng = np.random.default_rng(seed)
    pbr = _random_pbr(rng, n, smooth_frac=smooth_frac, lobes=True)
    k1 = _dirs(rng, n)
    return rng, pbr, k1


@pytest.mark.parametrize("features", LOBES, ids=LOBE_IDS)
def test_bsdf_evaluate_lobe(features):
    rng, pbr, k1 = _lobe_inputs(32, 4096)
    k1 = np.where((np.sum(k1 * pbr["N"], -1) < 0)[:, None] & (np.arange(4096) % 4 != 0)[:, None], -k1, k1)
    k2 = _dirs(rng, 4096)
    ref = jbsdf.bsdf_evaluate({k: jnp.asarray(v) for k, v in pbr.items()}, jnp.asarray(k1), jnp.asarray(k2),
                              features)
    port = tbsdf.bsdf_evaluate({k: torch.tensor(v) for k, v in pbr.items()}, torch.tensor(k1),
                               torch.tensor(k2), features)
    for k in ("bsdf_diffuse", "bsdf_glossy", "pdf"):
        _close(port[k], ref[k], k)
    if features is None or "diffuse_transmission" in features:
        assert (port["pdf"].numpy()[np.sum(k2 * pbr["N"], -1) < 0] > 0).any()  # the lower hemisphere


@pytest.mark.parametrize("features", LOBES, ids=LOBE_IDS)
def test_bsdf_sample_lobe(features):
    rng, pbr, k1 = _lobe_inputs(33, 4096, smooth_frac=0.1)
    k1 = np.where((np.sum(k1 * pbr["N"], -1) < 0)[:, None] & (np.arange(4096) % 3 != 0)[:, None], -k1, k1)
    u = rng.random((4096, 3), dtype=np.float32)
    ue = rng.random((4096, 2), dtype=np.float32)
    ref = jbsdf.bsdf_sample({k: jnp.asarray(v) for k, v in pbr.items()}, jnp.asarray(k1), jnp.asarray(u),
                            jnp.asarray(ue), features)
    port = tbsdf.bsdf_sample({k: torch.tensor(v) for k, v in pbr.items()}, torch.tensor(k1), torch.tensor(u),
                             torch.tensor(ue), features)
    ev = port["event"].numpy()
    assert np.array_equal(ev, np.asarray(ref["event"]))
    _close(port["k2"], ref["k2"], "k2")
    wide = pbr["roughness"].min(-1) >= 0.1
    for k in ("pdf", "bsdf_over_pdf"):
        p, r = port[k].numpy(), np.asarray(ref[k])
        _close(p[wide], r[wide], k)
        _close(p[~wide], r[~wide], k + " (narrow lobes)", rtol=1e-3, atol=1e-5)
    # each gated-in lobe was sampled: its events occur
    expect = {tbsdf.EVENT_DIFFUSE, tbsdf.EVENT_GLOSSY_REFLECTION, tbsdf.EVENT_IMPULSE_REFLECTION}
    if features is None or "transmission" in features:
        expect |= {tbsdf.EVENT_GLOSSY_TRANSMISSION, tbsdf.EVENT_IMPULSE_TRANSMISSION}
    if features is None or "diffuse_transmission" in features:
        expect.add(tbsdf.EVENT_DIFFUSE_TRANSMISSION)
    assert expect <= set(np.unique(ev).tolist()), (sorted(expect), np.unique(ev))


def test_eval_iridescence():
    """The Airy thin-film term alone, over thickness 0-500 nm (the film's
    fade below 30 nm and TIR included)."""
    rng = np.random.default_rng(34)
    n = 4096
    n_film = rng.uniform(1.0, 2.4, n).astype(np.float32)
    cos1 = rng.uniform(0.0, 1.0, n).astype(np.float32)
    th = rng.uniform(0.0, 500.0, n).astype(np.float32)
    th[:64] = rng.uniform(0.0, 30.0, 64)
    f0 = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    ref = jbsdf._eval_iridescence(jnp.asarray(n_film), jnp.asarray(cos1), jnp.asarray(th), jnp.asarray(f0))
    port = tbsdf._eval_iridescence(torch.tensor(n_film), torch.tensor(cos1), torch.tensor(th), torch.tensor(f0))
    _close(port, ref, "eval_iridescence")


def test_fresnel_dielectric():
    rng = np.random.default_rng(35)
    cos_i = rng.uniform(0.0, 1.0, 4096).astype(np.float32)
    ior1 = rng.uniform(1.0, 2.0, 4096).astype(np.float32)
    ior2 = rng.uniform(1.0, 2.0, 4096).astype(np.float32)
    ref = jbsdf._fresnel_dielectric(jnp.asarray(cos_i), jnp.asarray(ior1), jnp.asarray(ior2))
    port = tbsdf._fresnel_dielectric(torch.tensor(cos_i), torch.tensor(ior1), torch.tensor(ior2))
    _close(port, ref, "fresnel_dielectric")
    assert (port.numpy() == 1.0).any()  # total internal reflection


def test_compute_sheen_lut_equals_reference():
    assert np.array_equal(tsheen.compute_sheen_lut(), jsheen.compute_sheen_lut())


def test_sheen_albedo():
    rng = np.random.default_rng(36)
    ndotv = rng.uniform(-0.1, 1.1, 4096).astype(np.float32)
    rough = rng.uniform(0.0, 1.05, 4096).astype(np.float32)
    ref = jsheen.sheen_albedo(jnp.asarray(ndotv), jnp.asarray(rough))
    port = tsheen.sheen_albedo(torch.tensor(ndotv), torch.tensor(rough))
    _close(port, ref, "sheen_albedo")
    assert float(tsheen.sheen_albedo(1.0, 0.5)) == float(np.asarray(jsheen.sheen_albedo(1.0, 0.5)))


@pytest.mark.parametrize("name", ["game", "suite"])
def test_standin_writers_equal_tools_versions(name, tmp_path):
    """The port's game and suite writers against tools/baseline_standins:
    the same glTF JSON (its buffers embedded) and the same files."""
    tools, port = tmp_path / "tools", tmp_path / "port"
    tools.mkdir()
    port.mkdir()
    ref_gen = {"game": baseline_standins.make_game, "suite": baseline_standins.make_suite}[name]
    port_gen = {"game": make_game_standin, "suite": make_suite_standin}[name]
    pa, pb = Path(ref_gen(str(tools))), Path(port_gen(str(port)))
    ja, jb = json.loads(pa.read_text()), json.loads(pb.read_text())
    assert ja == jb
    assert ja["buffers"] and ja["buffers"][0]["byteLength"] > 0
    names = sorted(p.name for p in tools.iterdir())
    assert names == sorted(p.name for p in port.iterdir())
    for f in names:
        assert (tools / f).read_bytes() == (port / f).read_bytes(), f
