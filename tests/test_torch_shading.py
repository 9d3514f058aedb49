"""Port shading against the JAX package on the same inputs: hit state,
ray offset, texture sampling, material evaluation, sky and HDR
environment, BSDF and tonemapping.

Inputs are made with numpy from fixed seeds; scene tables are the
reference's, carried across with convert.from_reference. Float results
agree within 1e-5 (relative and absolute): both sides run the same float32
operations in the same order, and the two CPU backends differ only in the
last ulps of transcendental functions. Integer and bit-level results
(offset rays, events, ids) must be equal."""

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
from vk_gltf_renderer_tpu.ops import bsdf as jbsdf  # noqa: E402
from vk_gltf_renderer_tpu.ops import hdr as jhdr  # noqa: E402
from vk_gltf_renderer_tpu.ops import hitstate as jhit  # noqa: E402
from vk_gltf_renderer_tpu.ops import materials_eval as jmat  # noqa: E402
from vk_gltf_renderer_tpu.ops import sky as jsky  # noqa: E402
from vk_gltf_renderer_tpu.ops import textures as jtex  # noqa: E402
from vk_gltf_renderer_tpu.ops import tonemap as jtone  # noqa: E402
from vk_gltf_renderer_tpu.ops.bvh_flatten import build_world_bvh  # noqa: E402
from vk_gltf_renderer_tpu.ops.flat import build_scene_flat  # noqa: E402
from vk_gltf_renderer_tpu.ops.traverse import as_device  # noqa: E402
from vk_gltf_renderer_tpu_torch.convert import from_reference  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import bsdf as tbsdf  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import hdr as thdr  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import hitstate as thit  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import materials_eval as tmat  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import sky as tsky  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import textures as ttex  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import tonemap as ttone  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops.pathtrace import trace_closest  # noqa: E402
from vk_gltf_renderer_tpu_torch.scenes import synthetic_sky  # noqa: E402
from torch_test_helpers import share_native_builder  # noqa: E402

share_native_builder()

TOL = dict(rtol=1e-5, atol=1e-5)
HELMET_FEATURES = frozenset({"textured", "tex:base_color_texture"})


def _close(port, ref, what, **tol):
    np.testing.assert_allclose(np.asarray(port.numpy() if torch.is_tensor(port) else port),
                               np.asarray(ref), err_msg=what, **(tol or TOL))


def _scene(kind, tmp):
    if kind == "helmet":
        sc = Scene()
        sc.load(baseline_standins.make_helmet(str(tmp)))
    else:
        sc = baseline_standins._empty_scene()
        ed = SceneEditor(sc)
        ed.add_primitive("sphere", segments=16)
        cube = ed.add_primitive("cube")
        ed.set_translation(cube, [2.0, 0.5, -1.0])
        sc.parse_scene()
    flat = build_scene_flat(sc)
    wb = build_world_bvh(flat)
    scene_t, bvh_t, _ = from_reference(flat, wb, None, "cpu")
    return flat, wb, scene_t, bvh_t


@pytest.fixture(scope="module", params=["helmet", "editor"])
def hits(request, tmp_path_factory):
    """Hits of inward rays (found by the port's traversal), fed to both."""
    flat, wb, scene_t, bvh_t = _scene(request.param, tmp_path_factory.mktemp(request.param))
    rng = np.random.default_rng(21)
    lo, hi = wb.nodes_self[0, 0:3], wb.nodes_self[0, 3:6]
    d = rng.normal(size=(2048, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro = ((lo + hi) / 2 + d * np.linalg.norm(hi - lo)).astype(np.float32)
    rd = (-d + 0.3 * rng.normal(size=d.shape)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    h = trace_closest(bvh_t, torch.tensor(ro), torch.tensor(rd))
    keep = (h["tri"] >= 0).numpy()
    assert keep.sum() > 500
    h = {k: v.numpy()[keep] for k, v in h.items()}
    return request.param, flat, wb, scene_t, bvh_t, h, rd[keep]


def _jhit_state(wb, h, rd):
    return jhit.get_hit_state_fused(jnp.asarray(wb.hit_attr), jnp.asarray(wb.rn_attr_base),
                                    {k: jnp.asarray(v) for k, v in h.items()}, jnp.asarray(rd))


def test_hit_state_fused(hits):
    kind, flat, wb, scene_t, bvh_t, h, rd = hits
    assert wb.hit_attr.shape[1] == (64 if kind == "helmet" else 32)  # wide and narrow rows
    ref = _jhit_state(wb, h, rd)
    port = thit.get_hit_state_fused(bvh_t.hit_attr, bvh_t.rn_attr_base,
                                    {k: torch.tensor(v) for k, v in h.items()}, torch.tensor(rd))
    assert ref.keys() == port.keys()
    for k in ref:
        if k == "front_face":
            assert np.array_equal(port[k].numpy(), np.asarray(ref[k]))
        else:
            _close(port[k], ref[k], k)


def test_safe_offset_ray_bit_exact():
    rng = np.random.default_rng(22)
    pos = (rng.normal(size=(4096, 3)) * np.array([[1e-3], [0.5], [100.0], [3.0]]).repeat(1024, 0)).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ref = np.asarray(jhit.safe_offset_ray(jnp.asarray(pos), jnp.asarray(d)))
    port = thit.safe_offset_ray(torch.tensor(pos), torch.tensor(d)).numpy()
    assert np.array_equal(port.view(np.int32), ref.view(np.int32))


def test_sample_texture(tmp_path):
    flat, _, scene_t, _ = _scene("helmet", tmp_path)
    rng = np.random.default_rng(23)
    n = 4096
    slot = rng.integers(0, len(flat.ti_index), n).astype(np.int32)
    uv0 = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    uv1 = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    grad = rng.uniform(0, 0.2, n).astype(np.float32)
    ref = jtex.sample_texture(as_device(flat), jnp.asarray(slot), jnp.asarray(uv0), jnp.asarray(uv1),
                              jnp.asarray(grad))
    port = ttex.sample_texture(scene_t, torch.tensor(slot), torch.tensor(uv0), torch.tensor(uv1),
                               torch.tensor(grad))
    _close(port, ref, "sample_texture")


def test_evaluate_material(hits):
    kind, flat, wb, scene_t, bvh_t, h, rd = hits
    feats = HELMET_FEATURES if kind == "helmet" else frozenset()
    ref_hs = _jhit_state(wb, h, rd)
    hs_t = {k: torch.tensor(np.asarray(v)) for k, v in ref_hs.items()}
    mat_id = flat.rn_material[np.maximum(h["rnode"], 0)].astype(np.int32)
    lod = np.random.default_rng(24).uniform(0, 0.05, mat_id.shape).astype(np.float32)
    ref = jmat.evaluate_material(as_device(flat), jnp.asarray(mat_id), ref_hs, features=feats,
                                 tex_lod=jnp.asarray(lod))
    port = tmat.evaluate_material(scene_t, torch.tensor(mat_id), hs_t, features=feats,
                                  tex_lod=torch.tensor(lod))
    assert ref.keys() == port.keys()
    for k in ref:
        _close(port[k], ref[k], k)


def test_unported_material_features_raise():
    """Every material extension and every BSDF lobe is ported, and so are
    alpha (MASK/BLEND), the infinite plane, the denoiser guides, the TAA
    jitter, batched spp and primary-hit seeding (A12); what still raises,
    through RenderConfig.check_supported, is a feature flag no block
    knows."""
    from vk_gltf_renderer_tpu_torch.ops.pathtrace import RenderConfig

    every = frozenset(tmat.SUPPORTED_FEATURES) | {"tex:clearcoat_texture"}
    tmat.check_features(every)
    RenderConfig(features=every, has_lights=True).check_supported()
    RenderConfig(features=frozenset({"textured"}), alpha_any=True).check_supported()
    RenderConfig(use_infinite_plane=True, plane_shadow_catcher=True).check_supported()
    RenderConfig(features=every, alpha_any=True, denoise_guides=True, taa_jitter=True).check_supported()
    RenderConfig(features=every, denoise_guides=True, spp=2, spp_batch=True).check_supported()
    RenderConfig(features=every, taa_jitter=True, primary_seed=True).check_supported()
    with pytest.raises(NotImplementedError, match="no_such_block"):
        tmat.check_features(frozenset({"textured", "no_such_block"}))


def _dirs(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def test_sky():
    rng = np.random.default_rng(25)
    arrays = jsky.SkyParams().as_arrays()
    env = tsky.SkyEnv.from_arrays(arrays, "cpu")
    d = _dirs(rng, 4096)
    d[:8] = arrays["sun_dir"]  # inside the sun disk
    u = rng.random((4096, 3), dtype=np.float32)
    _close(tsky.eval_sky(env, torch.tensor(d)), jsky.eval_sky(arrays, jnp.asarray(d)), "eval_sky")
    _close(tsky.pdf_sky(env, torch.tensor(d)), jsky.pdf_sky(arrays, jnp.asarray(d)), "pdf_sky")
    for a, b, what in zip(tsky.sample_sky(env, torch.tensor(u)), jsky.sample_sky(arrays, jnp.asarray(u)),
                          ("dir", "radiance", "pdf")):
        _close(a, b, f"sample_sky {what}")
    for k, v in tsky.SkyParams().as_arrays().items():
        assert np.array_equal(v, np.asarray(arrays[k])), k


@pytest.mark.parametrize("rotation", [0.0, 0.7])
def test_hdr_environment(rotation):
    rgb = synthetic_sky(64, 128, seed=3)
    ref_env = jhdr.build_environment(rgb, intensity=1.3, rotation=rotation)
    _, _, env = from_reference(None, None, ref_env, "cpu")
    rng = np.random.default_rng(26)
    d = _dirs(rng, 4096)
    u = rng.random((4096, 3), dtype=np.float32)
    for full in (False, True):
        a = thdr.eval_hdr(env, torch.tensor(d), full=full)
        b = jhdr.eval_hdr(ref_env, jnp.asarray(d), full=full)
        _close(a[0], b[0], f"eval_hdr radiance full={full}")
        _close(a[1], b[1], f"eval_hdr pdf full={full}")
    for a, b, what in zip(thdr.sample_hdr(env, torch.tensor(u)), jhdr.sample_hdr(ref_env, jnp.asarray(u)),
                          ("dir", "radiance", "pdf")):
        _close(a, b, f"sample_hdr {what}")


def _random_pbr(rng, n, smooth_frac=0.0, lobes=False):
    """A random PbrMaterial of n lanes. lobes=True adds the keys of the
    transmission, clearcoat, sheen, diffuse-transmission and iridescence
    lobes (drawn after the others, so the base keys do not change): about
    half the lanes are glass seen from inside (ior1 > ior2), and each
    lobe's factor is zero on a fifth of the lanes."""
    N = _dirs(rng, n)
    a = _dirs(rng, n)
    T = np.cross(N, a)
    T /= np.linalg.norm(T, axis=1, keepdims=True)
    B = np.cross(N, T)
    alpha = rng.uniform(0.01, 1.0, n).astype(np.float32) ** 2
    alpha[: int(n * smooth_frac)] = 0.0014142 ** 2  # the roughness floor: mirror impulse
    aniso = np.stack([alpha, alpha * rng.uniform(0.5, 1.0, n)], -1).astype(np.float32)
    metallic = rng.random(n).astype(np.float32)
    metallic[::5] = 0.0
    metallic[1::5] = 1.0
    pbr = {
        "N": N, "T": T.astype(np.float32), "B": B.astype(np.float32), "Ng": N,
        "base_color": rng.random((n, 3)).astype(np.float32), "metallic": metallic,
        "roughness": aniso, "ior1": np.ones(n, np.float32), "ior2": np.full(n, 1.5, np.float32),
        "specular_color": np.ones((n, 3), np.float32), "specular": np.ones(n, np.float32),
        "transmission": np.zeros(n, np.float32), "diffuse_transmission": np.zeros(n, np.float32),
    }
    if lobes:
        def factor():
            f = rng.random(n).astype(np.float32)
            f[rng.random(n) < 0.2] = 0.0
            return f

        inside = rng.random(n) < 0.5
        ior = rng.uniform(1.2, 2.0, n).astype(np.float32)
        Nc = N + 0.2 * _dirs(rng, n)
        Nc /= np.linalg.norm(Nc, axis=1, keepdims=True)
        sheen_color = rng.random((n, 3)).astype(np.float32)
        sheen_color[rng.random(n) < 0.2] = 0.0
        pbr.update({
            "ior1": np.where(inside, ior, 1.0).astype(np.float32),
            "ior2": np.where(inside, 1.0, ior).astype(np.float32),
            "specular_color": rng.uniform(0.5, 1.0, (n, 3)).astype(np.float32),
            "specular": rng.uniform(0.5, 1.0, n).astype(np.float32),
            "transmission": factor(),
            "diffuse_transmission": factor(),
            "diffuse_transmission_color": rng.random((n, 3)).astype(np.float32),
            "clearcoat": factor(),
            "clearcoat_roughness": rng.uniform(0.001, 1.0, n).astype(np.float32),
            "Nc": Nc.astype(np.float32),
            "sheen_color": sheen_color,
            "sheen_roughness": rng.uniform(0.0014142, 1.0, n).astype(np.float32),
            "_sheen_on": (sheen_color.max(-1) > 0).astype(np.float32),
            "iridescence": factor(),
            "iridescence_thickness": rng.uniform(0.0, 500.0, n).astype(np.float32),
            "iridescence_ior": rng.uniform(1.2, 2.2, n).astype(np.float32),
        })
    return pbr


def test_bsdf_evaluate():
    rng = np.random.default_rng(27)
    n = 4096
    pbr = _random_pbr(rng, n)
    k1 = _dirs(rng, n)
    k1 = np.where((np.sum(k1 * pbr["N"], -1) < 0)[:, None] & (np.arange(n) % 4 != 0)[:, None], -k1, k1)
    k2 = _dirs(rng, n)
    ref = jbsdf.bsdf_evaluate({k: jnp.asarray(v) for k, v in pbr.items()}, jnp.asarray(k1),
                              jnp.asarray(k2), frozenset())
    port = tbsdf.bsdf_evaluate({k: torch.tensor(v) for k, v in pbr.items()}, torch.tensor(k1),
                               torch.tensor(k2), frozenset())
    for k in ("bsdf_diffuse", "bsdf_glossy", "pdf"):
        _close(port[k], ref[k], k)


def test_bsdf_sample():
    rng = np.random.default_rng(28)
    n = 4096
    pbr = _random_pbr(rng, n, smooth_frac=0.1)
    k1 = _dirs(rng, n)
    k1 = np.where((np.sum(k1 * pbr["N"], -1) < 0)[:, None], -k1, k1)
    u = rng.random((n, 3), dtype=np.float32)
    ue = rng.random((n, 2), dtype=np.float32)
    ref = jbsdf.bsdf_sample({k: jnp.asarray(v) for k, v in pbr.items()}, jnp.asarray(k1),
                            jnp.asarray(u), jnp.asarray(ue), frozenset())
    port = tbsdf.bsdf_sample({k: torch.tensor(v) for k, v in pbr.items()}, torch.tensor(k1),
                             torch.tensor(u), torch.tensor(ue), frozenset())
    assert np.array_equal(port["event"].numpy(), np.asarray(ref["event"]))
    _close(port["k2"], ref["k2"], "k2")
    # pdf and weight are evaluated AT the sampled direction: for a narrow
    # glossy lobe (alpha < 0.1) the last-ulp difference of k2 moves the
    # steep GGX peak by ~eps/alpha, so those lanes get 1e-3 relative
    wide = pbr["roughness"].min(-1) >= 0.1
    for k in ("pdf", "bsdf_over_pdf"):
        p, r = port[k].numpy(), np.asarray(ref[k])
        _close(p[wide], r[wide], k)
        _close(p[~wide], r[~wide], k + " (narrow lobes)", rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("op", ["filmic", "aces", "agx", "khronos_pbr", "reinhard_ext", "none"])
def test_tonemap(op):
    c = np.random.default_rng(29).lognormal(0.0, 1.5, (2048, 3)).astype(np.float32)
    c[:4] = [[0, 0, 0], [1e-4, 0, 0], [50, 50, 50], [0.5, 2.0, 9.0]]
    ref = jtone.tonemap(jnp.asarray(c), op, 1.3)
    port = ttone.tonemap(torch.tensor(c), op, 1.3)
    _close(port, ref, op, rtol=1e-5, atol=1e-6)
