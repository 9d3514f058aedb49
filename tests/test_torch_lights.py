"""The port's punctual lights and volume phase function against the JAX
package on the same inputs: sample_one_light for each light type (hard
and soft directional, point and spot lights, with and without a radius
and a range window), the Henyey-Greenstein sample and pdf, and the path
tracer's NEE technique mix (_sample_lights) and transmission shadow march
(_trace_shadow) on scenes.make_materials_standin (glass and opaque
spheres under a point, a spot and a directional light).

Inputs are made with numpy from fixed seeds. Float results agree within
1e-5 relative and absolute (test_torch_shading._close), a soft light's
pdf as its solid angle (test_sample_one_light says why); pdfs that are
DIRAC, seeds and light picks are exact."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk_gltf_renderer_tpu.models import Scene  # noqa: E402
from vk_gltf_renderer_tpu.models.materials import detect_scene_features  # noqa: E402
from vk_gltf_renderer_tpu.ops import lights as jlights  # noqa: E402
from vk_gltf_renderer_tpu.ops import pathtrace as jpt  # noqa: E402
from vk_gltf_renderer_tpu.ops import sky as jsky  # noqa: E402
from vk_gltf_renderer_tpu.ops.bvh_flatten import build_world_bvh  # noqa: E402
from vk_gltf_renderer_tpu.ops.flat import build_scene_flat  # noqa: E402
from vk_gltf_renderer_tpu.ops.traverse import as_device  # noqa: E402
from vk_gltf_renderer_tpu_torch.convert import from_reference  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import intersect  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import lights as tlights  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import pathtrace as tpt  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import rng as trng  # noqa: E402
from vk_gltf_renderer_tpu_torch.scenes import make_materials_standin  # noqa: E402
from test_torch_shading import _close, _dirs  # noqa: E402
from torch_test_helpers import share_native_builder  # noqa: E402

share_native_builder()

N = 4096


def _light_tables(rng, kind, count=5):
    """Tables of `count` lights of one kind, as ops/flat._build_lights lays
    them out: directional "dir" (angular size 0.53 deg), "dir_wide" (5
    deg) or "dir_hard" (0); "point" / "spot" hard, "*_radius" with a
    radius, "*_range" with a range window as well."""
    base = kind.split("_")[0]
    ltype = {"dir": 1, "spot": 2, "point": 3}[base]
    d = _dirs(rng, count)
    d[0] = [0.0, -1.0, 0.0]
    t = dict(
        light_type=np.full(count, ltype, np.int32),
        light_pos=rng.uniform(-3, 3, (count, 3)).astype(np.float32),
        light_dir=d,
        light_color=rng.uniform(0.2, 1.0, (count, 3)).astype(np.float32),
        light_intensity=rng.uniform(1.0, 500.0, count).astype(np.float32),
        light_radius=np.zeros(count, np.float32),
        light_angular_or_invrange=np.zeros(count, np.float32),
        light_cone=np.tile(np.float32([[0.0, 1.0]]), (count, 1)),
    )
    if base == "dir":
        t["light_angular_or_invrange"][:] = {"dir": np.radians(0.53), "dir_wide": np.radians(5.0),
                                             "dir_hard": 0.0}[kind]
    else:
        if "radius" in kind or "range" in kind:
            t["light_radius"][:] = rng.uniform(0.05, 0.5, count)
        if "range" in kind:
            t["light_angular_or_invrange"][:] = 1.0 / rng.uniform(2.0, 8.0, count)
        if base == "spot":
            inner, outer = rng.uniform(0.1, 0.4, count), rng.uniform(0.5, 1.2, count)
            t["light_cone"] = np.stack([np.cos(outer), 1.0 / np.maximum(np.cos(inner) - np.cos(outer), 1e-4)],
                                       -1).astype(np.float32)
    return t


@pytest.mark.parametrize("kind", ["dir", "dir_wide", "dir_hard", "point", "point_radius", "point_range",
                                  "spot", "spot_radius", "spot_range"])
def test_sample_one_light(kind):
    rng = np.random.default_rng(41)
    tables = _light_tables(rng, kind)
    idx = rng.integers(0, 5, N).astype(np.int32)
    pos = rng.uniform(-4, 4, (N, 3)).astype(np.float32)
    normal = _dirs(rng, N)
    u2 = rng.random((N, 2), dtype=np.float32)
    ref = jlights.sample_one_light(SimpleNamespace(**{k: jnp.asarray(v) for k, v in tables.items()}),
                                   jnp.asarray(idx), jnp.asarray(pos), jnp.asarray(normal), jnp.asarray(u2))
    port = tlights.sample_one_light(SimpleNamespace(**{k: torch.tensor(v) for k, v in tables.items()}),
                                    torch.tensor(idx), torch.tensor(pos), torch.tensor(normal), torch.tensor(u2))
    assert ref.keys() == port.keys()
    for k in ("direction", "distance", "intensity"):
        _close(port[k], ref[k], f"{kind}: {k}")
    # a soft light's pdf is 1 / (2 pi (1 - cos_max)): XLA's CPU sqrt is not
    # correctly rounded (1 ulp off on ~0.6% of inputs), and 1 - cos_max
    # cancels, so the pdfs are held equal as solid angles, to 1e-6 absolute
    # (2 pi x 1 ulp of cos_max is 3.7e-7)
    pdf_p, pdf_r = port["pdf"].numpy(), np.asarray(ref["pdf"])
    assert np.array_equal(pdf_p == tlights.DIRAC, pdf_r == tlights.DIRAC)
    soft = pdf_p != tlights.DIRAC
    _close(1.0 / pdf_p[soft], 1.0 / pdf_r[soft], f"{kind}: solid angle", rtol=1e-5, atol=1e-6)
    hard = kind in ("dir_hard", "point", "spot")
    assert (port["pdf"].numpy() == tlights.DIRAC).all() == hard
    if kind.startswith("spot"):
        lit = port["intensity"].numpy().max(-1) > 0
        assert lit.any() and not lit.all()  # inside and outside the cones


@pytest.mark.parametrize("g", [0.0, 0.3, 0.85, -0.5])
def test_henyey_greenstein(g):
    rng = np.random.default_rng(42)
    u2 = rng.random((N, 2), dtype=np.float32)
    wi = _dirs(rng, N)
    gs = np.full(N, g, np.float32)
    gs[::7] = 0.0005  # the isotropic branch
    cos_t = rng.uniform(-1, 1, N).astype(np.float32)
    _close(tpt._hg_sample(torch.tensor(u2), torch.tensor(gs), torch.tensor(wi)),
           jpt._hg_sample(jnp.asarray(u2), jnp.asarray(gs), jnp.asarray(wi)), "hg_sample")
    _close(tpt._hg_pdf(torch.tensor(cos_t), torch.tensor(gs)), jpt._hg_pdf(jnp.asarray(cos_t), jnp.asarray(gs)),
           "hg_pdf")


@pytest.fixture(scope="module")
def lit_scene(tmp_path_factory):
    sc = Scene()
    sc.load(make_materials_standin(str(tmp_path_factory.mktemp("materials"))))
    assert len(sc.render_lights) == 3
    flat = build_scene_flat(sc)
    wb = build_world_bvh(flat)
    arrays = jsky.SkyParams().as_arrays()
    scene_t, bvh_t, env_t = from_reference(flat, wb, arrays, "cpu")
    feats = frozenset(detect_scene_features(sc.model))
    assert {"transmission", "volume", "volume_scatter", "clearcoat"} <= feats
    rng = np.random.default_rng(43)
    # points on the board and the spheres: the hits of rays cast down
    ro = np.stack([rng.uniform(-2, 2, N), np.full(N, 3.0), rng.uniform(-2, 2, N)], -1).astype(np.float32)
    rd = np.tile(np.float32([[0.0, -1.0, 0.0]]), (N, 1))
    h = tpt.trace_closest(bvh_t, torch.tensor(ro), torch.tensor(rd))
    assert (h["tri"] >= 0).all()
    pos = (ro + rd * h["t"].numpy()[:, None] + np.float32([0, 1e-3, 0])).astype(np.float32)
    seed = trng.xxhash32(torch.arange(N), torch.zeros(N, dtype=torch.int64), torch.full((N,), 3))
    return flat, wb, arrays, scene_t, bvh_t, env_t, feats, pos, seed


def _configs(feats):
    ref = jpt.RenderConfig(features=feats, has_lights=True, traversal="wavefront")
    port = tpt.RenderConfig(features=feats, has_lights=True)
    return ref, port


def test_sample_lights_technique_mix(lit_scene):
    """NEE at surface points: the light / environment pick, the light pick,
    the technique MIS and the seed after every draw."""
    flat, wb, arrays, scene_t, bvh_t, env_t, feats, pos, seed = lit_scene
    cfg_r, cfg_p = _configs(feats)
    normal = np.tile(np.float32([[0.0, 1.0, 0.0]]), (N, 1))
    ref, seed_r = jpt._sample_lights(as_device(flat), arrays, jnp.asarray(pos), jnp.asarray(normal),
                                     jnp.asarray(seed.numpy().astype(np.uint32)), cfg_r)
    port, seed_p = tpt._sample_lights(scene_t, env_t, torch.tensor(pos), torch.tensor(normal), seed, cfg_p)
    assert np.array_equal(seed_p.numpy().astype(np.uint32), np.asarray(seed_r))
    for k in ref:
        _close(port[k], ref[k], k)
    dirac = port["pdf"].numpy() == tpt.DIRAC
    assert dirac.any() and not dirac.all()  # hard lights and the environment


def test_trace_shadow_transmission_march(lit_scene):
    """Shadow rays toward sampled lights through the glass pieces: the
    march's tint, its per-round draws and the final occlusion trace, on
    every lane (the port traces the caller's lanes only; here all)."""
    flat, wb, arrays, scene_t, bvh_t, env_t, feats, pos, seed = lit_scene
    cfg_r, cfg_p = _configs(feats)
    rng = np.random.default_rng(44)
    # up from the board and the spheres, some through a sphere
    target = np.stack([rng.uniform(-2, 2, N), np.full(N, 1.0), rng.uniform(-2, 2, N)], -1)
    rd = (target - pos).astype(np.float32)
    dist = np.linalg.norm(rd, axis=-1).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    dist[::2] = tpt.INFINITE
    ref, seed_r = jpt._trace_shadow(as_device(flat), as_device(wb), jnp.asarray(pos), jnp.asarray(rd),
                                    jnp.asarray(dist), jnp.asarray(seed.numpy().astype(np.uint32)), cfg_r)
    port, seed_p = tpt._trace_shadow(scene_t, bvh_t, torch.tensor(pos), torch.tensor(rd), torch.tensor(dist),
                                     seed, cfg_p, alive=torch.ones(N, dtype=torch.bool))
    assert np.array_equal(seed_p.numpy().astype(np.uint32), np.asarray(seed_r))
    _close(port, ref, "shadow transmission")
    t = port.numpy().max(-1)
    assert (t == 0).any() and (t == 1).any() and ((t > 0) & (t < 1)).any()  # opaque, free, through glass


def test_trace_shadow_march_on_a_lane_mask(lit_scene):
    """The march on the caller's lanes only (a third of them dead): the
    live lanes' factor equals the reference's, which traces every lane,
    and the seed advances on every lane."""
    flat, wb, arrays, scene_t, bvh_t, env_t, feats, pos, seed = lit_scene
    cfg_r, cfg_p = _configs(feats)
    rng = np.random.default_rng(45)
    target = np.stack([rng.uniform(-2, 2, N), np.full(N, 1.2), rng.uniform(-2, 2, N)], -1)
    rd = (target - pos).astype(np.float32)
    dist = np.linalg.norm(rd, axis=-1).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    alive = rng.uniform(size=N) > 1 / 3
    ref, seed_r = jpt._trace_shadow(as_device(flat), as_device(wb), jnp.asarray(pos), jnp.asarray(rd),
                                    jnp.asarray(dist), jnp.asarray(seed.numpy().astype(np.uint32)), cfg_r)
    port, seed_p = tpt._trace_shadow(scene_t, bvh_t, torch.tensor(pos), torch.tensor(rd), torch.tensor(dist),
                                     seed, cfg_p, alive=torch.tensor(alive))
    assert np.array_equal(seed_p.numpy().astype(np.uint32), np.asarray(seed_r))
    _close(port[torch.tensor(alive)], np.asarray(ref)[alive], "shadow transmission, live lanes")
    t = port.numpy()[alive].max(-1)
    assert (t == 0).any() and (t == 1).any() and ((t > 0) & (t < 1)).any()


@pytest.mark.parametrize("n", [1, 3, 8])
def test_trace_closest_hands_the_kernel_aligned_columns(lit_scene, monkeypatch, n):
    """The march traces as few as one live lane: trace_closest (and
    intersect_rays_packet, through intersect.soa_columns) gives the
    traversal fresh contiguous columns, 16-byte aligned as the CUDA
    wrappers require (a one-ray column view is contiguous, but 4 or 8
    bytes into its row), with the rays' values."""
    bvh_t = lit_scene[4]
    seen = []
    traced = tpt.intersect_rays_soa

    def recording(bvh, *cols, **kw):
        seen.append(cols)
        return traced(bvh, *cols, **kw)

    monkeypatch.setattr(tpt, "intersect_rays_soa", recording)
    rng = np.random.default_rng(46)
    ro = torch.tensor(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    rd = torch.tensor(_dirs(rng, n))
    tpt.trace_closest(bvh_t, ro, rd, tmin=1e-4, tmax=torch.full((n,), 5.0))
    (cols,) = seen
    want = [ro[:, 0], ro[:, 1], ro[:, 2], rd[:, 0], rd[:, 1], rd[:, 2], None, torch.full((n,), 5.0)]
    for k, (c, w) in enumerate(zip(cols, want)):
        assert c.is_contiguous() and c.shape == (n,) and c.data_ptr() % 16 == 0, k
        if w is not None:
            assert torch.equal(c, w), k
    rays = torch.cat([ro, rd], 1)[:, None, :]  # [n, 1, 6]: each ray a row of a wider table
    for k, c in enumerate(intersect.soa_columns(rays[:, 0, :3], rays[:, 0, 3:])):
        assert c.is_contiguous() and c.data_ptr() % 16 == 0 and torch.equal(c, want[k]), k
