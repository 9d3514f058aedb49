"""Path tracer: one frame of samples over all pixels (port of the
non-compact path of vk_gltf_renderer_tpu/ops/pathtrace.py).

Rays live in [N] / [N,3] tensors with an `alive` mask; each bounce is
intersect -> environment hit -> shade -> volume segment -> NEE with a
deferred shadow ray -> BSDF sample -> Russian roulette, and the loop stops
once every lane is dead. Lanes stay in row-major pixel order throughout:
every lane carries its own RNG stream seeded from xxhash32(px, py, frame),
so the TPU-only ray reordering of the reference (tile order, co-sorts,
bucket ladder, trace_width padding, the compact frame's state columns)
changes no pixel and is not ported.

Semantics kept from the reference (anchors in its module docstring):
Gaussian subpixel AA, env-miss MIS, emissive add and the unlit early-out,
NEE with the 50/50 punctual-light / environment technique MIS, the
deferred shadow ray with its transmission and alpha march, Beer-Lambert
absorption and Henyey-Greenstein scattering inside volumes (with NEE at the
scatter point and the ratio-tracking residual), dispersion's
wavelength-channel pick, stochastic alpha (re-tracing past rejected hits
of MASK and BLEND materials, the opacity classes of ops/omm.py skipping
OPAQUE-class rows), the infinite plane and its shadow catcher, Russian
roulette from depth 3, the roughness regularisation, NaN sanitising, the
firefly clamp on mean luminance, running-mean accumulation and the directly
visible HDR background at full resolution. Every random number is drawn in
the reference's order, for every lane.

Traversals (the reference's switch, RenderConfig.traversal): under
"packet", bounce 0's closest-hit trace uses RenderConfig.primary_kernel;
every later bounce and every shadow ray, bounce 0's included, uses
packet_kernel (the reference's mapping under its default
VKGR_PEEL_SORT_SHADOW=1, ops/pathtrace.py:780 and :1130-1134), and
ops/intersect.py routes each name to its CUDA kernel; a bounce's alpha
re-traces take its closest-hit kernel. A scene without transmission or
alpha traces its shadow rays any hit; with either, every shadow ray takes
the march, closest hit from tmin 1e-4.
Under "packet4" every trace, primary, bounce and shadow, goes to the split
BVH4 kernel (intersect_rays_packet(wide=True)), under "wavefront" to the
stackless walk (intersect_rays_wavefront); neither reads the kernel names,
and both trace shadow rays closest hit, as the reference's do
(ops/pathtrace.py:404-411).

With denoise_guides the tracer also keeps the reference's full denoiser
guide set: the specular albedo (_env_brdf_approx2 of the first hit), the
specular hit distance (the t of the trace after a first-bounce glossy or
impulse reflection, 65504 on a miss), the first hit's previous-frame
position through the previous frame's per-node transforms
(frame["prev_rn_o2w"]) and the per-sample luminance moments summed over
spp. taa_jitter places sample 0 at frame["cam_jitter"] (the TAAU Halton
jitter) and still draws the Gaussian, so every later draw keeps its place.

primary_seed (the reference's previous-frame hit seeding): render_frame_flat
inverts the previous frame's per-pixel first hit (frame["prev_first_rnode"],
frame["prev_first_tri"]) through rn_attr_base and emit2ref to a tris row,
_primary_seed_hits re-verifies that row's current triangle by one
Moller-Trumbore test a lane, and every sample's bounce-0 trace of a scene
without alpha runs with tmax at the verified t; the seed stands where the
kernel finds nothing closer. The image is the unseeded one but where two
triangles tie at the seed's t.

spp_batch with spp > 1 (and no frame["px"]): the frame's spp samples are one
path_trace_batch over n*spp lanes in sample-major blocks, seeded
xxhash32(px, py, frame*spp + s), sample 0 with the Gaussian (or TAA) jitter
and the others uniform; the reference's non-compact branch (its compact
branch and tile order are TPU lane orders): the first-hit aux and
spec_hitdist come from sample block 0, lum_moments sums every sample and
rays counts every lane.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import rng
from .bsdf import (DIRAC, EVENT_ABSORB, EVENT_GLOSSY_REFLECTION, EVENT_GLOSSY_TRANSMISSION,
                   EVENT_IMPULSE_REFLECTION, EVENT_IMPULSE_TRANSMISSION, bsdf_evaluate, bsdf_sample)
from .camera import apply_depth_of_field, generate_rays
from .hdr import eval_hdr, sample_hdr
from .hitstate import get_hit_state_fused, safe_offset_ray
from .lights import sample_one_light
from .materials_eval import _gather_materials, evaluate_material, get_opacity, unsupported_features
from .sky import _onb, eval_sky, pdf_sky, sample_sky
from .intersect import (TRAVERSALS, intersect_rays_packet, intersect_rays_soa,
                        intersect_rays_wavefront, route, soa_columns)
from .traverse import INFINITE, cross3, dot3

ANTIALIASING_STD = 0.4246609
RR_MIN_DEPTH = 3
MIN_TRANSMISSION = 0.01
VOLUME_MIN_SCATTER = 0.001
VOLUME_RAND_FLOOR = 1.0e-10


def _hg_sample(u2, g, wi):
    """Henyey-Greenstein direction sample around wi."""
    g = torch.clamp(g, -0.99, 0.99)
    sq = (1.0 - g * g) / torch.clamp(1.0 - g + 2.0 * g * u2[..., 0], min=1e-6)
    cos_t = torch.where(torch.abs(g) < 1e-3, 1.0 - 2.0 * u2[..., 0],
                        (1.0 + g * g - sq * sq) / torch.clamp(2.0 * g, min=1e-6))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u2[..., 1]
    t, b = _onb(wi)
    return (
        t * (torch.cos(phi) * sin_t)[..., None]
        + b * (torch.sin(phi) * sin_t)[..., None]
        + wi * cos_t[..., None]
    )


def _hg_pdf(cos_t, g):
    g = torch.clamp(g, -0.99, 0.99)
    denom = torch.clamp(1.0 + g * g - 2.0 * g * cos_t, min=1e-6)
    return (1.0 - g * g) / (4.0 * math.pi * denom * torch.sqrt(denom))


@dataclass(frozen=True)
class RenderConfig:
    """Render parameters (the fields of the reference's RenderConfig that
    mean something off the TPU)."""

    width: int = 512
    height: int = 512
    spp: int = 1
    max_depth: int = 5
    features: frozenset = frozenset()
    env_kind: str = "sky"  # "sky" | "hdr"
    has_lights: bool = False
    alpha_any: bool = False  # any MASK/BLEND material in the scene
    alpha_rounds: int = 4  # stochastic-alpha re-traces a bounce at most
    firefly_clamp: float = 10.0
    aperture: float = 0.0
    focal_distance: float = 0.0
    orthographic: bool = False
    transmission_rounds: int = 4  # shadow-ray transmission marches
    background: tuple | None = None  # solid backplate for primary misses
    # the infinite plane y = plane_height and its shadow catcher (the reference's
    # frameInfo.infinitePlane*: a default PBR material, or with the catcher an invisible
    # plane that shows the environment, darkened where occluded)
    use_infinite_plane: bool = False
    plane_height: float = 0.0
    plane_shadow_catcher: bool = False
    plane_base_color: tuple = (0.5, 0.5, 0.5)
    plane_metallic: float = 0.0
    plane_roughness: float = 0.5
    shadow_catcher_darken: float = 0.0
    denoise_guides: bool = False  # the full denoiser guide set (see the module docstring)
    taa_jitter: bool = False  # sample 0 at frame["cam_jitter"] (TAAU)
    wireframe: bool = False  # the preview's barycentric edge overlay (ops/preview.py)
    spp_batch: bool = False
    primary_seed: bool = False
    # traversal switch (VKGR_TRAVERSAL, VKGR_PRIMARY_KERNEL, VKGR_PACKET_KERNEL);
    # the defaults are the reference renderer's (renderer.py:487-488)
    traversal: str = "packet"
    primary_kernel: str = "v3"
    packet_kernel: str = "v9"

    def check_supported(self) -> None:
        """Raise NotImplementedError for anything the port cannot render
        yet, rather than rendering it half right."""
        missing = list(unsupported_features(self.features))
        if self.env_kind not in ("sky", "hdr"):
            missing.append(f"environment kind {self.env_kind!r}")
        if missing:
            raise NotImplementedError(
                "not ported to the torch path tracer yet: " + ", ".join(missing))
        self.kernel_tables()  # raises for unknown traversals and kernel names

    def kernel_tables(self) -> set:
        """Table families the selected traversal reads: ops/intersect.ROUTES
        of both kernel names under "packet", "bvh4_split" under "packet4",
        "wavefront" under "wavefront"; with primary_seed also "primary_seed"
        (the tris rows the seed re-verifies). Raises ValueError for anything
        else."""
        seed = {"primary_seed"} if self.primary_seed else set()
        if self.traversal == "packet4":
            return {"bvh4_split"} | seed
        if self.traversal == "wavefront":
            return {"wavefront"} | seed
        if self.traversal != "packet":
            raise ValueError(f"unknown traversal {self.traversal!r}; accepted: {list(TRAVERSALS)}")
        return {route(self.primary_kernel), route(self.packet_kernel)} | seed


def trace_closest(bvh, ro, rd, tmin=0.0, tmax=None, alive=None, anyhit=False, kernel="v3",
                  traversal="packet"):
    """Closest (or any) hit of [N,3] rays, in lane order, through the named
    traversal kernel under traversal "packet", else through the packet4 or
    wavefront traversal (closest hit whatever `anyhit` says); tmax is None
    (unbounded) or [N]. Dead lanes trace with tmax = -1 and miss at the
    root."""
    n = ro.shape[0]
    dev = ro.device
    if tmax is None:
        tmax = torch.full((n,), INFINITE, device=dev)
    if alive is not None:
        tmax = torch.where(alive, tmax, -1.0)
    tmin_b = torch.full((n,), float(tmin), device=dev)
    if traversal == "packet4":
        return intersect_rays_packet(bvh, ro, rd, tmin_b, tmax, anyhit=anyhit, wide=True)
    if traversal == "wavefront":
        return intersect_rays_wavefront(bvh, ro, rd, tmin_b, tmax)
    return intersect_rays_soa(bvh, *soa_columns(ro, rd), tmin_b, tmax.contiguous(), anyhit=anyhit,
                              kernel=kernel)


def _env_brdf_approx2(spec_color, alpha, nov):
    """Integrated specular reflectance approximation [Ray Tracing Gems,
    ch. 32]: the specular-albedo guide."""
    nov = torch.abs(nov)
    x = (torch.ones_like(nov), nov, nov * nov, nov ** 3)
    y = (torch.ones_like(alpha), alpha, alpha * alpha, alpha ** 3)

    def dot2(m, a, b):
        return (m[0][0] * a[0] + m[0][1] * a[1]) * b[0] + (m[1][0] * a[0] + m[1][1] * a[1]) * b[1]

    def dot3m(m, a, b):
        r = [m[i][0] * a[0] + m[i][1] * a[1] + m[i][2] * a[2] for i in range(3)]
        return r[0] * b[0] + r[1] * b[1] + r[2] * b[2]

    m1 = ((0.99044, -1.28514), (1.29678, -0.755907))
    m2 = ((1.0, 2.92338, 59.4188), (20.3225, -27.0302, 222.592), (121.563, 626.13, 316.627))
    m3 = ((0.0365463, 3.32707), (9.0632, -9.04756))
    m4 = ((1.0, 3.59685, -1.36772), (9.04401, -16.3174, 9.22949), (5.56589, 19.7886, -20.2123))
    xw, yw, xzw = (x[0], x[1], x[3]), (y[0], y[1], y[3]), (x[0], x[2], x[3])
    bias = dot2(m1, x, y) / torch.clamp(dot3m(m2, xw, yw), min=1e-6)
    scale = dot2(m3, x, y) / torch.clamp(dot3m(m4, xzw, yw), min=1e-6)
    bias = bias * torch.clamp(spec_color[..., 1] * 50.0, 0.0, 1.0)
    return spec_color * torch.clamp(scale, min=0.0)[..., None] + torch.clamp(bias, min=0.0)[..., None]


def _xform_point(m, p):
    """Batched 4x4 point transform: m [...,4,4], p [...,3]."""
    return (m[..., :3, 0] * p[..., 0:1] + m[..., :3, 1] * p[..., 1:2] + m[..., :3, 2] * p[..., 2:3]
            + m[..., :3, 3])


def sample_environment(env, d, cfg: RenderConfig):
    """(radiance, pdf) of the environment in directions d."""
    if cfg.env_kind == "hdr":
        return eval_hdr(env, d)
    return eval_sky(env, d), pdf_sky(env, d)


def sample_environment_dir(env, u3, cfg: RenderConfig):
    """Importance-sample an environment direction: (dir, radiance, pdf)."""
    if cfg.env_kind == "hdr":
        return sample_hdr(env, u3)
    return sample_sky(env, u3)


def _env_mis_weight(last_pdf, env_pdf, cfg):
    """computeEnvHitMisWeight: BSDF-sampled env hit vs NEE."""
    env_w = 0.5 if cfg.has_lights else 1.0
    w = last_pdf / torch.clamp(last_pdf + env_w * env_pdf, min=1e-20)
    return torch.where(last_pdf == DIRAC, 1.0, w)


def _sample_lights(scene, env, pos, normal, seed, cfg: RenderConfig):
    """NEE technique mix: punctual lights against the environment, 50/50
    when the scene has lights, with the technique MIS. Returns (DirectLight
    dict, seed)."""
    light_w = 0.5 if cfg.has_lights else 0.0
    env_w = 0.5 if cfg.has_lights else 1.0
    shape = pos.shape[:-1]
    dev = pos.device

    u_pick, seed = rng.rand(seed)
    pick_light = u_pick < light_w if cfg.has_lights else torch.zeros(shape, dtype=torch.bool, device=dev)

    direction = torch.zeros_like(pos)
    radiance = torch.zeros_like(pos)
    distance = torch.full(shape, INFINITE, device=dev)
    pdf = torch.zeros(shape, device=dev)
    env_pdf = torch.zeros(shape, device=dev)

    if cfg.has_lights:
        u_sel, seed = rng.rand(seed)
        nl = max(scene.num_lights, 1)
        li = torch.clamp((u_sel * nl).to(torch.int32), max=nl - 1)
        sel_pdf = 1.0 / nl
        u2, seed = rng.rand2(seed)
        lc = sample_one_light(scene, li, pos, normal, u2)
        direction = torch.where(pick_light[..., None], lc["direction"], direction)
        distance = torch.where(pick_light, lc["distance"], distance)
        radiance = torch.where(pick_light[..., None], lc["intensity"] / (sel_pdf * light_w), radiance)
        pdf = torch.where(pick_light, torch.where(lc["pdf"] == DIRAC, DIRAC, sel_pdf * lc["pdf"]), pdf)

    # environment technique
    u3, seed = rng.rand3(seed)
    e_dir, e_rad, e_pdf = sample_environment_dir(env, u3, cfg)
    pick_env = ~pick_light
    direction = torch.where(pick_env[..., None], e_dir, direction)
    radiance = torch.where(pick_env[..., None], e_rad / torch.clamp(e_pdf * env_w, min=1e-20)[..., None],
                           radiance)
    env_pdf = torch.where(pick_env, e_pdf, env_pdf)
    if cfg.has_lights:
        # the environment's pdf of the light-sampled direction (technique MIS)
        _, env_pdf_of_light_dir = sample_environment(env, direction, cfg)
        env_pdf = torch.where(pick_light, env_pdf_of_light_dir, env_pdf)

    not_dirac = pdf != DIRAC
    pdf_sum = light_w * torch.clamp(pdf, min=0.0) + env_w * env_pdf
    mis = torch.where(pick_light, light_w * torch.clamp(pdf, min=0.0), env_w * env_pdf) / torch.clamp(
        pdf_sum, min=1e-20)
    mis = torch.where(not_dirac, mis, 1.0)
    radiance = radiance * mis[..., None]
    pdf = torch.where(not_dirac, pdf_sum, DIRAC)
    return {"direction": direction, "radiance_over_pdf": radiance, "distance": distance, "pdf": pdf}, seed


def _marches(cfg: RenderConfig) -> bool:
    """Whether shadow rays take the march (transmission or alpha in the
    scene) rather than one any-hit test."""
    return "transmission" in cfg.features or cfg.alpha_any


def _trace_shadow(scene, bvh, ro, rd, dist, seed, cfg: RenderConfig, alive):
    """Shadow transmission factor [N,3] of the lanes in `alive` (other
    lanes' factor is not defined), and the seed. Without transmission or
    alpha one any-hit occlusion test; with either a march through up to
    transmission_rounds surfaces (closest hit from tmin 1e-4), each passing
    untouched with probability 1 - opacity (u >= opacity, one uniform a
    round for every lane) and otherwise tinting by its transmission factor,
    base color and Fresnel (blocking without transmission), then one final
    trace: a hit past the budget occludes. The march runs on the live lanes
    only, gathered once a round (one host sync: their count); the others
    keep the factor 1. A round (or the final trace) with no lane left is
    skipped, its draws still made."""
    if not _marches(cfg):
        hits = trace_closest(bvh, ro, rd, tmin=0.0, tmax=dist, alive=alive, anyhit=True,
                             kernel=cfg.packet_kernel, traversal=cfg.traversal)
        return torch.where((hits["tri"] >= 0)[..., None], 0.0, 1.0), seed

    transmission = torch.ones((ro.shape[0], 3), device=ro.device)
    lanes = torch.nonzero(alive).squeeze(1)  # the live lanes; nonzero brings their count to the host
    org, d, remaining = ro[lanes], rd[lanes], dist[lanes]
    for _ in range(cfg.transmission_rounds):
        u, seed = rng.rand(seed)  # the alpha draw, for every lane
        if lanes.numel() == 0:
            continue
        hits = trace_closest(bvh, org, d, tmin=1e-4, tmax=remaining, kernel=cfg.packet_kernel,
                             traversal=cfg.traversal)
        hit = hits["tri"] >= 0
        hs = get_hit_state_fused(bvh.hit_attr, bvh.rn_attr_base, hits, d)
        mat_id = scene.rn_material[torch.clamp(hits["rnode"], min=0).long()]
        if cfg.alpha_any:
            pass_alpha = u[lanes] >= get_opacity(scene, mat_id, hs, textured="textured" in cfg.features)
        else:
            pass_alpha = u[lanes] >= 1.0
        if "transmission" in cfg.features:
            m = _gather_materials(scene, mat_id, ("transmission_factor", "base_color_factor", "ior"))
            tfac, bc = m["transmission_factor"], m["base_color_factor"][..., :3]
            ior = m["ior"] if "ior" in cfg.features else torch.full_like(tfac, 1.5)
            cos_theta = torch.abs(dot3(d, hs["nrm"]))
            f0 = ((ior - 1.0) / (ior + 1.0)) ** 2
            fres = f0 + (1.0 - f0) * (1.0 - cos_theta) ** 5
            surface_trans = tfac[..., None] * bc * (1.0 - fres)[..., None]
        else:
            surface_trans = torch.zeros_like(org)
        trans = transmission[lanes]
        this_trans = torch.where(pass_alpha[..., None], 1.0, surface_trans)
        trans = torch.where(hit[..., None], trans * this_trans, trans)
        blocked = torch.amax(trans, dim=-1) <= MIN_TRANSMISSION
        trans = torch.where(blocked[..., None], 0.0, trans)
        transmission[lanes] = trans
        # continue past the surface: the lanes that hit, are not blocked and have distance left
        step = hits["t"] + 1e-4
        org, remaining = org + d * step[..., None], remaining - step
        keep = torch.nonzero(hit & ~blocked & (remaining > 1e-4)).squeeze(1)
        lanes, org, d, remaining = lanes[keep], org[keep], d[keep], remaining[keep]
    # a surface left after the budget occludes
    if lanes.numel():
        hits = trace_closest(bvh, org, d, tmin=1e-4, tmax=remaining, kernel=cfg.packet_kernel,
                             traversal=cfg.traversal)
        transmission[lanes] = torch.where((hits["tri"] >= 0)[..., None], 0.0, transmission[lanes])
    return transmission, seed


def _trace_with_alpha(scene, bvh, ro, rd, seed, cfg: RenderConfig, alive, kernel):
    """Closest hit with stochastic alpha (reference _trace_with_alpha,
    ops/pathtrace.py:552): after the trace, alpha_rounds rounds each draw
    one uniform for every lane and reject a hit on a row that is not
    OPAQUE-class (bvh.attr_alpha_class) where u > opacity; a rejected lane
    steps t + 1e-4 past its hit and re-traces from tmin 0. Only the hits
    that may reject have their opacity evaluated, and only the rejecting
    lanes are re-traced (one host sync a round: their count); the other
    lanes keep their hits as they were. The steps are added back to t at
    the end, in the reference's order of sums."""
    hits = trace_closest(bvh, ro, rd, alive=alive, kernel=kernel, traversal=cfg.traversal)
    if not cfg.alpha_any:
        return hits, seed
    cls_tab = bvh.attr_alpha_class
    org = ro
    t_accum = torch.zeros(ro.shape[0], device=ro.device)
    textured = "textured" in cfg.features
    for _ in range(cfg.alpha_rounds):
        u, seed = rng.rand(seed)
        attr_row = (bvh.rn_attr_base[torch.clamp(hits["rnode"], min=0).long()]
                    + torch.clamp(hits["tri"], min=0)).long()
        cls = cls_tab[torch.clamp(attr_row, 0, cls_tab.shape[0] - 1)]
        cand = torch.nonzero((hits["tri"] >= 0) & (cls != 0)).squeeze(1)  # 0: ALPHA_OPAQUE
        if cand.numel() == 0:
            continue
        sub = {k: v[cand] for k, v in hits.items()}
        hs = get_hit_state_fused(bvh.hit_attr, bvh.rn_attr_base, sub, rd[cand])
        mat_id = scene.rn_material[torch.clamp(sub["rnode"], min=0).long()]
        lanes = cand[u[cand] > get_opacity(scene, mat_id, hs, textured=textured)]
        if lanes.numel() == 0:
            continue
        step = hits["t"][lanes] + 1e-4
        org_r = org[lanes] + rd[lanes] * step[..., None]
        re = trace_closest(bvh, org_r, rd[lanes], tmin=0.0, kernel=kernel, traversal=cfg.traversal)
        hits = {k: v.index_put((lanes,), re[k]) for k, v in hits.items()}
        org = org.index_put((lanes,), org_r)
        t_accum = t_accum.index_put((lanes,), t_accum[lanes] + step)
    hits["t"] = hits["t"] + t_accum
    return hits, seed


def _primary_seed_hits(bvh, ro, rd, prev_ref):
    """Re-verify each lane's previous first hit (prev_ref: a tris row, -1
    for none) against the current triangle of that row by one
    Moller-Trumbore test (reference ops/pathtrace.py:683). Returns (t, rnode,
    tri, u, v, valid), t INFINITE where invalid: a sound tmax for the
    primary trace and the hit that stands where the trace finds nothing."""
    ref = torch.clamp(prev_ref, 0, bvh.tris.shape[0] - 1).long()
    tv = bvh.tris[ref]  # [n,16]: cols 0:9 the world vertices
    v0 = tv[:, 0:3]
    e1 = tv[:, 3:6] - v0
    e2 = tv[:, 6:9] - v0
    p = cross3(rd, e2)
    det = dot3(e1, p)
    ok = torch.abs(det) >= 1e-12
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tvec = ro - v0
    u = dot3(tvec, p) * inv_det
    q = cross3(tvec, e1)
    v = dot3(rd, q) * inv_det
    t = dot3(e2, q) * inv_det
    valid = (prev_ref >= 0) & ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    t = torch.where(valid, t, INFINITE)
    return t, bvh.wtri_rnode[ref], bvh.wtri_tri[ref], u, v, valid


def _seeded_primary_trace(bvh, ro, rd, cfg: RenderConfig, alive, seed_hits):
    """Bounce 0's closest hit with the verified seeds as tmax (reference
    ops/pathtrace.py:781): the kernel returns anything closer, else the
    seed's hit stands."""
    s_t, s_rn, s_tri, s_u, s_v, s_valid = seed_hits
    hits = trace_closest(bvh, ro, rd, tmax=s_t, alive=alive, kernel=cfg.primary_kernel,
                         traversal=cfg.traversal)
    use = s_valid & (hits["tri"] < 0)
    seeded = {"t": s_t, "rnode": s_rn, "tri": s_tri, "u": s_u, "v": s_v}
    return {k: torch.where(use, seeded[k].to(v.dtype), v) if k in seeded else v for k, v in hits.items()}


def _hdr_background_fixup(state, env, cfg):
    """Directly visible background: indirect bounces used the reduced
    sampling map, the primary miss shows the full-resolution radiance.
    first_pos holds the primary direction for miss lanes."""
    if not (cfg.env_kind == "hdr" and cfg.background is None):
        return state
    miss1 = ~state["solid"]
    l_full, _ = eval_hdr(env, state["first_pos"], full=True)
    l_red, _ = eval_hdr(env, state["first_pos"])
    state["radiance"] = state["radiance"] + torch.where(miss1[..., None], l_full - l_red, 0.0)
    return state


def path_trace_batch(scene, bvh, env, ro, rd, seed, cfg: RenderConfig, pixel_angle=0.0, prev_rn_o2w=None,
                     prev_ref=None):
    """Trace one sample per lane. Returns (radiance [N,3], aux dict, seed).
    prev_rn_o2w [R,16]: the previous frame's per-node object-to-world
    matrices, for the guides' first_pos_prev (zero without them).
    prev_ref [N]: each lane's previous first hit as a tris row (-1 none),
    which seeds bounce 0's trace in a scene without alpha."""
    n = ro.shape[0]
    dev = ro.device
    seed_hits = (_primary_seed_hits(bvh, ro, rd, prev_ref)
                 if prev_ref is not None and not cfg.alpha_any else None)

    def zeros(*shape):
        return torch.zeros((n,) + shape, device=dev)

    state = dict(
        ro=ro,
        rd=rd,
        radiance=zeros(3),
        throughput=torch.ones((n, 3), device=dev),
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        last_pdf=torch.full((n,), DIRAC, device=dev),
        max_rough=zeros(2),
        is_inside=torch.zeros(n, dtype=torch.bool, device=dev),
        solid=torch.ones(n, dtype=torch.bool, device=dev),
        first_pos=torch.full((n, 3), 1e34, device=dev),
        first_rnode=torch.full((n,), -1, dtype=torch.int32, device=dev),
        first_tri=torch.full((n,), -1, dtype=torch.int32, device=dev),
        guide_albedo=zeros(3),
        guide_normal=zeros(3),
        guide_rough=zeros(),
        att_sigma=zeros(3),
        scatter_sigma=zeros(3),
        scatter_g=zeros(),
        chroma=torch.full((n,), -1, dtype=torch.int32, device=dev),  # dispersion: -1 none, 0/1/2 = R/G/B
        cone_width=zeros(),
        seed=seed,
        rays=torch.zeros((), device=dev),
    )
    if cfg.denoise_guides:
        state.update(guide_spec_albedo=zeros(3), guide_spec_hitdist=zeros(),
                     capture_spec=torch.zeros(n, dtype=torch.bool, device=dev), guide_pos_prev=zeros(3))
    feats = cfg.features

    def bounce(state, depth):
        ro, rd = state["ro"], state["rd"]
        alive = state["alive"]
        seed = state["seed"]
        radiance = state["radiance"]
        throughput = state["throughput"]
        first = depth == 0

        state["rays"] = state["rays"] + torch.sum(alive.to(torch.float32))
        if first and seed_hits is not None:
            hits = _seeded_primary_trace(bvh, ro, rd, cfg, alive, seed_hits)
        else:
            hits, seed = _trace_with_alpha(scene, bvh, ro, rd, seed, cfg, alive,
                                           cfg.primary_kernel if first else cfg.packet_kernel)
        miss = hits["tri"] < 0

        if cfg.denoise_guides:
            # specular hit distance: this trace's t after a first-bounce reflection, taken before
            # the plane test (a plane hit records a miss), 65504 (fp16 max) on a miss
            cap = state["capture_spec"] & alive
            hd = torch.where(miss, 65504.0, hits["t"])
            state["guide_spec_hitdist"] = torch.where(cap, hd, state["guide_spec_hitdist"])
            state["capture_spec"] = torch.zeros_like(cap)

        # the infinite plane y = plane_height, seen from above, where it is nearer than the hit
        if cfg.use_infinite_plane:
            dn = rd[:, 1]
            t_plane = (cfg.plane_height - ro[:, 1]) / torch.where(torch.abs(dn) < 1e-6, 1.0, dn)
            plane_hit = ((ro[:, 1] > cfg.plane_height) & (torch.abs(dn) > 1e-6) & (t_plane > 0)
                         & (t_plane < torch.where(miss, INFINITE, hits["t"])))
            miss = miss & ~plane_hit

        # environment hit
        env_color, env_pdf = sample_environment(env, rd, cfg)
        mis_w = _env_mis_weight(state["last_pdf"], env_pdf, cfg)
        env_contrib = throughput * mis_w[..., None] * env_color
        if cfg.background is not None and first:
            env_contrib = torch.tensor(cfg.background, dtype=torch.float32, device=dev).expand(n, 3)
        radiance = radiance + torch.where((alive & miss)[..., None], env_contrib, 0.0)
        if first:
            first_miss = alive & miss
            state["solid"] = torch.where(first_miss, False, state["solid"])
            state["first_pos"] = torch.where(first_miss[..., None], rd, state["first_pos"])

        lane_hit = alive & ~miss
        alive = lane_hit
        lane_plane = alive & plane_hit if cfg.use_infinite_plane else None

        # surface shading with ray-cone texture LOD
        hs = get_hit_state_fused(bvh.hit_attr, bvh.rn_attr_base, hits, rd)
        mat_id = scene.rn_material[torch.clamp(hits["rnode"], min=0).long()]
        world_foot = (state["cone_width"] + pixel_angle * hits["t"]) / torch.clamp(
            torch.abs(dot3(hs["nrm"], -rd)), min=1e-3)
        tex_grad = world_foot * hs["texel_density"]
        state["cone_width"] = torch.where(lane_hit, world_foot, state["cone_width"])
        pbr = evaluate_material(scene, mat_id, hs, features=feats, is_inside=state["is_inside"],
                                tex_lod=tex_grad)

        if cfg.use_infinite_plane:
            # plane lanes take the plane's hit state and its default PBR material
            ppos = ro + rd * t_plane[..., None]
            axes = torch.eye(3, device=dev)
            up, tx, bz = (axes[k].expand(n, 3) for k in (1, 0, 2))
            pl = lane_plane[..., None]
            for k, v in (("pos", ppos), ("nrm", up), ("geonrm", up), ("shadow_pos", ppos), ("tangent", tx),
                         ("bitangent", bz)):
                hs[k] = torch.where(pl, v, hs[k])
            pbr["base_color"] = torch.where(
                pl, torch.tensor(cfg.plane_base_color, dtype=torch.float32, device=dev), pbr["base_color"])
            pbr["metallic"] = torch.where(lane_plane, cfg.plane_metallic, pbr["metallic"])
            alpha_p = max(cfg.plane_roughness, 0.0014) ** 2  # a Python float, as the reference's
            pbr["roughness"] = torch.where(pl, alpha_p, pbr["roughness"])
            pbr["N"] = torch.where(pl, up, pbr["N"])
            pbr["Ng"] = torch.where(pl, up, pbr["Ng"])
            pbr["T"] = torch.where(pl, tx, pbr["T"])
            pbr["B"] = torch.where(pl, bz, pbr["B"])
            pbr["emissive"] = torch.where(pl, 0.0, pbr["emissive"])
            hits["t"] = torch.where(lane_plane, t_plane, hits["t"])
            lane_hit = alive & (~miss | lane_plane)
            alive = lane_hit

        if first:
            fh = lane_hit
            state["first_pos"] = torch.where(fh[..., None], hs["pos"], state["first_pos"])
            state["first_rnode"] = torch.where(fh, hits["rnode"], state["first_rnode"])
            state["first_tri"] = torch.where(fh, hits["tri"], state["first_tri"])
            state["guide_albedo"] = torch.where(fh[..., None], pbr["base_color"], state["guide_albedo"])
            state["guide_normal"] = torch.where(fh[..., None], pbr["N"], state["guide_normal"])
            state["guide_rough"] = torch.where(fh, torch.sqrt(pbr["roughness"][..., 0]), state["guide_rough"])
            if cfg.denoise_guides and prev_rn_o2w is not None:
                # instance motion: the hit back in object space through the node's current w2o,
                # out again through its previous-frame o2w
                rn_safe = torch.clamp(hits["rnode"], min=0).long()
                w2o = scene.rn_packed[rn_safe, 16:32].reshape(n, 4, 4)
                prev_o2w = prev_rn_o2w[rn_safe].reshape(n, 4, 4)
                pos_prev = _xform_point(prev_o2w, _xform_point(w2o, hs["pos"]))
                state["guide_pos_prev"] = torch.where(fh[..., None], pos_prev, state["guide_pos_prev"])
            if cfg.denoise_guides:
                # the specular albedo: the KHR_materials_specular energy clamp, then EnvBRDFApprox2
                f0i = ((pbr["ior2"] - pbr["ior1"]) / torch.clamp(pbr["ior2"] + pbr["ior1"], min=1e-6)) ** 2
                scc = torch.clamp(f0i[..., None] * pbr["specular_color"], max=1.0)
                spec_alb = _env_brdf_approx2(scc, pbr["roughness"][..., 0], dot3(pbr["N"], rd))
                state["guide_spec_albedo"] = torch.where(fh[..., None], spec_alb, state["guide_spec_albedo"])

        # in-volume segment: Beer-Lambert absorption, and Henyey-Greenstein
        # scatter events where the medium scatters (KHR_materials_volume_scatter)
        scattered = torch.zeros_like(alive)
        if "volume" in feats:
            in_medium = lane_hit & state["is_inside"]
            if "volume_scatter" in feats:
                sig_s = state["scatter_sigma"]
                sig_t = state["att_sigma"] + sig_s
                max_s = torch.amax(sig_s, dim=-1)
                max_t = torch.clamp(torch.amax(sig_t, dim=-1), min=1e-6)
                u_s, seed = rng.rand(seed)
                s_dist = -torch.log(torch.clamp(u_s, min=VOLUME_RAND_FLOOR)) / max_t
                scattered = in_medium & (max_s > VOLUME_MIN_SCATTER) & (s_dist < hits["t"])
                # scatter event: single-scatter albedo weighting, HG redirect
                throughput = torch.where(scattered[..., None],
                                         throughput * (1.0 - (sig_t - sig_s) / max_t[..., None]), throughput)
                u2_hg, seed = rng.rand2(seed)
                wi = rd
                sc_dir = _hg_sample(u2_hg, state["scatter_g"], wi)
                sc_org = ro + rd * s_dist[..., None]
                # NEE at the scatter point: the light sampler gets wi where a
                # surface passes its normal
                dlv, seed = _sample_lights(scene, env, sc_org, wi, seed, cfg)
                phase_pdf = _hg_pdf(dot3(wi, dlv["direction"]), state["scatter_g"])
                v_mis = torch.where(dlv["pdf"] == DIRAC, 1.0,
                                    dlv["pdf"] / torch.clamp(dlv["pdf"] + phase_pdf, min=1e-20))
                v_lit = scattered & (dlv["pdf"] != 0.0)
                v_shadow, seed = _trace_shadow(scene, bvh, sc_org, dlv["direction"], dlv["distance"], seed,
                                               cfg, alive=v_lit)
                v_contrib = throughput * dlv["radiance_over_pdf"] * (v_mis * phase_pdf)[..., None] * v_shadow
                radiance = radiance + torch.where(v_lit[..., None], v_contrib, 0.0)
                # lanes that did not scatter: the ratio-tracking residual of a
                # free flight sampled with max_t (Beer-Lambert without scatter)
                no_sc = in_medium & ~scattered
                resid = torch.exp(torch.clamp(hits["t"], max=1e8)[..., None]
                                  * torch.clamp(max_t[..., None] - sig_t, max=0.0))
                throughput = torch.where(no_sc[..., None], throughput * resid, throughput)
                ro = torch.where(scattered[..., None], sc_org, ro)
                rd = torch.where(scattered[..., None], sc_dir, rd)
                state["last_pdf"] = torch.where(scattered, _hg_pdf(dot3(wi, sc_dir), state["scatter_g"]),
                                                state["last_pdf"])
                lane_hit = lane_hit & ~scattered  # scattered lanes stay alive and skip the surface
            else:
                seg_att = torch.exp(-hits["t"][..., None] * state["att_sigma"])
                throughput = torch.where(in_medium[..., None], throughput * seg_att, throughput)

        # roughness regularisation
        state["max_rough"] = torch.maximum(state["max_rough"], pbr["roughness"])
        pbr["roughness"] = torch.where(lane_hit[..., None], state["max_rough"], pbr["roughness"])

        radiance = radiance + torch.where(lane_hit[..., None], pbr["emissive"] * throughput, 0.0)

        if "unlit" in feats:
            unlit = lane_hit & (pbr["unlit"] > 0)
            radiance = radiance + torch.where(unlit[..., None], pbr["base_color"], 0.0)
            alive = alive & ~unlit
            lane_hit = lane_hit & ~unlit

        # next-event estimation
        dl, seed = _sample_lights(scene, env, hs["pos"], pbr["N"], seed, cfg)
        next_event = (
            lane_hit
            & ((dot3(dl["direction"], hs["nrm"]) > 0.0) | (pbr["diffuse_transmission"] > 0.0))
            & (dl["pdf"] != 0.0)
        )
        ev = bsdf_evaluate(pbr, -rd, dl["direction"], feats)
        light_mis = torch.where(
            dl["pdf"] == DIRAC, 1.0, dl["pdf"] / torch.clamp(dl["pdf"] + ev["pdf"], min=1e-20))
        contrib = (throughput * dl["radiance_over_pdf"] * light_mis[..., None]
                   * (ev["bsdf_diffuse"] + ev["bsdf_glossy"]))
        next_event = next_event & (ev["pdf"] > 0.0)

        # BSDF sample for the next segment
        if "dispersion" in feats:
            # pick a wavelength channel on the first dispersive transmission
            # and shift the IOR per channel (Abbe number V = 20 / D)
            u_ch, seed = rng.rand(seed)
            needs_chroma = (lane_hit & (pbr["dispersion"] > 0.0) & (pbr["transmission"] > 0.0)
                            & (state["chroma"] < 0))
            new_ch = torch.clamp((u_ch * 3).to(torch.int32), max=2)
            state["chroma"] = torch.where(needs_chroma, new_ch, state["chroma"])
            one_hot = torch.nn.functional.one_hot(new_ch.long(), 3).to(torch.float32)
            throughput = torch.where(needs_chroma[..., None], throughput * 3.0 * one_hot, throughput)
            half = (pbr["ior2"] - 1.0) * pbr["dispersion"] / 20.0 * 0.5
            shift = torch.where(state["chroma"] == 0, -half, torch.where(state["chroma"] == 2, half, 0.0))
            pbr["ior2"] = torch.where(state["chroma"] >= 0, torch.clamp(pbr["ior2"] + shift, min=1.01),
                                      pbr["ior2"])
        u3b, seed = rng.rand3(seed)
        ue, seed = rng.rand2(seed)
        samp = bsdf_sample(pbr, -rd, u3b, ue, feats)
        throughput = torch.where(lane_hit[..., None], throughput * samp["bsdf_over_pdf"], throughput)
        state["last_pdf"] = torch.where(lane_hit, samp["pdf"], state["last_pdf"])
        new_dir = samp["k2"]
        absorbed = lane_hit & (samp["event"] == EVENT_ABSORB)
        if cfg.denoise_guides and first:
            # arm the specular hit-distance capture for the next trace
            spec_ev = (samp["event"] == EVENT_GLOSSY_REFLECTION) | (samp["event"] == EVENT_IMPULSE_REFLECTION)
            state["capture_spec"] = lane_hit & spec_ev & ~absorbed

        if "transmission" in feats:
            # a transmission event enters or leaves the medium; entering takes
            # the material's absorption (and scattering) coefficients
            is_trans = ((samp["event"] == EVENT_IMPULSE_TRANSMISSION)
                        | (samp["event"] == EVENT_GLOSSY_TRANSMISSION))
            toggled = lane_hit & is_trans
            new_inside = torch.where(toggled, ~state["is_inside"], state["is_inside"])
            if "volume" in feats:
                att = -torch.log(torch.clamp(pbr["attenuation_color"], min=0.001)) / torch.clamp(
                    pbr["attenuation_distance"], min=0.001)[..., None]
                has_vol = (pbr["thickness"] > 0.0) & (pbr["attenuation_distance"] > 0.0)
                att = torch.where(has_vol[..., None], att, 0.0)
                enter = toggled & new_inside
                state["att_sigma"] = torch.where(enter[..., None], att, state["att_sigma"])
                if "volume_scatter" in feats:
                    state["scatter_sigma"] = torch.where(enter[..., None], pbr["scatter_coefficient"],
                                                         state["scatter_sigma"])
                    state["scatter_g"] = torch.where(enter, pbr["scatter_anisotropy"], state["scatter_g"])
            state["is_inside"] = new_inside

        offset_dir = torch.where((dot3(new_dir, hs["geonrm"]) > 0)[..., None], hs["geonrm"], -hs["geonrm"])
        new_org = safe_offset_ray(hs["pos"], offset_dir)

        # deferred shadow ray
        state["rays"] = state["rays"] + torch.sum(next_event.to(torch.float32))
        sh_fwd = (dot3(dl["direction"], hs["nrm"]) > 0.0)[..., None]
        sh_base = torch.where(sh_fwd, hs["shadow_pos"], hs["pos"])
        sh_off = torch.where(sh_fwd, hs["geonrm"], -hs["geonrm"])
        sh_org = safe_offset_ray(sh_base, sh_off)
        catcher = cfg.use_infinite_plane and cfg.plane_shadow_catcher
        # the reference marches every lane's shadow ray, so its catcher reads the shadow of a
        # plane lane that has no next event too
        shadow, seed = _trace_shadow(scene, bvh, sh_org, dl["direction"], dl["distance"], seed, cfg,
                                     alive=next_event | lane_plane if catcher and _marches(cfg) else next_event)
        if catcher:
            # the plane is invisible: it shows the environment, darkened where occluded
            env_c, env_p = sample_environment(env, rd, cfg)
            sc_mis = _env_mis_weight(state["last_pdf"], env_p, cfg)
            lit = torch.amin(shadow, dim=-1)
            sc_rad = throughput * sc_mis[..., None] * env_c * (
                lit + (1.0 - lit) * (1.0 - cfg.shadow_catcher_darken))[..., None]
            radiance = radiance + torch.where(lane_plane[..., None], sc_rad, 0.0)
            alive = alive & ~lane_plane
            lane_hit = lane_hit & ~lane_plane
            next_event = next_event & ~lane_plane
        radiance = radiance + torch.where(next_event[..., None], contrib * shadow, 0.0)

        alive = (alive & ~absorbed) | scattered
        surf = alive & ~scattered
        ro = torch.where(surf[..., None], new_org, ro)
        rd = torch.where(surf[..., None], new_dir, rd)

        # Russian roulette
        rr_p = torch.clamp(torch.amax(throughput, dim=-1) + 0.001, max=0.95)
        u_rr, seed = rng.rand(seed)
        if depth >= RR_MIN_DEPTH:
            die = alive & (u_rr >= rr_p)
            alive = alive & ~die
            throughput = torch.where(alive[..., None], throughput / rr_p[..., None], throughput)

        state.update(ro=ro, rd=rd, radiance=radiance, throughput=throughput, alive=alive, seed=seed)
        return state

    depth = 0
    while depth < cfg.max_depth and bool(state["alive"].any()):
        state = bounce(state, depth)
        depth += 1

    state = _hdr_background_fixup(state, env, cfg)
    aux = {
        "first_pos": state["first_pos"],
        "solid": state["solid"],
        "first_rnode": state["first_rnode"],
        "first_tri": state["first_tri"],
        "albedo": state["guide_albedo"],
        "normal": state["guide_normal"],
        "roughness": state["guide_rough"],
        "rays": state["rays"],
    }
    if cfg.denoise_guides:
        aux.update(spec_albedo=state["guide_spec_albedo"], spec_hitdist=state["guide_spec_hitdist"],
                   first_pos_prev=state["guide_pos_prev"])
    return state["radiance"], aux, state["seed"]


def render_frame_flat(scene, bvh, env, frame, cfg: RenderConfig):
    """Render one frame of cfg.spp samples for all W*H pixels, or for the
    pixels that frame["px"], frame["py"] name (int64 [N] each; a shard of
    parallel/, reference pathtrace.py:1344).

    frame: dict(proj_inv [4,4], view_inv [4,4], frame_idx int, accum [N,3],
    total_samples int, pixel_angle float; cam_jitter [2] under taa_jitter,
    prev_rn_o2w [R,16] with the guides). Returns (new_accum, aux) over the N
    pixels; with the guides aux also holds lum_moments [N,2], the sum over
    the samples of (L, L^2) of their luminance after the clamps. Every
    pixel's samples depend only on its own seed, xxhash32(px, py, frame), so
    a shard's pixels come out as they do in the whole frame.

    With primary_seed, frame["prev_first_rnode"] and ["prev_first_tri"]
    ([W*H] int32, the previous frame's aux; -1 where it saw nothing) seed
    every sample's bounce 0; a shard (frame["px"]) is not seeded, as in the
    reference. With spp_batch and spp > 1 the samples are one batch
    (_render_frame_spp_batched) unless frame["px"] names a shard."""
    cfg.check_supported()
    w, h = cfg.width, cfg.height
    dev = frame["accum"].device
    if "px" in frame:
        px, py = frame["px"], frame["py"]
    else:
        px = torch.arange(w, device=dev).repeat(h)
        py = torch.arange(h, device=dev).repeat_interleave(w)
    n = px.shape[0]
    seed = rng.xxhash32(px, py, torch.full_like(px, int(frame["frame_idx"])))
    sample_pos = torch.stack([px, py], dim=-1).to(torch.float32)
    image_size = torch.tensor([w, h], dtype=torch.float32, device=dev)

    prev_ref = None
    if cfg.primary_seed and "px" not in frame and frame.get("prev_first_rnode") is not None:
        # the previous frame's per-pixel first hit -> this frame's tris row (emit2ref). After an
        # edit that removed render nodes a stale rnode may lie past the table: clamped, as the
        # reference's gather clamps, and the seed is then re-verified like any other
        pix = (py * w + px).long()
        p_rn = frame["prev_first_rnode"][pix].long()
        p_tri = frame["prev_first_tri"][pix].long()
        p_rn_row = torch.clamp(p_rn, 0, bvh.rn_attr_base.shape[0] - 1)
        row = bvh.rn_attr_base[p_rn_row].long() + torch.clamp(p_tri, min=0)
        ref = bvh.emit2ref[torch.clamp(row, 0, bvh.emit2ref.shape[0] - 1)]
        prev_ref = torch.where((p_rn >= 0) & (p_tri >= 0), ref, -1)

    if cfg.spp > 1 and cfg.spp_batch and "px" not in frame:
        return _render_frame_spp_batched(scene, bvh, env, frame, cfg, px, py, image_size)

    total = torch.zeros((n, 3), device=dev)
    rays_total = torch.zeros((), device=dev)
    aux_out = None
    moments = torch.zeros((n, 2), device=dev) if cfg.denoise_guides else None
    for s in range(cfg.spp):
        ug, seed = rng.rand2(seed)
        gauss = 0.5 + ANTIALIASING_STD * rng.sample_gaussian(ug)
        uu, seed = rng.rand2(seed)
        jitter = gauss if s == 0 else uu
        if cfg.taa_jitter and s == 0:
            jitter = frame["cam_jitter"].expand(n, 2)
        ro, rd = generate_rays(sample_pos, jitter, image_size, frame["proj_inv"], frame["view_inv"],
                               orthographic=cfg.orthographic)
        if cfg.aperture > 0.0:
            u1, seed = rng.rand(seed)
            u2, seed = rng.rand(seed)
            ro, rd = apply_depth_of_field(ro, rd, frame["view_inv"], cfg.focal_distance, cfg.aperture, u1, u2)
        rad, aux, seed = path_trace_batch(scene, bvh, env, ro, rd, seed, cfg,
                                          pixel_angle=frame.get("pixel_angle", 0.0),
                                          prev_rn_o2w=frame.get("prev_rn_o2w"), prev_ref=prev_ref)
        rad = _clamp_sample(rad, cfg)
        if moments is not None:
            lum_s = _luminance(rad)
            moments = moments + torch.stack([lum_s, lum_s * lum_s], dim=-1)
        if s == 0:
            aux_out = dict(aux)  # first-hit captures come from sample 0
        total = total + rad
        rays_total = rays_total + aux["rays"]

    aux_out["rays"] = rays_total
    if moments is not None:
        aux_out["lum_moments"] = moments
    return _accumulate(frame, total, cfg.spp), aux_out


def _clamp_sample(rad, cfg: RenderConfig):
    """A rare degenerate sample (0*inf through a near-zero pdf) must not
    poison the accumulation buffer; then the firefly clamp on the mean."""
    rad = torch.nan_to_num(rad, nan=0.0, posinf=0.0, neginf=0.0)
    lum = torch.mean(rad, dim=-1)
    scale = torch.where(lum > cfg.firefly_clamp, cfg.firefly_clamp / torch.clamp(lum, min=1e-20), 1.0)
    return rad * scale[..., None]


def _luminance(rad):
    return 0.2126 * rad[:, 0] + 0.7152 * rad[:, 1] + 0.0722 * rad[:, 2]


def _accumulate(frame, total, k: int):
    """The running mean after k more samples summing to total [N,3]."""
    mean = total / k
    ts = torch.tensor(float(frame["total_samples"]), dtype=torch.float32, device=total.device)
    return (frame["accum"] * ts + mean * k) / (ts + k)


def _render_frame_spp_batched(scene, bvh, env, frame, cfg: RenderConfig, px, py, image_size):
    """cfg.spp samples of every pixel as one path_trace_batch over n*spp
    lanes in sample-major blocks (reference _render_frame_spp_batched,
    ops/pathtrace.py:1244, its non-compact branch). Returns (new_accum, aux)."""
    n, k = px.shape[0], cfg.spp
    dev = px.device
    s_b = torch.arange(k, device=dev).repeat_interleave(n)
    px_b, py_b = px.repeat(k), py.repeat(k)
    seed = rng.xxhash32(px_b, py_b, int(frame["frame_idx"]) * k + s_b)
    sample_pos = torch.stack([px_b, py_b], dim=-1).to(torch.float32)
    ug, seed = rng.rand2(seed)
    gauss = 0.5 + ANTIALIASING_STD * rng.sample_gaussian(ug)
    uu, seed = rng.rand2(seed)
    first = (s_b == 0)[..., None]
    jitter = torch.where(first, gauss, uu)
    if cfg.taa_jitter:
        jitter = torch.where(first, frame["cam_jitter"].expand(n * k, 2), jitter)
    ro, rd = generate_rays(sample_pos, jitter, image_size, frame["proj_inv"], frame["view_inv"],
                           orthographic=cfg.orthographic)
    if cfg.aperture > 0.0:
        u1, seed = rng.rand(seed)
        u2, seed = rng.rand(seed)
        ro, rd = apply_depth_of_field(ro, rd, frame["view_inv"], cfg.focal_distance, cfg.aperture, u1, u2)
    rad, aux, _ = path_trace_batch(scene, bvh, env, ro, rd, seed, cfg, pixel_angle=frame.get("pixel_angle", 0.0),
                                   prev_rn_o2w=frame.get("prev_rn_o2w"))
    rad = _clamp_sample(rad, cfg)
    total = rad.reshape(k, n, 3).sum(dim=0)
    aux_out = {key: (v if key == "rays" else v[:n]) for key, v in aux.items()}  # sample block 0
    if cfg.denoise_guides:
        lum = _luminance(rad)
        aux_out["lum_moments"] = torch.stack([lum.reshape(k, n).sum(dim=0), (lum * lum).reshape(k, n).sum(dim=0)],
                                             dim=-1)
    return _accumulate(frame, total, k), aux_out
