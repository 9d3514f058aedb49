"""Path tracer: one frame of samples over all pixels (port of the
non-compact path of vk_gltf_renderer_tpu/ops/pathtrace.py).

Rays live in [N] / [N,3] tensors with an `alive` mask; each bounce is
intersect -> environment hit -> shade -> NEE with a deferred shadow ray ->
BSDF sample -> Russian roulette, and the loop stops once every lane is
dead. Lanes stay in row-major pixel order throughout: every lane carries
its own RNG stream seeded from xxhash32(px, py, frame), so the TPU-only
ray reordering of the reference (tile order, co-sorts, bucket ladder,
trace_width padding) changes no pixel and is not ported.

Semantics kept from the reference (anchors in its module docstring):
Gaussian subpixel AA, env-miss MIS, emissive add, NEE against the
environment, deferred shadow ray, Russian roulette from depth 3, the
roughness regularisation, NaN sanitising, the firefly clamp on mean
luminance, running-mean accumulation and the directly visible HDR
background at full resolution.

Traversals (the reference's switch, RenderConfig.traversal): under
"packet", bounce 0's closest-hit trace uses RenderConfig.primary_kernel;
every later bounce and every shadow ray, bounce 0's included, uses
packet_kernel (the reference's mapping under its default
VKGR_PEEL_SORT_SHADOW=1, ops/pathtrace.py:780 and :1130-1134), and
ops/intersect.py routes each name to its CUDA kernel. Under "packet4"
every trace, primary, bounce and shadow, goes to the split BVH4 kernel
(intersect_rays_packet(wide=True)), under "wavefront" to the stackless
walk (intersect_rays_wavefront); neither reads the kernel names, and both
trace shadow rays closest hit, as the reference's do (ops/pathtrace.py
:404-411).

Not ported yet (RenderConfig.check_supported raises NotImplementedError):
punctual lights, stochastic alpha, transmission / volume and the other
material extensions, the infinite plane, denoiser guides, TAA jitter,
batched spp and primary-hit seeding.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import rng
from .bsdf import DIRAC, EVENT_ABSORB, bsdf_evaluate, bsdf_sample
from .camera import apply_depth_of_field, generate_rays
from .hdr import eval_hdr, sample_hdr
from .hitstate import get_hit_state_fused, safe_offset_ray
from .materials_eval import evaluate_material, unsupported_features
from .sky import eval_sky, pdf_sky, sample_sky
from .intersect import (TRAVERSALS, intersect_rays_packet, intersect_rays_soa,
                        intersect_rays_wavefront, route)
from .traverse import INFINITE, dot3

ANTIALIASING_STD = 0.4246609
RR_MIN_DEPTH = 3


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
    alpha_any: bool = False
    firefly_clamp: float = 10.0
    aperture: float = 0.0
    focal_distance: float = 0.0
    orthographic: bool = False
    background: tuple | None = None  # solid backplate for primary misses
    use_infinite_plane: bool = False
    denoise_guides: bool = False
    taa_jitter: bool = False
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
        missing = [name for name, on in (
            ("punctual lights", self.has_lights),
            ("alpha (MASK/BLEND materials)", self.alpha_any),
            ("infinite plane / shadow catcher", self.use_infinite_plane),
            ("denoiser guides", self.denoise_guides),
            ("TAA jitter", self.taa_jitter),
            ("batched spp", self.spp_batch and self.spp > 1),
            ("primary-hit seeding", self.primary_seed),
        ) if on]
        missing += unsupported_features(self.features)
        if self.env_kind not in ("sky", "hdr"):
            missing.append(f"environment kind {self.env_kind!r}")
        if missing:
            raise NotImplementedError(
                "not ported to the torch path tracer yet: " + ", ".join(missing))
        self.kernel_tables()  # raises for unknown traversals and kernel names

    def kernel_tables(self) -> set:
        """Table families the selected traversal reads: ops/intersect.ROUTES
        of both kernel names under "packet", "bvh4_split" under "packet4",
        "wavefront" under "wavefront". Raises ValueError for anything else."""
        if self.traversal == "packet4":
            return {"bvh4_split"}
        if self.traversal == "wavefront":
            return {"wavefront"}
        if self.traversal != "packet":
            raise ValueError(f"unknown traversal {self.traversal!r}; accepted: {list(TRAVERSALS)}")
        return {route(self.primary_kernel), route(self.packet_kernel)}


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
    c = [x.contiguous() for x in (ro[:, 0], ro[:, 1], ro[:, 2], rd[:, 0], rd[:, 1], rd[:, 2])]
    return intersect_rays_soa(bvh, *c, tmin_b, tmax.contiguous(), anyhit=anyhit, kernel=kernel)


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


def _sample_lights(env, pos, seed, cfg: RenderConfig):
    """NEE technique pick, environment branch (the only technique without
    punctual lights). Consumes the same random numbers as the reference's
    _sample_lights so the streams stay aligned. Returns (DirectLight dict,
    seed)."""
    env_w = 1.0
    _, seed = rng.rand(seed)  # the light/env technique pick
    u3, seed = rng.rand3(seed)
    e_dir, e_rad, e_pdf = sample_environment_dir(env, u3, cfg)
    radiance = e_rad / torch.clamp(e_pdf * env_w, min=1e-20)[..., None]
    pdf_sum = env_w * e_pdf
    mis = (env_w * e_pdf) / torch.clamp(pdf_sum, min=1e-20)
    radiance = radiance * mis[..., None]
    distance = torch.full(pos.shape[:-1], INFINITE, device=pos.device)
    return {"direction": e_dir, "radiance_over_pdf": radiance, "distance": distance,
            "pdf": pdf_sum}, seed


def _trace_shadow(bvh, ro, rd, dist, alive, cfg):
    """Opaque shadow factor [N,1]: one any-hit occlusion test."""
    hits = trace_closest(bvh, ro, rd, tmin=0.0, tmax=dist, alive=alive, anyhit=True,
                         kernel=cfg.packet_kernel, traversal=cfg.traversal)
    return torch.where((hits["tri"] >= 0)[..., None], 0.0, 1.0)


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


def path_trace_batch(scene, bvh, env, ro, rd, seed, cfg: RenderConfig, pixel_angle=0.0):
    """Trace one sample per lane. Returns (radiance [N,3], aux dict, seed)."""
    n = ro.shape[0]
    dev = ro.device

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
        solid=torch.ones(n, dtype=torch.bool, device=dev),
        first_pos=torch.full((n, 3), 1e34, device=dev),
        first_rnode=torch.full((n,), -1, dtype=torch.int32, device=dev),
        first_tri=torch.full((n,), -1, dtype=torch.int32, device=dev),
        guide_albedo=zeros(3),
        guide_normal=zeros(3),
        guide_rough=zeros(),
        cone_width=zeros(),
        seed=seed,
        rays=torch.zeros((), device=dev),
    )
    feats = cfg.features

    def bounce(state, depth):
        ro, rd = state["ro"], state["rd"]
        alive = state["alive"]
        seed = state["seed"]
        radiance = state["radiance"]
        throughput = state["throughput"]
        first = depth == 0

        state["rays"] = state["rays"] + torch.sum(alive.to(torch.float32))
        hits = trace_closest(bvh, ro, rd, alive=alive,
                             kernel=cfg.primary_kernel if first else cfg.packet_kernel,
                             traversal=cfg.traversal)
        miss = hits["tri"] < 0

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

        # surface shading with ray-cone texture LOD
        hs = get_hit_state_fused(bvh.hit_attr, bvh.rn_attr_base, hits, rd)
        mat_id = scene.rn_material[torch.clamp(hits["rnode"], min=0).long()]
        world_foot = (state["cone_width"] + pixel_angle * hits["t"]) / torch.clamp(
            torch.abs(dot3(hs["nrm"], -rd)), min=1e-3)
        tex_grad = world_foot * hs["texel_density"]
        state["cone_width"] = torch.where(lane_hit, world_foot, state["cone_width"])
        pbr = evaluate_material(scene, mat_id, hs, features=feats, tex_lod=tex_grad)

        if first:
            fh = lane_hit
            state["first_pos"] = torch.where(fh[..., None], hs["pos"], state["first_pos"])
            state["first_rnode"] = torch.where(fh, hits["rnode"], state["first_rnode"])
            state["first_tri"] = torch.where(fh, hits["tri"], state["first_tri"])
            state["guide_albedo"] = torch.where(fh[..., None], pbr["base_color"], state["guide_albedo"])
            state["guide_normal"] = torch.where(fh[..., None], pbr["N"], state["guide_normal"])
            state["guide_rough"] = torch.where(fh, torch.sqrt(pbr["roughness"][..., 0]), state["guide_rough"])

        # roughness regularisation
        state["max_rough"] = torch.maximum(state["max_rough"], pbr["roughness"])
        pbr["roughness"] = torch.where(lane_hit[..., None], state["max_rough"], pbr["roughness"])

        radiance = radiance + torch.where(lane_hit[..., None], pbr["emissive"] * throughput, 0.0)

        # next-event estimation
        dl, seed = _sample_lights(env, hs["pos"], seed, cfg)
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
        u3b, seed = rng.rand3(seed)
        ue, seed = rng.rand2(seed)
        samp = bsdf_sample(pbr, -rd, u3b, ue, feats)
        throughput = torch.where(lane_hit[..., None], throughput * samp["bsdf_over_pdf"], throughput)
        state["last_pdf"] = torch.where(lane_hit, samp["pdf"], state["last_pdf"])
        new_dir = samp["k2"]
        absorbed = lane_hit & (samp["event"] == EVENT_ABSORB)

        offset_dir = torch.where((dot3(new_dir, hs["geonrm"]) > 0)[..., None], hs["geonrm"], -hs["geonrm"])
        new_org = safe_offset_ray(hs["pos"], offset_dir)

        # deferred shadow ray
        state["rays"] = state["rays"] + torch.sum(next_event.to(torch.float32))
        sh_fwd = (dot3(dl["direction"], hs["nrm"]) > 0.0)[..., None]
        sh_base = torch.where(sh_fwd, hs["shadow_pos"], hs["pos"])
        sh_off = torch.where(sh_fwd, hs["geonrm"], -hs["geonrm"])
        sh_org = safe_offset_ray(sh_base, sh_off)
        shadow = _trace_shadow(bvh, sh_org, dl["direction"], dl["distance"], next_event, cfg)
        radiance = radiance + torch.where(next_event[..., None], contrib * shadow, 0.0)

        alive = alive & ~absorbed
        ro = torch.where(alive[..., None], new_org, ro)
        rd = torch.where(alive[..., None], new_dir, rd)

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
    return state["radiance"], aux, state["seed"]


def render_frame_flat(scene, bvh, env, frame, cfg: RenderConfig):
    """Render one frame of cfg.spp samples for all W*H pixels.

    frame: dict(proj_inv [4,4], view_inv [4,4], frame_idx int, accum [W*H,3],
    total_samples int, pixel_angle float). Returns (new_accum, aux)."""
    cfg.check_supported()
    w, h = cfg.width, cfg.height
    dev = frame["accum"].device
    n = w * h
    px = torch.arange(w, device=dev).repeat(h)
    py = torch.arange(h, device=dev).repeat_interleave(w)
    seed = rng.xxhash32(px, py, torch.full_like(px, int(frame["frame_idx"])))
    sample_pos = torch.stack([px, py], dim=-1).to(torch.float32)
    image_size = torch.tensor([w, h], dtype=torch.float32, device=dev)

    total = torch.zeros((n, 3), device=dev)
    rays_total = torch.zeros((), device=dev)
    aux_out = None
    for s in range(cfg.spp):
        ug, seed = rng.rand2(seed)
        gauss = 0.5 + ANTIALIASING_STD * rng.sample_gaussian(ug)
        uu, seed = rng.rand2(seed)
        jitter = gauss if s == 0 else uu
        ro, rd = generate_rays(sample_pos, jitter, image_size, frame["proj_inv"], frame["view_inv"],
                               orthographic=cfg.orthographic)
        if cfg.aperture > 0.0:
            u1, seed = rng.rand(seed)
            u2, seed = rng.rand(seed)
            ro, rd = apply_depth_of_field(ro, rd, frame["view_inv"], cfg.focal_distance, cfg.aperture, u1, u2)
        rad, aux, seed = path_trace_batch(scene, bvh, env, ro, rd, seed, cfg,
                                          pixel_angle=frame.get("pixel_angle", 0.0))
        # a rare degenerate sample (0*inf through a near-zero pdf) must not
        # poison the accumulation buffer
        rad = torch.nan_to_num(rad, nan=0.0, posinf=0.0, neginf=0.0)
        lum = torch.mean(rad, dim=-1)
        scale = torch.where(lum > cfg.firefly_clamp, cfg.firefly_clamp / torch.clamp(lum, min=1e-20), 1.0)
        rad = rad * scale[..., None]
        if s == 0:
            aux_out = dict(aux)  # first-hit captures come from sample 0
        total = total + rad
        rays_total = rays_total + aux["rays"]

    mean = total / cfg.spp
    ts = torch.tensor(float(frame["total_samples"]), dtype=torch.float32, device=dev)
    new_accum = (frame["accum"] * ts + mean * cfg.spp) / (ts + cfg.spp)
    aux_out["rays"] = rays_total
    return new_accum, aux_out
