"""Preview renderer: port of vk_gltf_renderer_tpu/ops/preview.py, the
answer to the reference's raster path (fast interactive frames with
simplified lighting, no global illumination).

Visibility is one closest-hit trace per pixel through the traversal
selection; the hit is shaded with the image-based lighting of ops/ibl.py
(diffuse irradiance + split-sum specular, or without products a 5-direction
hemisphere average and one mirror fetch), retroreflection and sheen where
the scene has them, and under the sky one sun-shadow trace. One
continuation trace serves transmissive surfaces (a refracted ray to the
next surface, shaded the same way) and BLEND surfaces (composited over
the next surface along the same ray). RenderConfig.wireframe darkens the
primary hit near its triangle's edges. Every trace routes as the
reference's preview routes it: under "packet" through packet_kernel.
"""

from __future__ import annotations

import math

import torch

from .camera import generate_rays
from .hitstate import get_hit_state_fused, safe_offset_ray
from .ibl import ibl_diffuse, ibl_specular
from .materials_eval import evaluate_material
from .pathtrace import RenderConfig, sample_environment, trace_closest
from .sheen_lut import sheen_albedo
from .sky import _onb
from .traverse import dot3

# the fallback's hemisphere directions in the normal's frame
_FALLBACK_DIRS = ((0.0, 0.0, 1.0), (0.8, 0.0, 0.6), (-0.8, 0.0, 0.6), (0.0, 0.8, 0.6), (0.0, -0.8, 0.6))


def _trace(bvh, ro, rd, cfg: RenderConfig, alive=None):
    return trace_closest(bvh, ro, rd, alive=alive, kernel=cfg.packet_kernel, traversal=cfg.traversal)


def _shade_hit(scene, bvh, env, frame, cfg: RenderConfig, hits, rd, *, sun_shadow: bool):
    """IBL shading of a batch of hits. Returns (color, hit state, pbr, miss)."""
    n = rd.shape[0]
    miss = hits["tri"] < 0
    hs = get_hit_state_fused(bvh.hit_attr, bvh.rn_attr_base, hits, rd)
    mat_id = scene.rn_material[torch.clamp(hits["rnode"], min=0).long()]
    pbr = evaluate_material(scene, mat_id, hs, features=cfg.features)
    N = pbr["N"]

    rough = torch.sqrt(pbr["roughness"][..., 0])
    metal = pbr["metallic"][..., None]
    f0 = 0.04 * (1.0 - metal) + pbr["base_color"] * metal
    ndotv = torch.abs(dot3(N, -rd))
    refl = rd - 2.0 * dot3(rd, N)[..., None] * N

    ibl = frame.get("ibl")
    if ibl is not None:
        irr = ibl_diffuse(ibl, N) * math.pi  # the map stores irradiance / pi
        spec = ibl_specular(ibl, refl, rough, f0, ndotv)
    else:
        t, b = _onb(N)
        irr = torch.zeros((n, 3), device=rd.device)
        for dx, dy, dz in _FALLBACK_DIRS:
            c, _ = sample_environment(env, t * dx + b * dy + N * dz, cfg)
            irr = irr + c * max(dz, 0.0)
        irr = irr * (math.pi / len(_FALLBACK_DIRS))
        spec_env, _ = sample_environment(env, refl, cfg)
        fres = f0 + (1.0 - f0) * ((1.0 - ndotv) ** 5)[..., None]
        spec = spec_env * fres * (1.0 - rough)[..., None]

    if "retroreflection" in cfg.features:
        # the retro lobe looks back toward the viewer
        retro_env, _ = sample_environment(env, -rd, cfg)
        w_r = pbr["retroreflection"][..., None]
        spec = spec * (1.0 - w_r) + retro_env * w_r

    kd = (1.0 - pbr["metallic"])[..., None] * pbr["base_color"]
    color = pbr["emissive"] + kd * irr / math.pi + spec

    if "sheen" in cfg.features:
        # energy-correct sheen under the IBL through the directional-albedo LUT
        e_sheen = sheen_albedo(ndotv, pbr["sheen_roughness"])
        scale = 1.0 - torch.amax(pbr["sheen_color"], dim=-1) * e_sheen
        color = color * scale[..., None] + pbr["sheen_color"] * (e_sheen[..., None] * irr / math.pi)

    if sun_shadow and cfg.env_kind == "sky":
        sun_dir = env.sun_dir
        ndl = torch.clamp(dot3(N, sun_dir), min=0.0)
        sh_org = safe_offset_ray(hs["pos"], hs["geonrm"])
        sh = _trace(bvh, sh_org, sun_dir.expand(n, 3).contiguous(), cfg, alive=(~miss) & (ndl > 0))
        lit = (sh["tri"] < 0).to(torch.float32)
        color = color + kd / math.pi * env.sun_radiance * (ndl * lit * 0.05)[..., None]
    return color, hs, pbr, miss


def _refract(rd, N, eta):
    """Snell refraction of unit rd through the surface normal N (flipped to
    the incident side); total internal reflection reflects."""
    cosi = dot3(rd, N)
    n_eff = torch.where(cosi[..., None] > 0, -N, N)
    ci = torch.abs(cosi)
    k = 1.0 - eta * eta * (1.0 - ci * ci)
    refr = eta[..., None] * rd + (eta * ci - torch.sqrt(torch.clamp(k, min=0.0)))[..., None] * n_eff
    refl = rd - 2.0 * dot3(rd, n_eff)[..., None] * n_eff
    out = torch.where((k < 0.0)[..., None], refl, refr)
    return out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-20)


def render_preview(scene, bvh, env, frame, cfg: RenderConfig):
    """One preview frame over all W*H pixels (row-major). frame: proj_inv,
    view_inv, frame_idx and optionally "ibl" (ops/ibl.build_ibl products).
    Returns (rgb [W*H,3], aux)."""
    w, h = cfg.width, cfg.height
    n = w * h
    dev = frame["proj_inv"].device
    px = torch.arange(w, device=dev).repeat(h)
    py = torch.arange(h, device=dev).repeat_interleave(w)
    sample_pos = torch.stack([px, py], dim=-1).to(torch.float32)
    ro, rd = generate_rays(sample_pos, torch.full((n, 2), 0.5, device=dev),
                           torch.tensor([w, h], dtype=torch.float32, device=dev),
                           frame["proj_inv"], frame["view_inv"], orthographic=cfg.orthographic)
    hits = _trace(bvh, ro, rd, cfg)
    env_color, _ = sample_environment(env, rd, cfg)
    color, hs, pbr, miss = _shade_hit(scene, bvh, env, frame, cfg, hits, rd, sun_shadow=True)

    # one continuation layer: refraction behind transmissive surfaces and
    # over-compositing of BLEND surfaces, through one trace
    has_trans = "transmission" in cfg.features
    has_blend = cfg.alpha_any
    if has_trans or has_blend:
        trans = pbr["transmission"] if has_trans else torch.zeros(n, device=dev)
        alpha = pbr["opacity"] if has_blend else torch.ones(n, device=dev)
        alpha = torch.where(pbr["alpha_mode"] == 2, alpha, 1.0)  # BLEND only
        refracts = trans > 1e-3
        need = (~miss) & (refracts | (alpha < 1.0 - 1e-3))
        ior1 = pbr["ior1"][..., 0] if pbr["ior1"].ndim > 1 else pbr["ior1"]
        eta = 1.0 / torch.clamp(ior1, min=1e-3)
        rd2 = torch.where(refracts[..., None], _refract(rd, pbr["N"], eta), rd)
        # the continuation leaves from the side the ray exits through
        side = torch.sign(dot3(rd2, hs["geonrm"]))[..., None]
        org2 = safe_offset_ray(hs["pos"], hs["geonrm"] * side)
        hits2 = _trace(bvh, org2, rd2, cfg, alive=need)
        color2, _, _, miss2 = _shade_hit(scene, bvh, env, frame, cfg, hits2, rd2, sun_shadow=False)
        env2, _ = sample_environment(env, rd2, cfg)
        behind = torch.where(miss2[..., None], env2, color2)
        if has_trans:
            color = torch.where(need[..., None],
                                color * (1.0 - trans[..., None]) + behind * pbr["base_color"] * trans[..., None],
                                color)
        if has_blend:
            wa = torch.where(need & (alpha < 1.0 - 1e-3), 1.0 - alpha, 0.0)
            color = color * (1.0 - wa[..., None]) + behind * wa[..., None]

    rgb = torch.where(miss[..., None], env_color, color)

    if cfg.wireframe:
        # barycentric distance to the nearest edge, feathered over 0.03
        bu, bv = hits["u"], hits["v"]
        edge = torch.minimum(torch.minimum(bu, bv), 1.0 - bu - bv)
        mixw = torch.where(~miss, torch.clamp(1.0 - edge / 0.03, 0.0, 1.0), 0.0)
        rgb = rgb * (1.0 - 0.85 * mixw[..., None])

    aux = {
        "first_rnode": torch.where(miss, -1, hits["rnode"]),
        "solid": ~miss,
        "first_pos": hs["pos"],
        "albedo": pbr["base_color"],
        "normal": pbr["N"],
        "roughness": torch.sqrt(pbr["roughness"][..., 0]),
        "rays": torch.sum((~miss).to(torch.float32)) + n,
    }
    return rgb, aux
