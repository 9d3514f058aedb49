"""Punctual light sampling (KHR_lights_punctual); port of
vk_gltf_renderer_tpu/ops/lights.py.

Directional lights with an angular size (a cone-sampled soft sun), point
and spot lights with a radius (sphere-sampled soft shadows), the spot
cone falloff and inverse-square falloff with the glTF range window. The
pdf is DIRAC for hard (zero-extent) lights. The light tables are the ones
ops/flat._build_lights builds (convert.DeviceScene.light_*).
"""

from __future__ import annotations

import math

import torch

from .bsdf import DIRAC
from .sky import _onb
from .traverse import dot3

LIGHT_DIRECTIONAL, LIGHT_SPOT, LIGHT_POINT = 1, 2, 3


def sample_one_light(scene, light_idx, pos, normal, u2):
    """Sample light `light_idx` ([N] int) from `pos` ([N,3]); `normal` is
    the reference's argument, which it does not read. Returns
    dict(direction [N,3] to the light, distance, intensity [N,3] (the
    radiance contribution before the pdf division), pdf)."""
    del normal
    li = light_idx.long()
    lt = scene.light_type[li]
    lpos = scene.light_pos[li]
    ldir = scene.light_dir[li]
    color = scene.light_color[li] * scene.light_intensity[li][..., None]
    radius = scene.light_radius[li]
    ang_or_inv = scene.light_angular_or_invrange[li]

    is_dir = lt == LIGHT_DIRECTIONAL

    # directional: a cone around -ldir of the light's angular size
    half_ang = ang_or_inv * 0.5
    cos_half = torch.cos(half_ang)
    t, b = _onb(-ldir)
    cos_t = 1.0 - u2[..., 0] * (1.0 - cos_half)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u2[..., 1]
    dir_cone = (
        t * (torch.cos(phi) * sin_t)[..., None]
        + b * (torch.sin(phi) * sin_t)[..., None]
        + (-ldir) * cos_t[..., None]
    )
    dir_solid_angle = 2.0 * math.pi * (1.0 - cos_half)
    dir_is_soft = dir_solid_angle > 1e-9
    # directional intensity is illuminance (lux): the contribution is the
    # color itself, spread over the cone by the pdf
    dir_pdf = torch.where(dir_is_soft, 1.0 / torch.clamp(dir_solid_angle, min=1e-9), DIRAC)

    # point / spot: sample the visible cone of the sphere of `radius` around lpos
    to_light = lpos - pos
    dist2 = torch.clamp(dot3(to_light, to_light), min=1e-12)
    dist = torch.sqrt(dist2)
    w_center = to_light / dist[..., None]
    sin_max2 = torch.clamp(radius * radius / dist2, 0.0, 0.9999)
    cos_max = torch.sqrt(1.0 - sin_max2)
    ts, bs = _onb(w_center)
    cos_ts = 1.0 - u2[..., 0] * (1.0 - cos_max)
    sin_ts = torch.sqrt(torch.clamp(1.0 - cos_ts * cos_ts, min=0.0))
    w_samp = (
        ts * (torch.cos(phi) * sin_ts)[..., None]
        + bs * (torch.sin(phi) * sin_ts)[..., None]
        + w_center * cos_ts[..., None]
    )
    sphere_solid_angle = 2.0 * math.pi * (1.0 - cos_max)
    soft = (radius > 0.0) & (sphere_solid_angle > 1e-9)
    pt_dir = torch.where(soft[..., None], w_samp, w_center)
    pt_pdf = torch.where(soft, 1.0 / torch.clamp(sphere_solid_angle, min=1e-9), DIRAC)

    # inverse-square falloff with the optional range window (glTF punctual spec)
    atten = 1.0 / dist2
    inv_range = ang_or_inv
    rng_t = torch.clamp(1.0 - (dist * inv_range) ** 4, 0.0, 1.0)
    atten = atten * torch.where(inv_range > 0, rng_t, 1.0)

    # spot cone falloff
    cd = dot3(ldir, -pt_dir)
    cone = scene.light_cone[li]
    spot_t = torch.clamp((cd - cone[..., 0]) * cone[..., 1], 0.0, 1.0)
    spot_fall = spot_t * spot_t
    atten = atten * torch.where(lt == LIGHT_SPOT, spot_fall, 1.0)

    intensity = torch.where(is_dir[..., None], color, color * atten[..., None])
    direction = torch.where(is_dir[..., None], dir_cone, pt_dir)
    distance = torch.where(is_dir, 1e32, dist)
    pdf = torch.where(is_dir, dir_pdf, pt_pdf)
    return {"direction": direction, "distance": distance, "intensity": intensity, "pdf": pdf}
