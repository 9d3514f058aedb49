"""Camera ray generation and thin-lens depth of field (reference
vk_gltf_renderer_tpu/ops/camera.py). Column-vector matrices; elementwise
f32 math only."""

from __future__ import annotations

import math

import torch

from .traverse import dot3


def _mat4_vec4(m, v):
    return (
        m[:, 0] * v[..., 0, None]
        + m[:, 1] * v[..., 1, None]
        + m[:, 2] * v[..., 2, None]
        + m[:, 3] * v[..., 3, None]
    )


def generate_rays(sample_pos, jitter, image_size, proj_inv, view_inv, *, orthographic=False):
    """sample_pos: [N,2] pixel coords; jitter: [N,2] subpixel offset;
    image_size: [2] tensor (w, h). Returns (origins [N,3], dirs [N,3])."""
    clip = (sample_pos + jitter) / image_size * 2.0 - 1.0
    n = clip.shape[0]
    ones = torch.ones((n, 1), dtype=clip.dtype, device=clip.device)
    clip4 = torch.cat([clip, -ones, ones], dim=-1)
    view = _mat4_vec4(proj_inv, clip4)
    view = view / view[..., 3:4]
    if orthographic:
        origins = _mat4_vec4(view_inv, view)[..., :3]
        fwd = _mat4_vec4(view_inv, torch.tensor([0.0, 0.0, -1.0, 0.0], device=clip.device))[..., :3]
        dirs = (fwd / torch.sqrt(dot3(fwd, fwd))).expand(origins.shape)
    else:
        origin = view_inv[:3, 3]
        world = _mat4_vec4(view_inv, view)[..., :3]
        d = world - origin
        dirs = d / torch.sqrt(dot3(d, d))[..., None]
        origins = origin.expand(dirs.shape)
    return origins.contiguous(), dirs.contiguous()


def apply_depth_of_field(origins, dirs, view_inv, focal_dist, aperture, u1, u2):
    """Thin lens: offset the origin on the aperture disk, re-aim at the
    focal point."""
    theta = u1 * 2.0 * math.pi
    r = torch.sqrt(u2 * aperture)
    cam_right = view_inv[:3, 0]
    cam_up = view_inv[:3, 1]
    offset = (torch.cos(theta)[..., None] * cam_right + torch.sin(theta)[..., None] * cam_up) * r[..., None]
    focal_point = focal_dist * dirs
    new_dir = focal_point - offset
    new_dir = new_dir / torch.sqrt(dot3(new_dir, new_dir))[..., None]
    return origins + offset, new_dir


def pixel_angle(fovy: float, image_height: int) -> float:
    """Angular size of one pixel (ray-cone texture LOD)."""
    return float(2.0 * math.tan(fovy * 0.5) / image_height)
