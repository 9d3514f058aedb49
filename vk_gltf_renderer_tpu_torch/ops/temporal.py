"""Temporal reprojection and accumulation: port of
vk_gltf_renderer_tpu/ops/temporal.py.

  motion_vectors(first_pos, solid, prev_vp, cur_vp, w, h) -> [H,W,2] px
  temporal_accumulate(cur, history, motion, valid)       -> blended history

The first-hit world position is projected with this frame's and the
previous frame's view-projection; the sky projects as a point at infinity
(w = 0). With first_pos_prev (the path tracer's instance-motion guide,
from the previous frame's per-node transforms) the motion covers moving
instances too; skin and morph vertex motion is not tracked, as in the
reference. Plain torch.
"""

from __future__ import annotations

import torch

from .upscale import _bilinear, _neighbourhood


def _project(vp, p, w_comp):
    """Project [H,W,3] points with the 4x4 vp (column vectors); w_comp 0
    projects directions."""
    x = vp[0, 0] * p[..., 0] + vp[0, 1] * p[..., 1] + vp[0, 2] * p[..., 2] + vp[0, 3] * w_comp
    y = vp[1, 0] * p[..., 0] + vp[1, 1] * p[..., 1] + vp[1, 2] * p[..., 2] + vp[1, 3] * w_comp
    w = vp[3, 0] * p[..., 0] + vp[3, 1] * p[..., 1] + vp[3, 2] * p[..., 2] + vp[3, 3] * w_comp
    w = torch.where(torch.abs(w) < 1e-9, 1e-9, w)
    return x / w, y / w


def motion_vectors(first_pos, solid, prev_vp, cur_vp, width, height, first_pos_prev=None):
    """Per-pixel screen motion in pixels: where the surface point was last
    frame minus where it is now. first_pos_prev (optional) replaces the
    point's previous position on solid pixels."""
    w_comp = solid.to(torch.float32)
    px_c, py_c = _project(cur_vp, first_pos, w_comp)
    prev_world = first_pos if first_pos_prev is None else torch.where(
        solid[..., None], first_pos_prev, first_pos)
    px_p, py_p = _project(prev_vp, prev_world, w_comp)

    def to_px(x, y):
        return (x * 0.5 + 0.5) * width, (y * 0.5 + 0.5) * height

    cx, cy = to_px(px_c, py_c)
    px, py = to_px(px_p, py_p)
    return torch.stack([px - cx, py - cy], dim=-1)


def temporal_accumulate(cur, history, motion, valid, alpha=0.15, clamp_k=1.5):
    """Blend the current frame [H,W,3] into the history sampled bilinearly
    at pixel + motion and clamped to the current 3x3 neighbourhood; pixels
    that are not valid or whose history lies outside the frame take the
    current frame."""
    h, w = cur.shape[:2]
    dev = cur.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    sx = xs + motion[..., 0]
    sy = ys + motion[..., 1]
    in_bounds = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    hist = _bilinear(history, sx, sy)

    lo, hi = _neighbourhood(cur)
    center = (lo + hi) * 0.5
    extent = (hi - lo) * 0.5 * clamp_k + 1e-4
    hist = torch.clamp(hist, center - extent, center + extent)

    keep = (valid & in_bounds)[..., None]
    return torch.where(keep, hist * (1 - alpha) + cur * alpha, cur)
