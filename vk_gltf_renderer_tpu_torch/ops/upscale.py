"""Temporal upsampling (TAAU): port of vk_gltf_renderer_tpu/ops/upscale.py.

The render-low / display-high half of the reference's DLSS-RR role: each
low-resolution frame point-samples its pixels at a Halton(2,3) subpixel
jitter (RenderConfig.taa_jitter puts sample 0 there), and temporal_upscale
folds it into a display-resolution running weighted average, reprojected
through the motion vectors and clamped to the current 3x3 neighbourhood.

  cur_lo     [h,w,3]  this frame's low-res radiance, sampled at pixel + jitter
  motion_lo  [h,w,2]  screen motion in low-res pixels (ops/temporal.py)
  jitter     [2]      this frame's subpixel sample position in [0,1)
  history_hi [H,W,4]  display-res rgb + accumulated weight (None on frame 0)

Plain torch, as the reference is plain XLA.
"""

from __future__ import annotations

import numpy as np
import torch


def halton(index: int, base: int) -> float:
    """Radical inverse of index + 1 in `base` (index 0 would give 0)."""
    f, r = 1.0, 0.0
    i = int(index) + 1
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def halton23(index: int) -> np.ndarray:
    """Frame `index`'s subpixel sample position in [0,1)^2."""
    return np.array([halton(index, 2), halton(index, 3)], np.float32)


def _bilinear(img, sx, sy):
    """Bilinear lookup of img [h,w,C] at continuous pixel coordinates,
    clamped to the image."""
    h, w = img.shape[:2]
    sx = torch.clamp(sx, 0.0, w - 1.0)
    sy = torch.clamp(sy, 0.0, h - 1.0)
    x0 = torch.floor(sx).to(torch.int64)
    y0 = torch.floor(sy).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    return (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x1] * fx * (1 - fy)
        + img[y1, x0] * (1 - fx) * fy
        + img[y1, x1] * fx * fy
    )


def _neighbourhood(img):
    """(lo, hi): the per-channel min and max over each pixel's 3x3
    neighbourhood, wrapping at the borders."""
    lo = hi = img
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb = torch.roll(img, (dy, dx), dims=(0, 1))
            lo = torch.minimum(lo, nb)
            hi = torch.maximum(hi, nb)
    return lo, hi


def temporal_upscale(cur_lo, motion_lo, jitter, history_hi, scale: int, decay=0.96, clamp_k=2.0):
    """One TAAU step: the new display-res history [h*scale, w*scale, 4]
    (rgb + accumulated sample weight). Each display pixel gathers the
    jittered samples bilinearly on the shifted grid and weights them by a
    Gaussian (sigma 0.22 display px, floor 0.004) of the nearest sample's
    distance to its centre; history ages by `decay`, is clamped to the
    3x3 neighbourhood (a clamp that moves it restarts its weight at 1) and
    its weight is capped at 25."""
    h, w = cur_lo.shape[:2]
    hh, ww = h * scale, w * scale
    dev = cur_lo.device
    ys, xs = torch.meshgrid(torch.arange(hh, dtype=torch.float32, device=dev),
                            torch.arange(ww, dtype=torch.float32, device=dev), indexing="ij")
    # display-pixel centres in low-res continuous coordinates (corner origin)
    lx = (xs + 0.5) / scale
    ly = (ys + 0.5) / scale
    jitter = torch.as_tensor(jitter, dtype=torch.float32, device=dev)
    jx, jy = jitter[0], jitter[1]

    # sample i sits at i + j, so the fractional index on the sample grid is l - j
    cur_up = _bilinear(cur_lo, lx - jx, ly - jy)
    dx = (lx - jx) - torch.round(lx - jx)
    dy = (ly - jy) - torch.round(ly - jy)
    d2 = (dx * dx + dy * dy) * (scale * scale)
    w_f = torch.exp(-d2 / (2.0 * 0.22 * 0.22)) + 0.004

    if history_hi is None:
        return torch.cat([cur_up, w_f[..., None]], dim=-1)

    # reproject history (rgb and weight) through the display-scaled motion
    mvx = _bilinear(motion_lo[..., 0:1], lx - 0.5, ly - 0.5)[..., 0] * scale
    mvy = _bilinear(motion_lo[..., 1:2], lx - 0.5, ly - 0.5)[..., 0] * scale
    sx = xs + mvx
    sy = ys + mvy
    in_bounds = (sx >= 0) & (sx <= ww - 1) & (sy >= 0) & (sy <= hh - 1)
    hist4 = _bilinear(history_hi, sx, sy)
    hist = hist4[..., :3]
    w_h = torch.clamp(hist4[..., 3], min=0.0) * decay * in_bounds

    lo, hi = _neighbourhood(cur_up)
    center = (lo + hi) * 0.5
    extent = (hi - lo) * 0.5 * clamp_k + 1e-4
    clamped = torch.clamp(hist, center - extent, center + extent)
    moved = torch.amax(torch.abs(clamped - hist), dim=-1) > extent[..., 0] * 0.5
    w_h = torch.where(moved, torch.clamp(w_h, max=1.0), w_h)

    w_new = w_h + w_f
    rgb = (clamped * w_h[..., None] + cur_up * w_f[..., None]) / w_new[..., None]
    w_new = torch.clamp(w_new, max=25.0)
    return torch.cat([rgb, w_new[..., None]], dim=-1)
