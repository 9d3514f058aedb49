"""Gizmo handle rendering — the visual half of the transform gizmo, in
torch on the displayed frame's device (reference
vk_gltf_renderer_tpu/ops/gizmo_draw.py).

The reference draws its translate/rotate/scale handles as raster geometry
(src/gizmo_transform_vk.cpp + shaders/gizmo_visuals.slang:1-118: colored
axis shafts with cone tips, quarter plane quads, great-circle rings, a
center cube, with the hovered handle highlighted). This module draws the
same handle set as an analytic screen-space composite over the displayed
frame, like ops/grid.py: the few 3D handle points are projected through
the view camera on the host (float64 numpy), and each primitive's
antialiased coverage is computed and alpha-blended on the device tensor
inside its pixel bbox.

Display-side by design: handles are a viewer affordance, not scene
content. The interaction math the handles visualize lives in gizmo.py
(pick_handle/begin_drag/drag_delta); this module shares its handle ids
and layout constants so what is drawn is exactly what pick_handle grabs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..gizmo import (
    AXIS_X,
    AXIS_Y,
    AXIS_Z,
    PLANE_XY,
    PLANE_YZ,
    PLANE_ZX,
    RING_X,
    RING_Y,
    RING_Z,
    UNIFORM,
    Mode,
)
from .grid import camera_basis

# handle palette (reference gizmo colors: X red / Y green / Z blue,
# hovered handle flips to yellow-white)
AXIS_COLORS = (
    np.float32([0.92, 0.26, 0.26]),  # X
    np.float32([0.30, 0.82, 0.32]),  # Y
    np.float32([0.30, 0.47, 0.95]),  # Z
)
HILIGHT = np.float32([1.0, 0.92, 0.25])
CENTER_COLOR = np.float32([0.88, 0.88, 0.88])

# plane-quad extents as a fraction of gizmo size — MUST match
# gizmo.pick_handle's 0.25..0.6 grab window so the drawn quad is the
# clickable region.
PLANE_LO, PLANE_HI = 0.25, 0.6


class _Camera:
    """World -> pixel projection matching ops/grid.py's ray generation
    (same basis, same FOV convention) so overlays line up exactly."""

    def __init__(self, eye, center, up, yfov, width, height):
        self.eye, self.fwd, self.right, self.up = camera_basis(eye, center, up)
        self.w, self.h = width, height
        self.t = np.tan(yfov * 0.5)

    def project(self, pts: np.ndarray):
        """[N,3] world -> ([N,2] pixel xy, [N] in-front mask).

        Inverts grid.py's mapping: pixel (x+0.5)/w and (0.5 - (y+0.5)/h)
        against the camera-plane coordinates.
        """
        pts = np.atleast_2d(np.asarray(pts, np.float64))
        rel = pts - self.eye
        z = rel @ self.fwd
        front = z > 1e-9
        zs = np.where(front, z, 1.0)
        cx = (rel @ self.right) / (zs * self.t * (self.w / self.h))
        cy = (rel @ self.up) / (zs * self.t)
        px = (cx * 0.5 + 0.5) * self.w - 0.5
        py = (0.5 - cy * 0.5) * self.h - 0.5
        return np.stack([px, py], axis=-1), front


def _blend(img, xy0, cov, color, alpha):
    """Alpha-blend coverage [h,w] at integer offset xy0 into img, in place."""
    x0, y0 = xy0
    h, w = cov.shape
    a = (cov * alpha)[..., None].to(torch.float32)
    sub = img[y0:y0 + h, x0:x0 + w]
    c = torch.tensor(color, dtype=torch.float32, device=img.device)
    img[y0:y0 + h, x0:x0 + w] = sub * (1.0 - a) + c[None, None, :] * a


def _bbox_grid(img, lo, hi, pad):
    """Clamped integer bbox + pixel-center coordinate grids (float64, on
    the image's device), or None."""
    h, w = img.shape[:2]
    x0 = max(int(np.floor(lo[0] - pad)), 0)
    y0 = max(int(np.floor(lo[1] - pad)), 0)
    x1 = min(int(np.ceil(hi[0] + pad)) + 1, w)
    y1 = min(int(np.ceil(hi[1] + pad)) + 1, h)
    if x0 >= x1 or y0 >= y1:
        return None
    ys, xs = torch.meshgrid(torch.arange(y0, y1, dtype=torch.float64, device=img.device),
                            torch.arange(x0, x1, dtype=torch.float64, device=img.device), indexing="ij")
    return (x0, y0), xs, ys


def _draw_segment(img, a, b, color, width_px=1.6, alpha=1.0):
    """AA line segment between pixel points a, b."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    g = _bbox_grid(img, np.minimum(a, b), np.maximum(a, b), width_px + 1.5)
    if g is None:
        return
    xy0, xs, ys = g
    d = b - a
    len2 = float(d @ d)
    if len2 < 1e-12:
        t = torch.zeros_like(xs)
    else:
        t = torch.clamp(((xs - a[0]) * d[0] + (ys - a[1]) * d[1]) / len2, 0.0, 1.0)
    dist = torch.hypot(xs - (a[0] + t * d[0]), ys - (a[1] + t * d[1]))
    cov = torch.clamp(width_px * 0.5 + 0.75 - dist, 0.0, 1.0)
    _blend(img, xy0, cov, color, alpha)


def _draw_poly(img, pts, color, alpha):
    """AA-filled convex polygon (pixel-space points, CCW or CW)."""
    pts = np.asarray(pts, np.float64)
    g = _bbox_grid(img, pts.min(0), pts.max(0), 1.5)
    if g is None:
        return
    xy0, xs, ys = g
    n = len(pts)
    # signed edge distances; flip so inside is positive for either winding
    area = 0.0
    for i in range(n):
        j = (i + 1) % n
        area += pts[i, 0] * pts[j, 1] - pts[j, 0] * pts[i, 1]
    sign = 1.0 if area > 0 else -1.0
    inside = torch.full(xs.shape, torch.inf, dtype=torch.float64, device=img.device)
    for i in range(n):
        j = (i + 1) % n
        e = pts[j] - pts[i]
        elen = max(np.hypot(*e), 1e-12)
        d = sign * ((xs - pts[i, 0]) * e[1] - (ys - pts[i, 1]) * e[0]) / elen
        inside = torch.minimum(inside, -d)
    cov = torch.clamp(inside + 0.5, 0.0, 1.0)
    _blend(img, xy0, cov, color, alpha)


def _draw_disc(img, c, radius_px, color, alpha=1.0):
    c = np.asarray(c, np.float64)
    g = _bbox_grid(img, c, c, radius_px + 1.5)
    if g is None:
        return
    xy0, xs, ys = g
    cov = torch.clamp(radius_px + 0.5 - torch.hypot(xs - c[0], ys - c[1]), 0.0, 1.0)
    _blend(img, xy0, cov, color, alpha)


def _draw_polyline(img, pts, front, color, width_px=1.6, alpha=1.0):
    for i in range(len(pts) - 1):
        if front[i] and front[i + 1]:
            _draw_segment(img, pts[i], pts[i + 1], color, width_px, alpha)


def auto_size(eye, pivot, yfov) -> float:
    """World-space gizmo size ~ 14% of the viewport height at the pivot —
    the reference's view-distance sizing."""
    d = float(np.linalg.norm(np.asarray(pivot, np.float64) - np.asarray(eye, np.float64)))
    return 0.28 * d * np.tan(yfov * 0.5)


def gizmo_overlay(
    img: torch.Tensor,
    eye,
    center,
    up,
    yfov: float,
    pivot,
    axes,
    mode: Mode,
    size: float | None = None,
    active: int | None = None,
) -> torch.Tensor:
    """Composite the gizmo handle set for `mode` onto a [H,W,3] float
    image, on the image's device.

    pivot/axes come from gizmo.handle_frame (world or local space);
    `active` is a handle id from gizmo.pick_handle — drawn highlighted,
    exactly the reference's hover feedback.
    """
    out = img.to(torch.float32).clone()
    h, w = out.shape[:2]
    cam = _Camera(eye, center, up, yfov, w, h)
    pivot = np.asarray(pivot, np.float64)
    axes = np.asarray(axes, np.float64)
    if size is None:
        size = auto_size(eye, pivot, yfov)

    (p0,), (f0,) = cam.project(pivot[None])
    if not f0:
        return out  # pivot behind the camera: nothing to draw

    def col(handle, i):
        return HILIGHT if active == handle else AXIS_COLORS[i]

    if mode in (Mode.TRANSLATE, Mode.SCALE):
        for i, hid in enumerate((AXIS_X, AXIS_Y, AXIS_Z)):
            tip3 = pivot + axes[i] * size
            base3 = pivot + axes[i] * (0.15 * size)  # pick window start
            (pt, pb), (ft, fb) = cam.project(np.stack([tip3, base3]))
            if not (ft and fb):
                continue
            c = col(hid, i)
            _draw_segment(out, pb, pt, c, width_px=1.8)
            if mode == Mode.TRANSLATE:
                # cone tip -> screen-space arrowhead triangle
                d = pt - pb
                n = np.hypot(*d)
                if n > 1e-6:
                    d = d / n
                    perp = np.array([-d[1], d[0]])
                    ah = 0.12 * max(np.hypot(*(pt - p0)), 8.0)
                    _draw_poly(out, [pt + d * ah, pt + perp * ah * 0.45,
                                     pt - perp * ah * 0.45], c, 1.0)
                else:
                    _draw_disc(out, pt, 3.0, c)
            else:
                # cube tip drawn as a small screen square
                s = max(0.035 * np.hypot(*(pt - p0)), 2.5)
                _draw_poly(out, [pt + [-s, -s], pt + [s, -s],
                                 pt + [s, s], pt + [-s, s]], c, 1.0)

    if mode == Mode.TRANSLATE:
        for hid, (ni, ui, vi) in ((PLANE_YZ, (0, 1, 2)),
                                  (PLANE_ZX, (1, 2, 0)),
                                  (PLANE_XY, (2, 0, 1))):
            u3, v3 = axes[ui], axes[vi]
            corners3 = np.stack([
                pivot + u3 * (PLANE_LO * size) + v3 * (PLANE_LO * size),
                pivot + u3 * (PLANE_HI * size) + v3 * (PLANE_LO * size),
                pivot + u3 * (PLANE_HI * size) + v3 * (PLANE_HI * size),
                pivot + u3 * (PLANE_LO * size) + v3 * (PLANE_HI * size),
            ])
            pts, front = cam.project(corners3)
            if not front.all():
                continue
            c = HILIGHT if active == hid else AXIS_COLORS[ni]
            _draw_poly(out, pts, c, 0.38)
            for i in range(4):
                _draw_segment(out, pts[i], pts[(i + 1) % 4], c, 1.2, 0.9)

    if mode == Mode.ROTATE:
        theta = np.linspace(0.0, 2.0 * np.pi, 97)
        for i, hid in enumerate((RING_X, RING_Y, RING_Z)):
            u3 = axes[(i + 1) % 3]
            v3 = axes[(i + 2) % 3]
            circle = (pivot[None, :]
                      + np.cos(theta)[:, None] * u3[None, :] * size
                      + np.sin(theta)[:, None] * v3[None, :] * size)
            pts, front = cam.project(circle)
            _draw_polyline(out, pts, front, col(hid, i), width_px=1.8)

    if mode == Mode.SCALE:
        # center uniform-scale cube (reference draws a small white cube)
        c = HILIGHT if active == UNIFORM else CENTER_COLOR
        s = max(0.05 * size / max(np.linalg.norm(pivot - cam.eye), 1e-9)
                / cam.t * h * 0.5, 3.0)
        _draw_poly(out, [p0 + [-s, -s], p0 + [s, -s],
                         p0 + [s, s], p0 + [-s, s]], c, 1.0)
    elif mode == Mode.TRANSLATE:
        _draw_disc(out, p0, 2.5, CENTER_COLOR, 0.9)

    return out
