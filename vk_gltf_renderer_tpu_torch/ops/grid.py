"""Reference-grid overlay — the viewer's world grid, in torch on the
displayed frame's device (reference vk_gltf_renderer_tpu/ops/grid.py).

The reference draws an infinite, antialiased, distance-faded world grid as
a raster pass (gizmo_grid_vk + gizmo_grid.slang:1-226: ray/plane hit,
minor/major line sets from screen-space derivatives, depth-tested against
the scene). This module computes the same quantities per pixel of the
displayed image: camera rays, the y = plane_y intersection, line coverage
from the analytic pixel footprint (the fwidth analog), and a depth test
against the path tracer's first-hit distance, then composites onto the
tonemapped image. The ray and plane arithmetic is float64 and the
composite float32, as in the reference; the camera basis (three vectors)
is formed on the host.

Display-side by design: the grid is a viewer affordance, not scene
content (it never appears in headless renders).
"""

from __future__ import annotations

import numpy as np
import torch


def _line_coverage(coord: torch.Tensor, footprint: torch.Tensor, spacing: float) -> torch.Tensor:
    """Antialiased coverage of grid lines at `spacing` world units.

    coord:     world coordinate along one axis            [H, W]
    footprint: world-units-per-pixel at that point        [H, W]
    Returns coverage in [0, 1]: 1 on a line center, 0 between lines,
    smoothly ramped over ~1 pixel (the slang fwidth/smoothstep recipe).
    """
    # distance to the nearest line, in world units
    d = torch.abs(torch.remainder(coord / spacing + 0.5, 1.0) - 0.5) * spacing
    # in pixels; lines are ~1.2 px wide like the reference grid
    px = d / torch.clamp(footprint, min=1e-12)
    return torch.clamp(1.2 - px, 0.0, 1.0)


def _sqrt(s: torch.Tensor) -> torch.Tensor:
    """float64 square root rounded as IEEE sqrt. The vectorised CPU sqrt of
    torch can be one ulp off, and the line colour below compares major and
    minor coverage that are equal to the last bit on a major line, so one
    Newton step with the exact residual s - y*y (Veltkamp split, no fused
    multiply-add needed) restores the rounding; on the card sqrt is
    already correctly rounded and the step leaves it unchanged."""
    y = torch.sqrt(s)
    c = 134217729.0 * y  # 2^27 + 1
    hi = c - (c - y)
    lo = y - hi
    p = y * y
    e = ((hi * hi - p) + 2.0 * hi * lo) + lo * lo
    return y + ((s - p) - e) / (2.0 * y)


def camera_basis(eye, center, up):
    """(eye, fwd, right, up) of a look-at camera as float64 numpy vectors:
    the basis the grid's rays, the gizmo's projection and the viewer's
    pixel rays share."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(center, np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    return eye, fwd, right, np.cross(right, fwd)


def grid_overlay(
    img: torch.Tensor,
    eye,
    center,
    up,
    yfov: float,
    scene_depth: torch.Tensor | None = None,
    plane_y: float = 0.0,
    spacing: float = 1.0,
    color=(0.62, 0.62, 0.62),
    major_color=(0.85, 0.85, 0.85),
    axis_x_color=(0.9, 0.35, 0.35),
    axis_z_color=(0.35, 0.5, 0.95),
    max_alpha: float = 0.55,
) -> torch.Tensor:
    """Composite the world grid (y = plane_y) onto a [H, W, 3] float image,
    on the image's device.

    scene_depth: per-pixel distance eye->first hit ([H*W] or [H, W]; INF/NaN
    where the ray escaped); the grid only draws where it is CLOSER than the
    scene — the slang pass's depth test.
    """
    h, w = img.shape[:2]
    dev = img.device
    eye, fwd, right, cup = camera_basis(eye, center, up)

    def vec(v):
        return torch.tensor(v, dtype=torch.float64, device=dev)

    t = np.tan(yfov * 0.5)
    ar = torch.arange(h, dtype=torch.float64, device=dev)
    ys = (0.5 - (ar + 0.5) / h) * 2.0 * t  # +up at top
    xs = ((torch.arange(w, dtype=torch.float64, device=dev) + 0.5) / w - 0.5) * 2.0 * t * (w / h)  # aspect
    d = vec(fwd)[None, None, :] + xs[None, :, None] * vec(right)[None, None, :] + ys[:, None, None] * vec(cup)[None, None, :]
    sq = d * d
    dn = d / _sqrt((sq[..., 0:1] + sq[..., 1:2]) + sq[..., 2:3])

    dy = dn[..., 1]
    hit = torch.abs(dy) > 1e-9
    # a tensor numerator: a scalar over a tensor multiplies by the reciprocal, which rounds differently
    t_plane = torch.where(hit, vec(plane_y - eye[1]) / torch.where(hit, dy, 1.0), torch.inf)
    front = hit & (t_plane > 0)

    px_world = t_plane * 2.0 * t / h  # pixel footprint at the hit (isotropic approx)
    gx = eye[0] + t_plane * dn[..., 0]
    gz = eye[2] + t_plane * dn[..., 2]

    minor = torch.maximum(_line_coverage(gx, px_world, spacing), _line_coverage(gz, px_world, spacing))
    major = torch.maximum(_line_coverage(gx, px_world, spacing * 10.0), _line_coverage(gz, px_world, spacing * 10.0))
    # world axes: a single line through the origin (distance to 0, not a
    # repeating set) — the x axis is the z = 0 line and vice versa
    ax_x = torch.clamp(1.2 - torch.abs(gz) / torch.clamp(px_world, min=1e-12), 0.0, 1.0)
    ax_z = torch.clamp(1.2 - torch.abs(gx) / torch.clamp(px_world, min=1e-12), 0.0, 1.0)

    # distance fade like the slang grid: gone by ~60 spacings
    fade = torch.clamp(1.0 - t_plane / (60.0 * spacing), 0.0, 1.0)

    if scene_depth is not None:
        depth = scene_depth.to(torch.float64).reshape(h, w)
        visible = front & (~torch.isfinite(depth) | (t_plane < depth))
    else:
        visible = front

    def rgb(c):
        return torch.tensor(c, dtype=torch.float32, device=dev)

    out = img.to(torch.float32)
    base = torch.where(major > minor, major, minor * 0.6)
    col = rgb(color).expand(h, w, 3)
    col = torch.where((major >= minor)[..., None], rgb(major_color), col)
    col = torch.where((ax_x > base)[..., None], rgb(axis_x_color), col)
    col = torch.where((ax_z > torch.maximum(base, ax_x))[..., None], rgb(axis_z_color), col)
    a = torch.maximum(torch.maximum(base, ax_x), ax_z) * fade * max_alpha
    a = torch.where(visible, a, 0.0)[..., None].to(torch.float32)
    return out * (1.0 - a) + col * a
