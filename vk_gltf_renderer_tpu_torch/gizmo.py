"""Transform-gizmo interaction math — the headless equivalent of the
reference's 3D translate/rotate/scale gizmo (src/gizmo_transform_vk.cpp,
1,677 LoC: axis/plane/ring handles, snapping, local/world spaces, undo
snapshots wired in renderer.cpp:423-451).

The reference's gizmo is ImGui-rendered; its VALUE is the manipulation
math: mapping a mouse ray against axis/plane/ring handles into a precise,
optionally snapped TRS delta. That math is fully headless and lives here,
driving SceneEditor edits (undoable via models/undo.py exactly like the
reference's continuous-command merge). The terminal viewer and edit_cli
call it; tests drive it with synthetic camera rays.

Conventions:
  * handles are defined at the node's world pivot with unit axes taken
    from world space (Space.WORLD) or the node's world rotation
    (Space.LOCAL) — the reference's space toggle;
  * a drag is (ray at press, ray now) -> delta; the gizmo is stateless
    beyond the press snapshot, so drags compose deterministically;
  * snapping quantizes the DELTA (translate: step units; rotate: step
    degrees; scale: step factor), matching the reference's increment
    snapping behavior.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

import numpy as np


class Mode(Enum):
    TRANSLATE = "translate"
    ROTATE = "rotate"
    SCALE = "scale"


class Space(Enum):
    WORLD = "world"
    LOCAL = "local"


# handle ids
AXIS_X, AXIS_Y, AXIS_Z = 0, 1, 2
PLANE_YZ, PLANE_ZX, PLANE_XY = 3, 4, 5  # normal = X / Y / Z
RING_X, RING_Y, RING_Z = 6, 7, 8
UNIFORM = 9  # center handle: uniform scale / screen-space translate


@dataclass
class Snap:
    translate: float = 0.0  # world units; 0 = off
    rotate_deg: float = 0.0
    scale: float = 0.0


@dataclass
class DragState:
    """Snapshot taken at mouse-press (the reference's gizmo press state)."""

    handle: int
    pivot: np.ndarray  # world pivot at press
    axes: np.ndarray  # [3,3] handle frame rows (world or local)
    start_point: np.ndarray  # world point where the press ray met the handle
    start_trs: tuple = None  # (t, r, s) of the node at press (for undo merge)
    start_angle: float = 0.0  # rotate: angle of start_point on the ring


def _normalize(v):
    n = np.linalg.norm(v)
    return v / n if n > 1e-20 else v


def ray_point_to_axis(ro, rd, pivot, axis):
    """Parameter of the closest point ON THE AXIS LINE to the mouse ray
    (the classic line-line closest-point; reference: axis-handle drag)."""
    w0 = np.asarray(ro, float) - np.asarray(pivot, float)
    a = float(np.dot(rd, rd))
    b = float(np.dot(rd, axis))
    c = float(np.dot(axis, axis))
    d = float(np.dot(rd, w0))
    e = float(np.dot(axis, w0))
    den = a * c - b * b
    if abs(den) < 1e-12:  # ray parallel to axis: keep previous point
        return 0.0
    return (a * e - b * d) / den


def ray_plane(ro, rd, pivot, normal):
    """Ray/plane intersection point (None when parallel)."""
    dn = float(np.dot(rd, normal))
    if abs(dn) < 1e-9:
        return None
    t = float(np.dot(np.asarray(pivot, float) - ro, normal)) / dn
    if t < 0:
        return None
    return np.asarray(ro, float) + np.asarray(rd, float) * t


def _node_world(scene, node_id):
    """Current world matrix of a node (scene.world_matrices is maintained
    by parse/update; callers inside a drag keep it current)."""
    return np.asarray(scene.world_matrices[node_id], float)


def _quat_mul(a, b):
    """Hamilton product, (x, y, z, w) storage (glTF order)."""
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def handle_frame(scene, node_id, space: Space):
    """Pivot + 3x3 axis rows for the gizmo at a node."""
    m = _node_world(scene, node_id)
    pivot = m[:3, 3].copy()
    if space == Space.WORLD:
        axes = np.eye(3)
    else:
        r = m[:3, :3]
        # orthonormalize (drop scale) — local-space handles follow rotation
        u, _, vt = np.linalg.svd(r)
        axes = (u @ vt).T  # rows = local x/y/z in world space
    return pivot, axes


def pick_handle(ro, rd, pivot, axes, mode: Mode, size: float = 1.0,
                pick_radius: float = 0.15):
    """Nearest gizmo handle hit by the mouse ray, or None.

    size scales the gizmo (the reference sizes it by view distance);
    pick_radius is the grab tolerance as a fraction of size."""
    ro = np.asarray(ro, float)
    rd = _normalize(np.asarray(rd, float))
    tol = size * pick_radius
    best = (None, np.inf)

    if mode in (Mode.TRANSLATE, Mode.SCALE):
        for h, ax in ((AXIS_X, axes[0]), (AXIS_Y, axes[1]), (AXIS_Z, axes[2])):
            s = ray_point_to_axis(ro, rd, pivot, ax)
            if 0.15 * size <= s <= size:
                p = pivot + ax * s
                # distance from the mouse ray to that axis point
                d = np.linalg.norm(np.cross(p - ro, rd))
                if d < tol and d < best[1]:
                    best = (h, d)
        if mode == Mode.TRANSLATE:
            for h, n, u, v in (
                (PLANE_YZ, axes[0], axes[1], axes[2]),
                (PLANE_ZX, axes[1], axes[2], axes[0]),
                (PLANE_XY, axes[2], axes[0], axes[1]),
            ):
                p = ray_plane(ro, rd, pivot, n)
                if p is None:
                    continue
                lu = float(np.dot(p - pivot, u))
                lv = float(np.dot(p - pivot, v))
                if 0.25 * size <= lu <= 0.6 * size and 0.25 * size <= lv <= 0.6 * size:
                    d = np.linalg.norm(p - (pivot + u * lu + v * lv))
                    if d < best[1]:
                        best = (h, 0.0)
        else:  # uniform-scale center cube
            d = np.linalg.norm(np.cross(pivot - ro, rd))
            if d < tol:
                best = (UNIFORM, d)
    if mode == Mode.ROTATE:
        for h, n in ((RING_X, axes[0]), (RING_Y, axes[1]), (RING_Z, axes[2])):
            p = ray_plane(ro, rd, pivot, n)
            if p is None:
                continue
            d = abs(np.linalg.norm(p - pivot) - size)
            if d < tol and d < best[1]:
                best = (h, d)
    return best[0]


def begin_drag(ro, rd, pivot, axes, handle, size: float = 1.0):
    """Press snapshot: where on the handle the press ray lands."""
    ro = np.asarray(ro, float)
    rd = _normalize(np.asarray(rd, float))
    if handle in (AXIS_X, AXIS_Y, AXIS_Z):
        ax = axes[handle - AXIS_X]
        s = ray_point_to_axis(ro, rd, pivot, ax)
        start = pivot + ax * s
        return DragState(handle=handle, pivot=pivot.copy(), axes=axes.copy(), start_point=start)
    if handle in (PLANE_YZ, PLANE_ZX, PLANE_XY):
        n = axes[handle - PLANE_YZ]
        p = ray_plane(ro, rd, pivot, n)
        if p is None:
            p = pivot.copy()
        return DragState(handle=handle, pivot=pivot.copy(), axes=axes.copy(), start_point=p)
    if handle in (RING_X, RING_Y, RING_Z):
        n = axes[handle - RING_X]
        p = ray_plane(ro, rd, pivot, n)
        if p is None:
            p = pivot + axes[(handle - RING_X + 1) % 3]
        u = axes[(handle - RING_X + 1) % 3]
        v = axes[(handle - RING_X + 2) % 3]
        ang = float(np.arctan2(np.dot(p - pivot, v), np.dot(p - pivot, u)))
        return DragState(handle=handle, pivot=pivot.copy(), axes=axes.copy(),
                         start_point=p, start_angle=ang)
    # UNIFORM: track along the view ray's perpendicular distance
    return DragState(handle=UNIFORM, pivot=pivot.copy(), axes=axes.copy(),
                     start_point=ro + rd * float(np.dot(pivot - ro, rd)))


def _snap_val(v, step):
    return round(v / step) * step if step > 0 else v


def drag_delta(state: DragState, ro, rd, snap: Snap = Snap()):
    """Current drag -> delta dict:
      translate handles -> {"translate": [dx,dy,dz]} (world space)
      rings             -> {"rotate_axis": axis, "rotate_angle": rad}
      scale handles     -> {"scale": [sx,sy,sz]} (multiplicative)
    The delta is measured from the PRESS snapshot, so re-applying on every
    mouse move (with undo-merge) behaves like the reference's continuous
    command."""
    ro = np.asarray(ro, float)
    rd = _normalize(np.asarray(rd, float))
    h = state.handle
    if h in (AXIS_X, AXIS_Y, AXIS_Z):
        ax = state.axes[h - AXIS_X]
        s_now = ray_point_to_axis(ro, rd, state.pivot, ax)
        s_then = float(np.dot(state.start_point - state.pivot, ax))
        d = _snap_val(s_now - s_then, snap.translate)
        return {"translate": (ax * d).tolist()}
    if h in (PLANE_YZ, PLANE_ZX, PLANE_XY):
        n = state.axes[h - PLANE_YZ]
        p = ray_plane(ro, rd, state.pivot, n)
        if p is None:
            return {"translate": [0.0, 0.0, 0.0]}
        d = p - state.start_point
        d -= n * float(np.dot(d, n))  # constrain to the plane
        if snap.translate > 0:
            u = state.axes[(h - PLANE_YZ + 1) % 3]
            v = state.axes[(h - PLANE_YZ + 2) % 3]
            d = u * _snap_val(float(np.dot(d, u)), snap.translate) + \
                v * _snap_val(float(np.dot(d, v)), snap.translate)
        return {"translate": d.tolist()}
    if h in (RING_X, RING_Y, RING_Z):
        n = state.axes[h - RING_X]
        u = state.axes[(h - RING_X + 1) % 3]
        v = state.axes[(h - RING_X + 2) % 3]
        p = ray_plane(ro, rd, state.pivot, n)
        if p is None:
            return {"rotate_axis": n.tolist(), "rotate_angle": 0.0}
        ang = float(np.arctan2(np.dot(p - state.pivot, v), np.dot(p - state.pivot, u)))
        delta = ang - state.start_angle
        while delta > np.pi:
            delta -= 2 * np.pi
        while delta < -np.pi:
            delta += 2 * np.pi
        if snap.rotate_deg > 0:
            step = np.radians(snap.rotate_deg)
            delta = round(delta / step) * step
        return {"rotate_axis": n.tolist(), "rotate_angle": delta}
    # UNIFORM scale: radial distance ratio from pivot in the view plane
    p_now = ro + rd * float(np.dot(state.pivot - ro, rd))
    num = np.linalg.norm(p_now - state.pivot)
    den = np.linalg.norm(state.start_point - state.pivot)
    f = num / den if den > 1e-9 else 1.0
    f = _snap_val(f, snap.scale) if snap.scale > 0 else f
    f = max(f, 1e-4)
    return {"scale": [f, f, f]}


def apply_delta(editor, node_id, delta, scale_axis=None, snap: Snap = Snap()):
    """Apply a drag delta to a node's LOCAL TRS via SceneEditor (the
    reference routes gizmo output through the editor the same way,
    renderer.cpp:423-451). Returns the new (t, r, s)."""
    scene = editor.scene
    node = scene.model.nodes[node_id]
    t = np.asarray(node.get("translation", [0.0, 0.0, 0.0]), float)
    r = np.asarray(node.get("rotation", [0.0, 0.0, 0.0, 1.0]), float)
    s = np.asarray(node.get("scale", [1.0, 1.0, 1.0]), float)
    if "translate" in delta:
        # world delta -> parent-space delta
        parent = int(scene.parents[node_id]) if node_id < len(scene.parents) else -1
        pm = _node_world(scene, parent)[:3, :3] if parent >= 0 else np.eye(3)
        local = np.linalg.solve(pm, np.asarray(delta["translate"], float))
        editor.set_translation(node_id, (t + local).tolist())
        return (t + local).tolist(), r.tolist(), s.tolist()
    if "rotate_angle" in delta:
        ax = np.asarray(delta["rotate_axis"], float)
        # world axis -> parent space (rotation delta composes left of the
        # local rotation in the parent frame)
        parent = int(scene.parents[node_id]) if node_id < len(scene.parents) else -1
        if parent >= 0:
            pr = _node_world(scene, parent)[:3, :3]
            u, _, vt = np.linalg.svd(pr)
            ax = (u @ vt).T @ ax
        ang = float(delta["rotate_angle"])
        half = ang / 2.0
        dq = np.array([*(_normalize(ax) * np.sin(half)), np.cos(half)])
        nr = _quat_mul(dq, r)
        editor.set_rotation(node_id, (nr / np.linalg.norm(nr)).tolist())
        return t.tolist(), nr.tolist(), s.tolist()
    if "scale" in delta:
        f = np.asarray(delta["scale"], float)
        if scale_axis is not None:  # per-axis handle
            m = np.ones(3)
            m[scale_axis] = f[scale_axis]
            f = m
        editor.set_scale(node_id, (s * f).tolist())
        return t.tolist(), r.tolist(), (s * f).tolist()
    return t.tolist(), r.tolist(), s.tolist()
