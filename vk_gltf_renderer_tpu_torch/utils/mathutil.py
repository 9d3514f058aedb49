"""Host-side linear algebra helpers (numpy, float32).

Equivalent of the glm pieces the reference uses host-side (node TRS
composition, camera matrices). Conventions follow glTF 2.0:
  * column-vector matrices stored row-major as numpy (4,4); point transform
    is ``M @ [x, y, z, 1]``.
  * node transform = T * R * S (glTF spec 5.25; reference
    tinygltf_utils.cpp getNodeMatrix).
  * right-handed, +Y up, camera looks down -Z.
"""

from __future__ import annotations

import numpy as np

F = np.float32


def trs_matrix(translation=None, rotation=None, scale=None) -> np.ndarray:
    """Compose a 4x4 from glTF translation [3], rotation quaternion [x,y,z,w], scale [3]."""
    m = quat_to_matrix(rotation) if rotation is not None else np.eye(4, dtype=F)
    if scale is not None:
        s = np.asarray(scale, dtype=F)
        m[:3, 0] *= s[0]
        m[:3, 1] *= s[1]
        m[:3, 2] *= s[2]
    if translation is not None:
        m[:3, 3] = np.asarray(translation, dtype=F)
    return m


def quat_to_matrix(q) -> np.ndarray:
    """glTF quaternion [x, y, z, w] -> 4x4 rotation matrix."""
    x, y, z, w = (float(v) for v in q)
    n = np.sqrt(x * x + y * y + z * z + w * w)
    if n > 0:
        x, y, z, w = x / n, y / n, z / n, w / n
    m = np.eye(4, dtype=F)
    m[0, 0] = 1 - 2 * (y * y + z * z)
    m[0, 1] = 2 * (x * y - z * w)
    m[0, 2] = 2 * (x * z + y * w)
    m[1, 0] = 2 * (x * y + z * w)
    m[1, 1] = 1 - 2 * (x * x + z * z)
    m[1, 2] = 2 * (y * z - x * w)
    m[2, 0] = 2 * (x * z - y * w)
    m[2, 1] = 2 * (y * z + x * w)
    m[2, 2] = 1 - 2 * (x * x + y * y)
    return m


def matrix_to_trs(m: np.ndarray):
    """Decompose 4x4 into (translation[3], quaternion[x,y,z,w], scale[3]).

    Mirrors the reference's editor behavior (gltf_scene_editor.cpp uses glm
    decompose) — needed when converting a node's `matrix` into editable TRS.
    """
    m = np.asarray(m, dtype=np.float64).reshape(4, 4)
    t = m[:3, 3].copy()
    r = m[:3, :3].copy()
    sx = np.linalg.norm(r[:, 0])
    sy = np.linalg.norm(r[:, 1])
    sz = np.linalg.norm(r[:, 2])
    if np.linalg.det(r) < 0:
        sx = -sx
    s = np.array([sx, sy, sz])
    with np.errstate(divide="ignore", invalid="ignore"):
        rot = r / np.where(s == 0, 1.0, s)[None, :]
    q = rotmat_to_quat(rot)
    return t.astype(F), q.astype(F), s.astype(F)


def rotmat_to_quat(r: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> quaternion [x, y, z, w] (Shepperd's method)."""
    r = np.asarray(r, dtype=np.float64)
    tr = r[0, 0] + r[1, 1] + r[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (r[2, 1] - r[1, 2]) / s
        y = (r[0, 2] - r[2, 0]) / s
        z = (r[1, 0] - r[0, 1]) / s
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        w = (r[2, 1] - r[1, 2]) / s
        x = 0.25 * s
        y = (r[0, 1] + r[1, 0]) / s
        z = (r[0, 2] + r[2, 0]) / s
    elif r[1, 1] > r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
        w = (r[0, 2] - r[2, 0]) / s
        x = (r[0, 1] + r[1, 0]) / s
        y = 0.25 * s
        z = (r[1, 2] + r[2, 1]) / s
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
        w = (r[1, 0] - r[0, 1]) / s
        x = (r[0, 2] + r[2, 0]) / s
        y = (r[1, 2] + r[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def node_local_matrix(node: dict) -> np.ndarray:
    """Local transform of a glTF node dict: `matrix` if present, else T*R*S."""
    if "matrix" in node:
        # glTF matrices are column-major flat lists.
        return np.asarray(node["matrix"], dtype=F).reshape(4, 4).T.copy()
    return trs_matrix(node.get("translation"), node.get("rotation"), node.get("scale"))


def perspective(fovy: float, aspect: float, znear: float, zfar: float) -> np.ndarray:
    """Vulkan-convention perspective projection (depth [0,1], Y flipped).

    Matches the reference's camera manipulator output so clip-space math
    (ray gen via projInv in pathtrace_functions getRay) behaves identically.
    """
    f = 1.0 / np.tan(fovy * 0.5)
    m = np.zeros((4, 4), dtype=F)
    m[0, 0] = f / aspect
    m[1, 1] = -f  # Vulkan Y-down clip space
    m[2, 2] = zfar / (znear - zfar)
    m[2, 3] = (zfar * znear) / (znear - zfar)
    m[3, 2] = -1.0
    return m


def orthographic(xmag: float, ymag: float, znear: float, zfar: float) -> np.ndarray:
    """Vulkan-convention orthographic projection (depth [0,1], Y flipped)."""
    m = np.zeros((4, 4), dtype=F)
    m[0, 0] = 1.0 / xmag
    m[1, 1] = -1.0 / ymag
    m[2, 2] = 1.0 / (znear - zfar)
    m[2, 3] = znear / (znear - zfar)
    m[3, 3] = 1.0
    return m


def look_at(eye, center, up) -> np.ndarray:
    """Right-handed view matrix."""
    eye = np.asarray(eye, dtype=np.float64)
    center = np.asarray(center, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    upn = np.cross(right, fwd)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = right
    m[1, :3] = upn
    m[2, :3] = -fwd
    m[0, 3] = -np.dot(right, eye)
    m[1, 3] = -np.dot(upn, eye)
    m[2, 3] = np.dot(fwd, eye)
    return m.astype(F)


def transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply 4x4 to an [N,3] array of points."""
    return pts @ m[:3, :3].T + m[:3, 3]


def transform_dirs(m: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Apply 4x4 rotation/scale (no translation) to an [N,3] array of vectors."""
    return dirs @ m[:3, :3].T
