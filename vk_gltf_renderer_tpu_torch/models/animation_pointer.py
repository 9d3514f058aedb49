"""KHR_animation_pointer: JSON-pointer-addressed animation targets.

Reference: gltf_animation_pointer.{hpp,cpp} — animates arbitrary Model
properties (material factors, light intensity, camera fov, ...) through
RFC 6901 JSON pointers. Because our Model IS the JSON dict, application is
a direct pointer write followed by the right dirty flag.
"""

from __future__ import annotations

import numpy as np


def _resolve(container, token):
    if isinstance(container, list):
        return int(token)
    return token


def apply_pointer(scene, pointer: str, value) -> bool:
    """Write `value` at the JSON pointer; raise matching dirty flags."""
    from .scene import DirtyFlags

    if not pointer.startswith("/"):
        return False
    tokens = [t.replace("~1", "/").replace("~0", "~") for t in pointer.split("/")[1:]]
    obj = scene.model.gltf
    for tok in tokens[:-1]:
        key = _resolve(obj, tok)
        try:
            obj = obj[key]
        except (KeyError, IndexError, TypeError):
            return False
    last = _resolve(obj, tokens[-1])
    v = np.asarray(value, np.float32).reshape(-1)
    new_val = float(v[0]) if v.size == 1 else [float(x) for x in v]
    try:
        obj[last] = new_val
    except (KeyError, IndexError, TypeError):
        return False

    root = tokens[0] if tokens else ""
    if root == "materials":
        scene.mark_dirty(DirtyFlags.MATERIALS, materials=[int(tokens[1])] if len(tokens) > 1 else [])
    elif root == "nodes":
        scene.mark_dirty(DirtyFlags.NODE_TRANSFORMS | DirtyFlags.RENDER_NODES, nodes=[int(tokens[1])] if len(tokens) > 1 else [])
    elif root == "extensions" and len(tokens) > 1 and tokens[1] == "KHR_lights_punctual":
        scene.mark_dirty(DirtyFlags.LIGHTS)
    elif root == "cameras":
        pass  # camera params are read per-frame from the Model
    else:
        scene.mark_dirty(DirtyFlags.MATERIALS)
    return True
