"""Keyframe animation playback (reference gltf_scene_animation.{hpp,cpp}).

Channels (translation/rotation/scale/weights), samplers (LINEAR / STEP /
CUBICSPLINE), loop wrapping, plus CPU skinning and morphing — the CPU
implementations are the oracles for the jitted device versions
(reference test_compute_animation.cpp pattern).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import accessors as acc
from ..utils import mathutil as mu


@dataclass
class AnimationChannel:
    node: int
    path: str  # "translation" | "rotation" | "scale" | "weights" | "pointer"
    times: np.ndarray  # [K]
    values: np.ndarray  # [K, C] (or [K*3, C] for cubicspline)
    interpolation: str = "LINEAR"
    pointer: str | None = None  # KHR_animation_pointer JSON pointer


@dataclass
class AnimationInfo:
    """Playback window + clock (reference AnimationInfo gltf_scene.hpp:159-189)."""

    name: str = ""
    start: float = np.inf
    end: float = -np.inf
    current_time: float = 0.0
    channels: list = field(default_factory=list)

    def reset(self) -> float:
        self.current_time = self.start
        return self.current_time

    def increment_time(self, dt: float, loop: bool = True) -> float:
        self.current_time += dt
        if loop:
            duration = max(self.end - self.start, 1e-9)
            wrapped = np.fmod(self.current_time - self.start, duration)
            if wrapped < 0.0:
                wrapped += duration
            self.current_time = self.start + wrapped
        elif self.current_time > self.end:
            self.current_time = self.end
        return self.current_time


def parse_animations(scene) -> list[AnimationInfo]:
    """Decode all animations (reference parseAnimations gltf_scene_animation.cpp:84)."""
    model = scene.model
    out = []
    for anim in model.gltf.get("animations", []):
        info = AnimationInfo(name=anim.get("name", ""))
        samplers = anim.get("samplers", [])
        for ch in anim.get("channels", []):
            samp = samplers[ch["sampler"]]
            times = np.asarray(acc.read_accessor(model, samp["input"]), np.float32).reshape(-1)
            values = np.asarray(acc.read_accessor(model, samp["output"]), np.float32)
            if values.ndim == 1:
                values = values[:, None]
            target = ch.get("target", {})
            path = target.get("path", "")
            pointer = None
            if path == "pointer":
                pointer = target.get("extensions", {}).get("KHR_animation_pointer", {}).get("pointer")
            info.channels.append(
                AnimationChannel(
                    node=target.get("node", -1),
                    path=path,
                    times=times,
                    values=values,
                    interpolation=samp.get("interpolation", "LINEAR"),
                    pointer=pointer,
                )
            )
            if times.size:
                info.start = min(info.start, float(times[0]))
                info.end = max(info.end, float(times[-1]))
        if not info.channels:
            info.start = info.end = 0.0
        out.append(info)
    return out


def _sample_channel(ch: AnimationChannel, t: float) -> np.ndarray:
    """Evaluate one channel at time t (LINEAR / STEP / CUBICSPLINE + slerp)."""
    times = ch.times
    k = times.shape[0]
    if k == 0:
        return None
    ncomp = ch.values.shape[1]
    if ch.interpolation == "CUBICSPLINE":
        vals = ch.values.reshape(k, 3, ncomp)  # (in-tangent, value, out-tangent)
    else:
        vals = ch.values.reshape(k, -1, ncomp)[:, 0] if ch.values.shape[0] == k else ch.values
    if k == 1 or t <= times[0]:
        v = vals[0, 1] if ch.interpolation == "CUBICSPLINE" else vals[0]
        return np.asarray(v, np.float32)
    if t >= times[-1]:
        v = vals[-1, 1] if ch.interpolation == "CUBICSPLINE" else vals[-1]
        return np.asarray(v, np.float32)
    i1 = int(np.searchsorted(times, t, side="right"))
    i1 = min(max(i1, 1), k - 1)
    i0 = i1 - 1
    t0, t1 = float(times[i0]), float(times[i1])
    dt = max(t1 - t0, 1e-9)
    u = (t - t0) / dt

    if ch.interpolation == "STEP":
        return np.asarray(vals[i0], np.float32)
    if ch.interpolation == "CUBICSPLINE":
        p0, m0 = vals[i0, 1], vals[i0, 2] * dt
        p1, m1 = vals[i1, 1], vals[i1, 0] * dt
        u2, u3 = u * u, u * u * u
        v = (2 * u3 - 3 * u2 + 1) * p0 + (u3 - 2 * u2 + u) * m0 + (-2 * u3 + 3 * u2) * p1 + (u3 - u2) * m1
        if ch.path == "rotation":
            v = v / max(np.linalg.norm(v), 1e-9)
        return np.asarray(v, np.float32)
    # LINEAR
    v0, v1 = vals[i0], vals[i1]
    if ch.path == "rotation":
        return _slerp(v0, v1, u)
    return np.asarray((1 - u) * v0 + u * v1, np.float32)


def _slerp(q0, q1, u) -> np.ndarray:
    q0 = np.asarray(q0, np.float64)
    q1 = np.asarray(q1, np.float64)
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = (1 - u) * q0 + u * q1
    else:
        theta = np.arccos(np.clip(d, -1, 1))
        q = (np.sin((1 - u) * theta) * q0 + np.sin(u * theta) * q1) / np.sin(theta)
    return (q / np.linalg.norm(q)).astype(np.float32)


def update_animation(scene, anim_index: int = 0) -> bool:
    """Apply animation at its current time to the Model's nodes
    (reference updateAnimation gltf_scene_animation.cpp:352).

    Mutates node TRS / mesh weights in the Model dict (Model-primary), marks
    dirty flags, returns True if anything changed.
    """
    from .scene import DirtyFlags

    if anim_index >= len(scene.animations):
        return False
    info = scene.animations[anim_index]
    t = info.current_time
    changed = False
    dirty_nodes = []
    for ch in info.channels:
        v = _sample_channel(ch, t)
        if v is None:
            continue
        if ch.path in ("translation", "rotation", "scale"):
            node = scene.model.nodes[ch.node]
            node.pop("matrix", None)
            node[ch.path] = [float(x) for x in v]
            dirty_nodes.append(ch.node)
            changed = True
        elif ch.path == "weights":
            node = scene.model.nodes[ch.node]
            nt = len(scene.model.meshes[node["mesh"]].get("primitives", [{}])[0].get("targets", []))
            full = _sample_weights_channel(ch, t, nt)
            node["weights"] = [float(x) for x in full]
            dirty_nodes.append(ch.node)
            scene.mark_dirty(DirtyFlags.VERTICES)
            changed = True
        elif ch.path == "pointer" and ch.pointer:
            from .animation_pointer import apply_pointer

            apply_pointer(scene, ch.pointer, v)
            changed = True
    if dirty_nodes:
        scene.mark_dirty(DirtyFlags.NODE_TRANSFORMS | DirtyFlags.RENDER_NODES, nodes=dirty_nodes)
    return changed


def _sample_weights_channel(ch: AnimationChannel, t: float, num_targets: int) -> np.ndarray:
    """Weights channels store num_targets values per key, flattened."""
    k = ch.times.shape[0]
    flat = ch.values.reshape(-1)
    per_key = 3 * num_targets if ch.interpolation == "CUBICSPLINE" else num_targets
    vals = flat.reshape(k, per_key)
    tmp = AnimationChannel(node=ch.node, path="weights", times=ch.times, values=vals, interpolation=ch.interpolation)
    v = _sample_channel(tmp, t)
    if ch.interpolation == "CUBICSPLINE":
        # _sample_channel already picked the value row for cubic
        return np.asarray(v, np.float32).reshape(-1)[:num_targets]
    return np.asarray(v, np.float32).reshape(-1)[:num_targets]


# ----------------------------------------------------------------- skinning
def compute_joint_matrices(scene, skin_id: int, node_world: np.ndarray) -> np.ndarray:
    """Per-joint skinning matrices: inverse(nodeWorld) * jointWorld * IBM
    (reference AnimationVk dispatchAnimation CPU stage,
    gltf_scene_animation_vk.cpp:414)."""
    skin = scene.model.skins[skin_id]
    joints = skin["joints"]
    if "inverseBindMatrices" in skin:
        ibms = acc.read_accessor(scene.model, skin["inverseBindMatrices"]).reshape(-1, 4, 4)
        ibms = np.transpose(ibms, (0, 2, 1))  # column-major -> row-major
    else:
        ibms = np.tile(np.eye(4, dtype=np.float32), (len(joints), 1, 1))
    inv_node = np.linalg.inv(node_world.astype(np.float64))
    out = np.zeros((len(joints), 4, 4), np.float32)
    for i, j in enumerate(joints):
        out[i] = (inv_node @ scene.world_matrices[j].astype(np.float64) @ ibms[i].astype(np.float64)).astype(np.float32)
    return out


def cpu_skin(positions, normals, joints0, weights0, joint_matrices):
    """4-influence linear-blend skinning — the oracle for the jitted kernel
    (reference computeSkinning gltf_scene_animation.cpp:724,
    skinning.comp.slang:28-70)."""
    w = weights0
    ws = w.sum(axis=1, keepdims=True)
    w = np.where(ws > 0, w / np.maximum(ws, 1e-9), w)
    m = joint_matrices[joints0]  # [V,4,4,4]
    skin_mat = np.einsum("vj,vjkl->vkl", w.astype(np.float64), m.astype(np.float64))
    pos = np.einsum("vkl,vl->vk", skin_mat, np.concatenate([positions, np.ones((positions.shape[0], 1))], axis=1))[:, :3]
    out_n = None
    if normals is not None:
        nrm = np.einsum("vkl,vl->vk", skin_mat[:, :3, :3], normals.astype(np.float64))
        ln = np.linalg.norm(nrm, axis=1, keepdims=True)
        out_n = (nrm / np.maximum(ln, 1e-20)).astype(np.float32)
    return pos.astype(np.float32), out_n


def cpu_morph(base: np.ndarray, deltas: list, weights: np.ndarray) -> np.ndarray:
    """Weighted morph-target blend — oracle for the jitted kernel
    (reference computeMorphTargets gltf_scene_animation.cpp:829,
    morph.comp.slang:28-70)."""
    out = base.astype(np.float64).copy()
    for w, d in zip(weights, deltas):
        if w != 0.0 and d is not None:
            out += float(w) * d.astype(np.float64)
    return out.astype(np.float32)
