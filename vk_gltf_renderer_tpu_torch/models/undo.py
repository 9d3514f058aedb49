"""Undo/redo: command pattern over Model mutations
(reference undo_redo.{hpp,cpp}: discrete `executeCommand` vs continuous
`pushExecuted` with merge; SceneGraphSnapshot for structural ops).
"""

from __future__ import annotations

import copy
import json
import time
from dataclasses import dataclass, field


class Command:
    """Base command. Subclasses capture before/after state."""

    merge_window_s = 0.5

    def execute(self, scene) -> None:
        raise NotImplementedError

    def undo(self, scene) -> None:
        raise NotImplementedError

    def can_merge(self, other: "Command") -> bool:
        return False

    def merge(self, other: "Command") -> None:
        pass


@dataclass
class TransformCommand(Command):
    """Node TRS change; consecutive drags on the same node merge
    (reference continuous-op merging)."""

    node_id: int
    key: str  # translation | rotation | scale
    new_value: list
    old_value: list | None = None
    timestamp: float = field(default_factory=time.monotonic)

    def execute(self, scene) -> None:
        node = scene.model.nodes[self.node_id]
        if self.old_value is None:
            self.old_value = list(node.get(self.key, _trs_default(self.key)))
        from .editor import SceneEditor

        SceneEditor(scene)._set_trs(self.node_id, self.key, list(self.new_value))

    def undo(self, scene) -> None:
        from .editor import SceneEditor

        SceneEditor(scene)._set_trs(self.node_id, self.key, list(self.old_value))

    def can_merge(self, other) -> bool:
        return (
            isinstance(other, TransformCommand)
            and other.node_id == self.node_id
            and other.key == self.key
            and other.timestamp - self.timestamp < self.merge_window_s
        )

    def merge(self, other) -> None:
        self.new_value = other.new_value
        self.timestamp = other.timestamp


def _trs_default(key: str):
    return {"translation": [0, 0, 0], "rotation": [0, 0, 0, 1], "scale": [1, 1, 1]}[key]


@dataclass
class SnapshotCommand(Command):
    """Structural edit captured as a full scene-graph snapshot
    (reference SceneGraphSnapshot, gltf_scene_editor.hpp:21-29). Used for
    add/delete/duplicate/reparent where index remapping makes incremental
    undo fragile."""

    action: object  # callable(scene) performing the edit
    label: str = "structural edit"
    _before: str | None = None

    def execute(self, scene) -> None:
        if self._before is None:
            self._before = json.dumps(scene.model.gltf)
            self._before_buffers = [bytes(b) for b in scene.model.buffers]
        self.action(scene)

    def undo(self, scene) -> None:
        from .scene import DirtyFlags

        scene.model.gltf = json.loads(self._before)
        scene.model.buffers = [bytearray(b) for b in self._before_buffers]
        scene.parse_scene()
        scene.mark_dirty(DirtyFlags.ALL)


@dataclass
class MaterialCommand(Command):
    """Material property change via JSON path within the material dict."""

    material_id: int
    updates: dict  # key path (dot separated) -> new value
    _old: dict | None = None

    def execute(self, scene) -> None:
        from .scene import DirtyFlags

        mat = scene.model.materials[self.material_id]
        if self._old is None:
            self._old = copy.deepcopy(mat)
        for path, val in self.updates.items():
            obj = mat
            keys = path.split(".")
            for k in keys[:-1]:
                obj = obj.setdefault(k, {})
            obj[keys[-1]] = val
        scene.mark_dirty(DirtyFlags.MATERIALS, materials=[self.material_id])

    def undo(self, scene) -> None:
        from .scene import DirtyFlags

        scene.model.materials[self.material_id] = copy.deepcopy(self._old)
        scene.mark_dirty(DirtyFlags.MATERIALS, materials=[self.material_id])


class UndoStack:
    """Discrete execute + continuous push-executed with merge
    (undo_redo.hpp:22-90)."""

    def __init__(self, scene, limit: int = 200):
        self.scene = scene
        self.limit = limit
        self._undo: list[Command] = []
        self._redo: list[Command] = []

    def execute(self, cmd: Command) -> None:
        cmd.execute(self.scene)
        self._push(cmd)

    def push_executed(self, cmd: Command) -> None:
        """Record an already-applied command (continuous ops like gizmo
        drags); merges with the previous one when possible."""
        if self._undo and self._undo[-1].can_merge(cmd):
            self._undo[-1].merge(cmd)
        else:
            self._push(cmd)

    def _push(self, cmd: Command) -> None:
        self._undo.append(cmd)
        if len(self._undo) > self.limit:
            self._undo.pop(0)
        self._redo.clear()

    def undo(self) -> bool:
        if not self._undo:
            return False
        cmd = self._undo.pop()
        cmd.undo(self.scene)
        self._redo.append(cmd)
        return True

    def redo(self) -> bool:
        if not self._redo:
            return False
        cmd = self._redo.pop()
        cmd.execute(self.scene)
        self._undo.append(cmd)
        return True

    @property
    def can_undo(self) -> bool:
        return bool(self._undo)

    @property
    def can_redo(self) -> bool:
        return bool(self._redo)
