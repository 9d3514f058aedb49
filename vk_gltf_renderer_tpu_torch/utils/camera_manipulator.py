"""Camera manipulator: orbit / pan / dolly / fit / glTF camera conversion.

In-repo replacement for nvutils::CameraManipulator + gltf_camera_utils.hpp
(SURVEY.md §2.6) — the host-side camera the UI/scripting layer drives.
"""

from __future__ import annotations

import numpy as np


class CameraManipulator:
    def __init__(self, eye=(0, 0, 5), center=(0, 0, 0), up=(0, 1, 0), yfov=np.radians(45.0)):
        self.eye = np.asarray(eye, np.float64)
        self.center = np.asarray(center, np.float64)
        self.up = np.asarray(up, np.float64)
        self.yfov = float(yfov)
        self.znear = 0.01
        self.zfar = 1000.0

    # ------------------------------------------------------------ motions
    def orbit(self, dx: float, dy: float) -> None:
        """Rotate eye around center; dx/dy in radians."""
        v = self.eye - self.center
        r = np.linalg.norm(v)
        theta = np.arctan2(v[0], v[2])
        phi = np.arccos(np.clip(v[1] / max(r, 1e-9), -1, 1))
        theta -= dx
        phi = np.clip(phi - dy, 1e-3, np.pi - 1e-3)
        self.eye = self.center + r * np.array(
            [np.sin(phi) * np.sin(theta), np.cos(phi), np.sin(phi) * np.cos(theta)]
        )

    def pan(self, dx: float, dy: float) -> None:
        """Translate eye+center in the view plane; units = world per call."""
        fwd = self.center - self.eye
        dist = np.linalg.norm(fwd)
        fwd /= max(dist, 1e-9)
        right = np.cross(fwd, self.up)
        right /= max(np.linalg.norm(right), 1e-9)
        upv = np.cross(right, fwd)
        delta = (-dx * right + dy * upv) * dist
        self.eye += delta
        self.center += delta

    def dolly(self, amount: float) -> None:
        """Move eye toward/away from center; amount in (-1, 1)."""
        v = self.eye - self.center
        self.eye = self.center + v * float(np.clip(1.0 - amount, 0.05, 20.0))

    def fit(self, lo, hi, margin: float = 1.2) -> None:
        """Frame an AABB (the reference's fit-camera on load)."""
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        c = (lo + hi) / 2
        radius = float(np.linalg.norm(hi - lo)) * 0.5 + 1e-9
        d = self.eye - self.center
        d /= max(np.linalg.norm(d), 1e-9)
        dist = radius / np.tan(self.yfov * 0.5) * margin
        self.center = c
        self.eye = c + d * dist
        self.znear = max(radius * 0.001, 1e-5)
        self.zfar = radius * 100.0

    # -------------------------------------------------------------- glTF
    def to_gltf_node(self) -> dict:
        """Camera state -> glTF node+camera dicts (gltf_camera_utils.hpp)."""
        from .mathutil import look_at, matrix_to_trs

        view = look_at(self.eye, self.center, self.up).astype(np.float64)
        world = np.linalg.inv(view)
        t, q, s = matrix_to_trs(world)
        return {
            "node": {"translation": [float(x) for x in t], "rotation": [float(x) for x in q]},
            "camera": {
                "type": "perspective",
                "perspective": {"yfov": self.yfov, "znear": self.znear, "zfar": self.zfar},
            },
        }

    @classmethod
    def from_render_camera(cls, rc) -> "CameraManipulator":
        m = cls(eye=rc.eye, center=rc.center, up=rc.up, yfov=rc.yfov or np.radians(45.0))
        m.znear = rc.znear or 0.01
        m.zfar = rc.zfar or 1000.0
        return m
