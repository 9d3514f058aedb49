"""Analytic sun + sky environment: eval / sample / pdf (port of
vk_gltf_renderer_tpu/ops/sky.py). The sampling density mixes a sun cone
(probability sun_w) with the uniform sphere; pdf_sky matches sample_sky."""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .traverse import dot3


@dataclass
class SkyParams:
    """Host-side sky parameters (same defaults as the reference)."""

    sun_direction: np.ndarray = field(default_factory=lambda: np.array([0.33, 0.45, 0.83], np.float32))
    sun_color: np.ndarray = field(default_factory=lambda: np.array([1.0, 0.96, 0.9], np.float32))
    sun_intensity: float = 50.0
    sun_angular_size: float = np.radians(0.53)
    sky_zenith: np.ndarray = field(default_factory=lambda: np.array([0.17, 0.32, 0.58], np.float32))
    sky_horizon: np.ndarray = field(default_factory=lambda: np.array([0.60, 0.70, 0.85], np.float32))
    ground_color: np.ndarray = field(default_factory=lambda: np.array([0.30, 0.27, 0.25], np.float32))
    sky_brightness: float = 1.0
    sun_sample_weight: float = 0.5

    def as_arrays(self) -> dict:
        """The reference's env dict, as numpy float32."""
        d = np.asarray(self.sun_direction, np.float32)
        d = d / max(np.linalg.norm(d), 1e-9)
        return dict(
            sun_dir=d,
            sun_radiance=np.asarray(self.sun_color * self.sun_intensity, np.float32),
            cos_sun=np.float32(np.cos(self.sun_angular_size * 0.5)),
            zenith=np.asarray(self.sky_zenith * self.sky_brightness, np.float32),
            horizon=np.asarray(self.sky_horizon * self.sky_brightness, np.float32),
            ground=np.asarray(self.ground_color * self.sky_brightness, np.float32),
            sun_w=np.float32(self.sun_sample_weight),
        )


@dataclass
class SkyEnv:
    """Device sky: [3] vectors and 0-d scalars, all float32."""

    sun_dir: torch.Tensor
    sun_radiance: torch.Tensor
    cos_sun: torch.Tensor
    zenith: torch.Tensor
    horizon: torch.Tensor
    ground: torch.Tensor
    sun_w: torch.Tensor

    @classmethod
    def from_arrays(cls, arrays, device) -> "SkyEnv":
        """Any mapping with the reference's sky keys (numpy or jax arrays)."""
        return cls(**{k: torch.tensor(np.asarray(arrays[k], np.float32), device=device)
                      for k in cls.__dataclass_fields__})


def eval_sky(sp: SkyEnv, d):
    """Radiance along directions d [...,3]."""
    y = d[..., 1]
    t = torch.clamp(y, 0.0, 1.0) ** 0.5
    sky = sp.horizon * (1.0 - t[..., None]) + sp.zenith * t[..., None]
    gfade = torch.clamp(-y * 8.0, 0.0, 1.0)[..., None]
    base = torch.where(y[..., None] >= 0.0, sky, sky * (1.0 - gfade) + sp.ground * gfade)
    cos_to_sun = dot3(d, sp.sun_dir)
    in_disk = (cos_to_sun >= sp.cos_sun) & (sp.sun_dir[1] > -0.2)
    return torch.where(in_disk[..., None], base + sp.sun_radiance, base)


def pdf_sky(sp: SkyEnv, d):
    """Solid-angle density of sample_sky at directions d."""
    cone_solid_angle = 2.0 * math.pi * (1.0 - sp.cos_sun)
    p_cone = 1.0 / torch.clamp(cone_solid_angle, min=1e-9)
    p_uni = 1.0 / (4.0 * math.pi)
    cos_to_sun = dot3(d, sp.sun_dir)
    in_cone = cos_to_sun >= sp.cos_sun
    return torch.where(in_cone, sp.sun_w * p_cone + (1 - sp.sun_w) * p_uni, (1 - sp.sun_w) * p_uni)


def _onb(n):
    """Branchless orthonormal basis (Frisvad/Duff)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]], dim=-1)
    bt = torch.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], dim=-1)
    return t, bt


def sample_sky(sp: SkyEnv, u):
    """u: [...,3] uniforms. Returns (direction, radiance, pdf)."""
    pick_sun = u[..., 0] < sp.sun_w
    cos_t = 1.0 - u[..., 1] * (1.0 - sp.cos_sun)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u[..., 2]
    t, bt = _onb(sp.sun_dir.expand(u.shape[:-1] + (3,)))
    cone_dir = (
        t * (torch.cos(phi) * sin_t)[..., None]
        + bt * (torch.sin(phi) * sin_t)[..., None]
        + sp.sun_dir * cos_t[..., None]
    )
    z = 1.0 - 2.0 * u[..., 1]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    sph_dir = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)

    d = torch.where(pick_sun[..., None], cone_dir, sph_dir)
    d = d / torch.sqrt(dot3(d, d))[..., None]
    return d, eval_sky(sp, d), pdf_sky(sp, d)
