"""Host tables -> device tensors ("weights carried across").

from_reference(flat, bvh, env, device) accepts any objects with the JAX
package's field names (its SceneFlat / WorldBvh / env dicts, or this
package's numpy copies; numpy or jax arrays) and returns the port's device
dataclasses. The renderer uses it on its own host builders; the tests use
it to hand both packages the same tables.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .ops.hdr import HdrEnv
from .ops.sky import SkyEnv


@dataclass
class DeviceScene:
    """The SceneFlat fields the device path reads."""

    rn_material: torch.Tensor  # [N] i32
    mat_packed: torch.Tensor  # [M,K] f32 (ops/flat.MAT_LAYOUT)
    ti_index: torch.Tensor  # [TI] i32
    ti_texcoord: torch.Tensor  # [TI] i32
    ti_uvxform: torch.Tensor  # [TI,2,3] f32
    tex_quads: torch.Tensor  # [K,16] f32
    tex_desc: torch.Tensor  # [D,4] i32
    tex_mip_table: torch.Tensor  # [ntex,max_mips] i32
    tex_num_mips: torch.Tensor  # [ntex] i32
    num_lights: int


@dataclass
class DeviceBvh:
    """The WorldBvh fields the device path reads."""

    nodes4_fi: torch.Tensor  # [M,32] f32
    tris128: torch.Tensor  # [L,128] f32
    hit_attr: torch.Tensor  # [Ta,64|32] f32
    rn_attr_base: torch.Tensor  # [N] i32
    attr_alpha_class: torch.Tensor  # [Ta] i8
    scene_lo: torch.Tensor  # [3] f32 world bounds
    scene_hi: torch.Tensor  # [3] f32
    root4_code: int
    num_world_tris: int


def _t(a, dtype, device):
    return torch.tensor(np.ascontiguousarray(np.asarray(a), dtype=dtype), device=device)


def scene_to_device(flat, device) -> DeviceScene:
    f32, i32 = np.float32, np.int32
    return DeviceScene(
        rn_material=_t(flat.rn_material, i32, device),
        mat_packed=_t(flat.mat_packed, f32, device),
        ti_index=_t(flat.ti_index, i32, device),
        ti_texcoord=_t(flat.ti_texcoord, i32, device),
        ti_uvxform=_t(flat.ti_uvxform, f32, device),
        tex_quads=_t(flat.tex_quads, f32, device),
        tex_desc=_t(flat.tex_desc, i32, device),
        tex_mip_table=_t(flat.tex_mip_table, i32, device),
        tex_num_mips=_t(flat.tex_num_mips, i32, device),
        num_lights=int(flat.num_lights),
    )


def bvh_to_device(bvh, device) -> DeviceBvh:
    f32, i32 = np.float32, np.int32
    root = np.asarray(bvh.nodes_self)[0]
    return DeviceBvh(
        nodes4_fi=_t(bvh.nodes4_fi, f32, device),
        tris128=_t(bvh.tris128, f32, device),
        hit_attr=_t(bvh.hit_attr, f32, device),
        rn_attr_base=_t(bvh.rn_attr_base, i32, device),
        attr_alpha_class=_t(bvh.attr_alpha_class, np.int8, device),
        scene_lo=_t(root[0:3], f32, device),
        scene_hi=_t(root[3:6], f32, device),
        root4_code=int(bvh.root4_code),
        num_world_tris=int(bvh.num_world_tris),
    )


def env_to_device(env, device):
    """Reference env dict (sky keys or HDR keys) -> SkyEnv / HdrEnv."""
    if "samp" in env:
        return HdrEnv.from_arrays(env, device)
    return SkyEnv.from_arrays(env, device)


def from_reference(flat, bvh, env, device):
    """(flat, bvh, env) with the reference's field names -> (DeviceScene,
    DeviceBvh, SkyEnv | HdrEnv); a None input gives None."""
    return (
        None if flat is None else scene_to_device(flat, device),
        None if bvh is None else bvh_to_device(bvh, device),
        None if env is None else env_to_device(env, device),
    )
