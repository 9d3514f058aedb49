"""Host tables -> device tensors ("weights carried across").

from_reference(flat, bvh, env, device) accepts any objects with the JAX
package's field names (its SceneFlat / WorldBvh / env dicts, or this
package's numpy copies; numpy or jax arrays) and returns the port's device
dataclasses. The renderer uses it on its own host builders; the tests use
it to hand both packages the same tables; ibl_to_device does the same for
the preview's IBL prefilter products. DeviceScene.to, DeviceBvh.to and
replicate copy device tables to another device (parallel/mesh.py's replicas).

DeviceRefit holds what the device refit reads (the deformable vertex
state, the index tables of the world-triangle and hit-row bakes, and the
refit maps of every table family present); refit_tables_to_device uploads
it once per scene and refit_device_bvh replaces a DeviceBvh's geometry
after a transform, skin or morph edit (renderer._refit_device).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from .ops.animation import refit_world_bvh
from .ops.bvh_flatten import multipop_stack_need, split_stack_need, stack_need
from .ops.hdr import HdrEnv
from .ops.hitstate import HIT_ATTR_COLS_NARROW
from .ops.lane_traverse import lane_entries
from .ops.sky import SkyEnv
from .ops.traverse import MULTIPOP


@dataclass
class DeviceScene:
    """The SceneFlat fields the device path reads."""

    rn_material: torch.Tensor  # [N] i32
    rn_packed: torch.Tensor  # [N,32] f32 each render node's o2w | w2o, row-major 4x4 (the device refit's)
    mat_packed: torch.Tensor  # [M,K] f32 (ops/flat.MAT_LAYOUT)
    ti_index: torch.Tensor  # [TI] i32
    ti_texcoord: torch.Tensor  # [TI] i32
    ti_uvxform: torch.Tensor  # [TI,2,3] f32
    tex_quads: torch.Tensor  # [K,16] f32
    tex_desc: torch.Tensor  # [D,4] i32
    tex_mip_table: torch.Tensor  # [ntex,max_mips] i32
    tex_num_mips: torch.Tensor  # [ntex] i32
    num_lights: int
    # punctual lights (ops/flat._build_lights; one placeholder row when the scene has none)
    light_type: torch.Tensor  # [L] i32
    light_pos: torch.Tensor  # [L,3] f32
    light_dir: torch.Tensor  # [L,3] f32
    light_color: torch.Tensor  # [L,3] f32
    light_intensity: torch.Tensor  # [L] f32
    light_radius: torch.Tensor  # [L] f32
    light_angular_or_invrange: torch.Tensor  # [L] f32
    light_cone: torch.Tensor  # [L,2] f32

    def to(self, device) -> "DeviceScene":
        return replicate(self, device)


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
    # tris row of each hit row (WorldBvh.emit2ref; -1 culled): the primary-hit seeding's
    # inversion of a pixel's (rnode, tri); rows stay in place under a refit
    emit2ref: torch.Tensor | None = None  # [max(Ta,1)] i32
    # the other kernels' tables, present only where the host BVH has them
    nodes_fi: torch.Tensor | None = None  # [Nn,16] f32 binary rows (BVH2)
    root_code: int = 0  # binary root code
    nodes16_fi: torch.Tensor | None = None  # [M,128] f32 BVH16 rows
    lane_entries: torch.Tensor | None = None  # [E,16] f32 entry-major lane entries
    nodes4_sc: torch.Tensor | None = None  # [M,8] i32 BVH4 codes + axes (v7)
    # the split tables of the packet4 / v1 kernels and the wavefront walk
    nodes_i: torch.Tensor | None = None  # [Nn,8] i32 left right first count parent axis
    nodes_f: torch.Tensor | None = None  # [Nn,16] f32 binary child boxes
    nodes_self: torch.Tensor | None = None  # [Nn,8] f32 binary nodes' own boxes
    tris: torch.Tensor | None = None  # [T+8,16] f32 world triangles in BVH order
    wtri_rnode: torch.Tensor | None = None  # [T+8] i32 render node of a tris row
    wtri_tri: torch.Tensor | None = None  # [T+8] i32 global triangle id of a tris row
    nodes4_i: torch.Tensor | None = None  # [M,8] i32 split BVH4 codes + axes
    nodes4_f: torch.Tensor | None = None  # [M,32] f32 split BVH4 child boxes
    # whether binary node 0 is a leaf, read on the host with the v1 kernel's tables: its
    # compaction's dead-lane rule depends on it, and the wrapper must not sync to learn it
    bvh2_split_root_leaf: bool = False
    # deepest traversal stack each walk over a present table can need, by
    # table family (ops/intersect.ROUTES and SPLIT_FAMILIES below; bvh_flatten.stack_need,
    # multipop_stack_need and split_stack_need), checked against the kernels' capacity
    stack_need: dict = field(default_factory=dict)
    # the device refit's tables (refit_tables_to_device), once a refit needs them
    refit: DeviceRefit | None = None

    def to(self, device) -> "DeviceBvh":
        """A copy on device without the refit's tables: a replica renders,
        and is replaced after a refit of the original."""
        return replicate(self, device, drop=("refit",))


@dataclass
class DeviceRefit:
    """What the device refit reads. The vertex state is the last refit's
    (the reference's _refit_device carries its deformed vtx_nrm and
    vtx_packed from frame to frame); the rest is topology."""

    vtx_pos: torch.Tensor  # [V,3] f32
    vtx_nrm: torch.Tensor  # [V,3] f32
    vtx_packed: torch.Tensor  # [V,24] f32
    tri_idx: torch.Tensor  # [F,3] i64
    wtri_rnode: torch.Tensor  # [T+8] i64 render node of each world triangle row
    wtri_src_tri: torch.Tensor  # [T+8] i64 its bake source triangle
    wtri_bary: torch.Tensor  # [T+8,6] f32
    attr_rnode: torch.Tensor  # [Ta] i64 render node of each hit row
    attr_tri: torch.Tensor  # [Ta] i64 its bake source triangle
    attr_has_uv: torch.Tensor  # [Ta] i32
    attr_bary: torch.Tensor  # [Ta,6] f32
    narrow: bool  # hit rows of 32 columns
    nodes_i: torch.Tensor  # [Nn,8] i64
    nodes_self: torch.Tensor  # [Nn,8] f32 (as built; the refit overwrites every box)
    refit_levels: torch.Tensor  # [L,K] i64
    map4: torch.Tensor  # [M,4] i64
    tri8_src: torch.Tensor  # [L*8] i64
    map16: torch.Tensor | None = None  # [M,16] i64, with nodes16_fi
    lane_geo_idx: torch.Tensor | None = None  # [E,16] i32 entry-major, with lane_entries
    tris: torch.Tensor | None = None  # [T+8,16] f32 world triangles of the last refit


def replicate(obj, device, drop=()):
    """A copy of a device dataclass (DeviceScene, DeviceBvh, HdrEnv,
    SkyEnv) with every tensor field copied to device; other fields carried
    across (dicts copied), the fields named in drop set to None. The copy
    of a tensor already on device is the tensor itself."""
    device = torch.device(device)
    kwargs = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name in drop:
            v = None
        elif isinstance(v, torch.Tensor):
            v = v.to(device)
        elif isinstance(v, dict):
            v = dict(v)
        kwargs[f.name] = v
    return type(obj)(**kwargs)


def _t(a, dtype, device):
    return torch.tensor(np.ascontiguousarray(np.asarray(a), dtype=dtype), device=device)


def scene_to_device(flat, device) -> DeviceScene:
    f32, i32 = np.float32, np.int32
    return DeviceScene(
        rn_material=_t(flat.rn_material, i32, device),
        rn_packed=_t(flat.rn_packed, f32, device),
        mat_packed=_t(flat.mat_packed, f32, device),
        ti_index=_t(flat.ti_index, i32, device),
        ti_texcoord=_t(flat.ti_texcoord, i32, device),
        ti_uvxform=_t(flat.ti_uvxform, f32, device),
        tex_quads=_t(flat.tex_quads, f32, device),
        tex_desc=_t(flat.tex_desc, i32, device),
        tex_mip_table=_t(flat.tex_mip_table, i32, device),
        tex_num_mips=_t(flat.tex_num_mips, i32, device),
        num_lights=int(flat.num_lights),
        light_type=_t(flat.light_type, i32, device),
        light_pos=_t(flat.light_pos, f32, device),
        light_dir=_t(flat.light_dir, f32, device),
        light_color=_t(flat.light_color, f32, device),
        light_intensity=_t(flat.light_intensity, f32, device),
        light_radius=_t(flat.light_radius, f32, device),
        light_angular_or_invrange=_t(flat.light_angular_or_invrange, f32, device),
        light_cone=_t(flat.light_cone, f32, device),
    )


def bvh_to_device(bvh, device) -> DeviceBvh:
    f32, i32 = np.float32, np.int32
    root = np.asarray(bvh.nodes_self)[0]
    dev = DeviceBvh(
        nodes4_fi=_t(bvh.nodes4_fi, f32, device),
        tris128=_t(bvh.tris128, f32, device),
        hit_attr=_t(bvh.hit_attr, f32, device),
        rn_attr_base=_t(bvh.rn_attr_base, i32, device),
        attr_alpha_class=_t(bvh.attr_alpha_class, np.int8, device),
        scene_lo=_t(root[0:3], f32, device),
        scene_hi=_t(root[3:6], f32, device),
        root4_code=int(bvh.root4_code),
        num_world_tris=int(bvh.num_world_tris),
        emit2ref=(_t(bvh.emit2ref, i32, device) if getattr(bvh, "emit2ref", None) is not None
                  else None),
        stack_need={"bvh4": stack_need(bvh.nodes4_fi, 2, int(bvh.root4_code)),
                    "bvh4_leafqueue": stack_need(bvh.nodes4_fi, 2, int(bvh.root4_code),
                                                 internal_only=True)},
    )
    return add_kernel_tables_to_device(dev, bvh, device)


# the table families of the split traversals (ops/intersect.TRAVERSALS packet4
# and wavefront, and intersect_rays_packet's v1 kernel)
SPLIT_FAMILIES = ("bvh4_split", "bvh2_split", "wavefront")
# the host tables each split family reads, beside tris + wtri_rnode + wtri_tri; the
# primary-hit seeding (RenderConfig.primary_seed) reads those three alone
_SPLIT_TABLES = {"bvh4_split": ("nodes4_i", "nodes4_f"), "bvh2_split": ("nodes_i", "nodes_f"),
                 "wavefront": ("nodes_i", "nodes_self"), "primary_seed": ()}
_SPLIT_DTYPES = {"nodes_i": np.int32, "nodes4_i": np.int32, "wtri_rnode": np.int32,
                 "wtri_tri": np.int32}


def add_kernel_tables_to_device(dev: DeviceBvh, bvh, device, families=()) -> DeviceBvh:
    """Copy to the device every optional kernel table the host BVH has and
    dev lacks (nodes_fi + root_code, nodes16_fi, lane_pages as entry-major
    lane_entries, nodes4_sc), and work out the v5 walk's stack need when
    `families` names "bvh4_multipop" (a Python walk of the whole tree, so
    only on request). The split tables, which every host BVH has, are
    copied only for the SPLIT_FAMILIES that `families` names (tris and
    wtri_* alone for "primary_seed"), with the
    split walks' stack needs (and, for the v1 kernel, whether node 0 is a
    leaf). Tables added after a refit (dev.refit.tris) are refitted over
    its triangles: the host tree keeps the boxes it was built with.
    Returns dev."""
    f32 = np.float32
    present = _geometry_present(dev)
    for family in SPLIT_FAMILIES + ("primary_seed",):
        if family not in families:
            continue
        for name in _SPLIT_TABLES[family] + ("tris", "wtri_rnode", "wtri_tri"):
            if getattr(dev, name) is None:
                setattr(dev, name, _t(getattr(bvh, name), _SPLIT_DTYPES.get(name, f32), device))
        if family in ("bvh4_split", "bvh2_split") and family not in dev.stack_need:
            dev.stack_need[family] = split_stack_need(bvh, 2 if family == "bvh4_split" else 1)
        if family == "bvh2_split":
            dev.bvh2_split_root_leaf = bool(np.asarray(bvh.nodes_i)[0, 3] > 0)
    if getattr(bvh, "nodes4_sc", None) is not None and dev.nodes4_sc is None:
        dev.nodes4_sc = _t(bvh.nodes4_sc, np.int32, device)
        dev.stack_need["bvh4_sidecar"] = dev.stack_need["bvh4"]
    if "bvh4_multipop" in families and "bvh4_multipop" not in dev.stack_need:
        dev.stack_need["bvh4_multipop"] = multipop_stack_need(bvh.nodes4_fi, dev.root4_code,
                                                              MULTIPOP)
    if getattr(bvh, "nodes_fi", None) is not None and dev.nodes_fi is None:
        dev.nodes_fi = _t(bvh.nodes_fi, f32, device)
        dev.root_code = int(bvh.root_code)
        dev.stack_need["bvh2"] = stack_need(bvh.nodes_fi, 1, dev.root_code, descend=True)
    if getattr(bvh, "nodes16_fi", None) is not None and dev.nodes16_fi is None:
        dev.nodes16_fi = _t(bvh.nodes16_fi, f32, device)
        dev.stack_need["bvh16"] = stack_need(bvh.nodes16_fi, 4, 0)
    if getattr(bvh, "lane_pages", None) is not None and dev.lane_entries is None:
        dev.lane_entries = _t(lane_entries(bvh.lane_pages), f32, device)
    if dev.refit is not None and dev.refit.tris is not None and _geometry_present(dev) != present:
        add_refit_maps(dev.refit, bvh, device)
        refit_device_bvh(dev, dev.refit.tris)
    return dev


# the DeviceBvh tables whose boxes or triangles a refit replaces, beside nodes4_fi and tris128
_REFIT_TABLES = ("nodes_fi", "nodes16_fi", "lane_entries", "nodes_f", "nodes_self", "tris", "nodes4_f")


def _geometry_present(dev: DeviceBvh) -> tuple:
    return tuple(getattr(dev, name) is not None for name in _REFIT_TABLES)


def refit_tables_to_device(flat, bvh, device) -> DeviceRefit:
    """Upload the refit's tables from the host scene and BVH (numpy or jax
    arrays, the reference's field names). A leaf's child slots of nodes_i
    go up as 0: the reference's native builder leaves them unwritten, and
    the refit gathers through them (its leaf rows of nodes_f are never read)."""
    f32, i64 = np.float32, np.int64
    nodes_i = np.array(bvh.nodes_i, i64)
    nodes_i[nodes_i[:, 3] > 0, 0:2] = 0
    ref = DeviceRefit(
        vtx_pos=_t(flat.vtx_pos, f32, device),
        vtx_nrm=_t(flat.vtx_nrm, f32, device),
        vtx_packed=_t(flat.vtx_packed, f32, device),
        tri_idx=_t(flat.tri_idx, i64, device),
        wtri_rnode=_t(bvh.wtri_rnode, i64, device),
        wtri_src_tri=_t(bvh.wtri_src_tri, i64, device),
        wtri_bary=_t(bvh.wtri_bary, f32, device),
        attr_rnode=_t(bvh.attr_rnode, i64, device),
        attr_tri=_t(bvh.attr_tri, i64, device),
        attr_has_uv=_t(bvh.attr_has_uv, np.int32, device),
        attr_bary=_t(bvh.attr_bary, f32, device),
        narrow=np.asarray(bvh.hit_attr).shape[-1] == HIT_ATTR_COLS_NARROW,
        nodes_i=_t(nodes_i, i64, device),
        nodes_self=_t(bvh.nodes_self, f32, device),
        refit_levels=_t(bvh.refit_levels, i64, device),
        map4=_t(bvh.map4, i64, device),
        tri8_src=_t(bvh.tri8_src, i64, device),
    )
    return add_refit_maps(ref, bvh, device)


def add_refit_maps(ref: DeviceRefit, bvh, device) -> DeviceRefit:
    """Upload the refit maps of the kernel tables the host BVH has and ref
    lacks (map16 with nodes16_fi, lane_geo_idx entry-major with
    lane_pages). Returns ref."""
    if getattr(bvh, "map16", None) is not None and ref.map16 is None:
        ref.map16 = _t(bvh.map16, np.int64, device)
    if getattr(bvh, "lane_geo_idx", None) is not None and ref.lane_geo_idx is None:
        ref.lane_geo_idx = _t(lane_entries(bvh.lane_geo_idx), np.int32, device)
    return ref


def refit_device_bvh(dev: DeviceBvh, new_tris: torch.Tensor) -> DeviceBvh:
    """Replace the geometry of every table family dev holds with the boxes
    refitted over new_tris [T+8,16] (ops/animation.refit_world_bvh): the
    BVH4 rows and leaf blocks, the BVH2, BVH16 and lane tables, the split
    tables and the scene bounds. Topology (codes, sidecar, stack needs)
    stays. dev.refit must hold the maps of every family present."""
    ref = dev.refit
    if dev.nodes16_fi is not None and ref.map16 is None or (
            dev.lane_entries is not None and ref.lane_geo_idx is None):
        raise ValueError("refit maps missing for a table family on the device (add_refit_maps)")
    nodes_f, nodes_self, nodes4_f, tris, nodes_fi, tris128, lane, nodes4_fi, nodes16_fi = refit_world_bvh(
        SimpleNamespace(nodes_i=ref.nodes_i, nodes_self=ref.nodes_self, refit_levels=ref.refit_levels,
                        map4=ref.map4, nodes4_fi=dev.nodes4_fi, nodes4_f=dev.nodes4_f, tri8_src=ref.tri8_src,
                        tris128=dev.tris128, nodes_fi=dev.nodes_fi, nodes16_fi=dev.nodes16_fi, map16=ref.map16,
                        lane_pages=dev.lane_entries, lane_geo_idx=ref.lane_geo_idx),
        new_tris)
    dev.nodes4_fi, dev.tris128 = nodes4_fi, tris128
    dev.nodes_fi, dev.nodes16_fi, dev.lane_entries, dev.nodes4_f = nodes_fi, nodes16_fi, lane, nodes4_f
    if dev.nodes_f is not None:
        dev.nodes_f = nodes_f
    if dev.nodes_self is not None:
        dev.nodes_self = nodes_self
    if dev.tris is not None:
        dev.tris = tris
    dev.scene_lo, dev.scene_hi = nodes_self[0, 0:3], nodes_self[0, 3:6]
    ref.tris = new_tris
    return dev


def env_to_device(env, device):
    """Reference env dict (sky keys or HDR keys) -> SkyEnv / HdrEnv."""
    if "samp" in env:
        return HdrEnv.from_arrays(env, device)
    return SkyEnv.from_arrays(env, device)


def ibl_to_device(products, device) -> dict:
    """Reference build_ibl products (irr, spec, brdf; numpy or jax arrays)
    -> the port's dict of float32 tensors (ops/ibl.py)."""
    return {k: _t(products[k], np.float32, device) for k in ("irr", "spec", "brdf")}


def from_reference(flat, bvh, env, device):
    """(flat, bvh, env) with the reference's field names -> (DeviceScene,
    DeviceBvh, SkyEnv | HdrEnv); a None input gives None. The BVH carries
    the split tables of every SPLIT_FAMILIES traversal across, and, given
    flat too, the refit's tables and maps (DeviceBvh.refit)."""
    dev_bvh = None
    if bvh is not None:
        dev_bvh = add_kernel_tables_to_device(bvh_to_device(bvh, device), bvh, device, SPLIT_FAMILIES)
        if flat is not None:
            dev_bvh.refit = refit_tables_to_device(flat, bvh, device)
    return (
        None if flat is None else scene_to_device(flat, device),
        dev_bvh,
        None if env is None else env_to_device(env, device),
    )
