"""The renderer's traversal switch: ray-batch entry points over every
ported traversal.

intersect_rays_soa is the "packet" traversal, mirroring the reference's
intersect_rays_packet_soa (vk_gltf_renderer_tpu/ops/pallas_traverse.py:1808)
and intersect_rays_lane_soa (ops/lane_traverse.py:433), including their
post-processing: rays without a hit get t = INFINITE and ids -1, and an
any-hit t becomes 0 or INFINITE (occlusion is read from tri >= 0: the
stack kernels return the t = -1 sentinel after an any hit). Kernel names
are the reference's VKGR_PRIMARY_KERNEL / VKGR_PACKET_KERNEL values. Each
routes to one CUDA kernel and the table family it reads; every name of
the reference's switch is ported, an unknown name raises, and no name
falls back to another kernel.

intersect_rays_packet is the reference's AoS entry point
(pallas_traverse.py:1963): wide=True is the packet4 traversal (split BVH4
kernel), v2=False the v1 kernel (split binary tables), the default the
BVH2 kernel. The split kernels return the hit's tris row, resolved here
to (rnode, tri) through wtri_rnode / wtri_tri; they have no any-hit mode
and trace closest hit with the real t whatever `anyhit` says, as the
reference's do. intersect_rays_wavefront (ops/traverse_wavefront.py) is
the third value of VKGR_TRAVERSAL. The reference's packet sizes (tiles,
coherent) are TPU packing and have no counterpart.
"""

from __future__ import annotations

import torch

from .lane_traverse import traverse_lanes
from .traverse import (INFINITE, STACK_DEPTH, STACK_DEPTH2, STACK_DEPTH16, STACK_DEPTH_MULTIPOP,
                       STACK_DEPTH_SPLIT2, STACK_DEPTH_SPLIT4)
from .traverse_bvh2 import traverse_bvh2
from .traverse_bvh2_split import traverse_bvh2_split
from .traverse_bvh4 import traverse_bvh4
from .traverse_bvh4_leafqueue import traverse_bvh4_leafqueue
from .traverse_bvh4_multipop import traverse_bvh4_multipop
from .traverse_bvh4_sidecar import traverse_bvh4_sidecar
from .traverse_bvh4_split import traverse_bvh4_split
from .traverse_bvh16 import traverse_bvh16
from .traverse_wavefront import MAX_STEPS, traverse_wavefront

# VKGR_TRAVERSAL values; "packet" reads the kernel names, the others not
TRAVERSALS = ("packet", "packet4", "wavefront")

# kernel name -> table family (convert.DeviceBvh fields it reads)
ROUTES = {
    "v3": "bvh4", "v9": "bvh4", "v9x4": "bvh4", "v9x8": "bvh4",  # nodes4_fi + tris128
    "v5": "bvh4_multipop",  # nodes4_fi + tris128, several pops per step
    "v8": "bvh4_leafqueue",  # nodes4_fi + tris128, internal stack + leaf queue
    "v7": "bvh4_sidecar",  # nodes4_fi boxes + nodes4_sc codes/axes + tris128
    "v2": "bvh2",  # nodes_fi + tris128
    "v6": "bvh16",  # nodes16_fi + tris128
    "lane": "lane", "lane_stream": "lane",  # lane_entries
}
# traversal stack entries of each family's kernel (v8: its internal stack)
STACK_CAPACITY = {"bvh2": STACK_DEPTH2, "bvh4": STACK_DEPTH, "bvh4_multipop": STACK_DEPTH_MULTIPOP,
                  "bvh4_leafqueue": STACK_DEPTH, "bvh4_sidecar": STACK_DEPTH,
                  "bvh16": STACK_DEPTH16, "bvh4_split": STACK_DEPTH_SPLIT4,
                  "bvh2_split": STACK_DEPTH_SPLIT2}


def route(kernel: str) -> str:
    """Table family of a kernel name; raises for unknown names."""
    if kernel in ROUTES:
        return ROUTES[kernel]
    raise ValueError(f"unknown traversal kernel {kernel!r}; accepted: {sorted(ROUTES)}")


def _check_stack(bvh, family, what):
    """Raise unless bvh holds the family's tables and its tree fits the
    kernel's stack."""
    need = bvh.stack_need.get(family)
    if need is None:
        raise ValueError(f"{what} reads the {family} table, which this DeviceBvh lacks: build it "
                         "with bvh_flatten.add_kernel_tables and "
                         "convert.add_kernel_tables_to_device")
    if need > STACK_CAPACITY[family]:
        raise ValueError(f"the {family} tree needs a {need}-entry traversal stack; the kernel "
                         f"holds {STACK_CAPACITY[family]}")


def intersect_rays_soa(bvh, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, anyhit=False,
                       kernel="v3"):
    """Closest hit (or any hit) of a ray batch against the device BVH
    (convert.DeviceBvh) through the named kernel. Returns dict(t, rnode,
    tri, u, v) of [N]."""
    family = route(kernel)
    rays = (rox, roy, roz, rdx, rdy, rdz, tmin, tmax)
    if family in STACK_CAPACITY:
        _check_stack(bvh, family, f"kernel {kernel!r}")
    if family == "bvh4":
        t, rnode, tri, u, v = traverse_bvh4(bvh.nodes4_fi, bvh.tris128, bvh.root4_code, *rays,
                                            anyhit=anyhit)
    elif family == "bvh4_multipop":
        t, rnode, tri, u, v = traverse_bvh4_multipop(bvh.nodes4_fi, bvh.tris128, bvh.root4_code,
                                                     *rays, anyhit=anyhit)
    elif family == "bvh4_leafqueue":
        t, rnode, tri, u, v = traverse_bvh4_leafqueue(bvh.nodes4_fi, bvh.tris128,
                                                      bvh.root4_code, *rays, anyhit=anyhit)
    elif family == "bvh4_sidecar":
        t, rnode, tri, u, v = traverse_bvh4_sidecar(bvh.nodes4_fi, bvh.nodes4_sc, bvh.tris128,
                                                    bvh.root4_code, *rays, anyhit=anyhit)
    elif family == "bvh2":
        t, rnode, tri, u, v = traverse_bvh2(bvh.nodes_fi, bvh.tris128, bvh.root_code, *rays,
                                            anyhit=anyhit)
    elif family == "bvh16":
        t, rnode, tri, u, v = traverse_bvh16(bvh.nodes16_fi, bvh.tris128, *rays, anyhit=anyhit)
    else:
        if bvh.lane_entries is None:
            raise ValueError(f"kernel {kernel!r} reads lane_entries, which this DeviceBvh lacks: "
                             "build it with bvh_flatten.add_kernel_tables")
        t, rnode, tri, u, v = traverse_lanes(bvh.lane_entries, *rays, anyhit=anyhit)
    valid = tri >= 0
    if anyhit:
        t = torch.where(valid, 0.0, INFINITE)
    else:
        t = torch.where(valid, t, INFINITE)
    return {
        "t": t,
        "rnode": torch.where(valid, rnode, -1),
        "tri": torch.where(valid, tri, -1),
        "u": u,
        "v": v,
    }


def _segments(n, dev, tmin, tmax):
    """tmin (a float or [N]) and tmax (None: unbounded, a float or [N]) as
    contiguous [N] f32."""
    tmin = torch.as_tensor(tmin, dtype=torch.float32, device=dev)
    tmax = torch.as_tensor(INFINITE if tmax is None else tmax, dtype=torch.float32, device=dev)
    return tmin.expand(n).contiguous(), tmax.expand(n).contiguous()


def soa_columns(ro, rd):
    """[N,3] origins and directions as six fresh contiguous [N] columns.
    The CUDA wrappers require 16-byte aligned data, and the column view of
    a single ray is contiguous already but 4 or 8 bytes into its row."""
    return [x[:, c].clone(memory_format=torch.contiguous_format) for x in (ro, rd) for c in range(3)]


def _resolve_rows(bvh, t, row, u, v):
    """A split walk's (t, tris row, u, v) -> dict(t, rnode, tri, u, v), the
    row resolved through wtri_rnode / wtri_tri as the reference does after
    its launch (pallas_traverse.py:2014-2027); a miss gets t = INFINITE and
    ids -1, and u/v stay unmasked."""
    valid = row >= 0
    safe = torch.clamp(row, min=0).long()
    return {
        "t": torch.where(valid, t, INFINITE),
        "rnode": torch.where(valid, bvh.wtri_rnode[safe], -1),
        "tri": torch.where(valid, bvh.wtri_tri[safe], -1),
        "u": u,
        "v": v,
    }


def intersect_rays_packet(bvh, ro, rd, tmin=0.0, tmax=None, anyhit=False, wide=False, v2=True):
    """Closest hit (or, on the default BVH2 branch only, any hit) of [N,3]
    rays, with the reference's semantics (pallas_traverse.py:1963-2027).
    tmin is a float or [N]; tmax None (unbounded), a float or [N].
    wide: the split BVH4 kernel (packet4); v2=False: the split binary
    kernel (v1); both trace closest hit whatever `anyhit` says. Returns
    dict(t, rnode, tri, u, v) of [N]."""
    tmin, tmax = _segments(ro.shape[0], ro.device, tmin, tmax)
    comps = soa_columns(ro, rd)
    if not wide and v2:
        return intersect_rays_soa(bvh, *comps, tmin, tmax, anyhit=anyhit, kernel="v2")
    _check_stack(bvh, "bvh4_split" if wide else "bvh2_split",
                 "traversal packet4" if wide else "the v1 kernel")
    if wide:
        t, _, row, u, v = traverse_bvh4_split(bvh.nodes4_f, bvh.nodes4_i, bvh.tris, *comps, tmin,
                                              tmax)
    else:
        t, _, row, u, v = traverse_bvh2_split(bvh.nodes_f, bvh.nodes_i, bvh.tris, *comps, tmin,
                                              tmax, root_leaf=bvh.bvh2_split_root_leaf)
    return _resolve_rows(bvh, t, row, u, v)


def intersect_rays_wavefront(bvh, ro, rd, tmin=0.0, tmax=None):
    """Closest hit of [N,3] rays through the stackless wavefront walk
    (ops/traverse_wavefront.py) over the device BVH's split tables
    (convert.DeviceBvh with family "wavefront"); tmin, tmax and the result
    as intersect_rays_packet's."""
    if bvh.nodes_self is None:
        raise ValueError("the wavefront walk reads nodes_self, nodes_i and tris, which this "
                         "DeviceBvh lacks: build it with convert.add_kernel_tables_to_device(..., "
                         "{'wavefront'})")
    tmin, tmax = _segments(ro.shape[0], ro.device, tmin, tmax)
    t, row, u, v = traverse_wavefront(bvh.nodes_self, bvh.nodes_i, bvh.tris, ro, rd, tmin, tmax,
                                      MAX_STEPS)
    return _resolve_rows(bvh, t, row, u, v)
