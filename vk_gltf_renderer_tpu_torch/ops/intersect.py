"""The renderer's traversal-kernel switch: one ray-batch entry point over
every ported traversal kernel, mirroring the reference's
intersect_rays_packet_soa (vk_gltf_renderer_tpu/ops/pallas_traverse.py:1808)
and intersect_rays_lane_soa (ops/lane_traverse.py:433), including their
post-processing: rays without a hit get t = INFINITE and ids -1, and an
any-hit t becomes 0 or INFINITE (occlusion is read from tri >= 0: the
stack kernels return the t = -1 sentinel after an any hit).

Kernel names are the reference's VKGR_PRIMARY_KERNEL / VKGR_PACKET_KERNEL
values. Each routes to one CUDA kernel and the table family it reads;
every name of the reference's switch is ported, an unknown name raises,
and no name falls back to another kernel.
"""

from __future__ import annotations

import torch

from .lane_traverse import traverse_lanes
from .traverse import INFINITE, STACK_DEPTH, STACK_DEPTH2, STACK_DEPTH16, STACK_DEPTH_MULTIPOP
from .traverse_bvh2 import traverse_bvh2
from .traverse_bvh4 import traverse_bvh4
from .traverse_bvh4_leafqueue import traverse_bvh4_leafqueue
from .traverse_bvh4_multipop import traverse_bvh4_multipop
from .traverse_bvh4_sidecar import traverse_bvh4_sidecar
from .traverse_bvh16 import traverse_bvh16

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
                  "bvh16": STACK_DEPTH16}


def route(kernel: str) -> str:
    """Table family of a kernel name; raises for unknown names."""
    if kernel in ROUTES:
        return ROUTES[kernel]
    raise ValueError(f"unknown traversal kernel {kernel!r}; accepted: {sorted(ROUTES)}")


def intersect_rays_soa(bvh, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, anyhit=False,
                       kernel="v3"):
    """Closest hit (or any hit) of a ray batch against the device BVH
    (convert.DeviceBvh) through the named kernel. Returns dict(t, rnode,
    tri, u, v) of [N]."""
    family = route(kernel)
    rays = (rox, roy, roz, rdx, rdy, rdz, tmin, tmax)
    if family in STACK_CAPACITY:
        need = bvh.stack_need.get(family)
        if need is None:
            raise ValueError(f"kernel {kernel!r} reads the {family} table, which this DeviceBvh "
                             "lacks: build it with bvh_flatten.add_kernel_tables and "
                             "convert.add_kernel_tables_to_device")
        if need > STACK_CAPACITY[family]:
            raise ValueError(f"the {family} tree needs a {need}-entry traversal stack; the kernel "
                             f"holds {STACK_CAPACITY[family]}")
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
