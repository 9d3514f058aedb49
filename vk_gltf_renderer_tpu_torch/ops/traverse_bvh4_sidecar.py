"""BVH4 traversal over the int32 sidecar (v7): the wrapper of
csrc/traverse_bvh4_sidecar.cu, replacing the reference's traverse_packets3
with its `sidecar` table (vk_gltf_renderer_tpu/ops/pallas_traverse.py),
kernel value v7.

CPU rays take the plain torch version (ops/traverse.traverse_bvh4_sidecar_plain),
CUDA rays the kernel; see ops/traverse_launch.py. The renderer reaches it
through ops/intersect.intersect_rays_soa.

On the card a launch compacts the live lanes into a scratch list, which
a persistent grid walks (ops/traverse_launch.list_scratch).
"""

from __future__ import annotations

import torch

from ..cuda_lib import LaunchCounter, OverflowCounter
from .traverse import traverse_bvh4_sidecar_plain
from .traverse_launch import list_scratch, run_traversal

COUNTER = LaunchCounter()
OVERFLOW = OverflowCounter()  # stack pushes dropped (must stay 0)


def traverse_bvh4_sidecar(nodes4_fi, nodes4_sc, tris128, root_code, *rays, anyhit=False):
    """Raw traversal: (t, rnode, tri, u, v) for the 8 [N] f32 ray components
    (rox, roy, roz, rdx, rdy, rdz, tmin, tmax). t is the best t (tmax where
    nothing hit, -1 after an any-hit)."""
    return run_traversal(
        "traverse_bvh4_sidecar", COUNTER, OVERFLOW,
        lambda: traverse_bvh4_sidecar_plain(nodes4_fi, nodes4_sc, tris128, root_code, *rays,
                                            anyhit=anyhit),
        (("nodes4_fi", nodes4_fi, (None, 32)),
         ("nodes4_sc", nodes4_sc, (None, 8), torch.int32),
         ("tris128", tris128, (None, 128))),
        (root_code,), rays, anyhit, extra=list_scratch)
