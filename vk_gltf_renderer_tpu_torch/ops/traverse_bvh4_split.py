"""BVH4 traversal over the split tables (packet4): the wrapper of
csrc/traverse_bvh4_split.cu, replacing the reference's traverse_packets4
(vk_gltf_renderer_tpu/ops/pallas_traverse.py), reached through
VKGR_TRAVERSAL=packet4.

CPU rays take the plain torch version (ops/traverse.traverse_bvh4_split_plain),
CUDA rays the kernel; see ops/traverse_launch.run_traversal. The renderer
reaches it through ops/intersect.intersect_rays_packet(wide=True).

On the card a launch compacts the live lanes into a scratch list, which
a persistent grid walks (ops/traverse_launch.list_scratch).
"""

from __future__ import annotations

import torch

from ..cuda_lib import LaunchCounter, OverflowCounter
from .traverse import traverse_bvh4_split_plain
from .traverse_launch import list_scratch, run_traversal

COUNTER = LaunchCounter()
OVERFLOW = OverflowCounter()  # stack pushes dropped (must stay 0)


def traverse_bvh4_split(nodes4_f, nodes4_i, tris, *rays):
    """Raw closest-hit traversal: (t, rnode, row, u, v) for the 8 [N] f32
    ray components (rox, roy, roz, rdx, rdy, rdz, tmin, tmax). t is the
    best t (tmax where nothing hit), row the hit's tris row (-1: none),
    which the caller resolves; rnode is -1. tris holds < 2**24 rows, the
    rows the kernel carries exactly in float32."""
    if tris.shape[0] >= 2**24:
        raise ValueError("traverse_bvh4_split: at most 2**24 rows of tris")
    return run_traversal(
        "traverse_bvh4_split", COUNTER, OVERFLOW,
        lambda: traverse_bvh4_split_plain(nodes4_f, nodes4_i, tris, *rays),
        (("nodes4_f", nodes4_f, (None, 32)), ("nodes4_i", nodes4_i, (None, 8), torch.int32),
         ("tris", tris, (None, 16))),
        (), rays, None, extra=list_scratch)
