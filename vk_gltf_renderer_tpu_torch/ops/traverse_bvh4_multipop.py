"""BVH4 multi-pop traversal (v5): the wrapper of
csrc/traverse_bvh4_multipop.cu, replacing the reference's traverse_packets5
(vk_gltf_renderer_tpu/ops/pallas_traverse.py), kernel value v5.

CPU rays take the plain torch version (ops/traverse.traverse_bvh4_multipop_plain),
CUDA rays the kernel; see ops/traverse_launch.py (the kernel compacts the
live lanes into list_scratch). The renderer reaches it through
ops/intersect.intersect_rays_soa.
"""

from __future__ import annotations

from ..cuda_lib import LaunchCounter, OverflowCounter
from .traverse import traverse_bvh4_multipop_plain
from .traverse_launch import list_scratch, run_traversal

COUNTER = LaunchCounter()
OVERFLOW = OverflowCounter()  # stack pushes dropped (must stay 0)


def traverse_bvh4_multipop(nodes4_fi, tris128, root_code, *rays, anyhit=False):
    """Raw traversal: (t, rnode, tri, u, v) for the 8 [N] f32 ray components
    (rox, roy, roz, rdx, rdy, rdz, tmin, tmax). t is the best t (tmax where
    nothing hit, -1 after an any-hit)."""
    return run_traversal(
        "traverse_bvh4_multipop", COUNTER, OVERFLOW,
        lambda: traverse_bvh4_multipop_plain(nodes4_fi, tris128, root_code, *rays, anyhit=anyhit),
        (("nodes4_fi", nodes4_fi, (None, 32)), ("tris128", tris128, (None, 128))),
        (root_code,), rays, anyhit, extra=list_scratch)
