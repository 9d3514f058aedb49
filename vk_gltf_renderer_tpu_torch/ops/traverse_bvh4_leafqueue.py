"""BVH4 leaf-queue traversal (v8): the wrapper of
csrc/traverse_bvh4_leafqueue.cu, replacing the reference's traverse_packets8
(vk_gltf_renderer_tpu/ops/pallas_traverse.py), kernel value v8.

CPU rays take the plain torch version (ops/traverse.traverse_bvh4_leafqueue_plain),
CUDA rays the kernel; see ops/traverse_launch.py. The renderer reaches it
through ops/intersect.intersect_rays_soa.

On the card a launch compacts the live lanes into a scratch list, which
a persistent grid walks (ops/traverse_launch.list_scratch).
"""

from __future__ import annotations

from ..cuda_lib import LaunchCounter, OverflowCounter
from .traverse import traverse_bvh4_leafqueue_plain
from .traverse_launch import list_scratch, run_traversal

COUNTER = LaunchCounter()
OVERFLOW = OverflowCounter()  # stack or queue pushes dropped (must stay 0)


def traverse_bvh4_leafqueue(nodes4_fi, tris128, root_code, *rays, anyhit=False):
    """Raw traversal: (t, rnode, tri, u, v) for the 8 [N] f32 ray components
    (rox, roy, roz, rdx, rdy, rdz, tmin, tmax). t is the best t (tmax where
    nothing hit, -1 after an any-hit)."""
    return run_traversal(
        "traverse_bvh4_leafqueue", COUNTER, OVERFLOW,
        lambda: traverse_bvh4_leafqueue_plain(nodes4_fi, tris128, root_code, *rays, anyhit=anyhit),
        (("nodes4_fi", nodes4_fi, (None, 32)), ("tris128", tris128, (None, 128))),
        (root_code,), rays, anyhit, extra=list_scratch)
