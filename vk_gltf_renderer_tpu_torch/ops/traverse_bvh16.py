"""BVH16 traversal: the wrapper of csrc/traverse_bvh16.cu (replacing the
reference's traverse_packets6, kernel value v6).

CPU rays take the plain torch version (ops/traverse.traverse_bvh16_plain),
CUDA rays the kernel; see ops/traverse_launch.py (the kernel compacts the
live lanes into list_scratch). The renderer reaches it through
ops/intersect.intersect_rays_soa.
"""

from __future__ import annotations

from ..cuda_lib import LaunchCounter, OverflowCounter
from .traverse import traverse_bvh16_plain
from .traverse_launch import list_scratch, run_traversal

COUNTER = LaunchCounter()
OVERFLOW = OverflowCounter()  # stack pushes dropped (must stay 0)


def traverse_bvh16(nodes16_fi, tris128, *rays, anyhit=False):
    """Raw traversal over the dense rows nodes16_fi [M,128] (root row 0):
    (t, rnode, tri, u, v) for the 8 [N] f32 ray components. t is the best
    t (tmax where nothing hit, -1 after an any-hit)."""
    return run_traversal(
        "traverse_bvh16", COUNTER, OVERFLOW,
        lambda: traverse_bvh16_plain(nodes16_fi, tris128, 0, *rays, anyhit=anyhit),
        (("nodes16_fi", nodes16_fi, (None, 128)), ("tris128", tris128, (None, 128))),
        (0,), rays, anyhit, extra=list_scratch)
