"""BVH2 traversal: the wrapper of csrc/traverse_bvh2.cu (replacing the
reference's traverse_packets2, kernel value v2).

CPU rays take the plain torch version (ops/traverse.traverse_bvh2_plain),
CUDA rays the kernel; see ops/traverse_launch.py (the kernel compacts the
live lanes into list_scratch). The renderer reaches it through
ops/intersect.intersect_rays_soa.
"""

from __future__ import annotations

from ..cuda_lib import LaunchCounter, OverflowCounter
from .traverse import traverse_bvh2_plain
from .traverse_launch import list_scratch, run_traversal

COUNTER = LaunchCounter()
OVERFLOW = OverflowCounter()  # stack pushes dropped (must stay 0)


def traverse_bvh2(nodes_fi, tris128, root_code, *rays, anyhit=False):
    """Raw traversal over the binary rows nodes_fi [N,16] from root_code:
    (t, rnode, tri, u, v) for the 8 [N] f32 ray components. t is the best
    t (tmax where nothing hit, -1 after an any-hit)."""
    return run_traversal(
        "traverse_bvh2", COUNTER, OVERFLOW,
        lambda: traverse_bvh2_plain(nodes_fi, tris128, root_code, *rays, anyhit=anyhit),
        (("nodes_fi", nodes_fi, (None, 16)), ("tris128", tris128, (None, 128))),
        (root_code,), rays, anyhit, extra=list_scratch)
