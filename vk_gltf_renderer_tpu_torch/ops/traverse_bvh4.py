"""BVH4 traversal: the wrapper of csrc/traverse_bvh4.cu (replacing the
reference's traverse_packets3 and traverse_packets9, kernel values v3, v9,
v9x4 and v9x8).

CPU rays take the plain torch version (ops/traverse.traverse_bvh4_plain),
CUDA rays the kernel; see ops/traverse_launch.py. The renderer reaches it
through ops/intersect.intersect_rays_soa.

On the card a launch compacts the live lanes into a scratch list, which
a persistent grid walks (ops/traverse_launch.list_scratch).
"""

from __future__ import annotations

from ..cuda_lib import LaunchCounter, OverflowCounter
from .traverse import traverse_bvh4_plain
from .traverse_launch import list_scratch, run_traversal

COUNTER = LaunchCounter()
OVERFLOW = OverflowCounter()  # stack pushes dropped (must stay 0)


def traverse_bvh4(nodes4_fi, tris128, root_code, *rays, anyhit=False):
    """Raw traversal: (t, rnode, tri, u, v) for the 8 [N] f32 ray components
    (rox, roy, roz, rdx, rdy, rdz, tmin, tmax). t is the best t (tmax where
    nothing hit, -1 after an any-hit)."""
    return run_traversal(
        "traverse_bvh4", COUNTER, OVERFLOW,
        lambda: traverse_bvh4_plain(nodes4_fi, tris128, root_code, *rays, anyhit=anyhit),
        (("nodes4_fi", nodes4_fi, (None, 32)), ("tris128", tris128, (None, 128))),
        (root_code,), rays, anyhit, extra=list_scratch)
